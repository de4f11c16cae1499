"""The port's HowTo100M pretraining path against the JAX package's, on the CPU:

- ``YTPretrainDataset`` gives the JAX package's examples and batches for the
  same seed: features in shard subdirectories, subtitles outside the
  duration dropped, a video without ASR;
- ``build_optimizer`` with ``mu_dtype="bfloat16"`` over 5 steps against the
  JAX package's (optax's ``clip_by_global_norm`` + ``adamw(mu_dtype=
  bfloat16)``, op by op): ``mu`` bit-identical, parameters and ``nu``
  within fp32 rounding; a save and restore keeps bf16;
- ``dvc_main`` on ``["htm"]``: ``last`` and ``log.txt``, ``{}`` returned, a
  rerun resumes with the bf16 moments;
- ``config.default_dataset_paths(..., "htm")`` is the JAX package's.
"""

import csv
import dataclasses
import json
import pickle

import numpy as np
import torch


def write_htm(root, n=6, dim=8, seed=0):
    """A HowTo100M layout: ``htm.csv`` of ``video_id,video_path``, ``[T, dim]``
    features at ``feats/shard{k}/<id>.mp4.npy``, and an ASR pickle keyed on
    the last 11 characters. Video 1 has no ASR; video 2 has a segment
    before 0 and one past its duration; video 3 states its duration."""
    rng = np.random.default_rng(seed)
    rows, asr = [], {}
    for i in range(n):
        vid = f"htmvideo{i:05d}"
        shard = root / "feats" / f"shard{i % 2}"
        shard.mkdir(parents=True, exist_ok=True)
        np.save(shard / f"{vid}.mp4.npy",
                rng.normal(size=(int(rng.integers(5, 30)), dim)).astype(np.float32))
        rows.append({"video_id": vid, "video_path": f"shard{i % 2}/{vid}.mp4"})
        if i == 1:
            continue
        starts = np.sort(rng.uniform(0, 20, size=4)).tolist()
        sub = {"text": [f"we mix part {j} of batch {i}" for j in range(4)], "start": starts,
               "end": [s + 3.0 for s in starts]}
        if i == 2:
            sub["start"][0], sub["end"][-1] = -1.0, 500.0
        if i == 3:
            sub["duration"] = 40.0
        asr[vid[-11:]] = sub
    with open(root / "htm.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["video_id", "video_path"])
        w.writeheader()
        w.writerows(rows)
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)


def _data_cfgs():
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    kw = dict(max_feats=10, features_dim=8, max_input_tokens=48, max_output_tokens=32)
    return jc.DataConfig(**kw), tc.DataConfig(**kw)


def test_yt_pretrain_examples_and_batches_match_jax(tmp_path):
    from vidchapters_tpu.data import dvc_dataset as jd
    from vidchapters_tpu.data.tokenizer import ByteLevelTokenizer as JaxTok
    from vidchapters_tpu_torch.data import dvc_dataset as td
    from vidchapters_tpu_torch.data.tokenizer import ByteLevelTokenizer

    write_htm(tmp_path)
    jcfg, tcfg = _data_cfgs()
    args = (str(tmp_path / "htm.csv"), str(tmp_path / "feats"))
    jds = jd.YTPretrainDataset.from_csv(*args, JaxTok(), str(tmp_path / "asr.pkl"), jcfg)
    tds = td.YTPretrainDataset.from_csv(*args, ByteLevelTokenizer(), str(tmp_path / "asr.pkl"),
                                        tcfg)
    assert len(tds) == len(jds) == 6
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(len(tds)):
        ref, got = jds.__getitem__(i, rng=jr), tds.__getitem__(i, rng=tr)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    no_asr = tds.__getitem__(1, rng=tr)
    assert no_asr["output_tokens"].tolist() == [ByteLevelTokenizer().eos_token_id]
    assert no_asr["denoising_input_tokens"].tolist() == [0]
    assert tds[3]["duration"] == 40.0
    # the video row of a shard subdirectory is its own file's, subsampled
    raw = np.load(tmp_path / "feats" / "shard0" / "htmvideo00004.mp4.npy")
    from vidchapters_tpu_torch.data.features import subsample_or_pad

    np.testing.assert_array_equal(tds[4]["video"], subsample_or_pad(raw, 10, 8))

    for epoch in (0, 1):
        ji = jd.EpochIterator(jds, 2, jcfg, seed=3)
        ti = td.EpochIterator(tds, 2, tcfg, seed=3)
        ji.set_epoch(epoch)
        ti.set_epoch(epoch)
        jb, tb = list(ji), list(ti)
        assert len(tb) == len(jb) == 3
        for a, b in zip(jb, tb):
            assert set(a) == set(b) and "input_tokens" not in b
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def test_htm_default_paths_match_jax():
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    kw = dict(data_dir="/data", ssd_dir="/ssd")
    ref = jc.default_dataset_paths(jc.PathsConfig(**kw), "htm")
    got = tc.default_dataset_paths(tc.PathsConfig(**kw), "htm")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.train_json_path == "/data/howto100m/htm_vid2seq.csv"


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(7, 33)).astype(np.float32),
            "b": rng.normal(size=(129,)).astype(np.float32),
            "c": rng.normal(size=(4, 3, 5)).astype(np.float32)}


def _grads(step, seed=1):
    rng = np.random.default_rng(seed + step)
    scale = 0.003 if step % 2 else 0.05  # steps under and over the clip
    return {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
            for k, v in _params().items()}


def _optim_cfgs():
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    kw = dict(lr=3e-3, weight_decay=0.01, clip_max_norm=0.1, schedule="cosine_with_warmup",
              fraction_warmup_steps=0.2, mu_dtype="bfloat16")
    return jc.OptimConfig(**kw), tc.OptimConfig(**kw)


def _port_optimizer(params):
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    return build_optimizer(_optim_cfgs()[1], 10, params)


def _port_step(opt, params, step):
    for k, p in zip(sorted(params), opt.params):
        p.grad = torch.from_numpy(_grads(step)[k])
    opt.step()


def test_bf16_moments_match_optax_over_five_steps():
    """optax op by op (the JAX package's ``build_optimizer``, unjitted); a
    jitted JAX step may keep ``b1 * mu`` in fp32 (schedules.py's note)."""
    import jax.numpy as jnp
    import optax

    from vidchapters_tpu.train.schedules import build_optimizer as jax_build

    tx = jax_build(_optim_cfgs()[0], 10)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(jp)
    names = sorted(jp)
    params = [torch.nn.Parameter(torch.from_numpy(_params()[k])) for k in names]
    opt = _port_optimizer(params)
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    assert all(n.dtype == torch.float32 for n in opt.nu)
    for step in range(5):
        g = {k: jnp.asarray(v) for k, v in _grads(step).items()}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        _port_step(opt, dict(zip(names, params)), step)
        adam = state[1][0]
        for i, k in enumerate(names):
            assert adam.mu[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                opt.mu[i].float().numpy(), np.asarray(adam.mu[k].astype(jnp.float32)),
                err_msg=f"mu {k} step {step}")
            np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]),
                                       rtol=2e-6, atol=1e-12, err_msg=f"nu {k} step {step}")
            np.testing.assert_allclose(params[i].detach().numpy(), np.asarray(jp[k]),
                                       rtol=2e-6, atol=1e-7, err_msg=f"param {k} step {step}")


def test_bf16_moments_survive_a_save_and_restore(tmp_path):
    names = sorted(_params())

    def fresh():
        return [torch.nn.Parameter(torch.from_numpy(_params()[k])) for k in names]

    p_a = fresh()
    opt_a = _port_optimizer(p_a)
    for step in range(3):
        _port_step(opt_a, dict(zip(names, p_a)), step)
    torch.save(opt_a.state_dict(), tmp_path / "opt.pt")
    p_b = [torch.nn.Parameter(p.detach().clone()) for p in p_a]
    opt_b = _port_optimizer(p_b)
    opt_b.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert opt_b.count == 3 and all(m.dtype == torch.bfloat16 for m in opt_b.mu)
    for step in (3, 4):
        _port_step(opt_a, dict(zip(names, p_a)), step)
        _port_step(opt_b, dict(zip(names, p_b)), step)
    for a, b in zip(opt_a.mu + opt_a.nu + p_a, opt_b.mu + opt_b.nu + p_b):
        assert torch.equal(a.detach(), b.detach())


def test_dvc_main_pretrains_on_htm_and_resumes(tmp_path, capsys):
    from tests.test_torch_dvc_main import _tiny_cfg
    from vidchapters_tpu_torch import config as c
    from vidchapters_tpu_torch.train.dvc_main import main

    write_htm(tmp_path, n=4)
    base = _tiny_cfg(tmp_path)
    cfg = dataclasses.replace(
        base, combine_datasets=["htm"],
        datasets={"htm": c.DatasetPaths(train_json_path=str(tmp_path / "htm.csv"),
                                        features_path=str(tmp_path / "feats"),
                                        subtitles_path=str(tmp_path / "asr.pkl"))},
        train=dataclasses.replace(base.train, genasr=True, optim=dataclasses.replace(
            base.train.optim, mu_dtype="bfloat16")))
    assert main(cfg, device="cpu") == {}
    ckpt = tmp_path / "ckpt"
    out = capsys.readouterr().out
    assert "Epoch [0] htm" in out
    assert (ckpt / "last").exists() and not (ckpt / "best").exists()
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0]
    assert np.isfinite(log[0]["train_loss"]) and np.isfinite(log[0]["train_denoising_loss"])
    payload = torch.load(ckpt / "last", weights_only=True)
    assert payload["step"] == 2 and all(m.dtype == torch.bfloat16
                                        for m in payload["optimizer"]["mu"])

    longer = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=2))
    assert main(longer, device="cpu") == {}
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out and "Epoch [1] htm" in out and "Epoch [0]" not in out
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0, 1]
    payload = torch.load(ckpt / "last", weights_only=True)
    assert payload["step"] == 4 and payload["optimizer"]["count"] == 4
    assert all(m.dtype == torch.bfloat16 for m in payload["optimizer"]["mu"])
