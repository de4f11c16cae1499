"""The port's PDVC data, training loop and evaluation against the JAX
package's, and its entry point end to end, on the CPU at a tiny size:

- ``Translator``, ``PDVCDataset`` and ``pdvc_collate`` give the JAX
  package's arrays; the port reads a ``translator.json`` JAX wrote;
- ``evaluate_pdvc`` gives JAX's submission and metrics for the same model
  outputs; ``rerank_proposals``, ``scheduled_sampling_prob``,
  ``transfer_params`` and the optimizer (clip, AdamW, StepLR staircase)
  follow JAX's;
- ``pdvc_main.main`` writes ``best`` / ``last`` / ``translator.json`` /
  ``info.json``, resumes, then ``eval_main`` and the CLI in test mode run;
  the entry points default to CUDA and raise without it;
- the JAX package's own resume from ``last`` raises (it saves
  ``(params,)`` and restores three parts), which the port does not copy.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=128,
           num_queries=6, num_feature_levels=2, dec_n_points=2, enc_n_points=2, feature_dim=8,
           frame_embedding_num=16, dropout=0.0, vocab_size=30, max_caption_len=6, rnn_size=24,
           caption_decoder_type="dsa", cap_nheads=2, cap_num_feature_levels=2,
           cap_dec_n_points=2)
WORDS = ["stir", "the", "soup", "serve", "dish", "chop", "onion", "fry", "egg", "pan"]


def _write_dataset(root: Path, n_train: int = 2, n_val: int = 2, seed: int = 0):
    """Features of 20-40 frames of 8 per video (named by the last 11
    characters of the id), train / val jsons of 2-3 captioned chapters."""
    rng = np.random.default_rng(seed)
    (root / "f").mkdir()
    splits = {"train": {}, "val": {}}
    for i in range(n_train + n_val):
        vid = f"vvvvvvvvv{i:02d}"
        np.save(root / "f" / f"{vid[-11:]}.npy",
                rng.normal(size=(int(rng.integers(20, 40)), 8)).astype(np.float32))
        dur = float(rng.integers(40, 90))
        k = int(rng.integers(2, 4))
        edges = np.linspace(0.0, dur, k + 1)
        splits["train" if i < n_train else "val"][vid] = {
            "duration": dur, "timestamps": [[float(a), float(b)] for a, b in zip(edges, edges[1:])],
            "sentences": [" ".join(rng.choice(WORDS, 3)) + ", then rest." for _ in range(k)]}
    for name, ann in splits.items():
        (root / f"{name}.json").write_text(json.dumps(ann))
    return root


def test_dataset_collate_and_vocab_identical_to_jax(tmp_path):
    from vidchapters_tpu.config import PDVCConfig as JConfig
    from vidchapters_tpu.data import pdvc_dataset as jds
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.data import pdvc_dataset as tds

    root = _write_dataset(tmp_path, n_train=3, n_val=0)
    ann = json.loads((root / "train.json").read_text())
    sents = [s for a in ann.values() for s in a["sentences"]] + ["Unseen words here!"]
    jtr, ttr = jds.Translator.build(sents[:-1]), tds.Translator.build(sents[:-1])
    assert dict(ttr.word_to_ix) == dict(jtr.word_to_ix) and ttr.unk_id == jtr.unk_id
    np.testing.assert_array_equal(ttr.translate(sents[-1], 6), jtr.translate(sents[-1], 6))
    jtr.to_json(tmp_path / "translator.json")
    back = tds.Translator.from_json(str(tmp_path / "translator.json"))
    assert back.ix_to_word == jtr.ix_to_word
    ids = [jtr.word_to_ix[w] for w in ("stir", "the", "soup")] + [0, 5]
    assert back.rtranslate(ids) == jtr.rtranslate(ids) == "stir the soup."

    kw = dict(frame_embedding_num=16, feature_dim=8, max_caption_len=6)
    jset = jds.PDVCDataset(str(root / "train.json"), str(root / "f"), jtr, JConfig(**kw),
                           max_events=4)
    tset = tds.PDVCDataset(str(root / "train.json"), str(root / "f"), ttr, PDVCConfig(**kw),
                           max_events=4)
    jb = jds.pdvc_collate([jset[i] for i in range(3)])
    tb = tds.pdvc_collate([tset[i] for i in range(3)])
    assert jb.keys() == tb.keys() and tb["video_id"] == jb["video_id"]
    for k in ("video", "video_mask", "boxes", "valid", "captions", "duration"):
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    feats = np.arange(10, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(tds.resize_features(feats, 7), jds.resize_features(feats, 7))


def _post(rng, b: int, q: int, vocab: int):
    """Model outputs of one batch as ``infer`` returns them (numpy)."""
    boxes = np.sort(rng.uniform(0, 60, (b, q, 2)), axis=-1).astype(np.float32)
    seq = rng.integers(1, vocab, (b, q, 6))
    seq[:, ::2, 3:] = 0
    return {"scores": np.sort(rng.uniform(0, 1, (b, q)), axis=1)[:, ::-1].astype(np.float32),
            "boxes": boxes, "seq": seq, "caption_scores": -rng.uniform(1, 9, (b, q)).astype(
                np.float32), "pred_seq_len": rng.integers(1, 4, b), "query_order": None}


def test_evaluate_pdvc_identical_to_jax(tmp_path):
    from vidchapters_tpu.data.pdvc_dataset import Translator
    from vidchapters_tpu.train.pdvc_train import evaluate_pdvc as jax_evaluate
    from vidchapters_tpu_torch.train.pdvc_train import evaluate_pdvc

    tr = Translator.build([" ".join(WORDS)])
    rng = np.random.default_rng(3)
    batches, posts, refs = [], [], {}
    for b in range(2):
        vids = [f"ev{b}{i}" for i in range(2)]
        batches.append({"video": np.zeros((2, 16, 8), np.float32),
                        "video_mask": np.ones((2, 16), np.int32),
                        "duration": np.array([60.0, 60.0], np.float32), "video_id": vids})
        posts.append(_post(rng, 2, 6, len(tr)))
        for v in vids:
            refs[v] = {"duration": 60.0, "timestamps": [[0.0, 25.0], [25.0, 60.0]],
                       "sentences": ["stir the soup", "serve the dish"]}
    queue = list(posts)
    ref_res, ref_metrics = jax_evaluate(lambda p, *a: queue.pop(0), None, batches, tr,
                                        references=[refs])
    queue = list(posts)
    res, metrics = evaluate_pdvc(lambda *a: queue.pop(0), batches, tr, references=[refs])
    assert res == ref_res and sum(len(p) for p in res.values()) > 0
    assert metrics == ref_metrics and "soda_c" in metrics and "METEOR" in metrics


def test_rerank_schedules_transfer_and_optimizer_follow_jax():
    import optax

    from vidchapters_tpu.train import pdvc_main as jmain
    from vidchapters_tpu.train.pdvc_train import build_pdvc_optimizer as jax_optimizer
    from vidchapters_tpu.train.pdvc_train import rerank_proposals as jax_rerank
    from vidchapters_tpu_torch.train import pdvc_main as tmain
    from vidchapters_tpu_torch.train.pdvc_train import (
        build_pdvc_optimizer,
        build_pdvc_schedule,
        rerank_proposals,
    )

    rng = np.random.default_rng(4)
    props = [{"timestamp": [float(s), float(s) + 5], "proposal_score": float(p),
              "sentence": " ".join(["w"] * int(n)), "sentence_score": float(c),
              "pred_event_count": 3}
             for s, p, n, c in zip(rng.uniform(0, 50, 8), rng.uniform(0, 1, 8),
                                   rng.integers(1, 6, 8), -rng.uniform(0, 9, 8))]
    assert rerank_proposals(props) == jax_rerank(props) and len(rerank_proposals(props)) == 3
    assert [tmain.scheduled_sampling_prob(e) for e in range(0, 60, 3)] == \
        [jmain.scheduled_sampling_prob(e) for e in range(0, 60, 3)]
    src = {"a": torch.ones(3, 4), "q": torch.ones(5, 8)}
    out = tmain.transfer_params(src, {"a": torch.zeros(3, 4), "q": torch.zeros(9, 8),
                                      "new": torch.zeros(2)}, verbose=False)
    assert torch.equal(out["a"], src["a"]) and not out["q"].any() and "new" in out

    sched = build_pdvc_schedule(1e-4, 3, 0.5)
    ref = optax.exponential_decay(1e-4, 3, 0.5, staircase=True)
    assert [sched(c) for c in range(20)] == [float(ref(c)) for c in range(20)]
    # three updates of clip(100) -> AdamW(wd 1e-4) against optax, one gradient clipped
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) * s for s in (1.0, 300.0, 0.5)]
    tx = jax_optimizer(lr=1e-2, lr_drop_step=1, steps_per_epoch=2)
    jw, state = jnp.asarray(w0), None
    state = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = build_pdvc_optimizer([p], lr=1e-2, lr_drop_step=1, steps_per_epoch=2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def test_dropout_is_drawn_from_the_step_and_keeps_the_rate():
    """Dropout parity with JAX cannot be exact (the streams differ): the
    same (seed, step) gives the same train step, and each element mask keeps
    1 - rate of the elements."""
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.models.t5 import _apply_dropout
    from vidchapters_tpu_torch.runtime.rng import StepRng

    x = torch.ones(200_000)
    kept = float((_apply_dropout(x, 0.1, StepRng(3, 7, "cpu")) != 0).float().mean())
    assert abs(kept - 0.9) < 0.005
    model = PDVC(PDVCConfig(**dict(CFG, dropout=0.3))).init_weights(
        torch.Generator().manual_seed(0))
    vf, mask = torch.randn(1, 16, 8, generator=torch.Generator().manual_seed(1)), torch.ones(1, 16)
    with torch.no_grad():
        a, b = (model(vf, mask, rng=StepRng(5, 2, "cpu"))["hs"] for _ in range(2))
        c = model(vf, mask, rng=StepRng(5, 3, "cpu"))["hs"]
        off = model(vf, mask)["hs"]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)


def test_jax_pdvc_main_resume_from_last_raises(tmp_path):
    """What the JAX package does on resume: ``main`` saves ``last`` as
    ``(params,)`` (pdvc_main.py:145) and restores ``(params, opt_state,
    step)`` from it (:110-112), which orbax refuses."""
    import optax

    from vidchapters_tpu.runtime.checkpoint import CheckpointManager

    params = {"w": jnp.ones((3, 2))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_last((params,), 0)
    with pytest.raises(ValueError, match="tree structures do not match"):
        mgr.restore("last", (params, optax.adam(1e-3).init(params), jnp.array(0)))


def test_main_checkpoints_resumes_and_evaluates(tmp_path, capsys):
    from vidchapters_tpu_torch.config import PDVCConfig, save_config
    from vidchapters_tpu_torch.train.pdvc_main import eval_main, main

    root = _write_dataset(tmp_path)
    cfg = PDVCConfig(**CFG)
    args = (str(root / "train.json"), str(root / "val.json"), str(root / "f"), cfg)
    ckpt = tmp_path / "ckpt"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(*args, str(ckpt), n_epochs=1)
    metrics = main(*args, str(ckpt), n_epochs=1, batch_size=2, device="cpu")
    assert "soda_c" in metrics and all(np.isfinite(v) for v in metrics.values())
    for name in ("best", "last", "translator.json", "info.json", "manager.json"):
        assert (ckpt / name).exists(), name
    payload = torch.load(ckpt / "last", weights_only=True)
    assert payload["epoch"] == 0 and payload["step"] == 1 and payload["optimizer"]["count"] == 1
    info = json.loads((ckpt / "info.json").read_text())
    assert info["opt"]["hidden_dim"] == 64 and [h["epoch"] for h in info["histories"]] == [0]
    assert "meteor_soda" in info["histories"][0]

    # a second call with two epochs resumes from `last` and trains epoch 1
    main(*args, str(ckpt), n_epochs=2, batch_size=2, device="cpu")
    assert "resumed PDVC training at epoch 1" in capsys.readouterr().out
    payload = torch.load(ckpt / "last", weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 2 and payload["optimizer"]["count"] == 2
    assert len(json.loads((ckpt / "info.json").read_text())["histories"]) == 2

    out_dir = tmp_path / "eval"
    scored = eval_main(str(ckpt), str(root / "val.json"), str(root / "f"), cfg,
                       save_dir=str(out_dir), device="cpu")
    assert "soda_c" in scored and list(out_dir.glob("eval_epoch*_num2_alpha0.3.json"))

    # the CLI in test mode: unlabeled videos from a metadata CSV, no scores
    save_config(cfg, str(tmp_path / "cfg.json"))
    ann = json.loads((root / "val.json").read_text())
    (tmp_path / "meta.csv").write_text("filename,video-duration\n" + "".join(
        f"/x/{v}.mp4,{a['duration']}\n" for v, a in ann.items()))
    run = subprocess.run(
        [sys.executable, "-m", "vidchapters_tpu_torch.train.pdvc_main", "--eval", "--load",
         str(ckpt), "--features-path", str(root / "f"), "--config", str(tmp_path / "cfg.json"),
         "--save-dir", str(out_dir), "--test-meta-csv", str(tmp_path / "meta.csv"),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == {}
    dvc = json.loads((out_dir / "dvc_results.json").read_text())["results"]
    assert set(dvc) == set(ann)
    assert all(p and all("sentence" in x and "timestamp" in x for x in p) for p in dvc.values())
