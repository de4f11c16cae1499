"""The port's grounding data, optimizer, evaluation and entry point against
the JAX package's, on the CPU:

- ``GroundingDataset`` / ``grounding_collate`` / ``batches`` give JAX's
  examples and batches for the same seed (multi-query rows, saliency
  draws, precomputed query features, the speech stream);
- the port's ``GroundingConfig`` loads ``configs/chapters_momentdetr.json``;
- ``build_grounding_optimizer`` against optax's chain (clip, AdamW with
  weight decay, the StepLR staircase) over two updates;
- ``eval_submission`` equals JAX's on a fixed submission, and the
  submission rows (NMS) equal JAX's;
- ``grounding_main``'s CLI end to end at a tiny width with ``--device
  cpu``: a test split and the smoke-mode speech tower; ``--clip-text-ckpt``
  as a plain state dict and as a TorchScript archive; ``--bert-ckpt``
  raises.
"""

import dataclasses
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_grounding import openai_clip_text_sd

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops: the suite runs six
    workers on the machine's cores, where torch's thread pool spends these
    tests' time handing work between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_vmr(root: Path, n: int = 6, d: int = 8, seed: int = 0, q_feats: bool = False,
               multi: bool = False):
    """A VMR jsonl of ``n`` rows (with ``multi``, every other one with two
    queries: a training set only, the evaluator reads one window list a
    row), ``[T, d]`` features, an ASR pickle and, with ``q_feats``,
    per-query token features ``qid{qid}.npz``."""
    rng = np.random.default_rng(seed)
    (root / "feats").mkdir()
    if q_feats:
        (root / "qfeats").mkdir()
    rows, subs = [], {}
    for i in range(n):
        vid = f"groundvid{i:02d}"
        dur = 60.0 + 15 * i
        win = [[3.0 * i, 3.0 * i + 20.0], [dur - 30.0, dur - 3.0]]
        if multi and i % 2:
            rows.append({"qid": i, "query": [f"topic {i}", f"other topic {i}"], "vid": vid,
                         "duration": dur, "relevant_windows": [[win[0]], [win[1], win[0]]]})
        else:
            rows.append({"qid": i, "query": f"chapter about topic {i}", "vid": vid,
                         "duration": dur, "relevant_windows": win})
        np.save(root / "feats" / f"{vid}.npy", rng.normal(size=(int(dur), d)).astype(np.float32))
        if q_feats:
            np.savez(root / "qfeats" / f"qid{i}.npz",
                     last_hidden_state=rng.normal(size=(5 + 3 * i, 6)).astype(np.float32))
        subs[vid] = {"text": [f"hello chapter {i}", "more speech here"],
                     "start": [0.0, 40.0], "end": [30.0, 58.0]}
    (root / "d.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    with open(root / "subs.pkl", "wb") as f:
        pickle.dump(subs, f)
    return root / "d.jsonl"


def _equal(got, ref, where):
    assert got.keys() == ref.keys(), where
    for k, r in ref.items():
        if isinstance(r, np.ndarray):
            assert got[k].dtype == r.dtype, (where, k)
            np.testing.assert_array_equal(got[k], r, err_msg=f"{where} {k}")
        else:
            assert got[k] == r, (where, k)


@pytest.mark.parametrize("train", [True, False])
def test_dataset_and_batches_equal_jax(tmp_path, train):
    from vidchapters_tpu.data.grounding_dataset import GroundingDataset as JDataset
    from vidchapters_tpu.data.grounding_dataset import grounding_collate as jax_collate
    from vidchapters_tpu.train.grounding_main import batches as jax_batches
    from vidchapters_tpu_torch.data.grounding_dataset import GroundingDataset, grounding_collate
    from vidchapters_tpu_torch.train.grounding_main import batches

    path = _write_vmr(tmp_path, q_feats=True, multi=True)
    kw = dict(train=train, max_v_l=24, clip_len=3, max_windows=1, use_speech=True,
              subtitles_path=str(tmp_path / "subs.pkl"), q_feat_dir=str(tmp_path / "qfeats"),
              max_q_l=12, seed=5)
    jds = JDataset(str(path), [str(tmp_path / "feats")], **kw)
    ds = GroundingDataset(str(path), [str(tmp_path / "feats")], **kw)
    for rep in range(2):  # the datasets' own generators advance alike
        for i in range(len(ds)):
            _equal(ds[i], jds[i], f"example {i}, pass {rep}")
    exs = [ds[i] for i in range(4)]
    jexs = [jds[i] for i in range(4)]
    _equal(grounding_collate(exs, 24, 3, max_q_l=12), jax_collate(jexs, 24, 3, max_q_l=12),
           "collate")
    tok = lambda qs: np.asarray([[len(q), 1] for q in qs], np.int32)  # noqa: E731
    got = list(batches(ds, 2, 24, 3, True, 9, tok, max_q_l=12))
    ref = list(jax_batches(jds, 2, 24, 3, True, 9, tok, max_q_l=12))
    assert len(got) == len(ref) == 3
    for n, (g, r) in enumerate(zip(got, ref)):
        _equal(g, r, f"batch {n}")


def test_recipe_loads_into_the_port_config():
    from vidchapters_tpu_torch.config import GroundingConfig
    from vidchapters_tpu_torch.utils.io import load_json

    recipe = load_json(ROOT / "configs" / "chapters_momentdetr.json")
    cfg = dataclasses.replace(GroundingConfig(), **recipe["model"])
    assert (cfg.hidden_dim, cfg.nheads, cfg.enc_layers, cfg.dec_layers) == (256, 8, 2, 2)
    assert (cfg.num_queries, cfg.max_v_l, cfg.v_feat_dim, cfg.dtype) == (10, 1200, 770,
                                                                        "bfloat16")
    assert recipe["train"]["batch_size"] == 256


def test_optimizer_matches_optax():
    """Two updates with the clip active and the lr dropping x0.1 after the
    first (``lr_drop_step`` 1 epoch of 1 step): every parameter within
    rtol 1e-6."""
    from vidchapters_tpu.train.grounding_train import (
        build_grounding_optimizer as jax_optimizer,
    )
    from vidchapters_tpu_torch.train.grounding_train import build_grounding_optimizer

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx = jax_optimizer(lr=1e-2, weight_decay=1e-2, lr_drop_step=1, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_grounding_optimizer(tparams.values(), lr=1e-2, weight_decay=1e-2,
                                    lr_drop_step=1, steps_per_epoch=1)
    import optax

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    for g in grads:
        jp, opt_state = update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        norm = opt.step()
        assert float(norm) > 0.1  # the clip is active
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_eval_submission_and_rows_equal_jax():
    from vidchapters_tpu.evals.moment import eval_submission as jax_eval
    from vidchapters_tpu.train.grounding_train import (
        predictions_to_submission as jax_rows,
    )
    from vidchapters_tpu_torch.evals import eval_submission
    from vidchapters_tpu_torch.train.grounding_train import predictions_to_submission

    rng = np.random.default_rng(1)
    spans = np.sort(rng.uniform(0, 120, size=(3, 8, 2)), axis=-1).astype(np.float32)
    scores = rng.uniform(size=(3, 8)).astype(np.float32)
    sal = rng.normal(size=(3, 30)).astype(np.float32)
    qids = [10, 11, 12]
    for nms in (-1.0, 0.5):
        got = predictions_to_submission(qids, spans, scores, sal, nms)
        assert got == jax_rows(qids, spans, scores, sal, nms)
    gt = [{"qid": q, "duration": 120.0, "relevant_windows": [[10.0 * i, 10.0 * i + 25.0]]}
          for i, q in enumerate(qids)]
    got, ref = eval_submission(got, gt, match_number=False), jax_eval(got, gt,
                                                                      match_number=False)
    assert got == ref and {"MR-full-mAP", "MR-full-R1@0.5"} <= set(got["brief"])


def _tiny_recipe(root: Path, speech: bool) -> Path:
    recipe = {"model": dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                            dim_feedforward=64, num_queries=4, v_feat_dim=10, t_feat_dim=16,
                            s_feat_dim=16, use_speech=speech, speech_max_l=16, dropout=0.1,
                            input_dropout=0.5, max_v_l=30, clip_length=3, dtype="float32"),
              "train": dict(epochs=1, batch_size=2, lr=1e-3, eval_every=1,
                            early_stop_patience=5, max_spans=3),
              "data": dict(train_jsonl=str(root / "d.jsonl"), val_jsonl=str(root / "d.jsonl"),
                           test_jsonl=str(root / "d.jsonl"), v_feat_dirs=[str(root / "feats")],
                           subtitles_path=str(root / "subs.pkl"))}
    (root / "recipe.json").write_text(json.dumps(recipe))
    return root / "recipe.json"


def _cli(argv, capsys):
    from vidchapters_tpu_torch.train import grounding_main

    capsys.readouterr()
    grounding_main._cli(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_end_to_end_with_speech_and_test_split(tmp_path, capsys):
    _write_vmr(tmp_path, n=4)
    recipe = _tiny_recipe(tmp_path, speech=True)
    save = tmp_path / "ckpt"
    out = _cli(["--recipe", str(recipe), "--save-dir", str(save), "--device", "cpu",
                "--epochs", "2"], capsys)
    assert {"MR-full-mAP", "MR-full-R1@0.5", "test_MR-full-mAP"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    log = [json.loads(line) for line in (save / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0, 1] and all(np.isfinite(e["loss"]) for e in log)
    for name in ("best", "last"):
        assert (save / name).exists()
    payload = torch.load(save / "last", weights_only=True)
    assert payload["step"] == 4 and any(k.startswith("speech_proj") for k in payload["model"])
    preds = [json.loads(line) for line in (save / "test_preds.jsonl").read_text().splitlines()]
    assert sorted(p["qid"] for p in preds) == [0, 1, 2, 3]
    assert all(len(p["pred_relevant_windows"]) == 4 for p in preds)

    with pytest.raises(NotImplementedError, match="WordPiece"):
        _cli(["--recipe", str(recipe), "--save-dir", str(save), "--device", "cpu",
              "--bert-ckpt", str(tmp_path)], capsys)


class _Holder(torch.nn.Module):
    """A TorchScript-able module holding tensors under dotted names, as
    OpenAI's released archive holds CLIP's."""

    def __init__(self, sd):
        super().__init__()
        for name, v in sd.items():
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, torch.nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.mark.parametrize("form", ["state_dict", "torchscript"])
def test_cli_clip_text_checkpoint(tmp_path, capsys, form):
    """Both forms load to the converter's state dict, which the 12-layer
    tower the CLI builds at ``t_feat_dim`` takes; the CLI trains on it
    (once: the path after loading is the same)."""
    from vidchapters_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPTextEncoder,
        convert_openai_clip_text,
    )
    from vidchapters_tpu_torch.train.grounding_main import load_clip_text_checkpoint

    _write_vmr(tmp_path, n=4)
    recipe = _tiny_recipe(tmp_path, speech=False)
    sd = openai_clip_text_sd(np.random.default_rng(3), width=16, layers=12, vocab=49408,
                             ctx=77, out=16)
    path = tmp_path / "clip.pt"
    if form == "torchscript":
        torch.jit.script(_Holder(sd)).save(str(path))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = load_clip_text_checkpoint(str(path))
    want = convert_openai_clip_text(sd)
    assert loaded.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(loaded[k], want[k], rtol=0, atol=0)
    CLIPTextEncoder(CLIPTextConfig(width=16, output_dim=16, heads=1)).load_state_dict(loaded)
    if form == "state_dict":
        out = _cli(["--recipe", str(recipe), "--save-dir", str(tmp_path / "ckpt"), "--device",
                    "cpu", "--clip-text-ckpt", str(path)], capsys)
        assert np.isfinite(out["MR-full-mAP"])
