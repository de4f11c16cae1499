"""The port's ``train/dvc_main`` and ``evaluate`` on the CPU at a tiny size:

- ``main`` trains one epoch on a synthetic on-disk dataset, evaluates on
  val (beam 2 on the standard decode), writes ``log.txt``, the val
  predictions, ``best`` and ``last``; a second call resumes and goes
  straight to the final eval; ``eval_only`` with nucleus sampling scores;
  the CLI runs with ``--device cpu --eval``;
- ``evaluate`` with the JAX package's weights (``from_jax_params``) gives
  the JAX ``evaluate``'s predictions and metrics exactly, beam 3 on the
  standard route;
- ``CheckpointManager`` keeps the JAX package's best / last / archive policy.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from tests._torch_helpers import jax_params, port_model, small_cfgs

ROOT = Path(__file__).resolve().parents[1]


def _write_dataset(root: Path, n_train: int = 4, n_val: int = 2, seed: int = 0):
    """Features ``[20, 8]`` per video (named by the last 11 characters of the
    id), train / val annotation jsons of 2 chapters a video, an ASR pickle."""
    rng = np.random.default_rng(seed)
    (root / "feats").mkdir()
    splits, asr = {"train": {}, "val": {}}, {}
    for i in range(n_train + n_val):
        vid = f"video{i:06d}"
        np.save(root / "feats" / f"{vid[-11:]}.npy", rng.normal(size=(20, 8)).astype(np.float32))
        split = "train" if i < n_train else "val"
        splits[split][vid] = {"duration": 60.0, "timestamps": [[0.0, 30.0], [30.0, 60.0]],
                              "sentences": [f"first half of video {i}", "second half"]}
        asr[vid[-11:]] = {"text": ["hello there", "we cook"], "start": [1.0, 20.0],
                          "end": [5.0, 25.0]}
    for split, ann in splits.items():
        (root / f"{split}.json").write_text(json.dumps(ann))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)


def _tiny_cfg(root: Path, **gen):
    from vidchapters_tpu_torch import config as c

    t5 = c.T5Config(d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=1,
                    num_heads=4, relative_attention_num_buckets=8,
                    relative_attention_max_distance=16, dtype="float32", dropout_rate=0.0,
                    encoder_dropout=0.0, decoder_dropout=0.0)
    vit = c.TemporalViTConfig(num_features=8, embed_dim=8, depth=1, num_heads=2, mlp_dim=16,
                              dtype="float32")
    return c.ExperimentConfig(
        datasets={"chapters": c.DatasetPaths(
            train_json_path=str(root / "train.json"), val_json_path=str(root / "val.json"),
            features_path=str(root / "feats"), subtitles_path=str(root / "asr.pkl"))},
        data=c.DataConfig(max_feats=8, features_dim=8, max_input_tokens=16,
                          max_output_tokens=24),
        model=c.Vid2SeqConfig(t5=t5, vit=vit),
        generation=c.GenerationConfig(max_length=8, **gen),
        train=c.TrainConfig(epochs=1, batch_size=2, eval_batch_size=2, print_freq=100,
                            optim=c.OptimConfig(lr=1e-3, fraction_warmup_steps=0.0),
                            checkpoint=c.CheckpointConfig(save_dir=str(root / "ckpt"))))


@pytest.fixture
def standard_route(monkeypatch):
    from vidchapters_tpu_torch.models import t5

    monkeypatch.setattr(t5, "USE_MEGA_DECODE", False)


METRICS = ("chapters_CIDEr", "chapters_METEOR", "chapters_Bleu_4", "chapters_Recall",
           "chapters_Precision", "chapters_soda_c")


def test_main_trains_evaluates_checkpoints_and_resumes(tmp_path, capsys, standard_route):
    from vidchapters_tpu_torch.train.dvc_main import main

    _write_dataset(tmp_path)
    cfg = _tiny_cfg(tmp_path, num_beams=2)
    metrics = main(cfg, device="cpu")
    assert all(k in metrics and np.isfinite(metrics[k]) for k in METRICS), metrics
    ckpt = tmp_path / "ckpt"
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0]
    assert np.isfinite(log[0]["train_total_loss"]) and "chapters_CIDEr" in log[0]
    preds = json.loads((ckpt / "chapters_val_preds_e0.json").read_text())["results"]
    assert set(preds) == {"video000004", "video000005"}
    for name in ("best", "last"):
        assert (ckpt / name).exists() and not (ckpt / f"{name}.tmp").exists()
    assert json.loads((ckpt / "manager.json").read_text())["best_value"] is not None
    payload = torch.load(ckpt / "last", weights_only=True)
    assert payload["epoch"] == 0 and payload["step"] == 2 and payload["optimizer"]["count"] == 2
    assert "Epoch [0] chapters" in capsys.readouterr().out

    # a second call resumes from `last` and only runs the final eval
    again = main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out and "Epoch [" not in out
    assert again == metrics
    assert len((ckpt / "log.txt").read_text().splitlines()) == 1

    # eval_only with nucleus sampling
    nucleus = main(dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, use_nucleus_sampling=True, top_p=0.9)), eval_only=True, device="cpu")
    assert all(k in nucleus and np.isfinite(nucleus[k]) for k in METRICS)


def test_cli_eval_on_cpu_and_load_of_a_foreign_file(tmp_path):
    from vidchapters_tpu_torch.config import save_config
    from vidchapters_tpu_torch.train.dvc_main import main

    _write_dataset(tmp_path)
    cfg = _tiny_cfg(tmp_path, num_beams=1)
    save_config(cfg, str(tmp_path / "exp.json"))
    out = subprocess.run([sys.executable, "-m", "vidchapters_tpu_torch.train.dvc_main",
                          "--config", str(tmp_path / "exp.json"), "--eval", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert "number of params" in out.stdout and "'chapters_soda_c'" in out.stdout
    foreign = tmp_path / "reference.pth"
    torch.save({"state_dict": {}}, foreign)
    with pytest.raises(ValueError, match="neither a checkpoint of train/dvc_main nor"):
        main(cfg, load=str(foreign), device="cpu")


class _ChapterText:
    """A tokenizer whose text is a chapter string made from the token ids,
    so that random weights give predictions to score: two time tokens and
    three words per row, all read from the row's ids."""

    def batch_decode(self, seqs, skip_special_tokens=True):
        texts = []
        for row in np.asarray(seqs):
            start = int(row[0]) % 50
            end = start + 1 + int(row[1]) % 49
            words = " ".join(f"w{int(t) % 5}" for t in row[2:5])
            texts.append(f"<time={start}> <time={end}> {words}")
        return texts


def test_evaluate_identical_to_jax(standard_route):
    from vidchapters_tpu.config import GenerationConfig as JGen
    from vidchapters_tpu.train.dvc_train import evaluate as jax_evaluate
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.train.dvc_train import evaluate

    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg, seed=2)
    model = port_model(tcfg, params)
    rng = np.random.default_rng(4)
    batches, refs = [], {}
    for b in range(2):
        tokens = rng.integers(3, 32000, size=(2, 12)).astype(np.int32)
        tokens[1, 8:] = 0
        vids = [f"vid{b}{i}" for i in range(2)]
        batches.append({"video": rng.normal(size=(2, 16, 128)).astype(np.float32),
                        "input_tokens": tokens, "video_id": vids,
                        "duration": np.array([100.0, 80.0], np.float32)})
        for v, dur in zip(vids, (100.0, 80.0)):
            refs[v] = {"duration": dur, "timestamps": [[0.0, dur / 2], [dur / 2, dur]],
                       "sentences": ["w1 w2 w3", "w4 w0 w1"]}
    tok = _ChapterText()
    ref_preds, ref_metrics = jax_evaluate(
        jmodel, params, batches, tok, JGen(num_beams=3, max_length=8, repetition_penalty=2.0),
        100, references=[refs], seed=0)
    preds, metrics = evaluate(model, batches, tok,
                              GenerationConfig(num_beams=3, max_length=8,
                                               repetition_penalty=2.0),
                              100, references=[refs], seed=0)
    assert sum(len(p) for p in ref_preds.values()) == 4  # every video has a chapter
    assert preds == ref_preds
    assert metrics == ref_metrics and metrics["Recall"] > 0


def test_checkpoint_manager_policy(tmp_path):
    """best by the metric (max), last for resume, archives pruned oldest
    first, manager.json's best_value read back, restore into a fresh state."""
    from vidchapters_tpu_torch.config import OptimConfig
    from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.train.dvc_train import TrainState
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    def state(seed):
        model = torch.nn.Linear(3, 2)
        torch.nn.init.normal_(model.weight, generator=torch.Generator().manual_seed(seed))
        return TrainState(model, build_optimizer(OptimConfig(), 10, model.parameters()), seed)

    mgr = CheckpointManager(str(tmp_path), best_metric="CIDEr", keep_last=2, keep_best=2)
    saved = {}
    for epoch, cider in enumerate([0.1, 0.3, 0.2, 0.4]):
        st = state(epoch)
        st.optimizer.count = epoch + 1
        saved[epoch] = st.model.weight.detach().clone()
        better = mgr.maybe_save_best(st, epoch, {"CIDEr": cider})
        assert better == (cider in (0.1, 0.3, 0.4))
        mgr.save_last(st, epoch)
    names = sorted(p.name for p in tmp_path.iterdir() if not p.name.endswith(".json"))
    assert names == ["best", "best_e3", "last", "last_e3"]
    assert mgr.meta("best") == {"epoch": 3, "CIDEr": 0.4} and mgr.meta("last") == {"epoch": 3}
    assert CheckpointManager(str(tmp_path)).best_value == 0.4
    fresh = state(99)
    mgr.restore("best", fresh)
    assert torch.equal(fresh.model.weight, saved[3])
    assert fresh.step == 3 and fresh.optimizer.count == 4
