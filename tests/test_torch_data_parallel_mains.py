"""``train/dvc_main`` and ``train/grounding_main`` over two gloo ranks on the
CPU, launched as a user launches them: one ``python -m`` process a rank
with the ``VIDCHAPTERS_*`` variables and one ``PYTHONHASHSEED``.

- ``dvc_main``: one ``log.txt`` line an epoch and one set of checkpoints
  (rank 0 writes them); both ranks report the same parameter checksum,
  which is that of the ``last`` checkpoint; a second launch resumes from
  ``last``; the gathered val predictions hold exactly the videos the JAX
  package's sharded iterators yield (9 val videos over 2 ranks at eval
  batch 4: rank 0 reads 0, 2, 4, 6 and drops 8, in both packages).
- ``grounding_main``: two epochs with the smoke speech tower, the same
  checksum on both ranks and in ``last``, one log and one prediction file.
"""

import dataclasses
import json
import re
import sys

import numpy as np

import torch

from tests.test_torch_data_parallel import ROOT, launch, wait_all

CHECKSUM = re.compile(r"rank (\d): parameters identical on 2 ranks \(checksum (\w+)\)")


def _checksums(outs):
    found = [CHECKSUM.findall(out) for out in outs]
    assert [f[0][0] for f in found] == ["0", "1"], outs
    assert found[0][0][1] == found[1][0][1]
    return found[0][0][1]


def _last_checksum(path, model):
    from vidchapters_tpu_torch.parallel.sharding import parameter_checksum

    payload = torch.load(path, weights_only=True)
    model.load_state_dict(payload["model"])
    return payload, parameter_checksum(model)


def _final_metrics(out):
    return out.strip().splitlines()[-1]


def _sharded_val_videos(root, tcfg):
    """The val videos each package's sharded eval iterators yield, rank by
    rank."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.data import dvc_dataset as jds
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jtok
    from vidchapters_tpu_torch.data import dvc_dataset as tds
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer as ttok

    d = tcfg.data
    jdata = jc.DataConfig(max_feats=d.max_feats, features_dim=d.features_dim,
                          max_input_tokens=d.max_input_tokens,
                          max_output_tokens=d.max_output_tokens)
    out = {}
    for name, mod, tok, data in (("jax", jds, jtok, jdata), ("port", tds, ttok, d)):
        ds = mod.DenseVideoCaptioningDataset(str(root / "val.json"), str(root / "feats"),
                                             tok("", 100), data,
                                             subtitles_path=str(root / "asr.pkl"))
        out[name] = [[v for b in mod.EpochIterator(ds, 4, data, shuffle=False, drop_last=False,
                                                   num_shards=2, shard_index=r,
                                                   bucket_inputs=True)
                      for v in b["video_id"]] for r in range(2)]
    return out


def test_dvc_main_two_ranks_checkpoints_resume_and_gathered_eval(tmp_path):
    from tests.test_torch_dvc_main import _tiny_cfg, _write_dataset
    from vidchapters_tpu_torch.config import save_config
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    _write_dataset(tmp_path, n_train=8, n_val=9)
    cfg = _tiny_cfg(tmp_path, num_beams=2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_batch_size=4))
    save_config(cfg, tmp_path / "exp.json")
    argv = [sys.executable, "-m", "vidchapters_tpu_torch.train.dvc_main", "--config",
            str(tmp_path / "exp.json"), "--device", "cpu"]
    procs = launch(argv, cwd=ROOT)
    shards = _sharded_val_videos(tmp_path, cfg)  # while the ranks run
    outs = wait_all(procs, timeout=240)

    assert shards["port"] == shards["jax"]
    assert [len(s) for s in shards["jax"]] == [4, 4]  # of 5 and 4: rank 0 drops one
    assert "video000016" not in shards["jax"][0]  # the 9th val video
    ckpt = tmp_path / "ckpt"
    preds = json.loads((ckpt / "chapters_val_preds_e0.json").read_text())["results"]
    assert sorted(preds) == sorted(shards["jax"][0] + shards["jax"][1])
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0] and np.isfinite(log[0]["train_total_loss"])
    files = {p.name for p in ckpt.iterdir()}
    assert {"best", "last", "manager.json", "best.meta.json", "last.meta.json"} <= files
    assert not [f for f in files if f.endswith(".tmp")]
    model = Vid2Seq(cfg.model)
    payload, digest = _last_checksum(ckpt / "last", model)
    assert payload["step"] == 2 and payload["optimizer"]["count"] == 2  # 8 videos / 2 ranks / 2
    assert _checksums(outs) == digest
    assert _final_metrics(outs[0]) == _final_metrics(outs[1])

    # a second launch resumes from `last` and trains the second epoch
    save_config(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=2)),
                tmp_path / "exp.json")
    outs = wait_all(launch(argv, cwd=ROOT), timeout=240)
    assert all("resumed from epoch 0" in out and "Epoch [1] chapters" in out for out in outs)
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0, 1]
    payload, digest = _last_checksum(ckpt / "last", model)
    assert payload["epoch"] == 1 and payload["step"] == 4
    assert _checksums(outs) == digest


def test_grounding_main_two_ranks(tmp_path):
    from tests.test_torch_grounding_main import _tiny_recipe, _write_vmr
    from vidchapters_tpu_torch.config import GroundingConfig
    from vidchapters_tpu_torch.models.grounding import MomentDETR

    _write_vmr(tmp_path, n=11)  # uncut, rank 0's shard would hold 3 batches and rank 1's 2
    recipe = _tiny_recipe(tmp_path, speech=True)
    save = tmp_path / "ckpt"
    outs = wait_all(launch([sys.executable, "-m", "vidchapters_tpu_torch.train.grounding_main",
                            "--recipe", str(recipe), "--save-dir", str(save), "--device", "cpu",
                            "--epochs", "2"], cwd=ROOT), timeout=240)
    assert _final_metrics(outs[0]) == _final_metrics(outs[1])
    assert all(np.isfinite(v) for v in json.loads(_final_metrics(outs[0])).values())
    log = [json.loads(line) for line in (save / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0, 1]
    preds = [json.loads(line) for line in (save / "test_preds.jsonl").read_text().splitlines()]
    # the eval runs whole, its last partial batch dropped
    assert sorted(p["qid"] for p in preds) == list(range(10))
    model = MomentDETR(GroundingConfig(**json.loads(recipe.read_text())["model"]))
    payload, digest = _last_checksum(save / "last", model)
    assert payload["step"] == 4  # 2 epochs x 10 of 11 queries / 2 ranks / batch 2
    assert _checksums(outs) == digest


def test_grounding_batches_give_every_rank_as_many(monkeypatch):
    """``grounding_main.batches`` over W ranks: every rank yields as many
    batches. Where the JAX package's ranks do too, the batches are its
    batches; where its ranks differ (17 queries over 2 ranks at batch 3:
    3 and 2), each port rank yields the fewest, JAX's own first batches."""
    from vidchapters_tpu.train import grounding_main as jgm
    from vidchapters_tpu_torch.train import grounding_main as tgm

    for mod in (jgm, tgm):
        monkeypatch.setattr(mod, "grounding_collate", lambda rows, *a, **k: list(rows))
    uneven = 0
    for n in range(1, 20):
        for world in (2, 3, 4):
            for bs in (1, 2, 3):
                got, ref = ([list(m.batches(list(range(n)), bs, 0, 0, True, n, num_shards=world,
                                            shard_index=r)) for r in range(world)]
                            for m in (tgm, jgm))
                fewest = min(len(b) for b in ref)
                assert [len(b) for b in got] == [fewest] * world, (n, world, bs)
                assert got == [b[:fewest] for b in ref], (n, world, bs)
                uneven += len({len(b) for b in ref}) > 1
    assert uneven  # the grid holds cases where the JAX package's ranks differ
    assert [len(list(jgm.batches(list(range(17)), 3, 0, 0, True, 0, num_shards=2,
                                 shard_index=r))) for r in range(2)] == [3, 2]
