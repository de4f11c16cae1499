"""``train/dvc_main`` at ``model_parallel_size`` 2 over gloo ranks on the
CPU, launched as a user launches it (one ``python -m`` process a rank with
the ``VIDCHAPTERS_*`` variables and one ``PYTHONHASHSEED``):

- grid 1 x 2 (2 ranks): one ``log.txt`` line, ``best`` and ``last`` written
  once, whole, in the one-process format (they load into an unsharded
  Vid2Seq, Adam moments of the whole parameters' shapes), both ranks
  report the checksum of the gathered weights, which is that of ``last``,
  and the same final metrics;
- a second launch at grid 2 x 2 (4 ranks) resumes from that ``last`` and
  trains the second epoch, each data rank on half the rows.
"""

import dataclasses
import json
import re
import sys

import numpy as np

import torch

from tests.test_torch_data_parallel import ROOT, launch, wait_all

CHECKSUM = re.compile(r"rank (\d): parameters identical on (\d) ranks \(checksum (\w+)\)")


def _checksum(outs, world: int) -> str:
    found = [CHECKSUM.findall(out) for out in outs]
    assert [f[0][:2] for f in found] == [(str(r), str(world)) for r in range(world)], outs
    assert len({f[0][2] for f in found}) == 1
    return found[0][0][2]


def test_dvc_main_on_a_model_axis_saves_whole_and_resumes_at_another_grid(tmp_path):
    from tests.test_torch_dvc_main import _tiny_cfg, _write_dataset
    from vidchapters_tpu_torch.config import MeshConfig, save_config
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.parallel.sharding import parameter_checksum

    _write_dataset(tmp_path, n_train=8, n_val=4)
    cfg = _tiny_cfg(tmp_path, num_beams=2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh=MeshConfig(model_parallel_size=2)))
    save_config(cfg, tmp_path / "exp.json")
    argv = [sys.executable, "-m", "vidchapters_tpu_torch.train.dvc_main", "--config",
            str(tmp_path / "exp.json"), "--device", "cpu"]
    outs = wait_all(launch(argv, world=2, cwd=ROOT), timeout=240)

    ckpt = tmp_path / "ckpt"
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0] and np.isfinite(log[0]["train_total_loss"])
    assert {"best", "last", "manager.json"} <= {p.name for p in ckpt.iterdir()}
    preds = json.loads((ckpt / "chapters_val_preds_e0.json").read_text())["results"]
    assert len(preds) == 4  # the val videos, decoded over both ranks and gathered
    payload = torch.load(ckpt / "last", weights_only=True)
    model = Vid2Seq(cfg.model)
    model.load_state_dict(payload["model"])  # whole: the one-process names and shapes
    assert [tuple(m.shape) for m in payload["optimizer"]["mu"]] == [
        tuple(p.shape) for p in model.parameters()]
    assert payload["step"] == 4 and payload["optimizer"]["count"] == 4  # 8 videos at batch 2
    assert _checksum(outs, 2) == parameter_checksum(model)
    assert outs[0].strip().splitlines()[-1] == outs[1].strip().splitlines()[-1]

    # grid 2 x 2 resumes from the 1 x 2 checkpoint
    save_config(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=2)),
                tmp_path / "exp.json")
    outs = wait_all(launch(argv, world=4, cwd=ROOT), timeout=240)
    assert all("resumed from epoch 0" in out and "Epoch [1] chapters" in out for out in outs)
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0, 1]
    payload = torch.load(ckpt / "last", weights_only=True)
    model.load_state_dict(payload["model"])
    assert payload["epoch"] == 1 and payload["step"] == 6  # + 8 videos / 2 data ranks / 2
    assert _checksum(outs, 4) == parameter_checksum(model)
    assert len({out.strip().splitlines()[-1] for out in outs}) == 1
