"""Checkpoint management: best / last / periodic, with ``torch.save``.

Counterpart of ``vidchapters_tpu/runtime/checkpoint.py`` with the same
policy (the reference's dvc.py:402-441): ``best`` by ``best_metric`` /
``best_mode``, ``last`` for resume, ``keep_last`` / ``keep_best`` > 1 also
archive ``last_e{epoch}`` / ``best_e{epoch}`` copies pruned oldest first,
``epoch_{epoch}`` every ``save_every_epochs``, ``manager.json`` holding
``best_value``, and a ``{name}.meta.json`` beside each checkpoint.

A checkpoint is one ``torch.save`` file of ``{"model": state_dict,
"optimizer": ClipAdamW state, "step", "epoch"}``, written to ``name.tmp``
and renamed over ``name``, so a reader never sees half a file. At T5-base
width with its two Adam moments that is 3.47 GB a file (3,470,764,565 bytes,
written by ``chip_smoke.py``'s phase 5).

Over several ranks (``runtime/mesh.py``) the JAX package's policy holds
(its checkpoint.py:64-100, :127): rank 0 alone writes the files, the meta
and ``manager.json`` and prunes the archives, and every rank waits at a
barrier until it has; every rank restores. The best value is rank 0's, so
that every rank takes the same ``best`` decision.

A model sharded over the model axis (``parallel/sharding.shard_params``)
is saved whole: every rank gathers its model group's parameters and Adam
moments (rank 0 writes them), so the files are those of one process, in
the port's names, and a restore at any grid cuts them again. A run saved
at model axis 2 resumes at 1, and the other way.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from vidchapters_tpu_torch.parallel import sharding
from vidchapters_tpu_torch.runtime.collectives import all_gather_object
from vidchapters_tpu_torch.runtime.mesh import barrier, is_main_process


def state_payload(state, epoch: int) -> Dict[str, Any]:
    """What a checkpoint holds of a ``train.dvc_train.TrainState``: the whole
    model and moments (gathered over the model group when it is sharded;
    every rank of the group calls this then)."""
    model, optim = state.model, state.optimizer.state_dict()
    if sharding.is_sharded(model):
        optim = dict(optim, mu=sharding.gather_tensors(model, optim["mu"]),
                     nu=sharding.gather_tensors(model, optim["nu"]))
    return {"model": sharding.gather_params(model), "optimizer": optim,
            "step": int(state.step), "epoch": int(epoch)}


def load_payload(state, payload: Dict[str, Any]) -> None:
    """Load a checkpoint's payload into ``state`` (model, optimizer and
    step), cutting this rank's slices when the model is sharded."""
    model, optim = state.model, payload["optimizer"]
    sharding.load_full_state_dict(model, payload["model"])
    if sharding.is_sharded(model):
        optim = dict(optim, mu=sharding.cut_tensors(model, optim["mu"]),
                     nu=sharding.cut_tensors(model, optim["nu"]))
    state.optimizer.load_state_dict(optim)
    state.step = int(payload["step"])


class CheckpointManager:
    def __init__(self, save_dir: str, best_metric: str = "CIDEr",
                 best_mode: str = "max", save_every_epochs: int = 0,
                 keep_last: int = 1, keep_best: int = 1):
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.save_every_epochs = save_every_epochs
        self.keep_last = max(1, keep_last)
        self.keep_best = max(1, keep_best)
        self.best_value: Optional[float] = None
        meta = self.dir / "manager.json"
        if meta.exists():
            self.best_value = json.loads(meta.read_text()).get("best_value")

    def _save(self, name: str, payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
        tmp = self.dir / (name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, self.dir / name)
        (self.dir / (name + ".meta.json")).write_text(json.dumps(meta))

    def meta(self, name: str) -> Dict[str, Any]:
        p = self.dir / (name + ".meta.json")
        return json.loads(p.read_text()) if p.exists() else {}

    def has(self, name: str) -> bool:
        return (self.dir / name).exists()

    def _prune_archives(self, prefix: str, keep: int) -> None:
        """Drop the oldest ``{prefix}_e{epoch}`` archives beyond ``keep``."""
        found = sorted((int(m.group(1)), p) for p in self.dir.iterdir()
                       if (m := re.fullmatch(rf"{prefix}_e(\d+)", p.name)))
        for _, p in found[:max(0, len(found) - keep)]:
            p.unlink()
            (self.dir / (p.name + ".meta.json")).unlink(missing_ok=True)

    def save_last(self, state, epoch: int) -> None:
        payload = state_payload(state, epoch)  # every rank: it may gather
        if is_main_process():
            self._save("last", payload, {"epoch": epoch})
            if self.keep_last > 1:
                self._save(f"last_e{epoch}", payload, {"epoch": epoch})
                self._prune_archives("last", self.keep_last - 1)
            if self.save_every_epochs and (epoch + 1) % self.save_every_epochs == 0:
                self._save(f"epoch_{epoch}", payload, {"epoch": epoch})
        barrier()

    def maybe_save_best(self, state, epoch: int, metrics: Dict[str, float]) -> bool:
        value = all_gather_object(metrics.get(self.best_metric))[0]  # rank 0's
        if value is None:
            return False
        better = (self.best_value is None
                  or (self.best_mode == "max" and value > self.best_value)
                  or (self.best_mode == "min" and value < self.best_value))
        if better:
            self.best_value = float(value)
            payload = state_payload(state, epoch)
            if is_main_process():
                meta = {"epoch": epoch, self.best_metric: float(value)}
                self._save("best", payload, meta)
                if self.keep_best > 1:
                    self._save(f"best_e{epoch}", payload, meta)
                    self._prune_archives("best", self.keep_best - 1)
                (self.dir / "manager.json").write_text(
                    json.dumps({"best_value": self.best_value}))
            barrier()
        return better

    def load(self, name: str, map_location=None) -> Dict[str, Any]:
        """The payload of checkpoint ``name``."""
        return torch.load(self.dir / name, map_location=map_location, weights_only=True)

    def restore(self, name: str, state) -> None:
        """Load checkpoint ``name`` into ``state`` (model, optimizer and step),
        in place."""
        device = next(state.model.parameters()).device
        load_payload(state, self.load(name, map_location=device))
