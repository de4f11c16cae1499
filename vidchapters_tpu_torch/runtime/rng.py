"""The dropout randomness of one train step.

Counterpart of ``fold_in(rng, state.step)`` in
``vidchapters_tpu/train/dvc_train.py`` (and of ``runtime/rng.py``'s
per-step key there): every random draw of a step comes from ``(seed,
step)``, so running a step again from the same seed and step gives the same
dropout masks. The numbers differ from JAX's: the law is the same.

With data parallelism each rank folds in its data rank (from rank 1 up, so
data rank 0 draws what one process draws): JAX draws a global batch's masks
from one key, so no two rows share theirs, and neither do rows of different
data ranks here. The ranks of one model group (one data rank) draw one
stream: a tensor sharded over the model axis takes its slice of the mask of
the whole tensor (``keep_mask``'s ``shard``), and the hash routes offset
their head index (``ops/fused_attention``'s ``h0``), so each rank keeps the
elements one process keeps.

- Element masks (``_apply_dropout``) come from ``generator``, a
  ``torch.Generator`` on the device of the tensors it masks.
- Hash-mask dropout (the fused attention kernel, the dense attention route)
  takes one uint32 per call from ``seed32``, drawn on the host so that
  passing it to a kernel needs no device sync.

A block rematerialised in training (``models/t5.py``) draws its masks
twice: ``get_state`` before the first pass, and ``replay`` of that state
around the recompute, which puts both parts of the live stream back after.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class StepRng:
    def __init__(self, seed: int, step: int, device: "str | torch.device", rank: int = 0):
        """``rank``: the data rank (``runtime/mesh.data_rank``)."""
        entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
        torch_seed, host_seed = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(torch_seed))
        self._host = np.random.default_rng(int(host_seed))

    def get_state(self) -> tuple:
        """Both parts' state: the generator's and the host stream's."""
        return self.generator.get_state(), self._host.bit_generator.state

    def set_state(self, state: tuple) -> None:
        self.generator.set_state(state[0])
        self._host.bit_generator.state = state[1]

    def replay(self, state: tuple) -> "_Replay":
        """A context (re-entrant) that draws from ``state`` inside and puts
        the live state back on the way out."""
        return _Replay(self, state)

    def seed32(self) -> int:
        """A fresh uint32 seed for one hash-mask dropout call."""
        return int(self._host.integers(0, 2**32, dtype=np.uint64))

    def keep_mask(self, x: torch.Tensor, keep: float,
                  shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        """Bool mask of ``x``'s shape, each element True with probability
        ``keep``. ``shard = (dim, parts, index)``: ``x`` is part ``index`` of
        ``parts`` along ``dim`` of a whole tensor; the mask of the whole is
        drawn and this part of it kept."""
        if shard is None or shard[1] == 1:
            return torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        dim, parts, index = shard
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = n * parts
        whole = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return whole.narrow(dim, index * n, n)


class _Replay:
    def __init__(self, rng: StepRng, state: tuple):
        self.rng, self.state, self.live = rng, state, None

    def __enter__(self) -> None:
        self.live = self.rng.get_state()
        self.rng.set_state(self.state)

    def __exit__(self, *exc) -> None:
        self.rng.set_state(self.live)
