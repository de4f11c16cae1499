"""The dropout randomness of one train step.

Counterpart of ``fold_in(rng, state.step)`` in
``vidchapters_tpu/train/dvc_train.py`` (and of ``runtime/rng.py``'s
per-step key there): every random draw of a step comes from ``(seed,
step)``, so running a step again from the same seed and step gives the same
dropout masks. The numbers differ from JAX's: the law is the same.

With data parallelism each rank folds in its rank (from rank 1 up, so rank
0 draws what one process draws): JAX draws a global batch's masks from one
key, so no two rows share theirs, and neither do rows of different ranks
here.

- Element masks (``_apply_dropout``) come from ``generator``, a
  ``torch.Generator`` on the device of the tensors it masks.
- Hash-mask dropout (the fused attention kernel, the dense attention route)
  takes one uint32 per call from ``seed32``, drawn on the host so that
  passing it to a kernel needs no device sync.
"""

from __future__ import annotations

import numpy as np
import torch


class StepRng:
    def __init__(self, seed: int, step: int, device: "str | torch.device", rank: int = 0):
        entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
        torch_seed, host_seed = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(torch_seed))
        self._host = np.random.default_rng(int(host_seed))

    def seed32(self) -> int:
        """A fresh uint32 seed for one hash-mask dropout call."""
        return int(self._host.integers(0, 2**32, dtype=np.uint64))

    def keep_mask(self, x: torch.Tensor, keep: float) -> torch.Tensor:
        """Bool mask of ``x``'s shape, each element True with probability ``keep``."""
        return torch.rand(x.shape, generator=self.generator, device=x.device) < keep
