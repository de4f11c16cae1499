"""Learning-rate schedules and the optimizer of the train step.

Counterpart of ``vidchapters_tpu/train/schedules.py`` (the reference's
step-wise adjustment, util/misc.py:15-42): linear warmup into constant,
linear decay or cosine decay, as a function of the update count; and the
optimizer chain ``clip_by_global_norm -> adamw`` with optax's semantics,
which ``torch.optim.AdamW`` with ``clip_grad_norm_`` does not have:

- the update numbered n (from 1) uses ``schedule(n - 1)``: the first
  update has the warmup's lr 0;
- bias correction with t from 1; ``eps`` outside the square root, no
  ``eps_root``;
- decoupled weight decay ``wd * param`` on every parameter, added to the
  Adam direction before the learning rate scales it;
- clipping ``g * max_norm / ||g||`` when ``||g|| >= max_norm``, with no
  ``+1e-6`` in the denominator;
- ``mu_dtype`` bfloat16 (optax 0.2.6 ``scale_by_adam``): the new first
  moment is ``(1 - b1) * g + b1 * mu``, where ``b1 * mu`` is computed in
  bf16 (``b1`` rounded to bf16, the product rounded) and the sum in fp32;
  the update uses that fp32 moment, and only the stored ``mu`` is cast to
  bf16. ``nu`` stays fp32. This is optax's op-by-op result; a jitted JAX
  step may keep ``b1 * mu`` in fp32 (XLA's excess precision).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import numpy as np
import torch

from vidchapters_tpu_torch.config import OptimConfig


def build_schedule(cfg: OptimConfig, num_training_steps: int) -> Callable[[int], float]:
    """``schedule(step) -> lr``, in float32 arithmetic as the JAX
    package's ``jnp`` schedule computes it."""
    warmup = max(int(cfg.fraction_warmup_steps * num_training_steps), 1)
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup:
            return float(f32(cfg.lr) * step / f32(warmup))
        if cfg.schedule == "linear_with_warmup":
            frac = (f32(num_training_steps) - step) / f32(max(num_training_steps - warmup, 1))
            return float(f32(cfg.lr) * max(frac, f32(0.0)))
        if cfg.schedule == "cosine_with_warmup":
            progress = np.clip((step - f32(warmup)) / f32(max(num_training_steps - warmup, 1)),
                               f32(0.0), f32(1.0))
            cos = np.cos(f32(math.pi) * progress, dtype=np.float32)
            return float(f32(cfg.lr) * f32(0.5) * (f32(1.0) + cos))
        return float(f32(cfg.lr))  # constant after warmup

    return schedule


def staircase_decay(lr: float, transition_steps: int, gamma: float) -> Callable[[int], float]:
    """optax's ``exponential_decay(lr, transition_steps, gamma,
    staircase=True)`` in float32: ``lr * gamma ** floor(count /
    transition_steps)`` (the reference's StepLR by steps)."""
    f32 = np.float32

    def schedule(count: int) -> float:
        p = np.floor(f32(count) / f32(transition_steps))
        return float(f32(lr) * np.power(f32(gamma), p, dtype=np.float32))

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum ||t||^2)`` over all tensors, in float32 (optax.global_norm)."""
    return torch.sqrt(torch.stack([(t.float() * t.float()).sum() for t in tensors]).sum())


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...))``
    over a list of parameters, updated in place. ``step()`` reads each
    parameter's ``.grad`` (None counts as zeros), applies one update, and
    returns the global norm of the raw gradients (before the clip). The
    state (``mu`` in ``mu_dtype``, ``nu`` in float32, ``count``) lives on
    the parameters' devices."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_max_norm: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        # b1 as a constant of mu's dtype (JAX's weak-typed Python float)
        self._b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        self.weight_decay = weight_decay
        self.clip_max_norm = clip_max_norm
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        g_norm = global_norm(grads)
        if self.clip_max_norm > 0:
            trigger = g_norm < self.clip_max_norm
            grads = [torch.where(trigger, g, g / g_norm.to(g.dtype) * self.clip_max_norm)
                     for g in grads]
        lr = self.schedule(self.count)  # the count before this update
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            m = (1.0 - b1) * g + self._b1_mu * mu  # b1 * mu in mu's dtype, the sum fp32
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (m / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            mu.copy_(m)
            u = u + self.weight_decay * p.float()
            p.copy_(p + (u * -lr).to(p.dtype))
        return g_norm

    def state_dict(self) -> dict:
        """The moments (``mu`` in its own dtype) and the update count (the
        schedule is rebuilt from the config)."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments for "
                             f"{len(self.params)} parameters")
        for mine, saved in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            mine.copy_(saved)
        self.count = int(state["count"])


def build_optimizer(cfg: OptimConfig, num_training_steps: int,
                    params: Iterable[torch.nn.Parameter]) -> ClipAdamW:
    """Global-norm clip + AdamW on ``params`` (dvc.py:112-116, 346-351),
    the first moment stored in ``cfg.mu_dtype`` ("float32" or "bfloat16").
    ``fused_flat`` changes nothing that is computed and is ignored."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.mu_dtype not in dtypes:
        raise ValueError(f"mu_dtype={cfg.mu_dtype!r}: expected one of {sorted(dtypes)}")
    return ClipAdamW(params, build_schedule(cfg, num_training_steps), b1=cfg.beta1,
                     b2=cfg.beta2, weight_decay=cfg.weight_decay,
                     clip_max_norm=cfg.clip_max_norm, mu_dtype=dtypes[cfg.mu_dtype])
