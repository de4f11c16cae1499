"""Temporal visual transformer over per-frame CLIP features.

Counterpart of ``vidchapters_tpu/models/vit.py`` (the reference's model/vit.py
frame transformer): learned temporal position embedding, nearest-neighbour
resampled on a length mismatch; pre-norm blocks with scaled attention and an
exact-GELU MLP; final LayerNorm. Inputs are CLIP features ``[B, T, D]``.
Products run in ``cfg.dtype``; LayerNorm statistics in fp32. With ``rng``
(a ``runtime.rng.StepRng``) the forward is in training mode: dropout at
``drop_rate`` on the position-embedded input, the attention projection, the
MLP hidden and output, and at ``attn_drop_rate`` on the attention
probabilities, as the JAX package's ``deterministic=False``.

Tensor parallelism (``mp`` > 1, set by ``parallel/sharding.shard_params``):
``qkv`` holds the rank's heads of each of q, k and v, ``proj`` the rank's
input rows, ``fc1`` (weight and bias) the rank's hidden columns and ``fc2``
their rows; the row-sharded outputs are summed over the model group before
their bias. The 100 frames take the dense route and are not sharded over
the sequence, as there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.config import TemporalViTConfig
from vidchapters_tpu_torch.models.t5 import _apply_dropout, _linear, _row_linear, model_shard
from vidchapters_tpu_torch.parallel import tensor_parallel as tp
from vidchapters_tpu_torch.runtime.rng import StepRng


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dt: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dt)


class ViTAttention(nn.Module):
    mp = 1

    def __init__(self, cfg: TemporalViTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, rng: Optional[StepRng] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        b, n, c = x.shape
        hd = cfg.embed_dim // cfg.num_heads
        qkv = _linear(x, self.qkv, dt).view(b, n, 3, cfg.num_heads // self.mp, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [b, h, n, hd]
        scores = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
        probs = _apply_dropout(torch.softmax(scores, dim=-1).to(dt), cfg.attn_drop_rate, rng,
                               model_shard(self, 1))
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, -1)
        proj = _row_linear(out, self.proj, dt) if self.mp > 1 else _linear(out, self.proj, dt)
        return _apply_dropout(proj, cfg.drop_rate, rng)


class ViTBlock(nn.Module):
    mp = 1

    def __init__(self, cfg: TemporalViTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.attn = ViTAttention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, rng: Optional[StepRng] = None) -> torch.Tensor:
        dt = getattr(torch, self.cfg.dtype)
        rate = self.cfg.drop_rate
        into = tp.copy_to_model if self.mp > 1 else (lambda t: t)
        x = x + self.attn(into(_layer_norm(x, self.norm1, dt)), rng)
        h = F.gelu(_linear(into(_layer_norm(x, self.norm2, dt)), self.fc1, dt))
        h = _apply_dropout(h, rate, rng, model_shard(self, 2))
        h = _row_linear(h, self.fc2, dt) if self.mp > 1 else _linear(h, self.fc2, dt)
        return x + _apply_dropout(h, rate, rng)


class TemporalViT(nn.Module):
    def __init__(self, cfg: TemporalViTConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_features, cfg.embed_dim))
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, rng: Optional[StepRng] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = x.to(dt)
        t = x.shape[1]
        pos = self.pos_embed
        if t != cfg.num_features:
            # nearest interpolation along time (reference vit.py:117-125)
            idx = (torch.arange(t, device=x.device) * cfg.num_features) // t
            pos = pos[:, idx]
        x = _apply_dropout(x + pos.to(dt), cfg.drop_rate, rng)
        for blk in self.blocks:
            x = blk(x, rng)
        return _layer_norm(x, self.norm, dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal(0.02) position embedding, fan-in-scaled normal
        dense kernels, zero biases, unit LayerNorms (the same distributions
        as the JAX package's initializers, not the same numbers)."""
        pos = torch.randn(self.pos_embed.shape, generator=generator) * 0.02
        self.pos_embed.copy_(pos.clamp(-0.04, 0.04))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.in_features ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
