"""CLIP's text tower in PyTorch: the frozen query encoder of Moment-DETR.

Counterpart of the text half of ``vidchapters_tpu/models/clip.py``
(OpenAI CLIP's causal text transformer with QuickGELU; the reference runs
it inside Moment-DETR, moment_detr/moment_detr/model.py:53-56,94-107, and
takes its per-token features projected through ``text_projection``). The
dtypes are the JAX module's: products in ``cfg.dtype`` (bf16 in the
recipe) with fp32 parameters, LayerNorm statistics in fp32 and its output
in the compute dtype, scores rounded to the compute dtype before the fp32
softmax, the causal mask as ``-1e9`` (not ``-inf``), and the projected
output in fp32. The tower is causal, so it takes the plain attention, as
the JAX module does.

The converters take plain dicts of arrays (or tensors) under OpenAI's
``clip`` names (the released ``.pt``) or HF ``CLIPModel``'s names and give
this module's ``state_dict``; a name of the text tower they cannot place
raises, and the vision tower's names are passed over. The vision tower
(``CLIPImageEncoder``) waits for the feature factory (ROADMAP.md §1 item
7).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.models.t5 import _linear

NEG_INF = -1e9


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 768
    mlp_dim: int = 0  # 0 = 4 * width
    dtype: str = "bfloat16"


TEXT_L14 = CLIPTextConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dt: torch.dtype) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dt)``: statistics and affine in fp32, output in ``dt``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dt)


class ResidualBlock(nn.Module):
    """Pre-norm block: causal multi-head attention, then a QuickGELU MLP."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype, mlp_dim: int = 0):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn_in = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, mlp_dim or 4 * width)
        self.mlp_proj = nn.Linear(mlp_dim or 4 * width, width)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _layer_norm(x, self.ln_1, dt)
        b, l, w = h.shape
        d_head = w // self.heads
        q, k, v = (t.reshape(b, l, self.heads, d_head).transpose(1, 2)
                   for t in _linear(h, self.attn_in, dt).chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(d_head)
        scores = torch.where(causal_mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, w)
        x = x + _linear(attn, self.attn_out, dt)
        h = quick_gelu(_linear(_layer_norm(x, self.ln_2, dt), self.mlp_fc, dt))
        return x + _linear(h, self.mlp_proj, dt)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.blocks = nn.ModuleList(ResidualBlock(cfg.width, cfg.heads, self.dtype, cfg.mlp_dim)
                                    for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.output_dim))

    def forward(self, tokens: torch.Tensor, return_tokens: bool = False) -> torch.Tensor:
        """tokens [B, L] -> pooled [B, output_dim] at the EOT token (the
        highest id); with ``return_tokens``, per-token projected features
        [B, L, output_dim] (the Moment-DETR use). fp32 either way."""
        dt = self.dtype
        l = tokens.shape[1]
        x = self.token_embedding[tokens.long()].to(dt) + self.positional_embedding[:l].to(dt)
        causal = torch.ones(l, l, dtype=torch.bool, device=tokens.device).tril()
        for block in self.blocks:
            x = block(x, causal)
        x = _layer_norm(x, self.ln_final, dt)
        projected = torch.matmul(x, self.text_projection.to(dt)).float()
        if return_tokens:
            return projected
        eot = torch.argmax(tokens, dim=-1)
        return projected[torch.arange(tokens.shape[0], device=tokens.device), eot]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPTextEncoder":
        """Seeded random weights with the JAX module's laws: embeddings
        N(0, 0.02) and N(0, 0.01), the projection N(0, 0.02), products
        N(0, 1/fan_in) with zero biases, norms at 1 and 0."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        normal(self.token_embedding, 0.02)
        normal(self.positional_embedding, 0.01)
        normal(self.text_projection, 0.02)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                normal(m.weight, m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------

# OpenAI's sub-module names -> this module's
_OPENAI_BLOCK = {"ln_1": "ln_1", "ln_2": "ln_2", "attn.out_proj": "attn_out",
                 "mlp.c_fc": "mlp_fc", "mlp.c_proj": "mlp_proj"}
_HF_BLOCK = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "self_attn.out_proj": "attn_out",
             "mlp.fc1": "mlp_fc", "mlp.fc2": "mlp_proj"}


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _finish(out: Dict[str, torch.Tensor], unplaced, what: str) -> Dict[str, torch.Tensor]:
    if unplaced:
        raise ValueError(f"{what}: names of the text tower it cannot place: {sorted(unplaced)}")
    n = 1 + max((int(k.split(".")[1]) for k in out if k.startswith("blocks.")), default=-1)
    expected = {"token_embedding", "positional_embedding", "text_projection",
                "ln_final.weight", "ln_final.bias"}
    expected |= {f"blocks.{i}.{m}.{leaf}" for i in range(n)
                 for m in ("ln_1", "ln_2", "attn_in", "attn_out", "mlp_fc", "mlp_proj")
                 for leaf in ("weight", "bias")}
    missing, stray = sorted(expected - set(out)), sorted(set(out) - expected)
    if missing or stray:
        raise ValueError(f"{what}: no value for {missing}; values of no layer: {stray}")
    return out


def convert_openai_clip_text(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """OpenAI ``clip`` state dict (the released ``.pt``, both towers) -> this
    module's ``state_dict``. Names under ``visual.`` and the model's
    ``logit_scale`` / ``input_resolution`` / ``context_length`` /
    ``vocab_size`` entries belong to the other tower or to no tower and are
    passed over; any other name this converter cannot place raises."""
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    top = {"token_embedding.weight": "token_embedding",
           "positional_embedding": "positional_embedding",
           "text_projection": "text_projection",
           "ln_final.weight": "ln_final.weight", "ln_final.bias": "ln_final.bias"}
    skip = ("logit_scale", "input_resolution", "context_length", "vocab_size")
    block = re.compile(r"^transformer\.resblocks\.(\d+)\.(.+)\.(weight|bias)$")
    inproj = re.compile(r"^transformer\.resblocks\.(\d+)\.attn\.in_proj_(weight|bias)$")
    for name, value in sd.items():
        if name.startswith("visual.") or name in skip:
            continue
        if name in top:
            out[top[name]] = _tensor(value)
        elif (m := inproj.match(name)):
            out[f"blocks.{m.group(1)}.attn_in.{m.group(2)}"] = _tensor(value)
        elif (m := block.match(name)) and m.group(2) in _OPENAI_BLOCK:
            out[f"blocks.{m.group(1)}.{_OPENAI_BLOCK[m.group(2)]}.{m.group(3)}"] = _tensor(value)
        else:
            unplaced.append(name)
    return _finish(out, unplaced, "convert_openai_clip_text")


def convert_hf_clip_text(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """HF ``transformers.CLIPModel`` state dict -> this module's
    ``state_dict``: q/k/v concatenated into the in-projection, the
    ``text_projection`` Linear transposed to ``[width, output_dim]``. The
    vision tower's names, ``logit_scale`` and the ``position_ids`` buffer are
    passed over; any other name raises."""
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    top = {"text_model.embeddings.token_embedding.weight": "token_embedding",
           "text_model.embeddings.position_embedding.weight": "positional_embedding",
           "text_model.final_layer_norm.weight": "ln_final.weight",
           "text_model.final_layer_norm.bias": "ln_final.bias"}
    block = re.compile(r"^text_model\.encoder\.layers\.(\d+)\.(.+)\.(weight|bias)$")
    qkv: Dict[tuple, torch.Tensor] = {}
    for name, value in sd.items():
        if (name.startswith(("vision_model.", "visual_projection."))
                or name in ("logit_scale", "text_model.embeddings.position_ids")):
            continue
        if name in top:
            out[top[name]] = _tensor(value)
        elif name == "text_projection.weight":
            out["text_projection"] = _tensor(value).t().contiguous()
        elif (m := block.match(name)) and m.group(2) in _HF_BLOCK:
            out[f"blocks.{m.group(1)}.{_HF_BLOCK[m.group(2)]}.{m.group(3)}"] = _tensor(value)
        elif m and m.group(2) in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            qkv[(m.group(1), m.group(2)[10], m.group(3))] = _tensor(value)
        else:
            unplaced.append(name)
    for i, leaf in sorted({(i, leaf) for i, _, leaf in qkv}):
        parts = [qkv.get((i, c, leaf)) for c in "qkv"]
        if any(p is None for p in parts):
            raise ValueError(f"convert_hf_clip_text: no value for layer {i}'s q, k or v {leaf}")
        out[f"blocks.{i}.attn_in.{leaf}"] = torch.cat(parts, dim=0)
    return _finish(out, unplaced, "convert_hf_clip_text")
