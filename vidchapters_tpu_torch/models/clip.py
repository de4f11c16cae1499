"""CLIP's two towers in PyTorch: the frame encoder of the feature factory
and the frozen query encoder of Moment-DETR.

Counterpart of ``vidchapters_tpu/models/clip.py`` (OpenAI CLIP: a conv
patch embedding, a class token and a pre-norm transformer with QuickGELU
for images; a causal text transformer for queries). The reference runs the
image tower at ViT-L/14 to make the datasets' frame features
(demo_vid2seq.py:98-99) and at ViT-B/32 in the run_on_video demo, and the
text tower inside Moment-DETR (moment_detr/moment_detr/model.py:53-56,
94-107, per-token features projected through ``text_projection``). The
dtypes are the JAX module's: products in ``cfg.dtype`` (bf16 by default)
with fp32 parameters, LayerNorm statistics in fp32 and its output in the
compute dtype, scores rounded to the compute dtype before the fp32
softmax, the causal mask as ``-1e9`` (not ``-inf``), and the projected
output in fp32.

Attention routes: the text tower is causal and takes the plain attention,
as the JAX module does. The image tower's attention is not causal; with
``USE_FUSED_ATTENTION`` (the default) it takes ``ops/fused_attention``
(for CUDA tensors the kernel ``csrc/fused_attention_fwd.cu``, for CPU
tensors its plain version) with q scaled by ``1/sqrt(d)`` first, as the
JAX module's fused route does (clip.py:102-110 there); False takes the
plain einsum route.

The converters take plain dicts of arrays (or tensors) under OpenAI's
``clip`` names (the released ``.pt``) or HF ``CLIPModel``'s names and give
one tower's ``state_dict``; a name of that tower they cannot place raises,
and the other tower's names are passed over.
"""

from __future__ import annotations

import re
import zipfile
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.models.t5 import _linear
from vidchapters_tpu_torch.ops.fused_attention import fused_attention

NEG_INF = -1e9


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768
    mlp_dim: int = 0  # 0 = 4 * width
    dtype: str = "bfloat16"


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


VIT_L14 = CLIPVisionConfig()
VIT_B32 = CLIPVisionConfig(patch_size=32, width=768, layers=12, heads=12, output_dim=512)
TEXT_L14 = CLIPTextConfig()
TEXT_B32 = CLIPTextConfig(width=512, layers=12, heads=8, output_dim=512)

# The image tower's attention route: True takes ops/fused_attention (the
# kernel for CUDA tensors), False the plain einsum route. The JAX module
# defaults to False after a TPU v5e measurement, which says nothing of this
# card; PERF.md has both routes' frames/s on the H100.
USE_FUSED_ATTENTION: bool = True
KEY_MULTIPLE = 64  # csrc/fused_attention_fwd.cu streams keys in tiles of 64


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dt: torch.dtype) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dt)``: statistics and affine in fp32, output in ``dt``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dt)


def vision_attention_inputs(qkv: torch.Tensor, heads: int):
    """The fused route's kernel inputs from the in-projection ``qkv`` [B, L,
    3W]: q [B, H, L, D] scaled by ``1/sqrt(d)`` in fp32 and rounded back
    (the kernel computes the unscaled ``q k^T`` of T5), k and v [B, H, Lk, D]
    with keys padded to a multiple of 64, the kernel's key tile, and the key
    mask [B, Lk] (at ViT-L/14's 257 tokens: 320 keys, not the 384 of
    ``fused_attention_padded``; the kernel takes the 257 query rows as they
    are)."""
    b, l, w3 = qkv.shape
    d = w3 // (3 * heads)
    parts = qkv.view(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)  # [3, B, H, L, D]
    # a bf16 product with a Python scalar is taken in fp32 and rounded once,
    # as the JAX module's fp32 product cast back
    q = (parts[0] * float(np.float32(1.0 / np.sqrt(d)))).contiguous()
    lk = -(-l // KEY_MULTIPLE) * KEY_MULTIPLE
    kv = qkv.new_empty((2, b, heads, lk, d))
    kv[:, :, :, :l] = parts[1:]
    kv[:, :, :, l:] = 0
    mask = torch.zeros((b, lk), dtype=torch.int32, device=qkv.device)
    mask[:, :l] = 1
    return q, kv[0], kv[1], mask


def fused_self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Non-causal attention of the in-projection ``qkv`` [B, L, 3W] through
    ``ops/fused_attention`` (``vision_attention_inputs``) -> [B, L, W] in
    ``qkv``'s dtype."""
    b, l, w3 = qkv.shape
    q, k, v, mask = vision_attention_inputs(qkv, heads)
    out = fused_attention(q, k, v, None, mask)
    return out.transpose(1, 2).reshape(b, l, w3 // 3)


class ResidualBlock(nn.Module):
    """Pre-norm block: multi-head attention (causal with a mask, else on the
    fused route when ``USE_FUSED_ATTENTION``), then a QuickGELU MLP."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype, mlp_dim: int = 0):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn_in = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, mlp_dim or 4 * width)
        self.mlp_proj = nn.Linear(mlp_dim or 4 * width, width)

    def forward(self, x: torch.Tensor,
                causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        h = _layer_norm(x, self.ln_1, dt)
        b, l, w = h.shape
        d_head = w // self.heads
        qkv = _linear(h, self.attn_in, dt)
        if causal_mask is None and USE_FUSED_ATTENTION:
            attn = fused_self_attention(qkv, self.heads)
        else:
            q, k, v = (t.reshape(b, l, self.heads, d_head).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            scores = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(d_head)
            if causal_mask is not None:
                scores = torch.where(causal_mask, scores, torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1).to(dt)
            attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, w)
        x = x + _linear(attn, self.attn_out, dt)
        h = quick_gelu(_linear(_layer_norm(x, self.ln_2, dt), self.mlp_fc, dt))
        return x + _linear(h, self.mlp_proj, dt)


def _init_tower(module: nn.Module, generator: torch.Generator, normals) -> None:
    """Seeded random weights with the JAX modules' laws: the named
    parameters N(0, std), products N(0, 1/fan_in) with zero biases, norms at
    1 and 0."""
    for p, std in normals:
        p.copy_(torch.randn(p.shape, generator=generator) * std)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.in_features ** -0.5)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class CLIPImageEncoder(nn.Module):
    """pixels [B, H, W, 3] (CLIP-normalised) -> [B, output_dim] fp32: a
    bias-free patch embedding, a class token, learned positions,
    ``ln_pre``, the blocks, ``ln_post`` on token 0 and ``proj``."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        p, w = cfg.patch_size, cfg.width
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(
            torch.zeros((cfg.image_size // p) ** 2 + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.blocks = nn.ModuleList(ResidualBlock(w, cfg.heads, self.dtype, cfg.mlp_dim)
                                    for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.output_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        b, hh, ww, c = pixels.shape
        p = cfg.patch_size
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} is not a whole number of {p}-pixel patches")
        # the stride-p convolution as one product over (kh, kw, channel)
        # patches, in the compute dtype (a float32 product stays float32 on
        # the card; cuDNN's convolution would take TF32 by default)
        patches = pixels.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, (hh // p) * (ww // p), p * p * c).to(dt)
        kernel = self.patch_embed.weight.permute(0, 2, 3, 1).reshape(cfg.width, -1)
        x = torch.matmul(patches, kernel.to(dt).t())
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)[None]
        x = _layer_norm(x, self.ln_pre, dt)
        for block in self.blocks:
            x = block(x)
        x = _layer_norm(x[:, 0], self.ln_post, dt)
        return torch.matmul(x, self.proj.to(dt)).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPImageEncoder":
        """Seeded random weights: the class token, positions and projection
        N(0, 0.02), the patch embedding N(0, 1/fan_in), the blocks as in
        ``_init_tower``."""
        fan_in = self.patch_embed.weight[0].numel()
        _init_tower(self, generator, [(self.class_embedding, 0.02),
                                      (self.positional_embedding, 0.02),
                                      (self.proj, 0.02),
                                      (self.patch_embed.weight, fan_in ** -0.5)])
        return self


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
        _init_tower(self, generator, [(self.token_embedding, 0.02),
                                      (self.positional_embedding, 0.01),
                                      (self.text_projection, 0.02)])
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


_BLOCK_LEAVES = tuple(f"{m}.{leaf}" for m in ("ln_1", "ln_2", "attn_in", "attn_out",
                                                "mlp_fc", "mlp_proj")
                      for leaf in ("weight", "bias"))
_TEXT_TOP = {"token_embedding", "positional_embedding", "text_projection",
             "ln_final.weight", "ln_final.bias"}
_VISION_TOP = {"class_embedding", "positional_embedding", "proj", "patch_embed.weight",
               "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias"}


def _finish(out: Dict[str, torch.Tensor], unplaced, what: str, tower: str = "text",
            top=_TEXT_TOP) -> Dict[str, torch.Tensor]:
    if unplaced:
        raise ValueError(f"{what}: names of the {tower} tower it cannot place: "
                         f"{sorted(unplaced)}")
    n = 1 + max((int(k.split(".")[1]) for k in out if k.startswith("blocks.")), default=-1)
    expected = set(top) | {f"blocks.{i}.{leaf}" for i in range(n) for leaf in _BLOCK_LEAVES}
    missing, stray = sorted(expected - set(out)), sorted(set(out) - expected)
    if missing or stray:
        raise ValueError(f"{what}: no value for {missing}; values of no layer: {stray}")
    return out


def _join_qkv(out: Dict[str, torch.Tensor], qkv: Dict[tuple, torch.Tensor], what: str) -> None:
    """HF's separate q/k/v projections of each layer -> the fused ``attn_in``."""
    for i, leaf in sorted({(i, leaf) for i, _, leaf in qkv}):
        parts = [qkv.get((i, c, leaf)) for c in "qkv"]
        if any(p is None for p in parts):
            raise ValueError(f"{what}: no value for layer {i}'s q, k or v {leaf}")
        out[f"blocks.{i}.attn_in.{leaf}"] = torch.cat(parts, dim=0)


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
    _join_qkv(out, qkv, "convert_hf_clip_text")
    return _finish(out, unplaced, "convert_hf_clip_text")


def convert_openai_clip_visual(sd: Mapping[str, object],
                               prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """OpenAI ``clip`` state dict (the released ``.pt``) -> the image
    tower's ``state_dict``. Names outside ``prefix`` belong to the text
    tower or to no tower and are passed over; a name under it that this
    converter cannot place raises. The torch convolution ``conv1.weight``
    [out, in, kh, kw] is the port's ``patch_embed.weight`` as it is."""
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    top = {"class_embedding": "class_embedding",
           "positional_embedding": "positional_embedding", "proj": "proj",
           "conv1.weight": "patch_embed.weight",
           "ln_pre.weight": "ln_pre.weight", "ln_pre.bias": "ln_pre.bias",
           "ln_post.weight": "ln_post.weight", "ln_post.bias": "ln_post.bias"}
    block = re.compile(r"^transformer\.resblocks\.(\d+)\.(.+)\.(weight|bias)$")
    inproj = re.compile(r"^transformer\.resblocks\.(\d+)\.attn\.in_proj_(weight|bias)$")
    for full, value in sd.items():
        if not full.startswith(prefix):
            continue
        name = full[len(prefix):]
        if name in top:
            out[top[name]] = _tensor(value)
        elif (m := inproj.match(name)):
            out[f"blocks.{m.group(1)}.attn_in.{m.group(2)}"] = _tensor(value)
        elif (m := block.match(name)) and m.group(2) in _OPENAI_BLOCK:
            out[f"blocks.{m.group(1)}.{_OPENAI_BLOCK[m.group(2)]}.{m.group(3)}"] = _tensor(value)
        else:
            unplaced.append(full)
    return _finish(out, unplaced, "convert_openai_clip_visual", "image", _VISION_TOP)


def convert_hf_clip_visual(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """HF ``transformers.CLIPModel`` state dict -> the image tower's
    ``state_dict``: q/k/v concatenated into the in-projection, the
    ``visual_projection`` Linear transposed to ``[width, output_dim]``. The
    text tower's names, ``logit_scale`` and the ``position_ids`` buffer are
    passed over; any other name raises."""
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    emb = "vision_model.embeddings."
    top = {emb + "class_embedding": "class_embedding",
           emb + "position_embedding.weight": "positional_embedding",
           emb + "patch_embedding.weight": "patch_embed.weight",
           "vision_model.pre_layrnorm.weight": "ln_pre.weight",
           "vision_model.pre_layrnorm.bias": "ln_pre.bias",
           "vision_model.post_layernorm.weight": "ln_post.weight",
           "vision_model.post_layernorm.bias": "ln_post.bias"}
    block = re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.(.+)\.(weight|bias)$")
    qkv: Dict[tuple, torch.Tensor] = {}
    for name, value in sd.items():
        if (name.startswith(("text_model.", "text_projection."))
                or name in ("logit_scale", emb + "position_ids")):
            continue
        if name in top:
            out[top[name]] = _tensor(value)
        elif name == "visual_projection.weight":
            out["proj"] = _tensor(value).t().contiguous()
        elif (m := block.match(name)) and m.group(2) in _HF_BLOCK:
            out[f"blocks.{m.group(1)}.{_HF_BLOCK[m.group(2)]}.{m.group(3)}"] = _tensor(value)
        elif m and m.group(2) in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            qkv[(m.group(1), m.group(2)[10], m.group(3))] = _tensor(value)
        else:
            unplaced.append(name)
    _join_qkv(out, qkv, "convert_hf_clip_visual")
    return _finish(out, unplaced, "convert_hf_clip_visual", "image", _VISION_TOP)


def load_openai_clip(path: str) -> Dict[str, torch.Tensor]:
    """The raw state dict of an OpenAI CLIP checkpoint: the released
    TorchScript archive (``torch.jit.load(...).state_dict()``) or a plain
    state dict under its names (``torch.load(weights_only=True)``); nothing
    is unpickled beyond tensors."""
    scripted = False
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            scripted = any(n.split("/", 1)[-1].startswith("code/") for n in z.namelist())
    if scripted:
        return torch.jit.load(path, map_location="cpu").state_dict()
    return torch.load(path, map_location="cpu", weights_only=True)
