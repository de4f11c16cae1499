"""BERT encoder in PyTorch (bert-base-uncased architecture): the frozen
speech tower of Moment-DETR's ``use_speech`` recipes.

Counterpart of ``vidchapters_tpu/models/bert.py`` (the reference's speech
branch, moment_detr/moment_detr/model.py:46-52,131-139: last hidden states
projected into the transformer input). The dtypes are the JAX module's:
products and exact-erf GELU in ``cfg.dtype`` with fp32 parameters, the key
mask additive (``(1 - mask) * -1e9``) with the softmax in fp32, LayerNorm
statistics in fp32 and its output in the compute dtype.
``convert_hf_bert`` takes an HF ``transformers.BertModel`` state dict as a
plain dict of arrays or tensors and gives this module's ``state_dict``
(the pooler, which no path uses, is passed over; any other name it cannot
place raises).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.models.clip import _layer_norm, _tensor
from vidchapters_tpu_torch.models.t5 import _linear

NEG_INF = -1e9


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


BERT_BASE = BertConfig()


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_norm = nn.LayerNorm(d, eps=eps)
        self.ff1 = nn.Linear(d, cfg.intermediate_size)
        self.ff2 = nn.Linear(cfg.intermediate_size, d)
        self.ff_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        h = cfg.num_heads
        b, l, d = x.shape
        q, k, v = (_linear(x, lin, dt).reshape(b, l, h, d // h).transpose(1, 2)
                   for lin in (self.q, self.k, self.v))
        # dividing by a numpy float64 promotes JAX's scores to fp32
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(d // h)
        scores = scores + (1.0 - mask.float())[:, None, None, :] * NEG_INF
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, d)
        x = _layer_norm(x + _linear(attn, self.attn_out, dt), self.attn_norm, dt)
        mid = F.gelu(_linear(x, self.ff1, dt))
        return _layer_norm(x + _linear(mid, self.ff2, dt), self.ff_norm, dt)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_position_embeddings, d))
        self.token_type_embeddings = nn.Parameter(torch.zeros(cfg.type_vocab_size, d))
        self.embed_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> last hidden states [B, L, D] in the compute dtype (CLS pooling
        is ``out[:, 0]``)."""
        dt = getattr(torch, self.cfg.dtype)
        ids = input_ids.long()
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        l = ids.shape[1]
        x = (self.word_embeddings[ids] + self.position_embeddings[:l][None]
             + self.token_type_embeddings[token_type_ids.long()]).to(dt)
        x = _layer_norm(x, self.embed_norm, dt)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertModel":
        """Seeded random weights with the JAX module's laws: embeddings
        N(0, 0.02), products N(0, 1/fan_in) with zero biases, norms at 1
        and 0."""
        for p in (self.word_embeddings, self.position_embeddings, self.token_type_embeddings):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


_HF_TOP = {"embeddings.word_embeddings.weight": "word_embeddings",
           "embeddings.position_embeddings.weight": "position_embeddings",
           "embeddings.token_type_embeddings.weight": "token_type_embeddings",
           "embeddings.LayerNorm.weight": "embed_norm.weight",
           "embeddings.LayerNorm.bias": "embed_norm.bias"}
_HF_LAYER = {"attention.self.query": "q", "attention.self.key": "k",
             "attention.self.value": "v", "attention.output.dense": "attn_out",
             "attention.output.LayerNorm": "attn_norm", "intermediate.dense": "ff1",
             "output.dense": "ff2", "output.LayerNorm": "ff_norm"}
_HF_LAYER_NAME = re.compile(r"^encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$")


def convert_hf_bert(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """HF ``BertModel`` state dict (a ``bert.`` prefix is dropped) -> this
    module's ``state_dict``. The pooler and the ``position_ids`` /
    ``token_type_ids`` buffers are passed over."""
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    for name, value in sd.items():
        name = name.removeprefix("bert.")
        if (name.startswith("pooler.")
                or name in ("embeddings.position_ids", "embeddings.token_type_ids")):
            continue
        if name in _HF_TOP:
            out[_HF_TOP[name]] = _tensor(value)
        elif (m := _HF_LAYER_NAME.match(name)) and m.group(2) in _HF_LAYER:
            out[f"layers.{m.group(1)}.{_HF_LAYER[m.group(2)]}.{m.group(3)}"] = _tensor(value)
        else:
            unplaced.append(name)
    if unplaced:
        raise ValueError(f"convert_hf_bert: names it cannot place: {sorted(unplaced)}")
    n = 1 + max((int(k.split(".")[1]) for k in out if k.startswith("layers.")), default=-1)
    expected = set(_HF_TOP.values()) | {f"layers.{i}.{m}.{leaf}" for i in range(n)
                                        for m in _HF_LAYER.values()
                                        for leaf in ("weight", "bias")}
    missing, stray = sorted(expected - set(out)), sorted(set(out) - expected)
    if missing or stray:
        raise ValueError(f"convert_hf_bert: no value for {missing}; values of no layer: {stray}")
    return out
