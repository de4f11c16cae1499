"""GPT-2 language model in PyTorch: PDVC's ``gpt2`` caption-head option.

Counterpart of ``vidchapters_tpu/models/gpt2.py``. The reference can swap
its LSTM captioner for HF GPT-2 conditioned on a projected event-query
prefix (PDVC/pdvc/pdvc.py:56-57, 414-427: ``inputs_embeds =
[query2cap(event); wte(seq)]`` with -100 on the prefix label). Pre-norm
blocks with a fused qkv product, ``gelu_new`` (tanh GELU), scores and the
softmax in fp32 over a causal plus padding mask, and the LM head tied to
``wte``. The attention is plain PyTorch, as in the JAX module (no Pallas
kernel runs there). Parameters keep the JAX module's names (``block_{i}``
-> ``blocks.{i}``, Dense -> ``nn.Linear``), so
``models/weights.pdvc_from_jax_params`` carries them across;
``models/weights.gpt2_from_hf_state_dict`` reads HF's names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.models.clip import _layer_norm
from vidchapters_tpu_torch.models.t5 import _linear

NEG_INF = -1e9


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: str = "float32"


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(d, eps=eps)
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d, eps=eps)
        self.mlp_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        b, l, d = x.shape
        h = _layer_norm(x, self.ln_1, dt)
        q, k, v = (t.reshape(b, l, cfg.n_head, d // cfg.n_head).transpose(1, 2)
                   for t in torch.chunk(_linear(h, self.c_attn, dt), 3, dim=-1))
        # dividing by a numpy float64 promotes JAX's scores to fp32
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(d // cfg.n_head)
        causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, NEG_INF)
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask.bool()[:, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, d)
        x = x + _linear(attn, self.c_proj, dt)
        h = F.gelu(_linear(_layer_norm(x, self.ln_2, dt), self.mlp_fc, dt), approximate="tanh")
        return x + _linear(h, self.mlp_proj, dt)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.zeros(cfg.n_positions, cfg.n_embd))
        self.blocks = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT2":
        """The JAX module's laws: ``wte`` N(0, 0.02), ``wpe`` N(0, 0.01),
        lecun-normal products with zero biases, norms at 1 and 0."""
        self.wte.copy_(torch.randn(self.wte.shape, generator=generator) * 0.02)
        self.wpe.copy_(torch.randn(self.wpe.shape, generator=generator) * 0.01)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                x = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(x * (math.sqrt(1.0 / m.in_features) / 0.87962566103423978))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def forward(self, inputs_embeds: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None, position_offset: int = 0,
                tokens: Optional[torch.Tensor] = None,
                prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_embeds [B, L, D] -> logits [B, L, V] in fp32 (tied head).
        Or ``tokens`` [B, T], embedded here by ``wte``, after an optional
        ``prefix_embeds`` [B, P, D] (PDVC/pdvc/pdvc.py:413-416)."""
        dt = getattr(torch, self.cfg.dtype)
        if tokens is not None:
            tok = self.wte[tokens.long()]
            inputs_embeds = (tok if prefix_embeds is None
                             else torch.cat([prefix_embeds.to(tok.dtype), tok], dim=1))
        l = inputs_embeds.shape[1]
        x = inputs_embeds.to(dt) + self.wpe[position_offset:position_offset + l][None].to(dt)
        for block in self.blocks:
            x = block(x, attn_mask)
        x = _layer_norm(x, self.ln_f, dt)
        return torch.einsum("bld,vd->blv", x, self.wte.to(dt)).float()

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.wte[tokens.long()]


def gpt2_caption_loss(model: GPT2, prefix_embeds: torch.Tensor, seq: torch.Tensor,
                      pad_id: int = 0) -> torch.Tensor:
    """Prefix-conditioned caption NLL (pdvc.py:414-427): inputs = [prefix ;
    wte(seq)], labels = [-100 ; seq with ``pad_id`` masked]; the mean over
    the labelled tokens."""
    inputs = torch.cat([prefix_embeds, model.embed(seq)], dim=1)
    logits = model(inputs)
    p = prefix_embeds.shape[1]
    # next-token prediction: the logits at position i predict token i + 1
    logp = torch.log_softmax(logits[:, p - 1:-1], dim=-1)
    mask = seq != pad_id
    nll = -torch.gather(logp, 2, torch.where(mask, seq, 0).long()[..., None])[..., 0]
    return torch.where(mask, nll, 0.0).sum() / mask.sum().clamp(min=1)


@torch.no_grad()
def gpt2_greedy_sample(model: GPT2, prefix_embeds: torch.Tensor, max_len: int,
                       eos_id: int = 50256, with_logprobs: bool = False):
    """Greedy continuation after the prefix -> tokens [B, max_len]; once a
    row emits ``eos_id`` it repeats it. Every step runs the whole
    [prefix ; generated ; zeros] buffer, as the JAX scan does.
    ``with_logprobs`` picks each token by its log-probability (PDVC's
    captioner, JAX ``pdvc.py:534-538``) and also returns them, [B, max_len]."""
    b, p, d = prefix_embeds.shape
    embeds = prefix_embeds.new_zeros((b, p + max_len, d))
    embeds[:, :p] = prefix_embeds
    done = torch.zeros(b, dtype=torch.bool, device=prefix_embeds.device)
    toks, lps = [], []
    for length in range(p, p + max_len):
        scores = model(embeds)[:, length - 1]
        if with_logprobs:
            scores = torch.log_softmax(scores, dim=-1)
        nxt = torch.argmax(scores, dim=-1)
        if with_logprobs:
            lps.append(torch.gather(scores, 1, nxt[:, None])[:, 0])
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
        embeds[:, length] = model.embed(nxt).to(embeds.dtype)
        toks.append(nxt)
    toks = torch.stack(toks, dim=1)
    return (toks, torch.stack(lps, dim=1)) if with_logprobs else toks
