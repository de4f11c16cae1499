"""LLaMA decoder-only LM: the zero-shot speech-VCG titler.

Counterpart of ``vidchapters_tpu/models/llama.py``. The reference loads
``LlamaForCausalLM`` (LLaMA-7B) and greedily generates a chapter title per
TextTiling segment with the prompt at zs_speechvcg.py:190-199
(``max_new_tokens=20``, left-padded with the ``<s>`` token reused as pad,
zs_speechvcg.py:131-133); vc.py:275-279 uses the same model for
ground-truth-boundary chapter titling.

The architecture: RMSNorm with fp32 statistics, rotary position embeddings
in HF's half-split convention, SwiGLU MLP, optional grouped-query attention
and an untied LM head. Every weight is rounded to ``cfg.dtype`` before it is
used (products, norm scales, the embedding lookup), as in the JAX module, so
weights stored in ``cfg.dtype`` give the same numbers as fp32 ones:
``init_llama`` builds the model on a device in ``cfg.dtype`` directly. The
attention is plain PyTorch (no kernel), as the JAX module's is plain einsum.

``llama_greedy_generate`` runs a static KV cache: one prefill over the
left-padded prompts, then one token a step. ``make_llama_generate_fn`` binds
a model and a tokenizer into the reference's ``generate_fn(prompt) -> str``.
``build_llama_titler`` loads an HF checkpoint directory (``load_llama``:
``config.json`` and the weights through ``utils/hf.py``; LLaMA's
SentencePiece BPE ``tokenizer.model`` through
``data/tokenizer.SentencePieceBPETokenizer``) and gives that function.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.models.t5 import _linear
from vidchapters_tpu_torch.utils.hf import meta_build

NEG_INF = -1e9


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32  # < num_heads => grouped-query attention
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    bos_id: int = 1
    eos_id: int = 2
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


LLAMA_7B = LlamaConfig()


def _dtype(cfg: LlamaConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: variance in fp32, scale applied in the input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    """The rotary inverse frequencies, float32 (HF's ``inv_freq``)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freq_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_inv_freq`` on ``device``, copied once: a copy from the host
    each forward would make every decode step wait for the card."""
    return torch.from_numpy(rope_inv_freq(head_dim, theta)).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, L] -> (cos, sin) each [B, L, head_dim] float32 (HF
    half-split convention: frequencies duplicated across the two halves)."""
    freqs = positions[..., None].float() * _inv_freq_on(head_dim, theta, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, d]; rotate_half([a, b]) = [-b, a] (HF convention)."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        self.input_norm = nn.Parameter(torch.ones(d))
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False)
        self.post_attn_norm = nn.Parameter(torch.ones(d))
        self.gate_proj = nn.Linear(d, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(d, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask_bias: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0) -> torch.Tensor:
        """``cache``: this layer's ``{"k", "v"}`` of ``[B, C, Hkv, d]``,
        written in place at slots ``cache_index..cache_index+l-1``; the
        queries then attend over all ``C`` slots under ``mask_bias``."""
        cfg = self.cfg
        dt = _dtype(cfg)
        b, l, _ = x.shape
        hd = cfg.head_dim
        h = _rms_norm(x, self.input_norm, cfg.rms_norm_eps)
        q = apply_rope(_linear(h, self.q_proj, dt).view(b, l, cfg.num_heads, hd), cos, sin)
        k = apply_rope(_linear(h, self.k_proj, dt).view(b, l, cfg.num_kv_heads, hd), cos, sin)
        v = _linear(h, self.v_proj, dt).view(b, l, cfg.num_kv_heads, hd)
        if cache is not None:
            cache["k"][:, cache_index:cache_index + l] = k
            cache["v"][:, cache_index:cache_index + l] = v
            k, v = cache["k"], cache["v"]
        if cfg.num_kv_heads != cfg.num_heads:
            rep = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)).float()
        probs = torch.softmax(scores / float(np.sqrt(hd)) + mask_bias, dim=-1).to(dt)
        attn = torch.matmul(probs, v.to(dt).transpose(1, 2))           # [b, H, l, d]
        x = x + _linear(attn.transpose(1, 2).reshape(b, l, cfg.num_heads * hd), self.o_proj, dt)
        h = _rms_norm(x, self.post_attn_norm, cfg.rms_norm_eps)
        mid = F.silu(_linear(h, self.gate_proj, dt)) * _linear(h, self.up_proj, dt)
        return x + _linear(mid, self.down_proj, dt)


class LlamaForCausalLM(nn.Module):
    """Returns logits [B, L, V] float32.

    Without a cache: causal self-attention over the padded prompt (pad key
    columns masked by ``attn_mask``). With a cache (``init_cache``): the
    ``l`` input tokens are written at slots ``cache_index..cache_index+l-1``
    of the static cache and the queries attend over every written slot that
    ``kv_pad_mask`` keeps; the same path serves the prefill (``cache_index``
    0) and the one-token decode steps."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_size))
        self.lm_head = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))

    def forward(self, input_ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                cache_index: int = 0,
                kv_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = _dtype(cfg)
        b, l = input_ids.shape
        dev = input_ids.device
        x = F.embedding(input_ids.long(), self.embed_tokens).to(dt)
        if attn_mask is None:
            attn_mask = torch.ones((b, l), dtype=torch.int32, device=dev)
        if position_ids is None:
            position_ids = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0)
        cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
        if cache is None:
            causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
            ok = causal[None] & attn_mask[:, None, :].bool()
        else:
            c = cache["layer_0"]["k"].shape[1]
            causal = (torch.arange(c, device=dev)[None, :]
                      <= (cache_index + torch.arange(l, device=dev))[:, None])
            if kv_pad_mask is None:
                kv_pad_mask = torch.ones((b, c), dtype=torch.int32, device=dev)
            ok = causal[None] & kv_pad_mask[:, None, :].bool()
        mask_bias = torch.where(ok[:, None], 0.0, NEG_INF).float()      # [B, 1, Lq, Lk]
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, mask_bias,
                      None if cache is None else cache[f"layer_{i}"], cache_index)
        x = _rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return torch.matmul(x, self.lm_head.to(dt).t()).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaForCausalLM":
        """Seeded random weights in place, drawn on ``generator``'s device:
        the embedding and the head N(0, 0.02), each projection N(0, 1/fan_in)
        (the JAX module's laws, not its numbers), the norms 1."""
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)
        self.lm_head.normal_(0.0, 0.02, generator=generator)
        self.final_norm.fill_(1.0)
        for layer in self.layers:
            layer.input_norm.fill_(1.0)
            layer.post_attn_norm.fill_(1.0)
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                        layer.gate_proj, layer.up_proj, layer.down_proj):
                lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
        return self


def init_llama(cfg: LlamaConfig, device="cuda", seed: int = 0) -> LlamaForCausalLM:
    """A ``LlamaForCausalLM`` of seeded random weights, allocated once on
    ``device`` in ``cfg.dtype`` (LLaMA-7B: 13.5 GB in bfloat16, never built
    in fp32 on the host first)."""
    with meta_build():
        model = LlamaForCausalLM(cfg)
    model = model.to(dtype=_dtype(cfg)).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval()


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed K/V slots ``[batch, max_len, kv_heads, head_dim]`` a layer, in
    ``cfg.dtype``."""
    dt = _dtype(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)}
            for i in range(cfg.num_layers)}


@torch.no_grad()
def llama_greedy_generate(model: LlamaForCausalLM, input_ids: torch.Tensor,
                          attn_mask: torch.Tensor, max_new_tokens: int) -> torch.Tensor:
    """Batched greedy continuation of left-padded prompts (the reference's
    ``model.generate(input_ids, max_new_tokens=20)`` at zs_speechvcg.py:199).

    input_ids / attn_mask: [B, P] with pads on the LEFT. Returns [B, T] int32
    new tokens; positions after the first EOS are filled with EOS. Every
    step runs (no early stop), as the JAX module's scan does."""
    cfg = model.cfg
    b, p = input_ids.shape
    dev = input_ids.device
    attn_mask = attn_mask.to(torch.int32)
    cache = init_cache(cfg, b, p + max_new_tokens, device=dev)
    positions = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0)
    n_real = attn_mask.sum(dim=1)
    kv_pad = torch.cat([attn_mask, torch.ones((b, max_new_tokens), dtype=torch.int32,
                                              device=dev)], dim=1)
    logits = model(input_ids, attn_mask=attn_mask, position_ids=positions, cache=cache,
                   cache_index=0, kv_pad_mask=kv_pad)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    done = tok == cfg.eos_id
    out = [tok]
    ones = torch.ones((b, 1), dtype=torch.int32, device=dev)
    eos = torch.full_like(tok, cfg.eos_id)
    for t in range(max_new_tokens - 1):
        logits = model(tok[:, None], attn_mask=ones, position_ids=(n_real + t)[:, None],
                       cache=cache, cache_index=p + t, kv_pad_mask=kv_pad)
        tok = torch.where(done, eos, torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
        done = done | (tok == cfg.eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_llama_generate_fn(model: LlamaForCausalLM, tokenizer, max_new_tokens: int = 20,
                           max_length: int = 512):
    """``generate_fn(prompt) -> str`` with the reference's tokenization
    (zs_speechvcg.py:131-133,150-200): ``<s>`` then the prompt's ids,
    truncated to ``max_length``, padded on the left to ``max_length`` with
    ``<s>`` (masked), ``max_new_tokens`` greedy tokens, decoded up to the
    first EOS without special tokens. ``tokenizer`` has HF's
    ``encode(text, add_special_tokens=False)`` and ``decode(ids,
    skip_special_tokens=True)``. Runs on the device of the model."""
    cfg = model.cfg
    dev = model.embed_tokens.device

    def generate_fn(prompt: str) -> str:
        ids = ([cfg.bos_id] + list(tokenizer.encode(prompt, add_special_tokens=False)))
        ids = ids[:max_length]
        pad = max_length - len(ids)
        input_ids = torch.tensor([[cfg.bos_id] * pad + ids], dtype=torch.int32, device=dev)
        mask = torch.tensor([[0] * pad + [1] * len(ids)], dtype=torch.int32, device=dev)
        toks = llama_greedy_generate(model, input_ids, mask, max_new_tokens)[0].tolist()
        if cfg.eos_id in toks:
            toks = toks[:toks.index(cfg.eos_id)]
        return tokenizer.decode(toks, skip_special_tokens=True)

    return generate_fn


def llama_config_from_hf(hf: dict, dtype: str = "bfloat16") -> LlamaConfig:
    """``LlamaConfig`` from an HF ``config.json`` dict, the fields the JAX
    loader reads (``vidchapters_tpu/models/llama.py:build_llama_titler``)."""
    return LlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf["max_position_embeddings"],
        rms_norm_eps=hf["rms_norm_eps"], rope_theta=hf.get("rope_theta", 10000.0),
        bos_id=hf["bos_token_id"], eos_id=hf["eos_token_id"], dtype=dtype)


def load_llama(model_dir: str, device=None, dtype: str = "bfloat16") -> LlamaForCausalLM:
    """An HF LLaMA checkpoint directory's ``LlamaForCausalLM``: the config
    of ``config.json``, the weights (safetensors or ``pytorch_model.bin``,
    one file or shards, through ``utils/hf.py``) imported by
    ``llama_from_hf_state_dict`` and stored in ``dtype`` on ``device`` (the
    card unless the caller asks for the CPU)."""
    from vidchapters_tpu_torch import resolve_device
    from vidchapters_tpu_torch.models.weights import llama_from_hf_state_dict
    from vidchapters_tpu_torch.utils.hf import load_hf_config, load_hf_state_dict

    device = resolve_device(device)
    cfg = llama_config_from_hf(load_hf_config(model_dir), dtype)
    with meta_build():
        model = LlamaForCausalLM(cfg)
    sd = llama_from_hf_state_dict(load_hf_state_dict(model_dir), model)
    model.load_state_dict({k: v.to(_dtype(cfg)) for k, v in sd.items()}, assign=True)
    return model.to(device).eval()


def build_llama_titler(model_dir: str, max_new_tokens: int = 20, batch_size: int = 8,
                       max_length: int = 512, device=None, dtype: str = "bfloat16"):
    """The reference's LLaMA titler from an HF checkpoint directory
    (``config.json``, the weights, ``tokenizer.model``): ``load_llama`` in
    ``dtype`` on ``device``, the SentencePiece BPE ``tokenizer.model``
    (``data/tokenizer.SentencePieceBPETokenizer``), and
    ``make_llama_generate_fn``: ``<s>`` as pad, padded on the left and
    truncated at ``max_length``, ``max_new_tokens`` greedy tokens, decoded
    without special tokens (zs_speechvcg.py:131-133, 150-200).
    ``batch_size`` is the JAX signature's and unused there too."""
    from pathlib import Path

    from vidchapters_tpu_torch.data.tokenizer import SentencePieceBPETokenizer

    tokenizer = SentencePieceBPETokenizer(str(Path(model_dir) / "tokenizer.model"))
    model = load_llama(model_dir, device, dtype)
    return make_llama_generate_fn(model, tokenizer, max_new_tokens, max_length)
