"""T5 encoder-decoder in PyTorch, the full-sequence path.

Counterpart of ``vidchapters_tpu/models/t5.py`` (same math, same parameter
tree): RMSNorm with fp32 statistics; relative attention bias computed by the
first layer's table of each stack and shared by every layer; unscaled
attention; ReLU or gated-GELU feed-forward; tied embeddings with the
``d_model**-0.5`` logit rescale; label-smoothed cross-entropy.

Training mode: every forward takes ``rng``, a ``runtime.rng.StepRng`` or
None (deterministic). With one, dropout runs where the JAX package's
``deterministic=False`` runs it: the embeddings, each sublayer's output,
the FF hidden, the final norm, and the attention probabilities by route
(the fused kernel's hash mask, the dense route's hash mask, or an element
mask). Each block is rematerialised in training (``REMAT_BLOCKS``,
``T5Config.remat``; t5.py:667-688 there): the backward pass runs the block
again from its inputs, row 1 and the hashed masks included, and the
recompute replays the dropout of the first pass (``runtime/rng.StepRng``'s
``replay``), so a step's result is that of a step without it, bit for bit.

Parameters are held in their stored dtype (float32 by default) and every
product runs in ``cfg.dtype`` (bfloat16 by default), as the JAX package's
``Dense(dtype=...)`` does. Long self-attention (Lq > 128 and Lq*Lk > 512^2)
goes through ``ops/fused_attention``.

Incremental decoding has two routes. ``ops/decode_megakernel`` runs a whole
decoder step in one launch; ``make_generate_fn`` takes it for greedy and
beam search unless ``USE_MEGA_DECODE`` is False. The standard route is
``init_cache`` / ``decode_step`` here, layer by layer (unrolled layers
only; ``scan_layers`` is not ported). Its cache tree keeps the JAX keys:
``block_{i}`` -> ``self`` (per-beam K/V rows, written at the step's index)
/ ``cross`` (per-example K/V of the encoder states, shared by the beams);
after the first step, a top-level ``cross`` holds each example's live
encoder keys (``cross_live_ends``), which every layer's cross kernel takes.
Each layer's two attentions go through ``ops/decode_attention``: on CUDA
tensors its two kernels always run, on CPU tensors their plain versions.
The JAX package reaches those kernels only under ``USE_FUSED_DECODE``,
which it keeps off for the TPU's dispatch cost; the port has no such flag.

Tensor parallelism (``parallel/sharding.shard_params`` sets each module's
``mp`` to the model axis): q / k / v and the FF's ``wi`` hold the rank's
heads and ``d_ff`` columns, ``o`` and ``wo`` their rows, ``shared`` (and an
untied ``lm_head``) the rank's vocabulary rows; each block copies its
input to the model group and sums the row-sharded outputs over it
(``parallel/tensor_parallel.py``). With ``SEQUENCE_PARALLEL`` the encoder's
residual stream is sharded over the sequence instead: each block gathers
the rows into attention and the FF and reduce-scatters what comes out
(t5.py:653,690 there); the decoder is never sharded so (t5.py:66-75
there). Every dropout takes its part of the mask of the whole tensor, so a
rank keeps what one process keeps. Decoding runs on the gathered weights.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vidchapters_tpu_torch.config import T5Config
from vidchapters_tpu_torch.ops.decode_attention import (
    cross_live_ends,
    decode_cross_attention,
    decode_self_attention,
)
from vidchapters_tpu_torch.ops.fused_attention import (
    dropout_scale,
    fused_attention_padded,
    mul32,
    murmur_mix,
)
from vidchapters_tpu_torch.parallel import tensor_parallel as tp
from vidchapters_tpu_torch.runtime import mesh
from vidchapters_tpu_torch.runtime.rng import StepRng

NEG_INF = -1e9  # large-negative additive mask (safe in bf16)

# The encoder pads its sequence to this multiple once, at stack entry.
SEQ_PAD_BLOCK = 128

# Query chunk below which attention stays dense (T5Attention.CHUNK there).
CHUNK = 128

# Training attentions with Lq*Lk at or above this (and off the fused route)
# drop their probabilities with the hashed mask ``dense_keep_scale``
# (t5.py:440-467 there), below it with an element mask.
DENSE_REMAT_MIN_ELEMS = 256 * 256

# gradient checkpointing of each T5 block in training (t5.py:48 there); a
# config's ``remat`` overrides it. The policy is JAX's None: the whole block
# is recomputed in the backward pass.
REMAT_BLOCKS = True

# the decode megakernel for greedy and beam search: True / None (the
# default: take it) or False (the standard cached decode). Nucleus sampling
# always takes the standard decode.
USE_MEGA_DECODE = None

# Megatron sequence parallelism of the encoder's residual stream over the
# model axis: set by runtime/mesh.enable_sequence_parallelism (the
# counterpart of SEQUENCE_SHARDING there), read by a tensor-parallel
# encoder stack at each forward.
SEQUENCE_PARALLEL = False


def dense_keep_scale(seed: int, shape, rate: float, device=None, h0: int = 0,
                     heads: Optional[int] = None) -> torch.Tensor:
    """``[B, H, Lq, Lk]`` float32 keep mask, ``1/(1-rate)`` or 0: murmur3
    over ``x = pos + row * (Lq*Lk)`` (row = b*heads + h0 + h, pos = q*Lk +
    k, uint32 wrap) with a 32-bit threshold, as ``_dense_keep_scale``
    (t5.py:123-141 there). ``heads`` (H by default) is the model's head
    count and ``h0`` the model's index of head 0: a rank holding heads
    ``[h0, h0 + H)`` gets its part of the whole mask."""
    b, h, lq, lk = shape
    heads = h if heads is None else heads
    n = lq * lk
    pos = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    row = (torch.arange(b, dtype=torch.int64, device=device)[:, None] * heads
           + torch.arange(h0, h0 + h, dtype=torch.int64, device=device)[None, :]
           ).reshape(-1, 1)
    x = (pos + mul32(row, n & 0xFFFFFFFF)) & 0xFFFFFFFF
    x = murmur_mix(x ^ mul32(torch.tensor(seed & 0xFFFFFFFF, device=device), 0x9E3779B1))
    thresh = min(int(rate * 2**32), 2**32 - 1)
    keep = torch.where(x >= thresh,
                       torch.tensor(dropout_scale(rate), device=device),
                       torch.zeros((), device=device))
    return keep.reshape(shape)


def uses_remat(cfg: T5Config) -> bool:
    """Whether a training forward checkpoints each block: ``cfg.remat``, or
    ``REMAT_BLOCKS`` when it is None."""
    return REMAT_BLOCKS if cfg.remat is None else bool(cfg.remat)


def _apply_dropout(x: torch.Tensor, rate: float, rng: Optional[StepRng],
                   shard: Optional[tuple] = None) -> torch.Tensor:
    """Element dropout in training (``rng`` given), identity otherwise.
    ``shard``: ``x`` is a part of a whole tensor (``StepRng.keep_mask``)."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(rng.keep_mask(x, keep, shard), x / keep, torch.zeros_like(x))


def model_shard(module: nn.Module, dim: int) -> Optional[tuple]:
    """``(dim, parts, index)`` of a tensor of a tensor-parallel ``module``
    split over the model axis along ``dim``; None without one."""
    return (dim, module.mp, mesh.model_rank()) if module.mp > 1 else None


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """``lin(x)`` computed in ``dt`` (input and weights cast)."""
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def _row_linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """``lin(x)`` of a row-sharded ``lin`` (its weight the rank's input
    columns, its bias whole): the partial products summed over the model
    group, then the bias added once."""
    out = tp.reduce_from_model(F.linear(x.to(dt), lin.weight.to(dt)))
    return out if lin.bias is None else out + lin.bias.to(dt)


class RMSNorm(nn.Module):
    """T5LayerNorm: scale-only RMS norm, statistics in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (self.weight.float() * (xf * torch.rsqrt(var + self.eps))).to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF-equivalent bucketing (modeling_t5.py:389-427), with the large-offset
    branch's log in float32 as the JAX package computes it."""
    rel = relative_position.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = float(np.float32(np.log(max_distance / max_exact)))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / log_ratio
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    mp = 1  # the model axis it is split over (its heads' columns)

    def __init__(self, cfg: T5Config, bidirectional: bool):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(
            torch.zeros(cfg.relative_attention_num_buckets, cfg.num_heads))

    def forward(self, query_length: int, key_length: int) -> torch.Tensor:
        """[1, heads, q_len, k_len] additive bias in the compute dtype; under
        tensor parallelism of the rank's heads (its columns of the table,
        whose gradient the model group sums)."""
        cfg = self.cfg
        dev = self.rel_embedding.device
        table = self.rel_embedding
        if self.mp > 1:
            n = cfg.num_heads // self.mp
            table = table[:, mesh.model_rank() * n:(mesh.model_rank() + 1) * n]
        ctx = torch.arange(query_length, device=dev)[:, None]
        mem = torch.arange(key_length, device=dev)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        # a one-hot product instead of rel_embedding[buckets], as t5.py:
        # 225-234 there: exact in fp32 (one 1.0 per row), and its backward
        # is a matrix product where the gather's is a scatter-add of q*k
        # rows into the [buckets, heads] table (118 ms against 0.54 ms at
        # L=1024 on an H100 80GB at 700 W, chip_smoke.py's training phase)
        onehot = (buckets[..., None] == torch.arange(
            cfg.relative_attention_num_buckets, device=dev)).float()
        bias = torch.matmul(onehot, table.float())  # [q, k, h]
        return bias.permute(2, 0, 1)[None].to(_dtype(cfg)).contiguous()


class T5Attention(nn.Module):
    """Multi-head attention, unscaled q k^T, optional additive bias. Under
    tensor parallelism (``mp`` > 1) it holds the rank's heads and returns
    its partial output projection (the caller sums it over the model
    group)."""

    mp = 1

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.view(b, l, -1, self.cfg.d_kv).transpose(1, 2)

    def forward(self, hidden: torch.Tensor, kv: torch.Tensor,
                bias: Optional[torch.Tensor], key_mask: Optional[torch.Tensor],
                dropout_rate: float = 0.0, rng: Optional[StepRng] = None) -> torch.Tensor:
        """``bias`` is batch-independent ([1, h, q, k]); the [B, K]
        ``key_mask`` is applied separately. With ``rng`` the probabilities
        take dropout at ``dropout_rate``."""
        dt = _dtype(self.cfg)
        q = self._split(_linear(hidden, self.q, dt))
        k = self._split(_linear(kv, self.k, dt))
        v = self._split(_linear(kv, self.v, dt))
        lq, lk = q.shape[2], k.shape[2]
        drop = dropout_rate if rng is not None else 0.0
        large = lq > CHUNK and lq * lk > 512 * 512
        h0 = mesh.model_rank() * q.shape[1] if self.mp > 1 else 0  # the rank's first head
        if (large and key_mask is not None
                and (bias is None or bias.shape[0] == 1)):
            # one uint32 per call: the kernels rebuild the keep mask from it
            seed = rng.seed32() if drop > 0.0 else 0
            out = fused_attention_padded(q, k, v, bias, key_mask, seed=seed,
                                         dropout_rate=drop, h0=h0)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)).float()
            if bias is not None:
                scores = scores + bias.float()
            if key_mask is not None:
                scores = torch.where(key_mask[:, None, None, :].bool(), scores,
                                     torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1)
            if drop > 0.0 and lq * lk >= DENSE_REMAT_MIN_ELEMS:
                keep = dense_keep_scale(rng.seed32(), probs.shape, drop, probs.device,
                                        h0=h0, heads=self.cfg.num_heads)
                probs = (probs * keep).to(q.dtype)
            else:
                probs = _apply_dropout(probs.to(q.dtype), drop, rng, model_shard(self, 1))
            out = torch.matmul(probs, v)
        return self._merge(out)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        """``[b, h, l, d]`` heads -> the output projection ``[b, l, d_model]``."""
        b, h, l, d = out.shape
        return _linear(out.transpose(1, 2).reshape(b, l, h * d), self.o, _dtype(self.cfg))

    # ----- incremental decoding (t5.py:350-399 there) -----

    def decode_self(self, hidden: torch.Tensor, cache: dict, cache_index: int,
                    bias_row: torch.Tensor):
        """Self-attention of one decode step: ``hidden [b, 1, d_model]``; the
        new K/V go to row ``cache_index`` of ``cache["k"]`` / ``cache["v"]``
        (in place). Returns the output and the cache."""
        dt = _dtype(self.cfg)
        q, k_new, v_new = (self._split(_linear(hidden, lin, dt))
                           for lin in (self.q, self.k, self.v))
        out, k, v = decode_self_attention(q, k_new, v_new, cache["k"], cache["v"],
                                          bias_row, cache_index)
        return self._merge(out), {"k": k, "v": v}

    def decode_cross(self, hidden: torch.Tensor, cache: dict, key_mask: torch.Tensor,
                     live_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-attention of one decode step over the precomputed K/V, which
        hold one row per example: the ``hidden.shape[0] // k.shape[0]`` beams
        of an example share it. ``live_ends``: ``cross_live_ends(key_mask)``."""
        q = self._split(_linear(hidden, self.q, _dtype(self.cfg)))
        return self._merge(decode_cross_attention(q, cache["k"], cache["v"], key_mask,
                                                  live_ends))

    def precompute_kv(self, kv: torch.Tensor) -> dict:
        dt = _dtype(self.cfg)
        return {"k": self._split(_linear(kv, self.k, dt)).contiguous(),
                "v": self._split(_linear(kv, self.v, dt)).contiguous()}


class T5FeedForward(nn.Module):
    """ReLU or gated-GELU FF; under tensor parallelism the rank's ``d_ff``
    columns, returning its partial ``wo`` product."""

    mp = 1

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        if cfg.is_gated_act:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, dropout_rate: float = 0.0,
                rng: Optional[StepRng] = None) -> torch.Tensor:
        dt = _dtype(self.cfg)
        if self.cfg.is_gated_act:
            # HF "gated-gelu" is gelu_new, the tanh approximation
            h = (F.gelu(_linear(x, self.wi_0, dt), approximate="tanh")
                 * _linear(x, self.wi_1, dt))
        else:
            h = torch.relu(_linear(x, self.wi, dt))
        return _linear(_apply_dropout(h, dropout_rate, rng, model_shard(self, 2)), self.wo, dt)


class T5Block(nn.Module):
    mp = 1

    def __init__(self, cfg: T5Config, is_decoder: bool):
        super().__init__()
        dt, eps = _dtype(cfg), cfg.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.self_attn_norm = RMSNorm(cfg.d_model, eps, dt)
        self.self_attn = T5Attention(cfg)
        if is_decoder:
            self.cross_attn_norm = RMSNorm(cfg.d_model, eps, dt)
            self.cross_attn = T5Attention(cfg)
        self.ff_norm = RMSNorm(cfg.d_model, eps, dt)
        self.ff = T5FeedForward(cfg)

    def forward(self, x, self_bias, enc_out, self_key_mask, cross_key_mask,
                dropout_rate: float = 0.0, rng: Optional[StepRng] = None,
                sequence_parallel: bool = False):
        """Under tensor parallelism ``enc_out`` has been copied to the model
        group (``T5Stack.forward``); with ``sequence_parallel`` ``x`` is the
        rank's rows of the residual stream."""
        sharded = self.mp > 1
        into, out, shard = _identity, _identity, None
        if sharded and sequence_parallel:
            into, out, shard = tp.gather_sequence, tp.scatter_sequence, model_shard(self, 1)
        elif sharded:
            into, out = tp.copy_to_model, tp.reduce_from_model
        normed = into(self.self_attn_norm(x))
        h = out(self.self_attn(normed, normed, self_bias, self_key_mask, dropout_rate, rng))
        x = x + _apply_dropout(h, dropout_rate, rng, shard)
        if self.is_decoder and enc_out is not None:
            h = out(self.cross_attn(into(self.cross_attn_norm(x)), enc_out, None,
                                    cross_key_mask, dropout_rate, rng))
            x = x + _apply_dropout(h, dropout_rate, rng, shard)
        h = out(self.ff(into(self.ff_norm(x)), dropout_rate, rng))
        return x + _apply_dropout(h, dropout_rate, rng, shard)

    def decode(self, x: torch.Tensor, self_bias: torch.Tensor, cache: dict,
               cache_index: int, cross_key_mask: torch.Tensor,
               cross_live: Optional[torch.Tensor] = None):
        """One decode step of a decoder block: ``(x, {"self", "cross"})``."""
        normed = self.self_attn_norm(x)
        h, self_kv = self.self_attn.decode_self(normed, cache["self"], cache_index, self_bias)
        x = x + h
        x = x + self.cross_attn.decode_cross(self.cross_attn_norm(x), cache["cross"],
                                             cross_key_mask, cross_live)
        x = x + self.ff(self.ff_norm(x))
        return x, {"self": self_kv, "cross": cache["cross"]}


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _checkpointed(blk: T5Block, rng: StepRng, *args) -> torch.Tensor:
    """``blk(*args)`` keeping only its inputs for the backward pass, which
    runs the block again (the model group's collectives too). The recompute
    draws from ``rng``'s state before the first pass, so it drops what that
    pass dropped, and leaves the live stream where it found it."""
    replay = rng.replay(rng.get_state())
    return checkpoint(blk, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay))


class T5Stack(nn.Module):
    mp = 1

    def __init__(self, cfg: T5Config, is_decoder: bool):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.blocks = nn.ModuleList(T5Block(cfg, is_decoder) for _ in range(n))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, _dtype(cfg))
        self.rel_bias = RelativePositionBias(cfg, bidirectional=not is_decoder)

    @property
    def dropout_rate(self) -> float:
        return self.cfg.decoder_dropout if self.is_decoder else self.cfg.encoder_dropout

    @property
    def sequence_parallel(self) -> bool:
        """Whether this stack shards its residual stream over the model axis:
        a tensor-parallel encoder under ``SEQUENCE_PARALLEL``."""
        return SEQUENCE_PARALLEL and self.mp > 1 and not self.is_decoder

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None,
                rng: Optional[StepRng] = None) -> torch.Tensor:
        """Full-sequence forward; training mode when ``rng`` is given. With
        ``sequence_parallel``, ``inputs_embeds`` is the rank's part of the
        vocabulary-sharded lookup (``T5ForConditionalGeneration.encode``),
        summed onto the rank's rows here; the output is gathered whole."""
        _, l_orig, _ = inputs_embeds.shape
        # the encoder pads its stream once to the kernel's 128-row block;
        # padded positions are masked as keys and sliced off at the end
        l = l_orig if self.is_decoder else -(-l_orig // SEQ_PAD_BLOCK) * SEQ_PAD_BLOCK
        if l != l_orig:
            inputs_embeds = F.pad(inputs_embeds, (0, 0, 0, l - l_orig))
            attention_mask = F.pad(attention_mask, (0, l - l_orig))
        rate = self.dropout_rate
        sp = self.sequence_parallel
        shard = model_shard(self, 1) if sp else None
        x = inputs_embeds.to(_dtype(self.cfg))
        if sp:  # each rank's part of the lookup, summed onto its rows
            x = tp.scatter_sequence(x)
        x = _apply_dropout(x, rate, rng, shard)
        if self.mp > 1 and enc_out is not None:  # the decoder's cross keys and values
            enc_out = tp.copy_to_model(enc_out)
        self_bias = self.rel_bias(l, l)
        if self.is_decoder:
            causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
            self_bias = torch.where(causal[None, None], self_bias,
                                    torch.full_like(self_bias, NEG_INF))
        # JAX's ``not deterministic and remat``: training, with autograd on
        remat = rng is not None and torch.is_grad_enabled() and uses_remat(self.cfg)
        for blk in self.blocks:
            args = (x, self_bias, enc_out, attention_mask, enc_mask, rate, rng, sp)
            x = _checkpointed(blk, rng, *args) if remat else blk(*args)
        x = _apply_dropout(self.final_norm(x), rate, rng, shard)
        if sp:
            x = tp.gather_sequence(x, 1, to_model=False)
        return x[:, :l_orig] if l != l_orig else x

    # ----- incremental decoding (t5.py:699-770 there, unrolled layers) -----

    def init_cache(self, batch: int, max_len: int, enc_out: torch.Tensor) -> dict:
        """Zeroed self K/V of ``batch`` rows (beams included) and the cross
        K/V of ``enc_out``'s rows (one per example)."""
        cfg = self.cfg
        dt = _dtype(cfg)
        shape = (batch, cfg.num_heads, max_len, cfg.d_kv)
        dev = enc_out.device
        return {f"block_{i}": {"self": {"k": torch.zeros(shape, dtype=dt, device=dev),
                                        "v": torch.zeros(shape, dtype=dt, device=dev)},
                               "cross": blk.cross_attn.precompute_kv(enc_out)}
                for i, blk in enumerate(self.blocks)}

    def decode_bias_table(self, max_len: int) -> torch.Tensor:
        """``[L, H, L]`` self-attention bias of every decode step: row ``i``
        is the relative-position bias of query ``i`` over all key slots,
        ``NEG_INF`` past ``i``. Built once per generate call."""
        bias = self.rel_bias(max_len, max_len)[0]                   # [H, L, L]
        causal = torch.tril(torch.ones(max_len, max_len, dtype=torch.bool,
                                       device=bias.device))
        bias = torch.where(causal[None], bias, torch.full_like(bias, NEG_INF))
        return bias.transpose(0, 1).contiguous()

    def decode_step(self, token_embeds: torch.Tensor, cache: dict, cache_index: int,
                    enc_mask: torch.Tensor, bias_table: torch.Tensor):
        """One decode step. ``token_embeds [b, 1, d]``; ``bias_table`` from
        ``decode_bias_table``."""
        x = token_embeds.to(_dtype(self.cfg))
        self_bias = bias_table[cache_index][None, :, None, :]        # [1, H, 1, L]
        # each example's live encoder keys, found at the first step and kept
        # in the cache under "cross", which the beam reorder passes by
        cross = cache.get("cross") or {"live": cross_live_ends(enc_mask)}
        new_cache = {"cross": cross}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"block_{i}"] = blk.decode(x, self_bias, cache[f"block_{i}"],
                                                    cache_index, enc_mask, cross["live"])
        return self.final_norm(x), new_cache


class T5ForConditionalGeneration(nn.Module):
    """Encoder-decoder with shared embeddings and (optionally tied) LM head.
    Under tensor parallelism ``shared`` (and ``lm_head``) hold the rank's
    vocabulary rows and the logits are the rank's columns
    (``parallel/tensor_parallel.vocab_parallel_cross_entropy`` takes them)."""

    mp = 1

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, is_decoder=False)
        self.decoder = T5Stack(cfg, is_decoder=True)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    def embed(self, ids: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """The embeddings of ``ids``; under tensor parallelism ``reduce=False``
        gives this rank's part (its vocabulary rows, zeros elsewhere)."""
        if self.mp > 1:
            return tp.vocab_parallel_embedding(ids, self.shared.weight,
                                               reduce).to(_dtype(self.cfg))
        return F.embedding(ids.long(), self.shared.weight).to(_dtype(self.cfg))

    def encode(self, input_ids: Optional[torch.Tensor] = None,
               inputs_embeds: Optional[torch.Tensor] = None,
               attention_mask: Optional[torch.Tensor] = None,
               rng: Optional[StepRng] = None) -> torch.Tensor:
        sp = self.encoder.sequence_parallel
        if sp and inputs_embeds is not None:
            raise ValueError("a sequence-parallel encoder embeds its input_ids itself")
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids, reduce=not sp)
        if attention_mask is None:
            attention_mask = torch.ones(inputs_embeds.shape[:2], dtype=torch.int32,
                                        device=inputs_embeds.device)
        return self.encoder(inputs_embeds, attention_mask, rng=rng)

    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """float32 logits; under tensor parallelism the rank's vocabulary
        columns."""
        cfg = self.cfg
        if self.mp > 1:
            hidden = tp.copy_to_model(hidden)
        if cfg.tie_word_embeddings:
            hidden = hidden * (cfg.d_model ** -0.5)
            logits = torch.matmul(hidden, self.shared.weight.to(hidden.dtype).t())
        else:
            logits = _linear(hidden, self.lm_head, _dtype(cfg))
        return logits.float()

    def decode(self, decoder_input_ids: torch.Tensor,
               decoder_attention_mask: torch.Tensor, enc_out: torch.Tensor,
               enc_mask: torch.Tensor, rng: Optional[StepRng] = None) -> torch.Tensor:
        dec = self.decoder(self.embed(decoder_input_ids), decoder_attention_mask,
                           enc_out=enc_out.to(_dtype(self.cfg)), enc_mask=enc_mask,
                           rng=rng)
        return self.logits_from_hidden(dec)

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                decoder_attention_mask, rng: Optional[StepRng] = None) -> torch.Tensor:
        enc = self.encode(input_ids=input_ids, attention_mask=attention_mask, rng=rng)
        return self.decode(decoder_input_ids, decoder_attention_mask, enc,
                           attention_mask, rng=rng)

    # decode-step API used by ops.decoding

    def init_cache(self, batch: int, max_len: int, enc_out: torch.Tensor) -> dict:
        return self.decoder.init_cache(batch, max_len, enc_out)

    def decode_step(self, token_ids: torch.Tensor, cache: dict, cache_index: int,
                    enc_mask: torch.Tensor, bias_table: torch.Tensor):
        """token_ids ``[b]`` -> (logits ``[b, vocab]`` float32, new cache)."""
        hidden, cache = self.decoder.decode_step(self.embed(token_ids[:, None]), cache,
                                                 cache_index, enc_mask, bias_table)
        return self.logits_from_hidden(hidden)[:, 0], cache

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Mesh-TF factor-scaled normal init (the JAX package's initializers;
        the same distributions, not the same numbers), drawn on
        ``generator``'s device in each parameter's dtype."""
        cfg = self.cfg
        inner = cfg.num_heads * cfg.d_kv

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device,
                                dtype=p.dtype) * std)

        normal(self.shared.weight, 1.0)
        for stack in (self.encoder, self.decoder):
            normal(stack.rel_bias.rel_embedding, cfg.d_model ** -0.5)
            for blk in stack.blocks:
                attns = [blk.self_attn] + ([blk.cross_attn] if blk.is_decoder else [])
                for attn in attns:
                    normal(attn.q.weight, (cfg.d_model * cfg.d_kv) ** -0.5)
                    normal(attn.k.weight, cfg.d_model ** -0.5)
                    normal(attn.v.weight, cfg.d_model ** -0.5)
                    normal(attn.o.weight, inner ** -0.5)
                for name in ("wi", "wi_0", "wi_1"):
                    if hasattr(blk.ff, name):
                        normal(getattr(blk.ff, name).weight, cfg.d_model ** -0.5)
                normal(blk.ff.wo.weight, cfg.d_ff ** -0.5)
        if not cfg.tie_word_embeddings:
            normal(self.lm_head.weight, cfg.d_model ** -0.5)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int = 0,
                pad_token_id: int = 0) -> torch.Tensor:
    """HF ``_shift_right``: prepend the start token, drop the last."""
    shifted = torch.zeros_like(labels)
    shifted[:, 1:] = labels[:, :-1]
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id), shifted)


def label_smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.1,
                                 ignore_index: int = -100,
                                 denom: Optional[int] = None) -> torch.Tensor:
    """Mean CE with label smoothing over non-ignored positions, as torch's
    ``CrossEntropyLoss(ignore_index=-100, label_smoothing=s)``. ``denom``
    replaces the count of non-ignored labels the sum is divided by (data
    parallelism passes the global batch's count; at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    smooth = -torch.mean(logp, dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    denom = torch.clamp(mask.sum(), min=1) if denom is None else max(int(denom), 1)
    return torch.where(mask, loss, torch.zeros_like(loss)).sum() / denom
