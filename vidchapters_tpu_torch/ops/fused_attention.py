"""Fused bias-aware attention (T5 self- and cross-attention at long lengths).

``softmax(q k^T + bias + (mask - 1) * 1e9) v``, unscaled as in T5, with
optional dropout on the probabilities, without a ``[B, H, Lq, Lk]`` score
tensor in device memory. Counterpart of
``vidchapters_tpu/ops/fused_attention.py``.

- For CUDA tensors the forward launches ``csrc/fused_attention_fwd.cu`` (a
  flash-style forward with an online softmax, which also writes each row's
  log-sum-exp for the backward) and the backward ``csrc/fused_attention_bwd.cu``
  (dq, dk, dv and ``dbias = sum_b dS``, recomputing the probabilities from
  that log-sum-exp).
- For CPU tensors both run their plain PyTorch versions,
  ``fused_attention_plain`` and ``fused_attention_bwd_plain``, which are also
  the kernels' yardsticks on the card.

Dropout is a keep mask hashed from (seed, batch, head, absolute query row,
key column), ``keep_scale``: the forward and the backward rebuild the same
mask from one uint32 seed, so no ``O(L^2)`` mask is kept between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.ops._build import F, I, P, U32, CudaKernel, stream_ptr

NEG_INF = -1e9
BLOCK_Q = 128
HEAD_DIMS = (32, 64, 128)  # head widths the kernels are instantiated for

KERNEL = CudaKernel("fused_attention_fwd", {
    "fused_attention_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, U32, I, I, F, P]})
BWD_KERNEL = CudaKernel("fused_attention_bwd", {
    "fused_attention_bwd": [P, P, P, P, P, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, I, U32, I, I, F, P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def _pad_to(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - dim - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths)


# ---------------------------------------------------------------------------
# the hashed keep mask (uint32 arithmetic carried in int64)
# ---------------------------------------------------------------------------


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the product
    is split at 16 bits of ``c`` so no int64 product overflows."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def murmur_mix(x):
    """The murmur3 finaliser steps of both keep masks (after the seed xor)."""
    x = mul32(x, 0xCC9E2D51)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_scale(rate: float) -> float:
    """``1 / (1 - rate)`` rounded to float32, the scale of a kept element."""
    return float(np.float32(1.0 / (1.0 - rate)))


def keep_scale(seed: int, b, h, q0: int, block_q: int, lk: int, rate: float,
               device=None) -> torch.Tensor:
    """``[..., block_q, lk]`` float32: ``1/(1-rate)`` where kept, else 0.

    One murmur3 hash of ``x = (row + q0) * (lk/2) + col`` yields two 16-bit
    decisions: lane ``j < lk/2`` takes the low half, lane ``j + lk/2`` the
    high half. The seed is mixed with ``b * 0x9E3779B1`` and
    ``h * 0x85EBCA6B``; ``b`` and ``h`` may be ints or int64 tensors that
    broadcast in front of the last two dimensions (one mask per (b, h)).
    Rows are absolute (``q0`` is the first row's index) and ``lk`` is the
    padded key length the kernel sees. Mirrors ``_keep_scale``
    (vidchapters_tpu/ops/fused_attention.py:72-99)."""
    half = lk // 2
    rows = torch.arange(block_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(half, dtype=torch.int64, device=device)[None, :]
    x = (mul32((rows + q0) & _M32, half) + cols) & _M32
    b = torch.as_tensor(b, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=torch.int64, device=device)
    s = (seed & _M32) ^ mul32(b, 0x9E3779B1) ^ mul32(h, 0x85EBCA6B)
    x = murmur_mix(x ^ s)
    thresh = min(int(rate * 65536.0), 65535)
    inv = torch.tensor(dropout_scale(rate), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    lo = torch.where((x & 0xFFFF) >= thresh, inv, zero)
    hi = torch.where((x >> 16) >= thresh, inv, zero)
    return torch.cat([lo, hi], dim=-1)


def _keep_full(seed: int, b: int, h: int, lq: int, lk: int, rate: float,
               device) -> torch.Tensor:
    """The keep mask over a whole ``[B, H, Lq, Lk]`` score tensor."""
    bi = torch.arange(b, device=device)[:, None, None, None]
    hi = torch.arange(h, device=device)[None, :, None, None]
    return keep_scale(seed, bi, hi, 0, lq, lk, rate, device)


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' yardsticks on the card)
# ---------------------------------------------------------------------------


def _scores(q, k, bias, key_mask) -> torch.Tensor:
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    return scores + (key_mask[:, None, None, :].float() - 1.0) * -NEG_INF


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], key_mask: torch.Tensor,
                          seed: int = 0, dropout_rate: float = 0.0) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: fp32 scores and
    softmax, the keep mask on the normalised probabilities, which are
    rounded to v's dtype before the product with v (fused_attention.py:
    107-138 there)."""
    probs = torch.softmax(_scores(q, k, bias, key_mask), dim=-1)
    if dropout_rate > 0.0:
        b, h, lq, lk = probs.shape
        probs = probs * _keep_full(seed, b, h, lq, lk, dropout_rate, q.device)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention_bwd_plain(q, k, v, bias, key_mask, seed: int, dropout_rate: float,
                              out, dout) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch, step by step as
    ``_bwd_kernel`` (fused_attention.py:196-259 there): recompute the
    softmax, ``delta = rowsum(dout * out)`` with ``out`` as stored, the keep
    mask on ``dp`` and ``p``, ``ds = p (dp - delta)`` rounded to the input
    dtype before its products. Returns float32 ``(dq, dk, dv, dbias)``,
    ``dbias = sum_b ds`` (``[1, H, Lq, Lk]``) or None without a bias."""
    scores = _scores(q, k, bias, key_mask)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True)
    delta = (dout.float() * out.float()).sum(dim=-1)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        b, h, lq, lk = p.shape
        keep = _keep_full(seed, b, h, lq, lk, dropout_rate, q.device)
        dp = dp * keep
        pd = p * keep
    ds = p * (dp - delta[..., None])
    ds_c = ds.to(k.dtype).float()
    dq = torch.matmul(ds_c, k.float())
    dk = torch.matmul(ds_c.transpose(-1, -2), q.float())
    dv = torch.matmul(pd.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dbias = ds.sum(dim=0, keepdim=True) if bias is not None else None
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, bias, key_mask, name: str) -> None:
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or (
            bias is not None and bias.dtype != q.dtype):
        raise TypeError(f"{name}: q, k, v and bias must share a dtype")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bias is not None and tuple(bias.shape) != (1, h, lq, lk):
        raise ValueError(f"{name}: bias must be [1,{h},{lq},{lk}], got {tuple(bias.shape)}")
    if tuple(key_mask.shape) != (b, lk):
        raise ValueError(f"{name}: key_mask must be [{b},{lk}]")
    if d not in HEAD_DIMS or lk % 64:
        raise ValueError(f"{name}: kernel needs D in {HEAD_DIMS} and Lk % 64 == 0 "
                         f"(D={d}, Lk={lk})")


def _dropout_args(seed: int, dropout_rate: float):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    on = dropout_rate > 0.0
    return (seed & _M32, int(on), min(int(dropout_rate * 65536.0), 65535) if on else 0,
            dropout_scale(dropout_rate) if on else 1.0)


def _forward(q, k, v, bias, key_mask, seed: int, dropout_rate: float,
             want_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse): CPU tensors take the plain version (no lse); CUDA
    tensors the kernel, which writes ``lse = m + log l`` per row
    (``[B, H, Lq]`` float32) when asked."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, key_mask, seed, dropout_rate), None
    _check(q, k, v, bias, key_mask, "fused_attention")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = bias.contiguous() if bias is not None else None
    mask = key_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    KERNEL.launch("fused_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  0 if bias is None else bias.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                  b, h, lq, lk, d, _DTYPE_CODE[q.dtype],
                  *_dropout_args(seed, dropout_rate), stream_ptr())
    return out, lse


def fused_attention_bwd(q, k, v, bias, key_mask, seed: int, dropout_rate: float,
                        out, dout, lse) -> Tuple[torch.Tensor, ...]:
    """float32 ``(dq, dk, dv, dbias)`` of the fused attention. CPU tensors
    take ``fused_attention_bwd_plain`` (``lse`` unused); CUDA tensors the
    kernel, which needs the forward's ``lse``."""
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, bias, key_mask, seed, dropout_rate,
                                         out, dout)
    _check(q, k, v, bias, key_mask, "fused_attention_bwd")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("fused_attention_bwd: out and dout must match q")
    if lse is None or tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"fused_attention_bwd: lse must be float32 [{b},{h},{lq}]")
    q, k, v, out, lse = (t.contiguous() for t in (q, k, v, out, lse))
    dout = dout.to(q.dtype).contiguous()
    bias = bias.contiguous() if bias is not None else None
    mask = key_mask.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty(q.shape, **f32), torch.empty(k.shape, **f32), torch.empty(v.shape, **f32)
    dbias = torch.empty((1, h, lq, lk), **f32) if bias is not None else None
    delta = torch.empty((b, h, lq), **f32)  # scratch: rowsum(dout * out)
    BWD_KERNEL.launch("fused_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      0 if bias is None else bias.data_ptr(), mask.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      0 if dbias is None else dbias.data_ptr(), delta.data_ptr(),
                      b, h, lq, lk, d, _DTYPE_CODE[q.dtype],
                      *_dropout_args(seed, dropout_rate), stream_ptr())
    return dq, dk, dv, dbias


class _FusedAttention(torch.autograd.Function):
    """The custom VJP of fused_attention.py:362-392 there: the forward
    saves q, k, v, bias, the mask, out and (on the card) lse; the backward
    rebuilds the keep mask from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, seed, dropout_rate):
        out, lse = _forward(q, k, v, bias, key_mask, seed, dropout_rate,
                            want_lse=q.device.type != "cpu")
        ctx.save_for_backward(q, k, v, bias, key_mask, out, lse)
        ctx.seed, ctx.dropout_rate = seed, dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_bwd(q, k, v, bias, key_mask, ctx.seed,
                                                ctx.dropout_rate, out, dout, lse)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if dbias is None else dbias.to(bias.dtype), None, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], key_mask: torch.Tensor,
                    seed: int = 0, dropout_rate: float = 0.0) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] (Lk a multiple of 64 on the card), bias
    [1,H,Lq,Lk] broadcast over the batch or None, key_mask [B,Lk] (1 =
    valid), ``seed`` a uint32 (read only when ``dropout_rate > 0``).
    Differentiable in q, k, v and bias. CPU tensors take the plain versions;
    CUDA tensors the kernels."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FusedAttention.apply(q, k, v, bias, key_mask, seed, dropout_rate)
    return _forward(q, k, v, bias, key_mask, seed, dropout_rate, want_lse=False)[0]


def fused_attention_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], key_mask: torch.Tensor,
                           seed: int = 0, dropout_rate: float = 0.0) -> torch.Tensor:
    """``fused_attention`` at any lengths: Lk pads to a multiple of 128
    (padded keys masked out), Lq to 8 up to 512 and to 128 beyond (padded
    query rows sliced off), as fused_attention.py:395-418 there does. The
    keep mask is hashed over the padded Lk, as there."""
    lq, lk = q.shape[2], k.shape[2]
    lqp = (-(-lq // 8) * 8 if lq <= 512 else -(-lq // BLOCK_Q) * BLOCK_Q)
    lkp = -(-lk // BLOCK_Q) * BLOCK_Q
    if lqp != lq:
        q = _pad_to(q, lqp, 2)
    if lkp != lk:
        k = _pad_to(k, lkp, 2)
        v = _pad_to(v, lkp, 2)
        key_mask = _pad_to(key_mask, lkp, 1)
    if bias is not None and (lqp != lq or lkp != lk):
        bias = _pad_to(_pad_to(bias, lqp, 2), lkp, 3)
    return fused_attention(q, k, v, bias, key_mask, seed, dropout_rate)[:, :, :lq]
