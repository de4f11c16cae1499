"""Fused bias-aware attention (T5 encoder self-attention at long lengths).

``softmax(q k^T + bias + (mask - 1) * 1e9) v``, unscaled as in T5, without
a ``[B, H, Lq, Lk]`` score tensor in device memory. For CUDA tensors the
wrapper launches ``csrc/fused_attention_fwd.cu`` (a flash-style forward with
an online softmax); for CPU tensors it runs ``fused_attention_plain``, the
same function in plain PyTorch, which is also the kernel's yardstick on the
card. Counterpart of ``vidchapters_tpu/ops/fused_attention.py`` (forward
only, no dropout).
"""

from __future__ import annotations

from typing import Optional

import torch

from vidchapters_tpu_torch.ops._build import I, P, CudaKernel, stream_ptr

NEG_INF = -1e9
BLOCK_Q = 128
HEAD_DIMS = (32, 64, 128)  # head widths the kernel is instantiated for

KERNEL = CudaKernel("fused_attention_fwd", {
    "fused_attention_fwd": [P, P, P, P, P, P, I, I, I, I, I, I, P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pad_to(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - dim - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          key_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores and softmax,
    probabilities rounded to v's dtype before the product with v."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    scores = scores + (key_mask[:, None, None, :].float() - 1.0) * -NEG_INF
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    key_mask: torch.Tensor) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] (Lk a multiple of 64 on the card), bias
    [1,H,Lq,Lk] broadcast over the batch or None, key_mask [B,Lk] (1 =
    valid). CPU tensors take the plain version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, key_mask)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or (
            bias is not None and bias.dtype != q.dtype):
        raise TypeError("fused_attention: q, k, v and bias must share a dtype")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"fused_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if bias is not None and tuple(bias.shape) != (1, h, lq, lk):
        raise ValueError(f"fused_attention: bias must be [1,{h},{lq},{lk}], "
                         f"got {tuple(bias.shape)}")
    if tuple(key_mask.shape) != (b, lk):
        raise ValueError(f"fused_attention: key_mask must be [{b},{lk}]")
    if d not in HEAD_DIMS or lk % 64:
        raise ValueError(f"fused_attention: kernel needs D in {HEAD_DIMS} "
                         f"and Lk % 64 == 0 (D={d}, Lk={lk})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = bias.contiguous() if bias is not None else None
    mask = key_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNEL.launch("fused_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), 0 if bias is None else bias.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), b, h, lq, lk, d,
                  _DTYPE_CODE[q.dtype], stream_ptr())
    return out


def fused_attention_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           key_mask: torch.Tensor) -> torch.Tensor:
    """``fused_attention`` at any lengths: Lk pads to a multiple of 128
    (padded keys masked out), Lq to 8 up to 512 and to 128 beyond (padded
    query rows sliced off), as fused_attention.py:395-418 does."""
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
    return fused_attention(q, k, v, bias, key_mask)[:, :, :lq]
