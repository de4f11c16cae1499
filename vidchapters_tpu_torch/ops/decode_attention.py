"""One decoder layer's attention for one step of the standard cached decode.

``decode_self_attention`` and ``decode_cross_attention`` launch
``csrc/decode_attention.cu`` for CUDA tensors and run their plain versions
(``*_plain``, the same functions in plain PyTorch) for CPU tensors.
Counterpart of ``vidchapters_tpu/ops/decode_attention.py``; the JAX package
takes it only under ``USE_FUSED_DECODE``, the port's standard decode always.

- self: write ``k_new`` / ``v_new`` at row ``cache_index`` of the caches in
  place (the TPU kernel's ``input_output_aliases={4: 1, 5: 2}``), then
  attend over the cache with the pre-masked bias row (``NEG_INF`` past the
  index); scores, softmax and p.v in fp32, output in q's dtype.
- cross: ``g = q.shape[0] // k.shape[0]`` beams per example share that
  example's K/V; masked keys score ``NEG_INF``; fp32 softmax and p.v. The
  kernel reads each example's live keys only (``cross_live_ends``), which a
  caller finds once per decode call and passes to every launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vidchapters_tpu_torch.ops._build import (I, P, CudaKernel, arrival_counters, sm_count,
                                              stream_ptr)

NEG_INF = -1e9
MAX_GROUP = 8    # beams per example the cross kernel takes
MAX_HEAD_DIM = 128

# one library, two entry points: a CudaKernel for each, so that each counts
# its own launches
SELF_KERNEL = CudaKernel("decode_attention",
                         {"decode_self_attention": [P] * 9 + [I] * 8 + [P]})
CROSS_KERNEL = CudaKernel("decode_attention",
                          {"decode_cross_attention": [P] * 8 + [I] * 7 + [P]})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_self_attention_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                k_cache: torch.Tensor, v_cache: torch.Tensor,
                                bias_row: torch.Tensor, cache_index: int
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The self kernel's function in plain PyTorch; the caches are written in
    place and returned."""
    idx = int(cache_index)
    k_cache[:, :, idx] = k_new[:, :, 0]
    v_cache[:, :, idx] = v_new[:, :, 0]
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) + bias_row.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v_cache.float()).to(q.dtype), k_cache, v_cache


def decode_cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 key_mask: torch.Tensor) -> torch.Tensor:
    """The cross kernel's function in plain PyTorch: the grouped
    ``[B0, g, H, 1, D]`` product over per-example K/V."""
    b0, heads, _, d = k.shape
    g = q.shape[0] // b0
    qg = q.float().reshape(b0, g, heads, 1, d)
    scores = torch.einsum("bghqd,bhkd->bghqk", qg, k.float())
    valid = (key_mask > 0)[:, None, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghqk,bhkd->bghqd", probs, v.float())
    return out.reshape(b0 * g, heads, 1, d).to(q.dtype)


def _check(fn: str, name: str, t: torch.Tensor, shape, dtype, vectors: bool = False) -> None:
    """Shape, dtype, device and layout; ``vectors``: the kernel reads it in
    16-byte vectors, so it must start on a 16-byte boundary."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if t.device.type != "cuda" or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous CUDA tensor")
    if vectors and t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")


def _check_width(fn: str, dtype: torch.dtype, d: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes float32 or bfloat16, not {dtype}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head width {d} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")


def decode_self_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          bias_row: torch.Tensor, cache_index: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One self-attention decode step.

    q / k_new / v_new ``[R, H, 1, D]``; k_cache / v_cache ``[R, H, L, D]``;
    bias_row ``[1, H, 1, L]`` with ``NEG_INF`` past ``cache_index``. Returns
    ``(out [R, H, 1, D], k_cache, v_cache)``, the caches being the same
    tensors, written at row ``cache_index``."""
    if q.device.type == "cpu":
        return decode_self_attention_plain(q, k_new, v_new, k_cache, v_cache, bias_row,
                                           cache_index)
    fn = "decode_self_attention"
    r, heads, _, d = q.shape
    length = k_cache.shape[2]
    idx = int(cache_index)
    _check_width(fn, q.dtype, d)
    if not 0 <= idx < length:
        raise ValueError(f"{fn}: cache_index {idx} outside [0, {length})")
    q, k_new, v_new = (t.contiguous() for t in (q, k_new, v_new))
    _check(fn, "q", q, (r, heads, 1, d), q.dtype)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _check(fn, name, t, (r, heads, 1, d), q.dtype, vectors=True)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(fn, name, t, (r, heads, length, d), q.dtype, vectors=True)
    bias_row = bias_row.contiguous()
    _check(fn, "bias_row", bias_row, (1, heads, 1, length), q.dtype)
    splits, span = self_splits(r * heads, idx + 1, sm_count(q.device.index))
    return _launch_self(q, k_new, v_new, k_cache, v_cache, bias_row, idx, splits, span)


SELF_SPLIT_MIN = 64  # fewest keys a split of the self kernel takes


def self_splits(units: int, n_keys: int, sm_count: int) -> Tuple[int, int]:
    """``(splits, span)``: the self kernel's ``n_keys`` keys go to ``splits``
    blocks of ``span`` keys per (row, head), enough blocks for two per SM
    while each split keeps at least ``SELF_SPLIT_MIN`` keys."""
    splits = max(1, min(-(-2 * sm_count // units), n_keys // SELF_SPLIT_MIN))
    return splits, -(-n_keys // splits)


def _launch_self(q, k_new, v_new, k_cache, v_cache, bias_row, idx: int, splits: int,
                 span: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the self kernel on checked, contiguous inputs."""
    r, heads, _, d = q.shape
    out = torch.empty_like(q)
    part = arrived = None
    if splits > 1:
        part = torch.empty(r * heads * splits * (d + 2), dtype=torch.float32, device=q.device)
        arrived = arrival_counters(q.device, r * heads)
    SELF_KERNEL.launch("decode_self_attention", q.data_ptr(), k_new.data_ptr(),
                       v_new.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       bias_row.data_ptr(), out.data_ptr(),
                       *(0 if t is None else t.data_ptr() for t in (part, arrived)),
                       r, heads, k_cache.shape[2], d, idx, splits, span,
                       _DTYPE_CODE[q.dtype], stream_ptr())
    return out, k_cache, v_cache


def cross_live_ends(key_mask: torch.Tensor) -> torch.Tensor:
    """``[B0]`` int32: each example's live keys for the cross kernel, up to
    and including its last unmasked key, or all ``Lk`` keys where none is
    unmasked (every key then scores ``NEG_INF`` alike, and the output is the
    mean of V over all of them). A masked key past the end adds exactly 0
    once one key is live, so the kernel reads no K/V row beyond it."""
    lk = key_mask.shape[1]
    pos = torch.arange(1, lk + 1, dtype=torch.int32, device=key_mask.device)
    ends = ((key_mask > 0) * pos).amax(dim=1)
    return torch.where(ends > 0, ends, lk).to(torch.int32)


def cross_blocks(b0: int, heads: int, sm_count: int) -> int:
    """The cross kernel's grid: two blocks per SM, and one per (example,
    head) at least. The kernel sizes its chunks of live keys to it."""
    return max(2 * sm_count, b0 * heads)


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor,
                           live_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cross-attention decode step: q ``[B0*g, H, 1, D]`` (beam-major
    within each example) over per-example k / v ``[B0, H, Lk, D]`` under
    key_mask ``[B0, Lk]``. Returns ``[B0*g, H, 1, D]`` in q's dtype.
    ``live_ends``: ``cross_live_ends(key_mask)``, which the kernel takes;
    derived here when not given."""
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, key_mask)
    fn = "decode_cross_attention"
    b0, heads, lk, d = k.shape
    rows = q.shape[0]
    _check_width(fn, q.dtype, d)
    if rows % b0 or not 1 <= rows // b0 <= MAX_GROUP:
        raise ValueError(f"{fn}: {rows} query rows is not {b0} examples x a group of "
                         f"1..{MAX_GROUP} beams")
    q = q.contiguous()
    _check(fn, "q", q, (rows, heads, 1, d), q.dtype)
    for name, t in (("k", k), ("v", v)):
        _check(fn, name, t, (b0, heads, lk, d), q.dtype, vectors=True)
    mask = key_mask.to(torch.int32).contiguous()
    _check(fn, "key_mask", mask, (b0, lk), torch.int32)
    live = cross_live_ends(mask) if live_ends is None else live_ends.contiguous()
    _check(fn, "live_ends", live, (b0,), torch.int32)
    return _launch_cross(q, k, v, mask, live, cross_blocks(b0, heads, sm_count(q.device.index)))


def _launch_cross(q, k, v, mask, live, blocks: int) -> torch.Tensor:
    """Launch the cross kernel on checked, contiguous inputs over a grid of
    ``blocks``."""
    b0, heads, lk, d = k.shape
    g = q.shape[0] // b0
    out = torch.empty_like(q)
    # per item: g running maxima, g sums, g x d accumulators; a counter per
    # (example, head) tells the last chunk to merge them
    part = torch.empty(blocks * g * (d + 2), dtype=torch.float32, device=q.device)
    arrived = arrival_counters(q.device, b0 * heads)
    CROSS_KERNEL.launch("decode_cross_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        mask.data_ptr(), live.data_ptr(), out.data_ptr(), part.data_ptr(),
                        arrived.data_ptr(), b0, g, heads, lk, d, blocks, _DTYPE_CODE[q.dtype],
                        stream_ptr())
    return out
