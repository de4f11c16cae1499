"""1-D multi-scale deformable attention (PDVC's encoder and decoder).

Counterpart of ``vidchapters_tpu/ops/deformable_attention.py``. For each
query, head, level and point, the value rows of that level are linearly
interpolated at pixel coordinate ``loc * T_l - 0.5`` with edge clamping (the
reference's ``grid_sample(bilinear, border, align_corners=False)`` with
height 1), and the samples are summed with the attention weights.

- ``deformable_attention_1d``: the attention, differentiable in value,
  locations and weights (a ``torch.autograd.Function``). CUDA tensors launch
  ``csrc/deformable_attention.cu`` (forward, and backward, whose dvalue is
  summed in shared memory across a thread-block cluster where the slice of
  one (batch, head) fits, the same bits on every run, else with atomics);
  CPU tensors run the plain versions. Float32 only on the card, and a head
  width that is a multiple of 4.
- ``deformable_attention_1d_plain``: the JAX package's dense-lerp form
  (``deformable_attention_1d`` there, lines 97-128; its Pallas kernel and
  gather oracle compute the same function) in plain PyTorch.
- ``deformable_attention_1d_bwd_plain``: the autograd VJP of the plain form,
  which is what the JAX custom VJP computes.
- ``deformable_sampling_1d``: the per-sample values (not summed), for the
  LSTM-DSA caption head; a plain gather.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from vidchapters_tpu_torch.ops._build import I, P, CudaKernel, stream_ptr

MAX_LEVELS = 16
MAX_HEAD_DIM = 128

# one library, two entry points, each with its own launch count
FWD_KERNEL = CudaKernel("deformable_attention", {"deformable_attention_fwd": [P] * 4 + [I] * 6
                                                 + [P, I, P]})
BWD_KERNEL = CudaKernel("deformable_attention", {"deformable_attention_bwd": [P] * 7 + [I] * 6
                                                 + [P, I, P]})


def _lerp_indices(loc: torch.Tensor, t_l: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """loc in [0, 1] -> (x0, x1, w0, w1): the two taps, clamped to the
    level, and their weights."""
    px = loc * t_l - 0.5
    x0 = torch.floor(px)
    w1 = px - x0
    w0 = 1.0 - w1
    # clamp before the conversion (a far-off location cannot overflow); the
    # taps after the clip are the same
    x0i = x0.clamp(-1, t_l).long()
    return x0i.clamp(0, t_l - 1), (x0i + 1).clamp(0, t_l - 1), w0, w1


def deformable_attention_1d_plain(value: torch.Tensor, spatial_shapes: Sequence[int],
                                  sampling_locations: torch.Tensor,
                                  attention_weights: torch.Tensor) -> torch.Tensor:
    """value [N, S, M, D] (S = sum of ``spatial_shapes``); sampling_locations,
    attention_weights [N, Lq, M, L, P]. Returns [N, Lq, M*D]. Per level, the
    attention-folded interpolation matrix [N, Lq, M, T_l] (two nonzeros per
    point) contracted with the level's values, in float32."""
    n, _, m, d = value.shape
    lq = sampling_locations.shape[1]
    acc = torch.zeros((n, lq, m, d), dtype=torch.float32, device=value.device)
    start = 0
    for lid, t_l in enumerate(spatial_shapes):
        v = value[:, start:start + t_l].float()
        attn = attention_weights[:, :, :, lid].float()
        x0, x1, w0, w1 = _lerp_indices(sampling_locations[:, :, :, lid], t_l)
        oh0 = F.one_hot(x0, t_l).float()
        oh1 = F.one_hot(x1, t_l).float()
        w = ((attn * w0)[..., None] * oh0 + (attn * w1)[..., None] * oh1).sum(dim=3)
        acc = acc + torch.einsum("nqmt,ntmd->nqmd", w, v)
        start += t_l
    return acc.reshape(n, lq, m * d).to(value.dtype)


def deformable_attention_1d_bwd_plain(value: torch.Tensor, spatial_shapes: Sequence[int],
                                      sampling_locations: torch.Tensor,
                                      attention_weights: torch.Tensor, grad_out: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dvalue, dloc, dattn): the VJP of the plain form at ``grad_out``
    [N, Lq, M*D] (the JAX custom VJP's ``_bwd``)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = deformable_attention_1d_plain(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out.float())


def _check(fn: str, name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32 on the card, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _on_card(fn: str, *ts: torch.Tensor) -> None:
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"{fn}: every tensor must be on the card, or every one on the CPU")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (the kernels read value and the
    output gradient as float4), copied where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(fn: str, value, spatial_shapes, loc, attn):
    """The checked sizes ``(n, s, lq, m, d, levels, p)`` and the host array
    of level lengths."""
    n, s, m, d = value.shape
    lq, levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    shapes = [int(t) for t in spatial_shapes]
    if len(shapes) != levels or not 1 <= levels <= MAX_LEVELS or sum(shapes) != s:
        raise ValueError(f"{fn}: spatial_shapes {shapes} do not fit value {tuple(value.shape)} "
                         f"and {levels} levels (at most {MAX_LEVELS})")
    if not 4 <= d <= MAX_HEAD_DIM or d % 4:
        raise ValueError(f"{fn}: head width {d} is not a multiple of 4 in [4, {MAX_HEAD_DIM}]")
    _check(fn, "value", value, (n, s, m, d))
    _check(fn, "sampling_locations", loc, (n, lq, m, levels, p))
    _check(fn, "attention_weights", attn, (n, lq, m, levels, p))
    return (n, s, lq, m, d, levels, p), (ctypes.c_int * levels)(*shapes)


def _forward(value: torch.Tensor, spatial_shapes: Sequence[int], loc: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
    if value.device.type == "cpu":
        return deformable_attention_1d_plain(value, spatial_shapes, loc, attn)
    _on_card("deformable_attention_1d", value, loc, attn)
    return _launch_fwd(value, spatial_shapes, loc, attn)


def _launch_fwd(value: torch.Tensor, spatial_shapes: Sequence[int], loc: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch on tensors of one device."""
    fn = "deformable_attention_1d"
    value, loc, attn = _aligned(value), loc.contiguous(), attn.contiguous()
    (n, s, lq, m, d, levels, p), shapes = _kernel_args(fn, value, spatial_shapes, loc, attn)
    out = torch.empty((n, lq, m * d), dtype=torch.float32, device=value.device)
    FWD_KERNEL.launch("deformable_attention_fwd", value.data_ptr(), loc.data_ptr(),
                      attn.data_ptr(), out.data_ptr(), n, s, lq, m, d, levels,
                      ctypes.addressof(shapes), p, stream_ptr())
    return out


def deformable_attention_1d_bwd(value: torch.Tensor, spatial_shapes: Sequence[int],
                                sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                                grad_out: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dvalue, dloc, dattn) at ``grad_out`` [N, Lq, M*D]: the backward
    kernel for CUDA tensors (one launch; it writes every element of its
    outputs, so none is zeroed here), the plain VJP for CPU tensors."""
    if value.device.type == "cpu":
        return deformable_attention_1d_bwd_plain(value, spatial_shapes, sampling_locations,
                                                 attention_weights, grad_out)
    _on_card("deformable_attention_1d_bwd", value, sampling_locations, attention_weights,
             grad_out)
    return _launch_bwd(value, spatial_shapes, sampling_locations, attention_weights, grad_out)


def _launch_bwd(value: torch.Tensor, spatial_shapes: Sequence[int],
                sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's launch on tensors of one device."""
    fn = "deformable_attention_1d_bwd"
    value, grad_out = _aligned(value), _aligned(grad_out)
    loc, attn = sampling_locations.contiguous(), attention_weights.contiguous()
    (n, s, lq, m, d, levels, p), shapes = _kernel_args(fn, value, spatial_shapes, loc, attn)
    _check(fn, "grad_out", grad_out, (n, lq, m * d))
    dvalue = torch.empty_like(value)
    dloc, dattn = torch.empty_like(loc), torch.empty_like(attn)
    BWD_KERNEL.launch("deformable_attention_bwd", value.data_ptr(), loc.data_ptr(),
                      attn.data_ptr(), grad_out.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                      dattn.data_ptr(), n, s, lq, m, d, levels, ctypes.addressof(shapes), p,
                      stream_ptr())
    return dvalue, dloc, dattn


class _DeformableAttention1D(torch.autograd.Function):
    """The custom VJP of deformable_attention.py:236-280 there: the forward
    saves its three inputs; the backward is one kernel launch."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = tuple(spatial_shapes)
        return _forward(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        dv, dloc, dattn = deformable_attention_1d_bwd(value, ctx.spatial_shapes, loc, attn,
                                                      grad_out)
        return dv.to(value.dtype), dloc, dattn, None


def deformable_attention_1d(value: torch.Tensor, spatial_shapes: Sequence[int],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor) -> torch.Tensor:
    """value [N, S, M, D]; sampling_locations, attention_weights
    [N, Lq, M, L, P] -> [N, Lq, M*D]. Differentiable in all three."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return _DeformableAttention1D.apply(value, sampling_locations, attention_weights,
                                            tuple(spatial_shapes))
    return _forward(value, spatial_shapes, sampling_locations, attention_weights)


def deformable_sampling_1d(value: torch.Tensor, spatial_shapes: Sequence[int],
                           sampling_locations: torch.Tensor) -> torch.Tensor:
    """The sampled values, not summed (the ``return_value=True`` mode of the
    reference's fallback, used by the LSTM-DSA caption head): value
    [N, S, M, D], sampling_locations [N, Lq, M, L, P] -> [N, Lq, M, L, P, D]."""
    n, _, m, d = value.shape
    _, lq, _, _, p = sampling_locations.shape
    per_level = []
    start = 0
    for lid, t_l in enumerate(spatial_shapes):
        v = value[:, start:start + t_l].permute(0, 2, 1, 3)  # [N, M, T, D]
        x0, x1, w0, w1 = _lerp_indices(sampling_locations[:, :, :, lid], t_l)

        def gather(idx):  # [N, Lq, M, P] -> [N, Lq, M, P, D]
            flat = idx.permute(0, 2, 1, 3).reshape(n, m, lq * p, 1).expand(-1, -1, -1, d)
            return torch.gather(v, 2, flat).reshape(n, m, lq, p, d).permute(0, 2, 1, 3, 4)

        per_level.append(w0[..., None] * gather(x0) + w1[..., None] * gather(x1))
        start += t_l
    return torch.stack(per_level, dim=3)
