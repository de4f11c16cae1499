"""The collectives of Megatron tensor parallelism over the model axis.

JAX has no counterpart file: there the parameters carry the
``NamedSharding`` of ``parallel/sharding.py``'s ``_RULES`` and GSPMD inserts
these collectives itself. Here each is an ``autograd.Function`` over the
model group of ``runtime/mesh.py`` (the ranks of one data index, in the
order of their model index):

- ``copy_to_model``: forward identity, backward all-reduce (the input of a
  column-sharded product, whose gradient each rank holds a part of);
- ``reduce_from_model``: forward all-reduce, backward identity (the output
  of a row-sharded product);
- ``gather_sequence``: forward all-gather over a sequence axis, backward
  reduce-scatter into a column-sharded product, or the rank's rows back to
  a replicated consumer;
- ``scatter_sequence``: forward reduce-scatter, backward all-gather (a
  row-sharded output onto the sequence-sharded stream);
- ``vocab_parallel_embedding`` and ``vocab_parallel_cross_entropy``: the
  tied embedding sharded by vocabulary rows.

Every rank of a group gets the same bits, and a sum is that of the values
in float32 rounded once to the tensor's dtype (``_sum_dtype``). On NCCL
the gathers and scatters are ``all_gather_into_tensor`` /
``reduce_scatter_tensor``; on gloo (ranks on the CPU, or ranks sharing one
card) a gather is gloo's list ``all_gather`` and a scatter the slice of an
``all_reduce``, which gloo takes for CPU and CUDA tensors alike (``_GLOO``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vidchapters_tpu_torch.runtime import mesh


def _group():
    return mesh.model_group()


def _is_gloo(group) -> bool:
    # _GLOO: gloo's all_gather_into_tensor / reduce_scatter_tensor are not
    # known to take CUDA tensors, so the gloo route gathers with the list
    # all_gather and scatters the slice of an all_reduce. One route per
    # backend, chosen here only.
    return dist.get_backend(group) == "gloo"


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a sum over the model group travels and adds in: the
    tensor's own over two ranks (one add of two values rounds once, as
    float32's sum rounded to the dtype does), float32 over more."""
    return x.dtype if mesh.model_size() == 2 else torch.float32


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group (``_sum_dtype``)."""
    y = x.to(_sum_dtype(x), memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=_group())
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim`` in rank order."""
    group, mp = _group(), mesh.model_size()
    x = x.movedim(dim, 0).contiguous()
    if _is_gloo(group):
        parts = [torch.empty_like(x) for _ in range(mp)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    else:
        out = torch.empty((mp * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's sum of ``x`` (``_sum_dtype``), this rank's slice of
    ``dim`` (its length over the group's size)."""
    group, mp, r = _group(), mesh.model_size(), mesh.model_rank()
    if x.shape[dim] % mp:
        raise ValueError(f"reduce_scatter: length {x.shape[dim]} over {mp} ranks")
    n = x.shape[dim] // mp
    xf = x.movedim(dim, 0).to(_sum_dtype(x), memory_format=torch.contiguous_format,
                              copy=True)
    if _is_gloo(group):
        dist.all_reduce(xf, group=group)
        out = xf[r * n:(r + 1) * n]
    else:
        out = torch.empty((n,) + tuple(xf.shape[1:]), dtype=xf.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xf, group=group)
    return out.to(x.dtype).movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, to_model):
        ctx.dim, ctx.to_model, ctx.n = dim, to_model, x.shape[dim]
        return all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.to_model:
            return reduce_scatter(g, ctx.dim), None, None
        r = mesh.model_rank()
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _ScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The replicated input of column-sharded products (JAX: an activation
    ``P()`` entering a kernel ``P(None, "model")``): the forward passes it,
    the backward sums the ranks' parts of its gradient."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-sharded product (JAX: a kernel ``P("model",
    None)`` contracting a sharded axis, GSPMD's all-reduce): the forward
    sums the ranks' partial outputs, the backward passes the gradient."""
    return _ReduceFromModel.apply(x)


def gather_sequence(x: torch.Tensor, dim: int = 1, to_model: bool = True) -> torch.Tensor:
    """The sequence-sharded stream (JAX: ``P("data", "model")``,
    ``models/t5.SEQUENCE_SHARDING`` there) gathered whole along ``dim``.
    ``to_model``: it feeds column-sharded products, whose gradients the
    backward reduce-scatters; else a replicated consumer, whose gradient the
    backward slices."""
    return _GatherSequence.apply(x, dim, to_model)


def scatter_sequence(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Partial sums (a row-sharded output, or the vocabulary-sharded
    embedding) summed and sharded along ``dim`` onto the
    ``P("data", "model")`` stream; the backward all-gathers."""
    return _ScatterSequence.apply(x, dim)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             reduce: bool = True) -> torch.Tensor:
    """The lookup of a table sharded by rows (JAX: ``shared/embedding``
    ``P("model", None)``): ``weight`` holds this rank's rows from ``model_rank
    * rows``; ids outside them give zeros. ``reduce``: sum over the model
    group (the whole lookup); else each rank's part, for
    ``scatter_sequence``."""
    n = weight.shape[0]
    local = ids.long() - mesh.model_rank() * n
    inside = (local >= 0) & (local < n)
    out = F.embedding(torch.where(inside, local, torch.zeros_like(local)), weight)
    out = out * inside[..., None].to(out.dtype)
    return reduce_from_model(out) if reduce else out


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 vocab_size: int, label_smoothing: float = 0.1,
                                 ignore_index: int = -100,
                                 denom: Optional[int] = None) -> torch.Tensor:
    """``models/t5.label_smoothed_cross_entropy`` of logits sharded by
    vocabulary (JAX: the tied logits ``P(..., "model")``): ``logits`` hold
    this rank's columns from ``model_rank * columns``. The max, the sum of
    exponentials, the target logit and the sum of the logits are reduced
    over the model group; ``log p = z - lse``, the smoothing term is
    ``lse - sum(z) / vocab_size``. ``denom`` as there."""
    z = logits.float()
    n = z.shape[-1]
    m = z.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=_group())
    mask = labels != ignore_index
    local = labels.long() - mesh.model_rank() * n
    inside = mask & (local >= 0) & (local < n)
    zt = torch.gather(z, -1, torch.where(inside, local, torch.zeros_like(local))[..., None])
    parts = reduce_from_model(torch.stack([
        torch.exp(z - m[..., None]).sum(dim=-1),
        zt[..., 0] * inside.to(z.dtype),
        z.sum(dim=-1)]))
    lse = m + torch.log(parts[0])
    nll = lse - parts[1]
    smooth = lse - parts[2] / vocab_size
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    denom = torch.clamp(mask.sum(), min=1) if denom is None else max(int(denom), 1)
    return torch.where(mask, loss, torch.zeros_like(loss)).sum() / denom
