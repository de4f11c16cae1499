"""The collectives of data-parallel training.

Counterpart of the data axis of ``vidchapters_tpu/parallel/sharding.py``
(``host_local_to_global``, :101-112). In JAX each process puts its rows into
one global batch and XLA sums the gradient over the data axis; here each
rank runs its own rows and the train step calls these functions itself:

- ``broadcast_parameters`` makes every rank hold rank 0's weights (after
  init, ``--load`` and resume);
- ``all_reduce_gradients`` sums the ranks' gradients in one flat float32
  bucket, after ``backward()`` and before ``optimizer.step()``, so that
  ``ClipAdamW`` clips and applies the global batch's gradient;
- ``global_counts`` sums host integers (the target tokens or the valid
  spans a loss divides by) over the ranks, on the host;
- ``sum_shares`` sums a step's metrics (the ranks' shares of the global
  losses) over the ranks;
- ``replicas_agree`` checks, by a checksum of the parameters' bits, that
  every rank holds the same weights (the mains call it after training).

The loss of each rank is its share of the global batch's loss: a sum over
its rows divided by the global count, or a mean over its rows divided by
the number of ranks. Summing the shares, and their gradients, over the
ranks gives the global batch's loss and gradient. Outside a process group
every function is the identity; a group of one rank runs each collective.
An explicit all-reduce keeps each parameter's
``.grad`` and the checkpoints' names as they are with one process; the
tensor-parallel rules (``_RULES``, ``infer_param_specs``) are the next
slice (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as dist

from vidchapters_tpu_torch.runtime.collectives import all_gather_object
from vidchapters_tpu_torch.runtime.mesh import distributed, host_group

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank, in place."""
    if not distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the ranks (None counts as
    zeros) in one float32 bucket; each ``.grad`` then holds the sum."""
    if not distributed():
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


def global_counts(counts: Sequence[int]) -> List[int]:
    """Each host integer summed over the ranks, through the host group."""
    if not distributed():
        return [int(c) for c in counts]
    t = torch.tensor([int(c) for c in counts], dtype=torch.int64)
    dist.all_reduce(t, group=host_group())
    return t.tolist()


def global_count(n: int) -> int:
    """``n`` summed over the ranks."""
    return global_counts([n])[0]


def sum_shares(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d tensor of ``metrics`` summed over the ranks, in one
    all-reduce: the ranks' shares of a step's losses give the global ones."""
    if not distributed():
        return metrics
    names = list(metrics)
    summed = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(summed)
    return dict(zip(names, summed.unbind()))


@torch.no_grad()
def parameter_checksum(module: torch.nn.Module) -> str:
    """A digest of the bits of every parameter: each tensor's bit patterns
    summed as integers on its device, the sums weighted by position."""
    sums = [t.detach().reshape(-1).view(_BITS[t.element_size()]).sum(dtype=torch.int64)
            for t in module.parameters()]
    weights = torch.arange(1, len(sums) + 1, dtype=torch.int64, device=sums[0].device)
    total = int((torch.stack(sums) * weights).sum()) if sums else 0
    return hashlib.sha256(str((len(sums), total)).encode()).hexdigest()[:16]


def replicas_agree(module: torch.nn.Module) -> str:
    """``parameter_checksum`` of ``module``, the same on every rank; raises
    when the ranks' parameters differ."""
    sums = all_gather_object(parameter_checksum(module))
    if len(set(sums)) > 1:
        raise RuntimeError(f"the ranks' parameters differ: checksums {sums}")
    return sums[0]
