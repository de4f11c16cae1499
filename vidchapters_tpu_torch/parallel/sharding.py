"""Sharding rules over the ``(data, model)`` grid, and the collectives of
data-parallel training.

Counterpart of ``vidchapters_tpu/parallel/sharding.py``. In JAX each leaf
carries a ``NamedSharding`` and XLA sums the gradient over the data axis and
places the model axis's collectives; here the train step calls these
functions itself.

The model axis: ``_RULES`` is the Megatron layout of JAX's (:27-48 there)
over the port's parameter names. Each rule gives the JAX ``PartitionSpec``
of the leaf's counterpart (``infer_param_specs``, as tuples) and where the
port's tensor is cut: JAX's Dense kernel is ``[in, out]``, the port's
``nn.Linear`` weight ``[out, in]``, so a kernel sharded on its output axis
is a weight sharded on axis 0, and the other way. Two departures:

- ViT ``attn.qkv`` (weight and bias) is ``P(None, "model")`` /
  ``P("model",)`` there over the packed ``[q | k | v]`` axis, where GSPMD
  reshards the contiguous halves (``models/vit.py:32-34`` there); the
  port's shard holds the rank's heads of each of q, k and v (the axis is
  cut in three parts, each cut alike), so attention needs no reshard.
- ``scan_layers`` and ``fused_qkv`` are not ported, so the rules for
  ``blocks/`` stacks and the packed ``qkv`` / ``kv`` T5 kernels (:31-34,
  :57-61 there) have no leaf here and are not carried.

``shard_params`` keeps this rank's slice of every sharded parameter (and
sets the modules' ``mp``); ``gather_params`` returns the whole state dict,
for checkpoints, the eval and the tests. Gradient reductions:

- ``reduce_model_gradients``: over the model group, the gradient of each
  whole parameter whose use is split (the relative-position tables, each
  rank using its heads' columns; the encoder's RMSNorms under sequence
  parallelism, each rank normalising its rows);
- ``all_reduce_gradients``: every gradient over the data group, in one flat
  float32 bucket, after ``backward()`` and before ``optimizer.step()``.

The data axis (``host_local_to_global`` there, :101-112):
``broadcast_parameters`` makes every rank hold rank 0's weights;
``global_counts`` sums host integers (the target tokens or valid spans a
loss divides by) over the data group, on the host; ``sum_shares`` sums a
step's metrics over the data group (over all ranks they would count each
row ``mp`` times); ``replicas_agree`` checks, by a checksum of the
parameters' bits, that every rank holds the same weights. The loss of each
data rank is its share of the global batch's loss; summing the shares and
their gradients over the data group gives the global batch's. Outside a
process group every function is the identity; a group of one rank runs
each collective.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from vidchapters_tpu_torch.parallel import tensor_parallel as tp
from vidchapters_tpu_torch.runtime import mesh
from vidchapters_tpu_torch.runtime.collectives import all_gather_object
from vidchapters_tpu_torch.runtime.mesh import distributed

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module) -> None:
    """Copy the parameters and buffers of data rank 0 to every rank of this
    rank's data group, in place (at model axis 1: rank 0's to every rank).
    The ranks of a model group hold their own slices of one replica."""
    if not distributed():
        return
    src = mesh.model_rank()  # the global rank of (data 0, this model index)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=mesh.data_group())


def _sum_gradients(params: Sequence[torch.nn.Parameter], group) -> None:
    """Sum each parameter's ``.grad`` over ``group`` (None counts as zeros)
    in one float32 bucket; each ``.grad`` then holds the sum."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the data group (None counts as
    zeros) in one float32 bucket; each ``.grad`` then holds the sum."""
    if distributed():
        _sum_gradients(list(params), mesh.data_group())


def global_counts(counts: Sequence[int]) -> List[int]:
    """Each host integer summed over the data group, on the host."""
    if not distributed():
        return [int(c) for c in counts]
    t = torch.tensor([int(c) for c in counts], dtype=torch.int64)
    dist.all_reduce(t, group=mesh.data_host_group())
    return t.tolist()


def global_count(n: int) -> int:
    """``n`` summed over the data group."""
    return global_counts([n])[0]


def sum_shares(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d tensor of ``metrics`` summed over the data group, in one
    all-reduce: the data ranks' shares of a step's losses give the global
    ones."""
    if not distributed():
        return metrics
    names = list(metrics)
    summed = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(summed, group=mesh.data_group())
    return dict(zip(names, summed.unbind()))


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

# (regexp over the port's names, JAX's PartitionSpec of the counterpart, the
# port's cut: (axis, parts)) -- first match wins
_RULES: Tuple[Tuple[str, tuple, Tuple[int, int]], ...] = (
    # T5 attention: q / k / v by heads (columns), o by rows
    (r".*(self_attn|cross_attn)\.(q|k|v)\.weight", (None, "model"), (0, 1)),
    (r".*(self_attn|cross_attn)\.o\.weight", ("model", None), (1, 1)),
    # T5 FFN
    (r".*ff\.wi(_0|_1)?\.weight", (None, "model"), (0, 1)),
    (r".*ff\.wo\.weight", ("model", None), (1, 1)),
    # embeddings / heads: vocabulary rows
    (r".*shared\.weight", ("model", None), (0, 1)),
    (r".*lm_head\.weight", (None, "model"), (0, 1)),
    # temporal ViT: qkv by heads within each of q, k, v (see above)
    (r".*attn\.qkv\.weight", (None, "model"), (0, 3)),
    (r".*attn\.qkv\.bias", ("model",), (0, 3)),
    (r".*attn\.proj\.weight", ("model", None), (1, 1)),
    (r".*fc1\.weight", (None, "model"), (0, 1)),
    (r".*fc1\.bias", ("model",), (0, 1)),
    (r".*fc2\.weight", ("model", None), (1, 1)),
)

# whole parameters whose gradient each model rank holds a part of: always
# (the relative-position tables), and under sequence parallelism (the
# encoder's norms)
_PARTIAL = r".*rel_bias\.rel_embedding"
_PARTIAL_SP = r"(.*\.)?encoder\.(blocks\.\d+\.\w+_norm|final_norm)\.weight"


def _rule(name: str, ndim: int):
    for pattern, spec, cut in _RULES:
        if re.fullmatch(pattern, name) and len(spec) <= ndim:
            return spec, cut
    return None


def _spec_for(name: str, ndim: int, model_parallel: bool) -> tuple:
    """JAX's ``PartitionSpec`` (as a tuple) of the counterpart of the port's
    parameter ``name``; ``()`` (replicated) without the model axis."""
    rule = _rule(name, ndim) if model_parallel else None
    return rule[0] if rule else ()


def infer_param_specs(model: nn.Module, model_parallel: bool = False) -> Dict[str, tuple]:
    """``{name: spec}`` over ``model``'s parameters, their full shapes."""
    return {name: _spec_for(name, len(full_shape(p)), model_parallel)
            for name, p in model.named_parameters()}


def full_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole of ``p`` (``p``'s own when not sharded)."""
    cut = getattr(p, "model_cut", None)
    if cut is None:
        return tuple(p.shape)
    shape = list(p.shape)
    shape[cut[0]] *= cut[2]
    return tuple(shape)


def _split_axis(t: torch.Tensor, axis: int, parts: int) -> torch.Tensor:
    shape = list(t.shape)
    return t.reshape(shape[:axis] + [parts, shape[axis] // parts] + shape[axis + 1:])


def cut(t: torch.Tensor, axis: int, parts: int, mp: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of the whole ``t`` over ``mp`` ranks: ``axis``
    is ``parts`` runs laid end to end, and each run is cut alike."""
    n = t.shape[axis]
    if n % (parts * mp):
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split in {parts} x {mp}")
    k = n // parts // mp
    piece = _split_axis(t, axis, parts).narrow(axis + 1, index * k, k)
    shape = list(t.shape)
    shape[axis] = parts * k
    return piece.reshape(shape)


def _gather(t: torch.Tensor, axis: int, parts: int) -> torch.Tensor:
    """The whole tensor from the model group's slices (``cut``'s inverse)."""
    whole = tp.all_gather(_split_axis(t, axis, parts), axis + 1)
    shape = list(t.shape)
    shape[axis] *= mesh.model_size()
    return whole.reshape(shape)


def is_sharded(model: nn.Module) -> bool:
    """Whether ``shard_params`` cut ``model`` over a model axis above 1."""
    return getattr(model, "mp", 1) > 1


@torch.no_grad()
def shard_params(model: nn.Module, mp: Optional[int] = None,
                 index: Optional[int] = None) -> nn.Module:
    """Keep this rank's slice of every parameter a rule shards (in place:
    the same ``Parameter`` objects, so build the optimizer after), mark it
    ``model_cut = (axis, parts, mp)``, and set ``mp`` on every module that
    has one. ``mp`` / ``index``: the model axis and this rank's place on it
    (``runtime/mesh``'s by default). The identity at ``mp`` 1."""
    mp = mesh.model_size() if mp is None else mp
    index = mesh.model_rank() if index is None else index
    if mp <= 1:
        return model
    if is_sharded(model):
        raise ValueError("the model is sharded already")
    for name, p in model.named_parameters():
        rule = _rule(name, p.dim())
        if rule is not None:
            axis, parts = rule[1]
            p.data = cut(p.data, axis, parts, mp, index).clone()
            p.model_cut = (axis, parts, mp)
    for m in model.modules():
        if hasattr(type(m), "mp"):
            m.mp = mp
    return model


@torch.no_grad()
def gather_tensors(model: nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Whole versions of ``tensors``, laid out as ``model.parameters()``
    (the parameters themselves, or the optimizer's moments): the sharded
    ones gathered over the model group, the others as they are. Every rank
    of the group calls it."""
    return [_gather(t, *p.model_cut[:2]) if getattr(p, "model_cut", None) else t
            for p, t in zip(model.parameters(), tensors)]


def cut_tensors(model: nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's slices of whole ``tensors`` laid out as
    ``model.parameters()`` (``gather_tensors``' inverse)."""
    r = mesh.model_rank()
    return [cut(t, p.model_cut[0], p.model_cut[1], p.model_cut[2], r)
            if getattr(p, "model_cut", None) else t
            for p, t in zip(model.parameters(), tensors)]


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded ``model`` (its own state dict when
    it is not sharded): what one process holds, in the port's names."""
    if not is_sharded(model):
        return model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    whole = gather_tensors(model, [p.detach() for p in model.parameters()])
    return dict(zip(names, whole))


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state dict (one process's, a checkpoint's) into
    ``model``, cutting this rank's slices when it is sharded."""
    if not is_sharded(model):
        model.load_state_dict(state)
        return
    names = [n for n, _ in model.named_parameters()]
    missing = sorted(set(names) ^ set(state))
    if missing:
        raise ValueError(f"load_full_state_dict: names that do not match: {missing}")
    for p, t in zip(model.parameters(), cut_tensors(model, [state[n] for n in names])):
        p.copy_(t)


def partial_gradient_parameters(model: nn.Module) -> List[torch.nn.Parameter]:
    """The whole parameters of a sharded ``model`` whose gradient each model
    rank holds a part of (``_PARTIAL``; ``_PARTIAL_SP`` under
    ``models/t5.SEQUENCE_PARALLEL``)."""
    from vidchapters_tpu_torch.models import t5

    patterns = [_PARTIAL] + ([_PARTIAL_SP] if t5.SEQUENCE_PARALLEL else [])
    return [p for name, p in model.named_parameters()
            if any(re.fullmatch(pat, name) for pat in patterns)]


@torch.no_grad()
def reduce_model_gradients(model: nn.Module) -> None:
    """Sum the gradients of ``partial_gradient_parameters`` over the model
    group, in one float32 bucket (after ``backward()``)."""
    if is_sharded(model):
        _sum_gradients(partial_gradient_parameters(model), mesh.model_group())


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
