"""Processes, ranks and each rank's device; the ``(data, model)`` grid.

Counterpart of ``vidchapters_tpu/runtime/mesh.py``. One process (a
rank) plays one JAX process holding one device; the ranks meet through
``torch.distributed``:

- NCCL for ranks on CUDA, one card a rank (``cuda:{rank % device_count}``,
  which holds for ranks laid out host by host over several hosts);
- gloo for ranks on the CPU, and on CUDA only where the caller names it, for
  ranks that share a card (NCCL does not put two ranks on one device).

Host values (pickled objects, token counts, barriers) go through a gloo
group on the host, so that reading them never waits for the card; tensors
go through the default group. ``maybe_initialize_distributed`` reads the
JAX package's own variables: ``VIDCHAPTERS_NUM_PROCESSES``,
``VIDCHAPTERS_PROCESS_ID`` and ``VIDCHAPTERS_COORDINATOR`` (``host:port``).
Nothing falls back quietly: a missing card or a failed rendezvous raises,
and NCCL itself refuses two ranks on one card.

``create_mesh`` lays the ranks out on a ``(data, model)`` grid, rank ``r``
at ``(r // mp, r % mp)`` as ``np.asarray(devices).reshape(dp, mp)`` there
(:46-56), and builds one process group per row (a model group: the ranks of
one data index) and per column (a data group: the ranks of one model
index). Gradients are summed over the data group; the model group carries
the tensor-parallel collectives (``parallel/tensor_parallel.py``).
``enable_sequence_parallelism`` (:73-110 there) shards the T5 encoder's
residual stream over the model axis.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import MeshConfig, Vid2SeqConfig

DEFAULT_TIMEOUT_S = 1800.0  # a collective that waits longer raises

_host_group = None  # the gloo group of host values; None: the default group


class _Grid:
    """This rank's place on the ``(data, model)`` grid and its groups (None:
    every rank, through the default group, or the host group for host
    values). Before ``create_mesh`` the grid is ``(world, 1)``."""

    def __init__(self, dp: int = 1, mp: int = 1, rank: int = 0):
        self.dp, self.mp = dp, mp
        self.data_rank, self.model_rank = divmod(rank, mp)
        self.data = self.model = self.data_host = None


_grid = _Grid()


def maybe_initialize_distributed(device: "str | torch.device | None" = None,
                                 backend: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 coordinator: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group when more than one process runs, or when the
    caller names the backend (a group of one rank, which runs the
    data-parallel path whole); returns whether it did. ``device``: where the
    ranks run (CUDA unless the caller asks for the CPU). ``backend``:
    ``nccl`` (the default on CUDA) or ``gloo`` (the default on the CPU, and
    the one that lets ranks share a card). The other arguments default to
    the ``VIDCHAPTERS_*`` variables."""
    global _host_group
    if num_processes is None:
        num_processes = int(os.environ.get("VIDCHAPTERS_NUM_PROCESSES", "1"))
    if num_processes <= 1 and backend is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if process_id is None:
        process_id = int(os.environ.get("VIDCHAPTERS_PROCESS_ID", "0"))
    coordinator = coordinator or os.environ.get("VIDCHAPTERS_COORDINATOR", "localhost:9876")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs CUDA devices; ranks on the CPU take gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    _host_group = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
    return True


def distributed() -> bool:
    """Whether this process is in a process group (of one rank or more)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def is_main_process() -> bool:
    """Rank 0 (util/dist.py:190-199): the one that writes files."""
    return rank() == 0


def host_group():
    """The process group of host values (gloo)."""
    return _host_group


def barrier() -> None:
    """Wait for every rank (on the host); nothing outside a process group."""
    if distributed():
        dist.barrier(group=_host_group)


def rank_device(device: "str | torch.device | None" = None) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for CUDA (unless
    the caller names an index), the CPU when asked for. Raises when CUDA
    is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def create_mesh(cfg: MeshConfig = MeshConfig(), model: "Vid2SeqConfig | None" = None
                ) -> Tuple[int, int]:
    """``(data, model)`` axis sizes over the ranks, and this rank's groups.
    Raises when the world does not tile the grid (a model axis above 1
    needs as many ranks at least), or when the model axis does not divide a
    width of ``model`` (``MeshConfig.check_widths``). Every rank calls it,
    with the same grid: each group is made by every rank, in one order."""
    global _grid
    world = world_size()
    dp, mp = cfg.axis_shapes(world)
    if model is not None:
        cfg.check_widths(model)
    grid = _Grid(dp, mp, rank())
    if mp > 1:
        timeout = timedelta(seconds=DEFAULT_TIMEOUT_S)
        for i in range(dp):  # the model groups: one data index each
            g = dist.new_group(list(range(i * mp, (i + 1) * mp)), timeout=timeout)
            if i == grid.data_rank:
                grid.model = g
        for j in range(mp):  # the data groups: one model index each
            ranks = list(range(j, world, mp))
            g = dist.new_group(ranks, timeout=timeout)
            h = (dist.new_group(ranks, backend="gloo", timeout=timeout)
                 if _host_group is not None else g)
            if j == grid.model_rank:
                grid.data, grid.data_host = g, h
    _grid = grid
    return dp, mp


def data_size() -> int:
    """Ranks on the data axis (the replicas of one model shard)."""
    return _grid.dp if _grid.mp > 1 else world_size()


def model_size() -> int:
    """Ranks on the model axis (the shards of one replica)."""
    return _grid.mp


def data_rank() -> int:
    """This rank's index on the data axis: which rows of the global batch."""
    return _grid.data_rank if _grid.mp > 1 else rank()


def model_rank() -> int:
    """This rank's index on the model axis: which shard of each weight."""
    return _grid.model_rank


def data_group():
    """The ranks of this rank's model index (gradients sum over them)."""
    return _grid.data


def data_host_group():
    """The data group for host values (gloo)."""
    return _grid.data_host if _grid.data_host is not None else _host_group


def model_group():
    """The ranks of this rank's data index (the tensor-parallel collectives)."""
    return _grid.model


def enable_sequence_parallelism(shape: Tuple[int, int]) -> bool:
    """Shard the T5 encoder's residual stream over the model axis between
    blocks (Megatron-SP, ``models/t5.SEQUENCE_PARALLEL``): its norms,
    dropouts and residual adds run on the rank's rows, each block gathers
    the rows into attention and the feed-forward and reduce-scatters their
    outputs. ``shape``: ``create_mesh``'s ``(data, model)``. The decoder is
    never sharded so, as there. False (and nothing set) when the model axis
    is 1."""
    if shape[1] <= 1:
        return False
    from vidchapters_tpu_torch.models import t5

    t5.SEQUENCE_PARALLEL = True
    return True


def disable_sequence_parallelism() -> None:
    """Clear ``models/t5.SEQUENCE_PARALLEL``."""
    from vidchapters_tpu_torch.models import t5

    t5.SEQUENCE_PARALLEL = False


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _host_group, _grid
    if distributed():
        dist.destroy_process_group()
    _host_group = None
    _grid = _Grid()
