"""Processes, ranks and each rank's device: data parallelism over processes.

Counterpart of ``vidchapters_tpu/runtime/mesh.py:23-70``. One process (a
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

Only the data axis is ported. Megatron tensor parallelism and encoder
sequence parallelism (``runtime/mesh.py:73-110`` and the ``_RULES`` of
``parallel/sharding.py`` there) are the next slice (ROADMAP.md).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import MeshConfig

DEFAULT_TIMEOUT_S = 1800.0  # a collective that waits longer raises

_host_group = None  # the gloo group of host values; None: the default group


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


def create_mesh(cfg: MeshConfig = MeshConfig()) -> Tuple[int, int]:
    """``(data, model)`` axis sizes over the ranks. Only the data axis is
    ported: a model axis above 1 raises."""
    if cfg.model_parallel_size > 1:
        raise NotImplementedError(
            f"model_parallel_size={cfg.model_parallel_size}: tensor and sequence parallelism "
            f"are not ported yet (the next slice, ROADMAP.md §1 item 9); the port runs data "
            f"parallelism only")
    return cfg.axis_shapes(world_size())


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _host_group
    if distributed():
        dist.destroy_process_group()
    _host_group = None
