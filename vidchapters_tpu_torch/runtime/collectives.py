"""Gathering across processes, for one process.

Counterpart of ``vidchapters_tpu/runtime/collectives.py`` (the reference's
pickled all-gather of eval results, util/dist.py:25-113). The port runs on
one GPU: the gather is the identity and the one process is the main one.
Data parallelism over more than one GPU is not ported (ROADMAP.md, DDP);
a process group of more than one process raises here rather than
evaluating only its own shard.
"""

from __future__ import annotations

from typing import Dict


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _require_one_process() -> None:
    if _world_size() > 1:
        raise NotImplementedError(
            "more than one process: data parallelism (DDP) is not ported yet (ROADMAP.md)")


def is_main_process() -> bool:
    _require_one_process()
    return True


def gather_results(results: Dict) -> Dict:
    """Merge the per-process prediction dicts (dvc.py:214-215): with one
    process, a copy of ``results``."""
    _require_one_process()
    return dict(results)
