"""Gathering and reducing host values across the ranks.

Counterpart of ``vidchapters_tpu/runtime/collectives.py:18-58`` (the
reference's pickled all-gather of eval results and its display-only loss
mean, util/dist.py:25-113). Objects travel pickled through the host group
of ``runtime/mesh.py`` (gloo), so no call here waits for the card. With one
process every function is the identity.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch.distributed as dist

from vidchapters_tpu_torch.runtime.mesh import host_group, world_size


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (one process: ``[obj]``)."""
    n = world_size()
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=host_group())
    return out


def gather_results(results: Dict) -> Dict:
    """Merge every rank's prediction dict, later ranks over earlier ones
    (the eval gather at dvc.py:214-215)."""
    merged: Dict = {}
    for part in all_gather_object(results):
        merged.update(part)
    return merged


def reduce_dict_mean(metrics: Dict[str, float]) -> Dict[str, float]:
    """Each scalar's mean over the ranks, as float32 (util/dist.py:89-113;
    the reference averages losses for display only)."""
    parts = all_gather_object({k: float(v) for k, v in metrics.items()})
    if len(parts) == 1:
        return dict(metrics)
    keys = sorted(metrics)
    table = np.array([[p[k] for k in keys] for p in parts], np.float32)
    return {k: float(v) for k, v in zip(keys, table.mean(0))}
