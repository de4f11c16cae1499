"""Import the JAX package's Vid2Seq parameters into the port's modules.

``from_jax_params`` takes the JAX parameter tree as nested dicts of numpy
arrays (``jax.device_get(params)``) in its default unscanned layout
(``block_{i}``, separate q/k/v) and returns a ``state_dict`` for the port's
``Vid2Seq``. Dense kernels ``[in, out]`` become ``nn.Linear`` weights
``[out, in]``; ``scale`` / ``embedding`` leaves become ``weight``. A leaf the
port has no place for, or a port parameter that no leaf fills, raises: the
scanned (``blocks``) and packed (``fused_qkv``) layouts are among those.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"^block_(\d+)$")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _BLOCK.match(p)
        parts += ["blocks", m.group(1)] if m else [p]
    return ".".join(parts + [_RENAME.get(path[-1], path[-1])])


def from_jax_params(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX ``Vid2Seq`` params -> ``model``'s state_dict (float32 tensors on
    the CPU, shapes checked against ``model``)."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for path, arr in _flatten(params).items():
        name = _port_name(path)
        if name not in target:
            leftover.append("/".join(path))
            continue
        if path[-1] == "kernel":
            if arr.ndim != 2:
                leftover.append("/".join(path))
                continue
            arr = arr.T
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} does not "
                             f"fit {name} {tuple(target[name].shape)}")
        out[name] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(f"from_jax_params: JAX leaves without a port parameter: "
                         f"{leftover}; port parameters without a JAX leaf: {missing}")
    return out
