"""Import the JAX package's parameters into the port's modules.

Both importers take the JAX parameter tree as nested dicts of numpy arrays
(``jax.device_get(params)``) and return a ``state_dict`` of the port's
model. Dense kernels ``[in, out]`` become ``nn.Linear`` weights
``[out, in]``, Flax ``Conv`` kernels ``[k, in, out]`` become ``Conv1d``
weights ``[out, in, k]``, and norm ``scale`` leaves become ``weight``. A leaf
the port has no place for, or a port parameter that no leaf fills, raises.

- ``from_jax_params``: Vid2Seq in its default unscanned layout
  (``block_{i}``, separate q/k/v); ``nn.Embed``'s ``embedding`` becomes
  ``weight``. The scanned (``blocks``) and packed (``fused_qkv``) layouts
  raise.
- ``pdvc_from_jax_params``: PDVC; the lists ``enc_{i}``, ``dec_{i}``,
  ``proj_{l}``, ``class_head_{i}``, ``count_head_{i}`` and ``bbox_head_{i}``
  map to ``enc_layers.{i}``, ``dec_layers.{i}``, ``proj.{l}``,
  ``class_heads.{i}``, ... The caption heads' explicit matrices
  (``embedding``, ``w_x``, ``logit_w``, ...) keep their names and their
  ``[in, out]`` orientation.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"^block_(\d+)$")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_PDVC_LISTS = re.compile(r"^(enc|dec|proj|class_head|count_head|bbox_head)_(\d+)$")
_PDVC_LIST_NAMES = {"enc": "enc_layers", "dec": "dec_layers", "proj": "proj",
                    "class_head": "class_heads", "count_head": "count_heads",
                    "bbox_head": "bbox_heads"}


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


def _pdvc_port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _PDVC_LISTS.match(p)
        parts += [_PDVC_LIST_NAMES[m.group(1)], m.group(2)] if m else [p]
    leaf = path[-1]
    return ".".join(parts + ["weight" if leaf in ("kernel", "scale") else leaf])


def _import(params: Mapping[str, Any], model: nn.Module, name_of: Callable[[tuple], str],
            what: str) -> Dict[str, torch.Tensor]:
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for path, arr in _flatten(params).items():
        name = name_of(path)
        if name not in target:
            leftover.append("/".join(path))
            continue
        if path[-1] == "kernel":
            if arr.ndim not in (2, 3):
                leftover.append("/".join(path))
                continue
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} does not "
                             f"fit {name} {tuple(target[name].shape)}")
        out[name] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(f"{what}: JAX leaves without a port parameter: "
                         f"{leftover}; port parameters without a JAX leaf: {missing}")
    return out


def from_jax_params(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX ``Vid2Seq`` params -> ``model``'s state_dict (float32 tensors on
    the CPU, shapes checked against ``model``)."""
    return _import(params, model, _port_name, "from_jax_params")


def pdvc_from_jax_params(params: Mapping[str, Any], model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``PDVC`` params (an ``init_all`` init or a checkpoint) ->
    ``model``'s state_dict."""
    return _import(params, model, _pdvc_port_name, "pdvc_from_jax_params")
