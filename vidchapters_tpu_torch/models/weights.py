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
_LAYER = re.compile(r"^layer_(\d+)$")
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


def _whisper_port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _LAYER.match(p)
        parts += ["layers", m.group(1)] if m else [p]
    return ".".join(parts + [_RENAME.get(path[-1], path[-1])])


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


def whisper_from_jax_params(params: Mapping[str, Any], model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``Whisper`` params -> the port's ``Whisper`` ``model``'s
    state_dict."""
    return _import(params, model, _whisper_port_name, "whisper_from_jax_params")


_HF_LAYER = re.compile(r"^(encoder|decoder)\.layers\.(\d+)\.(.+)$")
_HF_SUBLAYER = {"self_attn.": "self_attn.", "encoder_attn.": "cross_attn.",
                "self_attn_layer_norm.": "self_attn_norm.",
                "encoder_attn_layer_norm.": "cross_attn_norm.",
                "final_layer_norm.": "ff_norm.", "fc1.": "fc1.", "fc2.": "fc2."}
_HF_PROJ = {"q_proj.": "q.", "k_proj.": "k.", "v_proj.": "v.", "out_proj.": "out."}
_HF_TOP = {"encoder.conv1.weight": "encoder.conv1.weight",
           "encoder.conv1.bias": "encoder.conv1.bias",
           "encoder.conv2.weight": "encoder.conv2.weight",
           "encoder.conv2.bias": "encoder.conv2.bias",
           "encoder.layer_norm.weight": "encoder.ln_post.weight",
           "encoder.layer_norm.bias": "encoder.ln_post.bias",
           "decoder.embed_tokens.weight": "decoder.embed_tokens.weight",
           "decoder.embed_positions.weight": "decoder.embed_positions",
           "decoder.layer_norm.weight": "decoder.ln.weight",
           "decoder.layer_norm.bias": "decoder.ln.bias"}


def _hf_port_name(name: str):
    if name in _HF_TOP:
        return _HF_TOP[name]
    m = _HF_LAYER.match(name)
    if m is None:
        return None
    side, i, rest = m.groups()
    for hf, port in _HF_SUBLAYER.items():
        if rest.startswith(hf):
            rest = port + rest[len(hf):]
            if port.endswith("attn."):
                head, tail = rest.split(".", 1)
                for hp, pp in _HF_PROJ.items():
                    if tail.startswith(hp):
                        return f"{side}.layers.{i}.{head}.{pp}{tail[len(hp):]}"
                return None
            return f"{side}.layers.{i}.{rest}"
    return None


def whisper_from_hf_state_dict(sd: Mapping[str, Any], model: nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """HF ``WhisperForConditionalGeneration`` state dict (``model.`` prefix
    optional) -> the port's ``Whisper`` ``model``'s state_dict. torch's
    ``[out, in]`` and ``[out, in, k]`` layouts are the port's own, so no
    leaf is transposed."""
    if any(k.startswith("model.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    arr = {k: np.asarray(v.detach().cpu().float() if isinstance(v, torch.Tensor) else v,
                         dtype=np.float32) for k, v in sd.items()}
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for name, a in arr.items():
        if name == "encoder.embed_positions.weight":
            ref = model.encoder.positions.cpu().numpy()
            if a.shape != ref.shape or not np.allclose(a, ref, atol=1e-4):
                raise ValueError("whisper_from_hf_state_dict: encoder.embed_positions "
                                 "differ from Whisper's sinusoids")
            continue
        if name == "proj_out.weight":
            if not np.array_equal(a, arr.get("decoder.embed_tokens.weight")):
                raise ValueError("whisper_from_hf_state_dict: proj_out is not tied to "
                                 "decoder.embed_tokens")
            continue
        port = _hf_port_name(name)
        if port is None or port not in target:
            leftover.append(name)
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if tuple(t.shape) != tuple(target[port].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit {port} "
                             f"{tuple(target[port].shape)}")
        out[port] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(f"whisper_from_hf_state_dict: HF names without a port parameter: "
                         f"{leftover}; port parameters without an HF name: {missing}")
    return out
