"""Import the reference's released PyTorch checkpoints into the port's Vid2Seq.

The port's own copy of ``vidchapters_tpu/models/torch_import.py``. The
reference ships ``{model, optimizer, epoch, args}`` files (dvc.py:406-441)
whose ``model`` holds HF T5 names under ``t5_model.`` and the reference
ViT's under ``visual_encoder.``. ``convert_*`` map those names onto the JAX
package's parameter tree (name -> numpy), which ``models/weights.
from_jax_params`` then places on the port's modules, raising on any leaf it
cannot place and on any parameter left empty. The reference's quirks stay:

- the relative-position bias comes from block 0 of each stack only;
- ``lm_head`` is kept only where it differs from ``shared`` (an untied
  head), and raises where the port's model is tied;
- the ViT's qkv bias and ``proj_v2t`` are optional;
- DDP ``module.`` prefixes are stripped.

On top of the JAX converter, ``convert_vid2seq_state_dict`` raises on a
name it reads nothing from (the HF tied copies ``encoder.embed_tokens`` /
``decoder.embed_tokens`` pass when they equal ``shared``). There is no
vocab surgery: a ``shared.weight`` whose rows differ from the model's
``vocab_size`` raises with both shapes. The scanned and fused-qkv layouts of
the JAX package are not ported.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from vidchapters_tpu_torch.models.weights import from_jax_params

Params = Dict[str, Any]
_TIED_COPIES = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight")


def _t(x: np.ndarray) -> np.ndarray:
    """torch Linear stores [out, in]; the JAX tree's Dense kernel is [in, out]."""
    return np.ascontiguousarray(x.T)


def _set(tree: Params, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.asarray(value, dtype=np.float32)


class _Reader(Mapping):
    """A state dict that remembers which names were read, and names the
    one that is missing."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd, self.read = sd, set()

    def __getitem__(self, key):
        if key not in self.sd:
            raise KeyError(f"the reference checkpoint has no {key!r}")
        self.read.add(key)
        return self.sd[key]

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)

    def __contains__(self, key):
        return key in self.sd


def convert_t5_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "",
                          gated: bool = False) -> Params:
    """HF ``T5ForConditionalGeneration`` state_dict -> the T5 parameter tree."""
    p: Params = {}
    g = lambda k: np.asarray(sd[prefix + k])

    _set(p, "shared/embedding", g("shared.weight"))
    for stack in ("encoder", "decoder"):
        i = 0
        while f"{prefix}{stack}.block.{i}.layer.0.SelfAttention.q.weight" in sd:
            base = f"{stack}.block.{i}.layer.0"
            blk = f"{stack}/block_{i}"
            for w in ("q", "k", "v", "o"):
                _set(p, f"{blk}/self_attn/{w}/kernel", _t(g(f"{base}.SelfAttention.{w}.weight")))
            _set(p, f"{blk}/self_attn_norm/weight", g(f"{base}.layer_norm.weight"))
            if stack == "decoder":
                base_x = f"{stack}.block.{i}.layer.1"
                for w in ("q", "k", "v", "o"):
                    _set(p, f"{blk}/cross_attn/{w}/kernel",
                         _t(g(f"{base_x}.EncDecAttention.{w}.weight")))
                _set(p, f"{blk}/cross_attn_norm/weight", g(f"{base_x}.layer_norm.weight"))
                ff_idx = 2
            else:
                ff_idx = 1
            base_f = f"{stack}.block.{i}.layer.{ff_idx}"
            if gated:
                _set(p, f"{blk}/ff/wi_0/kernel", _t(g(f"{base_f}.DenseReluDense.wi_0.weight")))
                _set(p, f"{blk}/ff/wi_1/kernel", _t(g(f"{base_f}.DenseReluDense.wi_1.weight")))
            else:
                _set(p, f"{blk}/ff/wi/kernel", _t(g(f"{base_f}.DenseReluDense.wi.weight")))
            _set(p, f"{blk}/ff/wo/kernel", _t(g(f"{base_f}.DenseReluDense.wo.weight")))
            _set(p, f"{blk}/ff_norm/weight", g(f"{base_f}.layer_norm.weight"))
            i += 1
        _set(p, f"{stack}/final_norm/weight", g(f"{stack}.final_layer_norm.weight"))
        # the bias table of block 0 serves every layer (HF stores no other)
        _set(p, f"{stack}/rel_bias/rel_embedding",
             g(f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"))
    if prefix + "lm_head.weight" in sd:
        lm = g("lm_head.weight")
        if not np.array_equal(lm, g("shared.weight")):
            _set(p, "lm_head/kernel", _t(lm))
    return p


def convert_vit_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "") -> Params:
    """Reference ``VisionTransformer`` state_dict (model/vit.py) -> its tree."""
    p: Params = {}
    g = lambda k: np.asarray(sd[prefix + k])
    _set(p, "pos_embed", g("pos_embed"))
    i = 0
    while f"{prefix}blocks.{i}.norm1.weight" in sd:
        blk = f"block_{i}"
        _set(p, f"{blk}/norm1/scale", g(f"blocks.{i}.norm1.weight"))
        _set(p, f"{blk}/norm1/bias", g(f"blocks.{i}.norm1.bias"))
        _set(p, f"{blk}/attn/qkv/kernel", _t(g(f"blocks.{i}.attn.qkv.weight")))
        if f"{prefix}blocks.{i}.attn.qkv.bias" in sd:
            _set(p, f"{blk}/attn/qkv/bias", g(f"blocks.{i}.attn.qkv.bias"))
        _set(p, f"{blk}/attn/proj/kernel", _t(g(f"blocks.{i}.attn.proj.weight")))
        _set(p, f"{blk}/attn/proj/bias", g(f"blocks.{i}.attn.proj.bias"))
        _set(p, f"{blk}/norm2/scale", g(f"blocks.{i}.norm2.weight"))
        _set(p, f"{blk}/norm2/bias", g(f"blocks.{i}.norm2.bias"))
        _set(p, f"{blk}/fc1/kernel", _t(g(f"blocks.{i}.mlp.fc1.weight")))
        _set(p, f"{blk}/fc1/bias", g(f"blocks.{i}.mlp.fc1.bias"))
        _set(p, f"{blk}/fc2/kernel", _t(g(f"blocks.{i}.mlp.fc2.weight")))
        _set(p, f"{blk}/fc2/bias", g(f"blocks.{i}.mlp.fc2.bias"))
        i += 1
    _set(p, "norm/scale", g("norm.weight"))
    _set(p, "norm/bias", g("norm.bias"))
    return p


def convert_vid2seq_state_dict(sd: Mapping[str, np.ndarray], gated: bool = False) -> Params:
    """A whole reference Vid2Seq state_dict -> ``{"t5", "visual_encoder"[,
    "proj_v2t"]}``. Raises on a name that nothing reads."""
    reader = _Reader(sd)
    out: Params = {
        "t5": convert_t5_state_dict(reader, prefix="t5_model.", gated=gated),
        "visual_encoder": convert_vit_state_dict(reader, prefix="visual_encoder."),
    }
    if "proj_v2t.weight" in sd:
        out["proj_v2t"] = {"kernel": _t(np.asarray(reader["proj_v2t.weight"])),
                           "bias": np.asarray(reader["proj_v2t.bias"], dtype=np.float32)}
    shared = np.asarray(sd["t5_model.shared.weight"])
    for name in _TIED_COPIES:
        key = "t5_model." + name
        if key in sd and np.array_equal(np.asarray(sd[key]), shared):
            reader.read.add(key)
    unread = sorted(set(sd) - reader.read)
    if unread:
        raise ValueError(f"convert_vid2seq_state_dict: reference names without a port "
                         f"parameter: {unread}")
    return out


def load_payload(path: str) -> Any:
    """``torch.load`` of a checkpoint file on the CPU, tensors and plain data
    only (``weights_only``), with the reference's ``args`` Namespace allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def _is_reference(sd: Any) -> bool:
    """Whether ``sd`` holds the reference Vid2Seq's names (``t5_model.``)."""
    return isinstance(sd, Mapping) and any(
        isinstance(k, str) and k.removeprefix("module.").startswith("t5_model.") for k in sd)


def reference_state_dict(payload: Any) -> Dict[str, np.ndarray]:
    """The model weights of a reference payload (``{"model": ...}`` or a bare
    state_dict) as float32 numpy, ``module.`` prefixes stripped."""
    sd = payload.get("model", payload)
    return {k.removeprefix("module."): v.detach().cpu().float().numpy() for k, v in sd.items()}


def load_reference_weights(payload: Any, model: nn.Module) -> bool:
    """Load the weights of ``payload`` (a ``load_payload``) into ``model`` when
    it is a reference checkpoint and return True; return False, loading
    nothing, when it is not one."""
    inner = payload.get("model", payload) if isinstance(payload, Mapping) else None
    if not _is_reference(inner):
        return False
    model.load_state_dict(vid2seq_from_reference(reference_state_dict(payload), model))
    return True


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` file -> its model weights (``reference_state_dict``)."""
    return reference_state_dict(load_payload(path))


def vid2seq_from_reference(sd: Mapping[str, np.ndarray], model: nn.Module
                           ) -> Dict[str, torch.Tensor]:
    """A reference state_dict (``load_torch_checkpoint``) -> ``model``'s
    state_dict: float32 tensors on the CPU, every leaf checked against
    ``model``."""
    t5 = model.cfg.t5
    rows = np.asarray(sd["t5_model.shared.weight"]).shape
    if rows[0] != t5.vocab_size:
        raise ValueError(f"t5_model.shared.weight has shape {rows}, the model's vocabulary "
                         f"is ({t5.vocab_size}, {t5.d_model}); no vocab surgery is done")
    return from_jax_params(convert_vid2seq_state_dict(sd, gated=t5.is_gated_act), model)
