"""Read an HF checkpoint directory without ``transformers`` or ``safetensors``.

Every loader of the port that takes an HF directory (BLIP-2, LLaMA, the
BERT speech tower, the toxicity classifier) reads it here:

- ``load_hf_config``: ``config.json`` as a dict;
- ``load_hf_state_dict``: the weights, from the first of
  ``model.safetensors.index.json`` (its shards), ``model.safetensors``,
  ``pytorch_model.bin.index.json`` (its shards) and ``pytorch_model.bin``
  that the directory holds, the order in which ``from_pretrained`` looks;
- ``meta_build``: the context to build a model in before its weights are
  loaded with ``load_state_dict(..., assign=True)``;
- ``resolve_hf_dir``: a directory, or a hub name (``openai/whisper-large-v2``)
  found offline in the HF hub cache as ``from_pretrained`` finds it:
  ``models--openai--whisper-large-v2/refs/main`` names the snapshot under
  ``snapshots/``; the cache is ``hf_hub_cache()``;
- ``read_safetensors``: one ``.safetensors`` file. The format is an 8-byte
  little-endian header length, a JSON header naming each tensor's dtype,
  shape and byte range, then the raw little-endian data, which
  ``torch.frombuffer`` turns into tensors. A dtype the reader does not know
  raises and names the tensor.

The JAX package's loaders read the same files through
``transformers.from_pretrained``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import struct
from pathlib import Path
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode

SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                      "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                      "BOOL": torch.bool}


class _SkipInit(TorchFunctionMode):
    """``torch.nn.init``'s functions return their tensor untouched."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else kwargs["tensor"]
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def meta_build():
    """``torch.device("meta")`` with ``torch.nn.init``'s functions made
    no-ops: a module built in it has its parameters' shapes and dtypes and
    no values, as under ``torch.device("meta")`` alone, but its
    constructors' random inits do not run. On a meta tensor they run
    PyTorch's Python reference kernels, whose first call in a process
    imports ``torch._dynamo`` (12.7-12.9 s of a cold ``demo_asr`` load on
    an NVIDIA H100 80GB HBM3 machine, 700.00 W)."""
    with torch.device("meta"), _SkipInit():
        yield


def hf_hub_cache() -> Path:
    """The HF hub cache, in ``huggingface_hub``'s order: ``$HF_HUB_CACHE``,
    else ``$HUGGINGFACE_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``."""
    env = os.environ.get
    home = env("HF_HOME") or os.path.join(env("XDG_CACHE_HOME") or "~/.cache", "huggingface")
    cache = env("HF_HUB_CACHE") or env("HUGGINGFACE_HUB_CACHE") or os.path.join(home, "hub")
    return Path(os.path.expandvars(os.path.expanduser(cache)))


def resolve_hf_dir(name_or_path: str) -> str:
    """The checkpoint directory of ``name_or_path``: itself when it is a
    directory, else the snapshot of the hub name that ``refs/main`` names
    in the HF hub cache. Nothing is downloaded: a name that is not there
    raises, naming every path looked in."""
    path = Path(name_or_path).expanduser()
    if path.is_dir():
        return str(path)
    repo = hf_hub_cache() / ("models--" + name_or_path.replace("/", "--"))
    ref = repo / "refs" / "main"
    looked = [str(path), str(ref)]
    if ref.is_file():
        snapshot = repo / "snapshots" / ref.read_text().strip()
        looked.append(str(snapshot))
        if snapshot.is_dir():
            return str(snapshot)
    raise FileNotFoundError(f"{name_or_path!r} is not a directory nor in the HF hub cache "
                            f"(nothing is downloaded); looked in: {', '.join(looked)}")


def load_hf_config(model_dir: str) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, on the CPU (they share one
    buffer holding the file)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {len(head)} bytes, no safetensors header")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}, which the "
                             f"reader does not know ({sorted(SAFETENSORS_DTYPES)})")
        shape = tuple(meta["shape"])
        start, end = meta["data_offsets"]
        numel = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} spans bytes [{start}, {end}), not "
                             f"{numel} x {itemsize} inside the file's {len(data)}")
        out[name] = (torch.frombuffer(data, dtype=dtype, count=numel, offset=start)
                     .reshape(shape) if numel else torch.empty(shape, dtype=dtype))
    return out


def _shards(root: Path, index: str):
    return sorted(set(json.loads((root / index).read_text())["weight_map"].values()))


def load_hf_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory, on the CPU in its
    stored dtypes: safetensors (one file or the shards of its index) before
    ``pytorch_model.bin`` (one file or its shards, read by ``torch.load``
    with ``weights_only``). A directory with none of them raises, naming
    what it looked for."""
    root = Path(model_dir)
    if (root / "model.safetensors.index.json").exists():
        files, read = _shards(root, "model.safetensors.index.json"), read_safetensors
    elif (root / "model.safetensors").exists():
        files, read = ["model.safetensors"], read_safetensors
    elif (root / "pytorch_model.bin.index.json").exists():
        files, read = _shards(root, "pytorch_model.bin.index.json"), None
    elif (root / "pytorch_model.bin").exists():
        files, read = ["pytorch_model.bin"], None
    else:
        raise FileNotFoundError(
            f"{model_dir}: no pytorch_model.bin(.index.json) and no "
            "model.safetensors(.index.json)")
    read = read or (lambda p: torch.load(p, map_location="cpu", weights_only=True))
    sd: Dict[str, torch.Tensor] = {}
    for name in files:
        sd.update(read(root / name))
    return sd
