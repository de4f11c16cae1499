"""The JAX package's checkpoints, read with numpy.

``vidchapters_tpu/runtime/checkpoint.CheckpointManager`` saves a tuple
(``(params,)``, or ``(params, opt_state, step)`` from ``dvc_main``) as an
orbax directory, or without orbax as one flat npz (its checkpoint.py:95-98):
each leaf under ``"/".join(str(k) for k in keypath)``, so ``[0]`` is a
sequence index, ``['t5']`` a dict key and ``.mu`` an attribute (optax's
states). The port reads that npz form; ``convert_jax_checkpoint.py`` at the
repo root writes it from an orbax save directory, where JAX and orbax are
installed. The parameters are the ``[0]`` subtree, as the JAX package's
``restore_params`` takes element 0; ``models/weights.from_jax_params`` and
``pdvc_from_jax_params`` turn them into a state dict.
"""

from __future__ import annotations

import ast
import re
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# one key-path entry: [index], ['dict key'] / ["dict key"], .attribute
_ENTRY = re.compile(r"\[(-?\d+|'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")\]|\.([A-Za-z_]\w*)")


def parse_key(key: str) -> Tuple[Any, ...]:
    """The entries of one npz key: ints (sequence indices), strs (dict keys)
    and ``("attr", name)`` pairs (attributes). Raises naming the key when it
    is not of that form."""
    out, pos = [], 0
    while True:
        m = _ENTRY.match(key, pos)
        if m is None:
            raise ValueError(f"cannot parse JAX checkpoint key {key!r} at {key[pos:]!r}")
        out.append(("attr", m.group(2)) if m.group(2) else ast.literal_eval(m.group(1)))
        pos = m.end()
        if pos == len(key):
            return tuple(out)
        if key[pos] != "/":
            raise ValueError(f"cannot parse JAX checkpoint key {key!r} at {key[pos:]!r}")
        pos += 1


def read_params(path: "str | Path") -> Dict[str, Any]:
    """The params of a JAX npz checkpoint: the ``[0]`` subtree as nested
    dicts of numpy arrays. Every key must parse; the rest of the tuple
    (moments, step) is dropped. Raises when a params leaf is not under dict
    keys alone, or when there is no ``[0]`` subtree."""
    params: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            entries = parse_key(key)
            if entries[0] != 0:
                continue
            names = entries[1:]
            if not names or not all(isinstance(n, str) for n in names):
                raise ValueError(f"{path}: JAX checkpoint key {key!r} is not a params leaf "
                                 f"under dict keys")
            node = params
            for name in names[:-1]:
                node = node.setdefault(name, {})
                if not isinstance(node, dict):
                    raise ValueError(f"{path}: {key!r} lies under a leaf")
            if names[-1] in node:
                raise ValueError(f"{path}: {key!r} holds a leaf and a subtree")
            node[names[-1]] = data[key]
    if not params:
        raise ValueError(f"{path} holds no [0] (params) subtree of a JAX checkpoint")
    return params


def is_jax_npz(path: "str | Path") -> bool:
    """Whether ``path`` is a file in numpy's npz form (a zip of ``.npy``)."""
    path = Path(path)
    return path.is_file() and path.suffix == ".npz" and zipfile.is_zipfile(path)


def find(directory: "str | Path", names: Sequence[str]) -> Tuple[str, Optional[Path]]:
    """The first of ``names`` that ``directory`` holds a checkpoint of, with
    its JAX npz (``{name}.npz``), or None for the port's own ``torch.save``
    file ``{name}``. Raises when the directory holds both forms of that
    name, when it holds only the JAX package's orbax directory of it
    (convert it first), and when it holds none of ``names``."""
    d = Path(directory)
    names = list(dict.fromkeys(names))
    for name in names:
        own, npz = d / name, d / f"{name}.npz"
        if npz.is_file():
            if own.is_file():
                raise ValueError(f"{d} holds '{name}' twice: the port's {own} and the JAX "
                                 f"package's {npz}")
            return name, npz
        if own.is_dir():
            raise ValueError(f"{own} is an orbax checkpoint of the JAX package: write its npz "
                             f"form with convert_jax_checkpoint.py")
        if own.is_file():
            return name, None
    raise FileNotFoundError(f"{d} holds neither " + " nor ".join(f"a '{n}'" for n in names)
                            + " checkpoint")
