"""Build the host-side C++ libraries under ``native/`` with g++.

Each ``native/<name>.cpp`` exposes a plain C interface and is compiled at
first use into ``build/vidchapters_tpu_torch/`` beside the package (a
directory that ``.gitignore`` lists), under a file name that carries the
hash of its source and flags, so a library already built is reused as it
is. A build writes a temporary file and renames it, so processes that build
at once never load half a library. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vidchapters_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def library(name: str) -> Path:
    """The library of ``native/<name>.cpp``, built now when it is not yet.
    Raises when g++ is absent or fails."""
    src = NATIVE / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be built") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out
