"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions that take raw device pointers, ints and a stream, launch, and
return ``cudaGetLastError()``). It is compiled at first use with ``nvcc``
into ``build/vidchapters_tpu_torch/`` beside the package (a directory that
``.gitignore`` lists) and loaded with ``ctypes``. A library whose file name
carries the hash of its sources and flags is reused as it is.

Nothing is compiled or loaded when this module is imported: the tests
import every module, also where there is no CUDA and no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vidchapters_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U32 = ctypes.c_uint32


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources(name: str) -> List[Path]:
    """The kernel's own source plus every shared header it may include."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together. Returns ``{name: compiler output}``
    (the ``-Xptxas -v`` lines: registers, shared memory, spills); a library
    that was already built reports ``"cached"``. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            logs[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


class CudaKernel:
    """One ``csrc/<name>.cu`` library with its C entry points and a count of
    the launches made through it.

    ``symbols`` maps each C function to its ``argtypes``; every function
    returns the ``cudaError_t`` of its launch as an int. ``launch`` raises
    when that is not 0 and adds one to ``launches`` when it is.
    """

    _lock = threading.Lock()

    def __init__(self, name: str, symbols: Dict[str, Sequence]):
        self.name = name
        self.symbols = dict(symbols)
        self.launches = 0
        self._lib = None

    def _load(self):
        with self._lock:
            if self._lib is None:
                build([self.name])
                lib = ctypes.CDLL(str(_lib_path(self.name)))
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args) -> None:
        rc = getattr(self._load(), symbol)(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}.{symbol} failed to launch: "
                f"cudaError_t {rc}")
        self.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


_COUNTERS: Dict[object, object] = {}


def arrival_counters(device, n: int):
    """``n`` int32 arrival counters on ``device`` that are 0, for kernels
    whose last block to arrive merges the others' results and sets its
    counter back to 0 (so no launch zeroes them, and a CUDA graph can replay
    the launch). One buffer per device, zeroed once and grown as needed;
    kernels on one stream may share it, since each leaves it 0 again.
    Kernels on two streams at once would not: the decode loops run on one."""
    import torch

    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def stream_ptr() -> int:
    """PyTorch's current CUDA stream as the integer ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream().cuda_stream
