"""ctypes binding for the native feature loader (``native/feature_loader.cpp``).

The port's own copy of ``vidchapters_tpu/data/native_loader.py``:
``NativeFeatureLoader`` reads ``.npy`` features with the subsample / pad
rule of ``data.features.subsample_or_pad`` and prefetches upcoming files
into an LRU cache on a thread pool, in place of the reference's DataLoader
worker processes. Host code; the library is built with g++ at first use
(``data/_native_build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from vidchapters_tpu_torch.data import _native_build

_handle = None
_lock = threading.Lock()


def _load_lib():
    """The bound library; builds it on the first call. Raises when it cannot
    be built."""
    global _handle
    with _lock:
        if _handle is None:
            lib = ctypes.CDLL(str(_native_build.library("feature_loader")))
            lib.fl_create.restype = ctypes.c_void_p
            lib.fl_create.argtypes = [ctypes.c_int, ctypes.c_long]
            lib.fl_destroy.argtypes = [ctypes.c_void_p]
            lib.fl_load.restype = ctypes.c_long
            lib.fl_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                    ctypes.c_long]
            lib.fl_shape.restype = ctypes.c_long
            lib.fl_shape.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_long)]
            lib.fl_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.fl_cache_entries.restype = ctypes.c_long
            lib.fl_cache_entries.argtypes = [ctypes.c_void_p]
            _handle = lib
    return _handle


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeFeatureLoader:
    def __init__(self, num_threads: int = 4, cache_bytes: int = 1 << 30):
        self._lib = _load_lib()
        self._h = self._lib.fl_create(num_threads, cache_bytes)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fl_destroy(self._h)
            self._h = None

    def shape(self, path: str):
        rows, cols = ctypes.c_long(), ctypes.c_long()
        if self._lib.fl_shape(self._h, path.encode(), ctypes.byref(rows),
                              ctypes.byref(cols)) != 0:
            raise IOError(f"cannot read npy: {path}")
        return int(rows.value), int(cols.value)

    def load(self, path: str, max_rows: int, dim: int) -> np.ndarray:
        """``[max_rows, dim]`` float32: the file's rows subsampled or padded."""
        out = np.zeros((max_rows, dim), np.float32)
        rc = self._lib.fl_load(self._h, path.encode(),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               max_rows, dim)
        if rc < 0:
            raise IOError(f"cannot load npy: {path} (dim mismatch?)")
        return out

    def prefetch(self, paths: Sequence[str] | str) -> None:
        if isinstance(paths, str):
            paths = [paths]
        for p in paths:
            self._lib.fl_prefetch(self._h, p.encode())

    def cache_entries(self) -> int:
        return int(self._lib.fl_cache_entries(self._h))
