"""ctypes binding for the native unigram-SPM encoder (``native/spm_encoder.cpp``).

The port's own copy of ``vidchapters_tpu/data/native_spm.py``. The data
pipeline tokenizes every ASR transcript it reads (HowTo100M pretraining:
up to 1000 tokens of ASR per video, every step); the pure-Python Viterbi
of ``data/tokenizer.py`` is exact but slow, so
``SentencePieceUnigramTokenizer`` routes its Viterbi through this C++ twin
(the same ids: ``tests/test_torch_native_host.py``) when g++ can build it.
This is host code: no device is involved.

The library is built with g++ at first use (``data/_native_build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

from vidchapters_tpu_torch.data import _native_build

_handle = None
_lock = threading.Lock()


def _load_lib():
    """The bound library; builds it on the first call. Raises when it cannot
    be built."""
    global _handle
    with _lock:
        if _handle is None:
            lib = ctypes.CDLL(str(_native_build.library("spm_encoder")))
            lib.spm_create.restype = ctypes.c_void_p
            lib.spm_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_int64, ctypes.c_int32, ctypes.c_double]
            lib.spm_destroy.argtypes = [ctypes.c_void_p]
            lib.spm_encode.restype = ctypes.c_int64
            lib.spm_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            _handle = lib
    return _handle


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeSpmEncoder:
    """Viterbi encoder over a piece table; the exact twin of the Python path.
    ``calls`` counts the strings encoded by every instance."""

    calls = 0

    def __init__(self, pieces: Sequence[Tuple[str, float, int]], unk_id: int,
                 unk_score: float):
        self._lib = _load_lib()
        n = len(pieces)
        self._piece_bufs = [p.encode("utf-8") for (p, _, _) in pieces]
        arr = (ctypes.c_char_p * n)(*self._piece_bufs)
        scores = (ctypes.c_double * n)(*[s for (_, s, _) in pieces])
        self._h = self._lib.spm_create(arr, scores, n, unk_id, unk_score)
        if not self._h:
            raise RuntimeError("spm_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.spm_destroy(h)
            self._h = None

    def encode(self, normalized_text: str) -> List[int]:
        """Ids of an already normalized string (the caller adds the T5
        dummy prefix and collapses whitespace, as the Python path does)."""
        raw = normalized_text.encode("utf-8")
        # an explicit byte length: an embedded NUL tokenizes (as unk, like the
        # Python twin) instead of ending the string
        cap = len(raw) + 1  # every id consumes at least one byte
        out = (ctypes.c_int32 * cap)()
        got = self._lib.spm_encode(self._h, raw, len(raw), out, cap)
        if got < 0:  # cannot happen with this cap; the protocol allows it
            cap = -got
            out = (ctypes.c_int32 * cap)()
            got = self._lib.spm_encode(self._h, raw, len(raw), out, cap)
        NativeSpmEncoder.calls += 1
        return list(out[:got])
