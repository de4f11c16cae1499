"""Tokenizers with T5 vocabulary layout + ``<time=k>`` tokens.

The PyTorch port's own copy of ``vidchapters_tpu/data/tokenizer.py``: the
same ids, with the SentencePiece Viterbi in Python and in C++
(``data/native_spm.py``, chosen when g++ builds it).

The reference builds its tokenizer from HF ``T5Tokenizer`` and appends
``num_bins`` time tokens (model/vid2seq.py:10-18); the embedding table is
resized to 32100 text tokens + 100 time tokens (model/vid2seq.py:39-40).
This module reproduces that vocabulary layout without any network or
binary-blob dependency:

- ``SentencePieceUnigramTokenizer`` parses a real ``spiece.model`` protobuf
  with a hand-rolled wire-format reader and performs Viterbi unigram
  segmentation — byte-identical vocab ids to HF's T5 tokenizer, so real T5
  checkpoints and captions round-trip.
- ``ByteLevelTokenizer`` is a dependency-free fallback with the same id
  layout (pad=0, eos=1, unk=2, sentinels at the top of the text vocab) used
  for tests and fully-offline runs.

Both append time tokens ``<time=0> .. <time=num_bins-1>`` at ids
``[text_vocab_size, text_vocab_size + num_bins)`` and decode them as literal
text so the downstream chapter regex decoding (dvc.py:186-212 semantics in
``time_tokens.decode_chapter_sequence``) works unchanged.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

_TIME_RE = re.compile(r"<time=(\d+)>")
_EXTRA_RE = re.compile(r"<extra_id_(\d+)>")

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2


class _TokenizerBase:
    """Shared API: HF-tokenizer-compatible subset used by the framework."""

    pad_token_id: int = PAD_ID
    eos_token_id: int = EOS_ID
    unk_token_id: int = UNK_ID

    def __init__(self, text_vocab_size: int, num_bins: int, num_sentinels: int = 100):
        self.text_vocab_size = text_vocab_size
        self.num_bins = num_bins
        self.num_sentinels = num_sentinels

    def __len__(self) -> int:
        return self.text_vocab_size + self.num_bins

    # -- special-token helpers ------------------------------------------------

    def time_token_id(self, k: int) -> int:
        assert 0 <= k < self.num_bins, k
        return self.text_vocab_size + k

    def is_time_token(self, tid: int) -> bool:
        return self.text_vocab_size <= tid < self.text_vocab_size + self.num_bins

    def sentinel_id(self, k: int) -> int:
        """``<extra_id_k>``: highest text id for k=0 (HF T5 layout)."""
        assert 0 <= k < self.num_sentinels
        return self.text_vocab_size - 1 - k

    # -- encode / decode ------------------------------------------------------

    def _encode_text(self, text: str) -> List[int]:
        raise NotImplementedError

    def _decode_text(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: Optional[int] = None, truncation: bool = False) -> List[int]:
        """Encode, treating ``<time=k>`` as atomic added tokens (HF add_tokens
        semantics: added tokens split the text before the base model runs)."""
        ids: List[int] = []
        pos = 0
        for m in _TIME_RE.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_text(text[pos:m.start()]))
            ids.append(self.time_token_id(int(m.group(1))))
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_text(text[pos:]))
        if add_special_tokens:
            ids.append(self.eos_token_id)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = False,
                 max_length: Optional[int] = None, truncation: bool = False,
                 **_ignored) -> Dict[str, List[int]]:
        ids = self.encode(text, add_special_tokens=add_special_tokens,
                          max_length=max_length, truncation=truncation)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """Decode; time tokens render as literal ``<time=k>`` words separated
        by spaces (matching HF added-token decoding used at dvc.py:163-165)."""
        parts: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                piece = self._decode_text(run)
                if piece:
                    parts.append(piece)
                run.clear()

        for tid in ids:
            tid = int(tid)
            if tid in (self.pad_token_id, self.eos_token_id) and skip_special_tokens:
                flush()
                continue
            if self.is_time_token(tid):
                flush()
                parts.append(f"<time={tid - self.text_vocab_size}>")
            elif tid >= self.text_vocab_size - self.num_sentinels and tid < self.text_vocab_size:
                flush()
                if not skip_special_tokens:
                    parts.append(f"<extra_id_{self.text_vocab_size - 1 - tid}>")
            else:
                run.append(tid)
        flush()
        return " ".join(p for p in parts if p).strip()

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens=skip_special_tokens)
                for ids in batch_ids]


class ByteLevelTokenizer(_TokenizerBase):
    """Offline fallback: UTF-8 bytes at ids ``3 + byte``; same outer layout
    as the T5 vocabulary (text_vocab_size defaults to 32100)."""

    def __init__(self, text_vocab_size: int = 32100, num_bins: int = 100):
        super().__init__(text_vocab_size, num_bins)
        self._byte_offset = 3

    def _encode_text(self, text: str) -> List[int]:
        # segment-edge whitespace is dropped, mirroring T5 spm normalization
        # (decode re-joins segments with single spaces)
        return [self._byte_offset + b for b in text.strip().encode("utf-8")]

    def _decode_text(self, ids: Sequence[int]) -> str:
        data = bytes(max(0, min(255, i - self._byte_offset)) for i in ids
                     if self._byte_offset <= i < self._byte_offset + 256)
        return data.decode("utf-8", errors="ignore").strip()


# ---------------------------------------------------------------------------
# SentencePiece unigram model: protobuf wire parsing + Viterbi segmentation
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_spm_pieces(data: bytes) -> List[Tuple[str, float, int]]:
    """Parse `ModelProto.pieces` (field 1) from a sentencepiece model file.

    SentencePiece wire layout: ModelProto { repeated SentencePiece pieces = 1; }
    SentencePiece { optional string piece = 1; optional float score = 2;
                    optional Type type = 3; } (type: 1=NORMAL 2=UNKNOWN
    3=CONTROL 4=USER_DEFINED 5=UNUSED 6=BYTE).
    """
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # length-delimited SentencePiece
            length, pos = _read_varint(data, pos)
            sub = data[pos:pos + length]
            pos += length
            piece, score, ptype = "", 0.0, 1
            spos = 0
            while spos < length:
                stag, spos = _read_varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    slen, spos = _read_varint(sub, spos)
                    piece = sub[spos:spos + slen].decode("utf-8")
                    spos += slen
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[spos:spos + 4])
                    spos += 4
                elif sfield == 3 and swire == 0:
                    ptype, spos = _read_varint(sub, spos)
                else:  # skip unknown field
                    if swire == 0:
                        _, spos = _read_varint(sub, spos)
                    elif swire == 2:
                        slen, spos = _read_varint(sub, spos)
                        spos += slen
                    elif swire == 5:
                        spos += 4
                    elif swire == 1:
                        spos += 8
                    else:
                        raise ValueError(f"bad wire type {swire}")
            pieces.append((piece, score, ptype))
        else:  # skip other top-level fields (trainer/normalizer specs)
            if wire == 0:
                _, pos = _read_varint(data, pos)
            elif wire == 2:
                length, pos = _read_varint(data, pos)
                pos += length
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"bad wire type {wire}")
    return pieces


_WS = "▁"  # sentencepiece whitespace marker


class SentencePieceUnigramTokenizer(_TokenizerBase):
    """Unigram sentencepiece encoder over a real ``spiece.model`` (Viterbi
    in C++ when ``use_native`` allows and g++ builds it, else in Python).

    Matches HF T5Tokenizer ids: spm pieces own ids [0, n_pieces); 100
    ``<extra_id_k>`` sentinels appended with <extra_id_0> last (highest id);
    then this framework's time tokens. T5's spm has pad=0, eos=1, unk=2 as
    CONTROL/UNKNOWN pieces already.
    """

    def __init__(self, model_path: str, num_bins: int = 100, extra_ids: int = 100,
                 use_native: Optional[bool] = None):
        with open(model_path, "rb") as f:
            pieces = _parse_spm_pieces(f.read())
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores: List[float] = [s for (_, s, _) in pieces]
        self.max_piece_len = max(len(p) for (p, _, _) in pieces)
        self._prefix_set = None  # built by the Python Viterbi's first call
        text_vocab_size = len(pieces) + extra_ids
        super().__init__(text_vocab_size, num_bins, num_sentinels=extra_ids)
        # unigram Viterbi needs an unk score penalty
        self._unk_score = min(self.scores) - 10.0
        # the C++ Viterbi twin (data/native_spm.py): the same ids, far faster.
        # None: use it when g++ builds it; True: require it; False: Python.
        self._native = None
        if use_native is not False:
            from vidchapters_tpu_torch.data import native_spm

            try:
                self._native = native_spm.NativeSpmEncoder(pieces, UNK_ID, self._unk_score)
            except (RuntimeError, OSError):
                if use_native:
                    raise

    # -- normalization (T5 spm: add dummy prefix, collapse spaces) -----------

    def _normalize(self, text: str) -> str:
        text = re.sub(r"\s+", " ", text.strip())
        return _WS + text.replace(" ", _WS)

    @property
    def _prefixes(self):
        """Proper prefixes of every piece: the Viterbi's inner loop stops as
        soon as no piece can extend the current substring (the native
        encoder prunes the same way)."""
        if self._prefix_set is None:
            self._prefix_set = {p[:k] for (p, _, _) in self.pieces
                                for k in range(1, len(p))}
        return self._prefix_set

    def _encode_text(self, text: str) -> List[int]:
        if not text.strip():
            return []
        s = self._normalize(text)
        if self._native is not None:
            return self._native.encode(s)
        return self._viterbi(s)

    def _viterbi(self, s: str) -> List[int]:
        """Ids of the normalized string ``s``, in Python."""
        n = len(s)
        # Viterbi over substrings present in the vocab
        best = [float("-inf")] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, UNK_ID)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                sub = s[i:j]
                pid = self.piece_to_id.get(sub)
                if pid is not None:
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, pid)
                elif sub not in self._prefixes:
                    break  # no piece extends this substring
            # unk fallback: consume one char
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, UNK_ID)
        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append(pid)
            j = i
        return ids[::-1]

    def _decode_text(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if 0 <= i < len(self.pieces):
                piece, _, ptype = self.pieces[i]
                if ptype in (2,):  # UNKNOWN
                    out.append(" ⁇ ")
                elif ptype in (3,):  # CONTROL
                    continue
                else:
                    out.append(piece)
        return "".join(out).replace(_WS, " ").strip()


def build_tokenizer(tokenizer_path: str = "", num_bins: int = 100) -> _TokenizerBase:
    """Factory mirroring ``_get_tokenizer`` (model/vid2seq.py:10-18): a real
    sentencepiece model when a path is supplied, byte-level fallback otherwise."""
    if tokenizer_path:
        return SentencePieceUnigramTokenizer(tokenizer_path, num_bins=num_bins)
    return ByteLevelTokenizer(num_bins=num_bins)
