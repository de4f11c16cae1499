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
- ``SentencePieceBPETokenizer`` encodes and decodes a sentencepiece BPE
  model (LLaMA's ``tokenizer.model``) with its own ids;
  ``load_sentencepiece`` picks it or the unigram encoder by the model's
  ``trainer_spec.model_type``.
- ``ByteLevelTokenizer`` is a dependency-free fallback with the same id
  layout (pad=0, eos=1, unk=2, sentinels at the top of the text vocab) used
  for tests and fully-offline runs.

The unigram and byte-level tokenizers append time tokens
``<time=0> .. <time=num_bins-1>`` at ids
``[text_vocab_size, text_vocab_size + num_bins)`` and decode them as literal
text so the downstream chapter regex decoding (dvc.py:186-212 semantics in
``time_tokens.decode_chapter_sequence``) works unchanged.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

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


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        return _read_varint(buf, pos)[1]
    if wire == 2:
        length, pos = _read_varint(buf, pos)
        return pos + length
    if wire == 5:
        return pos + 4
    if wire == 1:
        return pos + 8
    raise ValueError(f"bad wire type {wire}")


def _fields(buf: bytes):
    """(field, wire, value) of each field of one message: ints for varints
    (int32 / int64 two's complement), bytes for length-delimited fields,
    the raw 4 bytes of a fixed32."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
            value = value - (1 << 64) if value >= 1 << 63 else value
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            pos = _skip_field(buf, pos, wire)
            continue
        yield field, wire, value


class SpmModel:
    """A sentencepiece ``ModelProto``: its pieces, and its two spec
    messages as raw bytes (empty when absent) for ``SpmSpecs.parse``.

    ModelProto { repeated SentencePiece pieces = 1; TrainerSpec trainer_spec
    = 2; NormalizerSpec normalizer_spec = 3; }. SentencePiece { string piece
    = 1; float score = 2; Type type = 3; } (type: 1=NORMAL 2=UNKNOWN
    3=CONTROL 4=USER_DEFINED 5=UNUSED 6=BYTE). The unigram encoder reads
    the pieces alone; the BPE encoder parses the specs too.
    """

    def __init__(self, data: bytes):
        self.pieces: List[Tuple[str, float, int]] = []
        self.trainer_spec = self.normalizer_spec = b""
        for field, wire, value in _fields(data):
            if field == 1 and wire == 2:
                piece, score, ptype = "", 0.0, 1
                for f, w, v in _fields(value):
                    if f == 1 and w == 2:
                        piece = v.decode("utf-8")
                    elif f == 2 and w == 5:
                        (score,) = struct.unpack("<f", v)
                    elif f == 3 and w == 0:
                        ptype = v
                self.pieces.append((piece, score, ptype))
            elif field == 2 and wire == 2:
                self.trainer_spec = value
            elif field == 3 and wire == 2:
                self.normalizer_spec = value


@dataclass
class SpmSpecs:
    """The fields of a ``ModelProto``'s specs the BPE encoder uses.

    TrainerSpec { ModelType model_type = 3 (1=UNIGRAM 2=BPE 3=WORD 4=CHAR);
    bool byte_fallback = 35; int32 unk_id = 40, bos_id = 41, eos_id = 42,
    pad_id = 43; }. NormalizerSpec { string name = 1; bool add_dummy_prefix
    = 3; bool remove_extra_whitespaces = 4; bool escape_whitespaces = 5; }.
    Absent fields take the proto's defaults; a spec that is not a message
    raises ``ValueError``.
    """

    UNIGRAM: ClassVar[int] = 1
    BPE: ClassVar[int] = 2

    model_type: int = 1
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    normalizer: str = ""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    @classmethod
    def parse(cls, model: SpmModel) -> "SpmSpecs":
        spec = cls()
        try:
            trainer = list(_fields(model.trainer_spec))
            normalizer = list(_fields(model.normalizer_spec))
        except (IndexError, ValueError) as e:
            raise ValueError(f"a sentencepiece spec is not a message: {e!r}") from None
        for f, w, v in trainer:
            if w != 0:
                continue
            if f == 3:
                spec.model_type = v
            elif f == 35:
                spec.byte_fallback = bool(v)
            elif f in (40, 41, 42, 43):
                setattr(spec, ("unk_id", "bos_id", "eos_id", "pad_id")[f - 40], v)
        for f, w, v in normalizer:
            if f == 1 and w == 2:
                spec.normalizer = v.decode("utf-8")
            elif f in (3, 4, 5) and w == 0:
                setattr(spec, ("add_dummy_prefix", "remove_extra_whitespaces",
                               "escape_whitespaces")[f - 3], bool(v))
        return spec


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
            pieces = SpmModel(f.read()).pieces
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


class SentencePieceBPETokenizer:
    """Encoder and decoder of a sentencepiece **BPE** ``tokenizer.model``
    (LLaMA's), in Python, with the ids of the model's pieces (no time
    tokens, no sentinels).

    ``encode`` follows sentencepiece's BPE model: the ``identity``
    normalizer (extra whitespace removed when the model asks, spaces become
    ``▁``, a ``▁`` dummy prefix when the model asks), each character a
    symbol, then repeatedly the adjacent pair whose concatenation is a
    piece with the highest score is merged, the leftmost on a tie. A symbol
    that no piece holds goes out as its UTF-8 bytes (``<0xXX>`` pieces) when
    the model has ``byte_fallback``, else as ``unk_id``. ``decode``
    reassembles byte pieces into characters, turns ``▁`` into spaces and
    drops the dummy prefix's. A model type, a normalizer, or pieces
    (``UNUSED``) that this encoder does not implement raise."""

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            m = SpmModel(f.read())
        spec = SpmSpecs.parse(m)
        if spec.model_type != SpmSpecs.BPE:
            raise ValueError(f"{model_path}: model_type {spec.model_type} is not BPE (2)")
        if spec.normalizer not in ("identity",):
            raise ValueError(f"{model_path}: normalizer {spec.normalizer!r} is not implemented "
                             "(only 'identity', LLaMA's)")
        if any(t == 5 for _, _, t in m.pieces):
            raise ValueError(f"{model_path}: UNUSED pieces are not implemented")
        self.spec = spec
        self.pieces = m.pieces
        self.unk_token_id, self.bos_token_id = spec.unk_id, spec.bos_id
        self.eos_token_id, self.pad_token_id = spec.eos_id, spec.pad_id
        # the pieces merges may form (sentencepiece's NORMAL and USER_DEFINED)
        self.piece_to_id = {p: i for i, (p, _, t) in enumerate(m.pieces) if t in (1, 4)}
        self.byte_ids = {int(p[3:5], 16): i for i, (p, _, t) in enumerate(m.pieces) if t == 6}
        if spec.byte_fallback and len(self.byte_ids) != 256:
            raise ValueError(f"{model_path}: byte_fallback with {len(self.byte_ids)} byte "
                             "pieces, not 256")

    def __len__(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        m = self.spec
        if m.remove_extra_whitespaces:
            text = re.sub(r" +", " ", text.strip(" "))
        if not text:
            return ""
        if m.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", _WS) if m.escape_whitespaces else text

    def _bpe(self, s: str) -> List[str]:
        """The merged symbols of the normalized string ``s``."""
        import heapq

        sym = list(s)
        nxt = list(range(1, len(sym) + 1))
        prev = list(range(-1, len(sym) - 1))
        scores = self.pieces
        heap: List[Tuple[float, int, str, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j < len(sym):
                pid = self.piece_to_id.get(sym[i] + sym[j])
                if pid is not None:
                    heapq.heappush(heap, (-scores[pid][1], i, sym[i], sym[j]))

        for i in range(len(sym) - 1):
            push(i)
        while heap:
            _, i, left, right = heapq.heappop(heap)
            j = nxt[i] if sym[i] else len(sym)
            if sym[i] != left or j >= len(sym) or sym[j] != right:
                continue  # a stale pair: one of its symbols was merged since
            sym[i], sym[j] = left + right, ""
            nxt[i] = nxt[j]
            if nxt[j] < len(sym):
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)
        return [x for x in sym if x]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """The ids of ``text``; ``add_special_tokens`` puts ``<s>`` first, as
        LLaMA's tokenizer does."""
        ids = [self.bos_token_id] if add_special_tokens else []
        s = self._normalize(text)
        for piece in (self._bpe(s) if s else []):
            pid = self.piece_to_id.get(piece)
            if pid is not None:
                ids.append(pid)
            elif self.spec.byte_fallback:
                ids.extend(self.byte_ids[b] for b in piece.encode("utf-8"))
            else:
                ids.append(self.unk_token_id)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out, run = [], bytearray()

        def flush():
            if run:
                out.append(run.decode("utf-8", errors="replace"))
                run.clear()

        for i in ids:
            piece, _, ptype = self.pieces[int(i)]
            if ptype == 6:
                run.append(int(piece[3:5], 16))
                continue
            flush()
            if ptype == 3:
                if not skip_special_tokens:
                    out.append(piece)
            elif ptype == 2:
                out.append(" ⁇ ")
            else:
                out.append(piece)
        flush()
        text = "".join(out).replace(_WS, " ")
        if self.spec.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]


def load_sentencepiece(model_path: str, **unigram_kwargs):
    """The encoder for a sentencepiece model file by its
    ``trainer_spec.model_type``: ``SentencePieceBPETokenizer`` for BPE,
    ``SentencePieceUnigramTokenizer(model_path, **unigram_kwargs)`` for
    unigram; other types raise."""
    with open(model_path, "rb") as f:
        kind = SpmSpecs.parse(SpmModel(f.read())).model_type
    if kind == SpmSpecs.BPE:
        return SentencePieceBPETokenizer(model_path)
    if kind == SpmSpecs.UNIGRAM:
        return SentencePieceUnigramTokenizer(model_path, **unigram_kwargs)
    raise ValueError(f"{model_path}: sentencepiece model_type {kind} is not implemented")


def build_tokenizer(tokenizer_path: str = "", num_bins: int = 100) -> _TokenizerBase:
    """Factory mirroring ``_get_tokenizer`` (model/vid2seq.py:10-18): a real
    sentencepiece model when a path is supplied, byte-level fallback otherwise."""
    if tokenizer_path:
        return SentencePieceUnigramTokenizer(tokenizer_path, num_bins=num_bins)
    return ByteLevelTokenizer(num_bins=num_bins)
