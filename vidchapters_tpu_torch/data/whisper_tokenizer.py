"""Whisper's byte-level BPE tokenizer over an HF directory, without
``transformers``, ``tokenizers`` or ``regex``.

The JAX package's ``demo_asr`` reads an HF Whisper checkpoint's tokenizer
with ``transformers.WhisperTokenizer``; this is that tokenizer's behaviour
as the demo uses it:

- the GPT-2 pre-tokenizer
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
  as a hand-written scanner over ``unicodedata.category`` (``pretokenize``),
  each piece's UTF-8 bytes mapped through GPT-2's byte-to-unicode table
  (the copy in ``data/clip_tokenizer.py``) and merged by the ranked merges;
- added tokens (Whisper's 1608 special and timestamp tokens) matched in the
  text before the pre-tokenizer, longest first at the earliest position
  (Whisper's carry no ``lstrip`` / ``rstrip`` / ``single_word`` flag);
- ``decode``: added tokens as their text, runs of BPE tokens back to bytes
  and UTF-8 with ``errors="replace"``, ids past the vocabulary as "";
  ``skip_special_tokens`` drops the special ids and a ``<|startofprev|>``
  prompt ahead of ``<|startoftranscript|>``; ``<|0.00|>``-style timestamp
  text is removed from the result, as HF's ``decode`` does; no
  ``clean_up_tokenization_spaces``: HF's slow ``WhisperTokenizer``, the one
  the JAX demo uses, never applies it, whatever the directory says.

``load_whisper_tokenizer(dir)`` reads ``vocab.json`` + ``merges.txt`` with
the added tokens of ``tokenizer_config.json``'s ``added_tokens_decoder`` or
of ``added_tokens.json``, or a directory holding only ``tokenizer.json``
(``model.vocab``, ``model.merges`` as ``"a b"`` strings or ``[a, b]`` pairs,
``added_tokens``). The special ids must be where the transcriber's
constants put them (``check_whisper_special_ids``).
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from vidchapters_tpu_torch.data.clip_tokenizer import bpe_merge, bytes_to_unicode

# Unicode's White_Space property, the ``\s`` of the ``regex`` module
WHITE_SPACE = frozenset(chr(c) for c in [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                            *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                            0x205F, 0x3000])
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
TIMESTAMP_TEXT = re.compile(r"<\|(\d+\.\d+)\|>")


def _kind(ch: str) -> str:
    """"s" (White_Space), "L" (a letter), "N" (a number) or "o" (other)."""
    if ch in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def pretokenize(text: str) -> List[str]:
    """GPT-2's pre-tokenizer pattern, alternative by alternative, at each
    position: a contraction; an optional space and a run of letters, of
    numbers, or of other non-space characters; a run of white space that
    leaves its last character to the next piece when a non-space follows;
    a lone white-space character."""
    kinds = [_kind(ch) for ch in text]
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            hit = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
        start = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "s" else i
        kind = kinds[start]
        if kind != "s":
            j = start + 1
            while j < n and kinds[j] == kind:
                j += 1
            out.append(text[i:j])
            i = j
            continue
        j = i + 1
        while j < n and kinds[j] == "s":
            j += 1
        if j < n and j - 1 > i:
            j -= 1  # \s+(?!\S): the last space goes with the next piece
        out.append(text[i:j])
        i = j
    return out


class AddedToken(NamedTuple):
    content: str
    special: bool = True


# the special ids of the multilingual Whisper vocabulary that the
# transcriber's constants hard-code (factory/whisper_transcribe.py)
WHISPER_SPECIAL_IDS = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
                       "<|en|>": 50259, "<|transcribe|>": 50359, "<|startofprev|>": 50361,
                       "<|nocaptions|>": 50362, "<|notimestamps|>": 50363, "<|0.00|>": 50364}


class WhisperTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added: Dict[int, AddedToken], special_tokens: Iterable[str] = (),
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(vocab)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.added = dict(added)
        self.added_ids = {tok.content: i for i, tok in self.added.items()}
        # by first character, longest first: a token that is a prefix of
        # another loses to it
        self._added_by_first: Dict[str, List[str]] = {}
        for t in sorted(self.added_ids, key=len, reverse=True):
            self._added_by_first.setdefault(t[:1], []).append(t)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.eos_token_id = self.convert_tokens_to_ids(eos_token)
        self.all_special_ids = sorted({self.convert_tokens_to_ids(t) for t in special_tokens}
                                      - {None})
        self._cache: Dict[str, List[str]] = {}

    def __len__(self) -> int:
        return len(set(self.encoder.values()) | set(self.added))

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self.added_ids.get(token, self.encoder.get(token))

    # -- encoding --------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token not in self._cache:
            self._cache[token] = bpe_merge(tuple(token), self.bpe_ranks)
        return self._cache[token]

    def _split_added(self, text: str) -> List[str]:
        """``text`` cut around its added tokens (the earliest match, the
        longest there): text, token, text, ..., text."""
        parts: List[str] = []
        i = start = 0
        while i < len(text):
            hit = next((t for t in self._added_by_first.get(text[i], ())
                        if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            parts += [text[start:i], hit]
            i = start = i + len(hit)
        parts.append(text[start:])
        return parts

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for k, part in enumerate(self._split_added(text)):
            if k % 2:
                out.append(part)
                continue
            for piece in pretokenize(part):
                out.extend(self._bpe("".join(self.byte_encoder[b]
                                             for b in piece.encode("utf-8"))))
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Token ids of ``text``, as HF's ``encode(text,
        add_special_tokens=False)``; a piece missing from the vocabulary is
        ``<|endoftext|>``, Whisper's unknown token. The prefix HF's default
        wraps around the ids is not built here."""
        if add_special_tokens:
            raise ValueError("encode adds no special tokens: pass add_special_tokens=False")
        unk = self.convert_tokens_to_ids("<|endoftext|>")
        return [unk if i is None else i
                for i in map(self.convert_tokens_to_ids, self.tokenize(text))]

    # -- decoding --------------------------------------------------------------

    def _bytes_text(self, tokens: List[str]) -> str:
        data = bytearray(self.byte_decoder[c] for c in "".join(tokens))
        return data.decode("utf-8", errors="replace")

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in (ids.tolist() if hasattr(ids, "tolist") else ids)]
        if skip_special_tokens and ids and ids[0] == self.convert_tokens_to_ids(
                "<|startofprev|>"):
            sot = self.convert_tokens_to_ids("<|startoftranscript|>")
            ids = ids[ids.index(sot):] if sot in ids else []
        special = set(self.all_special_ids) if skip_special_tokens else ()
        parts: List[str] = []
        run: List[str] = []
        for i in ids:
            if i in special:
                continue
            tok = self.added[i].content if i in self.added else self.decoder.get(i, "")
            if tok in self.added_ids:
                if run:
                    parts.append(self._bytes_text(run))
                    run = []
                parts.append(tok)
            else:
                run.append(tok)
        if run:
            parts.append(self._bytes_text(run))
        return TIMESTAMP_TEXT.sub("", "".join(parts))


def _read_json(path: Path):
    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        raise ValueError(f"{path}: cannot read it as JSON ({e})") from None


def _token_text(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


def _added_from_entries(entries) -> Dict[int, AddedToken]:
    return {int(e["id"]): AddedToken(e["content"], bool(e.get("special", False)))
            for e in entries}


def load_whisper_tokenizer(model_dir: str) -> WhisperTokenizer:
    """The tokenizer of an HF Whisper directory: ``vocab.json`` and
    ``merges.txt`` with ``tokenizer_config.json`` (its
    ``added_tokens_decoder``, else ``added_tokens.json``, and the special
    tokens of it or of ``special_tokens_map.json``), or ``tokenizer.json``
    alone. Raises ``FileNotFoundError`` / ``ValueError`` naming the file it
    could not read."""
    root = Path(model_dir)
    conf = _read_json(root / "tokenizer_config.json") if (
        root / "tokenizer_config.json").exists() else {}
    smap = _read_json(root / "special_tokens_map.json") if (
        root / "special_tokens_map.json").exists() else {}
    if (root / "vocab.json").exists():
        vocab = _read_json(root / "vocab.json")
        if not (root / "merges.txt").exists():
            raise FileNotFoundError(f"{root / 'merges.txt'}: missing beside vocab.json")
        lines = (root / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
        merges = [tuple(m.split()) for m in lines]
        if "added_tokens_decoder" in conf:
            added = _added_from_entries(
                {**e, "id": i} for i, e in conf["added_tokens_decoder"].items())
        elif (root / "added_tokens.json").exists():
            added = {int(i): AddedToken(t) for t, i in
                     _read_json(root / "added_tokens.json").items()}
        else:
            added = {}
        flagged: List[str] = []
    elif (root / "tokenizer.json").exists():
        full = _read_json(root / "tokenizer.json")
        try:
            vocab, merges = full["model"]["vocab"], full["model"]["merges"]
            added = _added_from_entries(full.get("added_tokens", []))
        except (KeyError, TypeError) as e:
            raise ValueError(f"{root / 'tokenizer.json'}: no BPE model ({e})") from None
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in merges]
        flagged = [t.content for t in added.values() if t.special]
    else:
        raise FileNotFoundError(f"{root}: no vocab.json + merges.txt and no tokenizer.json")

    def setting(key, default=None):
        return conf.get(key, smap.get(key, default))

    named = [_token_text(setting(k, "<|endoftext|>")) for k in ("bos_token", "eos_token",
                                                               "unk_token")]
    special = named + [_token_text(t) for t in [setting("pad_token")] + setting(
        "additional_special_tokens", []) if t] + flagged
    return WhisperTokenizer(vocab, merges, added, special, eos_token=named[1])


def check_whisper_special_ids(tok: WhisperTokenizer) -> None:
    """Raise unless the tokenizer's special tokens sit at the ids the
    transcriber uses (the multilingual vocabulary's layout)."""
    wrong = {t: tok.convert_tokens_to_ids(t) for t, i in WHISPER_SPECIAL_IDS.items()
             if tok.convert_tokens_to_ids(t) != i}
    if wrong:
        raise ValueError(f"the tokenizer's special ids {wrong} differ from the multilingual "
                         f"Whisper layout the transcriber uses ({WHISPER_SPECIAL_IDS})")
