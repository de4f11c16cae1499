"""BERT's WordPiece tokenizer over a ``vocab.txt``, without ``transformers``.

The JAX package tokenizes for its BERT towers (``grounding_main
--bert-ckpt``'s speech tower, the toxicity classifier of
``factory/analysis.py``) with HF's ``BertTokenizer``; this is that
tokenizer's behaviour as those callers use it:

- the basic tokenizer: control characters and U+FFFD dropped, whitespace to
  spaces, spaces around CJK ideographs, NFC; then per whitespace token
  lower case (``do_lower_case``) with NFD accent stripping
  (``strip_accents``, by default following ``do_lower_case``), and a split
  around every punctuation character;
- greedy longest-match-first WordPiece with ``##`` continuations; a word
  longer than 100 characters, or one that no pieces cover, is ``[UNK]``;
- ``[CLS]`` ... ``[SEP]``, truncation to ``max_length`` that keeps
  ``[SEP]``, and padding with ``[PAD]`` and an attention mask.

``WordPieceTokenizer.from_pretrained(dir)`` reads ``vocab.txt`` and the
``do_lower_case`` / ``strip_accents`` / ``tokenize_chinese_chars`` of
``tokenizer_config.json`` when the directory has one (defaults True, None,
True, as ``BertTokenizer``'s).
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # every non-alphanumeric ASCII character counts, as in BERT
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None, tokenize_chinese_chars: bool = True,
                 max_input_chars_per_word: int = 100):
        lines = Path(vocab_file).read_text(encoding="utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        self.vocab: Dict[str, int] = {}
        for i, token in enumerate(lines):
            self.vocab[token] = i  # a repeated token keeps its last line, as HF reads it
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token_id = self.vocab["[PAD]"]
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "WordPieceTokenizer":
        root = Path(model_dir)
        conf = {}
        if (root / "tokenizer_config.json").exists():
            conf = json.loads((root / "tokenizer_config.json").read_text())
        return cls(str(root / "vocab.txt"), do_lower_case=conf.get("do_lower_case", True),
                   strip_accents=conf.get("strip_accents"),
                   tokenize_chinese_chars=conf.get("tokenize_chinese_chars", True))

    # -- the basic tokenizer ---------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            if ord(ch) == 0 or ord(ch) == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic(self, text: str) -> List[str]:
        text = self._clean(text)
        if self.tokenize_chinese_chars:
            text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        tokens = []
        for token in unicodedata.normalize("NFC", text).split():
            if self.do_lower_case:
                token = token.lower()
            if self.strip_accents or (self.strip_accents is None and self.do_lower_case):
                token = "".join(ch for ch in unicodedata.normalize("NFD", token)
                                if unicodedata.category(ch) != "Mn")
            word: List[str] = []
            for ch in token:
                if _is_punctuation(ch):
                    if word:
                        tokens.append("".join(word))
                        word = []
                    tokens.append(ch)
                else:
                    word.append(ch)
            if word:
                tokens.append("".join(word))
        return tokens

    # -- WordPiece -------------------------------------------------------------

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            if start == end:
                return ["[UNK]"]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for word in self._basic(text) for p in self._wordpiece(word)]

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        """``[CLS]`` + the pieces' ids + ``[SEP]``; with ``truncation`` at
        most ``max_length`` ids, the pieces cut from the end."""
        ids = [self.vocab.get(p, self.unk_token_id) for p in self.tokenize(text)]
        if truncation and max_length is not None:
            ids = ids[:max(max_length - 2, 0)]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def __call__(self, texts: Union[str, Sequence[str]], max_length: Optional[int] = None,
                 truncation: bool = False, padding: Union[bool, str] = False
                 ) -> Dict[str, np.ndarray]:
        """HF's ``tokenizer(texts, max_length=, truncation=, padding=,
        return_tensors="np")``: ``input_ids``, ``token_type_ids`` and
        ``attention_mask`` as int64 arrays [B, L]. ``padding`` is
        ``"max_length"``, ``"longest"`` / True, or False (rows of one
        length only)."""
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t, max_length, truncation) for t in texts]
        width = (max_length if padding == "max_length" and max_length is not None
                 else max(len(r) for r in rows))
        if not padding and any(len(r) != width for r in rows):
            raise ValueError("rows of different lengths need padding")
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids), "attention_mask": mask}
