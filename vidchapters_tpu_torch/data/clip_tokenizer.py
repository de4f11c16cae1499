"""CLIP BPE tokenizer (pure Python) with an offline fallback.

The reference tokenizes grounding queries with the OpenAI ``clip`` package's
BPE tokenizer (moment_detr/moment_detr/start_end_dataset.py:299-306; a copy
is vendored at moment_detr/run_on_video/clip/simple_tokenizer.py). The BPE
merge table (``bpe_simple_vocab_16e6.txt.gz``) is a data file — when a path
to it is provided this class reproduces CLIP tokenization exactly; without
it, a whitespace+byte fallback keeps the pipeline runnable offline
(pretrained text towers then require the real merges file). The fallback's
ids come from Python's ``hash()`` of each token, which is salted per
process (``PYTHONHASHSEED``): they are stable within a process and change
between processes unless ``PYTHONHASHSEED`` is fixed. The port's own copy
of ``vidchapters_tpu/data/clip_tokenizer.py`` keeps that behaviour, so
that its ids equal the JAX package's in one process.

Vocabulary layout matches CLIP: 256 bytes + 256 byte-with-</w> + 48894
merges + <|startoftext|> (49406) + <|endoftext|> (49407).
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77
SOT, EOT = 49406, 49407


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# ASCII approximation of CLIP's \p{L}/\p{N} pattern (the stdlib ``re`` has no
# unicode property classes; captions here are English)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|"
    r"[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)


def bpe_merge(word: tuple, ranks: Dict[tuple, int]) -> List[str]:
    """``word``'s symbols merged by ranked BPE: while a ranked adjacent pair
    is left, every occurrence of the lowest-ranked one becomes one symbol."""
    while len(word) > 1:
        pairs = set(zip(word[:-1], word[1:]))
        bigram = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
        if bigram not in ranks:
            break
        first, second = bigram
        merged: List[str] = []
        i = 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                merged.append(first + second)
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = tuple(merged)
    return list(word)


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks: Dict[tuple, int] = {}
        self.encoder: Dict[str, int] = {}
        if bpe_path:
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")[1:48894 + 1]
            merges = [tuple(m.split()) for m in merges if m]
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = {v: i for i, v in enumerate(vocab)}
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {}

    @property
    def has_bpe(self) -> bool:
        return bool(self.bpe_ranks)

    def _bpe(self, token: str) -> List[str]:
        if token not in self._cache:
            self._cache[token] = bpe_merge(tuple(token[:-1]) + (token[-1] + "</w>",),
                                           self.bpe_ranks)
        return self._cache[token]

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for match in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in match.encode("utf-8"))
            if self.has_bpe:
                ids.extend(self.encoder[t] for t in self._bpe(token))
            else:  # fallback: a per-process hash of the whole-word token
                ids.append(512 + (hash(token) % (EOT - 512)))
        return ids

    def __call__(self, texts: Sequence[str] | str,
                 context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """clip.tokenize-compatible: [B, context_length] int32 with SOT/EOT."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [SOT] + self.encode(text) + [EOT]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"input too long: {text!r}")
                ids = ids[:context_length]
                ids[-1] = EOT
            out[i, : len(ids)] = ids
        return out
