"""PTB-style caption tokenization, pure Python.

Replaces the Stanford PTBTokenizer *Java subprocess* used by pycocoevalcap
(reference: dvc_eval/eval_dvc.py:19, SODA/dataset.py:4) with a regex
tokenizer reproducing the behaviors that matter for captioning metrics:
lowercasing, splitting punctuation/contractions/possessives PTB-style, and
dropping the pycocoevalcap punctuation list from the token stream.

Interface matches pycocoevalcap: ``tokenize({id: [{'caption': str}, ...]})``
returns ``{id: [tokenized_str, ...]}``.
"""

from __future__ import annotations

import re
from typing import Dict, List

# tokens removed from the stream after tokenization (pycocoevalcap list)
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
             "[": "-LSB-", "]": "-RSB-"}

# contractions that PTB splits as  do n't / they 'll / it 's ...
_CONTRACTION_RE = re.compile(r"\b(\w+)(n't)\b", re.IGNORECASE)
_APOS_SUFFIX_RE = re.compile(r"(\w)('s|'m|'d|'ll|'re|'ve|')(?=\s|$)", re.IGNORECASE)

# core splitter: words (with internal apostrophes/periods kept for now),
# multi-dot ellipses, double dashes, or single non-space symbols
_TOKEN_RE = re.compile(r"\.\.\.|--|n't|'\w+|\w+|[^\w\s]")


def ptb_tokenize_sentence(caption: str) -> str:
    """Tokenize one caption; returns the space-joined surviving tokens."""
    s = caption.replace("\n", " ").lower()
    s = _CONTRACTION_RE.sub(r"\1 \2", s)
    s = _APOS_SUFFIX_RE.sub(r"\1 \2", s)
    for b, tag in _BRACKETS.items():
        s = s.replace(b, f" {tag} ")
    tokens = _TOKEN_RE.findall(s)
    return " ".join(t for t in tokens if t not in PUNCTUATIONS)


class PTBTokenizer:
    """Drop-in for pycocoevalcap's PTBTokenizer (same dict-in/dict-out)."""

    def tokenize(self, captions_for_image: Dict) -> Dict[object, List[str]]:
        return {
            k: [ptb_tokenize_sentence(item["caption"]) for item in items]
            for k, items in captions_for_image.items()
        }
