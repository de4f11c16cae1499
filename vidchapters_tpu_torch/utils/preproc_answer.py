"""VQA-style answer normalization (util/preproc_answer.py equivalent).

Counterpart of ``vidchapters_tpu/utils/preproc_answer.py``, a copy.

Lowercase, expand/normalize contractions, strip punctuation (keeping
in-number commas/periods), drop articles, and map number words to digits —
the standard VQA evaluation normalization the reference carries
(util/preproc_answer.py:171-197; unused by the main chapter paths but part
of the utility surface).
"""

from __future__ import annotations

import re

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "didnt": "didn't", "doesnt":
    "doesn't", "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hes": "he's", "howd": "how'd",
    "howll": "how'll", "hows": "how's", "im": "i'm", "ive": "i've",
    "isnt": "isn't", "itd": "it'd", "itll": "it'll", "lets": "let's",
    "maam": "ma'am", "mightve": "might've", "mustve": "must've",
    "shant": "shan't", "shed": "she'd", "shes": "she's", "shouldve":
    "should've", "shouldnt": "shouldn't", "thats": "that's", "theres":
    "there's", "theyd": "they'd", "theyll": "they'll", "theyre":
    "they're", "theyve": "they've", "wasnt": "wasn't", "wed": "we'd",
    "weve": "we've", "werent": "weren't", "whatll": "what'll", "whatre":
    "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove":
    "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "yall": "y'all", "youd": "you'd", "youll": "you'll", "youre":
    "you're", "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = {"a", "an", "the"}
_PUNCT = list(";/[]\"{}()=+\\_-><@`,?!") + ["'"]
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (
                _COMMA_STRIP.search(text) is not None and p == ","):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    return out


def process_digit_article(text: str) -> str:
    words = []
    for w in text.lower().split():
        w = _NUMBER_MAP.get(w, w)
        if w in _ARTICLES:
            continue
        words.append(_CONTRACTIONS.get(w, w))
    return " ".join(words)


def preprocess_answer(answer: str) -> str:
    answer = answer.replace("\n", " ").replace("\t", " ").strip().lower()
    return process_digit_article(process_punctuation(answer)).strip()
