"""TextTiling topic segmentation (Hearst 1997), from scratch: the port's own
copy of ``vidchapters_tpu/zeroshot/texttiling.py``.

Replaces the vendored NLTK tokenizer (model/texttitling.py:85-482) used by
the zero-shot speech chapter-generation baseline (zs_speechvcg.py): the text
is split into pseudo-sentences of ``w`` tokens, adjacent blocks of ``k``
pseudo-sentences are compared by cosine similarity over stop-word-filtered
token counts, the gap-score series is smoothed, depth scores are computed at
local minima, and boundaries are placed where depth exceeds
``mean - cutoff_policy * std``, snapped to paragraph breaks.

Dependency-free: a built-in English stopword list replaces the NLTK corpus
download.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence, Tuple

STOPWORDS = frozenset("""
i me my myself we our ours ourselves you your yours yourself yourselves he
him his himself she her hers herself it its itself they them their theirs
themselves what which who whom this that these those am is are was were be
been being have has had having do does did doing a an the and but if or
because as until while of at by for with about against between into through
during before after above below to from up down in out on off over under
again further then once here there when where why how all any both each few
more most other some such no nor not only own same so than too very s t can
will just don should now
""".split())

_WORD_RE = re.compile(r"\w+", re.UNICODE)


def _tokenize_lower(text: str) -> List[Tuple[str, int]]:
    """(token, char_offset) pairs, lowercased."""
    return [(m.group(0).lower(), m.start()) for m in _WORD_RE.finditer(text)]


class TextTilingTokenizer:
    """API-compatible subset of nltk's TextTilingTokenizer: ``tokenize(text)``
    returns the list of multi-paragraph segments."""

    def __init__(self, w: int = 20, k: int = 10, smoothing_width: int = 2,
                 smoothing_rounds: int = 1, cutoff_policy: str = "HC"):
        self.w = w
        self.k = k
        self.smoothing_width = smoothing_width
        self.smoothing_rounds = smoothing_rounds
        self.cutoff_policy = cutoff_policy

    def tokenize(self, text: str) -> List[str]:
        paragraph_breaks = self._mark_paragraph_breaks(text)
        lowercase_text = text.lower()
        tokens = [(w, off) for (w, off) in _tokenize_lower(text)
                  if w not in STOPWORDS]
        if len(tokens) < self.w * 2:
            return [text]

        # pseudo-sentences of w tokens
        gap_scores = self._block_comparison(tokens)
        smooth = self._smooth(gap_scores)
        depths = self._depth_scores(smooth)
        seg_boundaries = self._identify_boundaries(depths)

        # token gap index -> char offset -> nearest paragraph break
        breaks = []
        for gap_idx, is_boundary in enumerate(seg_boundaries):
            if not is_boundary:
                continue
            tok_idx = min((gap_idx + 1) * self.w, len(tokens) - 1)
            char_off = tokens[tok_idx][1]
            nearest = min(paragraph_breaks, key=lambda b: abs(b - char_off))
            if nearest not in breaks and 0 < nearest < len(text):
                breaks.append(nearest)
        breaks.sort()

        segments = []
        prev = 0
        for b in breaks:
            segments.append(text[prev:b])
            prev = b
        segments.append(text[prev:])
        return [s for s in segments if s.strip()]

    # -- internals -----------------------------------------------------------

    def _mark_paragraph_breaks(self, text: str) -> List[int]:
        breaks = [0]
        for m in re.finditer(r"\n\s*\n|\n", text):
            breaks.append(m.end())
        return breaks

    def _block_comparison(self, tokens: List[Tuple[str, int]]) -> List[float]:
        w, k = self.w, self.k
        n_gaps = len(tokens) // w - 1
        scores = []
        for gap in range(n_gaps):
            left_start = max(0, (gap + 1 - k)) * w
            left = [t for t, _ in tokens[left_start:(gap + 1) * w]]
            right = [t for t, _ in tokens[(gap + 1) * w:(gap + 1 + k) * w]]
            scores.append(self._cosine(left, right))
        return scores

    @staticmethod
    def _cosine(a: Sequence[str], b: Sequence[str]) -> float:
        from collections import Counter

        ca, cb = Counter(a), Counter(b)
        num = sum(ca[t] * cb[t] for t in ca)
        den = math.sqrt(sum(v * v for v in ca.values())) * math.sqrt(
            sum(v * v for v in cb.values()))
        return num / den if den else 0.0

    def _smooth(self, scores: List[float]) -> List[float]:
        out = list(scores)
        for _ in range(self.smoothing_rounds):
            width = self.smoothing_width
            smoothed = []
            for i in range(len(out)):
                lo, hi = max(0, i - width // 2), min(len(out), i + width // 2 + 1)
                smoothed.append(sum(out[lo:hi]) / (hi - lo))
            out = smoothed
        return out

    @staticmethod
    def _depth_scores(scores: List[float]) -> List[float]:
        depths = []
        for i, s in enumerate(scores):
            lpeak = s
            for j in range(i, -1, -1):
                if scores[j] >= lpeak:
                    lpeak = scores[j]
                else:
                    break
            rpeak = s
            for j in range(i, len(scores)):
                if scores[j] >= rpeak:
                    rpeak = scores[j]
                else:
                    break
            depths.append(lpeak + rpeak - 2 * s)
        return depths

    def _identify_boundaries(self, depths: List[float]) -> List[bool]:
        if not depths:
            return []
        mean = sum(depths) / len(depths)
        std = math.sqrt(sum((d - mean) ** 2 for d in depths) / len(depths))
        if self.cutoff_policy == "LC":
            cutoff = mean - std
        else:  # "HC"
            cutoff = mean - std / 2.0
        flags = [d > cutoff for d in depths]
        # enforce a minimum distance of 4 gaps between boundaries
        last = -5
        out = []
        for i, f in enumerate(flags):
            if f and i - last > 4:
                out.append(True)
                last = i
            else:
                out.append(False)
        return out
