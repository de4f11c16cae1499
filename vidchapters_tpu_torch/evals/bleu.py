"""Corpus BLEU with the pycocoevalcap smoothing/brevity conventions.

Reproduces the scoring math of the `bleu_scorer` used by the reference's
evaluators (dvc_eval/eval_dvc.py:22, eval_vc.py:2): clipped n-gram precision
with ``(correct + tiny) / (guess + small)`` stabilizers, "closest" reference
length for the corpus brevity penalty, and per-segment scores computed with
the segment-level ratio adjustment pycocoevalcap applies.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        assert gts.keys() == res.keys()
        ids = sorted(gts.keys(), key=str)
        small, tiny = 1e-9, 1e-15

        total_correct = [0] * self.n
        total_guess = [0] * self.n
        total_testlen = 0
        total_reflen = 0
        seg_scores: List[List[float]] = [[] for _ in range(self.n)]

        for i in ids:
            hyp = res[i][0].split()
            refs = [r.split() for r in gts[i]]
            testlen = len(hyp)
            # "closest" reference length (ties -> shorter)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1] if refs else 0

            hyp_counts = _ngram_counts(hyp, self.n)
            max_ref_counts: Dict[tuple, int] = defaultdict(int)
            for r in refs:
                for ng, c in _ngram_counts(r, self.n).items():
                    max_ref_counts[ng] = max(max_ref_counts[ng], c)

            correct = [0] * self.n
            guess = [0] * self.n
            for ng, c in hyp_counts.items():
                k = len(ng) - 1
                guess[k] += c
                correct[k] += min(c, max_ref_counts.get(ng, 0))
            # guess per order is max(0, len-k)
            total_testlen += testlen
            total_reflen += reflen
            for k in range(self.n):
                total_correct[k] += correct[k]
                total_guess[k] += max(0, testlen - k)

            # per-segment score (geometric mean up to each order, with the
            # segment-level brevity adjustment pycocoevalcap applies)
            logbleu = 0.0
            for k in range(self.n):
                g = max(0, testlen - k)
                logbleu += math.log(correct[k] + tiny) - math.log(g + small)
                avg = logbleu / (k + 1)
                score = math.exp(avg)
                ratio = (testlen + tiny) / (reflen + small)
                if ratio < 1.0:
                    score *= math.exp(1 - 1 / max(ratio, tiny))
                seg_scores[k].append(score)

        # corpus-level scores
        corpus: List[float] = []
        logbleu = 0.0
        ratio = (total_testlen + tiny) / (total_reflen + small)
        for k in range(self.n):
            logbleu += (math.log(total_correct[k] + tiny)
                        - math.log(total_guess[k] + small))
            score = math.exp(logbleu / (k + 1))
            if ratio < 1.0:
                score *= math.exp(1 - 1 / max(ratio, tiny))
            corpus.append(score)

        return corpus, seg_scores
