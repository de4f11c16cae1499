"""CIDEr consensus metric, matching the reference's vendored scorer.

Semantics (dvc_eval/pycocoevalcap/cider/cider_scorer.py): per-order TF-IDF
vectors with document frequency computed over the *reference corpus of the
current compute_score call* (so the DVC evaluator's per-video calls get
per-video IDF, eval_dvc.py:293), clipped cosine similarity, Gaussian length
penalty (sigma=6), mean over n-gram orders 1..4, average over references,
x10 scaling, ``ref_len = log(#images)``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        ids = sorted(gts.keys(), key=str)
        crefs = [[_ngram_counts(r.split(), self.n) for r in gts[i]] for i in ids]
        ctest = [_ngram_counts(res[i][0].split(), self.n) for i in ids]

        # document frequency over reference sets
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                doc_freq[ngram] += 1
        ref_len = np.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * (ref_len - df)
                norm[k] += vec[k][ngram] ** 2
                if k == 1:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r):
            delta = float(len_h - len_r)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ngram, w in vec_h[k].items():
                    val[k] += min(w, vec_r[k][ngram]) * vec_r[k][ngram]
                if norm_h[k] != 0 and norm_r[k] != 0:
                    val[k] /= norm_h[k] * norm_r[k]
                val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = counts2vec(ref)
                score += sim(vec, vec_r, norm, norm_r, length, len_r)
            score_avg = float(np.mean(score)) / len(refs) * 10.0
            scores.append(score_avg)
        arr = np.array(scores)
        return float(np.mean(arr)), arr
