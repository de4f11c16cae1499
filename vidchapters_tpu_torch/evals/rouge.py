"""ROUGE-L (LCS F-measure, beta=1.2) matching pycocoevalcap's Rouge.

Used by the tIoU-matched DVC evaluator (dvc_eval/eval_dvc.py:23,69) and the
GT-boundary captioning evaluator (eval_vc.py:41).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r = max(prec, default=0.0), max(rec, default=0.0)
        if p != 0 and r != 0:
            return ((1 + self.beta ** 2) * p * r) / (r + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        ids = sorted(gts.keys(), key=str)
        scores = [self.calc_score(res[i], gts[i]) for i in ids]
        return float(np.mean(scores)), np.array(scores)
