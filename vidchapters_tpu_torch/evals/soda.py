"""SODA: Story-Oriented Dense-video-captioning evaluation.

Behavioral port of the reference SODA-c (dvc_eval/SODA/soda.py:15-188,
dataset.py:8-118): predictions and ground truths are sorted by start time,
PTB-tokenized, an IoU x METEOR score matrix is built (with the reference's
argument orientation: METEOR hypothesis = GT sentence, reference = predicted
sentence — soda.py:63-68 via the pycocoevalcap wrapper's (gts, res) order),
and the optimal *order-preserving* event alignment is found by dynamic
programming. Precision = max_score / n_pred, recall = max_score / n_gt,
reported as F1 averaged over videos and references.

The reference's recursive DP overflows Python's stack on long videos and is
silently scored 0 (soda.py:101-104); here the DP is iterative, so long
chapter lists are scored correctly — a strict improvement with identical
semantics on non-overflowing inputs.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from vidchapters_tpu_torch.evals.dvc import remove_nonascii
from vidchapters_tpu_torch.evals.meteor import Meteor
from vidchapters_tpu_torch.evals.ptb import PTBTokenizer


def soda_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU with the SODA union convention (SODA/utils.py:4-14)."""
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]), (a[1] - a[0]) + (b[1] - b[0]))
    return inter / (union + 1e-8)


def chased_dp_assignment(scores: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
    """Max-score monotone assignment, iterative DP.

    Recurrence (soda.py:151-175):
    ``dp[i,j] = max(dp[i-1,j], dp[i,j-1], dp[i-1,j-1] + scores[i,j])``.
    Returns (max score, matched (row, col) pairs).
    """
    M, N = scores.shape
    dp = np.full((M, N), -np.inf)
    path = np.zeros((M, N), dtype=np.int8)  # 0: up, 1: left, 2: diag-take
    for i in range(M):
        for j in range(N):
            up = dp[i - 1, j] if i > 0 else -1.0
            left = dp[i, j - 1] if j > 0 else -1.0
            diag = (dp[i - 1, j - 1] if (i > 0 and j > 0) else 0.0) + scores[i, j]
            if i == 0 and j == 0:
                state = (-1.0, -1.0, scores[i, j])
            elif i == 0:
                state = (-1.0, left, scores[i, j])
            elif j == 0:
                state = (up, -1.0, scores[i, j])
            else:
                state = (up, left, diag)
            k = int(np.argmax(state))
            dp[i, j] = state[k]
            path[i, j] = k
    # backtrack: pairs are the diagonal "take" cells along the optimal path
    pairs: List[Tuple[int, int]] = []
    i, j = M - 1, N - 1
    while True:
        taken = np.where(path[i, : j + 1] == 2)[0]
        if i != 0 and len(taken) == 0:
            i -= 1
            continue
        if i == 0 and len(taken) == 0:
            break
        jj = int(taken[-1])
        pairs.insert(0, (i, jj))
        if i == 0 or jj == 0:
            break
        i, j = i - 1, jj - 1
    return float(dp[M - 1, N - 1]), pairs


def _load(obj: Union[str, dict]) -> dict:
    if isinstance(obj, dict):
        return obj
    with open(obj) as f:
        return json.load(f)


class SODAEvaluator:
    def __init__(self, scorer: Meteor | None = None):
        self.scorer = scorer or Meteor()
        self.tokenizer = PTBTokenizer()

    def _tokenize_sents(self, sents: Sequence[str]) -> List[str]:
        d = {i: [{"caption": remove_nonascii(s)}] for i, s in enumerate(sents)}
        tok = self.tokenizer.tokenize(d)
        return [tok[i][0] for i in range(len(sents))]

    def _score_matrix(self, pred_sents: List[str], gold_sents: List[str]) -> np.ndarray:
        """[n_gold, n_pred] matrix; orientation matches soda.py:63-68 —
        hypothesis = gold sentence, reference = prediction."""
        rows = []
        for g in gold_sents:
            res = {i: [g] for i in range(len(pred_sents))}
            gts = {i: [p] for i, p in enumerate(pred_sents)}
            _, seg = self.scorer.compute_score(gts, res)
            rows.append(seg)
        return np.array(rows)

    @staticmethod
    def _assignment_score(iou_m: np.ndarray, score_m: np.ndarray,
                          soda_type: str) -> float:
        """One (pred, gt) matrix pair -> optimal alignment score
        (soda.py:130-149): a/b = DP on IoU, sum of caption scores at the
        matched pairs; c = DP on IoU x score; d = DP value on IoU alone."""
        if soda_type == "c":
            max_score, _ = chased_dp_assignment(iou_m * score_m)
            return max_score
        max_score, pairs = chased_dp_assignment(iou_m)
        if soda_type == "d":
            return max_score
        if not pairs:
            return 0.0
        rows, cols = zip(*pairs)
        return float(score_m[list(rows), list(cols)].sum())

    def evaluate(
        self,
        predictions: Dict[str, List[dict]],
        ground_truths: List[dict],
        gt_vids: Sequence[str],
        soda_type: str = "c",
        tious: Optional[Sequence[float]] = None,
    ) -> Dict[str, List[float]]:
        """SODA types a/b/c/d (soda.py:30-45): "a" averages F over the given
        tIoU thresholds (IoU below threshold zeroed); "b"/"c"/"d" use a
        single 0.0 threshold."""
        tious = list(tious) if tious is not None else [0.0]
        n_t = len(tious)
        p_best = [[] for _ in range(n_t)]
        r_best = [[] for _ in range(n_t)]
        f_best = [[] for _ in range(n_t)]
        for vid in gt_vids:
            props = sorted(predictions.get(vid, []), key=lambda x: x["timestamp"][0])
            pred_ts = [p["timestamp"] for p in props]
            pred_sents = self._tokenize_sents([p["sentence"] for p in props])
            if not pred_sents:
                for i in range(n_t):
                    p_best[i].append(0.0)
                    r_best[i].append(0.0)
                    f_best[i].append(0.0)
                continue
            cand = [[] for _ in range(n_t)]
            for gt in ground_truths:
                if vid not in gt:
                    continue
                gold = gt[vid]
                order = sorted(range(len(gold["timestamps"])),
                               key=lambda k: gold["timestamps"][k][0])
                gold_ts = [gold["timestamps"][k] for k in order]
                gold_sents = self._tokenize_sents([gold["sentences"][k] for k in order])
                iou_m = np.array([[soda_iou(p, g) for p in pred_ts] for g in gold_ts])
                score_m = (self._score_matrix(pred_sents, gold_sents)
                           if soda_type != "d" else np.zeros_like(iou_m))
                for i, t in enumerate(tious):
                    iou_t = np.where(iou_m >= t, iou_m, 0.0)
                    max_score = self._assignment_score(iou_t, score_m, soda_type)
                    n_g, n_p = iou_m.shape
                    p = max_score / n_p
                    r = max_score / n_g
                    f = 2 * p * r / (p + r) if p + r > 0 else 0.0
                    cand[i].append((p, r, f))
            for i in range(n_t):
                best = max(cand[i], key=lambda x: x[2]) if cand[i] else (0.0, 0.0, 0.0)
                p_best[i].append(best[0])
                r_best[i].append(best[1])
                f_best[i].append(best[2])
        return {
            "precision": float(np.mean([np.mean(x) for x in p_best])),
            "recall": float(np.mean([np.mean(x) for x in r_best])),
            "f1": float(np.mean([np.mean(x) for x in f_best])),
        }


def eval_soda(
    submission: Union[str, dict],
    references: Sequence[Union[str, dict]],
    verbose: bool = False,
) -> Dict[str, float]:
    """Top-level API matching dvc_eval.eval_soda (dvc_eval/eval_soda.py:36-44):
    SODA-c per reference file, averaged; returns {"soda_c": f1}."""
    del verbose
    sub = _load(submission)["results"]
    evaluator = SODAEvaluator()
    f_scores = []
    for ref in references:
        gt = _load(ref)
        gt_vids = [v for v in gt.keys() if v in sub]
        result = evaluator.evaluate(sub, [gt], gt_vids)
        f_scores.append(result["f1"])
    return {"soda_c": float(np.mean(f_scores)) if f_scores else 0.0}
