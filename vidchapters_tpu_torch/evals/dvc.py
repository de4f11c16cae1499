"""tIoU-matched dense-video-captioning evaluation (ANET-captions style).

Behavioral port of the reference evaluator (dvc_eval/eval_dvc.py:38-334):

- for each tIoU in {0.3,0.5,0.7,0.9}, every predicted caption is paired with
  every GT caption whose segment IoU >= tIoU; unmatched predictions are scored
  against a random garbage string (eval_dvc.py:258-262) as a matching control;
- METEOR/CIDEr/ROUGE-L/BLEU are computed per-video over that video's pairs
  (per-video CIDEr document frequencies, eval_dvc.py:293), averaged over
  videos, then averaged across tIoUs;
- detection precision/recall/F1 at each tIoU (any-overlap set coverage,
  eval_dvc.py:145-178) and "navigation" P/R/F1 at start-time distances
  {1,3,5,10,30,60}s (eval_dvc.py:180-213).

Output keys match the reference (``eval_dvc`` return dict, eval_dvc.py:311-334).
"""

from __future__ import annotations

import json
import random
import string
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from vidchapters_tpu_torch.evals.bleu import Bleu
from vidchapters_tpu_torch.evals.cider import Cider
from vidchapters_tpu_torch.evals.meteor import Meteor
from vidchapters_tpu_torch.evals.ptb import PTBTokenizer
from vidchapters_tpu_torch.evals.rouge import Rouge


def segment_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """Temporal IoU with the reference's union convention (eval_dvc.py:99-105)."""
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]),
                (a[1] - a[0]) + (b[1] - b[0]))
    return float(inter) / (union + 1e-8)


def _random_garbage(rng: random.Random) -> str:
    return "".join(rng.choice(string.ascii_lowercase)
                   for _ in range(rng.randint(10, 20)))


def remove_nonascii(text: str) -> str:
    return "".join(c if ord(c) < 128 else " " for c in text)


def _load(obj: Union[str, dict]) -> dict:
    if isinstance(obj, dict):
        return obj
    with open(obj) as f:
        return json.load(f)


class DVCEvaluator:
    def __init__(
        self,
        ground_truths: List[dict],
        predictions: Dict[str, List[dict]],
        tious: Sequence[float],
        distances: Sequence[float] = (1, 3, 5, 10, 30, 60),
        max_proposals: int = 1000,
        no_lang_eval: bool = False,
        seed: Optional[int] = None,
        version: str = "2021",
    ):
        self.gts = ground_truths
        self.preds = {vid: props[:max_proposals] for vid, props in predictions.items()}
        self.tious = list(tious)
        self.distances = list(distances)
        self.no_lang_eval = no_lang_eval
        # densevid_eval3 carries both scorer generations: the 2018 variant
        # uses a fixed garbage string and no navigation metrics
        # (evaluate2018.py vs evaluate2021.py)
        self.version = version
        if version == "2018":
            self.distances = []
        self.rng = random.Random(seed)
        self.tokenizer = PTBTokenizer()
        self.scorers = [
            (Meteor(), "METEOR"),
            (Cider(), "CIDEr"),
            (Rouge(), "Rouge-L"),
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        ]

    def _gt_vid_ids(self) -> List[str]:
        ids = set()
        for gt in self.gts:
            ids |= set(gt.keys())
        return list(ids)

    # -- localization P/R/F1 --------------------------------------------------

    def _coverage(self, match_fn) -> Tuple[float, float]:
        precisions, recalls = [], []
        for vid in self._gt_vid_ids():
            if vid not in self.preds:
                continue
            best_p = best_r = 0.0
            for gt in self.gts:
                if vid not in gt:
                    continue
                refs = gt[vid]["timestamps"]
                covered_refs, covered_preds = set(), set()
                for pi, pred in enumerate(self.preds[vid]):
                    for ri, ref_ts in enumerate(refs):
                        if match_fn(pred["timestamp"], ref_ts):
                            covered_refs.add(ri)
                            covered_preds.add(pi)
                best_p = max(best_p, len(covered_preds) / max(len(self.preds[vid]), 1))
                best_r = max(best_r, len(covered_refs) / len(refs))
            precisions.append(best_p)
            recalls.append(best_r)
        if not precisions:
            return 0.0, 0.0
        return float(np.mean(precisions)), float(np.mean(recalls))

    def detection_pr(self, tiou: float) -> Tuple[float, float]:
        return self._coverage(lambda p, r: segment_iou(p, r) > tiou)

    def navigation_pr(self, dist: float) -> Tuple[float, float]:
        return self._coverage(lambda p, r: abs(p[0] - r[0]) < dist)

    # -- tIoU-matched captioning ---------------------------------------------

    def captioning_at_tiou(self, tiou: float) -> Dict[str, float]:
        cur_res: Dict[int, List[dict]] = {}
        cur_gts: Dict[int, List[dict]] = {}
        vid2capid: Dict[str, List[int]] = {}
        uid = 0
        for vid in self._gt_vid_ids():
            if vid not in self.preds:
                continue
            vid2capid[vid] = []
            for pred in self.preds[vid]:
                added = False
                for gt in self.gts:
                    if vid not in gt:
                        continue
                    for ci, ts in enumerate(gt[vid]["timestamps"]):
                        if segment_iou(pred["timestamp"], ts) >= tiou:
                            cur_res[uid] = [{"caption": remove_nonascii(pred["sentence"])}]
                            cur_gts[uid] = [{"caption": remove_nonascii(gt[vid]["sentences"][ci])}]
                            vid2capid[vid].append(uid)
                            uid += 1
                            added = True
                if not added:  # garbage-string control for unmatched preds
                    cur_res[uid] = [{"caption": remove_nonascii(pred["sentence"])}]
                    garbage = ("abc123!@#" if self.version == "2018"
                               else _random_garbage(self.rng))
                    cur_gts[uid] = [{"caption": garbage}]
                    vid2capid[vid].append(uid)
                    uid += 1

        tok_res = self.tokenizer.tokenize(cur_res)
        tok_gts = self.tokenizer.tokenize(cur_gts)

        output: Dict[str, float] = {}
        for scorer, method in self.scorers:
            all_scores = {}
            for vid, cap_ids in vid2capid.items():
                res_v = {i: tok_res[i] for i in cap_ids}
                gts_v = {i: tok_gts[i] for i in cap_ids}
                if not res_v or not gts_v:
                    score = [0] * len(method) if isinstance(method, list) else 0
                else:
                    score, _ = scorer.compute_score(gts_v, res_v)
                all_scores[vid] = score
            vals = list(all_scores.values())
            if isinstance(method, list):
                means = np.mean(vals, axis=0) if vals else np.zeros(len(method))
                for m, s in zip(method, means):
                    output[m] = float(s)
            else:
                output[method] = float(np.mean(vals)) if vals else 0.0
        return output

    def evaluate(self) -> Dict[str, List[float]]:
        scores: Dict[str, List[float]] = {}
        if not self.no_lang_eval:
            for tiou in self.tious:
                for metric, val in self.captioning_at_tiou(tiou).items():
                    scores.setdefault(metric, []).append(val)
        for key in ("Recall", "Precision", "F1"):
            scores[key] = []
        for tiou in self.tious:
            p, r = self.detection_pr(tiou)
            scores["Recall"].append(r)
            scores["Precision"].append(p)
            scores["F1"].append(2 * r * p / (r + p) if r + p else 0.0)
        for dist in self.distances:
            p, r = self.navigation_pr(dist)
            scores["Recall"].append(r)
            scores["Precision"].append(p)
            scores["F1"].append(2 * r * p / (r + p) if r + p else 0.0)
        return scores


def eval_dvc(
    submission: Union[str, dict],
    references: Sequence[Union[str, dict]],
    tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
    distances: Sequence[float] = (1, 3, 5, 10, 30, 60),
    max_proposals_per_video: int = 1000,
    verbose: bool = False,
    no_lang_eval: bool = False,
    seed: Optional[int] = None,
    version: str = "2021",
) -> Dict[str, float]:
    """Top-level API matching dvc_eval.eval_dvc (eval_dvc.py:311-334);
    ``version`` selects the densevid_eval3 2018/2021 scorer variants."""
    del verbose
    sub = _load(submission)
    gts = [_load(r) for r in references]
    if version == "2018":
        distances = ()
    evaluator = DVCEvaluator(gts, sub["results"], tious, distances,
                             max_proposals_per_video, no_lang_eval, seed,
                             version=version)
    score = evaluator.evaluate()

    out: Dict[str, float] = {}
    for key, values in score.items():
        if key not in ("Recall", "Precision", "F1"):
            out[key] = float(np.mean(values))
    for i, t in enumerate(tious):
        for y in ("Recall", "Precision", "F1"):
            out[f"{y}@{t}"] = score[y][i]
    for y in ("Recall", "Precision", "F1"):
        out[y] = float(np.mean([score[y][i] for i in range(len(tious))]))
    for i, d in enumerate(distances):
        for y in ("Recall", "Precision", "F1"):
            out[f"{y}@{d}s"] = score[y][len(tious) + i]
    return out
