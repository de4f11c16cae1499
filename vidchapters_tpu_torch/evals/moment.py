"""Moment-retrieval / chapter-grounding evaluation.

Behavioral port of moment_detr/standalone_eval/eval.py + utils.py:

- MR mAP over tIoU thresholds 0.5:0.05:0.95, VOC-style detection AP with
  per-GT locking (utils.py:85-166), top-10 predicted windows per query;
- MR R@1 at tIoU in {0.3..0.95} and at start-distance {1,3,5,10}s — the GT
  window compared against is the one with max IoU vs the top prediction
  (eval.py:72-100); R@10s is the VidChapters grounding headline metric;
- length-range breakdown (short/middle/long/full, eval.py:106-163);
- highlight HIT@1 / mAP from saliency scores (eval.py:165-257).

Pure numpy, sequential (the reference shells out to a multiprocessing pool;
per-query AP here is vectorized enough not to need one). The port's own
copy of ``vidchapters_tpu/evals/moment.py``.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np


def temporal_iou_paired(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Row-wise IoU of [N,2] vs [N,2] (utils.py:15-31 — note the reference's
    'union' here is the enclosing hull, reproduced for parity)."""
    inter = np.maximum(
        0, np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0]))
    union = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    return np.divide(inter, union, out=np.zeros_like(inter, dtype=float),
                     where=union != 0)


def temporal_iou_cross(spans1: np.ndarray, spans2: np.ndarray) -> np.ndarray:
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]
    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def _interpolated_pr_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC2011 interpolated AP (utils.py:66-82)."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def detection_ap(gt_windows: np.ndarray, pred_windows: np.ndarray,
                 pred_scores: np.ndarray,
                 tiou_thresholds: Sequence[float]) -> np.ndarray:
    """Per-threshold AP for one query's windows (utils.py:85-166)."""
    n_thds = len(tiou_thresholds)
    ap = np.zeros(n_thds)
    if len(pred_windows) == 0:
        return ap
    n_gts = len(gt_windows)
    order = np.argsort(-pred_scores)
    pred_windows = pred_windows[order]
    tp = np.zeros((n_thds, len(pred_windows)))
    fp = np.zeros((n_thds, len(pred_windows)))
    lock = np.full((n_thds, max(n_gts, 1)), -1)
    for idx, w in enumerate(pred_windows):
        if n_gts == 0:
            fp[:, idx] = 1
            continue
        ious = temporal_iou_cross(w[None, :], gt_windows)[0]
        by_iou = np.argsort(-ious)
        for t, thd in enumerate(tiou_thresholds):
            assigned = False
            for j in by_iou:
                if ious[j] < thd:
                    fp[t, idx] = 1
                    assigned = True
                    break
                if lock[t, j] >= 0:
                    continue
                tp[t, idx] = 1
                lock[t, j] = idx
                assigned = True
                break
            if not assigned:
                fp[t, idx] = 1
    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    recall = tp_cum / max(float(n_gts), 1.0)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for t in range(n_thds):
        ap[t] = _interpolated_pr_ap(precision[t], recall[t])
    return ap


def compute_mr_ap(submission: List[dict], ground_truth: List[dict],
                  iou_thds: Optional[Sequence[float]] = None,
                  max_pred_windows: Optional[int] = 10) -> Dict[str, float]:
    iou_thds = [round(float(t), 2) for t in
                (iou_thds if iou_thds is not None else np.linspace(0.5, 0.95, 10))]
    gt_by_qid = {d["qid"]: np.array([w[:2] for w in d["relevant_windows"]],
                                    dtype=float)
                 for d in ground_truth}
    ap_rows = []
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        pw = np.array([w[:2] for w in windows], dtype=float).reshape(-1, 2)
        ps = np.array([w[2] if len(w) > 2 else 1.0 for w in windows], dtype=float)
        gt = gt_by_qid.get(d["qid"], np.zeros((0, 2)))
        ap_rows.append(detection_ap(gt, pw, ps, iou_thds))
    ap = np.mean(ap_rows, axis=0) if ap_rows else np.zeros(len(iou_thds))
    out = {str(t): float(f"{100 * v:.2f}") for t, v in zip(iou_thds, ap)}
    out["average"] = float(f"{100 * np.mean(ap):.2f}")
    return out


def compute_mr_r1(submission: List[dict], ground_truth: List[dict],
                  iou_thds: Optional[Sequence[float]] = None,
                  dists: Sequence[float] = (1, 3, 5, 10)) -> Dict[str, float]:
    iou_thds = [round(float(t), 2) for t in
                (iou_thds if iou_thds is not None else np.linspace(0.3, 0.95, 14))]
    pred_by_qid = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_window = {}
    for d in ground_truth:
        if d["qid"] not in pred_by_qid:
            continue
        windows = d["relevant_windows"]
        best = 0
        if len(windows) > 0:
            ious = temporal_iou_cross(
                np.array([pred_by_qid[d["qid"]]], dtype=float),
                np.array(windows, dtype=float))[0]
            best = int(np.argmax(ious))
        gt_window[d["qid"]] = windows[best]
    qids = list(pred_by_qid.keys())
    pred = np.array([pred_by_qid[q] for q in qids], dtype=float)
    gt = np.array([gt_window[q] for q in qids], dtype=float)
    iou = temporal_iou_paired(pred, gt)
    out = {}
    for t in iou_thds:
        out[str(t)] = float(f"{np.mean(iou >= t) * 100:.2f}")
    for dist in dists:
        out[f"{dist}s"] = float(
            f"{np.mean(np.abs(pred[:, 0] - gt[:, 0]) <= dist) * 100:.2f}")
    return out


def _filter_by_length(submission, ground_truth, len_range, full_range):
    min_l, max_l = len_range
    if list(len_range) == list(full_range):
        return submission, ground_truth
    gts = []
    qids = set()
    for d in ground_truth:
        wins = [w for w in d["relevant_windows"] if min_l < (w[1] - w[0]) <= max_l]
        if wins:
            d = copy.deepcopy(d)
            d["relevant_windows"] = wins
            gts.append(d)
            qids.add(d["qid"])
    subs = [copy.deepcopy(d) for d in submission if d["qid"] in qids]
    return subs, gts


def eval_moment_retrieval(submission: List[dict], ground_truth: List[dict],
                          dataset: str = "chapters") -> Dict[str, dict]:
    if dataset == "charades":
        ranges = [(0, 10), (10, 30), (0, 150)]
        names = ["short", "middle", "full"]
    elif dataset == "activitynet":
        ranges = [(0, 30), (30, 60), (60, 800), (0, 800)]
        names = ["short", "middle", "long", "full"]
    else:  # chapters / hl use the long-video ranges (eval.py:147)
        ranges = [(0, 60), (60, 180), (180, 3600), (0, 3600)]
        names = ["short", "middle", "long", "full"]
    full_range = ranges[-1]
    out = {}
    for rng, name in zip(ranges, names):
        subs, gts = _filter_by_length(submission, ground_truth, rng, full_range)
        if not subs:
            out[name] = {"MR-mAP": {"average": 0.0}, "MR-R1": {}}
            continue
        out[name] = {"MR-mAP": compute_mr_ap(subs, gts),
                     "MR-R1": compute_mr_r1(subs, gts)}
    return out


# ---------------------------------------------------------------------------
# Highlight detection (saliency)
# ---------------------------------------------------------------------------


def _ap_binary(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Interpolated AP over a binary relevance vector — exact semantics of
    the reference's get_ap(interpolate=True, point_11=False)
    (utils.py:169-209), which builds an sklearn precision_recall_curve
    (tied scores grouped into one threshold point, flat tail after full
    recall truncated, (p=1, r=0) endpoint appended), forward-interpolates
    precision in decreasing-recall order, and averages precision at every
    recall change. Differs from the sum/n_pos VOC form when scores tie."""
    y_true = np.asarray(y_true, dtype=float)
    y_score = np.asarray(y_score, dtype=float)
    uniq = np.unique(y_true)
    if len(uniq) == 1:
        return 0.0 if uniq[0] == 0 else 1.0
    desc = np.argsort(-y_score, kind="stable")
    y = y_true[desc]
    s = y_score[desc]
    thr_idx = np.r_[np.where(np.diff(s) != 0)[0], y.size - 1]
    tps = np.cumsum(y)[thr_idx]
    fps = 1 + thr_idx - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    # sklearn keeps the curve up to the FIRST point of full recall
    # (slice(tps.searchsorted(tps[-1]), None, -1)) and reverses it
    cut = int(np.searchsorted(tps, tps[-1]))
    precision = np.r_[precision[:cut + 1][::-1], 1.0]
    recall = np.r_[recall[:cut + 1][::-1], 0.0]
    precision = np.maximum.accumulate(precision)
    idx = np.where(np.diff(recall) != 0)[0]
    return float(np.mean(precision[idx]))


def mk_gt_scores(gt_data: dict, clip_length: float = 2) -> np.ndarray:
    num_clips = int(gt_data["duration"] / clip_length)
    scores = np.zeros((num_clips, 3))
    ids = np.array(gt_data["relevant_clip_ids"])
    scores[ids] = np.array(gt_data["saliency_scores"])
    return scores


def eval_highlight(submission: List[dict], ground_truth: List[dict]) -> Dict[str, dict]:
    preds = {d["qid"]: d for d in submission}
    gt_full = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    out = {}
    for min_score, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        binary = {k: (v >= min_score).astype(float) for k, v in gt_full.items()}
        hits, aps = [], []
        for qid, d in preds.items():
            scores = np.asarray(d["pred_saliency_scores"], dtype=float)
            gt = binary[qid]
            best = int(np.argmax(scores))
            hits.append(gt[best] if best < len(gt) else np.zeros(3))
            for w in range(3):
                y_pred = scores[:len(gt)]
                if len(y_pred) < len(gt):
                    y_pred = np.pad(y_pred, (0, len(gt) - len(y_pred)))
                aps.append(_ap_binary(gt[:, w], y_pred))
        hit1 = float(f"{100 * np.mean(np.max(hits, axis=1)):.2f}")
        mean_ap = float(f"{100 * np.mean(aps):.2f}")
        out[f"HL-min-{name}"] = {"HL-mAP": mean_ap, "HL-Hit1": hit1}
    return out


def eval_submission(submission: List[dict], ground_truth: List[dict],
                    match_number: bool = True,
                    dataset: str = "chapters") -> Dict[str, dict]:
    """Top-level API matching standalone_eval.eval.eval_submission
    (eval.py:259-341): returns {"brief": {...}, <section>: {...}}."""
    pred_qids = {d["qid"] for d in submission}
    gt_qids = {d["qid"] for d in ground_truth}
    if match_number:
        assert pred_qids == gt_qids, "qids mismatch; pass match_number=False"
    else:
        shared = pred_qids & gt_qids
        submission = [d for d in submission if d["qid"] in shared]
        ground_truth = [d for d in ground_truth if d["qid"] in shared]

    metrics: Dict[str, dict] = {}
    brief: "OrderedDict[str, float]" = OrderedDict()
    if submission and "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth, dataset=dataset)
        metrics.update(mr)
        b = {
            "MR-full-mAP": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"].get("0.5", 0.0),
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"].get("0.75", 0.0),
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr.get("long", {}).get("MR-mAP", {}).get("average", 0.0),
        }
        for key in ("0.3", "0.5", "0.7", "0.9", "1s", "3s", "5s", "10s"):
            if key in mr["full"]["MR-R1"]:
                b[f"MR-full-R1@{key}"] = mr["full"]["MR-R1"][key]
        brief.update(sorted(b.items()))
    if submission and "pred_saliency_scores" in submission[0] and dataset == "hl":
        hl = eval_highlight(submission, ground_truth)
        metrics.update(hl)
        brief.update({f"{k}-{sk.split('-')[1]}": v[sk]
                      for k, v in hl.items() for sk in v})
    final: "OrderedDict[str, dict]" = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items()))
    return final
