"""Zero-shot video chapter grounding baselines (VCGR): the port's own copy
of ``vidchapters_tpu/zeroshot/grounding.py``.

Counterpart of zs_vcgr.py:20-300:

- CLIP: per-chapter-title text embedding vs per-frame features; the span
  starts at the argmax frame and extends right while similarity stays within
  ``threshold`` of the peak (plateau extension, zs_vcgr.py:284-295);
- BERT: title embedding vs ASR-line embeddings, predict the best line's
  [start, end] (268-282);
- random: a random ASR line, else a random window (257-266);
- metrics: per-(query, gt) Recall@tIoU and Recall@Xs (20-48).

Embedding computation is injected (models.clip / any text encoder) so the
span logic stays pure and testable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def iou(a: Sequence[float], b: Sequence[float]) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]),
                (a[1] - a[0]) + (b[1] - b[0]))
    return float(inter) / (union + 1e-8)


def evaluate_predictions(results: Dict[str, dict],
                         tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                         distances: Sequence[float] = (1, 3, 5, 10)
                         ) -> Dict[str, float]:
    """results[vid] = {"pred": [[s,e]...], "gt": [[s,e]...]} (paired)."""
    scores = {}
    pairs = [(p, g) for cur in results.values()
             for p, g in zip(cur["pred"], cur["gt"])]
    for t in tious:
        scores[f"Recall@{t}"] = float(np.mean([iou(p, g) > t for p, g in pairs]))
    for d in distances:
        scores[f"Recall@{d}s"] = float(np.mean(
            [abs(p[0] - g[0]) < d for p, g in pairs]))
    return scores


def l2n(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=axis, keepdims=True) + 1e-8)


def clip_grounding_spans(text_feats: np.ndarray, frame_feats: np.ndarray,
                         frame_times: Sequence[float], duration: float,
                         threshold: float = 0.05) -> List[List[float]]:
    """Plateau-extension span decoding (zs_vcgr.py:284-295).

    text_feats [N, D] (title embeddings), frame_feats [L, D],
    frame_times [L] (start second of each frame slot)."""
    sim = text_feats @ frame_feats.T  # [N, L]
    # reference normalizes the full sim matrix rows (F.normalize on N x L)
    sim = l2n(sim, axis=-1)
    max_feats = frame_feats.shape[0]
    spans = []
    for i in range(sim.shape[0]):
        start_idx = int(np.argmax(sim[i]))
        idx = start_idx + 1
        while idx < max_feats and sim[i, idx] >= sim[i, start_idx] - threshold:
            idx += 1
        end = float(frame_times[idx]) if idx < len(frame_times) else float(duration)
        spans.append([float(frame_times[start_idx]), end])
    return spans


def bert_grounding_spans(query_feats: np.ndarray, asr_feats: np.ndarray,
                         starts: Sequence[float], ends: Sequence[float]
                         ) -> List[List[float]]:
    """Best-ASR-line prediction (zs_vcgr.py:268-282)."""
    sim = l2n(query_feats @ asr_feats.T, axis=-1)
    best = np.argmax(sim, axis=1)
    return [[float(starts[j]), float(ends[j])] for j in best]


def random_grounding_spans(n_queries: int, duration: float,
                           starts: Optional[Sequence[float]] = None,
                           ends: Optional[Sequence[float]] = None,
                           rng: Optional[np.random.Generator] = None
                           ) -> List[List[float]]:
    rng = rng or np.random.default_rng()
    if starts is not None and len(starts):
        j = int(rng.integers(len(starts)))
        return [[float(starts[j]), float(ends[j])] for _ in range(n_queries)]
    s = float(rng.integers(0, max(int(duration), 1)))
    e = float(rng.integers(int(s), max(int(duration), int(s) + 1)))
    return [[s, e] for _ in range(n_queries)]
