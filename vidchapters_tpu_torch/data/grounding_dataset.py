"""Chapter-grounding dataset (Moment-DETR StartEndDataset equivalent).

Reproduces moment_detr/moment_detr/start_end_dataset.py:18-318 on numpy with
static shapes: jsonl entries ``{qid, query, vid, duration, relevant_windows}``,
multi-query training sampling (112-115), optional ``[::clip_len]`` feature
downsampling + max_v_l truncation (265-266), l2 normalization, TEF
(temporal endpoint feature) concatenation (130-138), span labels in
normalized (center, width) over ``ctx_l * clip_len`` (215-228), "sub as
query" saliency pos/neg clip sampling used by the chapters recipe (150-173),
and ASR speech strings with quantized "st to ed text" prefixes (90-106).

Text is returned as raw query strings: the CLIP tokenizer step
(prepare_batch_inputs, 299-306) is the caller's job (models.clip tokenizer
or precomputed text features). The port's own copy of
``vidchapters_tpu/data/grounding_dataset.py``, changed only in its imports:
the same seeded ``default_rng`` draws in the same order give the same
examples.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from vidchapters_tpu_torch.utils.io import load_jsonl


def l2_normalize(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def span_xx_to_cxw_np(xx: np.ndarray) -> np.ndarray:
    return np.stack([xx.sum(-1) * 0.5, xx[..., 1] - xx[..., 0]], axis=-1)


class GroundingDataset:
    def __init__(self, data_path: str, v_feat_dirs: Sequence[str],
                 train: bool = True, max_v_l: int = 1200, clip_len: float = 3,
                 downsample: bool = True, max_windows: int = 5,
                 normalize_v: bool = True, use_tef: bool = True,
                 subtitles_path: Optional[str] = None,
                 use_speech: bool = False,
                 use_speech_time: bool = True,
                 q_feat_dir: Optional[str] = None, max_q_l: int = 32,
                 normalize_t: bool = True,
                 seed: int = 0):
        """``q_feat_dir``: precomputed token-level query features
        (``qid{qid}.npz['last_hidden_state']``, truncated to ``max_q_l`` and
        l2-normalized — start_end_dataset.py:229-240); when unset, raw query
        strings pass through for a live text tower. ``use_speech`` emits the
        quantized-time ASR string per example (start_end_dataset.py:119-122)
        for the caller's BERT tokenizer/tower."""
        self.data = load_jsonl(data_path) if isinstance(data_path, str) else data_path
        self.v_feat_dirs = list(v_feat_dirs)
        self.train = train
        self.max_v_l = max_v_l
        self.clip_len = clip_len
        self.downsample = downsample
        self.max_windows = max_windows
        self.normalize_v = normalize_v
        self.use_tef = use_tef
        self.use_speech = use_speech
        self.use_speech_time = use_speech_time
        self.q_feat_dir = q_feat_dir
        self.max_q_l = max_q_l
        self.normalize_t = normalize_t
        self.subs = None
        self.subs_path = None
        if subtitles_path and os.path.isdir(subtitles_path):
            self.subs_path = subtitles_path
        elif subtitles_path and os.path.exists(subtitles_path):
            with open(subtitles_path, "rb") as f:
                self.subs = pickle.load(f)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.data)

    # -- speech -------------------------------------------------------------

    def load_speech(self, vid: str, duration: float) -> str:
        key = vid[-11:]
        sub = None
        if self.subs is not None and key in self.subs:
            sub = self.subs[key]
        elif self.subs_path is not None:
            path = os.path.join(self.subs_path, key + ".pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sub = pickle.load(f)
        if sub is None:
            return ""
        if not self.use_speech_time:
            return " ".join(sub["text"])
        st = [min(int(100 * s / duration), 100) for s in sub["start"]]
        ed = [min(int(100 * e / duration), 100) for e in sub["end"]]
        return " ".join(f"{s} to {e} {t}" for s, e, t in zip(st, ed, sub["text"]))

    # -- features -----------------------------------------------------------

    def _video_feat(self, vid: str) -> np.ndarray:
        key = vid[-11:]
        feats = []
        for d in self.v_feat_dirs:
            path = os.path.join(d, f"{key}.mp4.npy")
            if not os.path.exists(path):
                path = os.path.join(d, f"{key}.npy")
            f = np.load(path)
            if self.downsample:
                f = f[:: int(self.clip_len)]
            f = f[: self.max_v_l].astype(np.float32)
            if self.normalize_v:
                f = l2_normalize(f)
            feats.append(f)
        min_len = min(len(f) for f in feats)
        return np.concatenate([f[:min_len] for f in feats], axis=1)

    def _query_feat(self, qid) -> np.ndarray:
        """Precomputed token-level query features, truncated to ``max_q_l``
        and l2-normalized (start_end_dataset.py:229-240)."""
        path = os.path.join(self.q_feat_dir, f"qid{qid}.npz")
        q = np.load(path)["last_hidden_state"].astype(np.float32)
        q = q[: self.max_q_l]
        if self.normalize_t:
            q = l2_normalize(q)
        return q

    # -- labels -------------------------------------------------------------

    def span_labels(self, windows: List[List[float]], ctx_l: int) -> np.ndarray:
        windows = list(windows)
        if len(windows) > self.max_windows:
            self.rng.shuffle(windows)
            windows = windows[: self.max_windows]
        xx = np.asarray(windows, np.float32) / (ctx_l * self.clip_len)
        return span_xx_to_cxw_np(xx)

    def saliency_sub_as_query(self, gt_window, ctx_l: int, max_n: int = 2):
        gt_st = int(gt_window[0] / self.clip_len)
        gt_ed = max(0, min(int(gt_window[1] / self.clip_len), ctx_l) - 1)
        gt_st = min(gt_st, gt_ed)
        if gt_st != gt_ed:
            pos = self.rng.choice(np.arange(gt_st, gt_ed + 1), size=max_n,
                                  replace=False).tolist()
        else:
            pos = [gt_st, gt_st]
        neg_pool = list(range(0, gt_st)) + list(range(gt_ed + 1, ctx_l))
        if len(neg_pool) >= max_n:
            neg = self.rng.choice(np.asarray(neg_pool), size=max_n,
                                  replace=False).tolist()
        elif ctx_l >= max_n:
            neg = self.rng.choice(np.arange(ctx_l), size=max_n,
                                  replace=False).tolist()
        else:
            neg = [0] * max_n
        return pos, neg

    # -- examples -----------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        meta = dict(self.data[index])
        if isinstance(meta["query"], list):  # multi-query-per-video sampling
            idx = int(self.rng.integers(len(meta["query"]))) if self.train else 0
            meta["query"] = meta["query"][idx]
            meta["relevant_windows"] = meta["relevant_windows"][idx]
        feat = self._video_feat(meta["vid"])
        ctx_l = len(feat)
        if self.use_tef:
            tef_st = np.arange(ctx_l, dtype=np.float32) / ctx_l
            tef = np.stack([tef_st, tef_st + 1.0 / ctx_l], axis=1)
            feat = np.concatenate([feat, tef], axis=1)
        out = {
            "qid": meta["qid"],
            "vid": meta["vid"],
            "query": meta["query"],
            "duration": float(meta["duration"]),
            "video_feat": feat,
            "ctx_l": ctx_l,
            "spans": self.span_labels(meta["relevant_windows"], ctx_l),
        }
        pos, neg = self.saliency_sub_as_query(meta["relevant_windows"][0], ctx_l)
        out["saliency_pos"] = np.asarray(pos, np.int64)
        out["saliency_neg"] = np.asarray(neg, np.int64)
        if self.q_feat_dir is not None:
            out["query_feat"] = self._query_feat(meta["qid"])
        if self.use_speech:
            out["speech"] = self.load_speech(meta["vid"],
                                             float(meta["duration"]))
        return out


def grounding_collate(examples: List[dict], max_v_l: int,
                      max_spans: int = 5,
                      max_q_l: int = 32) -> Dict[str, np.ndarray]:
    """Static-shape batch: video features padded to max_v_l, spans padded to
    max_spans with validity mask. Query strings pass through for the text
    encoder; precomputed ``query_feat`` rows pad to ``max_q_l`` with a mask,
    and ASR ``speech`` strings pass through for the speech tokenizer."""
    b = len(examples)
    d = examples[0]["video_feat"].shape[1]
    vid = np.zeros((b, max_v_l, d), np.float32)
    vid_mask = np.zeros((b, max_v_l), np.int32)
    spans = np.zeros((b, max_spans, 2), np.float32)
    span_valid = np.zeros((b, max_spans), np.int32)
    pos = np.zeros((b, examples[0]["saliency_pos"].shape[0]), np.int64)
    neg = np.zeros_like(pos)
    for i, e in enumerate(examples):
        t = min(len(e["video_feat"]), max_v_l)
        vid[i, :t] = e["video_feat"][:t]
        vid_mask[i, :t] = 1
        n = min(len(e["spans"]), max_spans)
        spans[i, :n] = e["spans"][:n]
        span_valid[i, :n] = 1
        pos[i] = e["saliency_pos"]
        neg[i] = e["saliency_neg"]
    batch = {
        "video_feat": vid,
        "video_mask": vid_mask,
        "spans": spans,
        "span_valid": span_valid,
        "saliency_pos_labels": pos,
        "saliency_neg_labels": neg,
        "qid": [e["qid"] for e in examples],
        "vid": [e["vid"] for e in examples],
        "query": [e["query"] for e in examples],
        "duration": np.asarray([e["duration"] for e in examples], np.float32),
        "ctx_l": np.asarray([e["ctx_l"] for e in examples], np.int32),
    }
    if "query_feat" in examples[0]:
        dq = examples[0]["query_feat"].shape[1]
        qf = np.zeros((b, max_q_l, dq), np.float32)
        qm = np.zeros((b, max_q_l), np.int32)
        for i, e in enumerate(examples):
            n = min(len(e["query_feat"]), max_q_l)
            qf[i, :n] = e["query_feat"][:n]
            qm[i, :n] = 1
        batch["query_feat"], batch["query_mask"] = qf, qm
    if "speech" in examples[0]:
        batch["speech"] = [e["speech"] for e in examples]
    return batch
