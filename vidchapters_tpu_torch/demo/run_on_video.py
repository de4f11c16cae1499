"""Moment localization on one raw video (the run_on_video demo).

Counterpart of ``vidchapters_tpu/demo/run_on_video.py`` (the reference's
moment_detr/run_on_video/run.py:12-80): extract CLIP features from the
video (ViT-B/32 at the demo's 1/clip_len FPS, run_on_video/data_utils.py:
9-49, through ``factory/features.CLIPFeatureExtractor``), l2-normalise them
and append the temporal endpoint features (TEF), encode the text queries
with the CLIP text tower, run Moment-DETR (``train/grounding_train.
make_grounding_infer``), and return moments ranked by score with per-clip
saliency scores.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class MomentDETRPredictor:
    """``grounding_model`` (the port's ``MomentDETR``) and ``text_encoder``
    (a ``CLIPTextEncoder``) hold their weights on the device they run on;
    ``clip_tokenizer`` maps a list of queries to [N, 77] token ids;
    ``feature_extractor`` maps [T, H, W, 3] frames to [T, D] features."""

    def __init__(self, grounding_model, text_encoder, clip_tokenizer,
                 feature_extractor=None, clip_len: float = 2.0, max_v_l: int = 75,
                 v_feat_dim: int = 514):
        from vidchapters_tpu_torch.train.grounding_train import make_grounding_infer

        self.model = grounding_model
        self.text_encoder = text_encoder
        self.tokenizer = clip_tokenizer
        self.extractor = feature_extractor
        self.clip_len = clip_len
        self.max_v_l = max_v_l
        self._infer = make_grounding_infer(grounding_model, text_encoder)

    def _video_features(self, video_path: str) -> np.ndarray:
        from vidchapters_tpu_torch.factory.features import decode_video_1fps

        frames = decode_video_1fps(video_path)
        # one feature per clip_len seconds (data_utils.py fps=1/clip_len)
        frames = frames[:: max(int(self.clip_len), 1)]
        return self.extractor(frames)

    def localize_moment(self, video_path: Optional[str], query_list: List[str],
                        video_features: Optional[np.ndarray] = None) -> List[Dict]:
        """-> per-query {query, vid, pred_relevant_windows,
        pred_saliency_scores} (run.py:25-80 schema), windows ranked by
        score."""
        feats = (video_features if video_features is not None
                 else self._video_features(video_path))
        feats = feats[: self.max_v_l]
        ctx_l = len(feats)
        # l2 normalize + TEF (start_end_dataset.py:130-138)
        feats = feats / (np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-5)
        tef_st = np.arange(ctx_l, dtype=np.float32) / ctx_l
        tef = np.stack([tef_st, tef_st + 1.0 / ctx_l], axis=1)
        feats = np.concatenate([feats, tef], axis=1)

        n = len(query_list)
        vid = np.tile(feats[None], (n, 1, 1)).astype(np.float32)
        vid_mask = np.ones((n, ctx_l), np.int32)
        duration = np.full(n, ctx_l * self.clip_len, np.float32)
        tokens = np.asarray(self.tokenizer(query_list))

        spans_sec, scores, saliency = self._infer(tokens, None, vid, vid_mask, duration)

        out = []
        for i, query in enumerate(query_list):
            order = np.argsort(-scores[i])
            out.append({
                "query": query,
                "vid": video_path,
                "pred_relevant_windows": [
                    [float(spans_sec[i, j, 0]), float(spans_sec[i, j, 1]),
                     float(scores[i, j])] for j in order],
                "pred_saliency_scores": [float(s) for s in saliency[i]],
            })
        return out
