"""Clip-level video captioning dataset (chapter titles with GT boundaries).

Counterpart of ``vidchapters_tpu/data/vc_dataset.py`` (the reference's
dataset/vc_dataset.py:52-283): at train time one random clip per video,
drawn from the caller's numpy generator — features sliced to the clip's
[start, end] seconds and re-padded to ``max_feats`` (vc_dataset.py:157-164);
at eval every clip; the ASR input is the concatenation of subtitle lines
fully inside the clip window (vc_dataset.py:174-186). A video whose
features are missing or unreadable gives one zero frame
(``FeatureSource.raw(strict=False)``). Text is tokenized by the caller
(``train/vc_train.tokenize_batch``).

The raw-video branch (``videos_path``: a 1-FPS ffmpeg decode whose first
frame per clip feeds the BLIP-2 evaluator) is not ported: it waits for the
BLIP-2 tower (ROADMAP.md §1 item 8), and the dataset raises when it is asked
for.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from vidchapters_tpu_torch.config import DataConfig
from vidchapters_tpu_torch.data.dvc_dataset import SubtitleSource
from vidchapters_tpu_torch.data.features import FeatureSource, subsample_or_pad
from vidchapters_tpu_torch.data.time_tokens import normalize_caption
from vidchapters_tpu_torch.utils.io import load_json


class VideoCaptioningDataset:
    def __init__(self, json_path, features_path, training: bool = True,
                 cfg: DataConfig = DataConfig(),
                 subtitles_path: Optional[str] = None,
                 videos_path=None):
        if videos_path is not None:
            raise NotImplementedError(
                "videos_path (raw frames for the BLIP-2 evaluator) is not ported: it "
                "waits for the BLIP-2 tower, ROADMAP.md §1 item 8")
        self.data = load_json(json_path) if isinstance(json_path, str) else json_path
        self.vids = list(self.data.keys())
        self.features = FeatureSource(features_path, cfg.max_feats, cfg.features_dim)
        self.training = training
        self.cfg = cfg
        self.subs = SubtitleSource(subtitles_path)

    def __len__(self) -> int:
        return len(self.data)

    def _clip_video(self, video: np.ndarray, start: float, end: float) -> np.ndarray:
        clip = video[int(start): int(end) + 1]
        if len(clip) == 0:
            clip = np.zeros((1, self.cfg.features_dim), np.float32)
        return subsample_or_pad(clip, self.cfg.max_feats, self.cfg.features_dim)

    def _clip_text(self, sub: Optional[dict], start: float, end: float) -> str:
        if sub is None:
            return ""
        lines = [normalize_caption(t) for t, s, e in zip(sub["text"], sub["start"], sub["end"])
                 if s >= start and e <= end]
        return " ".join(lines)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        video_id = self.vids[idx]
        ann = self.data[video_id]
        # raw (un-subsampled) features so second-resolution clip slicing works
        video = self.features.raw(video_id[-11:], strict=False)
        sub = self.subs.get(video_id)
        if self.training:
            j = int(rng.integers(len(ann["sentences"])))
            start, end = ann["timestamps"][j]
            return {
                "video_id": video_id,
                "video": self._clip_video(video, start, end),
                "input_text": self._clip_text(sub, start, end),
                "output_text": normalize_caption(ann["sentences"][j]),
            }
        return {
            "video_id": video_id,
            "video": np.stack([self._clip_video(video, st, ed) for st, ed in ann["timestamps"]]),
            "input_text": [self._clip_text(sub, st, ed) for st, ed in ann["timestamps"]],
            "output_text": [normalize_caption(s) for s in ann["sentences"]],
        }


def vc_collate(examples: List[dict]) -> Dict:
    return {
        "video_id": [e["video_id"] for e in examples],
        "video": np.stack([e["video"] for e in examples]).astype(np.float32),
        "input_text": [e["input_text"] for e in examples],
        "output_text": [e["output_text"] for e in examples],
    }
