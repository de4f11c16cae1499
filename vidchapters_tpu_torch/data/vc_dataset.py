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

With ``videos_path`` (a json path or a mapping of video id -> raw video
file) each example also carries ``raw_first_frames``: the first decoded
frame of each clip from ``get_raw_video``'s 1-FPS ffmpeg decode, what the
BLIP-2 evaluator captions (vc.py:111). A video that does not decode gives
one black frame (vc_dataset.py:47-48).
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from vidchapters_tpu_torch.config import DataConfig
from vidchapters_tpu_torch.data.dvc_dataset import SubtitleSource
from vidchapters_tpu_torch.data.features import FeatureSource, subsample_or_pad
from vidchapters_tpu_torch.data.time_tokens import normalize_caption
from vidchapters_tpu_torch.utils.io import load_json


def _output_dim(h: int, w: int, resolution: int):
    """Aspect-preserving resize so the short side equals ``resolution``
    (vc_dataset.py:12-16)."""
    if h >= w:
        return int(h * resolution / w), resolution
    return resolution, int(w * resolution / h)


def get_raw_video(video_path: Optional[str], resolution: int = 224) -> np.ndarray:
    """1-FPS ffmpeg decode + resize + center crop -> uint8 [T, R, R, 3]
    (vc_dataset.py:19-50); one black frame on any failure (:47-48) or when
    nothing decodes."""
    try:
        probe = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
             "stream=width,height", "-of", "csv=p=0", video_path],
            capture_output=True, text=True, check=True).stdout.strip()
        w, h = (int(x) for x in probe.split(",")[:2])
        height, width = _output_dim(h, w, resolution)
        x = int((width - resolution) / 2.0)
        y = int((height - resolution) / 2.0)
        out = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", video_path, "-vf",
             f"fps=1,scale={width}:{height},crop={resolution}:{resolution}:{x}:{y}",
             "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:"],
            capture_output=True, check=True).stdout
        frames = np.frombuffer(out, np.uint8).reshape(-1, resolution, resolution, 3).copy()
        if frames.shape[0] == 0:
            return np.zeros((1, resolution, resolution, 3), np.uint8)
        return frames
    except Exception:
        return np.zeros((1, resolution, resolution, 3), np.uint8)


class VideoCaptioningDataset:
    def __init__(self, json_path, features_path, training: bool = True,
                 cfg: DataConfig = DataConfig(),
                 subtitles_path: Optional[str] = None,
                 videos_path: Optional[Union[str, Mapping[str, str]]] = None):
        self.data = load_json(json_path) if isinstance(json_path, str) else json_path
        self.vids = list(self.data.keys())
        self.features = FeatureSource(features_path, cfg.max_feats, cfg.features_dim)
        self.training = training
        self.cfg = cfg
        self.subs = SubtitleSource(subtitles_path)
        self.vid2path: Optional[Mapping[str, str]] = (
            load_json(videos_path) if isinstance(videos_path, str) else videos_path)

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
        raw = None
        if self.vid2path is not None:
            raw = get_raw_video(self.vid2path.get(video_id[-11:]))
        if self.training:
            j = int(rng.integers(len(ann["sentences"])))
            start, end = ann["timestamps"][j]
            out = {
                "video_id": video_id,
                "video": self._clip_video(video, start, end),
                "input_text": self._clip_text(sub, start, end),
                "output_text": normalize_caption(ann["sentences"][j]),
            }
            if raw is not None:
                out["raw_first_frames"] = _first_frame(raw, start)
            return out
        out = {
            "video_id": video_id,
            "video": np.stack([self._clip_video(video, st, ed) for st, ed in ann["timestamps"]]),
            "input_text": [self._clip_text(sub, st, ed) for st, ed in ann["timestamps"]],
            "output_text": [normalize_caption(s) for s in ann["sentences"]],
        }
        if raw is not None:
            # the first decoded frame of each clip, what vc.py:111
            # (raw_video[0, :, 0]) feeds BLIP-2
            out["raw_first_frames"] = np.stack([_first_frame(raw, st)
                                                for st, _ in ann["timestamps"]])
        return out


def _first_frame(raw: np.ndarray, start: float) -> np.ndarray:
    return raw[max(min(int(start), len(raw) - 1), 0)]


def vc_collate(examples: List[dict]) -> Dict:
    out = {
        "video_id": [e["video_id"] for e in examples],
        "video": np.stack([e["video"] for e in examples]).astype(np.float32),
        "input_text": [e["input_text"] for e in examples],
        "output_text": [e["output_text"] for e in examples],
    }
    if "raw_first_frames" in examples[0]:
        out["raw_first_frames"] = np.stack([e["raw_first_frames"] for e in examples])
    return out
