"""Host-side video feature loading: strided subsample / zero-pad to static T.

Reference semantics (dataset/dvc_dataset.py:61-86): features come either from
a directory of per-video ``<id>.npy`` / ``<id>.mp4.npy`` files or from one
consolidated mapping; long videos are subsampled with the integer stride rule
``video[(j * len) // max_feats]`` and short ones zero-padded to ``max_feats``.
The port's own copy of ``vidchapters_tpu/data/features.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np


def subsample_or_pad(video: np.ndarray, max_feats: int,
                     features_dim: Optional[int] = None) -> np.ndarray:
    """[T, D] -> [max_feats, D] via integer-stride subsample or zero-pad."""
    features_dim = features_dim if features_dim is not None else video.shape[-1]
    t = len(video)
    if t > max_feats:
        idx = (np.arange(max_feats) * t) // max_feats
        return np.ascontiguousarray(video[idx])
    if t < max_feats:
        out = np.zeros((max_feats, features_dim), dtype=video.dtype)
        out[:t] = video
        return out
    return video


class FeatureSource:
    """Uniform accessor over per-video .npy dirs or consolidated feature dicts.

    In directory mode the C++ loader (``data/native_loader.py``: mmap'd npy,
    the same stride rule, a thread pool that prefetches into an LRU cache)
    serves ``__call__`` and ``prefetch`` when it builds: ``native=None``
    chooses it when g++ is there, ``False`` keeps numpy, ``True`` requires
    the library. Host code only."""

    def __init__(self, features_path: Union[str, Dict[str, np.ndarray]],
                 max_feats: int = 100, features_dim: int = 768,
                 native: Optional[bool] = None):
        self.max_feats = max_feats
        self.features_dim = features_dim
        self.features: Optional[Dict[str, np.ndarray]] = None
        self.dir_path: Optional[str] = None
        self._native = None
        self._native_opt = native
        if isinstance(features_path, dict):
            self.features = features_path
        elif os.path.isdir(features_path):
            self.dir_path = features_path
        elif features_path.endswith(".npz"):  # consolidated id -> array mapping
            self.features = dict(np.load(features_path))
        else:  # consolidated torch .pth mapping
            import torch

            loaded = torch.load(features_path, map_location="cpu")
            self.features = {k: v.numpy() for k, v in loaded.items()}

    def _native_loader(self):
        """The native loader, made at first use; None when disabled, not in
        directory mode, or (with ``native=None``) when it does not build."""
        if self._native_opt is False or self.dir_path is None:
            return None
        if self._native is None:
            from vidchapters_tpu_torch.data import native_loader

            try:
                self._native = native_loader.NativeFeatureLoader()
            except (RuntimeError, OSError):
                if self._native_opt is True:
                    raise
                self._native = False  # tried: unavailable here
        return self._native or None

    def _path(self, video_id: str) -> str:
        path = os.path.join(self.dir_path, video_id + ".mp4.npy")
        if not os.path.exists(path):
            path = os.path.join(self.dir_path, video_id + ".npy")
        return path

    def raw(self, video_id: str, strict: bool = True) -> np.ndarray:
        """The video's features as stored, ``[T, D]`` float32. With
        ``strict=False`` a missing or unreadable video gives one zero frame
        ``[1, features_dim]`` instead of raising (the reference's
        broken-video fallback, vc_dataset.py:47-48)."""
        try:
            if self.features is not None:
                if video_id not in self.features:
                    raise KeyError(f"no features for video {video_id!r}")
                return np.asarray(self.features[video_id], dtype=np.float32)
            return np.load(self._path(video_id)).astype(np.float32)
        except Exception:
            if strict:
                raise
            return np.zeros((1, self.features_dim), np.float32)

    def prefetch(self, video_ids) -> None:
        """Warm the native cache for upcoming ids (nothing without it)."""
        loader = self._native_loader()
        if loader is not None:
            loader.prefetch([self._path(v) for v in video_ids])

    def __call__(self, video_id: str) -> np.ndarray:
        loader = self._native_loader()
        if loader is not None:
            path = self._path(video_id)
            if os.path.exists(path):
                return loader.load(path, self.max_feats, self.features_dim)
        return subsample_or_pad(self.raw(video_id), self.max_feats, self.features_dim)
