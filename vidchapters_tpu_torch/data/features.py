"""Host-side video feature shaping: strided subsample / zero-pad to static T.

Reference semantics (dataset/dvc_dataset.py:61-86): long videos are
subsampled with the integer stride rule ``video[(j * len) // max_feats]`` and
short ones zero-padded to ``max_feats``.
"""

from __future__ import annotations

from typing import Optional

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
