"""Misc utilities mirroring the reference's util/basic_utils.py extras.

Counterpart of ``vidchapters_tpu/utils/misc.py``, a copy.

- ``pad_sequences_1d`` / ``pad_sequences_2d``: mask-producing pad
  (util/tensor_utils.py:5,56) on numpy;
- ``l2_normalize_np_array`` (util/basic_utils.py);
- ``AverageMeter`` (util/basic_utils.py:120-ish);
- ``make_zipfile``: code-snapshot zip with exclusions
  (moment_detr config.py:204-211 snapshots the code tree per run);
- ``dict_to_markdown`` for option logging.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Sequence, Tuple

import numpy as np


def pad_sequences_1d(sequences: Sequence[np.ndarray], dtype=np.float32,
                     fixed_length: int | None = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """List of [L_i, ...] -> (padded [N, L, ...], mask [N, L])."""
    lengths = [len(s) for s in sequences]
    max_len = fixed_length if fixed_length is not None else max(lengths)
    extra = np.asarray(sequences[0]).shape[1:]
    out = np.zeros((len(sequences), max_len) + extra, dtype)
    mask = np.zeros((len(sequences), max_len), np.float32)
    for i, s in enumerate(sequences):
        n = min(len(s), max_len)
        out[i, :n] = np.asarray(s)[:n]
        mask[i, :n] = 1
    return out, mask


def pad_sequences_2d(sequences: Sequence[Sequence[np.ndarray]], dtype=np.float32
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """List of lists of [L_ij, ...] -> ([N, M, L, ...], mask [N, M, L])."""
    n = len(sequences)
    m = max(len(s) for s in sequences)
    l = max(len(x) for s in sequences for x in s)
    extra = np.asarray(sequences[0][0]).shape[1:]
    out = np.zeros((n, m, l) + extra, dtype)
    mask = np.zeros((n, m, l), np.float32)
    for i, seq in enumerate(sequences):
        for j, x in enumerate(seq):
            out[i, j, : len(x)] = np.asarray(x)
            mask[i, j, : len(x)] = 1
    return out, mask


def l2_normalize_np_array(arr: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    return arr / (np.linalg.norm(arr, axis=-1, keepdims=True) + eps)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def make_zipfile(src_dir: str, save_path: str,
                 enclosing_dir: str = "",
                 exclude_dirs: Sequence[str] = (".git", "__pycache__",
                                                "results", "data", "debug"),
                 exclude_extensions: Sequence[str] = (".pyc", ".ipynb",
                                                      ".npy", ".pth",
                                                      ".npz")) -> None:
    """Zip a code tree for run snapshots (moment_detr config.py:204-211)."""
    with zipfile.ZipFile(save_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(src_dir):
            dirs[:] = [d for d in dirs
                       if d not in exclude_dirs and not d.startswith(".")]
            for fname in files:
                if any(fname.endswith(e) for e in exclude_extensions):
                    continue
                path = os.path.join(root, fname)
                arcname = os.path.join(enclosing_dir,
                                       os.path.relpath(path, src_dir))
                zf.write(path, arcname)


def dict_to_markdown(d: Dict, max_str_len: int = 120) -> str:
    rows = ["| key | value |", "| --- | --- |"]
    for k, v in d.items():
        s = str(v).replace("\n", " ")
        if max_str_len and len(s) > max_str_len:
            s = s[-max_str_len:]
        rows.append(f"| {k} | {s} |")
    return "\n".join(rows)
