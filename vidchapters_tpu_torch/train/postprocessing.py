"""Window post-processing for moment-retrieval submissions.

Numpy port of PostProcessorDETR (moment_detr/moment_detr/
postprocessing_moment_detr.py:9-95): clamp window lengths into
[min_w_l, max_w_l] (moving the window by the configured anchor), clip
timestamps into [min_ts_val, max_ts_val], and round to multiples of
``clip_length`` — applied to ``pred_relevant_windows`` rows in place of the
reference's torch pipeline. The port's own copy of
``vidchapters_tpu/train/postprocessing.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


class PostProcessorDETR:
    def __init__(self, clip_length: float = 2, min_ts_val: float = 0,
                 max_ts_val: float = 150, min_w_l: float = 2,
                 max_w_l: float = 70, move_window_method: str = "center",
                 process_func_names: Sequence[str] = ("clip_window_l",
                                                      "clip_ts",
                                                      "round_multiple")):
        self.clip_length = clip_length
        self.min_ts_val = min_ts_val
        self.max_ts_val = max_ts_val
        self.min_w_l = min_w_l
        self.max_w_l = max_w_l
        self.move_window_method = move_window_method
        self.process_func_names = process_func_names
        self._funcs = {
            "clip_ts": self.clip_min_max_timestamps,
            "round_multiple": self.round_to_multiple_clip_lengths,
            "clip_window_l": self.clip_window_lengths,
        }

    def __call__(self, lines: Iterable[Dict]) -> List[Dict]:
        out = []
        for line in lines:
            line = dict(line)
            rows = np.asarray(line["pred_relevant_windows"], np.float64)
            windows = rows[:, :2].copy()
            for name in self.process_func_names:
                windows = self._funcs[name](windows)
            line["pred_relevant_windows"] = [
                [float(w[0]), float(w[1]), float(f"{s:.4f}")]
                for w, s in zip(windows, rows[:, 2])]
            out.append(line)
        return out

    def clip_min_max_timestamps(self, windows: np.ndarray) -> np.ndarray:
        return np.clip(windows, self.min_ts_val, self.max_ts_val)

    def round_to_multiple_clip_lengths(self, windows: np.ndarray) -> np.ndarray:
        return np.round(windows / self.clip_length) * self.clip_length

    def clip_window_lengths(self, windows: np.ndarray) -> np.ndarray:
        lengths = windows[:, 1] - windows[:, 0]
        windows = self._move(windows, lengths < self.min_w_l, self.min_w_l)
        lengths = windows[:, 1] - windows[:, 0]
        windows = self._move(windows, lengths > self.max_w_l, self.max_w_l)
        return windows

    def _move(self, windows: np.ndarray, rows: np.ndarray,
              new_length: float) -> np.ndarray:
        if not rows.any():
            return windows
        method = self.move_window_method
        if method == "left":
            windows[rows, 1] = windows[rows, 0] + new_length
        elif method == "right":
            windows[rows, 0] = windows[rows, 1] - new_length
        else:  # center
            center = (windows[rows, 0] + windows[rows, 1]) / 2.0
            windows[rows, 0] = center - new_length / 2.0
            windows[rows, 1] = center + new_length / 2.0
        return windows
