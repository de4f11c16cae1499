"""Zero-shot visual video chapter generation (shot detect + caption): the
port's own copy of ``vidchapters_tpu/zeroshot/visual_vcg.py``.

Counterpart of zs_visualvcg.py: videos are segmented into shots and the
midpoint frame of each shot is captioned.

Two shot detectors:
- ``ffprobe_shot_detection``: the reference's scene-change filter
  (zs_visualvcg.py:20-47, ``select='gt(scene, 0.7)'``), behind a subprocess
  gate (ffmpeg/ffprobe may be absent);
- ``feature_shot_detection``: an equivalent over precomputed frame
  features — boundaries where the cosine distance between consecutive frame
  embeddings exceeds a threshold; no video decode needed.

The captioner (BLIP-2 with the reference's prompt, zs_visualvcg.py:256) is a
pluggable hook.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Callable, List, Sequence, Tuple

import numpy as np

# exact reference prompt (zs_visualvcg.py:256)
BLIP2_PROMPT = "Summarize the image in a chapter title. Chapter title:"


def ffprobe_shot_detection(video_path: str, threshold: float = 0.7
                           ) -> List[float]:
    """Scene-change timestamps in seconds via ffprobe (requires ffmpeg)."""
    if shutil.which("ffprobe") is None:
        raise RuntimeError("ffprobe not available; use feature_shot_detection")
    cmd = [
        "ffprobe", "-show_frames", "-of", "compact=p=0", "-f", "lavfi",
        f"movie={video_path},select=gt(scene\\,{threshold})",
    ]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    times = []
    for line in out.splitlines():
        for field in line.split("|"):
            if field.startswith("pkt_pts_time=") or field.startswith("pts_time="):
                times.append(float(field.split("=")[1]))
    return times


def feature_shot_detection(frame_feats: np.ndarray, frame_times: Sequence[float],
                           threshold: float = 0.3,
                           min_shot_len: int = 3) -> List[float]:
    """Boundary seconds where consecutive-frame cosine distance > threshold."""
    f = frame_feats / (np.linalg.norm(frame_feats, axis=-1, keepdims=True) + 1e-8)
    dist = 1.0 - (f[1:] * f[:-1]).sum(-1)
    times = []
    last = -min_shot_len
    for i, d in enumerate(dist):
        if d > threshold and i - last >= min_shot_len:
            times.append(float(frame_times[i + 1]))
            last = i
    return times


def shots_from_boundaries(boundaries: Sequence[float], duration: float
                          ) -> List[Tuple[float, float]]:
    edges = [0.0] + [b for b in boundaries if 0 < b < duration] + [duration]
    return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)
            if edges[i + 1] > edges[i]]


def make_blip2_captioner(caption_fn: Callable,
                         get_frame: Callable[[float], np.ndarray]) -> Callable:
    """Bind the port's BLIP-2 to the ``captioner`` hook.

    ``caption_fn(frames_uint8 [B, 224, 224, 3], prompt) -> list[str]`` comes
    from :func:`vidchapters_tpu_torch.models.blip2.build_blip2_captioner`;
    ``get_frame(seconds) -> uint8 [224, 224, 3]`` indexes decoded video
    (e.g. ``data.vc_dataset.get_raw_video`` output at 1 FPS, the reference's
    midpoint lookup at zs_visualvcg.py:250-252)."""

    def captioner(midpoint_seconds: float) -> str:
        frame = get_frame(midpoint_seconds)
        return caption_fn(frame[None], BLIP2_PROMPT)[0].strip()

    return captioner


def visual_chapters(shots: Sequence[Tuple[float, float]],
                    captioner: Callable[[float], str]) -> List[dict]:
    """Caption the midpoint of each shot (zs_visualvcg.py:247-266).

    ``captioner(midpoint_seconds) -> str`` wraps whatever captioning model is
    available (BLIP-2 in the reference)."""
    chapters = []
    for st, ed in shots:
        caption = captioner((st + ed) / 2.0)
        if caption:
            chapters.append({"sentence": caption, "timestamp": [st, ed]})
    return chapters
