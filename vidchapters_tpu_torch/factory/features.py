"""CLIP frame-feature factory: batched feature extraction on one card.

Counterpart of ``vidchapters_tpu/factory/features.py`` and of the reference
feature pipelines (demo_vid2seq.py:70-113: 1-FPS decode + CLIP ViT-L/14;
moment_detr/run_on_video/data_utils.py:9-49): frames are preprocessed
(shorter side resized to 224 bilinearly, centre crop, CLIP normalisation),
batched, and pushed through the port's CLIP image tower
(``models/clip.CLIPImageEncoder``). The per-video output is ``<id>.npy``
[T, D] float32, what every dataset loader reads.

- ``preprocess_frames`` is the JAX package's numpy preprocessing, bit for
  bit (its arithmetic runs in float64). ``preprocess_frames_torch`` is the
  same arithmetic in float32 torch over the centre crop only, for uint8
  frames already on the card: a 360x640 frame costs milliseconds of numpy
  on the host, far more than the tower's device time for it (PERF.md).
- ``CLIPFeatureExtractor`` keeps a bounded number of batches in flight on
  one CUDA stream: uint8 frames go through pinned host buffers with
  non-blocking copies, are preprocessed and encoded on the card, and come
  back through pinned buffers, so the host fills batch i+1 while the card
  encodes batch i (the JAX package's dispatch-ahead chunk pipeline).
- ``extract_features_sharded``: skip existing outputs, a seeded shuffle,
  a thread-pool decode ``prefetch`` videos ahead; ``prefetch=0`` decodes
  synchronously between videos, as the reference does.

Video decode needs ffmpeg and raises without it; the extractor takes
decoded frame arrays too.
"""

from __future__ import annotations

import shutil
import subprocess
from collections import deque
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_frames(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, size, size, 3] float32, CLIP-normalized
    (resize shorter side to ``size`` bilinearly, center crop)."""
    t, h, w, _ = frames.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    # bilinear resize via separable linear interpolation
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    resized = top * (1 - wy) + bot * wy
    # center crop
    oy = (nh - size) // 2
    ox = (nw - size) // 2
    crop = resized[:, oy:oy + size, ox:ox + size]
    return ((crop / 255.0 - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def _crop_taps(n: int, n_resized: int, size: int, device):
    """Source indices and weights of the ``size`` crop rows (or columns) of
    ``preprocess_frames``' linear interpolation, computed in float64 on the
    host as numpy does, the weights then rounded to float32."""
    pos = np.linspace(0, n - 1, n_resized)
    o = (n_resized - size) // 2
    pos = pos[o:o + size]
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    wgt = (pos - i0).astype(np.float32)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(wgt).to(device))


def preprocess_frames_torch(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """``preprocess_frames`` for a uint8 tensor [T, H, W, 3] on any device:
    the same interpolation, crop and normalisation in float32 (numpy's runs
    in float64; the two agree within 1e-5), computed for the crop only."""
    t, h, w, _ = frames.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    y0, y1, wy = _crop_taps(h, nh, size, frames.device)
    x0, x1, wx = _crop_taps(w, nw, size, frames.device)
    wy = wy[None, :, None, None]
    wx = wx[None, None, :, None]
    f = frames.float()
    rows0, rows1 = f.index_select(1, y0), f.index_select(1, y1)
    top = rows0.index_select(2, x0) * (1 - wx) + rows0.index_select(2, x1) * wx
    bot = rows1.index_select(2, x0) * (1 - wx) + rows1.index_select(2, x1) * wx
    crop = top * (1 - wy) + bot * wy
    mean = torch.from_numpy(CLIP_MEAN).to(frames.device)
    std = torch.from_numpy(CLIP_STD).to(frames.device)
    return (crop / 255.0 - mean) / std


def decode_video_1fps(video_path: str, size: int = 224) -> np.ndarray:
    """1-FPS RGB frames via ffmpeg (demo_vid2seq.py:84-90); raises if ffmpeg
    is unavailable."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not available; provide frames directly")
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height", "-of", "csv=p=0", video_path],
        capture_output=True, text=True, check=True).stdout.strip()
    w, h = (int(x) for x in probe.split(","))
    proc = subprocess.run(
        ["ffmpeg", "-i", video_path, "-vf", "fps=1", "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-v", "error", "-"],
        capture_output=True, check=True)
    frames = np.frombuffer(proc.stdout, np.uint8).reshape(-1, h, w, 3)
    return frames


class CLIPFeatureExtractor:
    """The port's CLIP image tower over frame arrays, ``batch_size`` frames
    a call of the tower. ``module`` is a ``CLIPImageEncoder`` holding its
    weights; it is moved to ``device`` (CUDA unless the caller asks for the
    CPU). On the card uint8 frames are preprocessed there
    (``preprocess_frames_torch``); on the CPU by ``preprocess_frames``, as
    the JAX package does. ``batches`` counts the tower's calls."""

    # batches in flight: enough to overlap the host's copies with the card's
    # work, few enough that a video of thousands of frames never holds more
    # than a few input and output buffers
    MAX_IN_FLIGHT = 3

    def __init__(self, module, device=None, batch_size: int = 64):
        from vidchapters_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.batch_size = batch_size
        self.batches = 0
        self._stream = None

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = preprocess_frames_torch(x)
        self.batches += 1
        return self.module(x)

    @torch.inference_mode()
    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 or preprocessed float -> [T, D] float32."""
        if len(frames) == 0:
            raise ValueError("no frames to encode")
        if self.device.type == "cuda":
            return self._pipelined(frames)
        if frames.dtype == np.uint8:
            frames = preprocess_frames(frames)
        bs = self.batch_size
        return np.concatenate([self._encode(torch.from_numpy(np.ascontiguousarray(
            frames[s:s + bs]))).numpy() for s in range(0, len(frames), bs)])

    def _pipelined(self, frames: np.ndarray) -> np.ndarray:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # the tower's reads follow whatever the caller queued on its own
        # stream (weights loaded or copied there without a host barrier)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        pending = deque()  # (event, pinned output, pinned input, first frame)
        out = None
        with torch.cuda.stream(self._stream):
            for s in range(0, len(frames), self.batch_size):
                if len(pending) >= self.MAX_IN_FLIGHT:
                    out = self._drain(pending.popleft(), out, len(frames))
                chunk = np.ascontiguousarray(frames[s:s + self.batch_size])
                pinned = torch.from_numpy(chunk).pin_memory()
                feats = self._encode(pinned.to(self.device, non_blocking=True))
                host = torch.empty(feats.shape, dtype=torch.float32, pin_memory=True)
                host.copy_(feats, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
                # the pinned input must outlive its copy: it rides along
                pending.append((event, host, pinned, s))
            while pending:
                out = self._drain(pending.popleft(), out, len(frames))
        return out

    @staticmethod
    def _drain(item, out, n: int) -> np.ndarray:
        event, host, _, start = item
        event.synchronize()
        feats = host.numpy()
        if out is None:
            out = np.empty((n, feats.shape[1]), np.float32)
        out[start:start + len(feats)] = feats
        return out


def extract_features_sharded(video_paths: Sequence[str], out_dir: str,
                             extractor: Callable[[np.ndarray], np.ndarray],
                             decode_fn: Optional[Callable[[str], np.ndarray]] = None,
                             seed: int = 0, prefetch: int = 2,
                             decode_workers: int = 1) -> int:
    """Idempotent sharded feature extraction (same resume pattern as the ASR
    factory: skip existing outputs, shuffle work). Returns the number of
    videos this call encoded.

    Video decode runs on ``decode_workers`` background threads ``prefetch``
    videos ahead so the CPU decode overlaps device encoding — the
    reference's VideoLoader decodes synchronously between GPU batches
    (run_on_video/data_utils.py:9-31). ``prefetch=0`` reproduces that
    synchronous behavior."""
    from concurrent.futures import ThreadPoolExecutor

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    decode_fn = decode_fn or decode_video_1fps
    paths = list(video_paths)
    np.random.default_rng(seed).shuffle(paths)
    todo = [p for p in paths
            if not (out / (Path(p).stem + ".npy")).exists()]
    done = 0

    def save(path: str, frames: np.ndarray) -> int:
        target = out / (Path(path).stem + ".npy")
        if target.exists():  # another shard may have raced us
            return 0
        np.save(target, extractor(frames).astype(np.float32))
        return 1

    if prefetch <= 0:  # synchronous decode-between-batches (reference mode)
        for path in todo:
            done += save(path, decode_fn(path))
        return done
    prefetch = max(prefetch, decode_workers)
    with ThreadPoolExecutor(max_workers=max(1, decode_workers)) as pool:
        futures = {}
        for i, path in enumerate(todo[:prefetch]):
            futures[i] = pool.submit(decode_fn, path)
        for i, path in enumerate(todo):
            frames = futures.pop(i).result()
            nxt = i + prefetch
            if nxt < len(todo):
                futures[nxt] = pool.submit(decode_fn, todo[nxt])
            done += save(path, frames)
    return done
