"""Energy-based voice-activity detection for the ASR factory.

The port's own copy of ``vidchapters_tpu/factory/vad.py``.

The reference's ``--faster`` path runs whisperx, whose pipeline VAD-segments
the audio before batched decoding (asr_extract/whisper_inference.py:28,43 —
whisperx wraps a pyannote segmentation model). That model's weights are not
shippable here, so this is a self-contained spectral-energy VAD with the
same ROLE in the pipeline: find speech regions so the transcriber skips
silent stretches instead of mel-transforming and decoding them. Long-form
real-world video (the 900k-video HowTo100M sweep) is full of silence/music
gaps; skipping them is pure throughput.

Method: framewise RMS energy in dB -> adaptive threshold (noise floor
percentile + margin, clamped to an absolute floor) -> hysteresis-free
binary mask -> morphological cleanup (drop sub-``min_speech_ms`` blips,
bridge sub-``min_gap_ms`` gaps, pad edges).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SAMPLE_RATE = 16_000


def _frame_energy_db(audio: np.ndarray, frame: int) -> np.ndarray:
    n = len(audio) // frame
    if n == 0:
        return np.zeros((0,), np.float32)
    x = audio[: n * frame].astype(np.float32).reshape(n, frame)
    rms = np.sqrt(np.mean(np.square(x), axis=1) + 1e-12)
    return 20.0 * np.log10(rms + 1e-12)


def speech_segments(audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                    frame_ms: int = 20, margin_db: float = 9.0,
                    floor_db: float = -55.0, ceil_db: float = -30.0,
                    min_speech_ms: int = 200,
                    min_gap_ms: int = 300, pad_ms: int = 150,
                    ) -> List[Tuple[int, int]]:
    """Speech regions of mono float audio as [(start_sample, end_sample)).

    The threshold adapts to the recording's noise floor (10th-percentile
    frame energy + ``margin_db``), never drops below ``floor_db`` (digital
    silence must not promote background hiss to speech) and never rises
    above ``ceil_db`` — wall-to-wall loud audio has a HIGH 10th percentile,
    and without the ceiling an adaptive threshold above every frame would
    classify a fully-voiced recording as silence (skipping it entirely).
    """
    frame = max(1, sample_rate * frame_ms // 1000)
    e = _frame_energy_db(audio, frame)
    if len(e) == 0:
        return []
    noise_floor = float(np.percentile(e, 10))
    thresh = max(min(noise_floor + margin_db, ceil_db), floor_db)
    mask = e > thresh
    if not mask.any():
        return []

    # frame runs -> segments
    idx = np.flatnonzero(np.diff(np.concatenate(([0], mask.view(np.int8),
                                                 [0]))))
    runs = [(int(idx[i]), int(idx[i + 1])) for i in range(0, len(idx), 2)]

    # bridge short gaps
    min_gap = max(1, min_gap_ms // frame_ms)
    merged: List[Tuple[int, int]] = []
    for s, t in runs:
        if merged and s - merged[-1][1] <= min_gap:
            merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    # drop blips, pad, convert to samples
    min_speech = max(1, min_speech_ms // frame_ms)
    pad = pad_ms * sample_rate // 1000
    out: List[Tuple[int, int]] = []
    for s, t in merged:
        if t - s < min_speech:
            continue
        a = max(0, s * frame - pad)
        b = min(len(audio), t * frame + pad)
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def next_voiced_seek(segments: List[Tuple[int, int]], seek: int,
                     window: int, total: int) -> int:
    """Smallest position >= ``seek`` whose [pos, pos+window) overlaps a
    speech segment; ``total`` (end of audio) when none does. With no
    segments list (VAD off) callers never invoke this."""
    for a, b in segments:
        if b <= seek:
            continue
        if a < seek + window:  # current window already overlaps
            return seek if a <= seek else min(a, total)
        return min(a, total)
    return total
