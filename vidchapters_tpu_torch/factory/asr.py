"""ASR factory: Whisper inference hooks and pickle merging, idempotent and
sharded.

Counterpart of ``vidchapters_tpu/factory/asr.py`` and of the reference's
asr_extract/: per-video ASR with the reference's resume pattern (skip
outputs that already exist and shuffle the work list, so that independent
jobs can share one directory, whisper_inference.py:26-50), plus the merge
steps producing the consolidated pickles the datasets read
(merge_asr_whisper.py:12-41, merge_asr_whisper_align.py:16-81, including the
``v_``-prefixed ActivityNet ids). ``run_batched_asr`` drives the port's
``WhisperTranscriber``; ``run_sharded_asr`` takes any ``transcribe_fn``.
``make_hf_whisper_transcribe`` keeps the JAX package's name and signature
and raises: that backend is ``transformers.pipeline``, which the port does
not use (``demo/demo_asr.py``'s default backend runs the port's own).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from vidchapters_tpu_torch.utils.io import load_pickle, save_pickle


def run_sharded_asr(video_paths: Iterable[str], out_dir: str,
                    transcribe_fn: Callable[[str], dict], seed: int = 0) -> int:
    """Idempotent per-video ASR: shuffled work list, skip existing outputs.

    ``transcribe_fn(path) -> {"text": [...], "start": [...], "end": [...]}``.
    Returns the number of videos processed by this job."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = list(video_paths)
    np.random.default_rng(seed).shuffle(paths)
    done = 0
    for path in paths:
        target = out / f"{Path(path).stem}.pkl"
        if target.exists():  # another job already did it
            continue
        save_pickle(transcribe_fn(path), target)
        done += 1
    return done


def normalize_video_id(name: str) -> str:
    """ActivityNet ids keep their ``v_`` prefix + 11-char id; YouTube ids are
    the trailing 11 chars (merge_asr_whisper_align.py:27-31)."""
    stem = Path(name).stem
    if stem.startswith("v_") and len(stem) >= 13:
        return stem[:13]
    return stem[-11:]


def merge_asr_pickles(asr_dir: str, out_path: str) -> Dict[str, dict]:
    """Merge per-video pickles into one ``{vid: raw_result}`` dict
    (merge_asr_whisper.py:12-41)."""
    merged = {}
    for name in sorted(os.listdir(asr_dir)):
        if name.endswith(".pkl"):
            merged[normalize_video_id(name)] = load_pickle(os.path.join(asr_dir, name))
    save_pickle(merged, out_path)
    return merged


def proc_asr(raw: dict) -> Dict[str, list]:
    """Raw (whisperx-style) result -> the ``{text[], start[], end[]}`` schema
    every dataset reads (merge_asr_whisper_align.py:16-81); the detected
    ``language`` code rides along when present."""
    texts, starts, ends = [], [], []
    segments = raw.get("segments", raw if isinstance(raw, list) else [])
    for seg in segments:
        text = seg.get("text", "").strip()
        if not text or "start" not in seg or "end" not in seg:
            continue
        texts.append(text)
        starts.append(float(seg["start"]))
        ends.append(float(seg["end"]))
    out = {"text": texts, "start": starts, "end": ends}
    if isinstance(raw, dict) and "language" in raw:
        out["language"] = raw["language"]
    return out


def merge_and_process(asr_dir: str, out_path: str) -> Dict[str, dict]:
    """Merged + schema-normalized variant (the ``_proc`` pickle)."""
    merged = {}
    for name in sorted(os.listdir(asr_dir)):
        if name.endswith(".pkl"):
            raw = load_pickle(os.path.join(asr_dir, name))
            merged[normalize_video_id(name)] = proc_asr(raw)
    save_pickle(merged, out_path)
    return merged


def make_hf_whisper_transcribe(model_name: str = "openai/whisper-large-v2",
                               device=None, language: Optional[str] = None
                               ) -> Callable[[str], dict]:
    """The JAX package's HF backend only wraps
    ``transformers.pipeline("automatic-speech-recognition", ...)``; the port
    imports no ``transformers``. Raises before any work."""
    raise NotImplementedError(
        "the 'hf' ASR backend is transformers.pipeline, which the PyTorch port does not "
        "use; the port's own Whisper (demo_asr --backend torch, the default) reads the same "
        f"checkpoint ({model_name!r})")


def run_batched_asr(audio_paths: Iterable[str], out_dir: str, transcriber,
                    batch_size: int = 8, seed: int = 0) -> int:
    """Batched idempotent ASR sweep: groups of ``batch_size`` audio files
    decode window-lockstep on one card (``WhisperTranscriber.transcribe_batch``),
    the batched version of ``run_sharded_asr``'s per-video loop. Skips
    existing outputs so that concurrent shards cooperate. Returns the videos
    processed by this job."""
    from vidchapters_tpu_torch.factory.audio import load_audio

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = list(audio_paths)
    np.random.default_rng(seed).shuffle(paths)
    todo = [p for p in paths if not (out / f"{Path(p).stem}.pkl").exists()]
    done = 0
    for s in range(0, len(todo), batch_size):
        chunk = todo[s:s + batch_size]
        results = transcriber.transcribe_batch([load_audio(p) for p in chunk])
        for path, result in zip(chunk, results):
            save_pickle(result, out / f"{Path(path).stem}.pkl")
            done += 1
    return done
