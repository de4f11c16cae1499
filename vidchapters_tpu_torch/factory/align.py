"""Word-level timestamp alignment from Whisper cross-attention (DTW).

Counterpart of ``vidchapters_tpu/factory/align.py``. The reference aligns
ASR with whisperx's wav2vec2 forced aligner (asr_extract/whisper_align.py:
33-55); this path follows openai-whisper's ``word_timestamps`` method
instead: teacher-force the transcription through the port's Whisper
decoder, pool its cross-attention maps over layers and heads
(``models/whisper.WhisperDecoder.cross_attention_mean``), median-filter
along audio time, run monotonic DTW over -attention, and read each token's
audio frame from the alignment path (0.02 s per encoder frame).

``median_filter``, ``dtw_path``, ``token_times_from_attention``,
``_words_from_times`` and ``align_words`` are copies. ``align_words_batch``
runs the port's ``Whisper`` in chunks of segments, each chunk's maps pooled
on the device as they come (the JAX package stacks every map of the batch,
[B, layers, heads, T_tok, T_aud] float32: about 246 MB a 64-token segment at
large-v2). ``align_segments`` turns a transcript of the ASR sweep
(``{text, start, end, language}``) into the whisperx form (``segments``
with ``words``) that ``factory/asr.proc_asr`` and ``merge_and_process``
read.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TIME_PER_FRAME = 0.02


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (odd width, edge padded)."""
    if width <= 1:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a [T_tokens, T_audio] cost matrix; returns the
    (token_idx, audio_idx) path arrays."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), np.int8)
    for i in range(1, n + 1):
        c_row = cost[i - 1]
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]
            c1 = acc[i - 1, j]
            c2 = acc[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                acc[i, j] = c0 + c_row[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                acc[i, j] = c1 + c_row[j - 1]
                trace[i, j] = 1
            else:
                acc[i, j] = c2 + c_row[j - 1]
                trace[i, j] = 2
    ti, ai = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        ai.append(j - 1)
        step = trace[i, j]
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(ai[::-1])


def token_times_from_attention(cross_attn: np.ndarray,
                               n_audio_frames: int,
                               filter_width: int = 7
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """cross_attn [layers, heads, T_tokens, T_audio] -> per-token
    (start_seconds, end_seconds)."""
    # pool heads/layers, then the pooled map's times
    w = cross_attn[..., :n_audio_frames].mean(axis=(0, 1))  # [T_tok, T_aud]
    return token_times_from_pooled(w, filter_width)


def token_times_from_pooled(w: np.ndarray, filter_width: int = 7
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The tail of ``token_times_from_attention`` on the map already pooled
    over layers and heads and cut to the real audio, ``w`` [T_tok, T_aud]."""
    # normalize per token, smooth along audio time
    std = w.std(axis=-1, keepdims=True) + 1e-6
    w = (w - w.mean(axis=-1, keepdims=True)) / std
    w = median_filter(w, filter_width)
    ti, ai = dtw_path(-w)
    n_tok = w.shape[0]
    starts = np.zeros(n_tok)
    ends = np.zeros(n_tok)
    for t in range(n_tok):
        frames = ai[ti == t]
        if len(frames):
            starts[t] = frames.min() * TIME_PER_FRAME
            ends[t] = (frames.max() + 1) * TIME_PER_FRAME
        elif t > 0:
            starts[t] = ends[t - 1]
            ends[t] = ends[t - 1]
    # enforce monotonicity
    for t in range(1, n_tok):
        starts[t] = max(starts[t], starts[t - 1])
        ends[t] = max(ends[t], starts[t])
    return starts, ends


def _words_from_times(token_words: Sequence[str], starts: np.ndarray,
                      ends: np.ndarray) -> List[Dict]:
    words: List[Dict] = []
    for i, word in enumerate(token_words):
        if word == "" and words:  # continuation token extends previous word
            words[-1]["end"] = float(ends[i])
        elif word:
            words.append({"word": word, "start": float(starts[i]),
                          "end": float(ends[i])})
    return words


def align_words_batch(model, mels: Sequence[np.ndarray],
                      token_ids_list: Sequence[Sequence[int]],
                      token_words_list: Sequence[Sequence[str]],
                      audio_seconds_list: Sequence[float],
                      prefix_ids: Sequence[int] = (),
                      chunk_size: Optional[int] = None,
                      ) -> List[List[Dict]]:
    """Teacher-force every segment through ``model`` (the port's
    ``Whisper``, on the device of its parameters): one encoder and one
    decoder call for each chunk of ``chunk_size`` segments (all at once
    when None).

    Mels are zero-padded to the frame count of the longest segment of the
    WHOLE call, whatever the chunk: the encoder takes no mask and adds its
    positions up to the mel's length, so every segment's encoding depends
    on that common count, and chunks padded to their own longest segment
    would give other word times than one batch does (the JAX package pads
    the whole batch at once). Token rows are padded to their chunk's
    longest: the decoder is causal, so rows past a segment's tokens change
    nothing before them. Trailing pad rows and frames beyond each segment's
    real audio are sliced off the pooled map before the DTW.
    ``prefix_ids`` (e.g. Whisper's [SOT, lang, task, <|notimestamps|>]) are
    teacher-forced ahead of the text, as openai-whisper's find_alignment
    does, and their rows stripped. ``token_words[i]`` is the text of token
    i ("" merges it with the previous word, e.g. BPE continuations).
    Returns one [{word, start, end}] list per segment.
    """
    assert len(mels) == len(token_ids_list) == len(audio_seconds_list)
    if not mels:
        return []
    device = next(model.parameters()).device
    p = len(prefix_ids)
    lens = [len(ids) for ids in token_ids_list]
    max_frames = max(m.shape[-1] for m in mels)
    step = chunk_size or len(mels)
    out: List[List[Dict]] = []
    for c0 in range(0, len(mels), step):
        sl = slice(c0, c0 + step)
        max_tok = p + max(lens[sl])
        tok_rows = []
        for ids in token_ids_list[sl]:
            row = list(prefix_ids) + list(ids)
            tok_rows.append(row + [0] * (max_tok - len(row)))
        mel_rows = np.stack([np.pad(m, ((0, 0), (0, max_frames - m.shape[-1])))
                             for m in mels[sl]]).astype(np.float32)
        with torch.inference_mode():
            enc = model.encode(torch.from_numpy(mel_rows).to(device))
            tokens = torch.tensor(tok_rows, dtype=torch.int32, device=device)
            pooled = model.decoder.cross_attention_mean(tokens, enc).cpu().numpy()
        for b, (n_tok, words, secs) in enumerate(
                zip(lens[sl], token_words_list[sl], audio_seconds_list[sl])):
            w = pooled[b, p:p + n_tok]  # strip prefix + pad rows
            n_frames = int(min(w.shape[-1], secs / TIME_PER_FRAME))
            if n_tok == 0 or n_frames < 1:  # empty text or no real audio
                out.append([])
                continue
            starts, ends = token_times_from_pooled(w[:, :n_frames])
            out.append(_words_from_times(words, starts, ends))
    return out


def align_words(model, mel: np.ndarray, token_ids: Sequence[int],
                token_words: Sequence[str], audio_seconds: float,
                prefix_ids: Sequence[int] = ()) -> List[Dict]:
    """Single-segment wrapper over align_words_batch."""
    return align_words_batch(model, [mel], [token_ids], [token_words], [audio_seconds],
                             prefix_ids=prefix_ids)[0]


def align_segments(model, audio: np.ndarray, result: Dict[str, list],
                   tokenize: Callable[[str], Tuple[List[int], List[str]]],
                   prefix_ids: Sequence[int] = (), chunk_size: Optional[int] = 16
                   ) -> Dict[str, object]:
    """A transcript of the ASR sweep (``{text[], start[], end[],
    language}``) and its 16 kHz audio -> the whisperx form
    ``{"segments": [{text, start, end, words: [{word, start, end}]}],
    "language"}`` with word times in seconds of the video. Each segment's
    audio (at most 30 s) becomes a 30 s log-mel window, as openai-whisper
    aligns; ``tokenize(text) -> (token ids, token words)``."""
    from vidchapters_tpu_torch.factory.audio import SAMPLE_RATE, log_mel_spectrogram

    mels, ids, words, secs = [], [], [], []
    for text, st, ed in zip(result["text"], result["start"], result["end"]):
        clip = audio[int(st * SAMPLE_RATE):int(ed * SAMPLE_RATE)]
        mels.append(log_mel_spectrogram(clip))
        i, w = tokenize(text)
        ids.append(i)
        words.append(w)
        secs.append(len(clip) / SAMPLE_RATE)
    aligned = align_words_batch(model, mels, ids, words, secs, prefix_ids=prefix_ids,
                                chunk_size=chunk_size)
    segments = []
    for text, st, ed, wds in zip(result["text"], result["start"], result["end"], aligned):
        segments.append({"text": text, "start": float(st), "end": float(ed),
                         "words": [{"word": w["word"], "start": st + w["start"],
                                    "end": st + w["end"]} for w in wds]})
    out: Dict[str, object] = {"segments": segments}
    if "language" in result:
        out["language"] = result["language"]
    return out
