"""T5-style span corruption (denoising objective) on the host, in NumPy.

Same deterministic span-count construction as the original T5 preprocessor
(and the reference's numpy port at util/t5.py:36-94): given a length,
``num_noise_tokens = round(length * density)`` clipped to [1, length-1], spans
alternate non-noise/noise starting with non-noise, and all segmentations are
equally likely. Sentinel ids descend from the top of the *text* vocabulary
(just below the time tokens), matching util/t5.py:13 so denoising batches are
id-compatible with the reference.

Used for the Vid2Seq denoising loss on ASR sequences (dvc.py:78-100,
dataset/dvc_dataset.py:126-142). The port's own copy of
``vidchapters_tpu/data/span_corruption.py`` (numpy only).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _random_partition(num_items: int, num_segments: int, rng: np.random.Generator) -> np.ndarray:
    """Uniformly random composition of ``num_items`` into ``num_segments``
    positive parts (stars-and-bars via shuffled break indicators)."""
    breaks = np.zeros(num_items - 1, dtype=bool)
    breaks[: num_segments - 1] = True
    rng.shuffle(breaks)
    first_in_segment = np.concatenate([[True], breaks])
    segment_id = np.cumsum(first_in_segment)
    return np.bincount(segment_id)[1:]


def random_spans_noise_mask(
    length: int,
    noise_density: float = 0.25,
    mean_noise_span_length: float = 5.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Boolean [length] mask of noise spans."""
    rng = rng or np.random.default_rng()
    num_noise = int(np.round(length * noise_density))
    num_noise = min(max(num_noise, 1), length - 1)
    num_spans = max(int(np.round(num_noise / mean_noise_span_length)), 1)
    num_keep = length - num_noise

    noise_lens = _random_partition(num_noise, num_spans, rng)
    keep_lens = _random_partition(num_keep, num_spans, rng)
    # interleave keep/noise (starts with a keep span)
    interleaved = np.stack([keep_lens, noise_lens], axis=1).reshape(-1)
    span_starts = np.cumsum(interleaved)[:-1]
    indicator = np.zeros(length, dtype=np.int8)
    indicator[span_starts] = 1
    span_num = np.cumsum(indicator)
    return (span_num % 2 == 1)


def sentinel_mask_ids(mask: np.ndarray, text_vocab_size: int) -> np.ndarray:
    """Per-position sentinel encoding of a noise mask.

    Span-start positions get the sentinel id (descending from
    ``text_vocab_size - 1``); interior noise positions get ``-1`` (delete);
    kept positions get ``0`` (passthrough). Matches util/t5.py:3-16 with
    ``text_vocab_size = len(tokenizer) - num_bins``.
    """
    mask = mask.astype(np.int8)
    prev = np.roll(mask, 1)
    prev[0] = 0
    is_start = (mask == 1) & (prev == 0)
    span_index = np.cumsum(is_start)  # 1-based at starts
    ids = np.where(is_start, text_vocab_size - span_index, 0).astype(np.int64)
    ids[(mask == 1) & ~is_start] = -1
    return ids


def apply_sentinels(
    input_ids: np.ndarray, sentinel_ids: np.ndarray, eos_id: int
) -> np.ndarray:
    """Replace masked spans with their sentinel, drop span interiors, append EOS
    (util/t5.py:19-33 semantics)."""
    merged = np.where(sentinel_ids != 0, sentinel_ids, input_ids)
    kept = merged[merged >= 0]
    return np.concatenate([kept, [eos_id]]).astype(np.int64)


def span_corrupt(
    input_ids: Sequence[int],
    tokenizer,
    noise_density: float = 0.25,
    mean_noise_span_length: float = 5.0,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full denoising pair for one sequence.

    Returns ``(corrupted_inputs, targets)``. Sequences of length <= 1 fall
    back to the degenerate pair (dvc_dataset.py:139-142).
    """
    ids = np.asarray(input_ids, dtype=np.int64)
    if len(ids) <= 1:
        return np.array([0], dtype=np.int64), np.array([tokenizer.eos_token_id], dtype=np.int64)
    text_vocab = len(tokenizer) - tokenizer.num_bins
    mask = random_spans_noise_mask(len(ids), noise_density, mean_noise_span_length, rng)
    inp_sent = sentinel_mask_ids(mask, text_vocab)
    tgt_sent = sentinel_mask_ids(~mask, text_vocab)
    corrupted = apply_sentinels(ids, inp_sent, tokenizer.eos_token_id)
    targets = apply_sentinels(ids, tgt_sent, tokenizer.eos_token_id)
    return corrupted, targets
