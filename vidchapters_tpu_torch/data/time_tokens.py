"""Time-token quantization, sequence construction, and chapter decoding.

Reference semantics:
- quantization: ``int((num_bins - 1) * t / duration) + num_text_tokens``
  (dataset/dvc_dataset.py:88-91);
- input sequences interleave ``[t_start, t_end, text...]`` per ASR line,
  truncated to ``max_tokens - 1`` then EOS-terminated
  (dataset/dvc_dataset.py:113-122); outputs likewise over events
  (dvc_dataset.py:144-155);
- decoding: split the generated string on whitespace, find adjacent time-token
  pairs, take following words as the caption, de-quantize
  ``token * duration / (num_bins - 1)``, drop empty/invalid (end <= start)
  events, and never treat 3 consecutive time tokens as two events
  (dvc.py:186-212).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

_TIME_TOKEN_RE = re.compile(r"\<time\=(\d+)\>")
# split on whitespace except inside a broken-up time token (dvc.py:187)
_SPLIT_RE = re.compile(r"(?<!<)\s+(?!>)")


def time_to_token(t: float, duration: float, num_bins: int, num_text_tokens: int) -> int:
    """Quantize an absolute time to a time-token id."""
    bin_idx = int(float((num_bins - 1) * t) / float(duration))
    assert bin_idx <= num_bins, (t, duration, bin_idx)
    return bin_idx + num_text_tokens


def token_to_time(token_bin: int, duration: float, num_bins: int) -> float:
    """De-quantize a time-token *bin index* back to seconds (dvc.py:202)."""
    return float(token_bin) * float(duration) / float(num_bins - 1)


def normalize_caption(text: str) -> str:
    """Caption normalization applied to every sentence/subtitle
    (dvc_dataset.py:54-59): strip, capitalize, ensure trailing period."""
    text = text.strip()
    text = text.capitalize()
    if text and text[-1] != ".":
        text = text + "."
    return text


def build_time_text_sequence(
    starts: Sequence[float],
    ends: Sequence[float],
    texts: Sequence[str],
    duration: float,
    tokenizer,
    num_bins: int,
    max_tokens: int,
    filter_to_duration: bool = False,
) -> List[int]:
    """Build ``[t_s, t_e, text tokens]*`` capped at ``max_tokens`` with EOS.

    With ``filter_to_duration`` the (start >= 0, end <= duration) filter from
    the subtitle path (dvc_dataset.py:106-112) is applied first; annotations
    are used as-is (dvc_dataset.py:144-155).
    """
    num_text_tokens = len(tokenizer) - num_bins
    items = list(zip(starts, ends, texts))
    if filter_to_duration:
        items = [(s, e, t) for (s, e, t) in items if s >= 0 and e <= duration]
        if not items:
            return [tokenizer.eos_token_id]
    ids: List[int] = []
    for st, ed, text in items:
        ids.append(time_to_token(st, duration, num_bins, num_text_tokens))
        ids.append(time_to_token(ed, duration, num_bins, num_text_tokens))
        ids.extend(tokenizer.encode(normalize_caption(text), add_special_tokens=False,
                                    max_length=max_tokens, truncation=True))
    ids = ids[: max_tokens - 1]
    ids.append(tokenizer.eos_token_id)
    return ids


def decode_chapter_sequence(
    text: str, duration: float, num_bins: int
) -> List[Dict[str, object]]:
    """Parse a generated string into ``[{sentence, timestamp:[s,e]}]``.

    Behavioral port of the eval decoding loop (dvc.py:186-212).
    """
    sequences = _SPLIT_RE.split(text)
    is_time = [s[:6] == "<time=" for s in sequences]
    starts = [j for j in range(len(sequences) - 1) if is_time[j] and is_time[j + 1]]
    events: List[Dict[str, object]] = []
    last_processed = -2
    for j, idx in enumerate(starts):
        if idx == last_processed + 1:  # 3 time tokens in a row != 2 events
            continue
        stop = starts[j + 1] if j < len(starts) - 1 else len(sequences)
        words = [sequences[k] for k in range(idx + 2, stop) if sequences[k] != "<time="]
        if not words:
            continue
        m_start = _TIME_TOKEN_RE.search(sequences[idx])
        m_end = _TIME_TOKEN_RE.search(sequences[idx + 1])
        if not m_start or not m_end:
            continue
        start = token_to_time(int(m_start.group(1)), duration, num_bins)
        end = token_to_time(int(m_end.group(1)), duration, num_bins)
        if end <= start:
            continue
        events.append({"sentence": " ".join(words), "timestamp": [start, end]})
        last_processed = idx
    return events
