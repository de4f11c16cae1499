"""Zero-shot speech-based video chapter generation: the port's own copy of
``vidchapters_tpu/zeroshot/speech_vcg.py``.

Counterpart of zs_speechvcg.py: the ASR transcript is segmented into topical
sections with TextTiling; each section's time span comes from its first/last
subtitle line; the section title is produced by a pluggable ``titler``
(LLaMA-7B with the reference's prompt, zs_speechvcg.py:190, behind an
optional hook) or, with ``random_title``, a random ASR line from the section
(183). Returns predictions in the DVC submission schema for eval_dvc/SODA.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from vidchapters_tpu_torch.zeroshot.texttiling import TextTilingTokenizer

# exact reference prompt (zs_speechvcg.py:196); the model continues after
# "Chapter title:" and the continuation is the title
LLM_PROMPT = (
    "Summarize the following speech transcript in a chapter title. "
    "Transcript:{} Chapter title:"
)


def first_sentence_titler(segment_lines: List[str]) -> str:
    return segment_lines[0] if segment_lines else ""


def make_random_titler(rng: Optional[np.random.Generator] = None) -> Callable:
    rng = rng or np.random.default_rng()

    def titler(segment_lines: List[str]) -> str:
        if not segment_lines:
            return ""
        return segment_lines[int(rng.integers(len(segment_lines)))]

    return titler


def make_llm_titler(generate_fn: Callable[[str], str]) -> Callable:
    """Wrap a text-in/continuation-out LLM with the reference prompt
    (zs_speechvcg.py:190-199: transcript lines joined, trailing period,
    greedy 20 new tokens; the continuation after "Chapter title:" is the
    title).  ``generate_fn`` must return only the continuation — e.g.
    :func:`vidchapters_tpu_torch.models.llama.make_llama_generate_fn`, the
    port's LLaMA behind a tokenizer."""

    def titler(segment_lines: List[str]) -> str:
        transcript = " ".join(segment_lines).replace("\n", "").strip()
        if transcript and transcript[-1] != ".":
            transcript = transcript + "."
        out = generate_fn(LLM_PROMPT.format(transcript))
        return out.strip().split("\n")[0].strip()

    return titler


def speech_chapters(sub: Dict[str, list], duration: float,
                    titler: Callable[[List[str]], str] = first_sentence_titler,
                    tiler: Optional[TextTilingTokenizer] = None
                    ) -> List[dict]:
    """sub = {"text": [...], "start": [...], "end": [...]} ->
    [{"sentence", "timestamp"}] predictions."""
    texts = [t for t in sub.get("text", [])]
    if not texts:
        return []
    tiler = tiler or TextTilingTokenizer()
    # paragraph per ASR line so boundaries snap to line edges
    doc = "\n".join(texts)
    segments = tiler.tokenize(doc)

    # map segment -> line indices by walking the document
    chapters = []
    line_idx = 0
    for seg in segments:
        n_lines = max(len([l for l in seg.split("\n") if l.strip()]), 1)
        lines = texts[line_idx: line_idx + n_lines]
        if not lines:
            break
        start = float(sub["start"][line_idx])
        end_idx = min(line_idx + n_lines - 1, len(sub["end"]) - 1)
        end = float(min(sub["end"][end_idx], duration))
        title = titler(lines)
        if title and end > start:
            chapters.append({"sentence": title, "timestamp": [start, end]})
        line_idx += n_lines
    return chapters
