"""Single-video ASR demo: transcribe, align, pickle.

Counterpart of ``vidchapters_tpu/demo/demo_asr.py`` (the reference's
demo_asr.py:16-26: Whisper large-v2 transcribes, whisperx aligns, a pickle
is written). The ``torch`` backend (the default, the JAX package's ``jax``)
reads an HF Whisper checkpoint itself: the directory, or the hub name found
offline in the HF cache (``utils/hf.resolve_hf_dir``), through
``models/whisper.load_hf_whisper`` and ``data/whisper_tokenizer``; it
transcribes with ``factory/whisper_transcribe.WhisperTranscriber`` (the
Whisper decode kernel on the card, greedy with temperature fallback) and
aligns words by cross-attention DTW (``factory/align``). The ``hf``
(``transformers.pipeline``) and ``whisperx`` (openai-whisper + whisperx)
backends are the JAX package's wrappers of other packages; the port does
not use them and raises before any work.

Usage:
  python -m vidchapters_tpu_torch.demo.demo_asr --video_path v.wav --out v.pkl \\
      [--model large-v2 | --model DIR_OR_HUB_NAME] [--vad] [--align] [--language en]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from vidchapters_tpu_torch.utils.io import save_pickle


def align_segments(model, tokenizer, audio, segments) -> dict:
    """Word times for transcribed ``segments`` by cross-attention DTW
    (``factory/align.align_words_batch``), the role whisperx.align plays in
    the reference demo, with the JAX demo's own rules: the training-time
    prefix cut to the vocabulary; each segment's window trimmed to
    ``min(end, start + 30 s, len(audio))``; segments with no text or under
    0.1 s of audio skipped; BPE pieces grouped into words at a leading
    space; one batched call; times offset by the segment's start and
    rounded to 3 decimals. Each segment gains ``words`` and a flat
    ``word_segments`` list is added."""
    import numpy as np

    from vidchapters_tpu_torch.factory.align import align_words_batch
    from vidchapters_tpu_torch.factory.audio import N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram
    from vidchapters_tpu_torch.factory.whisper_transcribe import (
        LANG_EN,
        NO_TIMESTAMPS,
        SOT,
        TRANSCRIBE,
    )

    vocab = int(model.cfg.vocab_size)
    prefix = tuple(t for t in (SOT, LANG_EN, TRANSCRIBE, NO_TIMESTAMPS) if t < vocab)
    todo = []  # (segment, mel, ids, token words, seconds)
    for seg in segments:
        seg["words"] = []
        ids = tokenizer.encode(seg["text"], add_special_tokens=False)
        s0 = int(seg["start"] * SAMPLE_RATE)
        s1 = int(min(seg["end"] * SAMPLE_RATE, s0 + N_SAMPLES, len(audio)))
        window = audio[s0:s1]
        if not ids or len(window) < SAMPLE_RATE // 10:
            continue
        # a word's text rides its first token; continuations pass ""
        words, firsts = [], []
        for i, piece in enumerate(tokenizer.decode([t]) for t in ids):
            if piece.startswith(" ") or not firsts:
                firsts.append(i)
                words.append(piece.strip())
            else:
                words[-1] += piece
        token_words = [""] * len(ids)
        for k, i in enumerate(firsts):
            token_words[i] = words[k]
        todo.append((seg, np.asarray(log_mel_spectrogram(window)), ids, token_words,
                     len(window) / SAMPLE_RATE))
    aligned = align_words_batch(model, [t[1] for t in todo], [t[2] for t in todo],
                                [t[3] for t in todo], [t[4] for t in todo], prefix_ids=prefix)
    word_segments = []
    for (seg, *_), words in zip(todo, aligned):
        for w in words:
            w["start"] = round(w["start"] + seg["start"], 3)
            w["end"] = round(w["end"] + seg["start"], 3)
        seg["words"] = words
        word_segments.extend(words)
    return {"segments": segments, "word_segments": word_segments}


def torch_transcribe(audio_path: str, model_name: str = "large-v2", vad: bool = False,
                     align: bool = False, language: str | None = None, device=None) -> dict:
    """The port's path (the JAX demo's ``jax_transcribe``): the HF
    checkpoint as the port's Whisper on ``device``, the transcriber's
    defaults (greedy, temperature fallback, the language detected per video
    unless ``language`` pins it), segments ``{text, start, end}`` and the
    ``language``; with ``align``, the word times of ``align_segments``.
    ``model_name`` ``large-v2`` is ``openai/whisper-large-v2``; a value
    holding ``/`` is a directory or a hub name already."""
    from vidchapters_tpu_torch import resolve_device
    from vidchapters_tpu_torch.data.whisper_tokenizer import (
        check_whisper_special_ids,
        load_whisper_tokenizer,
    )
    from vidchapters_tpu_torch.factory import whisper_transcribe
    from vidchapters_tpu_torch.factory.audio import load_audio
    from vidchapters_tpu_torch.models.whisper import load_hf_whisper
    from vidchapters_tpu_torch.utils.hf import resolve_hf_dir

    device = resolve_device(device)
    model_dir = resolve_hf_dir(model_name if "/" in model_name
                               else f"openai/whisper-{model_name}")
    tok = load_whisper_tokenizer(model_dir)
    check_whisper_special_ids(tok)
    model = load_hf_whisper(model_dir, device)
    tr = whisper_transcribe.WhisperTranscriber(model, decode_tokens=tok.decode, vad=vad,
                                               language=language, device=device)
    audio = load_audio(audio_path)
    out = tr.transcribe(audio)
    segments = [{"text": t, "start": s, "end": e}
                for t, s, e in zip(out["text"], out["start"], out["end"])]
    if align:
        aligned = align_segments(tr.model, tok, audio, segments)
        aligned.setdefault("language", out.get("language", "en"))
        return aligned
    return {"segments": segments, "language": out.get("language", "en")}


def transcribe(video_path: str, model_name: str = "large-v2", device=None,
               backend: str = "torch", vad: bool = False, align: bool = False,
               language: str | None = None) -> dict:
    if backend == "whisperx":
        raise NotImplementedError(
            "the 'whisperx' backend is openai-whisper + whisperx, which the PyTorch port "
            "does not use; --backend torch (the default) runs the port's own Whisper")
    if backend == "hf":
        from vidchapters_tpu_torch.factory.asr import make_hf_whisper_transcribe

        return make_hf_whisper_transcribe(f"openai/whisper-{model_name}", device,
                                          language=language)(video_path)
    return torch_transcribe(video_path, model_name, vad=vad, align=align, language=language,
                            device=device)


def main(args=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="large-v2",
                   help="large-v2 (openai/whisper-large-v2 in the HF cache), a hub name "
                        "or a checkpoint directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default="torch", choices=["torch", "hf", "whisperx"])
    p.add_argument("--vad", action="store_true",
                   help="energy-VAD silence skipping (the role whisperx's pyannote VAD "
                        "plays in the reference's --faster path)")
    p.add_argument("--align", action="store_true",
                   help="word-level timings via cross-attention DTW (the whisperx.align "
                        "step of the reference demo)")
    p.add_argument("--language", default=None,
                   help="pin the spoken language code (e.g. en); by default it is detected "
                        "per video, as the reference's bare model.transcribe does")
    a = p.parse_args(args)
    result = transcribe(a.video_path, a.model, a.device, a.backend, vad=a.vad, align=a.align,
                        language=a.language)
    save_pickle(result, a.out)
    print(f"wrote {a.out} ({len(result['segments'])} segments)")


if __name__ == "__main__":
    main()
