"""Chapter-title captioning with GT boundaries (VC task): the train step
and the evaluation.

Counterpart of ``vidchapters_tpu/train/vc_train.py`` (the reference's
vc.py:26-176): the Vid2Seq model trains on (clip features, clip ASR) ->
title with the generative loss only (no denoising, no time-token renorm);
evaluation generates a title per GT clip through ``dvc_train.
make_generate_fn`` (beam and greedy on the decode kernel) and scores the
titles with the COCO captioning metrics (``evals.captioning``).
Tokenization happens in the loop (vc.py:48-49).

``strip_time_tokens`` reproduces vc.py:304-308: a DVC checkpoint loaded for
the VC task loses its time-token rows (the VC variant's vocab is text only).

The zero-shot evaluators: ``evaluate_vc_with_captioner`` (any captioner,
e.g. the ``random`` baseline that scores the ASR), ``evaluate_vc_blip2``
(BLIP-2 on each clip's first raw frame, ``models/blip2``) and
``evaluate_vc_llama`` (LLaMA on each clip's ASR, ``models/llama``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.config import GenerationConfig
from vidchapters_tpu_torch.data.dvc_dataset import pick_bucket
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.runtime.rng import StepRng
from vidchapters_tpu_torch.train.dvc_train import TrainState, make_generate_fn


def tokenize_batch(texts: List[str], tokenizer, max_tokens: int, buckets=None) -> np.ndarray:
    """Tokenize + zero-pad to ``max_tokens`` (EOS-terminated, truncated);
    with ``buckets`` (``DataConfig.output_buckets``-style) pad instead to
    the smallest bucket covering the batch."""
    ids_list = []
    for t in texts:
        ids = tokenizer.encode(t, add_special_tokens=True, max_length=max_tokens,
                               truncation=True)
        if not ids or ids[-1] != tokenizer.eos_token_id:
            ids = (ids + [tokenizer.eos_token_id])[:max_tokens]
        ids_list.append(ids)
    if buckets:
        max_tokens = pick_bucket(max(len(i) for i in ids_list), buckets, max_tokens)
    out = np.zeros((len(texts), max_tokens), np.int64)
    for i, ids in enumerate(ids_list):
        out[i, : len(ids)] = ids
    return out


def strip_time_tokens(state_dict: Mapping[str, torch.Tensor], num_bins: int
                      ) -> Dict[str, torch.Tensor]:
    """A copy of a Vid2Seq ``state_dict`` without the trailing ``num_bins``
    time-token rows of the embedding and of an untied ``lm_head``
    (``[vocab, d]`` here, so rows; vc.py:304-308)."""
    out = {k: v.clone() for k, v in state_dict.items()}
    for name in ("t5.shared.weight", "t5.lm_head.weight"):
        if name in out:
            out[name] = out[name][:-num_bins].clone()
    return out


def make_vc_train_step(model: Vid2Seq) -> Callable:
    """``train_step(state, batch, seed) -> metrics``: one update of
    ``state`` (a ``dvc_train.TrainState``, in place) on ``batch``
    (``video`` [B, T, D] float32, ``input_tokens`` and ``output_tokens``
    int64, on the model's device) with the generative loss, dropout drawn
    from ``StepRng(seed, state.step)``. Metrics are 0-d device tensors:
    ``loss`` and ``grad_norm`` of the raw gradients."""

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int) -> Dict[str, torch.Tensor]:
        rng = StepRng(seed, state.step, batch["video"].device)
        state.model.zero_grad(set_to_none=True)
        inp = batch["input_tokens"]
        loss = state.model(batch["video"], inp, (inp != 0).to(torch.int32),
                           batch["output_tokens"], rng=rng)["loss"]
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def evaluate_vc_with_captioner(dataset, captioner) -> Tuple[Dict, Dict[str, float]]:
    """Zero-shot VC eval with any captioner (the dispatch of
    vc.py:109-154,268-283): ``captioner(video_clip, asr_text) -> str``."""
    from vidchapters_tpu_torch.evals.captioning import eval_vc

    results = {}
    uid = 0
    for idx in range(len(dataset)):
        ex = dataset[idx]
        for clip, asr, gt in zip(ex["video"], ex["input_text"], ex["output_text"]):
            results[uid] = {"sentence": captioner(clip, asr), "gt": gt}
            uid += 1
    return results, (eval_vc(results) if results else {})


# exact reference prompts (vc.py:112, vc.py:127-128)
VC_BLIP2_PROMPT = "Summarize the image in a chapter title. Chapter title:"
VC_LLAMA_PROMPT = ("Summarize the following speech transcript in a chapter "
                   "title. Transcript:{} Chapter title:")


def evaluate_vc_blip2(dataset, caption_fn) -> Tuple[Dict, Dict[str, float]]:
    """The BLIP-2 eval dispatch (vc.py:111-124): caption the first raw frame
    of every clip with the fixed prompt. ``caption_fn(frames_uint8, prompt)
    -> list[str]`` comes from ``models.blip2.build_blip2_captioner``; the
    dataset must be built with ``videos_path`` so examples carry
    ``raw_first_frames``."""
    from vidchapters_tpu_torch.evals.captioning import eval_vc

    results = {}
    uid = 0
    for idx in range(len(dataset)):
        ex = dataset[idx]
        preds = caption_fn(ex["raw_first_frames"], VC_BLIP2_PROMPT)
        for pred, gt in zip(preds, ex["output_text"]):
            results[uid] = {"sentence": pred.strip(), "gt": gt}
            uid += 1
    return results, (eval_vc(results) if results else {})


def evaluate_vc_llama(dataset, generate_fn) -> Tuple[Dict, Dict[str, float]]:
    """The LLaMA eval dispatch (vc.py:126-139): prompt on each clip's ASR
    text; the continuation is the title. ``generate_fn(prompt) -> str``,
    e.g. ``models.llama.make_llama_generate_fn``."""
    return evaluate_vc_with_captioner(
        dataset, lambda clip, asr: generate_fn(VC_LLAMA_PROMPT.format(asr)).strip())


def evaluate_vc(model: Vid2Seq, dataset, tokenizer, gen: GenerationConfig,
                max_input_tokens: int = 256, batch_clips: int = 16, seed: int = 0
                ) -> Tuple[Dict, Dict[str, float]]:
    """A title for every GT clip of every video, ``batch_clips`` clips a
    generate call, on the device of ``model``'s parameters; then the COCO
    captioning metrics (vc.py:89-176 + dvc_eval/eval_vc.py). Generate call
    n of a nucleus run samples from a generator seeded ``seed + n``."""
    from vidchapters_tpu_torch.evals.captioning import eval_vc

    generate = make_generate_fn(model, gen)
    device = next(model.parameters()).device
    results = {}
    uid = 0
    calls = 0
    for idx in range(len(dataset)):
        ex = dataset[idx]
        clips = ex["video"]  # [n_clips, T, D]
        inputs = tokenize_batch(ex["input_text"], tokenizer, max_input_tokens)
        texts: List[str] = []
        for s in range(0, len(clips), batch_clips):
            generator = torch.Generator(device=device).manual_seed(seed + calls)
            calls += 1
            seqs = generate(
                torch.as_tensor(np.asarray(clips[s:s + batch_clips]), dtype=torch.float32,
                                device=device),
                torch.as_tensor(inputs[s:s + batch_clips], device=device), generator)
            texts.extend(tokenizer.batch_decode(seqs.cpu().numpy(), skip_special_tokens=True))
        for pred, gt in zip(texts, ex["output_text"]):
            results[uid] = {"sentence": pred, "gt": gt}
            uid += 1
    return results, (eval_vc(results) if results else {})
