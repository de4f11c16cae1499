"""Vid2Seq training step and generation.

Counterpart of ``vidchapters_tpu/train/dvc_train.py``.

- ``make_train_step``: the generative loss, the denoising loss on the
  span-corrupted ASR reusing the generative pass's visual encoding (with its
  gradient, dvc.py:78-100), the weighted sum, the global-norm clip, AdamW
  with the cosine/warmup schedule, and the time-token embedding renorm
  (dvc.py:118-126). Dropout comes from a generator derived from (seed,
  step); the long attentions run the fused-attention kernels.
- ``make_generate_fn``: encode once, then greedy or beam decode, every step
  through the decode kernel (``ops/decode_megakernel``; on the CPU its
  plain version). The TPU package's tiling conditions for choosing that
  path (beams in {1,2,4,8}, ``B*beams % block``, gated ``d_ff % 128``) do
  not apply to the CUDA kernel and are dropped; the function computed is
  unchanged.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.config import GenerationConfig
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.ops.decode_megakernel import make_mega_decode_fns
from vidchapters_tpu_torch.ops.decoding import beam_search, greedy_decode
from vidchapters_tpu_torch.runtime.rng import StepRng
from vidchapters_tpu_torch.train.schedules import ClipAdamW

BATCH_FIELDS = ("video", "input_tokens", "output_tokens", "denoising_input_tokens",
                "denoising_output_tokens")


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments and count)
    and the step. ``train_step`` updates all three in place."""

    model: Vid2Seq
    optimizer: ClipAdamW
    step: int = 0


def _row_norms_mean(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.sqrt((xf * xf).sum(dim=1)).mean()


@torch.no_grad()
def renorm_time_tokens(model: Vid2Seq, num_bins: int) -> None:
    """Scale the time-token embedding rows (the last ``num_bins``) so their
    mean L2 norm is the text rows' mean norm (dvc.py:118-126), in place.
    The untied ``lm_head`` gets the same: it is ``[vocab, d]`` here
    (``[d, vocab]`` in JAX), so its norms run over rows."""
    heads = [model.t5.shared.weight]
    if hasattr(model.t5, "lm_head"):
        heads.append(model.t5.lm_head.weight)
    for w in heads:
        frozen, trainable = w[:-num_bins], w[-num_bins:]
        ratio = _row_norms_mean(frozen) / torch.clamp(_row_norms_mean(trainable), min=1e-8)
        w[-num_bins:] = trainable * ratio.to(w.dtype)


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The model's fields of a collated numpy batch as tensors on ``device``
    (features float32, token ids int64)."""
    out = {}
    for name in BATCH_FIELDS:
        if name in batch:
            arr = np.asarray(batch[name])
            dtype = torch.float32 if name == "video" else torch.int64
            out[name] = torch.as_tensor(arr, dtype=dtype).to(device, non_blocking=True)
    return out


def make_train_step(model: Vid2Seq, generative: float = 1.0, denoising: float = 1.0,
                    genasr: bool = False) -> Callable:
    """``train_step(state, batch, seed) -> metrics``: one update of
    ``state`` (in place) on ``batch`` (``batch_to_device`` fields on the
    model's device), with dropout drawn from ``StepRng(seed, state.step)``.
    Metrics are 0-d tensors on the device: ``loss``, ``denoising_loss``,
    ``total_loss``, and ``grad_norm`` of the raw gradients. After the step
    every parameter's ``.grad`` still holds that step's raw gradient."""
    num_bins = model.cfg.num_bins

    def loss_fn(batch: Dict[str, torch.Tensor], rng: StepRng
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        losses = {}
        video_embeds = None
        video = batch["video"]
        if generative:
            if genasr:  # HowTo100M: generate the ASR from the video alone (dvc.py:59-68)
                inp = torch.ones((video.shape[0], 1), dtype=torch.int64, device=video.device)
            else:
                inp = batch["input_tokens"]
            out = model(video, inp, (inp != 0).to(torch.int32), batch["output_tokens"],
                        rng=rng)
            losses["loss"] = out["loss"]
            video_embeds = out.get("video_embeds")
        if denoising:
            den = batch["denoising_input_tokens"]
            out_d = model(video, den, (den != 0).to(torch.int32),
                          batch["denoising_output_tokens"], video_embeds=video_embeds,
                          rng=rng)
            losses["denoising_loss"] = out_d["loss"]
        total = (generative * losses.get("loss", 0.0)
                 + denoising * losses.get("denoising_loss", 0.0))
        return total, losses

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Dict[str, torch.Tensor]:
        device = next(state.model.parameters()).device
        rng = StepRng(seed, state.step, device)
        state.model.zero_grad(set_to_none=True)
        total, losses = loss_fn(batch, rng)
        total.backward()
        grad_norm = state.optimizer.step()
        renorm_time_tokens(state.model, num_bins)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_generate_fn(model: Vid2Seq, gen: GenerationConfig) -> Callable:
    """``generate(video [B,T,D], input_tokens [B,S]) -> [B, max_length]``
    int32 token ids, on the device of ``model``'s parameters.

    Weights are cast once to ``gen.param_dtype`` (the JAX package casts
    every float32 leaf inside its jitted generate); compute runs in the
    model config's dtype (bfloat16 by default)."""
    if gen.use_nucleus_sampling or gen.num_beams == 0:
        raise NotImplementedError(
            "nucleus sampling is not ported yet (ROADMAP.md: standard incremental "
            "decode and nucleus sampling)")
    cast_to = getattr(torch, getattr(gen, "param_dtype", "float32"))
    if cast_to != torch.float32:
        model = copy.deepcopy(model).to(cast_to)
    model.eval()
    beams = gen.num_beams if gen.num_beams > 1 else 1
    fns = make_mega_decode_fns(model.t5, gen.max_length, num_beams=beams)

    @torch.inference_mode()
    def generate(video: torch.Tensor, input_tokens: torch.Tensor) -> torch.Tensor:
        attn = (input_tokens != 0).to(torch.int32)
        enc_out, enc_mask = model.encode_for_generation(video, input_tokens, attn)
        if beams == 1:
            return greedy_decode(fns, enc_out, enc_mask, gen.max_length,
                                 min_length=gen.min_length,
                                 repetition_penalty=gen.repetition_penalty)
        return beam_search(fns, enc_out, enc_mask, gen.max_length,
                           num_beams=gen.num_beams,
                           length_penalty=gen.length_penalty,
                           min_length=gen.min_length,
                           repetition_penalty=gen.repetition_penalty)

    return generate
