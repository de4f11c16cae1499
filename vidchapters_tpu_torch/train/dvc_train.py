"""Vid2Seq training step and generation.

Counterpart of ``vidchapters_tpu/train/dvc_train.py``.

- ``make_train_step``: the generative loss, the denoising loss on the
  span-corrupted ASR reusing the generative pass's visual encoding (with its
  gradient, dvc.py:78-100), the weighted sum, the global-norm clip, AdamW
  with the cosine/warmup schedule, and the time-token embedding renorm
  (dvc.py:118-126). Dropout comes from a generator derived from (seed,
  step, data rank); the long attentions run the fused-attention kernels.
  Over a ``(data, model)`` grid of ranks the step is the global batch's
  (``parallel/sharding.py``), the model sharded over the model axis.
- ``make_generate_fn``: encode once, then greedy, beam or nucleus decode.
  ``_pick_decode_fns`` chooses the route: greedy and beam search take the
  decode kernel (``ops/decode_megakernel``) unless ``models.t5.
  USE_MEGA_DECODE`` is False, nucleus sampling always takes the standard
  cached decode (``ops/decoding.make_decode_fns``, whose attentions are the
  ``ops/decode_attention`` kernels). On the CPU every kernel runs its plain
  version. The TPU package's tiling conditions for the decode kernel
  (beams in {1,2,4,8}, ``B*beams % block``, gated ``d_ff % 128``) do not
  apply to the CUDA kernel and are dropped; the function computed is
  unchanged.
- ``evaluate``: generate per batch, parse the chapters, gather every
  rank's, score them with ``eval_dvc`` + ``eval_soda``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.config import GenerationConfig
from vidchapters_tpu_torch.data.time_tokens import decode_chapter_sequence
from vidchapters_tpu_torch.models import t5 as t5_mod
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.ops.decode_megakernel import make_mega_decode_fns
from vidchapters_tpu_torch.ops.decoding import (
    DecodeFns,
    beam_search,
    greedy_decode,
    make_decode_fns,
    nucleus_sample,
)
from vidchapters_tpu_torch.parallel import tensor_parallel as tp
from vidchapters_tpu_torch.parallel.sharding import (
    all_reduce_gradients,
    gather_params,
    global_counts,
    is_sharded,
    reduce_model_gradients,
    sum_shares,
)
from vidchapters_tpu_torch.runtime import mesh
from vidchapters_tpu_torch.runtime.collectives import gather_results
from vidchapters_tpu_torch.runtime.rng import StepRng
from vidchapters_tpu_torch.train.schedules import ClipAdamW
from vidchapters_tpu_torch.utils.hf import meta_build

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
    (``[d, vocab]`` in JAX), so its norms run over rows. Sharded by
    vocabulary rows, each mean is a sum of row norms over the model group
    divided by the row count, and each rank scales the time rows it holds."""
    heads = [model.t5.shared.weight]
    if hasattr(model.t5, "lm_head"):
        heads.append(model.t5.lm_head.weight)
    sharded = is_sharded(model)
    for w in heads:
        if sharded:
            _renorm_sharded(w, num_bins, model.cfg.t5.vocab_size)
            continue
        frozen, trainable = w[:-num_bins], w[-num_bins:]
        ratio = _row_norms_mean(frozen) / torch.clamp(_row_norms_mean(trainable), min=1e-8)
        w[-num_bins:] = trainable * ratio.to(w.dtype)


def _renorm_sharded(w: torch.Tensor, num_bins: int, vocab: int) -> None:
    """``renorm_time_tokens`` of this rank's rows ``w`` of a ``[vocab, d]``
    table: the time rows are the global rows from ``vocab - num_bins``."""
    n = w.shape[0]
    first = vocab - num_bins - mesh.model_rank() * n  # the first time row, locally
    first = min(max(first, 0), n)
    wf = w.float()
    norms = torch.sqrt((wf * wf).sum(dim=1))
    sums = tp.all_reduce(torch.stack([norms[:first].sum(), norms[first:].sum()]))
    ratio = (sums[0] / (vocab - num_bins)) / torch.clamp(sums[1] / num_bins, min=1e-8)
    w[first:] = w[first:] * ratio.to(w.dtype)


def gathered_model(model: Vid2Seq) -> Vid2Seq:
    """The whole model of one sharded over the model axis, on its device
    (every rank of the model group calls this; its whole parameters are
    shared, not copied); ``model`` itself when it is not sharded. Generation
    and evaluation run on it."""
    if not is_sharded(model):
        return model
    state = gather_params(model)
    with meta_build():
        whole = Vid2Seq(model.cfg)
    whole.load_state_dict(state, assign=True)
    return whole


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


def target_counts(batch: Mapping) -> Tuple[int, int]:
    """(generative, denoising) target tokens of a batch: the nonzero
    ``output_tokens`` and ``denoising_output_tokens``, the labels the loss
    does not ignore (``Vid2Seq.forward``). A host batch gives them without
    a read from the card."""
    return tuple(int((batch[k] != 0).sum()) if k in batch else 0
                 for k in ("output_tokens", "denoising_output_tokens"))


def make_train_step(model: Vid2Seq, generative: float = 1.0, denoising: float = 1.0,
                    genasr: bool = False) -> Callable:
    """``train_step(state, batch, seed, counts=None) -> metrics``: one
    update of ``state`` (in place) on ``batch`` (``batch_to_device`` fields
    on the model's device), with dropout drawn from ``StepRng(seed,
    state.step, rank)``. Metrics are 0-d tensors on the device: ``loss``,
    ``denoising_loss``, ``total_loss``, and ``grad_norm`` of the raw
    gradients. After the step every parameter's ``.grad`` still holds that
    step's raw gradient.

    In a process group (``runtime/mesh.py``), ``batch`` is this data rank's
    rows and the step is that of the global batch over the grid, as JAX's
    jitted step over a batch sharded on the data axis: each loss term
    divides its sum by the global count of its target tokens (``counts``,
    this rank's ``target_counts`` of the host batch, summed over the data
    group on the host; required there), the gradients are summed over the
    data group before the clip and the update, and the metrics are the
    global batch's. A model sharded over the model axis
    (``parallel/sharding.shard_params``) first sums the gradients of its
    split whole parameters over the model group; its norm and its
    time-token renorm are the whole model's."""
    num_bins = model.cfg.num_bins
    data_parallel = mesh.distributed()
    sharded = is_sharded(model)

    def loss_fn(batch: Dict[str, torch.Tensor], rng: StepRng, denoms: Tuple
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
                        rng=rng, loss_denom=denoms[0])
            losses["loss"] = out["loss"]
            video_embeds = out.get("video_embeds")
        if denoising:
            den = batch["denoising_input_tokens"]
            out_d = model(video, den, (den != 0).to(torch.int32),
                          batch["denoising_output_tokens"], video_embeds=video_embeds,
                          rng=rng, loss_denom=denoms[1])
            losses["denoising_loss"] = out_d["loss"]
        total = (generative * losses.get("loss", 0.0)
                 + denoising * losses.get("denoising_loss", 0.0))
        return total, losses

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                   counts: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        device = next(state.model.parameters()).device
        rng = StepRng(seed, state.step, device, rank=mesh.data_rank())
        denoms = (None, None)
        if data_parallel:  # each term divided by its global batch's count
            if counts is None:
                raise ValueError("in a process group the step takes the host batch's "
                                 "target_counts as counts")
            denoms = tuple(global_counts(counts))
        state.model.zero_grad(set_to_none=True)
        total, losses = loss_fn(batch, rng, denoms)
        total.backward()
        if sharded:
            reduce_model_gradients(state.model)
        if data_parallel:
            all_reduce_gradients(state.model.parameters())
        grad_norm = state.optimizer.step()
        renorm_time_tokens(state.model, num_bins)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics = sum_shares(metrics)  # the ranks' shares sum to the global losses
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def _is_nucleus(gen: GenerationConfig) -> bool:
    return gen.use_nucleus_sampling or gen.num_beams == 0


def _pick_decode_fns(model: Vid2Seq, gen: GenerationConfig) -> DecodeFns:
    """The decode kernel for greedy and beam search unless
    ``t5.USE_MEGA_DECODE`` is False; the standard cached decode for nucleus
    sampling, always (dvc_train.py:121-152 there)."""
    if not _is_nucleus(gen) and t5_mod.USE_MEGA_DECODE is not False:
        beams = gen.num_beams if gen.num_beams > 1 else 1
        return make_mega_decode_fns(model.t5, gen.max_length, num_beams=beams)
    return make_decode_fns(model, gen.max_length)


def make_generate_fn(model: Vid2Seq, gen: GenerationConfig) -> Callable:
    """``generate(video [B,T,D], input_tokens [B,S], generator=None) ->
    [B, max_length]`` int32 token ids, on the device of ``model``'s
    parameters. Nucleus sampling draws from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when None).

    Weights are cast once to ``gen.param_dtype`` (the JAX package casts
    every float32 leaf inside its jitted generate); compute runs in the
    model config's dtype (bfloat16 by default). ``generate.decode_steps``
    is the number of decode steps its last call ran (each step's stop test
    is read on the host, so the count is final when the call returns)."""
    if is_sharded(model):
        raise ValueError("generate on the gathered weights (parallel/sharding.gather_params)")
    cast_to = getattr(torch, getattr(gen, "param_dtype", "float32"))
    if cast_to != torch.float32:
        model = copy.deepcopy(model).to(cast_to)
    model.eval()
    fns = _pick_decode_fns(model, gen)
    step = fns.step

    def counted_step(*args, **kwargs):
        generate.decode_steps += 1
        return step(*args, **kwargs)

    fns = fns._replace(step=counted_step)

    @torch.inference_mode()
    def generate(video: torch.Tensor, input_tokens: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generate.decode_steps = 0
        attn = (input_tokens != 0).to(torch.int32)
        enc_out, enc_mask = model.encode_for_generation(video, input_tokens, attn)
        if _is_nucleus(gen):
            if generator is None:
                generator = torch.Generator(device=enc_out.device).manual_seed(0)
            return nucleus_sample(fns, enc_out, enc_mask, gen.max_length, generator,
                                  top_p=gen.top_p, temperature=gen.temperature,
                                  min_length=gen.min_length)
        if gen.num_beams <= 1:
            return greedy_decode(fns, enc_out, enc_mask, gen.max_length,
                                 min_length=gen.min_length,
                                 repetition_penalty=gen.repetition_penalty)
        return beam_search(fns, enc_out, enc_mask, gen.max_length,
                           num_beams=gen.num_beams,
                           length_penalty=gen.length_penalty,
                           min_length=gen.min_length,
                           repetition_penalty=gen.repetition_penalty)

    generate.decode_steps = 0
    return generate


def evaluate(model: Vid2Seq, data_iter: Iterable[Mapping], tokenizer,
             gen: GenerationConfig, num_bins: int,
             references: Optional[List] = None,
             seed: int = 0) -> Tuple[Dict[str, list], Dict[str, float]]:
    """Decode every batch on the device of ``model``'s parameters, parse the
    chapters, gather every rank's predictions (each rank decodes its shard
    of the videos), and score them when ``references`` are given
    (dvc_train.py:192-226 there). Batch n of a nucleus run samples from a
    generator seeded ``seed + n``.

    Returns (predictions in the submission schema ``{vid: [{sentence,
    timestamp}]}``, metrics of ``eval_dvc`` + ``eval_soda``)."""
    generate = make_generate_fn(model, gen)
    device = next(model.parameters()).device
    results: Dict[str, list] = {}
    for n, batch in enumerate(data_iter):
        input_tokens = batch.get("input_tokens")
        if input_tokens is None:
            input_tokens = np.ones((batch["video"].shape[0], 1), np.int32)
        generator = torch.Generator(device=device).manual_seed(seed + n)
        seqs = generate(torch.as_tensor(np.asarray(batch["video"]), dtype=torch.float32,
                                        device=device),
                        torch.as_tensor(np.asarray(input_tokens), device=device), generator)
        texts = tokenizer.batch_decode(seqs.cpu().numpy(), skip_special_tokens=True)
        for i, vid in enumerate(batch["video_id"]):
            results[vid] = decode_chapter_sequence(texts[i], float(batch["duration"][i]),
                                                   num_bins)
    results = gather_results(results)
    metrics: Dict[str, float] = {}
    if references:
        from vidchapters_tpu_torch.evals import eval_dvc, eval_soda

        submission = {"results": results}
        metrics.update(eval_dvc(submission, references, seed=seed))
        metrics.update(eval_soda(submission, references))
    return results, metrics
