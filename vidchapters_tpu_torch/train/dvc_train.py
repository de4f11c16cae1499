"""Vid2Seq generation: encode once, then greedy or beam decode.

Counterpart of ``make_generate_fn`` in ``vidchapters_tpu/train/dvc_train.py``.
Every greedy or beam decode goes through the decode kernel
(``ops/decode_megakernel``); on the CPU that runs its plain version. The
TPU package's tiling conditions for choosing that path (beams in
{1,2,4,8}, ``B*beams % block``, gated ``d_ff % 128``) do not apply to the
CUDA kernel and are dropped; the function computed is unchanged. Training
is not ported yet.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from vidchapters_tpu_torch.config import GenerationConfig
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.ops.decode_megakernel import make_mega_decode_fns
from vidchapters_tpu_torch.ops.decoding import beam_search, greedy_decode


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
