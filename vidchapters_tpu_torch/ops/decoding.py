"""Autoregressive decoding: greedy, beam search and nucleus sampling over a
static KV cache.

Counterpart of ``vidchapters_tpu/ops/decoding.py`` with the same HF beam
semantics as the reference configures them (num_beams=4, length penalty,
early_stopping=False, min_length): scores are summed log-probs; finished
hypotheses rank by ``score / len**penalty``; the loop ends when no running
beam can still improve the worst kept hypothesis or ``max_length`` is
reached; with nothing finished the best running beam is returned.

The JAX ``while_loop`` becomes a Python loop whose stop test is read on the
host every step (one device sync per step): running extra steps could
change the chosen hypothesis, so the test is neither skipped nor batched.

The beam step's top-2K runs through ``_topk_small``: the ``csrc/topk.cu``
kernel for CUDA tensors, ``_topk_iterative`` for CPU tensors. Both give
``lax.top_k``'s order (ties to the smallest index); ``torch.topk`` does not
promise that order, so no top-k here uses it.

``make_decode_fns`` binds a model's standard cached decode (``init_cache``
/ ``decode_step``); ``ops/decode_megakernel.make_mega_decode_fns`` the
decode kernel. Nucleus sampling draws with an explicit ``torch.Generator``:
``jax.random``'s stream cannot be reproduced, so the port is held to the
JAX package by its filter and by the distribution it samples.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.ops._build import (I, P, CudaKernel, arrival_counters, sm_count,
                                              stream_ptr)

NEG_INF = -1.0e7

TOPK_KERNEL = CudaKernel("topk", {"topk": [P] * 6 + [I] * 5 + [P]})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class DecodeFns(NamedTuple):
    init_cache: Callable[[int, torch.Tensor], Any]
    step: Callable[[torch.Tensor, Any, int, torch.Tensor], Tuple[torch.Tensor, Any]]
    # beam search's cache reorder, ``reorder_beam_cache`` when None (the
    # decode kernel defers the permutation into its next step)
    reorder_cache: Any = None


def make_decode_fns(model, max_length: int) -> DecodeFns:
    """The standard cached decode of ``model`` (Vid2Seq or the T5) as
    ``DecodeFns``: ``init_cache(batch, enc_out)`` takes the per-beam row
    count and the per-example encoder states. The decoder's self-attention
    bias table is built here, once."""
    with torch.no_grad():
        t5 = getattr(model, "t5", model)
        bias_table = t5.decoder.decode_bias_table(max_length)

    def init_cache(batch: int, enc_out: torch.Tensor):
        return model.init_cache(batch, max_length, enc_out)

    def step(tokens: torch.Tensor, cache, index: int, enc_mask: torch.Tensor):
        return model.decode_step(tokens, cache, index, enc_mask, bias_table)

    return DecodeFns(init_cache, step)


def reorder_beam_cache(cache, flat_src: torch.Tensor):
    """Permute a decode cache's per-beam rows to follow the surviving beams:
    a row gather of every tensor whose leading dimension is the beam-flat
    row count, except under any ``cross`` key (per-example K/V and live
    encoder keys, which the beams share)."""
    rows = flat_src.shape[0]
    src = flat_src.long()

    def reorder(x):
        if isinstance(x, dict):
            return {k: (v if k == "cross" else reorder(v)) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == rows:
            return x.index_select(0, src)
        return x

    return reorder(cache)


def _apply_repetition_penalty(logits: torch.Tensor, sequences: torch.Tensor,
                              penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for tokens already generated
    (the zero padding counts, as in the JAX package), divide positive logits
    by ``penalty`` and multiply negative ones."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, sequences.long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _topk_iterative(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` for small k via k argmax sweeps (argmax takes the first
    maximum, so ties go to the smallest index). The top-k kernel's plain
    version."""
    vals, idxs = [], []
    neg = torch.finfo(x.dtype).min
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    for _ in range(k):
        top = torch.argmax(x, dim=-1)
        vals.append(torch.gather(x, 1, top[:, None])[:, 0])
        idxs.append(top.to(torch.int32))
        x = torch.where(cols == top[:, None], torch.full_like(x, neg), x)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _topk_small(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``x [B, N]`` (k <= 16): values and int32 indices,
    largest first, ties to the smallest index, as ``_topk_iterative`` gives
    them. CUDA tensors launch the top-k kernel; CPU tensors run
    ``_topk_iterative``."""
    if x.device.type == "cpu":
        return _topk_iterative(x, k)
    if x.dtype not in _DTYPE_CODE or x.dim() != 2:
        raise TypeError(f"_topk_small takes a 2-D float32 or bfloat16 tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    bsz, n = x.shape
    if not 1 <= k <= 16 or n < k:
        raise ValueError(f"_topk_small: k={k} needs 1 <= k <= 16 <= N={n}")
    return _launch_topk(x.contiguous(), k, topk_splits(bsz, n, sm_count(x.device.index)))


TOPK_SPLIT_MIN = 4096  # fewest entries a block of the top-k kernel takes
TOPK_MAX_SPLITS = 256  # most blocks a row the kernel takes (MAXS there)


def topk_splits(rows: int, n: int, sm_count: int) -> int:
    """Blocks a row for the top-k kernel: about two blocks an SM in all,
    each block at least ``TOPK_SPLIT_MIN`` entries."""
    return max(1, min(TOPK_MAX_SPLITS, -(-2 * sm_count // rows), n // TOPK_SPLIT_MIN))


def _launch_topk(x: torch.Tensor, k: int, splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the top-k kernel on contiguous ``x [B, N]`` with ``splits``
    blocks a row (the caller has checked x, k and splits)."""
    bsz, n = x.shape
    vals = torch.empty(bsz, k, dtype=x.dtype, device=x.device)
    idxs = torch.empty(bsz, k, dtype=torch.int32, device=x.device)
    ws = (0, 0, 0)
    if splits > 1:
        count = arrival_counters(x.device, bsz)
        ws_v = torch.empty(bsz * splits * k, dtype=torch.float32, device=x.device)
        ws_i = torch.empty(bsz * splits * k, dtype=torch.int32, device=x.device)
        ws = (ws_v.data_ptr(), ws_i.data_ptr(), count.data_ptr())
    TOPK_KERNEL.launch("topk", x.data_ptr(), vals.data_ptr(), idxs.data_ptr(), *ws,
                       bsz, n, k, splits, _DTYPE_CODE[x.dtype], stream_ptr())
    return vals, idxs


def _f32_pow(base: int, exponent: float) -> float:
    """``base ** exponent`` rounded as float32 arithmetic rounds it."""
    return float(np.float32(base) ** np.float32(exponent))


def _gather_beams(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Select along axis 1 by ``[batch, k]`` indices."""
    idx = indices.long()
    if x.dim() > 2:
        idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
            idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------


def greedy_decode(fns: DecodeFns, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                  max_length: int, eos_token_id: int = 1,
                  decoder_start_token_id: int = 0, min_length: int = 0,
                  repetition_penalty: float = 1.0) -> torch.Tensor:
    """Returns ``[batch, max_length]`` int32 sequences (0-padded after EOS)."""
    batch, dev = enc_out.shape[0], enc_out.device
    cache = fns.init_cache(batch, enc_out)
    tokens = torch.full((batch,), decoder_start_token_id, dtype=torch.int32, device=dev)
    seqs = torch.zeros((batch, max_length), dtype=torch.int32, device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    i = 0
    while i < max_length and not bool(finished.all()):
        logits, cache = fns.step(tokens, cache, i, enc_mask)
        logits = _apply_repetition_penalty(logits, seqs, repetition_penalty)
        if i + 1 < min_length:
            logits = logits.clone()
            logits[:, eos_token_id] = NEG_INF
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, torch.zeros_like(nxt), nxt)
        seqs[:, i] = nxt
        finished = finished | (nxt == eos_token_id)
        tokens = nxt
        i += 1
    return seqs


# ---------------------------------------------------------------------------
# Nucleus (top-p) sampling: the reference's num_beams=0 (dvc.py:177)
# ---------------------------------------------------------------------------


def topp_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Logits outside each row's nucleus set to ``NEG_INF``: the smallest
    prefix of the sorted row whose mass reaches ``top_p`` is kept (the
    top-1 always); a position stays if the mass before it is < ``top_p``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    kept = (cum - sorted_probs) < top_p
    threshold = torch.where(kept, sorted_logits,
                            torch.full_like(sorted_logits, float("inf"))).min(dim=-1).values
    return torch.where(logits < threshold[:, None], torch.full_like(logits, NEG_INF), logits)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max rule, as
    ``jax.random.categorical`` draws (its uniforms from ``generator``)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def nucleus_sample(fns: DecodeFns, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                   max_length: int, generator: torch.Generator, top_p: float = 0.9,
                   temperature: float = 1.0, eos_token_id: int = 1,
                   decoder_start_token_id: int = 0, min_length: int = 0) -> torch.Tensor:
    """Returns ``[batch, max_length]`` int32 sampled sequences (0-padded
    after EOS); ``generator`` lives on the device of ``enc_out``."""
    batch, dev = enc_out.shape[0], enc_out.device
    cache = fns.init_cache(batch, enc_out)
    tokens = torch.full((batch,), decoder_start_token_id, dtype=torch.int32, device=dev)
    seqs = torch.zeros((batch, max_length), dtype=torch.int32, device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    i = 0
    while i < max_length and not bool(finished.all()):
        logits, cache = fns.step(tokens, cache, i, enc_mask)
        logits = logits / max(temperature, 1e-6)
        if i + 1 < min_length:
            logits[:, eos_token_id] = NEG_INF
        nxt = categorical(topp_filter(logits, top_p), generator).to(torch.int32)
        nxt = torch.where(finished, torch.zeros_like(nxt), nxt)
        seqs[:, i] = nxt
        finished = finished | (nxt == eos_token_id)
        tokens = nxt
        i += 1
    return seqs


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def beam_search(fns: DecodeFns, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                max_length: int, num_beams: int = 4, eos_token_id: int = 1,
                decoder_start_token_id: int = 0, length_penalty: float = 1.0,
                min_length: int = 0, repetition_penalty: float = 1.0,
                early_stopping: bool = False) -> torch.Tensor:
    """Returns ``[batch, max_length]`` int32 best sequences."""
    reorder_cache = fns.reorder_cache or reorder_beam_cache
    batch, dev = enc_out.shape[0], enc_out.device
    K = num_beams
    # self-attention caches are per beam; cross K/V per example
    cache = fns.init_cache(batch * K, enc_out)
    f32, i32 = torch.float32, torch.int32
    running_seqs = torch.zeros((batch, K, max_length), dtype=i32, device=dev)
    running_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), dtype=f32,
                                  device=dev).repeat(batch, 1)
    finished_seqs = torch.zeros((batch, K, max_length), dtype=i32, device=dev)
    finished_scores = torch.full((batch, K), NEG_INF, dtype=f32, device=dev)
    finished_flags = torch.zeros((batch, K), dtype=torch.bool, device=dev)
    tokens = torch.full((batch, K), decoder_start_token_id, dtype=i32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    rows = torch.arange(batch, device=dev)[:, None] * K

    def not_done(i: int) -> bool:
        if i >= max_length:
            return False
        if early_stopping:
            improvable = ~torch.all(finished_flags, dim=1)
        else:
            # the attainable score of a running beam is bounded by its sum
            # normalized at the CURRENT length (HF BeamHypotheses.is_done)
            best_possible = running_scores / _f32_pow(max(i + 1, 1), length_penalty)
            worst_finished = torch.min(
                torch.where(finished_flags, finished_scores, neg), dim=1).values
            improvable = (torch.any(best_possible > worst_finished[:, None], dim=1)
                          | ~torch.any(finished_flags, dim=1))
        return bool(torch.any(improvable))

    i = 0
    while not_done(i):
        logits, cache = fns.step(tokens.reshape(-1), cache, i, enc_mask)
        vocab = logits.shape[-1]
        logits = _apply_repetition_penalty(
            logits, running_seqs.reshape(batch * K, max_length), repetition_penalty)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if i + 1 < min_length:
            logp[:, eos_token_id] = NEG_INF
        cand_scores = running_scores[:, :, None] + logp.view(batch, K, vocab)
        top_scores, top_idx = _topk_small(cand_scores.reshape(batch, K * vocab), 2 * K)
        beam_idx = top_idx // vocab
        token_idx = top_idx % vocab

        cand_seqs = _gather_beams(running_seqs, beam_idx)
        cand_seqs[:, :, i] = token_idx
        is_eos = token_idx == eos_token_id

        # the finished set takes the EOS candidates
        eos_norm = torch.where(is_eos, top_scores / _f32_pow(i + 1, length_penalty), neg)
        merged_seqs = torch.cat([finished_seqs, cand_seqs], dim=1)
        merged_scores = torch.cat([finished_scores, eos_norm], dim=1)
        merged_flags = torch.cat([finished_flags, is_eos], dim=1)
        finished_scores, top_fin = _topk_iterative(merged_scores, K)
        finished_seqs = _gather_beams(merged_seqs, top_fin)
        finished_flags = _gather_beams(merged_flags, top_fin)

        # the top-K non-EOS continuations are the new running set
        non_eos = torch.where(is_eos, neg, top_scores)
        running_scores, keep = _topk_iterative(non_eos, K)
        running_seqs = _gather_beams(cand_seqs, keep)
        tokens = _gather_beams(token_idx, keep)
        src_beams = _gather_beams(beam_idx, keep)
        cache = reorder_cache(cache, (rows + src_beams).reshape(-1))
        i += 1

    none_finished = ~torch.any(finished_flags, dim=1)
    norm_running = running_scores / _f32_pow(max_length, length_penalty)
    best_idx = torch.where(none_finished, torch.argmax(norm_running, dim=1),
                           torch.argmax(finished_scores, dim=1))
    pick = lambda seqs: seqs[torch.arange(batch, device=dev), best_idx]  # noqa: E731
    return torch.where(none_finished[:, None], pick(running_seqs), pick(finished_seqs))

