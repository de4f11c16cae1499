#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vidchapters_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero with no result:

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel under vidchapters_tpu_torch/csrc/ compiled with nvcc (its
   -Xptxas -v lines: registers, shared memory, spills).
2. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes, from a fixed seed: the fused-attention forward at the
   encoder form [8,12,1024,64] + bias (and a 1000-long padded case) and the
   cross form 256 x 1152 without bias, in fp32 and bf16, with dropout 0.1
   and without; its backward (dq, dk, dv, dbias) at both forms and, through
   autograd, at the 1000-long padded case; both in bf16 (the tensor-core
   route) also at head widths 32 and 128 and at a train step's ragged
   lengths (the encoder's 1100 padded to 1152, the denoising
   cross-attention's 304 queries over 904 keys padded to 1024), two
   backward runs bit-identical; the bf16 kernels' SASS (cuobjdump) must
   hold tensor-core instructions (HMMA); top-k exactly over [8, 4*32200]
   f32 and bf16 (k 8, forced ties) and the Whisper beam's [1 and 8,
   5*51865] and [8, 51865] (k 5), each with rows on which the plain version
   re-picks an entry at finfo.min; the T5 decode kernel at T5-base width
   (12 layers, L=256, Lenc=1152) at 8 examples x 4 beams, greedy 8 x 1 and
   2 x 4, cache indices 0/1/127/128/255 (two bf16 calls bit-identical, its
   timeline per phase, the grid barrier alone, HMMA in the bf16 SASS); the decode self-attention at 32 and 8 rows x 12 heads,
   L=256, cache indices 0/127/255 (caches bit for bit), the decode
   cross-attention at 8 examples x 4 and x 1 beams over 1152 padded keys
   (and with an example of no unmasked key, holes, 8 beams, D 128, 32
   examples),
   PDVC's deformable attention forward and backward at the encoder's
   188 and the decoder's 100 queries over value [1, 188, 8, 64] (locations
   past both borders and on pixel centres; two backward runs bit-identical;
   both parts timed at both query counts), the Whisper decode kernel at
   large-v2 width (fp32 and bf16, cross K/V int8 and unquantized, greedy 8
   rows and beam 2 x 5 and 8 x 5, cache indices 0/100/223), and the seven feature
   probes against their known answers (p2 and p3 also on random inputs).
   Each kernel's time (CUDA events), its plain version's time, the one-call
   library yardstick where one exists, and its bound; the fused attention
   also in its serving form (no dropout, no lse) and its two cross forms,
   each beside SDPA's time, and its kernels' -Xptxas -v lines.
3. Training at full width: Vid2Seq (T5-base + 12-layer ViT, dropout 0.1)
   trained by make_train_step on batches of 8 from the port's EpochIterator
   over a synthetic on-disk dataset (input 1000, output 256, denoising
   804 / 304 tokens): 1 warm-up step, 5 timed steps (step ms, videos/s,
   peak memory, the fused-attention launches, 48 of each per step), one
   profiled step (device time by kernel group and of each fused-attention
   kernel by name), then an fp32 gradient check: one step at 2+2 layers,
   dropout 0, kernels on the card against the plain versions on the CPU.
4. Serving end to end at full width: Vid2Seq with seeded
   random weights, beam 4 / max_length 256, behind serve() on 127.0.0.1;
   10 concurrent HTTP requests (8 in the 1000-token bucket, 2 short). The
   kernels' launch counts are zeroed just before the requests and read just
   after; each must be > 0. Then two requests at max_length 64 in fp32,
   once with the kernels on the card and once with the plain versions on
   the CPU: the tokens must be identical.
5. Training and evaluation at full width through train/dvc_main.main: one
   epoch (2 steps of 8) on a synthetic dataset with a val split, the val
   eval and the final eval at beam 4 / max_length 256 on the standard
   cached decode (the decode-attention kernels, not the decode kernel),
   checkpoints, then an eval_only rerun with nucleus sampling that resumes;
   every DVC/SODA metric finite; fp32 tokens of the standard decode, card
   against CPU (beam 4, greedy) and against the decode kernel (beam 4).
6. PDVC trained and evaluated at the full width of
   configs/chapters_pdvc.json through train/pdvc_main: one epoch at batch
   1 on 16 synthetic videos, the val eval on 8, best / last, eval_main from
   the saved directory and the CLI's test mode; the deformable kernels'
   launches exactly 4 forward per forward pass and 4 backward per train
   step; train ms/step, eval videos/s, the matcher's time and a profile of
   one train step and one eval batch; an fp32 gradient check of one step
   and fp32 caption tokens of two val videos, card against CPU.
7. The ASR factory at Whisper large-v2 width with seeded random weights
   and the transcriber's defaults: 8 synthetic .wav files (tones and noise
   with silent gaps, 20-65 s) through factory/asr.run_batched_asr at batch
   8, both merges, one transcribe at beam 5 with the VAD; the Whisper
   kernel's launches exactly 223 per decode call plus one per language
   detection; audio-seconds per second, peak memory, a profiled decode
   call; fp32 tokens and beam ancestry at 4+4 layers, card against CPU.
8. (a) HowTo100M pretraining at full width through train/dvc_main.main:
   configs/htm_pretrain.json (T5-base with ReLU, ViT 12 x 768, bf16,
   genasr, generative + denoising) with bf16 Adam moments, over a
   synthetic HowTo100M layout (a csv, .mp4.npy features in 8 shard
   subdirectories, an ASR pickle) tokenized by a synthetic SentencePiece
   model of T5-base's 32,100 text ids through the native encoder (a Python
   fallback fails the run); batch 64 if a step fits, else the largest power
   of two that does; one epoch of 1 + 3 steps (ms/step, peak memory), the
   fused-attention launches exactly the count the model's shapes give;
   log.txt and last; an eval_only rerun that resumes with bf16 moments;
   an fp32 gradient check of one genasr step at 2+2 layers and of the
   parameters after the next step. (b) A reference Vid2Seq .pth at T5-base
   width (seeded random weights under the reference's names, module.
   prefixes, an args Namespace) imported by serve.load_serving_params bit
   for bit, two requests served (fused attention, top-k and decode kernel
   launched), fp32 greedy tokens card vs CPU, and dvc_main --load --eval on
   phase 5's val set with finite metrics.
9. VC (chapter titles from ground-truth boundaries) at T5-base width
   through train/vc_main.main: one epoch at batch 16 (3 steps) over 48
   synthetic videos, the val eval and the final eval (best) over 4 videos
   of 16 chapters at beam 4 / max_length 32, 16 clips a generate call
   (64 decode-kernel rows); best / last / log.txt, finite CIDEr / METEOR /
   BLEU / ROUGE-L; the fused attention's, the top-k's and the decode
   kernel's launches exactly the counts the model, the shapes and the
   decode steps run give; ms a step, clips/s, peak memory; fp32 beam tokens
   at 2+2 layers card vs CPU; phase 5's best weights stripped of their time
   tokens load into a text-only-vocab VC model; --eval --model-type random.
   Phase 2 also holds the decode kernel at 16 x 4 rows and L 32 (fp32 and
   bf16) and the top-k at [16, 4*32200].
10. Moment-DETR at configs/chapters_momentdetr.json (hidden 256, 8 heads,
   2+2 layers, 10 queries, max_v_l 1200, TEF, bf16) through
   grounding_main's CLI with a 12-layer CLIP ViT-L/14 text tower from a
   synthetic OpenAI-named state dict (--clip-text-ckpt): the recipe's batch
   256 if a step fits, else the largest power of two that does; one epoch
   over 768 synthetic queries (videos up to 3600 s: 1200 clips), the val
   eval, best / last / log.txt, the final eval and test_preds.jsonl with
   finite metrics; ms a step and peak memory; an fp32 gradient check at
   hidden 64, card vs CPU; one use_speech step with the smoke-mode BERT
   tower on the card.
11. A raw video to chapters and moments. (a) The CLIP ViT-L/14 feature
   factory (factory/features.py over models/clip.CLIPImageEncoder, its
   attention on the fused kernel) from a synthetic OpenAI-named state dict
   through convert_openai_clip_visual: 4 synthetic 360 x 640 videos of
   120-900 frames (ffmpeg-encoded .mp4 files decoded by decode_video_1fps
   where ffmpeg exists, else the frames handed in as decode_fn, and the
   run says which) through extract_features_sharded on the kernel route
   and on the plain route (USE_FUSED_ATTENTION False): frames/s of each,
   row 1 launched exactly 24 x ceil(T/64) a video, the tower's device time
   a batch on both routes and a profiled batch, preprocessing ms a frame on
   the host and on the card, peak memory; fp32 features at 2 layers card
   vs CPU. (b) demo_vid2seq.main at T5-base (an untied LM head: random
   tied weights repeat the start token) from the 900-frame video with
   that checkpoint (--clip_ckpt), a reference .pth (--ckpt_path) and phase
   7's ASR pickle, beam 4: chapters JSON inside the duration, rows 1, 3 and
   4 launched exactly; fp32 ids and chapters at 2+2 layers card vs CPU.
   (c) run_on_video's MomentDETRPredictor at configs/chapters_momentdetr.
   json with ViT-B/32 image and text towers (one OpenAI-named checkpoint):
   one video, 4 queries, the schema and the ranking, row 1's launches;
   fp32 windows and saliency at hidden 64 card vs CPU. (d) Whisper word
   alignment (factory/align.align_words_batch) at large-v2 width over 24
   segments of phase 7's audio in chunks of 8: word times finite, monotone
   and inside their segments, seconds and peak memory; align_segments on
   phase 7's pickle read back by merge_and_process; fp32 word times at 4+4
   layers card vs CPU, identical. Phase 2 also holds row 1 at the image
   towers' forms, ViT-L/14's [64, 16, 257, 64] (keys padded to 320) and
   ViT-B/32's [64, 12, 50, 64] and [8, 12, 50, 64] (keys padded to 64),
   fp32 and bf16, against its plain version, and times each beside SDPA
   and the bound (ViT-L/14's also beside the 384-key form); the decode
   kernel at demo_vid2seq's 1 x 4 rows and the top-k at [1, 4*32200].
12. The paper's zero-shot baselines at full width, seeded random weights,
   bf16, each tower freed before the next. (a) Speech chapters at LLaMA-7B
   (13.5 GB, built on the card): run_speech_vcg over 8 synthetic videos of
   four topics with make_llm_titler(make_llama_generate_fn(...)) (a
   synthetic word-hash tokenizer stands in for LLaMA's, which the port
   cannot read; prompts padded to 512, 20 greedy tokens), the prefill's and
   a decode step's ms against their bounds, titles/s, peak memory, finite
   DVC / SODA metrics; evaluate_vc_llama over a VC val set; two bf16 calls
   identical. (b) BLIP-2 with ViT-g / Q-Former / Flan-T5-XL (7.9 GB): the
   ViT-g, Q-Former, encode and greedy-step ms at a batch of 8 frames;
   caption_fn on 8 frames with BLIP2_PROMPT, rows 5 and 6 launched exactly
   24 x its decode steps; two bf16 calls bit-identical; one num_beams=2
   call (row 3 once a step); run_visual_vcg over CLIP-width features with
   planted shots, the frames handed in to make_blip2_captioner;
   evaluate_vc_blip2 over a VC val set built with videos_path (decoded by
   ffmpeg where it exists, else the zero-frame fallback, and the run says
   which). (c) run_vcgr in clip mode with the CLIP ViT-L/14 text tower over
   phase 11's features, and in random mode. (d) vc_main --eval
   --model-type blip2 and zeroshot.run visual from a synthetic HF BLIP-2
   directory (config.json, pytorch_model.bin, spiece.model; 2 layers a
   tower at full width); vc_main --model-type llama raises with its
   loader's message. (e) fp32 tokens card vs CPU: LLaMA at 2 layers, d 256,
   GQA 8/2, and BLIP-2 at 2 + 2 + 2 + 2 layers (greedy and beam 2). Phase 2
   also holds rows 5 and 6 at every form (b) launches, 32 heads x 64 (self:
   8, 16, 2 and 1 rows, L 20, idx 0/10/19; cross: 8 x 1, 8 x 2, 2 x 1 and
   1 x 1 over the path's 54 keys, 8 x 1 and 8 x 2 with the last masked, and
   Flan-T5's own tokenizer's 46 and 45), and row 3 at beam 2's [8, 2 x
   32128], k 4; fp32 and bf16, timed beside SDPA / torch.topk and the
   bound. (b) fails unless its calls ran at those forms.

The kernels' launch counts are zeroed just before each main path (phases
3, 4, 6, 7, 8, 11, each BLIP-2 call of 12 and each run of 5) and read just after it; the kernel line
reports each kernel's count from its own path (training for the fused
attention, serving for top-k and the decode kernel, phase 5's first run for
the decode-attention kernels, phase 6's pdvc_main run for the deformable
attention, phase 7's sweep for the Whisper kernel); rows 1-2 also carry
``launches_pretrain`` from phase 8's dvc_main run and rows 1-4
``launches_vc`` from phase 9's vc_main run; row 1 carries
``launches_features`` from phase 11(a) and rows 1, 3 and 4
``launches_demo`` from phase 11(b); rows 3, 5 and 6 carry
``launches_zeroshot`` from phase 12(b)'s BLIP-2 calls. The probes lie on no
path: their count is phase 2's.

The last lines are the kernel table as one JSON object, the nvidia-smi
line, and {"ok": true, "device": {...}}. The full record also goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES = 3.35e12       # HBM3 bytes/s
DEVICE = "cuda"            # where phases 3 and 4 run the kernel paths


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Warm per-call time of ``fn`` in ms, by CUDA events over ``iters`` calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_graph(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn`` in ms: ``iters`` calls captured in one
    CUDA graph and replayed ``reps`` times, so the host's per-call work (a
    wrapper's checks, the launch itself) is not in the time. For calls of
    tens of microseconds, which ``time_ms`` would time by the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def time_ms_graph_cold(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time per call of ``fn`` in ms with the L2 cache cold: ``iters``
    pairs of (a 64 MB read, ``fn``) in one CUDA graph, less the reads alone,
    each replayed ``reps`` times. For a kernel whose inputs fit the 50 MB L2,
    which ``time_ms_graph`` then reads from L2, while its real caller finds
    them cold (a decode step's layers cycle through more K/V than L2 holds)."""
    import torch

    junk = torch.zeros(16 << 20, dtype=torch.float32, device="cuda")
    both = time_ms_graph(lambda: (junk.sum(), fn()), iters, reps)
    return both - time_ms_graph(junk.sum, iters, reps)


def within(got, ref, atol: float) -> bool:
    """Every element within ``atol``, or, for bfloat16, within two bf16
    ulps of the reference value where that is larger: a sum taken in
    another order may round one ulp away, and one ulp of a value in
    [4, 8) is already 3.1e-2."""
    import torch

    ref = ref.float()
    err = (got.float() - ref).abs()
    tol = torch.full_like(ref, atol)
    if got.dtype == torch.bfloat16:
        _, exp = torch.frexp(ref)
        tol = torch.maximum(tol, 2.0 * torch.ldexp(torch.ones_like(ref), exp - 8))
    return bool((err <= tol).all())


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device_and_build():
    import torch

    from vidchapters_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    logs = _build.build(["fused_attention_fwd", "fused_attention_bwd", "topk",
                         "decode_megakernel", "decode_attention", "deformable_attention",
                         "whisper_megakernel", "probes"])
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "smem")):
                say(f"[build] {name}: {line.strip()}")
    say(f"[build] ok in {time.time() - t0:.1f} s ({', '.join(logs)})")
    BUILD_LOGS.update(logs)
    return card


BUILD_LOGS = {}  # -Xptxas -v output of each library built in phase 1


def _ptxas_lines(name: str):
    """Registers, shared memory and spills of each kernel of one library, as
    ``-Xptxas -v`` printed them: ``{function: "Used N registers, ..."}``."""
    out, fn = {}, None
    for line in BUILD_LOGS.get(name, "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn is not None and ("registers" in line or "spill" in line):
            out[fn] = (out.get(fn, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


SEED = 0x5EED1234  # the dropout seed of the kernel checks
RATE = 0.1         # the recipe's dropout rate


def _attention_inputs(gen, form: str, dtype, length: int = 1024, d: int = 64,
                      cross: tuple = (256, 1152)):
    """The two forms the training path gives the fused attention: "encoder"
    (T5 encoder self-attention, [8,12,L,d] with the relative-position bias
    and per-example key padding) and "cross" (decoder cross-attention, 256
    queries over 1152 keys by default, or the denoising pass's 304 over 904,
    no bias, 100 frames + per-example ASR length). Also a random output
    gradient."""
    import torch

    from vidchapters_tpu_torch.models.t5 import relative_position_bucket

    b, h = 8, 12
    lq, lk = (length, length) if form == "encoder" else cross
    q = torch.randn(b, h, lq, d, generator=gen) * 0.5
    k, v = (torch.randn(b, h, lk, d, generator=gen) * 0.5 for _ in range(2))
    bias = None
    mask = torch.ones(b, lk, dtype=torch.int32)
    if form == "encoder":
        emb = torch.randn(32, h, generator=gen) * 768 ** -0.5
        pos = torch.arange(lq)
        bias = emb[relative_position_bucket(pos[None] - pos[:, None], True, 32, 128).long()]
        bias = bias.permute(2, 0, 1)[None].contiguous()
        for i in range(b):  # per-example valid lengths, leaving padding
            mask[i, lk - 37 * i:] = 0
    else:
        for i in range(b):
            mask[i, min(lk, 1100) - 90 * i:] = 0
    dout = torch.randn(b, h, lq, d, generator=gen)
    on = lambda t: None if t is None else t.to("cuda", dtype)  # noqa: E731
    return on(q), on(k), on(v), on(bias), mask.cuda(), on(dout)


def _pad_as_wrapper(q, k, v, bias, mask, dout=None):
    """The inputs at the lengths fused_attention_padded gives the kernels
    (padded keys masked, padded query rows of dout zero), so that a plain
    version sees the keep mask hashed over the same padded Lk."""
    from vidchapters_tpu_torch.ops import fused_attention as fa

    lqp, lkp = fa.padded_lengths(q.shape[2], k.shape[2])
    q, dout = (None if t is None else fa._pad_to(t, lqp, 2) for t in (q, dout))
    k, v = (fa._pad_to(t, lkp, 2) for t in (k, v))
    bias = None if bias is None else fa._pad_to(fa._pad_to(bias, lqp, 2), lkp, 3)
    return q, k, v, bias, fa._pad_to(mask, lkp, 1), dout


def check_fused_attention(gen):
    """The forward, without and with dropout, at both forms: the dropout
    rows agree to the same tolerance only if every keep decision matches
    (one flipped decision moves an output by a whole p*v term)."""
    import torch

    from vidchapters_tpu_torch.ops import fused_attention as fa

    errs = {}
    cases = [((form, length, dtype, rate), f"{form} L={length} {dtype}", tol, rate,
              (form, dtype, length))
             for form, length in (("encoder", 1024), ("cross", 1024), ("encoder", 1000))
             for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
             for rate in (0.0, RATE) if length == 1024 or dtype == torch.float32]
    # bf16 only, the tensor-core route: the extra head widths and ragged lengths
    cases += [(label, label, 2e-2, RATE, (form, torch.bfloat16, length, d, cross))
              for form, length, d, cross in FA_BF16_SHAPES
              for label in [_shape_label(form, length, d, cross)]]
    for key, label, tol, rate, draw in cases:
        q, k, v, bias, mask, _ = _attention_inputs(gen, *draw)
        got = fa.fused_attention_padded(q, k, v, bias, mask, seed=SEED, dropout_rate=rate)
        # the plain version at the lengths the wrapper pads to (the keep mask
        # hashes the padded Lk), its padded query rows sliced off
        ref = fa.fused_attention_plain(*_pad_as_wrapper(q, k, v, bias, mask)[:5], SEED,
                                       rate)[:, :, :q.shape[2]]
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        say(f"[check] fused_attention {label} dropout {rate}: max_abs_err {err:.3e} "
            f"(tol {tol})")
        check(err <= tol, f"fused_attention {label} rate {rate}: err {err} > {tol}")
        errs[key] = err
    q, k, v, bias, mask, _ = _attention_inputs(gen, "encoder", torch.bfloat16)
    b, h, l, d = q.shape
    # the training form: dropout and the log-sum-exp for the backward
    ms = time_ms(lambda: fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True))
    ms_serving = time_ms(lambda: fa.fused_attention(q, k, v, bias, mask))
    plain_ms = time_ms(lambda: fa.fused_attention_plain(q, k, v, bias, mask, SEED, RATE), 5)
    float_mask = (bias + (mask[:, None, None, :].to(bias.dtype) - 1) * 1e9).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=float_mask, dropout_p=RATE, scale=1.0))
    lib_ms_serving = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=float_mask, scale=1.0))
    cross_ms = {}
    for cross in ((256, 1152), (304, 904)):  # the two cross forms of a train step
        cq, ck, cv, _, cmask, _ = _pad_as_wrapper(
            *_attention_inputs(gen, "cross", torch.bfloat16, cross=cross)[:5])
        cmadd = ((cmask[:, None, None, :].to(cq.dtype) - 1) * 1e9).expand(
            -1, cq.shape[1], cq.shape[2], -1).contiguous()
        cross_ms[cross] = (
            time_ms(lambda: fa._forward(cq, ck, cv, None, cmask, SEED, RATE, want_lse=True)),
            time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                cq, ck, cv, attn_mask=cmadd, dropout_p=RATE, scale=1.0)))
    nbytes = 4 * b * h * l * d * 2 + h * l * l * 2 + b * l * 4 + b * h * l * 4
    bms, by = bound(nbytes, 4 * b * h * l * l * d, H100_BF16_FLOPS)
    torch.cuda.synchronize()
    return {"name": "fused_attention_fwd", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/fused_attention_fwd.cu",
            "replaces": "vidchapters_tpu/ops/fused_attention.py:163",
            "max_abs_err": errs[("encoder", 1024, torch.bfloat16, RATE)],
            "max_abs_err_fp32": errs[("encoder", 1024, torch.float32, RATE)],
            "max_abs_err_all": max(errs.values()),
            "ms": ms, "ms_serving_form": ms_serving,
            "ms_cross_form": cross_ms[(256, 1152)][0],
            "ms_cross_denoise_form": cross_ms[(304, 904)][0],
            "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "library_ms_serving_form": lib_ms_serving,
            "library_ms_cross_form": cross_ms[(256, 1152)][1],
            "library_ms_cross_denoise_form": cross_ms[(304, 904)][1],
            "library": "SDPA with a float mask (bias + key mask), dropout 0.1; the serving "
                       "form without dropout",
            "shape": "q/k/v [8,12,1024,64] bf16, bias [1,12,1024,1024], dropout 0.1, lse out; "
                     "cross forms 256 x 1152 and 304 x 904 (padded to 1024) keys, no bias",
            "ptxas": _ptxas_lines("fused_attention_fwd")}


VISION_FORM = (64, 16, 257, 64)  # ViT-L/14 at 224 px: a batch of 64 frames, 16 heads, 1 + 256 tokens
# ViT-B/32 at 224 px (run_on_video, phase 11c): 12 heads, 1 + 49 tokens (keys
# padded to 64: one key tile, 14 keys masked; 50 query rows, less than a
# query tile), a batch of 64 frames and the tail batch of 8 of a 200-clip video
VISION_B32_FORMS = ((64, 12, 50, 64), (8, 12, 50, 64))


def _vision_check(gen, frames: int, h: int, l: int, d: int, dtype, tol: float):
    """Row 1 on the image tower's route (``models/clip.fused_self_attention``)
    at [frames, h, l, d] in ``dtype``: one launch, against the plain version
    on the route's own inputs within ``tol``. Returns (qkv, q, k, v, mask,
    max_abs_err)."""
    import torch

    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import fused_attention as fa

    qkv = torch.randn(frames, l, 3 * h * d, generator=gen).to("cuda", dtype)
    q, k, v, mask = clip.vision_attention_inputs(qkv, h)
    lk = -(-l // 64) * 64
    check(tuple(k.shape) == (frames, h, lk, d) and int(mask.sum()) == frames * l,
          f"vision form: keys {tuple(k.shape)}, mask sum {int(mask.sum())}")
    before = fa.KERNEL.launches
    got = clip.fused_self_attention(qkv, h)
    torch.cuda.synchronize()
    check(fa.KERNEL.launches == before + 1, "the vision route launched no kernel")
    ref = fa.fused_attention_plain(q, k, v, None, mask).transpose(1, 2).reshape(
        frames, l, h * d)
    err = (got.float() - ref.float()).abs().max().item()
    say(f"[check] fused_attention vision form [{frames},{h},{l},{d}] {dtype}: "
        f"max_abs_err {err:.3e} (tol {tol})")
    check(err <= tol, f"fused_attention vision form [{frames},{h},{l},{d}] {dtype}: "
                      f"err {err} > {tol}")
    return qkv, q, k, v, mask, err


def _vision_times(qkv, q, k, v, mask, h: int, graph: bool = False):
    """Times of row 1 at an image tower's form (bf16 inputs of
    ``_vision_check``): the kernel on the route's inputs, the plain version,
    SDPA on the unpadded q, k, v with scale 1/sqrt(d), the whole fused route
    of a block (input preparation included) and the block's plain einsum
    route; the bound counts q, k, v and the output at the unpadded length.
    By CUDA events over eager calls, or with ``graph`` by CUDA-graph replay
    (``time_ms_graph``: calls of tens of microseconds, which eager calls
    would time by the host), the eager times of the kernel and SDPA beside."""
    import torch

    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import fused_attention as fa

    b, l, w3 = qkv.shape
    d = w3 // (3 * h)
    scale = 1.0 / d ** 0.5
    unscaled = qkv[..., :h * d].reshape(b, l, h, d).transpose(1, 2)
    ku, vu = k[:, :, :l], v[:, :, :l]

    def plain_route():  # the block's einsum route (USE_FUSED_ATTENTION False)
        qs, ks, vs = (t.reshape(b, l, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        probs = torch.softmax(torch.matmul(qs, ks.transpose(-1, -2)).float() * scale, dim=-1)
        return torch.matmul(probs.to(qkv.dtype), vs).transpose(1, 2).reshape(b, l, h * d)

    def kernel():
        return fa.fused_attention(q, k, v, None, mask)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(unscaled, ku, vu, scale=scale)

    timer = time_ms_graph if graph else time_ms
    bms, by = bound(4 * b * h * l * d * 2, 4 * b * h * l * l * d, H100_BF16_FLOPS)
    out = {"ms": timer(kernel),
           "plain_ms": timer(lambda: fa.fused_attention_plain(q, k, v, None, mask), 5),
           "library_ms": timer(library),
           "route_ms": timer(lambda: clip.fused_self_attention(qkv, h)),
           "plain_route_ms": timer(plain_route, 5), "bound_ms": bms, "bound_by": by}
    if graph:
        out["timing"] = TIMING_GRAPH
        out["eager_ms"] = {"kernel": time_ms(kernel, 50), "library": time_ms(library, 50)}
    return out


def check_fused_attention_vision(gen):
    """Row 1 at the CLIP image towers' forms (no bias, no dropout) on the
    towers' own route (``models/clip.vision_attention_inputs``: q scaled by
    1/sqrt(d), keys padded to a multiple of 64 under a mask, the query rows
    as they are), each against the plain version on the same inputs:
    ViT-L/14's [64, 16, 257, 64] (fp32 at 4 frames, bf16 at 64; keys padded
    to 320), and ViT-B/32's [64, 12, 50, 64] and tail [8, 12, 50, 64] (fp32
    and bf16 at each). Each bf16 form timed (``_vision_times``: ViT-B/32's
    by CUDA-graph replay); ViT-L/14's also with the kernel at
    ``fused_attention_padded``'s lengths (264 queries, 384 keys). Returns the numbers for row 1: ViT-L/14's keyed
    ``*_vision_form``, ViT-B/32's under ``vision_b32_forms``."""
    import torch

    from vidchapters_tpu_torch.ops import fused_attention as fa

    b, h, l, d = VISION_FORM
    out = {}
    for dtype, frames, tol in ((torch.float32, 4, 1e-4), (torch.bfloat16, b, 2e-2)):
        qkv, q, k, v, mask, err = _vision_check(gen, frames, h, l, d, dtype, tol)
        out["max_abs_err_vision_form" + ("_fp32" if dtype == torch.float32 else "")] = err
    qp, kp, vp, _, maskp, _ = _pad_as_wrapper(q[:, :, :l], k[:, :, :l], v[:, :, :l], None,
                                              mask[:, :l])
    check(tuple(kp.shape[2:]) == (384, d) and qp.shape[2] == 264,
          f"fused_attention_padded's lengths {qp.shape[2]} x {kp.shape[2]}")
    t = _vision_times(qkv, q, k, v, mask, h)
    out.update({f"{key}_vision_form": val for key, val in t.items()})
    out.update(
        ms_vision_form_padded_384=time_ms(lambda: fa.fused_attention(qp, kp, vp, None, maskp)),
        shape_vision_form="q [64,16,257,64] bf16 (scaled by 1/8), k/v padded to 320 keys "
                          "under a key mask, no bias, no dropout")
    b32 = []
    for b, h, l, d in VISION_B32_FORMS:
        row = {"shape": f"q [{b},{h},{l},{d}] bf16 (scaled by 1/8), k/v padded to "
                        f"{-(-l // 64) * 64} keys under a key mask, no bias, no dropout"}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            qkv, q, k, v, mask, err = _vision_check(gen, b, h, l, d, dtype, tol)
            row["max_abs_err" + ("_fp32" if dtype == torch.float32 else "")] = err
        row.update(_vision_times(qkv, q, k, v, mask, h, graph=True))
        b32.append(row)
    out["vision_b32_forms"] = b32
    say(f"[time] fused_attention vision forms: {json.dumps(out)}")
    return out


# the bf16 shapes beside the main one: head widths 32 and 128, and the
# ragged lengths of a train step (the encoder's 1100 tokens pad to 1152, the
# denoising cross-attention's 304 queries over 904 keys pad to 1024)
FA_BF16_SHAPES = (("encoder", 1024, 32, None), ("encoder", 1024, 128, None),
                  ("encoder", 1100, 64, None), ("cross", 0, 64, (304, 904)))


def bf16_grad_tol(ref) -> float:
    """The bound of the bf16 backward's checks at the extra shapes: 2e-2,
    or 2^-7 of the largest reference element (one to two bf16 ulps of it)
    where that is larger. dS and P keep are rounded to bf16 before their
    products; where the kernel's fp32 dS and the plain version's lie an fp32
    ulp apart across a rounding boundary they round to neighbouring bf16
    values, and one such term moves a gradient element by a bf16 ulp of
    |dS| |K|. That grows with |dS|: the 304 x 904 cross form has examples
    with 274 valid keys, and its dq, up to 5.8, reads 2.3e-2 from the plain
    version."""
    return max(2e-2, 2.0 * 2.0 ** -8 * float(ref.abs().max()))


def _shape_label(form, length, d, cross):
    return (f"{form} L={length} D={d}" if form == "encoder"
            else f"{form} {cross[0]}x{cross[1]} D={d}")


def _sdpa_fwd_bwd(q, k, v, bias, mask, dout):
    """The library yardstick of the backward: SDPA forward + backward with a
    float mask whose bias requires grad, on the first backend that gives the
    bias its gradient. Returns (ms, backend name) or (None, "none")."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    madd = (mask[:, None, None, :].to(bias.dtype) - 1) * 1e9

    def run():
        for t in leaves:
            t.grad = None
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3] + madd, dropout_p=RATE, scale=1.0)
        out.backward(dout)

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                run()
                torch.cuda.synchronize()
                if leaves[3].grad is None:
                    continue
                return time_ms(run, 5), backend.name
        except RuntimeError as e:
            say(f"[time] SDPA backend {backend.name} refused: {str(e).splitlines()[0][:120]}")
    return None, "none"


def check_fused_attention_bwd(gen):
    """The backward kernel against its plain version at both forms, fp32
    and bf16, dropout 0.1; then dq/dk/dv/dbias through autograd at the
    1000-long padded case against autograd of the plain forward."""
    import torch

    from vidchapters_tpu_torch.ops import fused_attention as fa

    errs = {}
    for form in ("encoder", "cross"):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, bias, mask, dout = _attention_inputs(gen, form, dtype)
            out, lse = fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True)
            got = fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, out, dout, lse)
            again = fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, out, dout, lse)
            ref = fa.fused_attention_bwd_plain(q, k, v, bias, mask, SEED, RATE, out, dout)
            torch.cuda.synchronize()
            per = {}
            for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, ref):
                if r is None:
                    continue
                check(torch.equal(a, a2), f"fused_attention_bwd {form} {dtype}: {name} "
                                          f"differs between two runs")
                per[name] = (a - r).abs().max().item()
            say(f"[check] fused_attention_bwd {form} {dtype} dropout {RATE}: max_abs_err "
                + ", ".join(f"{n} {e:.3e}" for n, e in per.items())
                + f" (tol {tol}); two runs bit-identical")
            check(max(per.values()) <= tol, f"fused_attention_bwd {form} {dtype}: {per} > {tol}")
            errs[(form, dtype)] = max(per.values())
    for form, length, d, cross in FA_BF16_SHAPES:
        q, k, v, bias, mask, dout = _pad_as_wrapper(
            *_attention_inputs(gen, form, torch.bfloat16, length, d, cross))
        out, lse = fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True)
        got = fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, out, dout, lse)
        again = fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, out, dout, lse)
        ref = fa.fused_attention_bwd_plain(q, k, v, bias, mask, SEED, RATE, out, dout)
        torch.cuda.synchronize()
        per, tols = {}, {}
        label = _shape_label(form, length, d, cross)
        for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, ref):
            if r is None:
                continue
            check(torch.equal(a, a2), f"fused_attention_bwd {label}: {name} differs between "
                                      f"two runs")
            per[name], tols[name] = (a - r).abs().max().item(), bf16_grad_tol(r)
        say(f"[check] fused_attention_bwd {label} bf16 dropout {RATE}: max_abs_err "
            + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3e})" for n, e in per.items())
            + "; two runs bit-identical")
        check(all(per[n] <= tols[n] for n in per), f"fused_attention_bwd {label}: {per} > {tols}")
        errs[label] = max(per.values())
    # autograd through the padding wrapper at L=1000 (pads to 1024), fp32
    q, k, v, bias, mask, dout = _attention_inputs(gen, "encoder", torch.float32, 1000)
    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
    fa.fused_attention_padded(*leaves, mask, seed=SEED, dropout_rate=RATE).backward(dout)
    got = [t.grad.clone() for t in leaves]
    ref_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    qp, kp, vp = (fa._pad_to(t, 1024, 2) for t in ref_leaves[:3])
    bp = fa._pad_to(fa._pad_to(ref_leaves[3], 1024, 2), 1024, 3)
    fa.fused_attention_plain(qp, kp, vp, bp, fa._pad_to(mask, 1024, 1), SEED,
                             RATE)[:, :, :1000].backward(dout)
    per = {n: (a - r.grad).abs().max().item()
           for n, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref_leaves)}
    say(f"[check] fused_attention autograd L=1000 padded fp32 dropout {RATE}: max_abs_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in per.items()) + " (tol 1e-4)")
    check(max(per.values()) <= 1e-4, f"fused_attention autograd L=1000: {per}")
    errs["padded_1000"] = max(per.values())

    q, k, v, bias, mask, dout = _attention_inputs(gen, "encoder", torch.bfloat16)
    b, h, l, d = q.shape
    out, lse = fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True)
    ms = time_ms(lambda: fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, out, dout,
                                                lse), 10)

    def fwd_bwd():
        o, s = fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True)
        fa.fused_attention_bwd(q, k, v, bias, mask, SEED, RATE, o, dout, s)

    ms_fwd_bwd = time_ms(fwd_bwd, 5)
    plain_ms = time_ms(lambda: fa.fused_attention_bwd_plain(q, k, v, bias, mask, SEED, RATE,
                                                            out, dout), 3)
    lib_ms, backend = _sdpa_fwd_bwd(q, k, v, bias, mask, dout)
    cq, ck, cv, _, cmask, cdout = _attention_inputs(gen, "cross", torch.bfloat16)
    cout, clse = fa._forward(cq, ck, cv, None, cmask, SEED, RATE, want_lse=True)
    ms_cross = time_ms(lambda: fa.fused_attention_bwd(cq, ck, cv, None, cmask, SEED, RATE,
                                                      cout, cdout, clse), 10)
    out0, lse0 = fa._forward(q, k, v, bias, mask, SEED, 0.0, want_lse=True)
    ms_no_dropout = time_ms(lambda: fa.fused_attention_bwd(q, k, v, bias, mask, SEED, 0.0,
                                                           out0, dout, lse0), 10)
    # each input read once (q, k, v, out, dout, bias, mask, lse), each output
    # written once (dq, dk, dv, dbias in fp32); five L x L x D products
    nbytes = (5 * b * h * l * d * 2 + h * l * l * 2 + b * l * 4 + b * h * l * 4
              + 3 * b * h * l * d * 4 + h * l * l * 4)
    bms, by = bound(nbytes, 10 * b * h * l * l * d, H100_BF16_FLOPS)
    torch.cuda.synchronize()
    return {"name": "fused_attention_bwd", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/fused_attention_bwd.cu",
            "replaces": "vidchapters_tpu/ops/fused_attention.py:320",
            "max_abs_err": errs[("encoder", torch.bfloat16)],
            "max_abs_err_fp32": errs[("encoder", torch.float32)],
            "max_abs_err_all": max(errs.values()),
            "ms": ms, "ms_fwd_plus_bwd": ms_fwd_bwd, "ms_cross_form": ms_cross,
            "ms_no_dropout": ms_no_dropout,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library": f"SDPA fwd+bwd, float mask with bias grad, "
                                             f"backend {backend}",
            "shape": "q/k/v/out/dout [8,12,1024,64] bf16, bias [1,12,1024,1024], dropout 0.1",
            "ptxas": _ptxas_lines("fused_attention_bwd")}


TC_KERNELS = ("fused_attention_fwd_tc", "fused_attention_bwd_dkdv_tc",
              "fused_attention_bwd_dq_tc")  # the bf16 route's kernels


def check_tensor_cores():
    """The bf16 fused-attention kernels run on the tensor cores: the SASS of
    every bf16 kernel (TC_KERNELS, at each head width) in the built libraries holds HMMA
    instructions (mma.sync), counted per function. Fails without cuobjdump."""
    from vidchapters_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    check(tool.exists(), f"cuobjdump not found beside nvcc ({tool}): the tensor-core gate "
                         f"cannot run")
    counts = {}
    for name in ("fused_attention_fwd", "fused_attention_bwd"):
        sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump -sass {name} failed: {sass.stderr[:500]}")
        for section in sass.stdout.split("Function : ")[1:]:
            fn = section.split("\n", 1)[0].strip()
            if any(w in fn for w in TC_KERNELS):
                counts[fn] = section.count("HMMA") + section.count("HGMMA")
    say(f"[check] tensor cores: {len(counts)} bf16 kernels, HMMA/HGMMA count "
        + ", ".join(f"{fn[:60]} {c}" for fn, c in sorted(counts.items())))
    check(len(counts) == 12, f"expected 12 bf16 kernels (fwd with and without the "
                             f"dropout walk, dkdv, dq; D 32/64/128), found {sorted(counts)}")
    check(all(c > 0 for c in counts.values()), f"a bf16 kernel has no HMMA: {counts}")
    return counts


def serving_checks_generator():
    """The generator the top-k and decode-kernel checks draw from: seed 0,
    advanced past the draws of the original (forward-only) attention check,
    four sets of q/k/v [8,12,L,64] and a [32,12] table at L = 1024, 1024,
    1000, 1024, so these two checks keep the inputs they were validated on."""
    import torch

    gen = torch.Generator().manual_seed(0)
    for length in (1024, 1024, 1000, 1024):
        for _ in range(3):
            torch.randn(8, 12, length, 64, generator=gen)
        torch.randn(32, 12, generator=gen)
    return gen


def topk_thin_rows(n: int, dtype):
    """[8, n] rows (n > 3000) of ``dtype`` on which ``_topk_iterative``
    re-picks: fewer than k entries above finfo(dtype).min, with -inf masks,
    entries at finfo.min, and one masked row with ties and enough entries
    (row 4)."""
    import torch

    lo = torch.finfo(dtype).min
    x = torch.full((8, n), float("-inf"), dtype=dtype)
    x[0, 100], x[0, 3000], x[0, 7] = 3.0, 2.0, 1.0     # picks [100, 3000, 7, 7, ...]
    x[1] = lo
    x[1, 50] = 0.0                                     # picks [50, 0, 0, ...]
    # row 2: -inf only: picks [0, 0, ...], values [-inf, min, min, ...]
    x[3, 20] = x[3, 9] = lo
    x[3, 1000] = x[3, 2000] = 5.0                      # picks [1000, 2000, 9, 9, ...]
    x[4, n // 2:] = (torch.arange(n - n // 2) * 7919 % 1013).to(dtype)
    x[5] = lo
    x[5, 0] = float("-inf")
    x[5, n - 1] = 0.0                                  # picks [n - 1, 1, 1, ...]
    x[6, n - 1] = lo                                   # picks [n - 1, n - 1, ...]
    x[7, 0] = -1.0                                     # picks [0, 0, ...]
    return x


TOPK_SHAPES = ((8, 4 * 32200, 8, "float32"),    # serving: 8 examples x 2K of 4 beams
               (8, 4 * 32200, 8, "bfloat16"),
               (1, 5 * 51865, 5, "float32"),    # Whisper beam 5, the one-file transcribe
               (8, 5 * 51865, 5, "float32"),    # Whisper beam 5 at batch 8
               (8, 51865, 5, "float32"),        # Whisper's first beam step
               (16, 4 * 32200, 8, "float32"),   # VC's eval: 16 clips x 2K of 4 beams
               (1, 4 * 32200, 8, "float32"),    # demo_vid2seq: one video x 2K of 4 beams
               (8, 2 * 32128, 4, "float32"))    # BLIP-2 Flan-T5-XL: 8 frames x 2K of 2 beams


def check_topk(gen):
    """The top-k kernel against its plain version, values and indices
    exactly, at the serving shape (f32 and bf16, k 8, with forced ties and
    beam-search start rows), VC's and demo_vid2seq's (16 and 1 rows),
    BLIP-2's beam 2 (k 4) and the Whisper beam's shapes (k 5, odd rows),
    each with the rows on which the plain version re-picks an entry at
    finfo.min appended. Each shape timed by CUDA-graph replay (device time),
    the kernel beside torch.topk and the plain version, and eagerly."""
    import torch

    from vidchapters_tpu_torch.ops import decoding as dec
    from vidchapters_tpu_torch.ops._build import sm_count

    shapes = []
    own = torch.Generator().manual_seed(5)
    for i, (rows, n, k, dt) in enumerate(TOPK_SHAPES):
        dtype = getattr(torch, dt)
        # the first shape's draw is the one check_megakernel's inputs follow
        x = torch.randn(rows, n, generator=gen if i == 0 else own) - 20.0
        x[0, 5] = x[0, n - 7] = x[0].max() + 1.0
        if rows > 1:
            x[1, 10:13] = x[1].max() + 2.0
            x[2] = -1e7                       # beam-search start rows: ulp 1.0
            x[2, n // 4:n // 4 + 10] = -1e7 + 1.0
            x[3, ::97] = x[3].max() + 0.5
        x = x.to("cuda", dtype)
        thin = topk_thin_rows(n, dtype).cuda()
        for xx in (x, thin):
            got_v, got_i = dec._topk_small(xx, k)
            ref_v, ref_i = dec._topk_iterative(xx, k)
            torch.cuda.synchronize()
            check(torch.equal(got_i, ref_i) and torch.equal(got_v, ref_v),
                  f"top-k [{xx.shape[0]},{n}] {dt} k={k} differs from plain")
        kernel = lambda: dec._topk_small(x, k)  # noqa: E731
        library = lambda: torch.topk(x, k)  # noqa: E731
        plain = lambda: dec._topk_iterative(x, k)  # noqa: E731
        nbytes = rows * n * x.element_size() + rows * k * (x.element_size() + 4)
        bms, by = bound(nbytes, rows * n, H100_FP32_FLOPS)
        shapes.append({"shape": f"[{rows}, {n}] {dt}, k={k}",
                       "blocks_per_row": dec.topk_splits(rows, n, sm_count(0)),
                       "ms": time_ms_graph(kernel), "library_ms": time_ms_graph(library),
                       "plain_ms": time_ms_graph(plain, iters=5), "bound_ms": bms,
                       "bound_by": by,
                       "eager_ms": {"kernel": time_ms(kernel, 50),
                                    "library": time_ms(library, 50)}})
        say(f"[check] topk [{rows},{n}] {dt} k={k} (+{thin.shape[0]} thin rows): values and "
            f"indices identical; {shapes[-1]['ms']:.4f} ms, torch.topk "
            f"{shapes[-1]['library_ms']:.4f} ms, bound {bms:.4f} ms")
    main = shapes[0]
    return {"name": "topk", "route": "cuda", "source": "vidchapters_tpu_torch/csrc/topk.cu",
            "replaces": "vidchapters_tpu/ops/decoding.py:269", "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timing": TIMING_GRAPH, "shape": main["shape"], "shapes": shapes}


def decode_kernel_tol(ref, dtype) -> float:
    """The decode kernel's bound against its plain version: fp32 1e-4; bf16
    3e-2, or 2^-5 of the largest reference element where that is larger.
    The residual stream is rounded to bf16 after every add, as the TPU kernel
    rounds it, so a sum taken in another order can flip one residual
    rounding, which the later layers carry: at full width the plain version
    computed on the CPU and on the card part from each other by as much as
    the kernel parts from either (up to 0.078 with a largest element of
    4.19; PERF.md, PR 8)."""
    if dtype == "float32" or str(dtype) == "torch.float32":
        return 1e-4
    return max(3e-2, 2.0 ** -5 * float(ref.float().abs().max()))


MEGA_SHAPE = dict(b0=8, g=4, n=12, length=256, lenc=1152, d=768, heads=12, dff=3072)


def megakernel_inputs(gen, b0: int = MEGA_SHAPE["b0"], length: int = MEGA_SHAPE["length"],
                      device: str = "cpu"):
    """The decode kernel's check inputs at full width (``b0`` examples x 4
    beams, 12 layers, L ``length``, Lenc 1152; serving's 8 and 256 by
    default), in fp32 on ``device`` (``gen``'s): (stacked weights, x, self
    caches, cross K/V, the [L, L, H] bias table, the encoder mask, the beam
    permutation)."""
    import torch

    _, g, n, _, lenc, d, heads, dff = MEGA_SHAPE.values()
    inner, rows = d, b0 * g

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def w(*shape, fan_in):
        return randn(*shape) * fan_in ** -0.5

    # T5's init scales: q carries the absent 1/sqrt(d_kv) of the scores
    dkv = inner // heads
    stacked = {"ln": 1.0 + 0.1 * randn(n, 3, d),
               "wqkv": torch.cat([w(n, d, inner, fan_in=d * dkv),
                                  w(n, d, 2 * inner, fan_in=d)], dim=2),
               "wo_self": w(n, inner, d, fan_in=inner),
               "wq_cross": w(n, d, inner, fan_in=d * dkv),
               "wo_cross": w(n, inner, d, fan_in=inner),
               "wi": w(n, d, dff, fan_in=d), "wo_ff": w(n, dff, d, fan_in=dff),
               "final_ln": 1.0 + 0.1 * randn(1, d)}
    x = randn(rows, d)
    kc, vc = (randn(rows, n, length, inner) for _ in range(2))
    kx, vx = (randn(b0, n, lenc, inner) for _ in range(2))
    bias_all = randn(length, length, heads)
    mask = torch.ones(b0, lenc, dtype=torch.int32, device=device)
    for e in range(b0):
        mask[e, 100 + 100 * e % 1000:] = 0   # 100 video frames + per-example ASR length
    src = torch.tensor([(r // g) * g + (r * 3 + 1) % g for r in range(rows)], dtype=torch.int32,
                       device=device)
    return stacked, x, kc, vc, kx, vx, bias_all, mask, src


# serving's 8 x 4 beams, greedy 8 x 1, the short bucket, and demo_vid2seq's one
# video x 4 beams (phase 11b)
MEGA_FORMS = ((8, 4), (8, 1), (2, 4), (1, 4))
MEGA_PHASES = ("set-up", "qkv", "self-attention", "self out", "cross q", "cross-attention",
               "cross out", "wi", "wo_ff", "final norm")


# the kernel's small test forms (tests/test_torch_decode_megakernel_emulated.py
# on the CPU, tests/test_torch_cuda_kernels.py on the card), at 2 layers, d
# 128, L 16: (examples, beams, heads, d_ff, encoder keys, SMs of the
# emulation, gated, cache indices)
MEGA_TEST_L = 16
MEGA_TEST_FORMS = {"greedy": (8, 1, 2, 256, 40, 3, False, (0, MEGA_TEST_L - 1)),
                   "beam": (2, 4, 4, 256, 72, 3, False, (7,)),
                   "gated": (2, 4, 4, 256, 72, 2, True, (7,)),
                   "long": (1, 4, 2, 256, 1500, 4, False, (MEGA_TEST_L - 1,)),
                   "passes": (7, 8, 2, 256, 40, 3, False, (MEGA_TEST_L - 1,))}


def mega_step_inputs(gen, b0: int, group: int, heads: int, dff: int, lenc: int, gated: bool,
                     dtype, n: int = 2, d: int = 128, length: int = MEGA_TEST_L):
    """Seeded inputs of one small T5 decode step on the CPU (the kernel's
    tests): stacked weights (T5's init scales, the JAX layout plus the
    kernel's), x, the caches, the cross K/V, a bias row and bias0, the
    encoder mask (example 0's keys end 13 keys before the end, inside a
    32-key tile; example 1 has keys 8..39 masked, a 32-key hole, and its
    last 5; example 2 none unmasked), and a beam permutation within each
    example (None for one beam)."""
    import torch

    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    inner, rows, N, D, LENGTH = d, b0 * group, n, d, length
    dkv = inner // heads

    def w(*shape, fan_in):
        return torch.randn(*shape, generator=gen) * fan_in ** -0.5

    st = {"ln": 1.0 + 0.1 * torch.randn(N, 3, D, generator=gen),
          "wqkv": torch.cat([w(N, D, inner, fan_in=D * dkv), w(N, D, 2 * inner, fan_in=D)], 2),
          "wo_self": w(N, inner, D, fan_in=inner), "wq_cross": w(N, D, inner, fan_in=D * dkv),
          "wo_cross": w(N, inner, D, fan_in=inner),
          "wi": w(N, D, 2 * dff if gated else dff, fan_in=D), "wo_ff": w(N, dff, D, fan_in=dff),
          "final_ln": 1.0 + 0.1 * torch.randn(1, D, generator=gen)}
    st = {k: (v if k in ("ln", "final_ln") else v.to(dtype)) for k, v in st.items()}
    x = torch.randn(rows, D, generator=gen).to(dtype)
    kc, vc = (torch.randn(rows, N, LENGTH, inner, generator=gen).to(dtype) for _ in range(2))
    kx, vx = (torch.randn(b0, N, lenc, inner, generator=gen).to(dtype) for _ in range(2))
    bias_row = torch.randn(LENGTH, heads, generator=gen)
    bias0 = torch.randn(1, heads, generator=gen)
    mask = torch.ones(b0, lenc, dtype=torch.int32)
    mask[0, lenc - 13:] = 0
    if b0 > 1:
        mask[1, 8:40] = 0
        mask[1, lenc - 5:] = 0
    if b0 > 2:
        mask[2] = 0
    src = torch.tensor([(r // group) * group + (r * 3 + 1) % group for r in range(rows)],
                       dtype=torch.int32) if group > 1 else None
    return dm.with_kernel_layout(st), x, kc, vc, kx, vx, bias_row, bias0, mask, src


def _mega_form(inputs, b0: int, g: int):
    """megakernel_inputs cut to the first b0 examples, with all their beams
    and the beam permutation (g = 4) or their first beam and none (g = 1,
    greedy)."""
    stacked, x, kc, vc, kx, vx, bias_all, mask, src = inputs
    full = MEGA_SHAPE["g"]
    check(g in (1, full), f"decode kernel form {b0}x{g}: beams must be 1 or {full}")
    rows = [e * full + j for e in range(b0) for j in range(g)]
    return (stacked, x[rows], kc[rows], vc[rows], kx[:b0], vx[:b0], bias_all, mask[:b0],
            src[rows] if g > 1 else None)


def _mega_live_keys(mask) -> int:
    """Encoder keys the kernel reads, summed over the examples: each
    example's keys up to its last unmasked one (the kernel skips the rest)."""
    total = 0
    for row in mask.tolist():
        last = max((k + 1 for k, v in enumerate(row) if v > 0), default=len(row))
        total += last
    return total


def _mega_bytes(rows: int, b0: int, idx: int, beam: bool, live: int):
    """Bytes one T5-base step of the decode kernel must move, by phase
    (bf16, summed over the layers): each weight once, the live cross K/V
    rows, the self-cache rows < idx read (and, for a beam, written to the
    new caches), row idx written, x, hidden, k/v new."""
    n, d, dff, inner = (MEGA_SHAPE[k] for k in ("n", "d", "dff", "d"))
    self_rows = 2 * rows * idx * inner * 2 * (2 if beam else 1)
    return {"qkv": n * (3 * d * inner * 2 + 2 * rows * inner * 2 * 2),
            "self-attention": n * self_rows, "self out": n * inner * d * 2,
            "cross q": n * d * inner * 2, "cross-attention": n * 2 * live * inner * 2,
            "cross out": n * inner * d * 2, "wi": n * d * dff * 2, "wo_ff": n * dff * d * 2,
            "norms and rows": n * 4 * 3 * d + 4 * d + rows * d * 2 * 2}


def _mega_bound(rows: int, b0: int, idx: int, beam: bool, live: int, g: int):
    """(ms, by) of one step: _mega_bytes over the HBM rate, or the products'
    and attention's operations (live keys only) over the bf16 tensor-core
    peak, whichever is larger."""
    n, d, dff, inner = (MEGA_SHAPE[k] for k in ("n", "d", "dff", "d"))
    params = n * (d * 3 * inner + 3 * inner * d + d * dff + dff * d)
    flops = 2 * rows * params + 4 * rows * n * inner * (idx + 1) + 4 * g * n * inner * live
    return bound(sum(_mega_bytes(rows, b0, idx, beam, live).values()), flops, H100_BF16_FLOPS)


def _mega_phases(call, n_layers: int):
    """ms of each phase of one kernel step, summed over the layers, from the
    kernel's own timeline (%globaltimer after each grid barrier; the median
    of 5 calls)."""
    import statistics

    import torch

    from vidchapters_tpu_torch.ops.decode_megakernel import PHASES

    runs = []
    for _ in range(5):
        tl = torch.zeros(PHASES * n_layers + 3, dtype=torch.int64, device="cuda")
        call(tl)
        torch.cuda.synchronize()
        t = tl.cpu().tolist()
        per = [(t[1] - t[0]) / 1e6] + [0.0] * PHASES + [(t[-1] - t[-2]) / 1e6]
        for i in range(2, len(t) - 1):
            per[1 + (i - 2) % PHASES] += (t[i] - t[i - 1]) / 1e6
        runs.append(per)
    return {name: statistics.median(r[i] for r in runs) for i, name in enumerate(MEGA_PHASES)}


def _hmma_counts(lib: str, kernel: str):
    """HMMA / HGMMA instructions of each instantiation of ``kernel`` in the
    SASS of library ``lib``, by cuobjdump (beside nvcc). Fails without it."""
    from vidchapters_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    check(tool.exists(), f"cuobjdump not found beside nvcc ({tool})")
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib} failed: {sass.stderr[:500]}")
    counts = {}
    for section in sass.stdout.split("Function : ")[1:]:
        fn = section.split("\n", 1)[0].strip()
        if kernel in fn:
            counts[fn] = section.count("HMMA") + section.count("HGMMA")
    return counts


def check_mega_tensor_cores():
    """The bf16 instantiation of the T5 decode kernel runs its products on
    the tensor cores (HMMA in its SASS); the fp32 one has none."""
    counts = _hmma_counts("decode_megakernel", "mega_decode_kernel")
    bf16 = {fn: c for fn, c in counts.items() if "mega_decode_kernelI13__nv_bfloat16" in fn}
    fp32 = {fn: c for fn, c in counts.items() if "mega_decode_kernelIf" in fn}
    say("[check] decode kernel tensor cores: HMMA/HGMMA per instantiation "
        + ", ".join(f"{fn[:60]} {c}" for fn, c in sorted(counts.items())))
    check(len(bf16) == 1 and all(c > 0 for c in bf16.values()),
          f"the bf16 decode kernel must hold HMMA: {counts}")
    check(len(fp32) == 1 and all(c == 0 for c in fp32.values()),
          f"the fp32 decode kernel must hold no HMMA: {counts}")
    return counts


def _mega_check(st, ts, m, s, bias_all, idxs, dtype, g: int, label: str):
    """One form of the decode kernel against its plain version at each cache
    index of ``idxs``: hidden and k/v new within ``decode_kernel_tol``, the
    permuted cache rows bit for bit (greedy: the other rows untouched), row
    idx the new k/v. Returns (the largest error, the largest tolerance)."""
    import torch

    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    heads = MEGA_SHAPE["heads"]
    xx, kk, vv, kxx, vxx = ts
    worst, tol = 0.0, 0.0
    for idx in idxs:
        br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
        k_in, v_in = kk.clone(), vv.clone()
        got = dm.mega_decode_step(st, xx, k_in, v_in, kxx, vxx, br, b0b, m, idx, g, heads, src=s)
        ref = dm.mega_decode_step_plain(st, xx, kk.clone(), vv.clone(), kxx, vxx, br, b0b, m,
                                        idx, g, heads, src=s)
        torch.cuda.synchronize()
        per = {name: (a.float() - r.float()).abs().max().item()
               for name, a, r in zip(("hidden", "k_new", "v_new"), got, ref)}
        tols = [decode_kernel_tol(r, dtype) for r in ref[:3]]
        check(all(torch.isfinite(a.float()).all().item() for a in got[:3]),
              f"decode kernel {dtype} {label} idx={idx}: not finite")
        check(all(within(a, r, t) for a, r, t in zip(got[:3], ref[:3], tols)),
              f"decode kernel {dtype} {label} idx={idx}: err {per} > {tols}")
        tol = max(tol, *tols)
        caches = got[3:] if s is not None else (k_in, v_in)
        for c_got, new in zip(caches, got[1:3]):
            check(torch.equal(c_got[:, :, idx], new),
                  f"decode kernel {dtype} {label} idx={idx}: cache row idx != new k/v")
        if s is not None:
            for c_got, c_ref in zip(got[3:], ref[3:]):
                check(torch.equal(c_got[:, :, :idx], c_ref[:, :, :idx]),
                      f"decode kernel {dtype} {label} idx={idx}: permuted rows differ")
        else:
            keep = [i for i in range(kk.shape[2]) if i != idx]
            check(torch.equal(k_in[:, :, keep], kk[:, :, keep]) and
                  torch.equal(v_in[:, :, keep], vv[:, :, keep]),
                  f"decode kernel {dtype} {label} idx={idx}: greedy touched other rows")
        worst = max(worst, max(per.values()))
    return worst, tol


def check_megakernel(gen):
    """The T5 decode kernel against its plain version at T5-base width (12
    layers, d 768, 12 heads, d_ff 3072, L 256, 1152 encoder keys), fp32 and
    bf16, at 8 examples x 4 beams (serving), greedy 8 x 1, 2 x 4 (the
    short bucket) and 1 x 4 (demo_vid2seq), each at cache indices 0, 1,
    127, 128 and 255: hidden and k/v new within ``decode_kernel_tol``, the
    permuted cache rows bit for bit, row idx the new k/v (greedy: written
    in place). Two bf16 calls at
    8 x 4 bit-identical. Timed at idx 128 in bf16 by CUDA-graph replay (the
    eager time beside it), with the kernel's timeline per phase, the grid
    barrier alone and the SASS's HMMA count."""
    import torch

    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    heads, n = MEGA_SHAPE["heads"], MEGA_SHAPE["n"]
    inputs = megakernel_inputs(gen)
    bias_all = inputs[6]

    def on(dtype, b0, g):
        stacked, x, kc, vc, kx, vx, _, mask, src = _mega_form(inputs, b0, g)
        st = dm.with_kernel_layout(
            {kk: (v.cuda() if kk in ("ln", "final_ln") else v.to("cuda", dtype))
             for kk, v in stacked.items()})
        ts = [t.to("cuda", dtype) for t in (x, kc, vc, kx, vx)]
        return st, ts, mask.cuda(), None if src is None else src.cuda(), mask

    errs, identical = {}, False
    for dtype in (torch.float32, torch.bfloat16):
        for b0, g in MEGA_FORMS:
            st, ts, m, s, _ = on(dtype, b0, g)
            worst, tol = _mega_check(st, ts, m, s, bias_all, (0, 1, 127, 128, 255), dtype, g,
                                     f"{b0}x{g}")
            if dtype == torch.bfloat16 and (b0, g) == (8, 4):
                # sums in a fixed order: a second call gives the same bits
                xx, kk, vv, kxx, vxx = ts
                idx = 128
                br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
                got = dm.mega_decode_step(st, xx, kk.clone(), vv.clone(), kxx, vxx, br, b0b, m,
                                          idx, g, heads, src=s)
                again = dm.mega_decode_step(st, xx, kk.clone(), vv.clone(), kxx, vxx, br, b0b,
                                            m, idx, g, heads, src=s)
                check(all(torch.equal(p, q) for p, q in zip(again[:3], got[:3])) and
                      all(torch.equal(p[:, :, :idx + 1], q[:, :, :idx + 1])
                          for p, q in zip(again[3:], got[3:])),
                      "decode kernel bf16 8x4: two calls differ")
                identical = True
            errs[(str(dtype).split(".")[-1], f"{b0}x{g}")] = worst
            say(f"[check] decode kernel {dtype} {b0}x{g} idx 0/1/127/128/255: max_abs_err "
                f"{worst:.3e} (tol up to {tol:.4f}"
                f"{', or 2 bf16 ulps' if dtype == torch.bfloat16 else ''}); "
                f"{'permuted' if g > 1 else 'untouched'} rows and new rows exact")
            del st, ts
            torch.cuda.empty_cache()
    times, idx = {}, 128
    for b0, g in MEGA_FORMS:
        st, (xx, kk, vv, kxx, vxx), m, s, mask = on(torch.bfloat16, b0, g)
        br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
        outs = (torch.empty_like(kk), torch.empty_like(vv)) if s is not None else None
        kernel = lambda: dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g,  # noqa: E731
                                             heads, src=s, out_caches=outs)
        plain = lambda: dm.mega_decode_step_plain(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g,  # noqa: E731
                                                  heads, src=s, out_caches=outs)
        live = _mega_live_keys(mask)
        t = {"ms": time_ms_graph(kernel, 10, 3), "eager_ms": time_ms(kernel, 10),
             "plain_ms": time_ms_graph(plain, 3, 2), "live_keys": live}
        t["bound_ms"], t["bound_by"] = _mega_bound(b0 * g, b0, idx, g > 1, live, g)
        t["phases_ms"] = _mega_phases(
            lambda tl: dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g, heads,
                                           src=s, out_caches=outs, timeline=tl), n)
        nbytes = _mega_bytes(b0 * g, b0, idx, g > 1, live)
        t["phase_tb_s"] = {k: v / (t["phases_ms"][k] * 1e-3) / 1e12
                           for k, v in nbytes.items() if k in t["phases_ms"]}
        times[f"{b0}x{g}"] = t
        say(f"[time] decode kernel {b0}x{g} bf16 idx {idx}: {t}")
        del st, xx, kk, vv, kxx, vxx, outs
        torch.cuda.empty_cache()
    n_bar = dm.PHASES * n + 1
    per = []
    for _ in range(5):
        tl = dm.barrier_step(n_bar).cpu().tolist()
        per.append((tl[-1] - tl[0]) / n_bar / 1e3)
    barrier_us = sorted(per)[2]
    say(f"[time] decode kernel grid barrier alone: {barrier_us:.3f} us ({n_bar} a step: "
        f"{barrier_us * n_bar / 1e3:.4f} ms)")
    hmma = check_mega_tensor_cores()
    vc_form = check_megakernel_vc()
    main = times["8x4"]
    return {"name": "decode_megakernel", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/decode_megakernel.cu",
            "replaces": "vidchapters_tpu/ops/decode_megakernel.py:519",
            "max_abs_err": max(v for k, v in errs.items() if k[0] == "bfloat16"),
            "max_abs_err_fp32": max(v for k, v in errs.items() if k[0] == "float32"),
            "errors": {"/".join(k): v for k, v in errs.items()},
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "library": "none (no single call)",
            "eager_ms": main["eager_ms"], "phases_ms": main["phases_ms"],
            "greedy_8x1": times["8x1"], "beam_2x4": times["2x4"], "beam_1x4": times["1x4"],
            "vc_16x4_L32": vc_form,
            "bit_identical_8x4_bf16": identical, "barrier_us": barrier_us,
            "hmma_per_kernel": hmma, "ptxas": _ptxas_lines("decode_megakernel"),
            "timing": TIMING_GRAPH,
            "bound_note": "cross K/V bytes and operations of the live keys only (each "
                          "example's keys up to its last unmasked one), which the kernel reads",
            "shape": "8 examples x 4 beams, 12 layers, L=256, Lenc=1152, idx=128, bf16"}


MEGA_VC = (16, 32)  # VC's eval (phase 9): 16 clips x 4 beams = 64 rows, max_length 32


def check_megakernel_vc():
    """The T5 decode kernel at VC's eval form: 16 examples x 4 beams (64
    rows: two product passes), L 32, 1152 encoder keys, T5-base width, fp32
    and bf16 at cache indices 0, 1, 15, 16 and 31, held as
    ``check_megakernel`` holds the other forms; timed at idx 16 in bf16 by
    CUDA-graph replay beside its plain version and its bound."""
    import torch

    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    b0, length = MEGA_VC
    g, heads, idx = MEGA_SHAPE["g"], MEGA_SHAPE["heads"], 16
    gen = torch.Generator(device="cuda").manual_seed(14)
    stacked, x, kc, vc, kx, vx, bias_all, mask, src = megakernel_inputs(
        gen, b0=b0, length=length, device="cuda")
    out = {"shape": f"{b0} examples x {g} beams, 12 layers, L={length}, Lenc=1152"}
    for dtype in (torch.float32, torch.bfloat16):
        st = dm.with_kernel_layout({k: (v if k in ("ln", "final_ln") else v.to(dtype))
                                    for k, v in stacked.items()})
        ts = [t.to(dtype) for t in (x, kc, vc, kx, vx)]
        worst, tol = _mega_check(st, ts, mask, src, bias_all, (0, 1, 15, 16, length - 1),
                                 dtype, g, f"{b0}x{g} L{length}")
        name = str(dtype).split(".")[-1]
        out[f"max_abs_err_{name}"], out[f"tol_{name}"] = worst, tol
        say(f"[check] decode kernel {dtype} {b0}x{g} L {length} idx 0/1/15/16/{length - 1}: "
            f"max_abs_err {worst:.3e} (tol up to {tol:.4f}); permuted and new rows exact")
        if dtype == torch.bfloat16:
            xx, kk, vv, kxx, vxx = ts
            br, b0b = bias_all[idx].contiguous(), bias_all[0, :1].contiguous()
            outs = (torch.empty_like(kk), torch.empty_like(vv))
            kernel = lambda: dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, mask,  # noqa: E731
                                                 idx, g, heads, src=src, out_caches=outs)
            plain = lambda: dm.mega_decode_step_plain(st, xx, kk, vv, kxx, vxx, br, b0b,  # noqa: E731
                                                      mask, idx, g, heads, src=src,
                                                      out_caches=outs)
            live = _mega_live_keys(mask.cpu())
            out.update(ms=time_ms_graph(kernel, 10, 3), plain_ms=time_ms_graph(plain, 3, 2),
                       live_keys=live)
            out["bound_ms"], out["bound_by"] = _mega_bound(b0 * g, b0, idx, True, live, g)
            say(f"[time] decode kernel {b0}x{g} L {length} bf16 idx {idx}: {out['ms']:.4f} ms "
                f"(plain {out['plain_ms']:.4f}, bound {out['bound_ms']:.4f} by "
                f"{out['bound_by']})")
        del st, ts
        torch.cuda.empty_cache()
    return out


DEC_ROWS, DEC_HEADS, DEC_LEN, DEC_DKV = 32, 12, 256, 64  # 8 examples x 4 beams, T5-base
DEC_LENC = 1152  # 100 frames + the 1000 input bucket, padded to 128 by Vid2Seq.encode
TIMING_GRAPH = ("device time per call: 20 calls in one CUDA graph, replayed 5 times "
                "(eager_ms: back-to-back eager calls, which the host's per-call work bounds)")


def check_decode_self_attention(gen):
    """The decode self-attention kernel against its plain version at the
    standard decode's beam-4 shape (32 rows: 8 examples x 4 beams) and its
    greedy / nucleus shape (8 rows, its keys split over blocks), cache
    indices 0, 127 and 255, fp32 and bf16: the output within tolerance, the
    caches bit for bit (row idx is the new k/v, every other row untouched).
    Timed at idx 255 (every cache row read) and 127 for both row counts, by
    CUDA-graph replay (device time) and eagerly; the yardstick is an
    ``index_copy_`` of the new rows and SDPA (scale 1, the bias row as its
    float mask). The 8-row inputs are the first 8 rows of the 32-row ones."""
    import torch

    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops._build import sm_count

    r, h, length, d = DEC_ROWS, DEC_HEADS, DEC_LEN, DEC_DKV
    q, k_new, v_new = (torch.randn(r, h, 1, d, generator=gen) for _ in range(3))
    kc, vc = (torch.randn(r, h, length, d, generator=gen) for _ in range(2))
    bias_all = torch.randn(1, h, 1, length, generator=gen)

    def inputs(dtype, idx, rows):
        bias = bias_all.clone()
        bias[..., idx + 1:] = da.NEG_INF
        return [t[:rows].to("cuda", dtype) for t in (q, k_new, v_new, kc, vc)] + [
            bias.to("cuda", dtype)]

    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for rows in (r, 8):
            for idx in (0, 127, length - 1):
                qq, kn, vn, kk, vv, bb = inputs(dtype, idx, rows)
                k2, v2 = kk.clone(), vv.clone()
                out, k_out, v_out = da.decode_self_attention(qq, kn, vn, kk, vv, bb, idx)
                ref, k_ref, v_ref = da.decode_self_attention_plain(qq, kn, vn, k2, v2, bb, idx)
                torch.cuda.synchronize()
                check(k_out is kk and v_out is vv, "decode_self_attention: caches not in place")
                check(torch.equal(kk, k_ref) and torch.equal(vv, v_ref),
                      f"decode_self_attention {dtype} rows={rows} idx={idx}: caches differ "
                      f"from plain")
                err = (out.float() - ref.float()).abs().max().item()
                check(within(out, ref, tol),
                      f"decode_self_attention {dtype} rows={rows} idx={idx}: err {err}")
                worst = max(worst, err)
        say(f"[check] decode_self_attention [{r} and 8,{h},1,{d}] over [.,{h},{length},{d}] "
            f"{dtype} idx 0/127/255: max_abs_err {worst:.3e} (tol {tol}"
            f"{', or 2 bf16 ulps' if dtype == torch.bfloat16 else ''}); caches bit-identical")
        errs[dtype] = worst

    def timed(rows, idx):
        qq, kn, vn, kk, vv, bb = inputs(torch.bfloat16, idx, rows)
        where = torch.tensor([idx], device="cuda")
        kernel = lambda: da.decode_self_attention(qq, kn, vn, kk, vv, bb, idx)  # noqa: E731
        plain = lambda: da.decode_self_attention_plain(qq, kn, vn, kk, vv, bb, idx)  # noqa: E731

        def library():
            kk.index_copy_(2, where, kn)
            vv.index_copy_(2, where, vn)
            return torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=bb,
                                                                    scale=1.0)

        # read: q, k_new, v_new, the idx live cache rows of k and v, the bias
        # row; written: out and the new cache rows (bf16)
        n = idx + 1
        nbytes = 2 * (3 * rows * h * d + 2 * rows * h * (n - 1) * d + h * n + rows * h * d
                      + 2 * rows * h * d)
        bms, by = bound(nbytes, 4 * rows * h * n * d, H100_BF16_FLOPS)
        return {"rows": rows, "idx": idx,
                "splits": da.self_splits(rows * h, n, sm_count(0))[0],
                "ms": time_ms_graph(kernel), "plain_ms": time_ms_graph(plain),
                "library_ms": time_ms_graph(library), "bound_ms": bms, "bound_by": by,
                "eager_ms": {"kernel": time_ms(kernel, 50), "plain": time_ms(plain, 20),
                             "library": time_ms(library, 50)}}

    forms = [timed(rows, idx) for rows in (r, 8) for idx in (length - 1, 127)]
    for f in forms:
        say(f"[check] decode_self_attention {f['rows']} rows idx {f['idx']} ({f['splits']} "
            f"splits): {f['ms']:.4f} ms, index_copy_ + SDPA {f['library_ms']:.4f} ms, bound "
            f"{f['bound_ms']:.4f} ms")
    main = forms[0]
    torch.cuda.synchronize()
    return {"name": "decode_self_attention", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vidchapters_tpu/ops/decode_attention.py:66",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
            "ms": main["ms"], "ms_idx127": forms[1]["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "timing": TIMING_GRAPH,
            "eager_ms": main["eager_ms"], "forms": forms,
            "library": "index_copy_ of the new rows + SDPA (scale 1, float bias mask)",
            "shape": f"q [{r},{h},1,{d}], caches [{r},{h},{length},{d}] bf16, idx {length - 1}"}


def check_decode_cross_attention(gen):
    """The decode cross-attention kernel against its plain version at 8
    examples x 4 beams (beam search) and x 1 (nucleus), Lk 1152 with each
    example's padded tail masked, fp32 and bf16; then at five edge forms: an
    example with no unmasked key (the mean of V), holes inside the live
    keys, 8 beams, D 128, and 32 examples. Timed at 4 and 1 beams with the
    live ends found once (as the decode does), by CUDA-graph replay (device
    time; also with the L2 cache flushed before each call) and eagerly; the
    yardstick is SDPA (scale 1) over K/V expanded across the beams, with the
    mask as a float mask."""
    import torch

    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops._build import sm_count

    b0, h, lk, d = DEC_ROWS // 4, DEC_HEADS, DEC_LENC, DEC_DKV
    k, v = (torch.randn(b0, h, lk, d, generator=gen) for _ in range(2))
    q8 = torch.randn(b0 * 8, h, 1, d, generator=gen)
    mask = torch.ones(b0, lk, dtype=torch.int32)
    for e in range(b0):  # 100 frames + per-example ASR length, then the pad
        mask[e, 100 + 1000 - 90 * e:] = 0
    no_key, holes = mask.clone(), mask.clone()
    no_key[3] = 0
    holes[0, 5:40] = holes[2, 500:700] = holes[5, 0:1] = holes[7, 469] = 0
    k128, v128 = (torch.randn(b0, h, lk, 128, generator=gen) for _ in range(2))
    q128 = torch.randn(b0 * 4, h, 1, 128, generator=gen)
    q32 = torch.randn(32 * 4, h, 1, d, generator=gen)
    # (label, q, k, v, mask); b32: 32 examples (serving's largest batch), one
    # chunk an (example, head), more tiles a warp than its ring holds
    forms = [("g4", q8[:b0 * 4], k, v, mask), ("g1", q8[:b0], k, v, mask),
             ("no_key", q8[:b0 * 4], k, v, no_key), ("holes", q8[:b0 * 4], k, v, holes),
             ("g8", q8, k, v, holes), ("d128", q128, k128, v128, mask),
             ("b32", q32, k.repeat(4, 1, 1, 1), v.repeat(4, 1, 1, 1), holes.repeat(4, 1))]
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for label, qq, kk, vv, mm in forms:
            qq, kk, vv = (t.to("cuda", dtype) for t in (qq, kk, vv))
            mm = mm.cuda()
            got = da.decode_cross_attention(qq, kk, vv, mm)
            ref = da.decode_cross_attention_plain(qq, kk, vv, mm)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            check(within(got, ref, tol),
                  f"decode_cross_attention {dtype} {label}: err {err}")
            worst = max(worst, err)
        say(f"[check] decode_cross_attention {b0} examples x 4 / x 1 beams, Lk {lk} padded, "
            f"and {', '.join(f[0] for f in forms[2:])}, {dtype}: max_abs_err {worst:.3e} "
            f"(tol {tol}{', or 2 bf16 ulps' if dtype == torch.bfloat16 else ''})")
        errs[dtype] = worst
    mask = mask.cuda()
    live_ends = da.cross_live_ends(mask)  # once per decode call, as T5Stack.decode_step
    live = int(live_ends.sum().item())

    def timed(group):
        qq, kk, vv = (t.to("cuda", torch.bfloat16) for t in (q8[:b0 * group], k, v))
        kernel = lambda: da.decode_cross_attention(qq, kk, vv, mask, live_ends)  # noqa: E731
        plain = lambda: da.decode_cross_attention_plain(qq, kk, vv, mask)  # noqa: E731
        ke, ve = (t.repeat_interleave(group, dim=0) for t in (kk, vv))
        fmask = ((mask.repeat_interleave(group, dim=0)[:, None, None, :] - 1) * 1e9
                 ).to(torch.bfloat16)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qq, ke, ve, attn_mask=fmask, scale=1.0)
        rows = b0 * group
        # masked keys past each example's last live key do not change the
        # output: count the K/V rows of its live keys (bf16), q and out, and
        # the int32 live ends and mask entries of those keys, each read once
        nbytes = 2 * (2 * h * live * d + 2 * rows * h * d) + 4 * (live + b0)
        bms, by = bound(nbytes, 4 * group * h * live * d, H100_BF16_FLOPS)
        return {"beams": group, "ms": time_ms_graph(kernel), "plain_ms": time_ms_graph(plain),
                "library_ms": time_ms_graph(library), "bound_ms": bms, "bound_by": by,
                "cold_l2_ms": {"kernel": time_ms_graph_cold(kernel),
                               "library": time_ms_graph_cold(library)},
                "eager_ms": {"kernel": time_ms(kernel, 50), "plain": time_ms(plain, 20),
                             "library": time_ms(library, 50)}}

    g4, g1 = timed(4), timed(1)
    for f in (g4, g1):
        say(f"[check] decode_cross_attention {b0} x {f['beams']} beams ({live} live keys): "
            f"{f['ms']:.4f} ms, SDPA {f['library_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms; "
            f"L2 cold {f['cold_l2_ms']['kernel']:.4f} ms, SDPA {f['cold_l2_ms']['library']:.4f}")
    torch.cuda.synchronize()
    return {"name": "decode_cross_attention", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vidchapters_tpu/ops/decode_attention.py:117",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
            "ms": g4["ms"], "plain_ms": g4["plain_ms"], "bound_ms": g4["bound_ms"],
            "bound_by": g4["bound_by"], "library_ms": g4["library_ms"], "timing": TIMING_GRAPH,
            "eager_ms": g4["eager_ms"], "cold_l2_ms": g4["cold_l2_ms"], "beams_1": g1,
            "live_keys": live,
            "blocks": da.cross_blocks(b0, h, sm_count(0)),
            "library": "SDPA (scale 1) over K/V expanded across beams",
            "shape": f"q [{b0 * 4},{h},1,{d}] over k/v [{b0},{h},{lk},{d}] bf16, g 4, "
                     f"{live} live keys"}


BLIP2_DEC = dict(heads=32, length=20, d=64)  # Flan-T5-XL's decode, 20 new tokens
BLIP2_REAL_KEYS = 46  # 32 query tokens + BLIP2_PROMPT's 13 ids and </s> under Flan-T5's spiece.model
# self-attention rows of phase 12(b): caption_fn's 8 frames, beam 2's 8 x 2,
# evaluate_vc_blip2's 2 clips a video, run_visual_vcg's one shot a call
BLIP2_SELF_ROWS = (8, 16, 2, 1)
BLIP2_CROSS_GROUPS = ((8, 1), (8, 2), (2, 1), (1, 1))  # (examples, beams), the same calls


def blip2_path_keys(root: Path, num_query_tokens: int = 32) -> int:
    """Cross keys of phase 12(b)'s BLIP-2 decode: the query tokens and
    ``BLIP2_PROMPT``'s ids with ``</s>`` under the synthetic
    ``spiece.model`` (written into ``root`` unless it is there)."""
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceUnigramTokenizer
    from vidchapters_tpu_torch.models import blip2
    from vidchapters_tpu_torch.zeroshot.visual_vcg import BLIP2_PROMPT

    path = root / "spiece.model"
    if not path.exists():
        _write_spm_model(path)
    tok = SentencePieceUnigramTokenizer(str(path), num_bins=0)
    return num_query_tokens + blip2.encode_prompts(tok, [BLIP2_PROMPT])[0].shape[1]


def blip2_cross_forms(path_keys: int):
    """(examples, beams, keys, live keys) of row 6 in phase 12(b), all live,
    and two with the last key masked; then the same decode under Flan-T5's
    own tokenizer (46 keys, and 45 with the last masked)."""
    forms = [(b0, g, path_keys, path_keys) for b0, g in BLIP2_CROSS_GROUPS]
    forms += [(8, g, path_keys, path_keys - 1) for g in (1, 2)]
    return forms + [(8, 1, BLIP2_REAL_KEYS, BLIP2_REAL_KEYS),
                    (8, 1, BLIP2_REAL_KEYS - 1, BLIP2_REAL_KEYS - 2)]


def check_decode_attention_blip2(gen):
    """Rows 5 and 6 at every form BLIP-2 Flan-T5-XL's decode launches in
    phase 12(b), 32 heads x 64: the self kernel at ``BLIP2_SELF_ROWS`` rows,
    L 20, cache indices 0 / 10 / 19; the cross kernel at
    ``blip2_cross_forms`` of the path's key count (``blip2_path_keys``);
    fp32 and bf16 against the plain versions (caches bit for bit). Each form
    timed in bf16 (idx 19) by CUDA-graph replay beside its plain version,
    SDPA and its bound. Returns (row 5's entries, row 6's entries)."""
    import torch

    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops._build import sm_count

    h, length, d = (BLIP2_DEC[k] for k in ("heads", "length", "d"))
    with tempfile.TemporaryDirectory() as tmp:
        path_keys = blip2_path_keys(Path(tmp))
    cross_forms = blip2_cross_forms(path_keys)
    rmax = max(BLIP2_SELF_ROWS)
    q, k_new, v_new = (torch.randn(rmax, h, 1, d, generator=gen) for _ in range(3))
    kc, vc = (torch.randn(rmax, h, length, d, generator=gen) for _ in range(2))
    bias_all = torch.randn(1, h, 1, length, generator=gen)
    kmax = max(f[2] for f in cross_forms)
    ck, cv = (torch.randn(8, h, kmax, d, generator=gen) for _ in range(2))

    def self_inputs(r, idx, dtype):
        bias = bias_all.clone()
        bias[..., idx + 1:] = da.NEG_INF
        return tuple(t.to("cuda", dtype) for t in (q[:r], k_new[:r], v_new[:r], kc[:r], vc[:r],
                                                     bias))

    def cross_inputs(b0, g, lk, live, dtype):
        mask = torch.ones(b0, lk, dtype=torch.int32)
        mask[:, live:] = 0
        kk, vv = (t[:b0, :, :lk].contiguous().to("cuda", dtype) for t in (ck, cv))
        return q[:b0 * g].to("cuda", dtype), kk, vv, mask.cuda()

    errs = {"self": {}, "cross": {}}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for r in BLIP2_SELF_ROWS:
            for idx in (0, 10, length - 1):
                qq, kn, vn, kk, vv, bb = self_inputs(r, idx, dtype)
                k2, v2 = kk.clone(), vv.clone()
                out, _, _ = da.decode_self_attention(qq, kn, vn, kk, vv, bb, idx)
                ref, k_ref, v_ref = da.decode_self_attention_plain(qq, kn, vn, k2, v2, bb, idx)
                torch.cuda.synchronize()
                check(torch.equal(kk, k_ref) and torch.equal(vv, v_ref),
                      f"decode_self_attention BLIP-2 {dtype} {r} rows idx {idx}: caches differ "
                      f"from plain")
                err = (out.float() - ref.float()).abs().max().item()
                check(within(out, ref, tol), f"decode_self_attention BLIP-2 {dtype} {r} rows "
                                             f"idx {idx}: err {err}")
                worst = max(worst, err)
        errs["self"][str(dtype)] = worst
        worst = 0.0
        for b0, g, lk, live in cross_forms:
            qq, kk, vv, mm = cross_inputs(b0, g, lk, live, dtype)
            check(da.cross_live_ends(mm).tolist() == [live] * b0,
                  f"cross_live_ends at BLIP-2's {b0} x {g} over {lk} keys, {live} live")
            got = da.decode_cross_attention(qq, kk, vv, mm)
            ref = da.decode_cross_attention_plain(qq, kk, vv, mm)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            check(within(got, ref, tol), f"decode_cross_attention BLIP-2 {dtype} {b0} x {g} over "
                                         f"{lk} keys, {live} live: err {err}")
            worst = max(worst, err)
        errs["cross"][str(dtype)] = worst
    say(f"[check] BLIP-2 forms: decode_self_attention {BLIP2_SELF_ROWS} rows x {h} heads over L "
        f"{length}, idx 0/10/19, max_abs_err {errs['self']}, caches bit-identical; "
        f"decode_cross_attention (examples, beams, keys, live) {cross_forms} (the path's "
        f"{path_keys} keys): {errs['cross']}")

    idx = length - 1
    self_forms = []
    for r in BLIP2_SELF_ROWS:
        qq, kn, vn, kk, vv, bb = self_inputs(r, idx, torch.bfloat16)
        where = torch.tensor([idx], device="cuda")

        def self_library():
            kk.index_copy_(2, where, kn)
            vv.index_copy_(2, where, vn)
            return torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=bb,
                                                                    scale=1.0)

        # read: q, k_new, v_new, the idx live cache rows of k and v, the bias
        # row; written: out and the new cache rows (bf16)
        nbytes = 2 * (3 * r * h * d + 2 * r * h * idx * d + h * length + r * h * d
                      + 2 * r * h * d)
        bms, by = bound(nbytes, 4 * r * h * length * d, H100_BF16_FLOPS)
        self_forms.append({
            "rows": r, "heads": h, "length": length, "idx": idx,
            "splits": da.self_splits(r * h, idx + 1, sm_count(0))[0],
            "ms": time_ms_graph(lambda: da.decode_self_attention(qq, kn, vn, kk, vv, bb, idx)),
            "plain_ms": time_ms_graph(lambda: da.decode_self_attention_plain(
                qq, kn, vn, kk, vv, bb, idx)),
            "library_ms": time_ms_graph(self_library), "bound_ms": bms, "bound_by": by})
    cross_out = []
    for b0, g, lk, live in cross_forms:
        qq, kk, vv, mm = cross_inputs(b0, g, lk, live, torch.bfloat16)
        ends = da.cross_live_ends(mm)  # once per decode call, as T5Stack.decode_step
        ke, ve = (t.repeat_interleave(g, dim=0) for t in (kk, vv))
        fmask = ((mm.repeat_interleave(g, dim=0)[:, None, None, :] - 1) * 1e9).to(torch.bfloat16)
        # the live keys' K/V rows, q and out (bf16), the live ends and the
        # live keys' mask entries (int32), each read once
        nbytes = 2 * (2 * b0 * h * live * d + 2 * b0 * g * h * d) + 4 * (b0 * live + b0)
        bms, by = bound(nbytes, 4 * b0 * g * h * live * d, H100_BF16_FLOPS)
        cross_out.append({
            "examples": b0, "beams": g, "heads": h, "keys": lk, "live_keys": live,
            "path": lk == path_keys,
            "ms": time_ms_graph(lambda: da.decode_cross_attention(qq, kk, vv, mm, ends)),
            "plain_ms": time_ms_graph(lambda: da.decode_cross_attention_plain(qq, kk, vv, mm)),
            "library_ms": time_ms_graph(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, ke, ve, attn_mask=fmask, scale=1.0)),
            "bound_ms": bms, "bound_by": by})
    for f in self_forms:
        say(f"[check] decode_self_attention at BLIP-2's {f['rows']} rows: {f['ms']:.4f} ms (plain "
            f"{f['plain_ms']:.4f}, SDPA {f['library_ms']:.4f}, bound {f['bound_ms']:.4f} by "
            f"{f['bound_by']})")
    for f in cross_out:
        say(f"[check] decode_cross_attention at BLIP-2's {f['examples']} x {f['beams']} over "
            f"{f['keys']} keys ({f['live_keys']} live): {f['ms']:.4f} ms (plain "
            f"{f['plain_ms']:.4f}, SDPA {f['library_ms']:.4f}, bound {f['bound_ms']:.4f} by "
            f"{f['bound_by']})")
    torch.cuda.synchronize()
    return ({"blip2_form": self_forms[0], "blip2_forms": self_forms,
             "blip2_max_abs_err": errs["self"]},
            {"blip2_form": cross_out[0], "blip2_forms": cross_out, "blip2_path_keys": path_keys,
             "blip2_max_abs_err": errs["cross"]})


PDVC_LEVELS = (100, 50, 25, 13)  # 100 frames through three stride-2 convs
PDVC_HEADS, PDVC_DHEAD, PDVC_POINTS = 8, 64, 4
PDVC_ENC_LQ, PDVC_DEC_LQ = sum(PDVC_LEVELS), 100  # encoder queries = all 188 positions


def _deformable_inputs(gen, lq: int):
    """value [1, 188, 8, 64], locations in [-0.1, 1.1] (past both borders)
    with point 0 of every level exactly on a pixel centre (k + 0.5) / T_l,
    softmaxed weights over levels x points, and an output gradient, on the
    card in float32."""
    import torch

    levels = len(PDVC_LEVELS)
    value = torch.randn(1, sum(PDVC_LEVELS), PDVC_HEADS, PDVC_DHEAD, generator=gen)
    loc = torch.rand(1, lq, PDVC_HEADS, levels, PDVC_POINTS, generator=gen) * 1.2 - 0.1
    for lid, t in enumerate(PDVC_LEVELS):
        k = torch.randint(0, t, (1, lq, PDVC_HEADS), generator=gen)
        loc[:, :, :, lid, 0] = (k + 0.5) / t
    attn = torch.softmax(torch.randn(1, lq, PDVC_HEADS, levels * PDVC_POINTS, generator=gen),
                         dim=-1).reshape(1, lq, PDVC_HEADS, levels, PDVC_POINTS)
    grad = torch.randn(1, lq, PDVC_HEADS * PDVC_DHEAD, generator=gen)
    return [t.cuda() for t in (value, loc, attn, grad)]


def _grid_sample_fallback(value, loc, attn):
    """The reference's pure-PyTorch fallback (ms_deform_attn_core_pytorch as
    tests/test_deformable_attention.py::torch_oracle builds it): per level a
    pseudo-2D grid_sample(bilinear, border, align_corners=False) of height 1
    and the attention-weighted sum over points."""
    import torch
    import torch.nn.functional as F

    n, _, m, d = value.shape
    lq = loc.shape[1]
    out = 0
    for lid, (v, t_l) in enumerate(zip(value.split(PDVC_LEVELS, dim=1), PDVC_LEVELS)):
        vl = v.flatten(2).transpose(1, 2).reshape(n * m, d, 1, t_l)
        gx = 2 * loc[:, :, :, lid] - 1
        grid = torch.stack([gx, torch.zeros_like(gx)], -1).permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampled = F.grid_sample(vl, grid, mode="bilinear", padding_mode="border",
                                align_corners=False)  # [N*M, D, Lq, P]
        a = attn[:, :, :, lid].permute(0, 2, 1, 3).flatten(0, 1)
        out = out + (sampled * a[:, None]).sum(-1).reshape(n, m, d, lq).permute(0, 3, 1, 2)
    return out.reshape(n, lq, m * d)


def check_deformable_attention(gen):
    """The deformable attention forward and backward kernels against their
    plain versions at PDVC's shapes: the encoder's 188 queries and the
    decoder's 100 over value [1, 188, 8, 64], 4 levels x 4 points, float32.
    Forward within 1e-5; dloc and dattn within 1e-4 of their largest
    element; dvalue within 1e-5 of its norm, and bit-identical on a second
    launch (the cluster route sums it in shared memory, in a fixed order).
    Each part timed at both query counts by CUDA-graph replay (the row's
    ``ms`` at the encoder's 188, ``lq100`` at the decoder's); the yardstick
    is the reference's grid_sample fallback (no single PyTorch call computes
    this function), forward and, through autograd, backward."""
    import torch

    from vidchapters_tpu_torch.ops import deformable_attention as da

    shapes = PDVC_LEVELS
    errs = {"fwd": 0.0, "dvalue": 0.0, "dloc": 0.0, "dattn": 0.0, "bwd_max_abs": 0.0}
    inputs = {}
    for lq in (PDVC_ENC_LQ, PDVC_DEC_LQ):
        value, loc, attn, grad = inputs[lq] = _deformable_inputs(gen, lq)
        out = da.deformable_attention_1d(value, shapes, loc, attn)
        ref = da.deformable_attention_1d_plain(value, shapes, loc, attn)
        got = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
        again = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
        want = da.deformable_attention_1d_bwd_plain(value, shapes, loc, attn, grad)
        torch.cuda.synchronize()
        err = {"fwd": (out - ref).abs().max().item(),
               "dvalue": ((got[0] - want[0]).norm() / want[0].norm()).item(),
               "dloc": ((got[1] - want[1]).abs().max() / want[1].abs().max()).item(),
               "dattn": ((got[2] - want[2]).abs().max() / want[2].abs().max()).item(),
               "bwd_max_abs": max((a - b).abs().max().item() for a, b in zip(got, want))}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        say(f"[check] deformable_attention Lq {lq} over value [1,188,8,64] f32: fwd max_abs_err "
            f"{err['fwd']:.3e} (tol 1e-5); dvalue {err['dvalue']:.3e} of its norm (tol 1e-5), "
            f"dloc {err['dloc']:.3e} and dattn {err['dattn']:.3e} of their max (tol 1e-4); "
            f"a second backward bit-identical: {same}")
        check(err["fwd"] <= 1e-5, f"deformable forward Lq {lq}: err {err['fwd']}")
        check(err["dvalue"] <= 1e-5, f"deformable dvalue Lq {lq}: {err['dvalue']}")
        check(err["dloc"] <= 1e-4 and err["dattn"] <= 1e-4,
              f"deformable dloc / dattn Lq {lq}: {err['dloc']} / {err['dattn']}")
        check(same, f"deformable backward Lq {lq}: two launches differ")
        errs = {k: max(v, err[k]) for k, v in errs.items()}
    value, loc, attn, _ = inputs[PDVC_ENC_LQ]
    lib_out = _grid_sample_fallback(value, loc, attn)
    check((lib_out - da.deformable_attention_1d_plain(value, shapes, loc, attn)).abs().max()
          .item() <= 1e-4, "the grid_sample fallback does not compute the same function")

    def times(lq):
        """{part: (ms, plain ms, library ms, bound ms, bound by, eager ms)} at Lq."""
        value, loc, attn, grad = inputs[lq]
        leaves = [t.detach().requires_grad_(True) for t in (value, loc, attn)]

        def library_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(_grid_sample_fallback(*leaves), leaves, grad)

        timed = {
            "fwd": (lambda: da.deformable_attention_1d(value, shapes, loc, attn),
                    lambda: da.deformable_attention_1d_plain(value, shapes, loc, attn),
                    lambda: _grid_sample_fallback(value, loc, attn)),
            "bwd": (lambda: da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad),
                    lambda: da.deformable_attention_1d_bwd_plain(value, shapes, loc, attn, grad),
                    library_bwd)}
        # bytes: each input read once, each output written once (fp32); operations:
        # 2 multiplies and 2 adds per channel and sample forward, 4 more backward
        # (two dot products) and 4 for the two dvalue updates
        m, d = PDVC_HEADS, PDVC_DHEAD
        samples = lq * m * len(shapes) * PDVC_POINTS
        v_bytes, s_bytes, o_bytes = 4 * sum(shapes) * m * d, 4 * samples, 4 * lq * m * d
        work = {"fwd": (v_bytes + 2 * s_bytes + o_bytes, 4 * samples * d),
                "bwd": (2 * v_bytes + 4 * s_bytes + o_bytes, 12 * samples * d)}
        res = {}
        for part, (kernel, plain, library) in timed.items():
            bms, by = bound(*work[part], H100_FP32_FLOPS)
            res[part] = {"ms": time_ms_graph(kernel), "plain_ms": time_ms_graph(plain),
                         "library_ms": time_ms_graph(library), "bound_ms": bms, "bound_by": by,
                         "eager_ms": {"kernel": time_ms(kernel, 50), "plain": time_ms(plain, 20),
                                      "library": time_ms(library, 20)}}
        return res

    by_lq = {lq: times(lq) for lq in (PDVC_ENC_LQ, PDVC_DEC_LQ)}
    rows = []
    for part in ("fwd", "bwd"):
        enc, dec = by_lq[PDVC_ENC_LQ][part], by_lq[PDVC_DEC_LQ][part]
        rows.append({
            "name": f"deformable_attention_{part}", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/deformable_attention.cu",
            "replaces": ("vidchapters_tpu/ops/deformable_attention.py:217" if part == "fwd" else
                         "vidchapters_tpu/ops/deformable_attention.py:266 (custom VJP of :217)"),
            "max_abs_err": errs["fwd"] if part == "fwd" else errs["bwd_max_abs"],
            "errors": errs, **{k: enc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "eager_ms")},
            f"lq{PDVC_DEC_LQ}": dec, "timing": TIMING_GRAPH,
            "library": "reference fallback, 5+ calls: 4 x grid_sample(bilinear, border) + "
                       "weighted sum" + (" (forward + autograd backward)" if part == "bwd" else ""),
            "shape": f"value [1,188,8,64], loc/attn [1,{PDVC_ENC_LQ},8,4,4] f32 (lq{PDVC_DEC_LQ}: "
                     f"[1,{PDVC_DEC_LQ},8,4,4]), levels {shapes}"})
        say(f"[time] deformable_attention_{part}: Lq {PDVC_ENC_LQ} {enc['ms']:.6f} ms, Lq "
            f"{PDVC_DEC_LQ} {dec['ms']:.6f} ms (bounds {enc['bound_ms']:.6f}, "
            f"{dec['bound_ms']:.6f})")
    torch.cuda.synchronize()
    return rows


WHISPER_N, WHISPER_D, WHISPER_H, WHISPER_DFF = 32, 1280, 20, 5120  # large-v2's decoder
WHISPER_L, WHISPER_LENC = 224, 1500  # max_decode_len 224; 30 s of audio at 50 frames/s


# the Whisper kernel's limit against its plain version, a share of the plain
# version's largest hidden element (here and in the card tests)
WHISPER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _whisper_step_inputs(gen, b0: int, group: int, dtype, quant: bool, n: int = WHISPER_N,
                         d: int = WHISPER_D, dff: int = WHISPER_DFF, length: int = WHISPER_L,
                         lenc: int = WHISPER_LENC, device: str = "cuda"):
    """Seeded inputs of one Whisper decode step on ``device`` (by default the
    card, at large-v2 width): stacked weights ([N, out, in], LeCun-scaled),
    caches and the cross K/V (int8 with its per-lane scales when ``quant``,
    padded as ``make_whisper_mega_fns`` pads it: 1500 -> 1504 rows), a beam
    permutation within each example. ``gen`` lies on ``device``."""
    import torch

    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    rows, lencp = b0 * group, wm._round_up(lenc, 32 if quant else 16)
    rnd = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=device) * std  # noqa: E731
    shapes = {"wqkv": (3 * d, d), "wo_self": (d, d), "wq_cross": (d, d), "wo_cross": (d, d),
              "wi": (dff, d), "wo_ff": (d, dff)}
    biases = dict(zip(shapes, ("bqkv", "bo_self", "bq_cross", "bo_cross", "bi", "bo_ff")))
    st = {"ln_scale": 1.0 + rnd(n, 3, d, std=0.1), "ln_bias": rnd(n, 3, d, std=0.1)}
    for name, (o, i) in shapes.items():
        st[name] = rnd(n, o, i, std=i ** -0.5).to(dtype)
        st[biases[name]] = rnd(n, 1, o, std=0.02)
    st["bqkv"][:, :, d:2 * d] = 0.0  # the bias-free k projection
    x = rnd(rows, d).to(dtype)
    kc, vc = (rnd(rows, n, length, d).to(dtype) for _ in range(2))
    cross = []
    for _ in range(2):
        a = torch.zeros(b0, n, lencp, d, device=device)
        a[:, :, :lenc] = rnd(b0, n, lenc, d)
        cross.append(wm._quantize_lanes(a.to(dtype)) if quant else (a.to(dtype), None))
    src = torch.tensor([(r // group) * group + (r * 3 + 1) % group for r in range(rows)],
                       dtype=torch.int32, device=device) if group > 1 else None
    return st, x, kc, vc, cross, src


def _whisper_step_bound(rows: int, b0: int, idx: int, quant: bool, beam: bool):
    """(ms, by) of one large-v2 decode step: every weight read once, the
    cross K/V's 1500 live rows (+ scales), the live self-cache rows read and
    the rows written (beam: the permuted rows < idx too), x, hidden, k/v new."""
    n, d, dff, lenc = WHISPER_N, WHISPER_D, WHISPER_DFF, WHISPER_LENC
    params = n * (3 * d * d + 3 * d * d + 2 * d * dff)
    nbytes = (params * 2 + n * 4 * (6 * d + 3 * d + d + d + dff + d)   # weights, LN, biases
              + 2 * b0 * n * lenc * d * (1 if quant else 2)           # cross K/V
              + (2 * b0 * n * d * 4 if quant else 0)                  # scales
              + 2 * rows * n * idx * d * 2                            # self rows read
              + 2 * rows * n * ((idx + 1) if beam else 1) * d * 2     # self rows written
              + rows * d * 2 * 2 + 2 * rows * n * d * 2)              # x, hidden, k/v new
    flops = 2 * rows * params + 4 * rows * n * d * (idx + 1 + lenc)
    return bound(nbytes, flops, H100_BF16_FLOPS)


WHISPER_PHASES = ("set-up", "qkv", "self-attention", "self out", "cross q", "cross scores",
                  "cross p.v", "cross out", "fc1", "fc2")


def _whisper_phases(call):
    """ms of each phase of one kernel step, summed over the layers, from the
    kernel's own timeline (%globaltimer after each grid barrier; the median
    of 5 calls)."""
    import statistics

    import torch

    from vidchapters_tpu_torch.ops.whisper_megakernel import PHASES

    runs = []
    for _ in range(5):
        tl = torch.zeros(PHASES * WHISPER_N + 2, dtype=torch.int64, device="cuda")
        call(tl)
        torch.cuda.synchronize()
        t = tl.cpu().tolist()
        per = [(t[1] - t[0]) / 1e6] + [0.0] * PHASES
        for i in range(2, len(t)):
            per[1 + (i - 2) % PHASES] += (t[i] - t[i - 1]) / 1e6
        runs.append(per)
    return {name: statistics.median(r[i] for r in runs) for i, name in enumerate(WHISPER_PHASES)}


def _whisper_phase_bytes(rows: int, b0: int, idx: int, quant: bool, beam: bool):
    """Bytes each phase of a large-v2 step must move, summed over the layers
    (bf16 weights and K/V, int8 cross K/V when ``quant``): the products'
    weights, the self-attention's live cache rows (read, and the beam's copy
    written), the cross K and V rows."""
    n, d, dff, lenc = WHISPER_N, WHISPER_D, WHISPER_DFF, WHISPER_LENC
    kv = 1 if quant else 2
    self_rows = 2 * rows * idx * d * 2 * (2 if beam else 1)
    return {"qkv": n * 3 * d * d * 2, "self-attention": n * self_rows,
            "self out": n * d * d * 2, "cross q": n * d * d * 2,
            "cross scores": n * b0 * lenc * d * kv, "cross p.v": n * b0 * lenc * d * kv,
            "cross out": n * d * d * 2, "fc1": n * d * dff * 2, "fc2": n * d * dff * 2}


def _whisper_barrier_us(reps: int = 5) -> float:
    """One grid barrier of the Whisper kernel's grid alone, in us: a launch
    of a step's barriers (9 N + 1) and nothing else, by its own timeline;
    the median of ``reps`` launches."""
    import statistics

    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    n = wm.PHASES * WHISPER_N + 1
    per = []
    for _ in range(reps):
        t = wm.barrier_step(n).cpu().tolist()
        per.append((t[-1] - t[0]) / n / 1e3)
    return statistics.median(per)


def check_whisper_tensor_cores():
    """The bf16 Whisper kernel runs its products on the tensor cores: the
    SASS of both bf16 instantiations (int8 and bf16 cross K/V) holds HMMA /
    HGMMA instructions, counted per function. Fails without cuobjdump."""
    counts = _hmma_counts("whisper_megakernel", "whisper_mega_kernel")
    bf16 = {fn: c for fn, c in counts.items() if "whisper_mega_kernelI13__nv_bfloat16" in fn}
    say(f"[check] whisper tensor cores: HMMA/HGMMA per instantiation "
        + ", ".join(f"{fn[:70]} {c}" for fn, c in sorted(counts.items())))
    check(len(bf16) == 2 and all(c > 0 for c in bf16.values()),
          f"the two bf16 Whisper kernels must hold HMMA: {counts}")
    return counts


def check_whisper_megakernel(gen):
    """The Whisper decode kernel against its plain version at large-v2 width
    (32 layers, d 1280, 20 heads, d_ff 5120, L 224, 1500 encoder frames),
    fp32 and bf16, cross K/V int8 and unquantized: the greedy form at 8 rows
    and the beam forms at 2 and 8 examples x 5 beams (10 and 40 rows, the
    second ``transcribe_batch``'s beam rung at batch 8) with a permutation,
    each at cache indices 0, 100 and 223. hidden and k/v new within
    ``WHISPER_TOL`` of the plain version's largest hidden element, the
    copied cache rows bit for bit, row idx the new k/v. Timed by CUDA-graph
    replay at the sweep's shape (greedy, 8 rows, int8, bf16) and both beam
    forms, at idx 111 (the middle of a 223-step decode)."""
    import torch

    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    heads, lenc = WHISPER_H, WHISPER_LENC
    forms = ((8, 1), (2, 5), (8, 5))
    errs, identical = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = WHISPER_TOL[str(dtype).split(".")[-1]]
        for quant in (True, False):
            for b0, group in forms:
                st, x, kc, vc, cross, src = _whisper_step_inputs(gen, b0, group, dtype, quant)
                (kx, ks), (vx, vs) = cross
                worst = 0.0
                for idx in (0, 100, WHISPER_L - 1):
                    k_in, v_in = kc.clone(), vc.clone()
                    got = wm.whisper_mega_step(st, x, k_in, v_in, kx, vx, idx, heads, lenc, ks, vs,
                                               group, src)
                    k_ref, v_ref = kc.clone(), vc.clone()
                    ref = wm.whisper_mega_step_plain(st, x, k_ref, v_ref, kx, vx, idx, heads,
                                                     lenc, ks, vs, group, src)
                    torch.cuda.synchronize()
                    top = ref[0].float().abs().max().item()
                    err = max((a.float() - r.float()).abs().max().item()
                              for a, r in zip(got[:3], ref[:3]))
                    check(all(torch.isfinite(a.float()).all().item() for a in got[:3]),
                          f"whisper kernel {dtype} quant={quant} g={group} idx={idx}: not finite")
                    check(err <= tol * top, f"whisper kernel {dtype} quant={quant} {b0}x{group} "
                                            f"idx={idx}: err {err} > {tol} x {top}")
                    caches = (k_in, v_in) if src is None else got[3:]
                    for c_got, new in ((caches[0], got[1]), (caches[1], got[2])):
                        check(torch.equal(c_got[:, :, idx], new),
                              f"whisper kernel {dtype} g={group} idx={idx}: row idx != new k/v")
                    if src is not None:
                        for c_got, c_ref in ((got[3], ref[3]), (got[4], ref[4])):
                            check(torch.equal(c_got[:, :, :idx], c_ref[:, :, :idx]),
                                  f"whisper kernel {dtype} idx={idx}: permuted rows differ")
                    worst = max(worst, err / top)
                    if dtype == torch.bfloat16 and b0 * group == 40 and idx == 100:
                        # sums in a fixed order: a second call gives the same bits
                        again = wm.whisper_mega_step(st, x, kc.clone(), vc.clone(), kx, vx, idx,
                                                     heads, lenc, ks, vs, group, src)
                        check(all(torch.equal(p, q) for p, q in zip(again[:3], got[:3])) and
                              all(torch.equal(p[:, :, :idx + 1], q[:, :, :idx + 1])
                                  for p, q in zip(again[3:], got[3:])),
                              f"whisper kernel bf16 quant={quant} 8x5: two calls differ")
                        identical["int8" if quant else "plain"] = True
                errs[(str(dtype).split(".")[-1], "int8" if quant else "plain", f"{b0}x{group}")] = worst
                say(f"[check] whisper kernel {dtype} cross {'int8' if quant else 'unquantized'} "
                    f"{b0}x{group} idx 0/100/223: max err {worst:.3e} of the largest hidden "
                    f"element (limit {tol}); copied cache rows and new rows exact")
                del st, x, kc, vc, cross
                torch.cuda.empty_cache()
    times = {}
    idx = 111
    for b0, group in forms:
        st, x, kc, vc, cross, src = _whisper_step_inputs(gen, b0, group, torch.bfloat16, True)
        (kx, ks), (vx, vs) = cross
        outs = (torch.empty_like(kc), torch.empty_like(vc)) if src is not None else None
        kernel = lambda: wm.whisper_mega_step(st, x, kc, vc, kx, vx, idx, heads, lenc, ks,  # noqa: E731
                                              vs, group, src, outs)
        plain = lambda: wm.whisper_mega_step_plain(st, x, kc, vc, kx, vx, idx, heads, lenc,  # noqa: E731
                                                   ks, vs, group, src, outs)
        t = {"ms": time_ms_graph(kernel, 10, 3), "eager_ms": time_ms(kernel, 10),
             "plain_ms": time_ms_graph(plain, 3, 2)}
        t["bound_ms"], t["bound_by"] = _whisper_step_bound(b0 * group, b0, idx, True, group > 1)
        t["phases_ms"] = _whisper_phases(
            lambda tl: wm.whisper_mega_step(st, x, kc, vc, kx, vx, idx, heads, lenc, ks, vs, group,
                                            src, outs, timeline=tl))
        nbytes = _whisper_phase_bytes(b0 * group, b0, idx, True, group > 1)
        t["phase_tb_s"] = {k: v / (t["phases_ms"][k] * 1e-3) / 1e12 for k, v in nbytes.items()}
        times[f"{b0}x{group}"] = t
        say(f"[time] whisper kernel {b0}x{group} bf16 int8 idx {idx}: {t}")
        del st, x, kc, vc, cross, outs
        torch.cuda.empty_cache()
    barrier_us = _whisper_barrier_us()
    say(f"[time] whisper kernel grid barrier alone: {barrier_us:.3f} us "
        f"({WHISPER_N * 9 + 1} a step: {barrier_us * (WHISPER_N * 9 + 1) / 1e3:.4f} ms)")
    hmma = check_whisper_tensor_cores()
    g1 = times["8x1"]
    return {"name": "whisper_megakernel", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/whisper_megakernel.cu",
            "replaces": "vidchapters_tpu/ops/whisper_megakernel.py:463",
            "max_abs_err": max(v for k, v in errs.items() if k[0] == "bfloat16"),
            "max_abs_err_fp32": max(v for k, v in errs.items() if k[0] == "float32"),
            "errors": {"/".join(map(str, k)): v for k, v in errs.items()},
            "error_unit": "max abs error / largest element of the plain version's hidden",
            "ms": g1["ms"], "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
            "bound_by": g1["bound_by"], "library_ms": None, "library": "none (no single call)",
            "eager_ms": g1["eager_ms"], "beam_2x5": times["2x5"], "beam_8x5": times["8x5"],
            "tolerance": WHISPER_TOL,
            "bit_identical_8x5_bf16": identical,
            "barrier_us": barrier_us, "hmma_per_kernel": hmma,
            "ptxas": _ptxas_lines("whisper_megakernel"),
            "timing": TIMING_GRAPH,
            "shape": "large-v2 decoder, 8 rows, L 224, 1500 frames int8, idx 111, bf16"}


def check_probes():
    """The seven feature probes (csrc/probes.cu) against their known answers
    and their plain versions, exactly, and p2 and p3 on seeded random inputs
    within 1e-5 of their plain versions' largest output; each timed by CUDA-graph
    replay. The grid-cell probe's time per cell of its (12 x 8) grid is
    run_probes'."""
    import torch

    from vidchapters_tpu_torch.ops import probes as pb

    library = {"reshape_split_minor": lambda x: torch.mul(x, 2.0),
               "dot_general_2batch": lambda q, c: torch.matmul(q, c.transpose(-1, -2)),
               "dot_general_1batch_3d": torch.bmm,
               "blockspec_5d_bf16": lambda c: torch.sum(c[-1], dim=(1, 2), dtype=torch.float32),
               "lane_slice_64": lambda x: x[:, 64:128].contiguous(),
               "grid_cell_overhead": lambda x, w: torch.matmul(
                   x.view(12, 64, 768), w).view(96, 8, 768)}
    results = pb.run_probes()
    bad = {name: r for name, r in results.items() if not r["ok"] or r["plain_max_abs_err"]}
    check(not bad, f"probes differ from their known answers or plain versions: {bad}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, c = (torch.randn(8, 12, m, 64, generator=gen, device="cuda") for m in (1, 32))
    ref = pb.dot_2batch_plain(q, c)
    p2_rel = ((pb.dot_2batch(q, c) - ref).abs().max() / ref.abs().max()).item()
    check(p2_rel <= 1e-5, f"probe p2 on random inputs: {p2_rel:.3e} of the largest output")
    a3, b3 = torch.randn(12, 8, 64, generator=gen, device="cuda"), torch.randn(
        12, 64, 32, generator=gen, device="cuda")
    ref = pb.dot_1batch_plain(a3, b3)
    p3_rel = ((pb.dot_1batch(a3, b3) - ref).abs().max() / ref.abs().max()).item()
    check(p3_rel <= 1e-5, f"probe p3 on random inputs: {p3_rel:.3e} of the largest output")
    rows = []
    for pr in pb.PROBES:
        xs = pr.inputs(torch.device("cuda"))
        got = pr.fn(*xs)
        nbytes = sum(x.numel() * x.element_size() for x in xs) + got.numel() * got.element_size()
        flops = {"dot_general_2batch": 2 * 8 * 12 * 32 * 64, "dot_general_1batch_3d": 2 * 12 * 8 * 32 * 64,
                 "grid_cell_overhead": 2 * 96 * 8 * 768 * 768}.get(pr.name, got.numel())
        bms, by = bound(nbytes, flops, H100_FP32_FLOPS)
        lib = library.get(pr.name)
        row = {"name": f"probe_{pr.name}", "route": "cuda",
               "source": "vidchapters_tpu_torch/csrc/probes.cu", "replaces": pr.replaces,
               "max_abs_err": results[pr.name]["max_abs_err"],
               "ms": time_ms_graph(lambda: pr.fn(*xs)),
               "plain_ms": time_ms_graph(lambda: pr.plain(*xs)), "bound_ms": bms, "bound_by": by,
               "library_ms": None if lib is None else time_ms_graph(lambda: lib(*xs)),
               "timing": TIMING_GRAPH}
        if pr.name == "grid_cell_overhead":
            row["us_per_cell"] = results[pr.name]["us_per_cell"]
        if pr.name == "dot_general_2batch":
            row["random_rel_err"] = p2_rel
        if pr.name == "dot_general_1batch_3d":
            row["random_rel_err"] = p3_rel
        rows.append(row)
    say("[check] probes p1-p7: every output equals its known answer and its plain version "
        f"(p5: 12 x 32 per row); p2 and p3 on random inputs {p2_rel:.3e} and {p3_rel:.3e} of "
        f"the largest output; "
        f"p7 {rows[-1]['us_per_cell']:.3f} us per cell")
    return rows


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5            # timed steps, after one warm-up step
FUSED_PER_STEP = 48        # 12 layers x (encoder self + decoder cross) x 2 passes


def _write_train_dataset(root: Path, n_videos: int, seed: int = 0, n_val: int = 0) -> Path:
    """Features (.npy per video, 80-240 frames of 768), an annotation json
    of 8 chapters per video (enough to fill 256 output tokens) and an ASR
    pickle of 40 segments per video (enough to fill 1000 input tokens):
    ``ann.json`` holds the first ``n_videos``, ``val.json`` the ``n_val``
    after them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "features").mkdir()
    ann, val, asr = {}, {}, {}
    for i in range(n_videos + n_val):
        vid = f"vid{i:08d}"
        np.save(root / "features" / f"{vid}.npy",
                rng.standard_normal((int(rng.integers(80, 240)), 768)).astype(np.float32))
        starts = np.linspace(0.0, 540.0, 8)
        (ann if i < n_videos else val)[vid] = {"duration": 600.0,
                    "timestamps": [[float(s), float(s) + 60.0] for s in starts],
                    "sentences": [f"chapter {j} of video {i}: we knead the dough, fold it "
                                  f"twice and let it rest" for j in range(8)]}
        st = np.linspace(0.0, 590.0, 40)
        asr[vid] = {"text": [f"in step {j} of video {i} we whisk eggs and fold in flour"
                             for j in range(40)],
                    "start": st.tolist(), "end": (st + 5.0).tolist()}
    (root / "ann.json").write_text(json.dumps(ann))
    (root / "val.json").write_text(json.dumps(val))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root


def _device_ms_by_kernel(prof):
    """Device time (ms) by kernel name in a finished ``torch.profiler`` run:
    device-side events only (operators and autograd nodes report their
    kernels' time as their own)."""
    import torch

    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    return kernels


def _profile_step(step, state, batch, step_ms: float):
    """One train step under torch.profiler: device time by kernel name,
    grouped, and the device's idle share of an unprofiled step (``step_ms``;
    the profiler's own overhead stretches the profiled step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(state, batch, 0)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = _device_ms_by_kernel(prof)
    groups = {"fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0, "matmul (cuBLAS)": 0.0,
              "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "fused_attention_fwd" in low:
            groups["fused_attention_fwd"] += ms
        elif any(w in low for w in FUSED_BWD_NAMES):
            groups["fused_attention_bwd"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
            groups["matmul (cuBLAS)"] += ms
        elif "elementwise" in low:
            groups["elementwise"] += ms
        elif "reduce" in low or "softmax" in low:
            groups["reduce"] += ms
        else:
            groups["other"] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    fused = {n[:120]: t for n, t in kernels.items()
             if "fused_attention" in n.lower() or any(w in n.lower() for w in FUSED_BWD_NAMES)}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / step_ms) if busy else None,
            "by_group_ms": groups, "fused_attention_kernels_ms": fused,
            "top_kernels_ms": [[n[:90], t] for n, t in top]}


# the backward's kernels by name: the bf16 route's fused_attention_bwd_* and
# the fp32 route's, with delta_kernel shared
FUSED_BWD_NAMES = ("fused_attention_bwd", "dkdv_kernel", "dq_kernel", "delta_kernel")


def _rel_bias_grad_ms(length: int = 1024):
    """Forward + backward of the relative-position bias table lookup at the
    encoder's length, as a gather (the port) and as the JAX package's
    one-hot product: the gather's backward is a scatter-add of L^2 rows of
    12 into a [32, 12] table."""
    import torch

    from vidchapters_tpu_torch.models.t5 import relative_position_bucket

    emb = torch.randn(32, 12, device="cuda", requires_grad=True)
    pos = torch.arange(length, device="cuda")
    buckets = relative_position_bucket(pos[None] - pos[:, None], True, 32, 128).long()
    g = torch.randn(length, length, 12, device="cuda")
    gather = time_ms(lambda: torch.autograd.grad(emb[buckets], emb, g))
    onehot = time_ms(lambda: torch.autograd.grad(
        (buckets[..., None] == torch.arange(32, device="cuda")).float() @ emb, emb, g))
    return {"gather_ms": gather, "onehot_ms": onehot, "length": length}


def phase_train(card: str):
    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import ExperimentConfig
    from vidchapters_tpu_torch.data.dvc_dataset import (
        DenseVideoCaptioningDataset,
        EpochIterator,
        denoise_length_bounds,
    )
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import fused_attention as fa
    from vidchapters_tpu_torch.train.dvc_train import (
        TrainState,
        batch_to_device,
        make_train_step,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    cfg = ExperimentConfig()  # T5-base + ViT-12, dropout 0.1, bs 8 / 1000 / 256
    bs, n_batches = 8, 1 + TRAIN_STEPS + 1
    tok = build_tokenizer("", num_bins=cfg.model.num_bins)
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_train_dataset(Path(tmp), n_videos=2 * bs)
        ds = DenseVideoCaptioningDataset(str(root / "ann.json"), str(root / "features"), tok,
                                         cfg.data, subtitles_path=str(root / "asr.pkl"))
        it = EpochIterator(ds, bs, cfg.data, seed=0)
        t0 = time.time()
        host_batches = []
        for epoch in range(n_batches):
            it.set_epoch(epoch)
            host_batches.extend(it)
        host_batches = host_batches[:n_batches]
        collate_ms = (time.time() - t0) * 1e3 / len(host_batches)
    den_in, den_out = denoise_length_bounds(cfg.data.max_input_tokens)
    shapes = {k: tuple(host_batches[0][k].shape) for k in
              ("video", "input_tokens", "output_tokens", "denoising_input_tokens",
               "denoising_output_tokens")}
    want = {"video": (bs, 100, cfg.data.features_dim), "input_tokens": (bs, 1000), "output_tokens": (bs, 256),
            "denoising_input_tokens": (bs, den_in), "denoising_output_tokens": (bs, den_out)}
    check(shapes == want, f"batch shapes {shapes} != {want}")
    check(all(int((b["input_tokens"] != 0).sum(1).min()) == 1000 for b in host_batches),
          "the ASR does not fill 1000 input tokens")
    say(f"[train] batches of {bs} from EpochIterator: {shapes} "
        f"(collate {collate_ms:.1f} ms/batch on the host)")

    model = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
    opt = build_optimizer(cfg.train.optim, 100, model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, cfg.train.generative, cfg.train.denoising)
    batches = [batch_to_device(b, DEVICE) for b in host_batches]
    t0 = time.time()
    m = step(state, batches[0], 0)  # warm-up: lr(0) = 0
    torch.cuda.synchronize()
    say(f"[train] warm-up step {time.time() - t0:.2f} s, total_loss {float(m['total_loss']):.4f}")
    before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    emb = model.t5.shared.weight
    metrics, norms = [], []
    for kern in (fa.KERNEL, fa.BWD_KERNEL):
        kern.launches = 0
    t0 = time.time()
    for i in range(TRAIN_STEPS):
        metrics.append(step(state, batches[1 + i], 0))
        with torch.no_grad():
            rows = emb.float().norm(dim=1)
            norms.append(torch.stack([rows[-cfg.model.num_bins:].mean(),
                                      rows[:-cfg.model.num_bins].mean()]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"fused_attention_fwd": fa.KERNEL.launches,
                "fused_attention_bwd": fa.BWD_KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [{k: float(v) for k, v in mm.items()} for mm in metrics]
    for i, mm in enumerate(losses):
        check(all(np.isfinite(v) for v in mm.values()), f"step {i}: non-finite {mm}")
    for i, nn_ in enumerate(norms):
        t_norm, x_norm = (float(x) for x in nn_)
        check(abs(t_norm - x_norm) <= 1e-5 * x_norm,
              f"step {i}: time-token rows' mean norm {t_norm} != text rows' {x_norm}")
    unchanged = [n for n, p in model.named_parameters() if torch.equal(p.detach().cpu(),
                                                                       before[n])]
    check(not unchanged, f"parameters unchanged by {TRAIN_STEPS} steps: {unchanged[:5]}")
    for name, count in launches.items():
        check(count == FUSED_PER_STEP * TRAIN_STEPS,
              f"{name}: {count} launches in {TRAIN_STEPS} steps, expected "
              f"{FUSED_PER_STEP} per step")
    train = {"steps": TRAIN_STEPS, "batch": bs, "step_ms": wall * 1e3 / TRAIN_STEPS,
             "videos_per_s": bs * TRAIN_STEPS / wall, "wall_s": wall,
             "peak_memory_bytes": peak, "launches": launches, "losses": losses,
             "collate_ms_per_batch": collate_ms, "card": card}
    say(f"[train] {json.dumps({k: v for k, v in train.items() if k != 'losses'})}")
    say(f"[train] losses {[round(mm['total_loss'], 4) for mm in losses]}, "
        f"grad_norm {[round(mm['grad_norm'], 3) for mm in losses]}")
    train["profile"] = _profile_step(step, state, batches[-1], train["step_ms"])
    say(f"[train] profiled step: {json.dumps({k: v for k, v in train['profile'].items() if k != 'top_kernels_ms'})}")
    for name, ms in train["profile"]["top_kernels_ms"]:
        say(f"[train]   {ms:9.3f} ms  {name}")
    train["rel_bias_grad"] = _rel_bias_grad_ms()
    say(f"[train] relative-position bias fwd+bwd at L=1024: {train['rel_bias_grad']}")
    del model, state, opt, batches, step, emb
    torch.cuda.empty_cache()
    train["fp32_grad_check"] = fp32_grad_check(cfg, host_batches[0])
    return train, launches


def fp32_grad_check(cfg, host_batch):
    """One step of make_train_step in fp32 at dropout 0, full width and 2+2
    layers (ViT depth 2), on the first 2 examples of a recipe batch: the
    kernels on the card against the plain versions on the CPU, from the same
    weights. The loss must agree to 1e-4 and every parameter's gradient to
    1e-3 of its norm (sums run in other orders, and a ReLU pre-activation
    within rounding of 0 can take the other branch)."""
    import torch

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import fused_attention as fa
    from vidchapters_tpu_torch.train.dvc_train import (
        BATCH_FIELDS,
        TrainState,
        batch_to_device,
        make_train_step,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    t5 = dataclasses.replace(cfg.model.t5, dtype="float32", num_layers=2, num_decoder_layers=2,
                             dropout_rate=0.0, encoder_dropout=0.0, decoder_dropout=0.0)
    vit = dataclasses.replace(cfg.model.vit, dtype="float32", depth=2)
    mcfg = dataclasses.replace(cfg.model, t5=t5, vit=vit)
    weights = Vid2Seq(mcfg).init_weights(torch.Generator().manual_seed(1)).state_dict()
    sub = {k: host_batch[k][:2] for k in BATCH_FIELDS}
    out = {}
    for path, dev in (("kernels", DEVICE), ("plain", "cpu")):
        model = Vid2Seq(mcfg)
        model.load_state_dict(weights)
        model.to(dev)
        state = TrainState(model, build_optimizer(cfg.train.optim, 100, model.parameters()))
        fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
        t0 = time.time()
        m = make_train_step(model)(state, batch_to_device(sub, dev), 0)
        loss = float(m["total_loss"])
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        out[path] = (loss, grads, fa.KERNEL.launches - fwd0, fa.BWD_KERNEL.launches - bwd0)
        say(f"[fp32-grad] {path} on {dev}: {time.time() - t0:.1f} s, total_loss {loss:.6f}")
    loss_k, g_k, fwd_n, bwd_n = out["kernels"]
    loss_p, g_p, _, _ = out["plain"]
    check(fwd_n == 8 and bwd_n == 8, f"fp32 check launched {fwd_n} / {bwd_n} fused "
                                     f"fwd / bwd kernels, expected 8 each (2+2 layers)")
    rel = {n: float((g_k[n] - g_p[n]).norm() / max(float(g_p[n].norm()), 1e-30)) for n in g_p}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    say(f"[fp32-grad] loss rel diff {loss_rel:.2e} (tol 1e-4); {len(rel)} gradients, worst "
        f"{worst} at {rel[worst]:.2e} of its norm (tol 1e-3)")
    check(loss_rel <= 1e-4, f"fp32 loss kernels {loss_k} vs plain {loss_p}")
    check(rel[worst] <= 1e-3, f"fp32 gradient {worst}: {rel[worst]:.2e} of its norm")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": loss_rel,
            "n_gradients": len(rel), "worst_gradient": worst, "worst_rel_err": rel[worst],
            "depth": "T5 2+2 layers, ViT 2, full width, 2 examples"}


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def _request(i: int, long: bool, rng):
    if long:  # ~1200 ASR characters: the byte tokenizer fills the 1000 bucket
        lines = [f"in step {j} of video {i} we whisk eggs, fold in flour and rest the dough"
                 for j in range(16)]
    else:
        lines = [f"short clip {i}"]
    duration = 300.0
    starts = [duration * j / (len(lines) + 1) for j in range(len(lines))]
    return {"features": rng.standard_normal((120, 768)).round(3).tolist(),
            "duration": duration,
            "asr": {"text": lines, "start": starts, "end": [s + 5.0 for s in starts]}}


def _post(port: int, payload: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chapters",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=900) as resp:
        return resp.status, json.loads(resp.read())


def phase_end_to_end(card: str):
    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import ExperimentConfig
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import decode_megakernel, decoding, fused_attention
    from vidchapters_tpu_torch.serve import ChapterGenerator, load_serving_params, serve

    kernels = {"fused_attention_fwd": fused_attention.KERNEL, "topk": decoding.TOPK_KERNEL,
               "decode_megakernel": decode_megakernel.KERNEL}
    cfg = ExperimentConfig()  # T5-base + ViT-12, beam 4, max_length 256
    tok = build_tokenizer("", num_bins=cfg.model.num_bins)
    model = load_serving_params(Vid2Seq(cfg.model), None, seed=0)
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    engine = ChapterGenerator(model, tok, cfg.data, cfg.generation, cfg.model.num_bins,
                              device=DEVICE)
    box, ready = {}, threading.Event()
    t0 = time.time()
    server = threading.Thread(target=serve, daemon=True, kwargs=dict(
        engine=engine, host="127.0.0.1", port=0, warmup=True,
        on_ready=lambda httpd: (box.update(httpd=httpd), ready.set())))
    server.start()
    check(ready.wait(timeout=600), "server did not come up")
    say(f"[serve] up with warm-up of buckets {engine.buckets} in {time.time() - t0:.1f} s")
    port = box["httpd"].server_address[1]
    rng = np.random.default_rng(0)
    payloads = [_request(i, True, rng) for i in range(8)] + [_request(i, False, rng)
                                                             for i in range(8, 10)]
    buckets = [engine._bucket(len(engine._input_tokens(p["asr"], p["duration"])))
               for p in payloads]
    check(buckets[:8] == [1000] * 8 and max(buckets[8:]) == 128, f"buckets {buckets}")
    results = [None] * len(payloads)

    def work(i):
        try:
            results[i] = _post(port, payloads[i])
        except Exception as e:  # recorded and failed below
            results[i] = (None, repr(e))

    calls0 = engine.device_calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.time()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.time() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    box["httpd"].shutdown()
    server.join(timeout=60)
    engine.close()
    n_chapters = 0
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
        chapters = r[1]["chapters"]
        check(isinstance(chapters, list), f"request {i}: chapters not a list")
        for ch in chapters:
            check(set(ch) == {"sentence", "timestamp"} and isinstance(ch["sentence"], str)
                  and 0.0 <= ch["timestamp"][0] < ch["timestamp"][1] <= 300.0,
                  f"request {i}: malformed chapter {ch}")
        n_chapters += len(chapters)
    e2e = {"requests_answered": len(results), "device_calls": engine.device_calls - calls0,
           "launches": launches, "videos_per_s": len(results) / wall, "wall_s": wall,
           "peak_memory_bytes": peak, "chapters_returned": n_chapters, "card": card}
    say(f"[e2e] {json.dumps(e2e)}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the serving path")
    fp32, fp32_inputs = fp32_token_check(cfg, cpu_state, engine, payloads[:2])
    return e2e, launches, fp32, (cpu_state, fp32_inputs)


def _fp32_inputs(engine, payloads):
    """Videos [2, 100, 768] and 1000-token inputs of two requests, numpy."""
    import numpy as np

    from vidchapters_tpu_torch.data.features import subsample_or_pad

    videos = np.stack([subsample_or_pad(np.asarray(p["features"], np.float32), 100, 768)
                       for p in payloads])
    tokens = np.zeros((2, 1000), np.int32)
    for i, p in enumerate(payloads):
        ids = engine._input_tokens(p["asr"], p["duration"])[:1000]
        tokens[i, :len(ids)] = ids
    return videos, tokens


def _fp32_model(cfg, state, dev):
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    mcfg = dataclasses.replace(cfg.model, t5=dataclasses.replace(cfg.model.t5, dtype="float32"),
                               vit=dataclasses.replace(cfg.model.vit, dtype="float32"))
    model = Vid2Seq(mcfg)
    model.load_state_dict(state)
    return model.to(dev).eval()


def _fp32_tokens(cfg, state, gen, dev, videos, tokens, label):
    """Tokens of ``make_generate_fn`` in fp32 on ``dev`` (numpy)."""
    import torch

    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    model = _fp32_model(cfg, state, dev)
    t0 = time.time()
    seqs = make_generate_fn(model, gen)(torch.from_numpy(videos).to(dev),
                                        torch.from_numpy(tokens).to(dev)).cpu().numpy()
    say(f"[fp32] {label} on {dev}: {time.time() - t0:.1f} s, first tokens {seqs[0, :8].tolist()}")
    return seqs


def _same_tokens(got, ref, what, cfg, state, videos, tokens):
    """Fail with the first differing step and the reference's top-2 log-prob
    gap there (teacher-forced through the full-sequence decoder on the CPU)."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.models.t5 import shift_right

    if np.array_equal(got, ref):
        return
    row, step = map(int, np.argwhere(got != ref)[0])
    model = _fp32_model(cfg, state, "cpu")
    with torch.no_grad():
        tv, tt = torch.from_numpy(videos[row:row + 1]), torch.from_numpy(tokens[row:row + 1])
        enc, mask = model.encode(tv, tt, (tt != 0).to(torch.int32))
        labels = torch.from_numpy(ref[row:row + 1, :step + 1]).long()
        logits = model.t5.decode(shift_right(labels), torch.ones_like(labels), enc, mask)
        top2 = torch.topk(torch.log_softmax(logits[0, step], -1), 2).values
    raise SmokeFailure(f"fp32 tokens differ ({what}) at row {row} step {step}: "
                       f"{got[row, step]} vs {ref[row, step]}, top-2 log-prob gap there "
                       f"{float(top2[0] - top2[1]):.3e}")


def fp32_token_check(cfg, state, engine, payloads):
    """Two 1000-bucket requests at max_length 64 in fp32: kernels on the card
    against the plain versions on the CPU; the tokens must be identical."""
    # the repetition penalty keeps the random model off one repeated token,
    # so the comparison spans 64 distinct decisions per hypothesis
    gen = dataclasses.replace(cfg.generation, max_length=64, repetition_penalty=3.0)
    videos, tokens = _fp32_inputs(engine, payloads)
    out = {path: _fp32_tokens(cfg, state, gen, dev, videos, tokens, path)
           for path, dev in (("kernels", DEVICE), ("plain", "cpu"))}
    _same_tokens(out["kernels"], out["plain"], "kernels vs plain", cfg, state, videos, tokens)
    say(f"[fp32] tokens identical over {out['plain'].shape} (max_length 64)")
    return {"identical": True, "shape": list(out["plain"].shape)}, (videos, tokens)


# ---------------------------------------------------------------------------
# phase 5: train and evaluate at full width through dvc_main
# ---------------------------------------------------------------------------

EVAL_METRICS = ("Bleu_4", "METEOR", "Rouge-L", "CIDEr", "Recall", "Precision", "F1", "soda_c")
DECODE_KERNELS = ("decode_self_attention", "decode_cross_attention")


DECODE_PROFILE_STEPS = 64


def _profile_decode(cfg, batch, mega: bool):
    """One beam-4 generate call of 64 steps over the 8 val videos (bf16,
    seeded random weights) on one decode route, after a warm-up call: its
    wall time unprofiled, then under torch.profiler the device's kernel time
    by group. Per step, the encoder's share included (it runs once a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    old = t5_mod.USE_MEGA_DECODE
    t5_mod.USE_MEGA_DECODE = None if mega else False
    try:
        model = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
        generate = make_generate_fn(model, dataclasses.replace(
            cfg.generation, max_length=DECODE_PROFILE_STEPS))
    finally:
        t5_mod.USE_MEGA_DECODE = old
    video = torch.as_tensor(batch["video"], dtype=torch.float32, device=DEVICE)
    tokens = torch.as_tensor(batch["input_tokens"], device=DEVICE)
    generate(video, tokens)
    torch.cuda.synchronize()
    t0 = time.time()
    generate(video, tokens)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        generate(video, tokens)
        torch.cuda.synchronize()
    groups = {"decode_attention": 0.0, "decode_megakernel": 0.0, "topk": 0.0,
              "fused_attention_fwd": 0.0, "matmul (cuBLAS)": 0.0, "elementwise": 0.0,
              "reduce": 0.0, "other": 0.0}
    kernels = _device_ms_by_kernel(prof)
    for name, ms in kernels.items():
        low = name.lower()
        key = next((g for g in ("decode_attention", "decode_megakernel", "topk",
                                "fused_attention_fwd") if g in low), None)
        if key is None and "mega_decode" in low:
            key = "decode_megakernel"
        if key is None:
            if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
                key = "matmul (cuBLAS)"
            elif "elementwise" in low:
                key = "elementwise"
            elif "reduce" in low or "softmax" in low:
                key = "reduce"
            else:
                key = "other"
        groups[key] += ms
    busy = sum(kernels.values())
    steps = DECODE_PROFILE_STEPS
    out = {"steps": steps, "rows": int(video.shape[0]) * cfg.generation.num_beams,
           "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy / steps,
           "idle_share": 1.0 - busy / wall_ms, "by_group_ms_per_step":
           {k: v / steps for k, v in groups.items() if v}}
    say(f"[decode] {'megakernel' if mega else 'standard'} route, beam 4, {steps} steps: "
        f"{json.dumps(out)}")
    del model, generate
    torch.cuda.empty_cache()
    return out


class _Tee:
    """A stdout that also keeps what it writes."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_train_and_evaluate(card: str, fp32_state, fp32_inputs):
    """``dvc_main.main`` on the card at full width (``ExperimentConfig()``:
    T5-base + ViT-12, dropout 0.1, bf16 compute) over phase 3's synthetic
    dataset with a val split (16 train, 8 val videos), greedy and beam search
    on the standard cached decode (``USE_MEGA_DECODE = False``):

    1. one epoch at batch 8 (2 steps), val eval at beam 4 / max_length 256,
       ``log.txt``, the val predictions, ``best`` and ``last``, then the
       final eval with ``best``;
    2. ``eval_only`` with nucleus sampling (top_p 0.9): resumes from
       ``last``, then the final eval.

    The checkpoints (weights and two Adam moments, 3.47 GB each) go to a
    temporary directory that is removed at the end. Each run's kernel counts
    are zeroed just before it and read just after; both decode-attention
    kernels must launch a multiple of 12 times (once per layer per step),
    the decode megakernel never. Then fp32 tokens of phase 4's two requests
    at max_length 64: the standard decode with the kernels on the card
    against the plain versions on the CPU (beam 4 and greedy), and against
    the megakernel on the card (beam 4)."""
    import contextlib

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import CheckpointConfig, DatasetPaths, ExperimentConfig
    from vidchapters_tpu_torch.data.dvc_dataset import DenseVideoCaptioningDataset, EpochIterator
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.ops import decode_attention, decode_megakernel, decoding
    from vidchapters_tpu_torch.ops import fused_attention
    from vidchapters_tpu_torch.train import dvc_main

    kernels = {"decode_self_attention": decode_attention.SELF_KERNEL,
               "decode_cross_attention": decode_attention.CROSS_KERNEL,
               "decode_megakernel": decode_megakernel.KERNEL, "topk": decoding.TOPK_KERNEL,
               "fused_attention_fwd": fused_attention.KERNEL,
               "fused_attention_bwd": fused_attention.BWD_KERNEL}
    evals, steps = [], []
    real_evaluate, real_make_step = dvc_main.evaluate, dvc_main.make_train_step

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real_evaluate(*a, **k)
        torch.cuda.synchronize()
        evals.append({"videos": len(out[0]), "wall_s": time.time() - t0})
        return out

    def timed_make_step(*a, **k):
        step = real_make_step(*a, **k)

        def timed(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(state, batch, seed)
            torch.cuda.synchronize()
            steps.append((time.time() - t0) * 1e3)
            return m

        return timed

    base = ExperimentConfig()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_train_dataset(Path(tmp), n_videos=16, n_val=8)
        ckpt = Path(tmp) / "ckpt"
        cfg = dataclasses.replace(
            base, datasets={"chapters": DatasetPaths(
                train_json_path=str(root / "ann.json"), val_json_path=str(root / "val.json"),
                features_path=str(root / "features"), subtitles_path=str(root / "asr.pkl"))},
            train=dataclasses.replace(base.train, epochs=1, batch_size=8, eval_batch_size=8,
                                      print_freq=1,
                                      checkpoint=CheckpointConfig(save_dir=str(ckpt))))
        nucleus = dataclasses.replace(cfg, generation=dataclasses.replace(
            cfg.generation, use_nucleus_sampling=True, top_p=0.9))
        old = (t5_mod.USE_MEGA_DECODE, dvc_main.evaluate, dvc_main.make_train_step)
        t5_mod.USE_MEGA_DECODE = False
        dvc_main.evaluate, dvc_main.make_train_step = timed_evaluate, timed_make_step
        try:
            for name, run_cfg, eval_only in (("beam4", cfg, False), ("nucleus", nucleus, True)):
                n_evals = len(evals)
                torch.cuda.synchronize()
                for kern in kernels.values():
                    kern.launches = 0
                tee = _Tee(sys.stdout)
                t0 = time.time()
                with contextlib.redirect_stdout(tee):
                    metrics = dvc_main.main(run_cfg, eval_only=eval_only, device=DEVICE)
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = {n: k.launches for n, k in kernels.items()}
                printed = "".join(tee.parts)
                runs[name] = {"wall_s": wall, "launches": launches, "metrics": metrics,
                              "evals": evals[n_evals:],
                              "resumed": "resumed from epoch 0" in printed}
                say(f"[dvc_main] {name}: {wall:.1f} s, launches {launches}, evals "
                    f"{evals[n_evals:]}")
                missing = [m for m in EVAL_METRICS if not np.isfinite(
                    metrics.get(f"chapters_{m}", float("nan")))]
                check(not missing, f"dvc_main {name}: metrics missing or not finite: {missing}")
                for kname in DECODE_KERNELS:
                    n = launches[kname]
                    check(n > 0 and n % 12 == 0,
                          f"dvc_main {name}: {kname} launched {n} times, not a multiple of 12")
                check(launches["decode_megakernel"] == 0,
                      f"dvc_main {name}: the decode megakernel ran on the standard route")
            log = (ckpt / "log.txt").read_text().splitlines()
            check(len(log) == 1 and json.loads(log[0])["epoch"] == 0, f"log.txt: {log}")
            for f in ("chapters_val_preds_e0.json", "best", "last", "manager.json"):
                check((ckpt / f).exists(), f"dvc_main wrote no {f}")
            check(not runs["beam4"]["resumed"] and runs["nucleus"]["resumed"],
                  "the eval_only run did not resume from `last` (or the first run did)")
            check(len(steps) == 2, f"{len(steps)} train steps, expected 2")
            ckpt_bytes = (ckpt / "last").stat().st_size
            # the DVC weights phase 9 strips of their time tokens
            best_weights = torch.load(ckpt / "best", map_location="cpu",
                                      weights_only=True)["model"]
        finally:
            t5_mod.USE_MEGA_DECODE, dvc_main.evaluate, dvc_main.make_train_step = old
        val_batch = next(iter(EpochIterator(
            DenseVideoCaptioningDataset(str(root / "val.json"), str(root / "features"),
                                        build_tokenizer("", num_bins=base.model.num_bins),
                                        base.data, subtitles_path=str(root / "asr.pkl")),
            8, base.data, shuffle=False, drop_last=False, bucket_inputs=True)))
    beam_eval, nucleus_eval = runs["beam4"]["evals"][-1], runs["nucleus"]["evals"][-1]
    summary = {"eval_videos_per_s_beam4_standard": beam_eval["videos"] / beam_eval["wall_s"],
               "eval_videos_per_s_nucleus": nucleus_eval["videos"] / nucleus_eval["wall_s"],
               "train_step_ms": steps, "checkpoint_bytes": ckpt_bytes, "card": card}
    say(f"[dvc_main] {json.dumps(summary)}")
    torch.cuda.empty_cache()
    summary["decode_step"] = {route: _profile_decode(base, val_batch, route == "megakernel")
                              for route in ("standard", "megakernel")}

    # fp32 tokens: standard decode card vs CPU (beam 4, greedy), and vs the megakernel
    videos, tokens = fp32_inputs
    gen4 = dataclasses.replace(base.generation, max_length=64, repetition_penalty=3.0)
    gen1 = dataclasses.replace(gen4, num_beams=1)
    fp32 = {}
    old_route = t5_mod.USE_MEGA_DECODE
    try:
        t5_mod.USE_MEGA_DECODE = False
        std = {}
        for label, gen in (("beam4", gen4), ("greedy", gen1)):
            std[label] = {dev: _fp32_tokens(base, fp32_state, gen, dev, videos, tokens,
                                            f"standard {label}")
                          for dev in (DEVICE, "cpu")}
            _same_tokens(std[label][DEVICE], std[label]["cpu"], f"standard {label}, card vs CPU",
                         base, fp32_state, videos, tokens)
            fp32[f"standard_{label}_card_vs_cpu"] = "identical"
        t5_mod.USE_MEGA_DECODE = None
        mega = _fp32_tokens(base, fp32_state, gen4, DEVICE, videos, tokens, "megakernel beam4")
        _same_tokens(std["beam4"][DEVICE], mega, "standard vs megakernel, beam 4", base,
                     fp32_state, videos, tokens)
        fp32["standard_vs_megakernel_beam4"] = "identical"
    finally:
        t5_mod.USE_MEGA_DECODE = old_route
    say(f"[fp32] standard decode: {fp32} over {list(mega.shape)} (max_length 64)")
    summary.update(runs=runs, fp32_tokens=fp32)
    return summary, runs["beam4"]["launches"], best_weights


# ---------------------------------------------------------------------------
# phase 6: PDVC trained and evaluated at full width through pdvc_main
# ---------------------------------------------------------------------------

PDVC_RECIPE = "configs/chapters_pdvc.json"
DEFORM_KERNELS = ("deformable_attention_fwd", "deformable_attention_bwd")
PDVC_METRICS = ("Bleu_4", "METEOR", "CIDEr", "Recall", "Precision", "soda_c")


def _write_pdvc_dataset(root: Path, n_train: int, n_val: int, seed: int = 0) -> Path:
    """CLIP-like features ([T, 768], T in [60, 400]) per video, train / val
    jsons of videos 60-600 s long with 3-10 chapters, each captioned by
    5-20 words of a 300-word list, and a metadata CSV of the val videos."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syll = [c + v for c in "bcdfghklmnprstvz" for v in "aeiou"]
    words = sorted({"".join(rng.choice(syll, int(rng.integers(1, 4)))) for _ in range(400)})[:300]
    (root / "features").mkdir()
    splits = {"train": {}, "val": {}}
    for i in range(n_train + n_val):
        vid = f"pdvc{i:07d}"  # 11 characters: the feature file's name
        np.save(root / "features" / f"{vid}.npy",
                rng.standard_normal((int(rng.integers(60, 401)), 768)).astype(np.float32))
        dur = float(rng.uniform(60.0, 600.0))
        k = int(rng.integers(3, 11))
        edges = np.sort(np.concatenate([[0.0, dur], rng.uniform(0.0, dur, k - 1)]))
        splits["train" if i < n_train else "val"][vid] = {
            "duration": dur,
            "timestamps": [[float(a), float(b)] for a, b in zip(edges, edges[1:])],
            "sentences": [" ".join(rng.choice(words, int(rng.integers(5, 21)))) + "."
                          for _ in range(k)]}
    for name, ann in splits.items():
        (root / f"{name}.json").write_text(json.dumps(ann))
    (root / "meta.csv").write_text("filename,video-duration\n" + "".join(
        f"/videos/{v}.mp4,{a['duration']}\n" for v, a in splits["val"].items()))
    return root


def _profile_pdvc(fn, wall_ms: float):
    """``fn`` once under torch.profiler: device time by kernel group and the
    device's idle share of an unprofiled call of ``wall_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _device_ms_by_kernel(prof)
    groups = {"deformable_attention": 0.0, "matmul (cuBLAS)": 0.0, "elementwise": 0.0,
              "reduce": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "deform_" in low:
            groups["deformable_attention"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
            groups["matmul (cuBLAS)"] += ms
        elif "elementwise" in low:
            groups["elementwise"] += ms
        elif "reduce" in low or "softmax" in low:
            groups["reduce"] += ms
        else:
            groups["other"] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # what the host issued: device kernels, and the operators called from
    # Python or autograd (not those nested inside another operator)
    n_kernels = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    n_ops = sum(1 for ev in prof.events() if ev.name.startswith("aten::") and not (
        ev.cpu_parent is not None and ev.cpu_parent.name.startswith("aten::")))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_kernels": n_kernels, "top_level_ops": n_ops, "by_group_ms": groups,
            "top_kernels_ms": [[n[:90], t] for n, t in top]}


def _timed_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


def pdvc_fp32_grad_check(cfg, host_batch):
    """One train step's loss and gradients at full width in fp32 with
    dropout 0, from the same weights and batch: the plain versions on the
    CPU, then the kernels on the card. The matcher's assignments are
    compared first. Where they differ, the card's assignment is costed
    under the CPU's cost matrix: it must be a near-tie (within 2 x targets
    x 1e-4 of the CPU's total: each auction ends within targets x eps of the
    optimum), it is reported as such, and the card's step takes the CPU's assignments, so
    that the gradients compare one function. The loss must then agree to
    1e-5 relative and every gradient to 1e-4 of its norm (+1e-6 for
    gradients that are 0 up to rounding, such as the query self-attention's
    key biases)."""
    import torch

    from vidchapters_tpu_torch.models import pdvc_loss
    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.ops import deformable_attention as da
    from vidchapters_tpu_torch.train.pdvc_train import pdvc_batch_to_device

    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    weights = PDVC(cfg0).init_weights(torch.Generator().manual_seed(1)).state_dict()
    coefs = dict(cost_class=cfg0.cls_loss_coef, cost_bbox=cfg0.bbox_loss_coef,
                 cost_giou=cfg0.giou_loss_coef)
    res, matching = {}, {}
    real_match = pdvc_loss.match_pdvc
    for path, dev in (("plain", "cpu"), ("kernels", DEVICE)):
        model = PDVC(cfg0)
        model.load_state_dict(weights)
        model.to(dev)
        batch = pdvc_batch_to_device(host_batch, dev)
        counts0 = (da.FWD_KERNEL.launches, da.BWD_KERNEL.launches)
        t0 = time.time()
        out = model(batch["video"], batch["video_mask"])
        assigns = [real_match(out["pred_logits"][lid], out["pred_boxes"][lid], batch["boxes"],
                              batch["valid"], cfg0, **coefs).cpu()
                   for lid in range(cfg0.dec_layers)]
        if path == "plain":
            costs = [pdvc_loss.match_cost(out["pred_logits"][lid], out["pred_boxes"][lid],
                                          batch["boxes"], cfg0, **coefs)[0]
                     for lid in range(cfg0.dec_layers)]
        else:  # compare, then give the card's step the CPU's assignments
            valid = batch["valid"][0].cpu() > 0
            cpu_assigns = res["plain"][2]
            for lid, (ak, ap) in enumerate(zip(assigns, cpu_assigns)):
                if torch.equal(ak, ap):
                    continue
                t_idx = torch.arange(len(valid))[valid]
                total = lambda a: float(costs[lid][a[0, valid], t_idx].sum())  # noqa: E731
                gap = total(ak) - total(ap)
                matching[f"layer_{lid}"] = {"card": ak.tolist(), "cpu": ap.tolist(),
                                            "cost_gap_under_cpu_cost": gap}
                # each auction ends within n_valid * eps of the optimum
                tol = 2 * int(valid.sum()) * 1e-4
                say(f"[pdvc-fp32-grad] matcher assignments differ card vs CPU at decoder layer "
                    f"{lid}: {ak.tolist()} vs {ap.tolist()}; the card's costs {gap:.3e} more "
                    f"under the CPU's cost matrix (a near-tie if within {tol:.1e})")
                check(abs(gap) <= tol, f"PDVC fp32 check: the matcher's assignments differ "
                                       f"card vs CPU at layer {lid} by a cost of {gap}")
            forced = iter(cpu_assigns)
            pdvc_loss.match_pdvc = lambda *a, **k: next(forced).to(DEVICE)
        try:
            targets = {k: batch[k] for k in ("boxes", "valid", "captions")}
            total_loss, _ = pdvc_loss.pdvc_criterion(model, out, targets, cfg0)
        finally:
            pdvc_loss.match_pdvc = real_match
        total_loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in model.named_parameters()}
        res[path] = (float(total_loss.detach()), grads, assigns,
                     (da.FWD_KERNEL.launches - counts0[0], da.BWD_KERNEL.launches - counts0[1]))
        say(f"[pdvc-fp32-grad] {path} on {dev}: {time.time() - t0:.1f} s, total {res[path][0]:.6f}")
        del model, out, total_loss
    loss_k, g_k, _, launched = res["kernels"]
    loss_p, g_p, _, _ = res["plain"]
    per_pass = cfg0.enc_layers + cfg0.dec_layers
    check(launched == (per_pass, per_pass), f"fp32 check launched {launched} deformable "
                                            f"fwd / bwd kernels, expected {per_pass} each")
    rel = {n: float((g_k[n] - g_p[n]).norm()) / max(float(g_p[n].norm()), 1e-30) for n in g_p}
    over = {n: float((g_k[n] - g_p[n]).norm()) - (1e-4 * float(g_p[n].norm()) + 1e-6)
            for n in g_p}
    worst = max(over, key=over.get)
    worst_rel = max((n for n in g_p if float(g_p[n].norm()) > 1e-3), key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    say(f"[pdvc-fp32-grad] assignments {'identical' if not matching else matching}; loss rel "
        f"diff {loss_rel:.2e} (tol 1e-5); {len(rel)} gradients, worst relative {worst_rel} at "
        f"{rel[worst_rel]:.2e} of its norm; closest to the tolerance {worst} "
        f"({rel[worst]:.2e} of a norm {float(g_p[worst].norm()):.3e})")
    check(loss_rel <= 1e-5, f"PDVC fp32 loss card {loss_k} vs CPU {loss_p}")
    check(over[worst] <= 0, f"PDVC fp32 gradient {worst}: {rel[worst]:.2e} of its norm")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": loss_rel,
            "assignments": matching or "identical", "n_gradients": len(rel),
            "worst_gradient": worst_rel, "worst_rel_err": rel[worst_rel],
            "depth": "full (2+2 layers), full width, batch 1"}


def pdvc_fp32_token_check(cfg, host_batch):
    """Greedy caption tokens (and proposals) of ``make_pdvc_infer`` in fp32
    for two val videos: the kernels on the card against the plain versions
    on the CPU, from seeded weights (not ``best``: the backward's fp32
    atomics make each run's trained weights, and so its near-ties, differ)
    with the caption head's logit layer drawn normal(0, 1) (the init's
    uniform(0.1) layer, and the head after one epoch on random data, emit
    EOS first, which would leave nothing to compare). The tokens must be
    identical and hold words; a difference is reported with the CPU's top-2
    log-prob gap there."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.train.pdvc_train import make_pdvc_infer

    weights = PDVC(cfg).init_weights(torch.Generator().manual_seed(2)).state_dict()
    weights["captioner.logit_w"] = torch.randn(weights["captioner.logit_w"].shape,
                                               generator=torch.Generator().manual_seed(7))
    posts, models = {}, {}
    for dev in (DEVICE, "cpu"):
        model = PDVC(cfg)
        model.load_state_dict(weights)
        models[dev] = model.to(dev).eval()
        t0 = time.time()
        posts[dev] = make_pdvc_infer(models[dev], cfg)(host_batch["video"],
                                                      host_batch["video_mask"],
                                                      host_batch["duration"])
        say(f"[pdvc-fp32-tokens] infer on {dev}: {time.time() - t0:.1f} s")
    got, ref = posts[DEVICE], posts["cpu"]
    if not np.array_equal(got["seq"], ref["seq"]):
        b, j, s = map(int, np.argwhere(got["seq"] != ref["seq"])[0])
        q = int(ref["query_order"][b, j])
        model = models["cpu"]
        with torch.no_grad():
            out = model(torch.as_tensor(host_batch["video"][b:b + 1]),
                        torch.as_tensor(host_batch["video_mask"][b:b + 1]))
            ctx = model.caption_context(out, torch.tensor([[q]]))
            seq = torch.as_tensor(np.concatenate([[0], ref["seq"][b, j, :s + 1]]))[None].long()
            logp = model.caption_logprobs(out["hs"][-1][:, q], seq, ctx)[0, s]
            top2 = torch.topk(logp, 2).values
        raise SmokeFailure(f"PDVC fp32 tokens differ card vs CPU at video {b}, query {q}, step "
                           f"{s}: {got['seq'][b, j, s]} vs {ref['seq'][b, j, s]}; the CPU's "
                           f"top-2 log-prob gap there {float(top2[0] - top2[1]):.3e}")
    score_err = float(np.abs(got["scores"] - ref["scores"]).max())
    check(np.array_equal(got["query_order"], ref["query_order"]) and score_err <= 1e-4,
          f"PDVC fp32 proposals differ card vs CPU (score err {score_err})")
    n_words = int((ref["seq"] > 0).sum())
    check(n_words > 0, "PDVC fp32 token check: the captions hold no words")
    say(f"[pdvc-fp32-tokens] tokens identical over {list(ref['seq'].shape)} ({n_words} words); "
        f"proposal order identical, scores within {score_err:.2e}")
    return {"identical": True, "shape": list(ref["seq"].shape), "words": n_words,
            "score_max_abs_err": score_err}


def phase_pdvc(card: str, cfg=None, n_train: int = 16, n_val: int = 8):
    """PDVC through ``train/pdvc_main`` on the card at the full width of
    configs/chapters_pdvc.json (hidden 512, 8 heads, 2+2 layers, 100
    queries, 4 levels x 4 points, LSTM-DSA caption head with vocab 33598,
    fp32), on a synthetic on-disk dataset of ``n_train`` + ``n_val`` videos:

    1. ``main``: one epoch at the recipe's batch 1, lr 1e-4, StepLR 8, the
       val eval, ``best`` / ``last`` / ``translator.json`` / ``info.json``,
       the final eval with ``best``. The deformable kernels' counts are
       zeroed just before and read just after: the forward must launch once
       per encoder and decoder layer per forward pass (train steps and eval
       batches), the backward once per layer per train step;
    2. ``eval_main`` from the saved directory (``best``), then the CLI's
       test mode over the val videos' metadata CSV;
    3. one train step and one eval batch under torch.profiler;
    4. the fp32 gradient check and the fp32 caption-token check (seeded
       weights), card against CPU.

    Cut from the recipe: one epoch instead of five, random-init weights."""
    import contextlib

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import PDVCConfig, save_config
    from vidchapters_tpu_torch.data.pdvc_dataset import PDVCDataset, Translator, pdvc_collate
    from vidchapters_tpu_torch.models import pdvc_loss
    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.ops import deformable_attention as da
    from vidchapters_tpu_torch.train import pdvc_main
    from vidchapters_tpu_torch.train.pdvc_train import (
        PDVCTrainState,
        build_pdvc_optimizer,
        make_pdvc_infer,
        make_pdvc_train_step,
        pdvc_batch_to_device,
    )

    recipe = json.loads((ROOT / PDVC_RECIPE).read_text())
    cfg = cfg or dataclasses.replace(PDVCConfig(), **recipe["model"])
    tr = recipe["train"]
    bs, per_pass = tr["batch_size"], cfg.enc_layers + cfg.dec_layers
    kernels = {"deformable_attention_fwd": da.FWD_KERNEL,
               "deformable_attention_bwd": da.BWD_KERNEL}
    steps, evals, match_ms = [], [], []
    real = (pdvc_main.make_pdvc_train_step, pdvc_main.evaluate_pdvc, pdvc_loss.match_pdvc)

    def timed_make_step(*a, **k):
        step = real[0](*a, **k)

        def timed(state, batch, seed):
            out = {}
            steps.append(_timed_ms(lambda: out.update(step(state, batch, seed))))
            return out

        return timed

    def timed_evaluate(*a, **k):
        out = []
        ms = _timed_ms(lambda: out.append(real[1](*a, **k)))
        evals.append({"videos": len(out[0][0]), "wall_s": ms / 1e3})
        return out[0]

    def timed_match(*a, **k):
        out = []
        match_ms.append(_timed_ms(lambda: out.append(real[2](*a, **k))))
        return out[0]

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    def zero():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    summary = {"card": card, "config": f"{PDVC_RECIPE} model section",
               "cut": ["1 epoch (recipe: 5)", "random-init weights",
                       f"synthetic data: {n_train} train + {n_val} val videos"]}
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_pdvc_dataset(Path(tmp), n_train, n_val)
        save, out_dir = Path(tmp) / "ckpt", Path(tmp) / "eval"
        data = (str(root / "train.json"), str(root / "val.json"), str(root / "features"), cfg)
        pdvc_main.make_pdvc_train_step, pdvc_main.evaluate_pdvc = timed_make_step, timed_evaluate
        pdvc_loss.match_pdvc = timed_match
        try:
            zero()
            torch.cuda.reset_peak_memory_stats()
            tee = _Tee(sys.stdout)
            t0 = time.time()
            with contextlib.redirect_stdout(tee):
                metrics = pdvc_main.main(*data, str(save), n_epochs=1, batch_size=bs,
                                         lr=tr["lr"], lr_drop_epochs=tr["lr_drop_epochs"],
                                         max_events=tr["max_events"], seed=0, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            pdvc_main.make_pdvc_train_step, pdvc_main.evaluate_pdvc = real[:2]
            pdvc_loss.match_pdvc = real[2]
        n_steps = n_train // bs
        eval_batches = 2 * -(-n_val // bs)  # the val eval and the final eval
        want = {"deformable_attention_fwd": per_pass * (n_steps + eval_batches),
                "deformable_attention_bwd": per_pass * n_steps}
        say(f"[pdvc_main] train + evaluate: {wall:.1f} s, {len(steps)} steps, launches "
            f"{launches} (expected {want}), evals {evals}")
        check(len(steps) == n_steps, f"{len(steps)} PDVC train steps, expected {n_steps}")
        check(launches == want, f"deformable launches {launches}, expected {want}")
        check(len(match_ms) == cfg.dec_layers * n_steps,
              f"{len(match_ms)} matcher calls, expected {cfg.dec_layers} per step")
        missing = [m for m in PDVC_METRICS if not np.isfinite(metrics.get(m, float("nan")))]
        check(not missing, f"pdvc_main: metrics missing or not finite: {missing}")
        for f in ("best", "last", "translator.json", "info.json", "manager.json"):
            check((save / f).exists(), f"pdvc_main wrote no {f}")
        info = json.loads((save / "info.json").read_text())
        check([h["epoch"] for h in info["histories"]] == [0], f"info.json: {info['histories']}")
        best_epoch = json.loads((save / "best.meta.json").read_text())["epoch"]
        ckpt_bytes = (save / "last").stat().st_size

        # eval_main from the saved directory, then the CLI's test mode
        zero()
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            scored = pdvc_main.eval_main(str(save), data[1], data[2], cfg, save_dir=str(out_dir),
                                         batch_size=bs, max_events=tr["max_events"],
                                         device=DEVICE)
        eval_main_s = time.time() - t0
        eval_launches = counts()
        check("loaded PDVC 'best' checkpoint" in "".join(tee.parts), "eval_main did not load best")
        check(eval_launches == {"deformable_attention_fwd": per_pass * -(-n_val // bs),
                                "deformable_attention_bwd": 0},
              f"eval_main launches {eval_launches}")
        missing = [m for m in PDVC_METRICS if not np.isfinite(scored.get(m, float("nan")))]
        check(not missing, f"eval_main: metrics missing or not finite: {missing}")
        save_config(cfg, str(Path(tmp) / "cfg.json"))
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            pdvc_main._cli(["--eval", "--load", str(save), "--features-path", data[2],
                            "--config", str(Path(tmp) / "cfg.json"), "--save-dir", str(out_dir),
                            "--test-meta-csv", str(root / "meta.csv"), "--batch-size", str(bs),
                            "--device", DEVICE])
        test_mode_s = time.time() - t0
        check(json.loads("".join(tee.parts).strip().splitlines()[-1]) == {},
              "test mode printed metrics")
        dvc = json.loads((out_dir / "dvc_results.json").read_text())["results"]
        val_ids = set(json.loads(Path(data[1]).read_text()))
        check(set(dvc) == val_ids and all(
            p and all("sentence" in x and "timestamp" in x for x in p) for p in dvc.values()),
              f"test mode results cover {len(dvc)} of {len(val_ids)} videos, or some are empty")
        say(f"[pdvc_main] eval_main {eval_main_s:.1f} s (launches {eval_launches}), test mode "
            f"{test_mode_s:.1f} s, {sum(len(p) for p in dvc.values())} proposals")

        best = torch.load(save / "best", map_location="cpu", weights_only=True)["model"]
        translator = Translator.from_json(str(save / "translator.json"))
        train_ds = PDVCDataset(data[0], data[2], translator, cfg, max_events=tr["max_events"])
        val_ds = PDVCDataset(data[1], data[2], translator, cfg, max_events=tr["max_events"])
        big = max(range(len(train_ds)), key=lambda i: int(train_ds[i]["valid"].sum()))
        train_batch = pdvc_collate([train_ds[big]])
        val_batch = pdvc_collate([val_ds[0], val_ds[1]])
        one = pdvc_collate([val_ds[0]])

    timed_steps = steps[1:] if len(steps) > 1 else steps
    final_eval = evals[-1]
    summary.update({
        "train_step_ms": steps, "train_step_ms_mean_after_first": float(np.mean(timed_steps)),
        "train_videos_per_s": bs * len(timed_steps) / (sum(timed_steps) / 1e3),
        "eval_videos_per_s": final_eval["videos"] / final_eval["wall_s"], "evals": evals,
        "matcher_ms_per_step": float(np.sum(match_ms)) / max(n_steps, 1),
        "matcher_ms_per_call": float(np.mean(match_ms)), "peak_memory_bytes": peak,
        "run_wall_s": wall, "launches": launches, "metrics": metrics, "best_epoch": best_epoch,
        "eval_main": {"wall_s": eval_main_s, "launches": eval_launches, "metrics": scored},
        "test_mode_wall_s": test_mode_s, "checkpoint_bytes": ckpt_bytes})
    say(f"[pdvc] train {summary['train_step_ms_mean_after_first']:.2f} ms/step "
        f"({summary['train_videos_per_s']:.2f} videos/s), eval "
        f"{summary['eval_videos_per_s']:.3f} videos/s (decode + rerank + scoring), matcher "
        f"{summary['matcher_ms_per_step']:.2f} ms/step, peak {peak} bytes")

    # one train step and one eval batch under the profiler
    model = PDVC(cfg).to(DEVICE)
    model.load_state_dict(best)
    state = PDVCTrainState(model, build_pdvc_optimizer(model.parameters(), lr=tr["lr"]))
    step = make_pdvc_train_step(model, cfg)
    batch = pdvc_batch_to_device(train_batch, DEVICE)
    infer = make_pdvc_infer(model, cfg)
    for _ in range(2):
        step(state, batch, 0)
        infer(one["video"], one["video_mask"], one["duration"])
    summary["profile"] = {
        "train_step": _profile_pdvc(lambda: step(state, batch, 0),
                                    _timed_ms(lambda: step(state, batch, 0))),
        "eval_batch": _profile_pdvc(
            lambda: infer(one["video"], one["video_mask"], one["duration"]),
            _timed_ms(lambda: infer(one["video"], one["video_mask"], one["duration"])))}
    for what, prof in summary["profile"].items():
        say(f"[pdvc] profiled {what}: {json.dumps({k: v for k, v in prof.items() if k != 'top_kernels_ms'})}")
        for name, ms in prof["top_kernels_ms"]:
            say(f"[pdvc]   {ms:9.3f} ms  {name}")
    del model, state, step, infer
    torch.cuda.empty_cache()

    summary["fp32_grad_check"] = pdvc_fp32_grad_check(cfg, train_batch)
    summary["fp32_tokens"] = pdvc_fp32_token_check(cfg, val_batch)
    return summary, launches


# ---------------------------------------------------------------------------
# phase 7: the ASR factory at Whisper large-v2 width
# ---------------------------------------------------------------------------


ASR_SECONDS = (20.0, 26.5, 33.0, 39.5, 46.0, 52.5, 59.0, 65.0)  # the 8 synthetic videos
ASR_PICKLES = {}  # the sweep's pickles by video id, kept for phase 11
ASR_STEPS = 223  # decoder steps per decode call: max_decode_len 224, less 1


def _write_asr_wavs(root: Path, seconds, seed: int = 0):
    """Seeded 16 kHz mono .wav files: a few tones plus noise, with silent
    gaps of 2-6 s; video ids of 11 characters, as the merges key them."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    paths = []
    for i, dur in enumerate(seconds):
        t = np.arange(int(16000 * dur)) / 16000
        sig = sum(0.2 * np.sin(2 * np.pi * rng.uniform(120, 900) * t + rng.uniform(0, 6))
                  for _ in range(3))
        sig = sig + rng.normal(size=t.shape) * 0.03
        for start in rng.uniform(0, dur - 6, 2):
            sig[int(start * 16000):int((start + rng.uniform(2, 6)) * 16000)] = 0.0
        path = root / f"asrvid{i:05d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())
        paths.append(str(path))
    return paths


def _whisper_model(cfg, device: str, seed: int):
    """The port's Whisper built on ``device`` with seeded random weights."""
    import torch

    from vidchapters_tpu_torch.models.whisper import Whisper

    with torch.device(device):
        model = Whisper(cfg)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _profile_asr_decode(tr, enc, prefix):
    """One greedy decode call (223 steps at the sweep's batch) under
    torch.profiler, and one unprofiled: wall and device ms per step, device
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    temps = torch.zeros(enc.shape[0], device=enc.device)
    run = lambda: tr._decode(enc, prefix, temps, 0, False)  # noqa: E731
    run()
    torch.cuda.synchronize()
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = _device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    mega = sum(ms for name, ms in kernels.items() if "whisper_mega" in name)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": ASR_STEPS, "rows": int(enc.shape[0]), "wall_ms_per_step": wall_ms / ASR_STEPS,
            "device_ms_per_step": busy / ASR_STEPS, "kernel_ms_per_step": mega / ASR_STEPS,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "top_kernels_ms": [[n[:90], t] for n, t in top]}


def asr_fp32_token_check(cfg):
    """Large-v2 widths cut to 4+4 layers, fp32, seeded weights: one 30 s
    window decoded greedily under the timestamp rules and one beam-5 window,
    with the decode kernel on the card and its plain version on the CPU; the
    tokens and the beam ancestry (each step's parent rows) must be
    identical."""
    import copy

    import numpy as np
    import torch

    from vidchapters_tpu_torch.factory.audio import log_mel_spectrogram
    from vidchapters_tpu_torch.factory.whisper_transcribe import WhisperTranscriber

    cut = dataclasses.replace(cfg, encoder_layers=4, decoder_layers=4, dtype="float32")
    card_model = _whisper_model(cut, DEVICE, seed=11)
    cpu_model = copy.deepcopy(card_model).to("cpu")
    rng = np.random.default_rng(5)
    t = np.arange(16000 * 30) / 16000
    mel = log_mel_spectrogram((0.3 * np.sin(2 * np.pi * 220 * t)
                               + rng.normal(size=t.shape) * 0.05).astype(np.float32))
    out = {"config": "large-v2 widths, 4+4 layers, fp32"}
    for name, beam in (("greedy", None), ("beam5", 5)):
        runs = []
        for model, dev in ((card_model, DEVICE), (cpu_model, "cpu")):
            tr = WhisperTranscriber(model, device=dev, language="en", temperatures=(0.0,),
                                    compression_ratio_threshold=None, logprob_threshold=None,
                                    no_speech_threshold=None, beam_size=beam)
            parents = []
            if beam:
                real = tr.decode_fns.reorder_cache
                tr.decode_fns = tr.decode_fns._replace(reorder_cache=lambda c, s: (
                    parents.append(s.cpu().numpy().tolist()), real(c, s))[1])
            t0 = time.time()
            toks, avg_lp, nsp, _ = tr._decode_window(mel, 0)
            runs.append({"tokens": toks, "parents": parents, "avg_logprob": avg_lp,
                         "no_speech": nsp, "wall_s": time.time() - t0})
        card, cpu = runs
        check(card["tokens"] == cpu["tokens"],
              f"fp32 ASR {name}: tokens differ between the card and the CPU")
        check(card["parents"] == cpu["parents"],
              f"fp32 ASR {name}: beam ancestry differs between the card and the CPU")
        out[name] = {"tokens": len(card["tokens"]), "parent_steps": len(card["parents"]),
                     "avg_logprob_card": card["avg_logprob"], "avg_logprob_cpu": cpu["avg_logprob"],
                     "wall_s_card": card["wall_s"], "wall_s_cpu": cpu["wall_s"]}
        say(f"[asr] fp32 {name}: {len(card['tokens'])} tokens identical card / CPU"
            + (f", ancestry of {len(card['parents'])} steps identical" if beam else "")
            + f" (avg log-prob {card['avg_logprob']:.6f} / {cpu['avg_logprob']:.6f})")
    return out


def phase_asr(card: str, cfg=None, seconds=ASR_SECONDS):
    """The ASR factory (``factory/asr.run_batched_asr`` over
    ``factory/whisper_transcribe.WhisperTranscriber``) on the card at
    Whisper large-v2 width (vocab 51865, 80 mels, 32+32 layers, d 1280, 20
    heads, d_ff 5120, bf16 compute) with seeded random weights and the
    transcriber's defaults (language detection, thresholds 2.4 / -1.0 /
    0.6, temperatures 0 .. 1.0, max_decode_len 224, the timestamp rules):

    1. 8 synthetic .wav files (tones and noise with silent gaps, 20-65 s)
       through ``run_batched_asr`` at batch 8; every pickle holds text /
       start / end / language; ``merge_asr_pickles`` carries each over
       whole, and ``merge_and_process`` of the same segments in whisperx
       form gives back their non-empty texts, times and language;
    2. one ``transcribe`` of the first file with beam 5 and the VAD;
    3. one greedy decode call at batch 8 under torch.profiler;
    4. the fp32 token check (4+4 layers, card against CPU).

    The decode kernel's launches are zeroed before 1 and 2 and read after:
    each must equal 223 x (decode calls) + (language-detection calls). With
    random weights the average log-prob is about -ln 51865, so every window
    climbs all six rungs. Cut from a deployment: random weights, 8 videos."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.factory import asr
    from vidchapters_tpu_torch.factory.whisper_transcribe import WhisperTranscriber
    from vidchapters_tpu_torch.models.whisper import LARGE_V2
    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    cfg = cfg or LARGE_V2
    summary = {"card": card, "config": "Whisper large-v2 (LARGE_V2), seeded random weights",
               "audio_s": list(seconds)}
    model = _whisper_model(cfg, DEVICE, seed=7)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_asr_wavs(Path(tmp), seconds)
        out_dir = Path(tmp) / "asr"
        tr = WhisperTranscriber(model, device=DEVICE)
        keys = []
        real_decode = tr._decode

        def keyed_decode(enc, prefix, temperature, key, sample):
            keys.append(key)
            return real_decode(enc, prefix, temperature, key, sample)

        tr._decode = keyed_decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wm.KERNEL.launches = 0
        t0 = time.time()
        n = asr.run_batched_asr(paths, str(out_dir), tr, batch_size=8)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = wm.KERNEL.launches
        peak = torch.cuda.max_memory_allocated()
        want = ASR_STEPS * tr.decode_calls + tr.detect_calls
        windows = len({k // 131 for k in keys})
        say(f"[asr] run_batched_asr: {n} videos, {sum(seconds):.1f} s of audio in {wall:.2f} s "
            f"= {sum(seconds) / wall:.2f} audio-s/s; {windows} lockstep windows, "
            f"{tr.decode_calls} decode calls (rungs {[k % 131 for k in keys]}), "
            f"{tr.detect_calls} detect; launches {launches} (expected {want}); peak {peak} bytes")
        check(n == len(paths), f"run_batched_asr processed {n} of {len(paths)} videos")
        check(launches == want, f"whisper kernel launches {launches}, expected {want}")
        pickles = {}
        for p in paths:
            with open(out_dir / (Path(p).stem + ".pkl"), "rb") as f:
                pickles[Path(p).stem] = pickle.load(f)
        ASR_PICKLES.update(pickles)  # phase 11's demo and alignment read them
        for vid, res in pickles.items():
            check(set(res) == {"text", "start", "end", "language"}
                  and len(res["text"]) == len(res["start"]) == len(res["end"])
                  and all(np.isfinite(res["start"])) and all(np.isfinite(res["end"])),
                  f"ASR pickle {vid}: {sorted(res)}")
        # the factory's pickles are already in the datasets' schema: the plain
        # merge must carry each one over whole
        merged = asr.merge_asr_pickles(str(out_dir), str(Path(tmp) / "asr.pkl"))
        check(merged == {asr.normalize_video_id(v): r for v, r in pickles.items()},
              f"merge_asr_pickles keys {sorted(merged)} or contents differ from the pickles")
        # merge_and_process reads whisperx-aligned segments (the output of the
        # alignment step): give it the sweep's segments in that form and
        # expect the non-empty texts back with their times and language
        aligned_dir = Path(tmp) / "aligned"
        aligned_dir.mkdir()
        expected = {}
        for vid, res in pickles.items():
            segs = [{"text": t, "start": s, "end": e}
                    for t, s, e in zip(res["text"], res["start"], res["end"])]
            with open(aligned_dir / f"{vid}.pkl", "wb") as f:
                pickle.dump({"segments": segs, "language": res["language"]}, f)
            kept = [(t.strip(), float(s), float(e)) for t, s, e in
                    zip(res["text"], res["start"], res["end"]) if t.strip()]
            expected[asr.normalize_video_id(vid)] = {
                "text": [k[0] for k in kept], "start": [k[1] for k in kept],
                "end": [k[2] for k in kept], "language": res["language"]}
        proc = asr.merge_and_process(str(aligned_dir), str(Path(tmp) / "asr_proc.pkl"))
        check(proc == expected, "merge_and_process of the aligned segments differs from the "
                                "sweep's non-empty segments")
        summary["sweep"] = {
            "videos": n, "audio_s": sum(seconds), "wall_s": wall,
            "audio_s_per_s": sum(seconds) / wall, "windows": windows,
            "decode_calls": tr.decode_calls, "detect_calls": tr.detect_calls,
            "rungs": [k % 131 for k in keys], "launches": launches, "peak_memory_bytes": peak,
            "segments": {v: len(r["text"]) for v, r in pickles.items()},
            "languages": {v: r["language"] for v, r in pickles.items()}}

        # one video, beam 5 and the VAD
        from vidchapters_tpu_torch.factory.audio import load_audio

        beam = WhisperTranscriber(model, device=DEVICE, beam_size=5, vad=True)
        audio = load_audio(paths[0])
        wm.KERNEL.launches = 0
        t0 = time.time()
        res = beam.transcribe(audio)
        torch.cuda.synchronize()
        beam_wall = time.time() - t0
        beam_launches = wm.KERNEL.launches
        want_beam = ASR_STEPS * beam.decode_calls + beam.detect_calls
        say(f"[asr] transcribe beam 5 + VAD: {len(audio) / 16000:.1f} s in {beam_wall:.2f} s, "
            f"{beam.decode_calls} decode calls, {len(res['text'])} segments, launches "
            f"{beam_launches} (expected {want_beam})")
        check(set(res) == {"text", "start", "end", "language"}, f"beam transcribe: {sorted(res)}")
        check(beam_launches == want_beam,
              f"beam whisper kernel launches {beam_launches}, expected {want_beam}")
        summary["beam5_vad"] = {"audio_s": len(audio) / 16000, "wall_s": beam_wall,
                                "decode_calls": beam.decode_calls, "launches": beam_launches,
                                "segments": len(res["text"])}
        del beam
        torch.cuda.empty_cache()

        # a decode call at the sweep's batch under the profiler
        from vidchapters_tpu_torch.factory.audio import log_mel_spectrogram

        mels = np.stack([log_mel_spectrogram(load_audio(p)[:480000]) for p in paths])
        enc = tr._encode(mels)
        prefix = tr._prefix([tr._sot_sequence(None)] * len(paths))
        summary["decode_profile"] = _profile_asr_decode(tr, enc, prefix)
        say(f"[asr] profiled decode call: "
            f"{json.dumps({k: v for k, v in summary['decode_profile'].items() if k != 'top_kernels_ms'})}")
        del tr, enc, model
        torch.cuda.empty_cache()
    summary["fp32_tokens"] = asr_fp32_token_check(cfg)
    return summary, {"whisper_megakernel": launches}


# ---------------------------------------------------------------------------
# phase 8: HowTo100M pretraining and a reference checkpoint at full width
# ---------------------------------------------------------------------------

PRETRAIN_RECIPE = "configs/htm_pretrain.json"
PRETRAIN_STEPS = 3                  # timed steps of dvc_main's epoch, after one warm-up step
PRETRAIN_BATCHES = (64, 32, 16, 8)  # the recipe's batch, then the powers of two below it
SPM_PIECES = 32000                  # T5-base's spiece.model: 32,000 pieces + 100 sentinels
ASR_WORDS = ("in step of video we whisk eggs and fold flour then knead the dough let it rest "
             "for minutes add salt water butter sugar mix bake slice serve").split()


def _spm_piece(text: str, score: float, ptype: int = 1) -> bytes:
    """One ``SentencePiece`` message inside a ``ModelProto`` (field 1)."""
    import struct

    def varint(n: int) -> bytes:
        out = b""
        while True:
            b, n = n & 0x7F, n >> 7
            if not n:
                return out + bytes([b])
            out += bytes([b | 0x80])

    enc = text.encode("utf-8")
    body = (b"\x0a" + varint(len(enc)) + enc + b"\x15" + struct.pack("<f", score)
            + b"\x18" + varint(ptype))
    return b"\x0a" + varint(len(body)) + body


def _write_spm_model(path: Path) -> None:
    """A unigram ``spiece.model`` with T5-base's layout: pad / eos / unk at
    ids 0-2, then 31,997 pieces (the ASR's words with and without the ``▁``
    prefix, every printable ASCII character, the digits' pairs, and letter
    bigrams and trigrams as filler), scored so that whole words win."""
    import itertools
    import string

    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -4.0, 1)]
    seen = {p for p, _, _ in pieces}

    def add(text, score):
        if text not in seen and len(pieces) < SPM_PIECES:
            seen.add(text)
            pieces.append((text, score, 1))

    for w in ASR_WORDS:
        add("▁" + w, -3.0 - 0.01 * len(pieces))
        add(w, -6.0)
    for c in string.printable.strip():
        add(c, -9.0)
        add("▁" + c, -8.0)
    for a, b in itertools.product(string.digits, repeat=2):
        add(a + b, -7.0)
        add("▁" + a + b, -6.5)
    for n in (2, 3):
        for combo in itertools.product(string.ascii_lowercase, repeat=n):
            add("".join(combo), -12.0 + n)
            add("▁" + "".join(combo), -11.5 + n)
    check(len(pieces) == SPM_PIECES, f"synthetic spiece.model holds {len(pieces)} pieces")
    path.write_bytes(b"".join(_spm_piece(*p) for p in pieces))


def _write_htm_dataset(root: Path, n_videos: int, seed: int = 0):
    """A HowTo100M layout: ``htm.csv`` of ``video_id,video_path``, ``[T, 768]``
    features (T 200-400, one a second) at ``features/shard{k}/<id>.mp4.npy``
    over 8 shard subdirectories, an ASR pickle keyed on the last 11
    characters (90 segments a video: more than 1000 tokens of time + text),
    and the synthetic ``spiece.model``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows, asr = [], {}
    for i in range(n_videos):
        vid = f"htm{i:08d}"
        shard = root / "features" / f"shard{i % 8}"
        shard.mkdir(parents=True, exist_ok=True)
        frames = int(rng.integers(200, 400))
        np.save(shard / f"{vid}.mp4.npy",
                rng.standard_normal((frames, 768), dtype=np.float32))
        rows.append(f"{vid},shard{i % 8}/{vid}.mp4")
        st = np.linspace(0.0, frames - 6.0, 90)
        words = rng.choice(ASR_WORDS, size=(90, 10))
        asr[vid[-11:]] = {"text": [f"{' '.join(w)} {j}" for j, w in enumerate(words)],
                          "start": st.tolist(), "end": (st + 4.0).tolist()}
    (root / "htm.csv").write_text("video_id,video_path\n" + "\n".join(rows) + "\n")
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    _write_spm_model(root / "spiece.model")
    return root


def fused_per_step(mcfg, data, genasr: bool) -> int:
    """Fused-attention forward launches of one train step (the generative
    pass, then the denoising pass; each launch has one backward), from the
    route of ``models/t5.T5Attention``: a key mask and Lq > CHUNK with Lq *
    Lk > 512^2. The encoder pads its input to SEQ_PAD_BLOCK, and Vid2Seq
    pads the video + ASR states once more before cross-attention."""
    from vidchapters_tpu_torch.data.dvc_dataset import denoise_length_bounds
    from vidchapters_tpu_torch.models.t5 import CHUNK, SEQ_PAD_BLOCK

    def pad(n):
        return -(-n // SEQ_PAD_BLOCK) * SEQ_PAD_BLOCK

    def fused(lq, lk):
        return int(lq > CHUNK and lq * lk > 512 * 512)

    den_in, den_out = denoise_length_bounds(data.max_input_tokens)
    gen_in = 1 if genasr else data.max_input_tokens  # genasr: the video alone
    n = 0
    for lin, lout in ((gen_in, data.max_output_tokens), (den_in, den_out)):
        n += mcfg.t5.num_layers * fused(pad(lin), pad(lin))
        n += mcfg.t5.num_decoder_layers * (fused(lout, lout)
                                           + fused(lout, pad(data.max_feats + lin)))
    return n


def _pretrain_cfg(root: Path, batch: int, csv_name: str = "htm.csv"):
    """``configs/htm_pretrain.json`` through the port's ``load_config``, on
    the synthetic layout under ``root`` (its videos listed in ``csv_name``),
    one epoch, ``mu_dtype`` bfloat16."""
    from vidchapters_tpu_torch.config import (
        CheckpointConfig,
        DatasetPaths,
        ExperimentConfig,
        load_config,
    )

    base = load_config(ExperimentConfig, str(ROOT / PRETRAIN_RECIPE))
    t = base.train
    return dataclasses.replace(
        base, tokenizer_path=str(root / "spiece.model"),
        datasets={"htm": DatasetPaths(train_json_path=str(root / csv_name),
                                      features_path=str(root / "features"),
                                      subtitles_path=str(root / "asr.pkl"))},
        train=dataclasses.replace(t, epochs=1, batch_size=batch, print_freq=1,
                                  optim=dataclasses.replace(t.optim, mu_dtype="bfloat16"),
                                  checkpoint=CheckpointConfig(save_dir=str(root / "ckpt"))))


def _largest_batch_that_fits(cfg, ds):
    """The recipe's batch if one train step of it fits on the card, else the
    largest power of two below it that does: (batch, {batch: outcome})."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.data.dvc_dataset import collate
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.dvc_train import (
        TrainState,
        batch_to_device,
        make_train_step,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    t, d = cfg.train, cfg.data
    model = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
    state = TrainState(model, build_optimizer(t.optim, 100, model.parameters()))
    step = make_train_step(model, t.generative, t.denoising, t.genasr)
    tried = {}
    chosen = None
    for bs in PRETRAIN_BATCHES:
        rng = np.random.default_rng(0)
        batch = collate([ds.__getitem__(i, rng=rng) for i in range(bs)],
                        d.max_input_tokens, d.max_output_tokens)
        torch.cuda.reset_peak_memory_stats()
        try:
            step(state, batch_to_device(batch, DEVICE), t.seed)
            torch.cuda.synchronize()
            tried[bs] = {"fits": True, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            chosen = bs
        except torch.cuda.OutOfMemoryError as e:
            tried[bs] = {"fits": False, "error": str(e).splitlines()[0][:160]}
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        say(f"[pretrain] batch {bs}: {tried[bs]}")
        if chosen is not None:
            break
    del model, state, step
    torch.cuda.empty_cache()
    check(chosen is not None, f"no batch of {PRETRAIN_BATCHES} fits: {tried}")
    return chosen, tried


def phase_pretrain(card: str):
    """HowTo100M pretraining at full width through ``train/dvc_main.main``:
    ``configs/htm_pretrain.json`` (T5-base with ReLU, ViT 12 x 768, bf16
    compute, ``genasr``: the generative pass sees the video alone; the
    denoising pass the span-corrupted ASR) with bf16 Adam moments, over a
    synthetic HowTo100M layout tokenized by a synthetic SentencePiece model
    of T5-base's 32,100 text ids through the native encoder (the Python
    Viterbi raises here). The recipe's batch 64 if a step fits on the card,
    else the largest power of two that does; one epoch of 1 warm-up + 3
    timed steps; the fused-attention launches exactly ``fused_per_step``
    each; ``log.txt`` and ``last`` and no ``best``; an ``eval_only`` rerun
    that resumes from ``last`` with the moments restored as bf16. Then an
    fp32 gradient check of one genasr step at 2+2 layers."""
    import contextlib

    import numpy as np
    import torch

    from vidchapters_tpu_torch.data import native_spm
    from vidchapters_tpu_torch.data.dvc_dataset import EpochIterator, YTPretrainDataset
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceUnigramTokenizer
    from vidchapters_tpu_torch.ops import fused_attention as fa
    from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.train import dvc_main

    check(native_spm.is_available(), "the native SentencePiece encoder does not build")
    steps, restored = [], []
    real_make_step, real_restore = dvc_main.make_train_step, CheckpointManager.restore
    real_viterbi = SentencePieceUnigramTokenizer._viterbi

    def python_viterbi(self, s):
        raise SmokeFailure("the tokenizer fell back to the Python Viterbi in phase 8")

    def timed_make_step(*a, **k):
        step = real_make_step(*a, **k)

        def timed(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(state, batch, seed)
            torch.cuda.synchronize()
            steps.append((time.time() - t0) * 1e3)
            return m

        return timed

    def checked_restore(self, name, state):
        real_restore(self, name, state)
        restored.append(sorted({str(m.dtype) for m in state.optimizer.mu}))

    n_steps = 1 + PRETRAIN_STEPS
    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.time()
        _write_htm_dataset(root, n_videos=PRETRAIN_BATCHES[0] * n_steps)
        cfg = _pretrain_cfg(root, PRETRAIN_BATCHES[0])
        tok = SentencePieceUnigramTokenizer(cfg.tokenizer_path, num_bins=cfg.model.num_bins,
                                            use_native=True)
        check(len(tok) == cfg.model.t5.vocab_size,
              f"tokenizer vocabulary {len(tok)} != the model's {cfg.model.t5.vocab_size}")
        ds = YTPretrainDataset.from_csv(cfg.datasets["htm"].train_json_path,
                                        cfg.datasets["htm"].features_path, tok,
                                        cfg.datasets["htm"].subtitles_path, cfg.data)
        lens = [len(ds[i]["output_tokens"]) for i in range(4)]
        check(min(lens) >= cfg.data.max_input_tokens,
              f"the ASR of a video gives {lens} tokens, not {cfg.data.max_input_tokens}")
        say(f"[pretrain] synthetic HowTo100M layout: {len(ds)} videos, 8 shards, "
            f"{len(tok)} ids, in {time.time() - t0:.1f} s")
        SentencePieceUnigramTokenizer._viterbi = python_viterbi
        try:
            bs, tried = _largest_batch_that_fits(cfg, ds)
            # one epoch of n_steps batches: the first bs * n_steps videos
            rows = (root / "htm.csv").read_text().splitlines()
            (root / "epoch.csv").write_text("\n".join(rows[:1 + bs * n_steps]) + "\n")
            cfg = _pretrain_cfg(root, bs, "epoch.csv")
            want = fused_per_step(cfg.model, cfg.data, cfg.train.genasr)
            dvc_main.make_train_step, CheckpointManager.restore = timed_make_step, checked_restore
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in (fa.KERNEL, fa.BWD_KERNEL):
                kern.launches = 0
            calls0 = native_spm.NativeSpmEncoder.calls
            tee = _Tee(sys.stdout)
            t0 = time.time()
            with contextlib.redirect_stdout(tee):
                got = dvc_main.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {"fused_attention_fwd": fa.KERNEL.launches,
                        "fused_attention_bwd": fa.BWD_KERNEL.launches}
            peak = torch.cuda.max_memory_allocated()
            native_calls = native_spm.NativeSpmEncoder.calls - calls0
            with contextlib.redirect_stdout(tee):
                again = dvc_main.main(cfg, eval_only=True, device=DEVICE)
            printed = "".join(tee.parts)
        finally:
            SentencePieceUnigramTokenizer._viterbi = real_viterbi
            dvc_main.make_train_step, CheckpointManager.restore = real_make_step, real_restore
        ckpt = root / "ckpt"
        log = (ckpt / "log.txt").read_text().splitlines()
        check(got == {} and again == {}, f"dvc_main on htm returned {got}, then {again}")
        check(len(log) == 1 and json.loads(log[0])["epoch"] == 0, f"log.txt: {log}")
        stats = json.loads(log[0])
        check(all(np.isfinite(stats[k]) for k in ("train_loss", "train_denoising_loss",
                                                  "train_total_loss")), f"log.txt: {stats}")
        check((ckpt / "last").exists() and not (ckpt / "best").exists(),
              f"save dir holds {sorted(p.name for p in ckpt.iterdir())}")
        check("resumed from epoch 0" in printed and restored == [["torch.bfloat16"]],
              f"the rerun did not resume with bf16 moments: restored {restored}")
        check(len(steps) == n_steps, f"{len(steps)} train steps, expected {n_steps}")
        check(native_calls >= bs * n_steps * 90,
              f"the native encoder ran {native_calls} times for {bs * n_steps} videos")
        for name, count in launches.items():
            check(count == want * n_steps, f"{name}: {count} launches in {n_steps} steps, "
                                           f"expected {want} per step")
        timed = steps[1:]
        summary.update(
            batch=bs, batch_trials=tried, steps=n_steps, step_ms=steps,
            step_ms_mean_timed=sum(timed) / len(timed),
            videos_per_s=bs * len(timed) / (sum(timed) / 1e3), wall_s=wall,
            peak_memory_bytes=peak, fused_per_step=want, launches=launches,
            native_spm_calls=native_calls, checkpoint_bytes=(ckpt / "last").stat().st_size,
            log=stats)
        say(f"[pretrain] {json.dumps(summary)}")
        host_batch = next(iter(EpochIterator(ds, 2, cfg.data, seed=cfg.train.seed)))
    torch.cuda.empty_cache()
    summary["fp32_grad_check"] = pretrain_fp32_grad_check(cfg, host_batch)
    return summary, launches


def pretrain_fp32_grad_check(cfg, host_batch):
    """One genasr step (generative on the video alone + denoising) in fp32
    at dropout 0, full width and 2+2 layers (ViT depth 2), bf16 Adam moments,
    on 2 examples: the kernels on the card against the plain versions on the
    CPU from the same weights; the loss within 1e-4 and every gradient within
    1e-3 of its norm (phase 3's tolerance). Then a second step on the card
    (the first update's learning rate is the warm-up's 0): its parameters
    must equal, within fp32 rounding (rtol 1e-6, atol 1e-7), the CPU
    optimizer and time-token renorm applied to the card's own gradients from
    the same state, and its bf16 ``mu`` must be within two bf16 ulps of
    theirs (``within``: the clip's global norm is summed in another order)."""
    import torch

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import fused_attention as fa
    from vidchapters_tpu_torch.train.dvc_train import (
        BATCH_FIELDS,
        TrainState,
        batch_to_device,
        make_train_step,
        renorm_time_tokens,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    t5 = dataclasses.replace(cfg.model.t5, dtype="float32", num_layers=2, num_decoder_layers=2,
                             dropout_rate=0.0, encoder_dropout=0.0, decoder_dropout=0.0)
    vit = dataclasses.replace(cfg.model.vit, dtype="float32", depth=2)
    mcfg = dataclasses.replace(cfg.model, t5=t5, vit=vit)
    weights = Vid2Seq(mcfg).init_weights(torch.Generator().manual_seed(1)).state_dict()
    sub = {k: host_batch[k][:2] for k in BATCH_FIELDS if k in host_batch}
    want = fused_per_step(mcfg, cfg.data, True)
    out = {}
    for path, dev in (("kernels", DEVICE), ("plain", "cpu")):
        model = Vid2Seq(mcfg)
        model.load_state_dict(weights)
        model.to(dev)
        state = TrainState(model, build_optimizer(cfg.train.optim, 100, model.parameters()))
        step = make_train_step(model, genasr=True)
        batch = batch_to_device(sub, dev)
        fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
        loss = float(step(state, batch, 0)["total_loss"])
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        out[path] = (loss, grads, fa.KERNEL.launches - fwd0, fa.BWD_KERNEL.launches - bwd0)
        if path == "kernels":
            snap = ({n: p.detach().cpu().clone() for n, p in model.named_parameters()},
                    {k: ([t.cpu().clone() for t in v] if isinstance(v, list) else v)
                     for k, v in state.optimizer.state_dict().items()})
            step(state, batch, 0)
            after = ({n: p.detach().cpu() for n, p in model.named_parameters()},
                     [m.cpu() for m in state.optimizer.mu],
                     {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        del model, state
    loss_k, g_k, fwd_n, bwd_n = out["kernels"]
    loss_p, g_p, _, _ = out["plain"]
    check(fwd_n == want and bwd_n == want, f"fp32 genasr check launched {fwd_n} / {bwd_n} "
                                           f"fused fwd / bwd kernels, expected {want} each")
    rel = {n: float((g_k[n] - g_p[n]).norm() / max(float(g_p[n].norm()), 1e-30)) for n in g_p}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)

    # the card's second step replayed on the CPU from the same state and gradients
    replay = Vid2Seq(mcfg)
    replay.load_state_dict({**weights, **snap[0]})
    opt = build_optimizer(cfg.train.optim, 100, replay.parameters())
    opt.load_state_dict(snap[1])
    for n, p in replay.named_parameters():
        p.grad = after[2][n]
    opt.step()
    renorm_time_tokens(replay, mcfg.num_bins)
    param_err = {n: float((after[0][n] - p.detach()).abs().max())
                 for n, p in replay.named_parameters()
                 if not torch.allclose(after[0][n], p.detach(), rtol=1e-6, atol=1e-7)}
    mu_ok = all(m.dtype == torch.bfloat16 and within(m, r, 0.0)
                for m, r in zip(after[1], opt.mu))
    moved = sum(not torch.equal(after[0][n], snap[0][n]) for n in snap[0])
    say(f"[fp32-grad] genasr: loss rel diff {loss_rel:.2e} (tol 1e-4); {len(rel)} gradients, "
        f"worst {worst} at {rel[worst]:.2e} of its norm (tol 1e-3); second step: {moved} "
        f"parameters moved, {len(param_err)} off the CPU replay, bf16 mu within two ulps: "
        f"{mu_ok}")
    check(loss_rel <= 1e-4, f"fp32 genasr loss kernels {loss_k} vs plain {loss_p}")
    check(rel[worst] <= 1e-3, f"fp32 genasr gradient {worst}: {rel[worst]:.2e} of its norm")
    check(not param_err, f"parameters after the step off the CPU replay: {param_err}")
    check(mu_ok, "bf16 mu after the step off the CPU replay by more than two bf16 ulps")
    check(moved == len(snap[0]), f"only {moved} of {len(snap[0])} parameters moved")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": loss_rel,
            "n_gradients": len(rel), "worst_gradient": worst, "worst_rel_err": rel[worst],
            "fused_per_step": want, "params_after_step_vs_cpu_replay": "within fp32 rounding",
            "mu_after_step": "bf16, within two bf16 ulps of the CPU replay",
            "depth": "T5 2+2 layers, ViT 2, full width, 2 examples, genasr, bf16 mu"}


def _reference_name(port: str) -> str:
    """The reference Vid2Seq's name (HF T5 under ``t5_model.``, the reference
    ViT under ``visual_encoder.``) of the port's parameter ``port``; both
    keep torch's ``[out, in]`` layout, so no tensor is transposed."""
    import re

    m = re.fullmatch(r"t5\.(encoder|decoder)\.blocks\.(\d+)\.(\w+)\.(.+)", port)
    if m:
        stack, i, sub, rest = m.groups()
        ff = 2 if stack == "decoder" else 1
        base = f"t5_model.{stack}.block.{i}.layer"
        return {"self_attn_norm": f"{base}.0.layer_norm.{rest}",
                "self_attn": f"{base}.0.SelfAttention.{rest}",
                "cross_attn_norm": f"{base}.1.layer_norm.{rest}",
                "cross_attn": f"{base}.1.EncDecAttention.{rest}",
                "ff_norm": f"{base}.{ff}.layer_norm.{rest}",
                "ff": f"{base}.{ff}.DenseReluDense.{rest}"}[sub]
    m = re.fullmatch(r"t5\.(encoder|decoder)\.(final_norm\.weight|rel_bias\.rel_embedding)",
                     port)
    if m:
        stack, leaf = m.groups()
        return (f"t5_model.{stack}.final_layer_norm.weight" if leaf.startswith("final")
                else f"t5_model.{stack}.block.0.layer.0.SelfAttention."
                     f"relative_attention_bias.weight")
    if port.startswith("t5."):
        return "t5_model." + port[3:]  # shared, lm_head
    m = re.fullmatch(r"visual_encoder\.blocks\.(\d+)\.(fc1|fc2)\.(\w+)", port)
    if m:
        return f"visual_encoder.blocks.{m.group(1)}.mlp.{m.group(2)}.{m.group(3)}"
    return port  # the rest of visual_encoder.* and proj_v2t.* keep their names


def _write_reference_pth(path: Path, mcfg, seed: int = 0):
    """``torch.save`` a reference Vid2Seq checkpoint of ``mcfg``: the port's
    seeded random weights (``init_weights``: T5's and the ViT's own scales)
    under the reference's names, with a DDP ``module.`` prefix and HF's tied
    copies of the embedding, an ``optimizer``, an ``epoch`` and an ``args``
    Namespace. Returns ``{port name: tensor}``. (Weights drawn N(0, 0.05)
    everywhere give logits of std 0.05, whose greedy choices sit 1e-4 apart:
    fp32 sums in another order flip them.)"""
    import argparse

    import torch

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    port = Vid2Seq(mcfg).init_weights(torch.Generator().manual_seed(seed)).state_dict()
    ref = {_reference_name(n): t for n, t in port.items()}
    check(len(ref) == len(port), "two port parameters share a reference name")
    for copy in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
                 "lm_head.weight"):
        ref.setdefault("t5_model." + copy, ref["t5_model.shared.weight"])
    torch.save({"model": {"module." + k: v for k, v in ref.items()},
                "optimizer": {"state": {}, "param_groups": [{"lr": 3e-4}]}, "epoch": 9,
                "args": argparse.Namespace(model_name="t5-base", num_bins=100, max_feats=100,
                                           lr=3e-4, combine_datasets=["htm"])}, path)
    return port


def _serve_requests(engine, payloads):
    """``payloads`` posted at once to ``serve(engine)`` on 127.0.0.1 (no
    warm-up); returns the answers."""
    from vidchapters_tpu_torch.serve import serve

    box, ready = {}, threading.Event()
    server = threading.Thread(target=serve, daemon=True, kwargs=dict(
        engine=engine, host="127.0.0.1", port=0, warmup=False,
        on_ready=lambda httpd: (box.update(httpd=httpd), ready.set())))
    server.start()
    check(ready.wait(timeout=300), "server did not come up")
    port = box["httpd"].server_address[1]
    results = [None] * len(payloads)

    def work(i):
        try:
            results[i] = _post(port, payloads[i])
        except Exception as e:  # recorded and failed below
            results[i] = (None, repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    box["httpd"].shutdown()
    server.join(timeout=60)
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200 and isinstance(r[1].get("chapters"), list),
              f"request {i}: {r}")
    return results


def phase_reference_checkpoint(card: str):
    """A reference Vid2Seq ``.pth`` at T5-base width (``ExperimentConfig()``:
    T5-base with ReLU and tied embeddings, ViT 12 x 768), seeded random
    weights: imported by ``serve.load_serving_params`` (the ``--ckpt``
    path), every port parameter equal to its source tensor bit for bit; two
    1000-bucket requests served over HTTP with the fused attention, the
    top-k and the decode kernel each launched; fp32 greedy tokens, card
    against CPU, with the imported weights; and ``dvc_main.main(load=pth,
    eval_only=True)`` on phase 5's val set with finite metrics."""
    import contextlib

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import CheckpointConfig, DatasetPaths, ExperimentConfig
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import decode_megakernel, decoding, fused_attention
    from vidchapters_tpu_torch.serve import ChapterGenerator, load_serving_params
    from vidchapters_tpu_torch.train import dvc_main

    kernels = {"fused_attention_fwd": fused_attention.KERNEL, "topk": decoding.TOPK_KERNEL,
               "decode_megakernel": decode_megakernel.KERNEL}
    cfg = ExperimentConfig()
    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        pth = Path(tmp) / "vid2seq_howto100m.pth"
        t0 = time.time()
        source = _write_reference_pth(pth, cfg.model)
        summary["pth_bytes"] = pth.stat().st_size
        t1 = time.time()
        model = load_serving_params(Vid2Seq(cfg.model), str(pth))
        summary["write_s"], summary["import_s"] = t1 - t0, time.time() - t1
        state = model.state_dict()
        check(set(state) == set(source), "imported names differ from the model's")
        differ = [n for n, t in state.items() if not torch.equal(t, source[n])]
        check(not differ, f"imported parameters differ from their source: {differ[:5]}")
        say(f"[reference] {pth.name}: {summary['pth_bytes']} bytes, written in "
            f"{summary['write_s']:.1f} s, imported in {summary['import_s']:.1f} s; "
            f"{len(state)} parameters equal their source bit for bit")

        tok = build_tokenizer("", num_bins=cfg.model.num_bins)
        engine = ChapterGenerator(model, tok, cfg.data, cfg.generation, cfg.model.num_bins,
                                  device=DEVICE)
        rng = np.random.default_rng(8)
        payloads = [_request(i, True, rng) for i in range(2)]
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.time()
        results = _serve_requests(engine, payloads)
        launches = {n: k.launches for n, k in kernels.items()}
        summary["serve"] = {"requests": len(results), "wall_s": time.time() - t0,
                            "launches": launches,
                            "chapters": [len(r[1]["chapters"]) for r in results]}
        videos, tokens = _fp32_inputs(engine, payloads)
        engine.close()
        say(f"[reference] served {json.dumps(summary['serve'])}")
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched serving the imported weights")
        cpu_state = {k: v.detach().cpu().clone() for k, v in state.items()}
        del engine, model, state
        torch.cuda.empty_cache()
        gen1 = dataclasses.replace(cfg.generation, num_beams=1, max_length=64,
                                   repetition_penalty=3.0)
        seqs = {dev: _fp32_tokens(cfg, cpu_state, gen1, dev, videos, tokens,
                                  "imported greedy") for dev in (DEVICE, "cpu")}
        _same_tokens(seqs[DEVICE], seqs["cpu"], "imported weights, greedy, card vs CPU", cfg,
                     cpu_state, videos, tokens)
        summary["fp32_greedy_card_vs_cpu"] = "identical"
        say(f"[fp32] imported weights, greedy: identical over {list(seqs['cpu'].shape)}")

        root = Path(tmp) / "data"
        root.mkdir()
        _write_train_dataset(root, n_videos=16, n_val=8)  # phase 5's val set
        run_cfg = dataclasses.replace(
            cfg, datasets={"chapters": DatasetPaths(
                train_json_path=str(root / "ann.json"), val_json_path=str(root / "val.json"),
                features_path=str(root / "features"), subtitles_path=str(root / "asr.pkl"))},
            train=dataclasses.replace(cfg.train, eval_batch_size=8, print_freq=1,
                                      checkpoint=CheckpointConfig(save_dir=str(root / "ckpt"))))
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            metrics = dvc_main.main(run_cfg, load=str(pth), eval_only=True, device=DEVICE)
        summary["dvc_main_eval"] = {"wall_s": time.time() - t0, "metrics": metrics}
        printed = "".join(tee.parts)
    missing = [m for m in EVAL_METRICS if not np.isfinite(
        metrics.get(f"chapters_{m}", float("nan")))]
    check(not missing, f"dvc_main --load <pth> --eval: metrics missing or not finite: {missing}")
    check("imported reference checkpoint" in printed and "resumed from" not in printed,
          "dvc_main --load did not import the reference checkpoint")
    say(f"[reference] dvc_main --load --eval: {json.dumps(summary['dvc_main_eval'])}")
    return summary, launches


# ---------------------------------------------------------------------------
# phase 9: VC (chapter titles from ground-truth boundaries) through vc_main
# ---------------------------------------------------------------------------

VC_TRAIN_VIDEOS = 48       # 3 steps of vc_main's batch 16 in one epoch
VC_VAL_VIDEOS = 4          # 4 generate calls an eval
VC_VAL_CHAPTERS = 16       # a val video's clips: one generate call of 16 clips x 4 beams
VC_METRICS = ("CIDEr", "METEOR", "Bleu_4", "ROUGE_L")


def _write_vc_dataset(root: Path, n_train: int, n_val: int, val_chapters: int,
                      seed: int = 0) -> Path:
    """Features at one frame a second (``[T, 768]``, T the duration), an ASR
    pickle of a 4-second segment every 6 s, ``train.json`` of ``n_train``
    videos of 3-8 chapters of 15-40 s and ``val.json`` of ``n_val`` videos
    of ``val_chapters`` chapters, each with its title."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "features").mkdir()
    splits, asr = ({}, {}), {}
    words = ("whisk", "eggs", "flour", "dough", "knead", "rest", "bake", "oven", "slice",
             "serve", "intro", "sauce")
    for i in range(n_train + n_val):
        vid = f"vcvid{i:06d}"
        n_ch = int(rng.integers(3, 9)) if i < n_train else val_chapters
        bounds = np.concatenate([[0.0], np.cumsum(rng.uniform(15.0, 40.0, n_ch))])
        dur = float(bounds[-1])
        np.save(root / "features" / f"{vid}.npy",
                rng.standard_normal((int(dur), 768)).astype(np.float32))
        splits[int(i >= n_train)][vid] = {
            "duration": dur,
            "timestamps": [[float(a), float(b)] for a, b in zip(bounds[:-1], bounds[1:])],
            "sentences": [f"Step {j}: " + " ".join(rng.choice(words, int(rng.integers(2, 6))))
                          for j in range(n_ch)]}
        st = np.arange(0.0, dur - 4.0, 6.0)
        asr[vid] = {"text": [" ".join(rng.choice(words, 8)) for _ in st],
                    "start": st.tolist(), "end": (st + 4.0).tolist()}
    for name, ann in zip(("train", "val"), splits):
        (root / f"{name}.json").write_text(json.dumps(ann))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root


def vc_fused_per_pass(mcfg, data, out_len: int = 0) -> int:
    """Fused-attention forward launches of one VC forward pass (route of
    ``models/t5.T5Attention``, as ``fused_per_step`` counts it): the
    encoder's self-attention over ``max_input_tokens`` padded to
    SEQ_PAD_BLOCK, and, for a train step (``out_len`` the batch's title
    bucket), the decoder's self- and cross-attention. A generate call's
    decoder runs on the decode kernel (``out_len`` 0)."""
    from vidchapters_tpu_torch.models.t5 import CHUNK, SEQ_PAD_BLOCK

    def pad(n):
        return -(-n // SEQ_PAD_BLOCK) * SEQ_PAD_BLOCK

    def fused(lq, lk):
        return int(lq > CHUNK and lq * lk > 512 * 512)

    lin = pad(data.max_input_tokens)
    n = mcfg.t5.num_layers * fused(lin, lin)
    if out_len:
        n += mcfg.t5.num_decoder_layers * (
            fused(out_len, out_len) + fused(out_len, pad(data.max_feats + data.max_input_tokens)))
    return n


def vc_fp32_token_check(mcfg, data, ds):
    """Beam-4 tokens at max_length 32 of one generate call of 16 clips (the
    first val video's), fp32 at 2+2 layers (ViT depth 2) with seeded
    weights: the kernels on the card against the plain versions on the CPU
    (repetition penalty 3.0, so that the random model's 32 decisions a
    hypothesis are distinct)."""
    import types

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.vc_train import tokenize_batch

    small = dataclasses.replace(mcfg, t5=dataclasses.replace(mcfg.t5, num_layers=2,
                                                             num_decoder_layers=2),
                                vit=dataclasses.replace(mcfg.vit, depth=2))
    state = Vid2Seq(small).init_weights(torch.Generator().manual_seed(9)).state_dict()
    ex = ds[0]
    videos = np.asarray(ex["video"][:16], np.float32)
    tokens = tokenize_batch(ex["input_text"][:16], build_tokenizer(""), data.max_input_tokens)
    gen = GenerationConfig(num_beams=4, max_length=32, repetition_penalty=3.0)
    cfg = types.SimpleNamespace(model=small)
    out = {label: _fp32_tokens(cfg, state, gen, dev, videos, tokens, f"VC beam 4, {label}")
           for label, dev in (("kernels", DEVICE), ("plain", "cpu"))}
    _same_tokens(out["kernels"], out["plain"], "VC beam 4, card vs CPU", cfg, state, videos,
                 tokens)
    say(f"[vc-fp32] beam-4 tokens identical card vs CPU over {list(out['plain'].shape)}")
    return {"identical": True, "shape": list(out["plain"].shape), "depth": "2+2, ViT 2"}


def phase_vc(card: str, phase5_weights, mcfg=None, n_train: int = VC_TRAIN_VIDEOS,
             n_val: int = VC_VAL_VIDEOS, val_chapters: int = VC_VAL_CHAPTERS):
    """VC at T5-base width (``ExperimentConfig()``'s model, bf16 compute)
    through ``train/vc_main.main``: one epoch at vc_main's batch 16 over a
    synthetic set (``n_train`` videos: 3 steps), the val eval and the final
    eval (``best``) at beam 4 / max_length 32, 16 clips a generate call
    (64 decode rows). Checks ``best`` / ``last`` / ``log.txt`` and finite
    CIDEr / METEOR / BLEU / ROUGE-L; the launches exactly: the fused
    attention's forward ``vc_fused_per_pass`` a train step (each with one
    backward) and 12 a generate call (the encoder), the top-k and the
    decode kernel once a decode step (the steps counted as the beam search
    runs them: 32 a call unless every beam finishes early). Then fp32
    beam tokens card vs CPU, ``strip_time_tokens`` of phase 5's ``best``
    weights into a text-only-vocab VC model, and ``--eval --model-type
    random``."""
    import contextlib
    import io

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import DataConfig, ExperimentConfig, GenerationConfig
    from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.ops import decode_megakernel, decoding, fused_attention
    from vidchapters_tpu_torch.train import dvc_train, vc_main, vc_train
    from vidchapters_tpu_torch.train.vc_train import strip_time_tokens

    mcfg = mcfg or ExperimentConfig().model
    data = DataConfig()
    gen = GenerationConfig(num_beams=4, max_length=32)
    kernels = {"fused_attention_fwd": fused_attention.KERNEL,
               "fused_attention_bwd": fused_attention.BWD_KERNEL,
               "topk": decoding.TOPK_KERNEL, "decode_megakernel": decode_megakernel.KERNEL}
    steps, evals, decode_steps, calls = [], [], [], []
    real = (vc_main.make_vc_train_step, vc_main.evaluate_vc, dvc_train._pick_decode_fns,
            vc_train.make_generate_fn)

    def timed_make_step(*a, **k):
        step = real[0](*a, **k)

        def timed(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(state, batch, seed)
            torch.cuda.synchronize()
            steps.append({"ms": (time.time() - t0) * 1e3,
                          "out_len": int(batch["output_tokens"].shape[1])})
            return m

        return timed

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real[1](*a, **k)
        torch.cuda.synchronize()
        evals.append({"clips": len(out[0]), "wall_s": time.time() - t0})
        return out

    def counted_pick(*a, **k):  # one entry per decode step the beam search runs
        fns = real[2](*a, **k)

        def step(*sa, **sk):
            decode_steps.append(1)
            return fns.step(*sa, **sk)

        return fns._replace(step=step)

    def counted_generate_fn(*a, **k):  # one entry per generate call
        generate = real[3](*a, **k)

        def call(*ga, **gk):
            calls.append(ga[0].shape[0])
            return generate(*ga, **gk)

        return call

    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_vc_dataset(Path(tmp), n_train, n_val, val_chapters)
        save = Path(tmp) / "ckpt"
        vc_main.make_vc_train_step, vc_main.evaluate_vc = timed_make_step, timed_evaluate
        dvc_train._pick_decode_fns, vc_train.make_generate_fn = counted_pick, counted_generate_fn
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.time()
            metrics = vc_main.main(str(root / "train.json"), str(root / "val.json"),
                                   str(root / "features"), mcfg, data, str(save),
                                   subtitles_path=str(root / "asr.pkl"), n_epochs=1,
                                   batch_size=16, generation=gen, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: k.launches for n, k in kernels.items()}
            peak = torch.cuda.max_memory_allocated()
        finally:
            (vc_main.make_vc_train_step, vc_main.evaluate_vc, dvc_train._pick_decode_fns,
             vc_train.make_generate_fn) = real
        log = (save / "log.txt").read_text().splitlines()
        check(len(log) == 1 and json.loads(log[0])["epoch"] == 0, f"log.txt: {log}")
        for name in ("best", "last"):
            check((save / name).exists(), f"vc_main wrote no {name}")
        bad = [m for m in VC_METRICS if not np.isfinite(metrics.get(m, float("nan")))]
        check(not bad, f"vc_main: metrics missing or not finite: {bad} in {metrics}")
        n_steps = n_train // 16
        check(len(steps) == n_steps, f"{len(steps)} VC train steps, expected {n_steps}")
        n_clips = n_val * val_chapters
        want_calls = 2 * n_val * -(-val_chapters // 16)  # the val eval and the final eval
        check(len(evals) == 2 and all(e["clips"] == n_clips for e in evals),
              f"evals {evals}: expected 2 of {n_clips} clips")
        check(len(calls) == want_calls and max(calls) == min(16, val_chapters),
              f"{len(calls)} generate calls of {sorted(set(calls))} clips, expected "
              f"{want_calls} of up to 16")
        train_fwd = sum(vc_fused_per_pass(mcfg, data, s["out_len"]) for s in steps)
        want = {"fused_attention_fwd": train_fwd + want_calls * vc_fused_per_pass(mcfg, data),
                "fused_attention_bwd": train_fwd, "topk": len(decode_steps),
                "decode_megakernel": len(decode_steps)}
        check(launches == want, f"VC launches {launches}, expected {want} (decode steps "
                                f"{len(decode_steps)} in {want_calls} calls)")
        check(0 < len(decode_steps) <= want_calls * gen.max_length,
              f"{len(decode_steps)} decode steps in {want_calls} calls")
        val_ds = VideoCaptioningDataset(str(root / "val.json"), str(root / "features"),
                                        training=False, cfg=data,
                                        subtitles_path=str(root / "asr.pkl"))
        step_ms = [s["ms"] for s in steps]
        timed = step_ms[1:] or step_ms
        final = evals[-1]
        summary.update(
            steps=steps, step_ms_mean_after_first=sum(timed) / len(timed),
            eval_clips_per_s=[e["clips"] / e["wall_s"] for e in evals],
            eval_wall_s=[e["wall_s"] for e in evals], generate_calls=len(calls),
            decode_steps=len(decode_steps), decode_rows=max(calls) * gen.num_beams,
            wall_s=wall, peak_memory_bytes=peak, launches=launches, expected_launches=want,
            metrics=metrics, checkpoint_bytes=(save / "last").stat().st_size)
        say(f"[vc] {json.dumps(summary)}")
        say(f"[vc] {summary['step_ms_mean_after_first']:.1f} ms a train step (batch 16), eval "
            f"{n_clips / final['wall_s']:.2f} clips/s (beam 4, max_length 32, 16 clips a "
            f"call), peak {peak} B on {card}")
        torch.cuda.empty_cache()
        summary["fp32_tokens"] = vc_fp32_token_check(mcfg, data, val_ds)

        # a DVC checkpoint of phase 5, stripped of its time tokens, loads into a
        # VC model of the text-only vocab (vc.py:304-308)
        stripped = strip_time_tokens(phase5_weights, mcfg.num_bins)
        vc_cfg = dataclasses.replace(mcfg, t5=dataclasses.replace(
            mcfg.t5, vocab_size=mcfg.t5.vocab_size - mcfg.num_bins))
        with torch.device("meta"):
            vc_model = Vid2Seq(vc_cfg)
        vc_model.load_state_dict(stripped, assign=True)
        summary["stripped_embedding"] = list(stripped["t5.shared.weight"].shape)
        del stripped, vc_model

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            vc_main._cli(["--val-json", str(root / "val.json"), "--features-path",
                          str(root / "features"), "--save-dir", str(save), "--subtitles-path",
                          str(root / "asr.pkl"), "--eval", "--model-type", "random"])
        random_metrics = json.loads(out.getvalue().strip().splitlines()[-1])
        bad = [m for m in VC_METRICS if not np.isfinite(random_metrics.get(m, float("nan")))]
        check(not bad, f"--eval --model-type random: not finite: {bad} in {random_metrics}")
        summary["random_eval"] = random_metrics
    say(f"[vc] stripped embedding {summary['stripped_embedding']} loads into a VC model; "
        f"--model-type random: {random_metrics}")
    return summary, launches


# ---------------------------------------------------------------------------
# phase 10: Moment-DETR chapter grounding through grounding_main
# ---------------------------------------------------------------------------

GROUNDING_RECIPE = "configs/chapters_momentdetr.json"
GROUNDING_BATCHES = (256, 128, 64, 32)  # the recipe's batch, then the powers of two below it
GROUNDING_VIDEOS = 32                   # x 24 chapters: 768 train queries, 3 steps of 256
GROUNDING_CHAPTERS = 24
GROUNDING_EVAL_ROWS = 64                # val and test queries
GROUNDING_METRICS = ("MR-full-mAP", "MR-full-R1@0.5", "MR-full-R1@0.7", "MR-full-R1@10s")


def _write_vmr_dataset(root: Path, n_videos: int, chapters: int, n_eval: int,
                       seed: int = 0) -> Path:
    """Per-video CLIP features ``[T, 768]`` at one a second (T the duration,
    600-3600 s, the first 3600 s: the recipe's clip_length 3 keeps every
    third, at most max_v_l 1200 clips), ``train.jsonl`` of one query a chapter (its title
    and window), ``val.jsonl`` and ``test.jsonl`` of ``n_eval`` of them, and
    an ASR pickle of a 6-second segment every 10 s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "features").mkdir()
    rows, asr = [], {}
    words = ("whisk", "eggs", "flour", "dough", "knead", "rest", "bake", "oven", "slice",
             "serve", "intro", "sauce", "review", "unboxing", "setup", "final")
    for i in range(n_videos):
        vid = f"mdvid{i:06d}"
        dur = 3600.0 if i == 0 else float(rng.integers(600, 3601))  # video 0 fills max_v_l
        np.save(root / "features" / f"{vid}.npy",
                rng.standard_normal((int(dur), 768), dtype=np.float32))
        bounds = np.linspace(0.0, dur, chapters + 1)
        for j in range(chapters):
            title = " ".join(rng.choice(words, int(rng.integers(2, 7))))
            rows.append({"qid": len(rows), "query": f"chapter {j}: {title}", "vid": vid,
                         "duration": dur,
                         "relevant_windows": [[float(bounds[j]), float(bounds[j + 1])]]})
        st = np.arange(0.0, dur - 6.0, 10.0)
        asr[vid] = {"text": [" ".join(rng.choice(words, 10)) for _ in st],
                    "start": st.tolist(), "end": (st + 6.0).tolist()}
    picks = rng.permutation(len(rows))
    for name, part in (("train", rows), ("val", [rows[k] for k in picks[:n_eval]]),
                       ("test", [rows[k] for k in picks[n_eval:2 * n_eval]])):
        (root / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in part) + "\n")
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root


_OPENAI_TOP = {"token_embedding": "token_embedding.weight", "patch_embed.weight": "conv1.weight"}
_OPENAI_PARTS = {"ln_1": "ln_1", "ln_2": "ln_2", "attn_in": "attn.in_proj_",
                 "attn_out": "attn.out_proj", "mlp_fc": "mlp.c_fc", "mlp_proj": "mlp.c_proj"}


def _openai_clip_names(state, prefix: str = ""):
    """A port CLIP tower's ``state_dict`` under OpenAI's ``clip`` names
    (``prefix`` "visual." for the image tower)."""
    out = {}
    for name, t in state.items():
        if name.startswith("blocks."):  # blocks.{i}.{part}.{leaf}
            _, i, part, leaf = name.split(".")
            oa = _OPENAI_PARTS[part]
            name = f"transformer.resblocks.{i}." + (oa + leaf if oa.endswith("_")
                                                     else f"{oa}.{leaf}")
        out[prefix + _OPENAI_TOP.get(name, name)] = t
    return out


def _write_clip_text_checkpoint(path: Path, seed: int = 0):
    """A state dict of CLIP ViT-L/14's text tower (12 layers of width 768, 12
    heads, context 77, vocab 49,408) under OpenAI's names, with seeded
    random weights (the text tower's init laws) and the model's
    ``logit_scale``: the form ``torch.load`` reads."""
    import torch

    from vidchapters_tpu_torch.models.clip import TEXT_L14, CLIPTextEncoder

    tower = CLIPTextEncoder(TEXT_L14).init_weights(torch.Generator().manual_seed(seed))
    torch.save({"logit_scale": torch.tensor(4.6052), **_openai_clip_names(tower.state_dict())},
               path)
    return tower.state_dict()


def _grounding_batch_that_fits(cfg, text_encoder, ds, tokenizer, candidates):
    """The first of ``candidates`` (the recipe's batch 256, then the powers
    of two below it) at which one train step fits on the card: (batch,
    {batch: outcome})."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.train import grounding_main as gm
    from vidchapters_tpu_torch.train.grounding_train import (
        GroundingTrainState,
        build_grounding_optimizer,
        grounding_batch_to_device,
        make_grounding_train_step,
    )

    model = MomentDETR(cfg).init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
    state = GroundingTrainState(model, build_grounding_optimizer(model.parameters()))
    step = make_grounding_train_step(model, text_encoder, cfg)
    tok = lambda qs: np.asarray(tokenizer(qs))  # noqa: E731
    tried, chosen = {}, None
    for bs in candidates:
        batch = next(gm.batches(ds, bs, cfg.max_v_l, 5, False, 0, tok, max_q_l=cfg.max_q_l))
        torch.cuda.reset_peak_memory_stats()
        try:
            step(state, grounding_batch_to_device(batch, DEVICE), 0)
            torch.cuda.synchronize()
            tried[bs] = {"fits": True, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            chosen = bs
        except torch.cuda.OutOfMemoryError as e:
            tried[bs] = {"fits": False, "error": str(e).splitlines()[0][:160]}
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        say(f"[grounding] batch {bs}: {tried[bs]}")
        if chosen is not None:
            break
    del model, state, step
    torch.cuda.empty_cache()
    check(chosen is not None, f"no batch of {candidates} fits: {tried}")
    return chosen, tried


def grounding_fp32_grad_check(cfg, host_batch):
    """One train step's losses and gradients in fp32 at a narrow width
    (hidden 64, d_ff 256, the recipe's 8 heads, 2+2 layers, 10 queries, TEF,
    max_v_l 1200) with dropout 0, on 4 queries with seeded text features:
    the CPU, then the card, from the same weights. The matcher's
    assignments are compared first; where they differ the card's costs
    under the CPU's cost matrix must be a near-tie (within 2 x targets x
    1e-4), and the card's loss takes the CPU's assignments, so that the
    gradients compare one function. The loss within 1e-5 relative and every
    gradient within 1e-4 of its norm (+1e-6 for the key biases' gradients,
    0 up to rounding)."""
    import torch

    from vidchapters_tpu_torch.models import grounding as gr
    from vidchapters_tpu_torch.train.grounding_train import grounding_batch_to_device

    cfg0 = dataclasses.replace(cfg, hidden_dim=64, dim_feedforward=256, dtype="float32",
                               dropout=0.0, input_dropout=0.0)
    weights = gr.MomentDETR(cfg0).init_weights(torch.Generator().manual_seed(2)).state_dict()
    g = torch.Generator().manual_seed(3)
    txt = torch.randn(4, 77, cfg0.t_feat_dim, generator=g)
    txt_mask = torch.from_numpy(host_batch["query_tokens"] != 0).to(torch.int32)
    res, matching = {}, {}
    real_match = gr.match_layers
    for path, dev in (("plain", "cpu"), ("kernels", DEVICE)):
        model = gr.MomentDETR(cfg0)
        model.load_state_dict(weights)
        model.to(dev)
        b = grounding_batch_to_device(host_batch, dev)
        t0 = time.time()
        out = model(txt.to(dev), txt_mask.to(dev), b["video_feat"], b["video_mask"])
        layers = [(out["pred_logits"], out["pred_spans"])] + [
            (a["pred_logits"], a["pred_spans"]) for a in out["aux_outputs"]]
        assigns = [a.cpu() for a in real_match(layers, b["spans"], b["span_valid"], cfg0)]
        if path == "plain":
            costs = [gr.match_cost(lg, sp, b["spans"], cfg0) for lg, sp in layers]
        else:
            valid = b["span_valid"].cpu() > 0
            for lid, (ak, ap) in enumerate(zip(assigns, res["plain"][2])):
                if torch.equal(ak, ap):
                    continue
                gap = 0.0
                for i in range(ak.shape[0]):
                    t_idx = torch.arange(valid.shape[1])[valid[i]]
                    gap += float(costs[lid][i][ak[i, valid[i]], t_idx].sum()
                                 - costs[lid][i][ap[i, valid[i]], t_idx].sum())
                tol = 2 * int(valid.sum()) * 1e-4
                matching[f"layer_{lid}"] = {"card": ak.tolist(), "cpu": ap.tolist(),
                                            "cost_gap_under_cpu_cost": gap}
                say(f"[grounding-fp32-grad] assignments differ card vs CPU at decoder layer "
                    f"{lid}; the card's cost {gap:.3e} more under the CPU's (tol {tol:.1e})")
                check(abs(gap) <= tol, f"grounding fp32 check: assignments differ at layer "
                                       f"{lid} by a cost of {gap}")
            forced = [a.to(DEVICE) for a in res["plain"][2]]
            gr.match_layers = lambda *a, **k: forced
        try:
            targets = {k: b[k] for k in ("spans", "span_valid", "saliency_pos_labels",
                                         "saliency_neg_labels")}
            total, _ = gr.grounding_loss(out, targets, cfg0)
        finally:
            gr.match_layers = real_match
        total.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in model.named_parameters()}
        res[path] = (float(total.detach()), grads, assigns)
        say(f"[grounding-fp32-grad] {path} on {dev}: {time.time() - t0:.1f} s, total "
            f"{res[path][0]:.6f}")
        del model, out, total
    loss_k, g_k, _ = res["kernels"]
    loss_p, g_p, _ = res["plain"]
    rel = {n: float((g_k[n] - g_p[n]).norm()) / max(float(g_p[n].norm()), 1e-30) for n in g_p}
    over = {n: float((g_k[n] - g_p[n]).norm()) - (1e-4 * float(g_p[n].norm()) + 1e-6)
            for n in g_p}
    worst = max(over, key=over.get)
    worst_rel = max((n for n in g_p if float(g_p[n].norm()) > 1e-3), key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    say(f"[grounding-fp32-grad] assignments {'identical' if not matching else matching}; "
        f"loss rel diff {loss_rel:.2e} (tol 1e-5); worst gradient {worst_rel} at "
        f"{rel[worst_rel]:.2e} of its norm (tol 1e-4)")
    check(loss_rel <= 1e-5, f"grounding fp32 loss card {loss_k} vs CPU {loss_p}")
    check(over[worst] <= 0, f"grounding fp32 gradient {worst}: {rel[worst]:.2e} of its norm")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": loss_rel,
            "assignments": matching or "identical", "n_gradients": len(rel),
            "worst_gradient": worst_rel, "worst_rel_err": rel[worst_rel],
            "shape": "hidden 64, 8 heads, 2+2 layers, 10 queries, 4 queries of max_v_l 1200"}


def grounding_speech_step(cfg, ds, tokenizer, bs: int = 16):
    """One train step of the recipe with ``use_speech`` on the card: the
    smoke-mode BERT speech tower (one layer at 768, a hash tokenizer) over
    each query's ASR (``speech_max_l`` tokens) beside a one-layer text
    tower; the loss finite and ``speech_proj`` given a gradient."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.train import grounding_main as gm
    from vidchapters_tpu_torch.train.grounding_train import (
        GroundingTrainState,
        build_grounding_optimizer,
        grounding_batch_to_device,
        make_grounding_train_step,
    )

    scfg = dataclasses.replace(cfg, use_speech=True)
    tower, sp_tok = gm.smoke_speech_tower(scfg)
    tower.to(DEVICE).requires_grad_(False)
    text = CLIPTextEncoder(CLIPTextConfig(layers=1)).init_weights(
        torch.Generator().manual_seed(0)).to(DEVICE).requires_grad_(False)
    model = MomentDETR(scfg).init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
    state = GroundingTrainState(model, build_grounding_optimizer(model.parameters()))
    batch = next(gm.batches(ds, bs, scfg.max_v_l, 5, False, 0,
                            lambda qs: np.asarray(tokenizer(qs)),
                            speech_featurizer=lambda t: sp_tok(t, max_length=scfg.speech_max_l),
                            max_q_l=scfg.max_q_l))
    check("speech_tokens" in batch and (batch["speech_tokens"] != 0).any(),
          "the speech batch holds no ASR tokens")
    m = make_grounding_train_step(model, text, scfg, tower)(
        state, grounding_batch_to_device(batch, DEVICE), 0)
    total = float(m["total"])
    grad = float(model.speech_proj.weight.grad.norm())
    check(np.isfinite(total) and grad > 0,
          f"speech step: loss {total}, speech_proj gradient norm {grad}")
    out = {"batch": bs, "speech_tokens": list(batch["speech_tokens"].shape), "total": total,
           "speech_proj_grad_norm": grad,
           "device": str(next(model.parameters()).device)}
    say(f"[grounding] use_speech step on {out['device']}: {out}")
    del model, state, tower, text
    return out


def phase_grounding(card: str, cfg=None, n_videos: int = GROUNDING_VIDEOS,
                    chapters: int = GROUNDING_CHAPTERS, n_eval: int = GROUNDING_EVAL_ROWS,
                    batches=GROUNDING_BATCHES):
    """Moment-DETR at ``configs/chapters_momentdetr.json`` (hidden 256, 8
    heads, 2+2 layers, 10 queries, max_v_l 1200, TEF, bf16 compute) with the
    12-layer CLIP ViT-L/14 text tower from a synthetic OpenAI-named state
    dict, through ``grounding_main``'s CLI (``--clip-text-ckpt``, the
    recipe's defaults with its data paths and batch replaced): the
    recipe's batch 256 if a step fits (else the largest power of two that
    does), one epoch over ``n_videos`` x ``chapters`` queries, the val eval,
    ``best`` / ``last`` / ``log.txt``, the final eval with ``best`` and the
    test split's ``test_preds.jsonl``; the brief metrics finite; ms a step
    and peak memory. Then an fp32 gradient check at a narrow width, card
    against CPU, and one ``use_speech`` step on the card."""
    import contextlib

    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import GroundingConfig
    from vidchapters_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vidchapters_tpu_torch.data.grounding_dataset import GroundingDataset
    from vidchapters_tpu_torch.models.clip import TEXT_L14, CLIPTextEncoder
    from vidchapters_tpu_torch.train import grounding_main as gm

    recipe = json.loads((ROOT / GROUNDING_RECIPE).read_text())
    cfg = cfg or dataclasses.replace(GroundingConfig(), **recipe["model"])
    steps = []
    real_make_step = gm.make_grounding_train_step

    def timed_make_step(*a, **k):
        step = real_make_step(*a, **k)

        def timed(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(state, batch, seed)
            torch.cuda.synchronize()
            steps.append((time.time() - t0) * 1e3)
            return m

        return timed

    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.time()
        _write_vmr_dataset(root, n_videos, chapters, n_eval)
        tower_sd = _write_clip_text_checkpoint(root / "clip_text.pt")
        say(f"[grounding] synthetic VMR set ({n_videos * chapters} train, {n_eval} val, "
            f"{n_eval} test queries) and a ViT-L/14 text checkpoint in {time.time() - t0:.1f} s")
        ds_kw = dict(max_v_l=cfg.max_v_l, clip_len=cfg.clip_length)
        train_ds = GroundingDataset(str(root / "train.jsonl"), [str(root / "features")],
                                    **ds_kw)
        lens = [train_ds[i]["video_feat"].shape for i in range(0, len(train_ds), chapters)]
        check(max(s[0] for s in lens) == cfg.max_v_l and all(s[1] == cfg.v_feat_dim
                                                              for s in lens),
              f"video features {sorted(set(lens))}: expected up to {cfg.max_v_l} x "
              f"{cfg.v_feat_dim}")
        tokenizer = CLIPTokenizer()
        text = CLIPTextEncoder(TEXT_L14)  # as the CLI builds it
        text.load_state_dict(tower_sd)
        text.to(DEVICE).requires_grad_(False)
        bs, tried = _grounding_batch_that_fits(cfg, text, train_ds, tokenizer, batches)
        del text
        torch.cuda.empty_cache()
        run = dict(recipe, train=dict(recipe["train"], batch_size=bs, epochs=1),
                   data={"train_jsonl": str(root / "train.jsonl"),
                         "val_jsonl": str(root / "val.jsonl"),
                         "test_jsonl": str(root / "test.jsonl"),
                         "v_feat_dirs": [str(root / "features")]},
                   model=dataclasses.asdict(cfg))
        (root / "recipe.json").write_text(json.dumps(run))
        save = root / "ckpt"
        gm.make_grounding_train_step = timed_make_step
        tee = _Tee(sys.stdout)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with contextlib.redirect_stdout(tee):
                gm._cli(["--recipe", str(root / "recipe.json"), "--save-dir", str(save),
                         "--clip-text-ckpt", str(root / "clip_text.pt"), "--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            gm.make_grounding_train_step = real_make_step
        metrics = json.loads("".join(tee.parts).strip().splitlines()[-1])
        n_steps = n_videos * chapters // bs
        check(len(steps) == n_steps, f"{len(steps)} grounding steps, expected {n_steps}")
        for name in ("best", "last", "log.txt", "test_preds.jsonl"):
            check((save / name).exists(), f"grounding_main wrote no {name}")
        log = [json.loads(line) for line in (save / "log.txt").read_text().splitlines()]
        check(len(log) == 1 and np.isfinite(log[0]["loss"]), f"log.txt: {log}")
        preds = (save / "test_preds.jsonl").read_text().splitlines()
        check(len(preds) == n_eval, f"test_preds.jsonl holds {len(preds)} rows, not {n_eval}")
        want = list(GROUNDING_METRICS) + [f"test_{m}" for m in GROUNDING_METRICS]
        bad = [m for m in want if not np.isfinite(metrics.get(m, float("nan")))]
        check(not bad, f"grounding metrics missing or not finite: {bad} in {metrics}")
        timed = steps[1:] or steps
        summary.update(batch=bs, batch_trials=tried, steps=n_steps, step_ms=steps,
                       step_ms_mean_after_first=sum(timed) / len(timed),
                       queries_per_s=bs * len(timed) / (sum(timed) / 1e3), wall_s=wall,
                       peak_memory_bytes=peak, metrics=metrics,
                       checkpoint_bytes=(save / "last").stat().st_size)
        say(f"[grounding] {json.dumps(summary)}")
        say(f"[grounding] {summary['step_ms_mean_after_first']:.1f} ms a step at batch {bs} "
            f"({summary['queries_per_s']:.1f} queries/s), peak {peak} B on {card}")
        host_batch = next(gm.batches(train_ds, 4, cfg.max_v_l, 5, False, 0,
                                     lambda qs: np.asarray(tokenizer(qs))))
        torch.cuda.empty_cache()
        summary["fp32_grad_check"] = grounding_fp32_grad_check(cfg, host_batch)
        speech_ds = GroundingDataset(str(root / "train.jsonl"), [str(root / "features")],
                                     use_speech=True, subtitles_path=str(root / "asr.pkl"),
                                     **ds_kw)
        summary["speech_step"] = grounding_speech_step(cfg, speech_ds, tokenizer)
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 11: a raw video to chapters and moments
# ---------------------------------------------------------------------------

VIDEO_FRAMES = (120, 300, 600, 900)  # 4 synthetic videos, one frame a second
VIDEO_HW = (360, 640)
FEATURE_BATCH = 64                   # CLIPFeatureExtractor's frames a tower call
VIDEO_FEATURES = {}                  # the kernel route's features by video id, kept for phase 12
MOMENT_QUERIES = ("mixing the dough", "the oven is hot", "slicing the bread", "tasting")
ALIGN_CUTS = 3                       # segments per phase-7 audio file (24 in all)
ALIGN_PREFIX = (50258, 50259, 50359, 50363)  # SOT, <|en|>, transcribe, no timestamps


def _synthetic_videos(counts, hw, seed: int = 0):
    """Seeded uint8 videos [T, H, W, 3] of random 8 x 8-pixel blocks (an
    encoder compresses them quickly)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, t in enumerate(counts):
        low = torch.randint(0, 256, (t, hw[0] // 8, hw[1] // 8, 3), generator=g,
                            dtype=torch.uint8)
        out[f"rawvid{i:05d}"] = low.repeat_interleave(8, 1).repeat_interleave(8, 2).numpy()
    return out


def _video_files(root: Path, videos):
    """``.mp4`` files of ``videos`` at 1 FPS when ffmpeg exists (decoded back
    by ``factory/features.decode_video_1fps``), else placeholder paths and a
    decode that hands the frames in. Returns (paths, decode_fn, route)."""
    import shutil

    from vidchapters_tpu_torch.factory import features

    paths = [str(root / f"{vid}.mp4") for vid in videos]
    if shutil.which("ffmpeg") and shutil.which("ffprobe"):
        for path, frames in zip(paths, videos.values()):
            _, h, w, _ = frames.shape
            subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
                            "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", "1", "-i", "-",
                            "-c:v", "mpeg4", "-q:v", "3", "-pix_fmt", "yuv420p", path],
                           input=frames.tobytes(), check=True)
        return paths, features.decode_video_1fps, "ffmpeg: .mp4 files through decode_video_1fps"
    by_path = dict(zip(paths, videos.values()))
    return paths, by_path.__getitem__, "no ffmpeg: the frames handed in as decode_fn"


def _patched_decode(decode, route: str):
    """A context in which ``factory/features.decode_video_1fps`` hands the
    synthetic frames in, where there is no ffmpeg to decode files."""
    import contextlib

    from vidchapters_tpu_torch.factory import features

    @contextlib.contextmanager
    def cm():
        real = features.decode_video_1fps
        if not route.startswith("ffmpeg"):
            features.decode_video_1fps = decode
        try:
            yield
        finally:
            features.decode_video_1fps = real

    return cm()


def _vision_tower(cfg, seed: int, device: str):
    """A CLIP image tower of ``cfg`` with seeded random weights, under
    OpenAI's names and back through ``convert_openai_clip_visual`` (every
    tensor equal): (tower on ``device``, the OpenAI-named state dict)."""
    import torch

    from vidchapters_tpu_torch.models.clip import CLIPImageEncoder, convert_openai_clip_visual

    src = CLIPImageEncoder(cfg).init_weights(torch.Generator().manual_seed(seed))
    sd = _openai_clip_names(src.state_dict(), "visual.")
    tower = CLIPImageEncoder(cfg)
    tower.load_state_dict(convert_openai_clip_visual(sd))
    for name, t in src.state_dict().items():
        check(torch.equal(tower.state_dict()[name], t), f"convert_openai_clip_visual: {name}")
    return tower.to(device).eval(), sd


def _batches(frames: int) -> int:
    return -(-frames // FEATURE_BATCH)


def video_features(card: str, root: Path, vit, counts=VIDEO_FRAMES):
    """(a) The feature factory at ViT-L/14 on 4 synthetic 360 x 640 videos
    of 120-900 frames through ``extract_features_sharded``: on the kernel
    route (row 1 launched exactly once a layer a batch of 64), then on the
    plain route (``USE_FUSED_ATTENTION`` False); frames/s of each, the
    tower's device time a batch on both routes, preprocessing ms a frame on
    the host (numpy) and on the card, peak memory; an fp32 check at 2
    layers, card against CPU."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.factory import features
    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import fused_attention as fa

    t0 = time.time()
    videos = _synthetic_videos(counts, VIDEO_HW)
    paths, decode, route = _video_files(root, videos)
    tower, sd = _vision_tower(vit, seed=11, device=DEVICE)
    torch.save(sd, root / "clip_vit.pt")
    say(f"[video] {len(videos)} videos of {list(counts)} frames at {VIDEO_HW} and a "
        f"{vit.layers} x {vit.width} image tower in {time.time() - t0:.1f} s; decode: {route}")
    lens = {}

    def counted(path):
        frames = decode(path)
        lens[path] = len(frames)
        return frames

    ext = features.CLIPFeatureExtractor(tower, DEVICE, batch_size=FEATURE_BATCH)
    summary = {"card": card, "decode": route, "frames": list(counts),
               "frame_hw": list(VIDEO_HW)}
    for fused in (True, False):
        key = "kernel" if fused else "plain"
        out_dir = root / f"features_{key}"
        clip.USE_FUSED_ATTENTION = fused
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.KERNEL.launches = 0
            t0 = time.time()
            n = features.extract_features_sharded(paths, str(out_dir), ext, counted)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches, peak = fa.KERNEL.launches, torch.cuda.max_memory_allocated()
        finally:
            clip.USE_FUSED_ATTENTION = True
        total = sum(lens.values())
        want = sum(vit.layers * _batches(t) for t in lens.values()) if fused else 0
        check(n == len(paths), f"extract_features_sharded encoded {n} of {len(paths)} videos")
        check(launches == want, f"fused launches {launches} on the {key} route, expected {want}")
        for path in paths:
            f = np.load(out_dir / (Path(path).stem + ".npy"))
            check(f.shape == (lens[path], vit.output_dim) and f.dtype == np.float32
                  and np.isfinite(f).all(), f"features of {path}: {f.shape} {f.dtype}")
        summary[key] = {"wall_s": wall, "frames": total, "frames_per_s": total / wall,
                        "launches": launches, "expected_launches": want,
                        "peak_memory_bytes": peak}
        say(f"[video] features, {key} route: {total} frames in {wall:.2f} s = "
            f"{total / wall:.1f} frames/s, row 1 launches {launches} (expected {want}), "
            f"peak {peak} B on {card}")
    VIDEO_FEATURES.update({Path(p).stem: np.load(root / "features_kernel" / f"{Path(p).stem}.npy")
                           for p in paths})
    stem = Path(paths[-1]).stem
    a, b = (np.load(root / f"features_{k}" / f"{stem}.npy") for k in ("kernel", "plain"))
    summary["routes_max_abs_diff_over_max"] = float(np.abs(a - b).max() / np.abs(b).max())

    # the tower alone on one batch, both routes; preprocessing alone
    frames = videos[stem][:FEATURE_BATCH]
    dev = torch.from_numpy(np.ascontiguousarray(frames)).to(DEVICE)
    pixels = features.preprocess_frames_torch(dev)
    with torch.inference_mode():
        for fused in (True, False):
            key = "kernel" if fused else "plain"
            clip.USE_FUSED_ATTENTION = fused
            try:
                ms = time_ms(lambda: tower(pixels), 5)
            finally:
                clip.USE_FUSED_ATTENTION = True
            summary[f"tower_ms_per_batch_{key}"] = ms
            summary[f"tower_frames_per_s_{key}"] = FEATURE_BATCH / ms * 1e3
        summary["device_preprocess_ms_per_frame"] = time_ms(
            lambda: features.preprocess_frames_torch(dev), 5) / FEATURE_BATCH
        summary["tower_profile_kernel"] = _profile_step(
            lambda *_: tower(pixels), None, None, summary["tower_ms_per_batch_kernel"])
    t0 = time.time()
    features.preprocess_frames(frames[:16])
    summary["host_preprocess_ms_per_frame"] = (time.time() - t0) * 1e3 / 16
    say(f"[video] the tower alone, batch {FEATURE_BATCH}: kernel route "
        f"{summary['tower_ms_per_batch_kernel']:.2f} ms "
        f"({summary['tower_frames_per_s_kernel']:.1f} frames/s), plain route "
        f"{summary['tower_ms_per_batch_plain']:.2f} ms "
        f"({summary['tower_frames_per_s_plain']:.1f} frames/s); preprocessing "
        f"{summary['host_preprocess_ms_per_frame']:.2f} ms a frame on the host (numpy), "
        f"{summary['device_preprocess_ms_per_frame']:.4f} on the card; routes' features "
        f"{summary['routes_max_abs_diff_over_max']:.3e} apart (of the largest); a profiled "
        f"batch on the kernel route, device ms by group: "
        f"{json.dumps(summary['tower_profile_kernel']['by_group_ms'])}")
    del tower, ext, pixels, dev
    torch.cuda.empty_cache()
    summary["fp32_check"] = features_fp32_check(vit, videos[stem][:70])
    return summary, videos, paths, decode, route


def features_fp32_check(vit, frames, layers: int = 2, tol: float = 1e-4):
    """fp32 features of a ``layers``-deep tower of ``vit``'s width: the card
    (row 1, preprocessing on the card) against the CPU (the plain versions,
    numpy preprocessing), within ``tol`` of the largest feature."""
    import numpy as np

    from vidchapters_tpu_torch.factory import features
    from vidchapters_tpu_torch.ops import fused_attention as fa

    cfg = dataclasses.replace(vit, layers=layers, dtype="float32")
    cpu, _ = _vision_tower(cfg, seed=12, device="cpu")
    ref = features.CLIPFeatureExtractor(cpu, "cpu", batch_size=FEATURE_BATCH)(frames)
    card, _ = _vision_tower(cfg, seed=12, device=DEVICE)
    before = fa.KERNEL.launches
    got = features.CLIPFeatureExtractor(card, DEVICE, batch_size=FEATURE_BATCH)(frames)
    launches, want = fa.KERNEL.launches - before, layers * _batches(len(frames))
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    say(f"[video] fp32 features at {layers} layers, {len(frames)} frames, card vs CPU: "
        f"max abs diff {err:.3e} of the largest (tol {tol}); launches {launches}")
    check(launches == want, f"fp32 features: {launches} fused launches, expected {want}")
    check(err <= tol, f"fp32 features card vs CPU: {err} > {tol}")
    return {"layers": layers, "frames": len(frames), "max_abs_diff_over_max": err,
            "tol": tol, "launches": launches}


def _demo_args(video_path, clip_ckpt, pth, asr, out, device, extra=()):
    return ["--video_path", video_path, "--clip_ckpt", str(clip_ckpt), "--ckpt_path", str(pth),
            "--asr_path", str(asr), "--num_beams", "4", "--out_path", str(out),
            "--device", device, *extra]


def video_demo(card: str, root: Path, vit, video_path: str, frames: int, decode, route: str,
               mcfg=None):
    """(b) ``demo_vid2seq.main`` from the video at T5-base
    (``Vid2SeqConfig()`` with an untied LM head, through ``--config``: with
    random weights a tied head makes the decoder repeat its start token, 0,
    and no chapter can come out): the synthetic image tower's checkpoint
    (``--clip_ckpt``), a reference ``.pth`` of seeded random weights
    (``--ckpt_path``), phase 7's ASR pickle with the most segments
    (``--asr_path``), beam 4. The chapters JSON well-formed and inside the
    duration; rows 1, 3 and 4 launched exactly as the shapes and decode
    steps give; then fp32 ids and chapters at 2+2 layers and a 2-layer image
    tower, card against CPU."""
    import torch

    from vidchapters_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        Vid2SeqConfig,
        save_config,
    )
    from vidchapters_tpu_torch.demo import demo_vid2seq
    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import decode_megakernel, decoding, fused_attention
    from vidchapters_tpu_torch.train import dvc_train

    mcfg = mcfg or Vid2SeqConfig()
    mcfg = dataclasses.replace(mcfg, t5=dataclasses.replace(mcfg.t5, tie_word_embeddings=False))
    data = DataConfig()
    t0 = time.time()
    save_config(ExperimentConfig(model=mcfg, data=data), str(root / "demo.json"))
    _write_reference_pth(root / "vid2seq.pth", mcfg, seed=13)
    vid = max(ASR_PICKLES, key=lambda v: len(ASR_PICKLES[v]["text"]))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(ASR_PICKLES[vid], f)
    say(f"[video] demo inputs in {time.time() - t0:.1f} s: a reference .pth and phase 7's "
        f"ASR pickle of {vid} ({len(ASR_PICKLES[vid]['text'])} segments)")
    kernels = {"fused_attention_fwd": fused_attention.KERNEL, "topk": decoding.TOPK_KERNEL,
               "decode_megakernel": decode_megakernel.KERNEL}
    steps, feat_s, seqs = [], [], []
    real = (dvc_train._pick_decode_fns, demo_vid2seq.clip_features,
            dvc_train.make_generate_fn, clip.VIT_L14)

    def counted_pick(*a, **k):  # one entry per decode step
        fns = real[0](*a, **k)

        def step(*sa, **sk):
            steps.append(1)
            return fns.step(*sa, **sk)

        return fns._replace(step=step)

    def timed_features(*a):
        torch.cuda.synchronize()
        t = time.time()
        out = real[1](*a)
        torch.cuda.synchronize()
        feat_s.append(time.time() - t)
        return out

    def kept_ids(*a, **k):  # the generated ids of each call
        generate = real[2](*a, **k)

        def call(*ga, **gk):
            out = generate(*ga, **gk)
            seqs.append(out.cpu().numpy())
            return out

        return call

    dvc_train._pick_decode_fns = counted_pick
    demo_vid2seq.clip_features = timed_features
    dvc_train.make_generate_fn = kept_ids
    clip.VIT_L14 = vit  # the tower the demo builds for --clip_ckpt
    out = root / "chapters.json"
    try:
        with _patched_decode(decode, route):
            for kern in kernels.values():
                kern.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            chapters = demo_vid2seq.main(_demo_args(video_path, root / "clip_vit.pt",
                                                    root / "vid2seq.pth", root / "asr.pkl",
                                                    out, DEVICE,
                                                    ("--config", str(root / "demo.json"))))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: k.launches for n, k in kernels.items()}
            peak = torch.cuda.max_memory_allocated()
        want = {"fused_attention_fwd": vit.layers * _batches(frames)
                + vc_fused_per_pass(mcfg, data),
                "topk": len(steps), "decode_megakernel": len(steps)}
        check(launches == want, f"demo launches {launches}, expected {want}")
        check(0 < len(steps) <= data.max_output_tokens,
              f"{len(steps)} decode steps, at most {data.max_output_tokens}")
        check(json.loads(out.read_text()) == chapters, "--out_path differs from the chapters")
        for ch in chapters:
            st, ed = ch["timestamp"]
            check(0.0 <= st <= ed <= frames and isinstance(ch["sentence"], str),
                  f"chapter {ch} outside [0, {frames}] s")
        summary = {"card": card, "frames": frames, "wall_s": wall, "feature_s": feat_s[0],
                   "decode_steps": len(steps), "launches": launches, "expected_launches": want,
                   "chapters": chapters, "ids": int((seqs[0] != 0).sum()),
                   "peak_memory_bytes": peak}
        say(f"[video] demo_vid2seq: {frames} frames -> {len(chapters)} chapters in {wall:.2f} s "
            f"(features {feat_s[0]:.2f} s), {len(steps)} decode steps, launches {launches} "
            f"(expected {want}), peak {peak} B on {card}")
        summary["fp32_check"] = demo_fp32_check(root, vit, video_path, decode, route, mcfg,
                                                seqs)
    finally:
        (dvc_train._pick_decode_fns, demo_vid2seq.clip_features,
         dvc_train.make_generate_fn, clip.VIT_L14) = real
    torch.cuda.empty_cache()
    return summary, launches


def demo_fp32_check(root: Path, vit, video_path: str, decode, route: str, mcfg, seqs,
                    max_out: int = 64):
    """The demo in fp32 at 2+2 T5 layers (a 2-deep ViT) with a 2-layer
    image tower of ``vit``'s width, on the card and on the CPU (``--device
    cpu``): identical ids and chapters."""
    import torch

    from vidchapters_tpu_torch.config import ExperimentConfig, save_config
    from vidchapters_tpu_torch.demo import demo_vid2seq
    from vidchapters_tpu_torch.models import clip

    small = dataclasses.replace(
        mcfg, t5=dataclasses.replace(mcfg.t5, num_layers=2, num_decoder_layers=2,
                                     dtype="float32"),
        vit=dataclasses.replace(mcfg.vit, depth=2, dtype="float32"))
    save_config(ExperimentConfig(model=small), str(root / "small.json"))
    _write_reference_pth(root / "small.pth", small, seed=14)
    clip.VIT_L14 = dataclasses.replace(vit, layers=2, dtype="float32")
    _, sd = _vision_tower(clip.VIT_L14, seed=15, device="cpu")
    torch.save(sd, root / "clip_small.pt")
    chapters = {}
    with _patched_decode(decode, route):
        for device in (DEVICE, "cpu"):
            chapters[device] = demo_vid2seq.main(_demo_args(
                video_path, root / "clip_small.pt", root / "small.pth", root / "asr.pkl",
                root / f"small_{device}.json", device,
                ("--config", str(root / "small.json"), "--max_output_tokens", str(max_out))))
    card_ids, cpu_ids = seqs[-2], seqs[-1]
    same = card_ids.shape == cpu_ids.shape and bool((card_ids == cpu_ids).all())
    say(f"[video] fp32 demo at 2+2 layers, card vs CPU: ids identical {same} "
        f"({int((cpu_ids != 0).sum())} ids), {len(chapters['cpu'])} chapters")
    check(same and chapters[DEVICE] == chapters["cpu"],
          f"fp32 demo: card and CPU differ ({chapters[DEVICE]} vs {chapters['cpu']})")
    check(int((cpu_ids != 0).sum()) > max_out // 2, "fp32 demo: the ids are mostly padding")
    return {"ids_identical": same, "ids": int((cpu_ids != 0).sum()),
            "chapters": len(chapters["cpu"]), "max_output_tokens": max_out}


def _moment_predictor(root: Path, gcfg, device: str, small: bool, seed: int):
    """A ``MomentDETRPredictor`` on ``device`` with ViT-B/32's image and
    text towers (2 layers in fp32 when ``small``), both from one
    OpenAI-named checkpoint of seeded random weights read back through
    ``load_openai_clip`` and the two converters; Moment-DETR of ``gcfg``."""
    import torch

    from vidchapters_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vidchapters_tpu_torch.demo.run_on_video import MomentDETRPredictor
    from vidchapters_tpu_torch.factory.features import CLIPFeatureExtractor
    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.models.grounding import MomentDETR

    vcfg, tcfg = clip.VIT_B32, clip.TEXT_B32
    if small:
        vcfg = dataclasses.replace(vcfg, layers=2, dtype="float32")
        tcfg = dataclasses.replace(tcfg, layers=2, dtype="float32")
    text = clip.CLIPTextEncoder(tcfg).init_weights(torch.Generator().manual_seed(seed))
    _, vsd = _vision_tower(vcfg, seed, "cpu")
    path = root / f"clip_b32{'_small' if small else ''}.pt"
    torch.save({**vsd, **_openai_clip_names(text.state_dict())}, path)
    sd = clip.load_openai_clip(str(path))
    vision, text = clip.CLIPImageEncoder(vcfg), clip.CLIPTextEncoder(tcfg)
    vision.load_state_dict(clip.convert_openai_clip_visual(sd))
    text.load_state_dict(clip.convert_openai_clip_text(sd))
    model = MomentDETR(gcfg).init_weights(torch.Generator().manual_seed(seed)).to(device).eval()
    return MomentDETRPredictor(model, text.to(device).eval(), CLIPTokenizer(),
                               CLIPFeatureExtractor(vision, device), clip_len=gcfg.clip_length,
                               max_v_l=gcfg.max_v_l, v_feat_dim=gcfg.v_feat_dim)


def _check_moments(rows, n_windows: int, ctx: int, duration: float):
    import numpy as np

    check(len(rows) == len(MOMENT_QUERIES), f"{len(rows)} rows for {len(MOMENT_QUERIES)} queries")
    for row, q in zip(rows, MOMENT_QUERIES):
        check(set(row) == {"query", "vid", "pred_relevant_windows", "pred_saliency_scores"}
              and row["query"] == q, f"moment row keys {sorted(row)}")
        w = np.asarray(row["pred_relevant_windows"])
        check(w.shape == (n_windows, 3) and np.isfinite(w).all()
              and (np.diff(w[:, 2]) <= 0).all()
              and (w[:, :2] >= 0).all() and (w[:, :2] <= duration + 1e-3).all(),
              f"windows of {q!r}: {w.shape}, not ranked or outside [0, {duration}]")
        check(len(row["pred_saliency_scores"]) == ctx
              and np.isfinite(row["pred_saliency_scores"]).all(),
              f"saliency of {q!r}: {len(row['pred_saliency_scores'])} for {ctx} clips")


def video_moments(card: str, root: Path, video_path: str, frames: int, decode, route: str,
                  gcfg=None, tol: float = 1e-3):
    """(c) ``MomentDETRPredictor`` at ``configs/chapters_momentdetr.json``
    (v_feat_dim 514 and t_feat_dim 512 for ViT-B/32's features) with
    ViT-B/32's image and text towers: one video at the recipe's clip_length
    (3 s) and 4 queries. The run.py schema, windows ranked by score and
    inside the video, a saliency score per clip, row 1 launched 12 a batch;
    then fp32 windows and saliency at hidden 64 with 2-layer towers, card
    against CPU, within ``tol`` (seconds and scores)."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.config import GroundingConfig
    from vidchapters_tpu_torch.models.clip import VIT_B32
    from vidchapters_tpu_torch.ops import fused_attention as fa

    recipe = json.loads((ROOT / GROUNDING_RECIPE).read_text())
    gcfg = gcfg or dataclasses.replace(GroundingConfig(), **recipe["model"])
    gcfg = dataclasses.replace(gcfg, v_feat_dim=514, t_feat_dim=512)
    pred = _moment_predictor(root, gcfg, DEVICE, small=False, seed=16)
    clips = -(-frames // max(int(gcfg.clip_length), 1))
    ctx = min(clips, gcfg.max_v_l)
    with _patched_decode(decode, route):
        fa.KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        rows = pred.localize_moment(video_path, list(MOMENT_QUERIES))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fa.KERNEL.launches
    want = VIT_B32.layers * _batches(clips)
    check(launches == want, f"moments: fused launches {launches}, expected {want}")
    _check_moments(rows, gcfg.num_queries, ctx, ctx * gcfg.clip_length)
    summary = {"card": card, "clips": ctx, "queries": len(rows), "wall_s": wall,
               "launches": launches, "top_window": rows[0]["pred_relevant_windows"][0]}
    say(f"[video] run_on_video: {ctx} clips x {len(rows)} queries in {wall:.2f} s, launches "
        f"{launches} (expected {want}); top window {summary['top_window']} on {card}")
    del pred
    small = dataclasses.replace(gcfg, hidden_dim=64, nheads=4, dim_feedforward=128,
                                dtype="float32")
    out = {}
    for device in (DEVICE, "cpu"):
        p = _moment_predictor(root, small, device, small=True, seed=17)
        with _patched_decode(decode, route):
            out[device] = p.localize_moment(video_path, list(MOMENT_QUERIES))
    _check_moments(out[DEVICE], small.num_queries, ctx, ctx * gcfg.clip_length)
    err = max(max(float(np.abs(np.asarray(g["pred_relevant_windows"])
                               - np.asarray(r["pred_relevant_windows"])).max()),
                  float(np.abs(np.asarray(g["pred_saliency_scores"])
                               - np.asarray(r["pred_saliency_scores"])).max()))
              for g, r in zip(out[DEVICE], out["cpu"]))
    say(f"[video] fp32 moments at hidden 64, card vs CPU: max abs diff {err:.3e} (tol {tol})")
    check(err <= tol, f"fp32 moments card vs CPU: {err} > {tol}")
    summary["fp32_max_abs_diff"] = err
    torch.cuda.empty_cache()
    return summary


def _align_inputs(seconds, seed: int = 0):
    """Phase 7's synthetic audio (the same seeded files) cut into
    ``ALIGN_CUTS`` segments each (at most 30 s), each with seeded random
    token ids (2.5 a second) and their words (every third token a
    continuation): (mels, ids, words, seconds)."""
    import numpy as np

    from vidchapters_tpu_torch.factory.audio import load_audio, log_mel_spectrogram

    rng = np.random.default_rng(seed)
    mels, ids, words, secs = [], [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for path in _write_asr_wavs(Path(tmp), seconds):
            audio = load_audio(path)
            n = len(audio) // ALIGN_CUTS
            for c in range(ALIGN_CUTS):
                piece = audio[c * n:min((c + 1) * n, c * n + 480000)]
                mels.append(log_mel_spectrogram(piece))
                toks = rng.integers(0, 50257, max(1, int(len(piece) / 16000 * 2.5))).tolist()
                ids.append(toks)
                words.append(["" if i % 3 == 2 else f"w{t}" for i, t in enumerate(toks)])
                secs.append(len(piece) / 16000)
    return mels, ids, words, secs


def video_align(card: str, wcfg=None, seconds=ASR_SECONDS, chunk: int = 8):
    """(d) ``align_words_batch`` at Whisper large-v2 width (phase 7's seeded
    random weights, bf16) over 24 segments of phase 7's synthetic audio in
    chunks of 8: word times finite, monotone and inside their segments;
    seconds and peak memory. ``align_segments`` turns phase 7's pickle with
    the most segments into whisperx segments that ``merge_and_process``
    reads back. Then fp32 word times at 4+4 layers, card against CPU,
    identical."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.factory import align, asr
    from vidchapters_tpu_torch.factory.audio import load_audio
    from vidchapters_tpu_torch.models.whisper import LARGE_V2

    wcfg = wcfg or LARGE_V2
    mels, ids, words, secs = _align_inputs(seconds)
    model = _whisper_model(wcfg, DEVICE, seed=7).to(DEVICE)  # its buffers too
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = align.align_words_batch(model, mels, ids, words, secs, prefix_ids=ALIGN_PREFIX,
                                  chunk_size=chunk)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    for seg, s, w in zip(out, secs, words):
        starts = [x["start"] for x in seg]
        check(len(seg) == sum(1 for x in w if x) and starts == sorted(starts)
              and all(np.isfinite([x["start"], x["end"]]).all()
                      and 0.0 <= x["start"] <= x["end"] <= s + 1e-6 for x in seg),
              f"aligned words not finite, monotone and inside [0, {s}]: {seg[:3]}")
    summary = {"card": card, "segments": len(out), "audio_s": sum(secs),
               "words": sum(len(s) for s in out), "chunk": chunk, "wall_s": wall,
               "peak_memory_bytes": peak}
    say(f"[video] align_words_batch at d {wcfg.d_model}, {wcfg.encoder_layers}+"
        f"{wcfg.decoder_layers} layers: {len(out)} segments ({sum(secs):.1f} s of "
        f"audio), {summary['words']} words in {wall:.2f} s, chunks of {chunk}, peak {peak} B "
        f"on {card}")
    vid = max(ASR_PICKLES, key=lambda v: len(ASR_PICKLES[v]["text"]))
    res = ASR_PICKLES[vid]
    with tempfile.TemporaryDirectory() as tmp:
        path = next(p for p in _write_asr_wavs(Path(tmp), seconds) if Path(p).stem == vid)
        aligned = align.align_segments(
            model, load_audio(path), res,
            lambda text: ([int(t) for t in text.split()], [f"w{t}" for t in text.split()]),
            prefix_ids=ALIGN_PREFIX)
        out_dir = Path(tmp) / "aligned"
        out_dir.mkdir()
        with open(out_dir / f"{vid}.pkl", "wb") as f:
            pickle.dump(aligned, f)
        merged = asr.merge_and_process(str(out_dir), str(Path(tmp) / "proc.pkl"))
    kept = [t.strip() for t in res["text"] if t.strip()]
    check(merged[asr.normalize_video_id(vid)]["text"] == kept,
          "merge_and_process of the aligned pickle lost segments")
    summary["aligned_pickle"] = {"video": vid, "segments": len(aligned["segments"]),
                                 "words": sum(len(s["words"]) for s in aligned["segments"])}
    say(f"[video] align_segments on phase 7's {vid}: {summary['aligned_pickle']}; "
        f"merge_and_process reads its {len(kept)} texts back")
    del model
    torch.cuda.empty_cache()
    summary["fp32_check"] = align_fp32_check(wcfg, mels[:4], ids[:4], words[:4], secs[:4])
    return summary


def align_fp32_check(wcfg, mels, ids, words, secs, layers: int = 4):
    """fp32 word times at ``layers``+``layers`` layers of ``wcfg``'s width,
    card against CPU: identical."""
    import copy

    from vidchapters_tpu_torch.factory import align

    cfg = dataclasses.replace(wcfg, encoder_layers=layers, decoder_layers=layers,
                              dtype="float32")
    cpu = _whisper_model(cfg, "cpu", seed=8)
    card = copy.deepcopy(cpu).to(DEVICE)
    got = align.align_words_batch(card, mels, ids, words, secs, prefix_ids=ALIGN_PREFIX)
    ref = align.align_words_batch(cpu, mels, ids, words, secs, prefix_ids=ALIGN_PREFIX)
    same = got == ref
    say(f"[video] fp32 word times at {layers}+{layers} layers, {len(mels)} segments, card vs "
        f"CPU: identical {same}")
    check(same, "fp32 word times differ between the card and the CPU")
    return {"layers": layers, "segments": len(mels), "identical": same,
            "words": sum(len(s) for s in ref)}


def phase_video(card: str, vit=None, counts=VIDEO_FRAMES, mcfg=None, gcfg=None, wcfg=None):
    """Phase 11, a raw video to chapters and moments: (a) the ViT-L/14
    feature factory, (b) ``demo_vid2seq`` at T5-base, (c) ``run_on_video``'s
    predictor, (d) Whisper word alignment at large-v2. Returns (summary,
    row 1's launches in (a), the demo's launches of rows 1, 3 and 4)."""
    import torch

    from vidchapters_tpu_torch.models.clip import VIT_L14

    vit = vit or VIT_L14
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        feats, videos, paths, decode, route = video_features(card, root, vit, counts)
        frames = {p: len(decode(p)) if route.startswith("ffmpeg") else len(videos[Path(p).stem])
                  for p in paths}
        longest = max(paths, key=frames.get)
        demo, demo_launches = video_demo(card, root, vit, longest, frames[longest], decode,
                                         route, mcfg)
        mid = sorted(paths, key=frames.get)[len(paths) // 2]
        moments = video_moments(card, root, mid, frames[mid], decode, route, gcfg)
        del videos
    torch.cuda.empty_cache()
    align = video_align(card, wcfg)
    summary = {"card": card, "features": feats, "demo": demo, "moments": moments,
               "align": align, "wall_s": time.time() - t_phase}
    say(f"[video] phase 11 in {summary['wall_s']:.1f} s on {card}")
    return summary, feats["kernel"]["launches"], demo_launches


# ---------------------------------------------------------------------------
# phase 12: the zero-shot baselines
# ---------------------------------------------------------------------------


def _fresh_peak() -> int:
    """Collect garbage (a model caught in a reference cycle stays on the
    card until the cyclic collector runs), reset the peak-memory counter,
    and return the bytes still allocated on the card, which every peak read
    after it includes."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


ZS_VIDEOS = 8              # phase 12(a)'s speech videos
ZS_TOPICS = (("pasta", "boil", "salt", "sauce", "noodle", "simmer", "garlic", "basil"),
             ("engine", "race", "track", "tyre", "brake", "gear", "lap", "pit"),
             ("canvas", "brush", "paint", "colour", "sketch", "easel", "oil", "shade"),
             ("guitar", "chord", "string", "tune", "strum", "fret", "melody", "amp"))
ZS_LINES = 20              # ASR lines a topic, 5 s each
ZS_VISUAL_SHOTS = (3, 4, 5, 4)  # planted shots of phase 12(b)'s four visual videos
LLAMA_PROMPT_LEN = 512     # the reference's max_length (zs_speechvcg.py:131-133)
LLAMA_NEW_TOKENS = 20


class _WordIds:
    """A stand-in for LLaMA's SentencePiece-BPE tokenizer (which the port
    cannot read yet): one id in [3, vocab) a word, by CRC32; ids decode to
    ``t<id>``. HF's ``encode`` / ``decode`` signatures."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str, add_special_tokens: bool = False):
        import zlib

        return [3 + zlib.crc32(w.encode()) % (self.vocab - 3) for w in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"t{i}" for i in ids if i > 2)


def _zs_speech_data(root: Path, n_videos: int, seed: int = 0):
    """Annotation json and ASR pickle of ``n_videos`` videos, each four
    topics of ``ZS_LINES`` ten-word lines (5 s a line), and a VC val split of
    two of them (one clip a topic)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ann, asr = {}, {}
    for v in range(n_videos):
        vid = f"zsspeech{v:03d}"
        order = rng.permutation(len(ZS_TOPICS))
        text = [" ".join(rng.choice(ZS_TOPICS[t] + ("the", "and", "we"), 10))
                for t in order for _ in range(ZS_LINES)]
        n = len(text)
        asr[vid] = {"text": text, "start": [5.0 * i for i in range(n)],
                    "end": [5.0 * i + 4.5 for i in range(n)]}
        span = 5.0 * ZS_LINES
        ann[vid] = {"duration": 5.0 * n,
                    "timestamps": [[span * i, span * (i + 1)] for i in range(len(order))],
                    "sentences": [f"all about {ZS_TOPICS[t][0]}" for t in order]}
    (root / "zs_ann.json").write_text(json.dumps(ann))
    (root / "zs_vc_val.json").write_text(json.dumps(dict(list(ann.items())[:2])))
    with open(root / "zs_asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root / "zs_ann.json", root / "zs_asr.pkl", root / "zs_vc_val.json"


def _finite_metrics(metrics, what: str):
    import math

    check(bool(metrics) and all(math.isfinite(float(v)) for v in metrics.values()),
          f"{what}: metrics not finite: {metrics}")


def zeroshot_speech(card: str, root: Path, cfg=None, n_videos: int = ZS_VIDEOS):
    """(a) Speech chapters at LLaMA-7B, bf16, seeded random weights:
    ``run_speech_vcg`` with ``make_llm_titler(make_llama_generate_fn(...))``
    (prompts padded to 512, 20 greedy tokens), the prefill's and a decode
    step's time against their bounds, titles/s, peak memory; then
    ``evaluate_vc_llama`` over a VC val set of two videos; two generate
    calls bit-identical."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset
    from vidchapters_tpu_torch.models import llama
    from vidchapters_tpu_torch.train.vc_train import evaluate_vc_llama
    from vidchapters_tpu_torch.zeroshot.run import run_speech_vcg
    from vidchapters_tpu_torch.zeroshot.speech_vcg import make_llm_titler

    cfg = cfg or dataclasses.replace(llama.LLAMA_7B, dtype="bfloat16")
    ann, asr, vc_val = _zs_speech_data(root, n_videos)
    held = _fresh_peak()
    t0 = time.time()
    model = llama.init_llama(cfg, DEVICE, seed=21)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"[zeroshot] LLaMA {cfg.num_layers} x {cfg.hidden_size} ({weight_bytes / 1e9:.2f} GB "
        f"in {cfg.dtype}) built on the card in {build_s:.1f} s; tokenizer: a synthetic "
        f"word-hash stand-in (ids below {cfg.vocab_size}), not LLaMA's")

    # the prefill of one padded prompt and one decode step, timed alone
    p_len, new = LLAMA_PROMPT_LEN, LLAMA_NEW_TOKENS
    g = torch.Generator(device=DEVICE).manual_seed(5)
    ids = torch.randint(3, cfg.vocab_size, (1, p_len), generator=g, device=DEVICE)
    ones = torch.ones((1, p_len + new), dtype=torch.int32, device=DEVICE)
    cache = llama.init_cache(cfg, 1, p_len + new, device=DEVICE)
    with torch.no_grad():
        prefill_ms = time_ms(lambda: model(ids, cache=cache, cache_index=0, kv_pad_mask=ones), 3)
        tok = ids[:, -1:]
        pos = torch.full((1, 1), p_len, device=DEVICE)
        step_ms = time_ms(lambda: model(tok, position_ids=pos, cache=cache, cache_index=p_len,
                                        kv_pad_mask=ones), 10)
    embed = model.embed_tokens.numel() * model.embed_tokens.element_size()
    kv_bytes = sum(t.numel() * t.element_size() for c in cache.values() for t in c.values())
    dense = 2 * (weight_bytes - embed) // model.embed_tokens.element_size()  # 2 flops a weight
    step_bound = bound(weight_bytes - embed + kv_bytes, dense, H100_BF16_FLOPS)
    prefill_bound = bound(weight_bytes - embed + kv_bytes,
                          dense * p_len + 4 * cfg.num_layers * p_len * p_len * cfg.hidden_size,
                          H100_BF16_FLOPS)
    del cache

    gen = llama.make_llama_generate_fn(model, _WordIds(cfg.vocab_size), new, p_len)
    calls = []

    def counted(prompt: str) -> str:
        calls.append(len(prompt))
        return gen(prompt)

    torch.cuda.synchronize()
    t0 = time.time()
    results, metrics = run_speech_vcg(str(ann), str(asr), titler=make_llm_titler(counted))
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_chapters = sum(len(r) for r in results.values())
    check(len(calls) >= 2 * n_videos and n_chapters >= n_videos,
          f"speech chapters: {len(calls)} titles, {n_chapters} chapters of {n_videos} videos")
    _finite_metrics(metrics, "run_speech_vcg")
    vc_ds = VideoCaptioningDataset(str(vc_val), {}, training=False, subtitles_path=str(asr))
    t1 = time.time()
    vc_results, vc_metrics = evaluate_vc_llama(vc_ds, gen)
    vc_wall = time.time() - t1
    _finite_metrics(vc_metrics, "evaluate_vc_llama")
    prompt = "Summarize the following speech transcript in a chapter title. Transcript:" \
             " we boil the pasta. Chapter title:"
    check(gen(prompt) == gen(prompt), "two bf16 LLaMA generate calls differ")
    peak = torch.cuda.max_memory_allocated()
    out = {"config": dataclasses.asdict(cfg), "weights_bytes": weight_bytes, "build_s": build_s,
           "tokenizer": "synthetic word-hash stand-in (LLaMA's SentencePiece BPE is not read)",
           "prompt_tokens": p_len, "new_tokens": new,
           "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound[0],
           "prefill_bound_by": prefill_bound[1], "decode_step_ms": step_ms,
           "decode_step_bound_ms": step_bound[0], "decode_step_bound_by": step_bound[1],
           "titles": len(calls), "chapters": n_chapters, "wall_s": wall,
           "titles_per_s": len(calls) / wall, "metrics": metrics,
           "vc_llama": {"titles": len(vc_results), "wall_s": vc_wall, "metrics": vc_metrics},
           "peak_memory_bytes": peak, "held_bytes_before": held, "bit_identical_bf16": True}
    say(f"[zeroshot] (a) speech chapters at LLaMA {cfg.num_layers} x {cfg.hidden_size}: "
        f"{len(calls)} titles ({n_chapters} "
        f"chapters, {n_videos} videos) in {wall:.2f} s = {len(calls) / wall:.2f} titles/s; "
        f"prefill of {p_len} tokens {prefill_ms:.2f} ms (bound {prefill_bound[0]:.2f} by "
        f"{prefill_bound[1]}), a decode step {step_ms:.3f} ms (bound {step_bound[0]:.3f} by "
        f"{step_bound[1]}); evaluate_vc_llama {len(vc_results)} clips in {vc_wall:.2f} s; "
        f"peak {peak} B ({held} B held before); soda_c {metrics.get('soda_c')} on {card}")
    del model, gen
    torch.cuda.empty_cache()
    return out


def _zs_frame(vid: str, second: float):
    """A seeded 224 x 224 frame of ``vid`` at ``second`` (8 x 8 blocks)."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(f"{vid}:{int(second)}".encode()))
    low = rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)
    return low.repeat(8, 0).repeat(8, 1)


def _greedy_steps(toks, eos: int = 1) -> int:
    """The decode steps ``greedy_decode`` ran for ``toks`` [B, T]: up to the
    step where the last row first gave EOS, else all T."""
    import numpy as np

    toks = np.asarray(toks)
    firsts = [np.flatnonzero(row == eos) for row in toks]
    if any(len(f) == 0 for f in firsts):
        return toks.shape[1]
    return int(max(f[0] for f in firsts)) + 1


def zeroshot_visual(card: str, root: Path, cfg=None, batch: int = 8):
    """(b) Visual chapters and VC at BLIP-2 Flan-T5-XL, bf16, seeded random
    weights: ViT-g, Q-Former, encode and a greedy step timed at a batch of
    8 frames; ``caption_fn`` on 8 frames with rows 5 and 6 launched exactly
    24 x its decode steps; two bf16 calls bit-identical; one
    ``num_beams=2`` call (row 3 once a step); ``run_visual_vcg`` over
    CLIP-width features with planted shots and ``make_blip2_captioner``
    over frames handed in; ``evaluate_vc_blip2`` over a VC val set built
    with ``videos_path``. Returns (summary, launches)."""
    import shutil

    import numpy as np
    import torch

    from vidchapters_tpu_torch.data.tokenizer import SentencePieceUnigramTokenizer
    from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset
    from vidchapters_tpu_torch.models import blip2
    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops import decoding as dec
    from vidchapters_tpu_torch.train.vc_train import evaluate_vc_blip2
    from vidchapters_tpu_torch.zeroshot.run import run_visual_vcg
    from vidchapters_tpu_torch.zeroshot.visual_vcg import BLIP2_PROMPT, make_blip2_captioner

    if cfg is None:
        base = blip2.Blip2Config()
        cfg = blip2.Blip2Config(
            vision=dataclasses.replace(base.vision, dtype="bfloat16"),
            qformer=dataclasses.replace(base.qformer, dtype="bfloat16"),
            t5=dataclasses.replace(base.t5, dtype="bfloat16"))
    held = _fresh_peak()
    t0 = time.time()
    model = blip2.init_blip2(cfg, DEVICE, seed=22)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    _write_spm_model(root / "spiece.model")
    tok = SentencePieceUnigramTokenizer(str(root / "spiece.model"), num_bins=0)
    make_caption = blip2.make_blip2_caption_fn(model, tok, LLAMA_NEW_TOKENS)
    calls = set()  # (frames, cross keys) of every caption_fn call: phase 2 checked these forms

    def caption_fn(frames, prompt):
        calls.add((frames.shape[0], cfg.num_query_tokens + blip2.encode_prompts(
            tok, [prompt])[0].shape[1]))
        return make_caption(frames, prompt)

    say(f"[zeroshot] BLIP-2 (ViT-g {cfg.vision.num_layers} x {cfg.vision.hidden_size}, "
        f"Q-Former {cfg.qformer.num_layers} x {cfg.qformer.hidden_size}, Flan-T5 "
        f"{cfg.t5.num_layers}+{cfg.t5.num_decoder_layers} x {cfg.t5.d_model}; "
        f"{weight_bytes / 1e9:.2f} GB) built on the card in {build_s:.1f} s")

    frames = np.stack([_zs_frame("batch", s) for s in range(batch)])
    px = torch.from_numpy(blip2.preprocess_frames(frames)).to(DEVICE)
    ids, mask = (torch.from_numpy(x).to(DEVICE) for x in blip2.encode_prompts(
        tok, [BLIP2_PROMPT] * batch))
    with torch.no_grad():
        img = model.vision(px)
        queries = model.query_tokens.expand(batch, -1, -1)
        vision_ms = time_ms(lambda: model.vision(px), 5)
        qformer_ms = time_ms(lambda: model.qformer(queries, img), 5)
        encode_ms = time_ms(lambda: model.encode(px, ids, mask), 5)
        enc, enc_mask = model.encode(px, ids, mask)
        fns = dec.make_decode_fns(model.t5, LLAMA_NEW_TOKENS)
        cache = fns.init_cache(batch, enc)
        step_tok = torch.zeros(batch, dtype=torch.int32, device=DEVICE)
        step_ms = time_ms(lambda: fns.step(step_tok, cache, 5, enc_mask), 10)
    t5 = model.t5
    per_step = [p for n, p in t5.decoder.named_parameters()
                if ".cross_attn.k." not in n and ".cross_attn.v." not in n]
    per_step.append(t5.lm_head.weight)
    step_bytes = sum(p.numel() * p.element_size() for p in per_step)
    step_bound = bound(step_bytes, 2 * batch * sum(p.numel() for p in per_step),
                       H100_BF16_FLOPS)
    del cache

    def counted(fn):
        da.SELF_KERNEL.launches = da.CROSS_KERNEL.launches = dec.TOPK_KERNEL.launches = 0
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t, {"decode_self_attention": da.SELF_KERNEL.launches,
                                      "decode_cross_attention": da.CROSS_KERNEL.launches,
                                      "topk": dec.TOPK_KERNEL.launches}

    captions, caption_s, greedy = counted(lambda: caption_fn(frames, BLIP2_PROMPT))
    n_dec = cfg.t5.num_decoder_layers
    toks = [blip2.blip2_generate(model, px, ids, mask, LLAMA_NEW_TOKENS).cpu() for _ in range(2)]
    check(torch.equal(toks[0], toks[1]), "two bf16 BLIP-2 generate calls differ")
    steps = _greedy_steps(toks[0])
    check(captions == tok.batch_decode(toks[0].numpy(), skip_special_tokens=True),
          "caption_fn's captions differ from blip2_generate's tokens")
    check(greedy["decode_self_attention"] == greedy["decode_cross_attention"] == n_dec * steps
          and greedy["topk"] == 0,
          f"caption_fn launches {greedy}, expected {n_dec} x {steps} steps of rows 5 and 6")
    _, beam_s, beam = counted(lambda: blip2.blip2_generate(model, px, ids, mask,
                                                           LLAMA_NEW_TOKENS, num_beams=2))
    check(1 <= beam["topk"] <= LLAMA_NEW_TOKENS
          and beam["decode_self_attention"] == beam["decode_cross_attention"]
          == n_dec * beam["topk"], f"num_beams=2 launches {beam}: row 3 once a step, rows 5 "
                                   f"and 6 {n_dec} a step")

    # run_visual_vcg over CLIP-width features with planted shots
    rng = np.random.default_rng(23)
    feats, ann = {}, {}
    for v, n_shots in enumerate(ZS_VISUAL_SHOTS):
        vid = f"zsvisual{v:03d}"
        blocks = [np.tile(rng.normal(size=(1, 768)), (12, 1)) + 0.02 * rng.normal(size=(12, 768))
                  for _ in range(n_shots)]
        feats[vid] = np.concatenate(blocks).astype(np.float32)
        dur = float(len(feats[vid]))
        ann[vid] = {"duration": dur, "timestamps": [[0.0, dur / 2], [dur / 2, dur]],
                    "sentences": ["the first half", "the second half"]}
    (root / "zs_visual.json").write_text(json.dumps(ann))
    captioners = {vid: make_blip2_captioner(caption_fn, lambda t, _v=vid: _zs_frame(_v, t))
                  for vid in ann}
    (results, metrics), visual_s, visual = counted(lambda: run_visual_vcg(
        str(root / "zs_visual.json"), feats, lambda vid, t: captioners[vid](t)))
    n_shots = sum(len(r) for r in results.values())
    check(n_shots == sum(ZS_VISUAL_SHOTS), f"run_visual_vcg captioned {n_shots} shots, "
                                           f"planted {sum(ZS_VISUAL_SHOTS)}")
    check(visual["decode_self_attention"] == visual["decode_cross_attention"] > 0
          and visual["decode_self_attention"] % n_dec == 0 and visual["topk"] == 0,
          f"run_visual_vcg launches {visual}")
    _finite_metrics(metrics, "run_visual_vcg")

    # evaluate_vc_blip2 over a VC val set built with videos_path
    videos = {vid: np.stack([_zs_frame(vid, s) for s in range(int(ann[vid]["duration"]))])
              for vid in list(ann)[:2]}
    paths, _, route = _video_files(root, videos)
    decoded = bool(shutil.which("ffmpeg") and shutil.which("ffprobe"))
    vc_ds = VideoCaptioningDataset(str(root / "zs_visual.json"), feats, training=False,
                                   videos_path={vid: p for vid, p in zip(videos, paths)})
    first = vc_ds[0]["raw_first_frames"]
    check(first.shape[1:] == (224, 224, 3) and bool(first.any()) == decoded,
          f"raw_first_frames {first.shape}: decoded {bool(first.any())}, ffmpeg {decoded}")
    (vc_results, vc_metrics), vc_s, vc_launches = counted(
        lambda: evaluate_vc_blip2(vc_ds, caption_fn))
    _finite_metrics(vc_metrics, "evaluate_vc_blip2")
    peak = torch.cuda.max_memory_allocated()
    launches = {k: greedy[k] + beam[k] + visual[k] + vc_launches[k] for k in greedy}
    path_keys = blip2_path_keys(root, cfg.num_query_tokens)
    check(enc.shape[1] == path_keys and calls <= {(r, path_keys) for r in BLIP2_SELF_ROWS}
          and (batch, 2) in BLIP2_CROSS_GROUPS and 2 * batch in BLIP2_SELF_ROWS,
          f"BLIP-2 decode forms {sorted(calls)} (frames, keys), beam 2 at {batch}, encoder keys "
          f"{enc.shape[1]}: phase 2 checked rows {BLIP2_SELF_ROWS} over {path_keys} keys")
    out = {"config": dataclasses.asdict(cfg), "weights_bytes": weight_bytes, "build_s": build_s,
           "batch": batch, "vision_ms": vision_ms, "qformer_ms": qformer_ms,
           "encode_ms": encode_ms, "encoder_keys": int(enc.shape[1]),
           "greedy_step_ms": step_ms, "greedy_step_bound_ms": step_bound[0],
           "greedy_step_bound_by": step_bound[1], "greedy_step_bytes": step_bytes,
           "caption_fn_forms": sorted(calls),
           "caption_fn": {"s": caption_s, "steps": steps, "launches": greedy,
                          "captions": captions[:2]},
           "beam2": {"s": beam_s, "launches": beam}, "bit_identical_bf16": True,
           "run_visual_vcg": {"s": visual_s, "shots": n_shots, "launches": visual,
                              "metrics": metrics},
           "vc_blip2": {"s": vc_s, "clips": len(vc_results), "launches": vc_launches,
                        "frames": "decoded by ffmpeg" if decoded else
                        "zero-frame fallback (no ffmpeg)", "route": route,
                        "metrics": vc_metrics},
           "peak_memory_bytes": peak, "held_bytes_before": held}
    say(f"[zeroshot] (b) BLIP-2 at batch {batch}: ViT-g {vision_ms:.2f} ms, Q-Former "
        f"{qformer_ms:.2f} ms, encode {encode_ms:.2f} ms ({enc.shape[1]} encoder keys), a greedy "
        f"step {step_ms:.3f} ms (bound {step_bound[0]:.3f} by {step_bound[1]}); caption_fn "
        f"{steps} steps in {caption_s:.2f} s, launches {greedy}; beam 2 {beam}; "
        f"run_visual_vcg {n_shots} shots in {visual_s:.2f} s; evaluate_vc_blip2 "
        f"{len(vc_results)} clips in {vc_s:.2f} s ({out['vc_blip2']['frames']}); peak {peak} B "
        f"({held} B held before) "
        f"on {card}")
    del model, caption_fn, make_caption, captioners, enc, img
    torch.cuda.empty_cache()
    return out, launches


def zeroshot_grounding(card: str, root: Path, text_cfg=None):
    """(c) Zero-shot grounding over phase 11's features: ``run_vcgr`` in
    ``clip`` mode with the port's CLIP ViT-L/14 text tower (seeded random
    weights) as ``text_embed_fn``, and in ``random`` mode."""
    import torch

    from vidchapters_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vidchapters_tpu_torch.models.clip import TEXT_L14, CLIPTextEncoder
    from vidchapters_tpu_torch.zeroshot.run import run_vcgr

    check(bool(VIDEO_FEATURES), "phase 11 left no features for zero-shot grounding")
    tower = CLIPTextEncoder(text_cfg or TEXT_L14).init_weights(
        torch.Generator().manual_seed(24)).to(DEVICE).eval()
    tokenizer = CLIPTokenizer()

    def text_embed_fn(texts):
        with torch.no_grad():
            toks = torch.from_numpy(tokenizer(list(texts))).to(DEVICE)
            return tower(toks).float().cpu().numpy()

    ann, asr = {}, {}
    for vid, f in VIDEO_FEATURES.items():
        dur = float(len(f))
        cuts = [0.0, dur / 4, dur / 2, dur]
        ann[vid] = {"duration": dur, "timestamps": [[a, b] for a, b in zip(cuts, cuts[1:])],
                    "sentences": ["mixing the dough", "the oven is hot", "slicing the bread"]}
        asr[vid] = {"text": ["we mix", "we bake", "we slice"], "start": cuts[:3],
                    "end": cuts[1:]}
    (root / "zs_vcgr.json").write_text(json.dumps(ann))
    with open(root / "zs_vcgr_asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    t0 = time.time()
    _, clip_metrics = run_vcgr(str(root / "zs_vcgr.json"), features_path=dict(VIDEO_FEATURES),
                               text_embed_fn=text_embed_fn, mode="clip")
    clip_s = time.time() - t0
    _, random_metrics = run_vcgr(str(root / "zs_vcgr.json"),
                                 subtitles_path=str(root / "zs_vcgr_asr.pkl"), mode="random")
    for name, m in (("clip", clip_metrics), ("random", random_metrics)):
        _finite_metrics(m, f"run_vcgr {name}")
    say(f"[zeroshot] (c) run_vcgr over {len(ann)} videos of phase 11's features: clip "
        f"{clip_metrics} in {clip_s:.2f} s, random {random_metrics} on {card}")
    del tower
    return {"videos": len(ann), "clip_metrics": clip_metrics, "clip_s": clip_s,
            "random_metrics": random_metrics}


def _small_blip2_cfg(dtype: str = "float32", layers: int = 2):
    """Blip2Config() cut to ``layers`` layers a tower (widths kept)."""
    from vidchapters_tpu_torch.models import blip2

    base = blip2.Blip2Config()
    return blip2.Blip2Config(
        vision=dataclasses.replace(base.vision, num_layers=layers, dtype=dtype),
        qformer=dataclasses.replace(base.qformer, num_layers=layers, dtype=dtype),
        t5=dataclasses.replace(base.t5, num_layers=layers, num_decoder_layers=layers,
                               dtype=dtype))


def _cli_json(fn, argv):
    """Run a CLI entry point, returning the JSON of its last stdout line."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _torch_test_helpers():
    """``tests/_torch_helpers.py`` (the synthetic HF BLIP-2 writer the CPU
    tests share), loaded from its file: a ``tests`` package installed on
    the machine would shadow the repo's ``tests`` directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_torch_helpers",
                                                  ROOT / "tests" / "_torch_helpers.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def zeroshot_clis(card: str, root: Path, cfg=None):
    """(d) The CLIs on the card from a synthetic HF BLIP-2 directory (2
    layers a tower at full width, fp32 weights): ``vc_main --eval
    --model-type blip2`` and ``zeroshot.run visual``; ``vc_main --model-type
    llama`` raises with its loader's message."""
    import numpy as np

    from vidchapters_tpu_torch.train import vc_main
    from vidchapters_tpu_torch.zeroshot import run as zs_run

    cfg = cfg or _small_blip2_cfg()
    t0 = time.time()
    blip2_dir = _torch_test_helpers().write_blip2_dir(root / "blip2_hf", cfg, seed=25)
    feats = root / "zs_cli_feats"
    feats.mkdir()
    ann = json.loads((root / "zs_visual.json").read_text())
    for vid, a in ann.items():
        np.save(feats / f"{vid}.npy", np.zeros((int(a["duration"]), 768), np.float32))
    videos = root / "zs_cli_videos.json"
    videos.write_text(json.dumps({vid: str(root / f"{vid}.mp4") for vid in ann}))
    base = ["--val-json", str(root / "zs_visual.json"), "--features-path", str(feats),
            "--save-dir", str(root / "zs_cli_out"), "--eval", "--device", DEVICE]
    vc = _cli_json(vc_main._cli, base + ["--model-type", "blip2", "--blip2-dir", str(blip2_dir),
                                         "--videos-path", str(videos)])
    _finite_metrics(vc, "vc_main --model-type blip2")
    visual = _cli_json(zs_run.main, ["visual", "--ann", str(root / "zs_visual.json"),
                                     "--videos", str(videos), "--blip2_dir", str(blip2_dir),
                                     "--out", str(root / "zs_visual_preds.json"),
                                     "--device", DEVICE])
    _finite_metrics(visual, "zeroshot.run visual")
    preds = json.loads((root / "zs_visual_preds.json").read_text())["results"]
    check(set(preds) == set(ann), f"zeroshot.run visual predicted {sorted(preds)}")
    try:
        vc_main._cli(base + ["--model-type", "llama", "--llama-dir", str(root / "llama")])
        check(False, "vc_main --model-type llama did not raise")
    except NotImplementedError as e:
        llama_message = str(e)
    check("SentencePiece BPE" in llama_message, f"llama's message: {llama_message}")
    wall = time.time() - t0
    say(f"[zeroshot] (d) CLIs from a synthetic HF BLIP-2 directory in {wall:.1f} s: vc_main "
        f"blip2 CIDEr {vc.get('CIDEr')}, zeroshot.run visual soda_c {visual.get('soda_c')}; "
        f"vc_main llama raises: {llama_message[:80]}... on {card}")
    return {"vc_main_blip2": vc, "zeroshot_visual": visual, "llama_message": llama_message,
            "wall_s": wall}


def zeroshot_fp32_check(llama_cfg=None, blip2_cfg=None):
    """(e) fp32 tokens card against CPU: LLaMA at 2 layers, d 256, GQA 8/2,
    over ragged left-padded prompts; BLIP-2 at 2 + 2 + 2 + 2 layers (widths
    kept), greedy and at beam 2. Identical."""
    import copy

    import numpy as np
    import torch

    from vidchapters_tpu_torch.models import blip2, llama

    out = {}
    lcfg = llama_cfg or llama.LlamaConfig(hidden_size=256, intermediate_size=512, num_layers=2,
                                          num_heads=8, num_kv_heads=2)
    cpu = llama.init_llama(lcfg, "cpu", seed=26)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(27)
    ids = rng.integers(3, lcfg.vocab_size, (3, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, :7], mask[1, :7] = 1, 0
    ids[2, :15], mask[2, :15] = 1, 0
    ref = llama.llama_greedy_generate(cpu, torch.from_numpy(ids), torch.from_numpy(mask), 12)
    got = llama.llama_greedy_generate(card, torch.from_numpy(ids).to(DEVICE),
                                      torch.from_numpy(mask).to(DEVICE), 12).cpu()
    check(torch.equal(got, ref), f"fp32 LLaMA tokens card vs CPU differ:\n{got}\n{ref}")
    out["llama_tokens"] = ref.tolist()
    del cpu, card
    bcfg = blip2_cfg or _small_blip2_cfg()
    cpu = blip2.init_blip2(bcfg, "cpu", seed=28)
    card = copy.deepcopy(cpu).to(DEVICE)
    px = rng.normal(size=(2, 3, bcfg.vision.image_size, bcfg.vision.image_size))
    px = torch.from_numpy(px.astype(np.float32))
    bids = torch.from_numpy(rng.integers(3, 32000, (2, 14)).astype(np.int64))
    bmask = torch.ones_like(bids)
    for beams in (1, 2):
        ref = blip2.blip2_generate(cpu, px, bids, bmask, 12, num_beams=beams)
        got = blip2.blip2_generate(card, px.to(DEVICE), bids.to(DEVICE), bmask.to(DEVICE), 12,
                                   num_beams=beams).cpu()
        check(torch.equal(got, ref), f"fp32 BLIP-2 tokens at beam {beams} card vs CPU differ:"
                                     f"\n{got}\n{ref}")
        out[f"blip2_tokens_beam{beams}"] = ref.tolist()
    say("[zeroshot] (e) fp32 tokens card vs CPU identical: LLaMA 2 layers d 256 GQA 8/2 "
        "(3 ragged left-padded prompts, 12 tokens), BLIP-2 2+2+2+2 layers (greedy and beam 2)")
    return out


def phase_zeroshot(card: str, llama_cfg=None, blip2_cfg=None, cli_cfg=None, text_cfg=None,
                   fp32_cfgs=(None, None), n_videos: int = ZS_VIDEOS):
    """Phase 12, the paper's zero-shot baselines: (a) speech chapters at
    LLaMA-7B, (b) visual chapters and VC at BLIP-2 Flan-T5-XL, (c) zero-shot
    grounding, (d) the CLIs, (e) fp32 tokens card vs CPU. Returns (summary,
    the launches of rows 3, 5 and 6 in (b))."""
    import torch

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        speech = zeroshot_speech(card, root, llama_cfg, n_videos)
        visual, launches = zeroshot_visual(card, root, blip2_cfg)
        grounding = zeroshot_grounding(card, root, text_cfg)
        clis = zeroshot_clis(card, root, cli_cfg)
    torch.cuda.empty_cache()
    fp32 = zeroshot_fp32_check(*fp32_cfgs)
    summary = {"card": card, "speech": speech, "visual": visual, "grounding": grounding,
               "clis": clis, "fp32": fp32, "launches": launches,
               "wall_s": time.time() - t_phase}
    say(f"[zeroshot] phase 12 in {summary['wall_s']:.1f} s on {card}")
    return summary, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this script runs the port on a GPU", flush=True)
        return 1
    if not (ROOT / "vidchapters_tpu_torch" / "csrc").is_dir():
        print(f"FAIL: no vidchapters_tpu_torch package beside {__file__}", flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 checks are full fp32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = phase_device_and_build()
        gen = torch.Generator().manual_seed(1)
        table = [check_fused_attention(gen), check_fused_attention_bwd(gen)]
        table[0]["hmma_per_kernel"] = check_tensor_cores()
        table[0].update(check_fused_attention_vision(gen))
        gen = serving_checks_generator()
        table += [check_topk(gen), check_megakernel(gen)]
        gen = torch.Generator().manual_seed(2)
        table += [check_decode_self_attention(gen), check_decode_cross_attention(gen)]
        for row, extra in zip(table[-2:], check_decode_attention_blip2(gen)):
            row.update(extra)
        table += check_deformable_attention(torch.Generator().manual_seed(3))
        table.append(check_whisper_megakernel(torch.Generator(device="cuda").manual_seed(4)))
        torch.cuda.empty_cache()
        from vidchapters_tpu_torch.ops import probes

        probes.KERNEL.launches = 0
        table += check_probes()
        probe_launches = probes.KERNEL.launches
        for row in table:
            say(f"[time] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']}, bound {row['bound_ms']:.4f} by "
                f"{row['bound_by']}) on {card}")
        train, train_launches = phase_train(card)
        e2e, serve_launches, fp32, (fp32_state, fp32_inputs) = phase_end_to_end(card)
        evaluation, eval_launches, phase5_weights = phase_train_and_evaluate(
            card, fp32_state, fp32_inputs)
        del fp32_state, fp32_inputs
        torch.cuda.empty_cache()
        pdvc, pdvc_launches = phase_pdvc(card)
        torch.cuda.empty_cache()
        asr_run, asr_launches = phase_asr(card)
        torch.cuda.empty_cache()
        pretrain, pretrain_launches = phase_pretrain(card)
        torch.cuda.empty_cache()
        reference, reference_launches = phase_reference_checkpoint(card)
        torch.cuda.empty_cache()
        vc, vc_launches = phase_vc(card, phase5_weights)
        del phase5_weights
        torch.cuda.empty_cache()
        grounding = phase_grounding(card)
        torch.cuda.empty_cache()
        video, feature_launches, demo_launches = phase_video(card)
        torch.cuda.empty_cache()
        zeroshot, zeroshot_launches = phase_zeroshot(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    for row in table:  # each kernel's count on its own main path
        if row["name"] in DECODE_KERNELS:
            row["launches"] = eval_launches[row["name"]]
        elif row["name"] in DEFORM_KERNELS:
            row["launches"] = pdvc_launches[row["name"]]
        elif row["name"] in asr_launches:
            row["launches"] = asr_launches[row["name"]]
        elif row["name"].startswith("probe_"):
            # the probes lie on no path: their count is phase 2's own run
            row["launches"] = probe_launches
            row["launches_from"] = "phase 2 (the probes lie on no main path)"
        else:
            row["launches"] = train_launches.get(row["name"], serve_launches.get(row["name"]))
    table[0]["launches_serving"] = serve_launches["fused_attention_fwd"]
    for row in table[:2]:  # rows 1-2 on the pretraining path (phase 8a)
        row["launches_pretrain"] = pretrain_launches[row["name"]]
    for row in table:  # rows 1-4 on VC's training and eval (phase 9)
        if row["name"] in vc_launches:
            row["launches_vc"] = vc_launches[row["name"]]
    table[0]["launches_features"] = feature_launches  # phase 11(a)
    for row in table:  # rows 1, 3 and 4 in demo_vid2seq (phase 11b)
        if row["name"] in demo_launches:
            row["launches_demo"] = demo_launches[row["name"]]
    for row in table:  # rows 3, 5 and 6 in BLIP-2's zero-shot paths (phase 12b)
        if zeroshot_launches.get(row["name"]):
            row["launches_zeroshot"] = zeroshot_launches[row["name"]]
    say(f"[summary] serving {e2e['videos_per_s']:.3f} videos/s (megakernel, beam 4); eval "
        f"{evaluation['eval_videos_per_s_beam4_standard']:.3f} videos/s (standard, beam 4), "
        f"{evaluation['eval_videos_per_s_nucleus']:.3f} videos/s (nucleus); training "
        f"{train['step_ms']:.1f} ms/step (phase 3), dvc_main steps "
        f"{[round(x, 1) for x in evaluation['train_step_ms']]} ms; PDVC "
        f"{pdvc['train_step_ms_mean_after_first']:.2f} ms/step, eval "
        f"{pdvc['eval_videos_per_s']:.3f} videos/s; ASR "
        f"{asr_run['sweep']['audio_s_per_s']:.2f} audio-s/s (large-v2, batch 8); pretraining "
        f"{pretrain['step_ms_mean_timed']:.1f} ms/step at batch {pretrain['batch']} "
        f"({pretrain['videos_per_s']:.2f} videos/s, peak {pretrain['peak_memory_bytes']} B); "
        f"reference .pth served with launches {reference_launches}; VC "
        f"{vc['step_ms_mean_after_first']:.1f} ms/step, eval {vc['eval_clips_per_s'][-1]:.2f} "
        f"clips/s; grounding {grounding['step_ms_mean_after_first']:.1f} ms/step at batch "
        f"{grounding['batch']} (peak {grounding['peak_memory_bytes']} B); video features "
        f"{video['features']['kernel']['frames_per_s']:.1f} frames/s (plain route "
        f"{video['features']['plain']['frames_per_s']:.1f}), demo_vid2seq "
        f"{video['demo']['wall_s']:.2f} s, alignment {video['align']['wall_s']:.2f} s; "
        f"zero-shot: LLaMA-7B {zeroshot['speech']['titles_per_s']:.2f} titles/s, BLIP-2 "
        f"greedy step {zeroshot['visual']['greedy_step_ms']:.3f} ms")
    record = {"kernels": table, "train": train, "end_to_end": e2e, "fp32_tokens": fp32,
              "evaluation": evaluation, "pdvc": pdvc, "asr": asr_run, "pretrain": pretrain,
              "reference_checkpoint": reference, "vc": vc, "grounding": grounding, "video": video,
              "zeroshot": zeroshot, "card": card}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
