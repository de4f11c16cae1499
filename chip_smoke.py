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
   autograd, at the 1000-long padded case; top-k over [8, 4*32200] with
   forced ties, exactly; the decode kernel at 8 examples x 4 beams, 12
   layers, L=256, Lenc=1152, at several cache indices with a beam
   permutation. Each kernel's time (CUDA events), its plain version's time,
   the one-call library yardstick where one exists, and its bound.
3. Training at full width: Vid2Seq (T5-base + 12-layer ViT, dropout 0.1)
   trained by make_train_step on batches of 8 from the port's EpochIterator
   over a synthetic on-disk dataset (input 1000, output 256, denoising
   804 / 304 tokens): 1 warm-up step, 5 timed steps (step ms, videos/s,
   peak memory, the fused-attention launches, 48 of each per step), one
   profiled step, then an fp32 gradient check: one step at 2+2 layers,
   dropout 0, kernels on the card against the plain versions on the CPU.
4. Serving end to end at full width: Vid2Seq with seeded
   random weights, beam 4 / max_length 256, behind serve() on 127.0.0.1;
   10 concurrent HTTP requests (8 in the 1000-token bucket, 2 short). The
   kernels' launch counts are zeroed just before the requests and read just
   after; each must be > 0. Then two requests at max_length 64 in fp32,
   once with the kernels on the card and once with the plain versions on
   the CPU: the tokens must be identical.

The kernels' launch counts are zeroed just before each main path (phases 3
and 4) and read just after it; the kernel line reports each kernel's
count from its own path (training for the fused attention, serving for
top-k and the decode kernel).

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
                         "decode_megakernel"])
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "smem")):
                say(f"[build] {name}: {line.strip()}")
    say(f"[build] ok in {time.time() - t0:.1f} s ({', '.join(logs)})")
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


SEED = 0x5EED1234  # the dropout seed of the kernel checks
RATE = 0.1         # the recipe's dropout rate


def _attention_inputs(gen, form: str, dtype, length: int = 1024):
    """The two forms the training path gives the fused attention: "encoder"
    (T5 encoder self-attention, [8,12,L,64] with the relative-position bias
    and per-example key padding) and "cross" (decoder cross-attention, 256
    queries over 1152 keys, no bias, 100 frames + per-example ASR length).
    Also a random output gradient."""
    import torch

    from vidchapters_tpu_torch.models.t5 import relative_position_bucket

    b, h, d = 8, 12, 64
    lq, lk = (length, length) if form == "encoder" else (256, 1152)
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
            mask[i, 100 + 1000 - 90 * i:] = 0
    dout = torch.randn(b, h, lq, d, generator=gen)
    on = lambda t: None if t is None else t.to("cuda", dtype)  # noqa: E731
    return on(q), on(k), on(v), on(bias), mask.cuda(), on(dout)


def check_fused_attention(gen):
    """The forward, without and with dropout, at both forms: the dropout
    rows agree to the same tolerance only if every keep decision matches
    (one flipped decision moves an output by a whole p*v term)."""
    import torch

    from vidchapters_tpu_torch.ops import fused_attention as fa

    errs = {}
    cases = [(form, length, dtype, tol, rate)
             for form, length in (("encoder", 1024), ("cross", 1024), ("encoder", 1000))
             for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
             for rate in (0.0, RATE) if length == 1024 or dtype == torch.float32]
    for form, length, dtype, tol, rate in cases:
        q, k, v, bias, mask, _ = _attention_inputs(gen, form, dtype, length)
        got = fa.fused_attention_padded(q, k, v, bias, mask, seed=SEED, dropout_rate=rate)
        if length % 128:  # the plain version at the padded shape, as the wrapper pads
            lp = -(-length // 128) * 128
            qp, kp, vp = (fa._pad_to(t, lp, 2) for t in (q, k, v))
            ref = fa.fused_attention_plain(qp, kp, vp, fa._pad_to(fa._pad_to(bias, lp, 2), lp, 3),
                                           fa._pad_to(mask, lp, 1), SEED, rate)[:, :, :length]
        else:
            ref = fa.fused_attention_plain(q, k, v, bias, mask, SEED, rate)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        say(f"[check] fused_attention {form} L={length} {dtype} dropout {rate}: "
            f"max_abs_err {err:.3e} (tol {tol})")
        check(err <= tol, f"fused_attention {form} L={length} {dtype} rate {rate}: "
                          f"err {err} > {tol}")
        errs[(form, length, dtype, rate)] = err
    q, k, v, bias, mask, _ = _attention_inputs(gen, "encoder", torch.bfloat16)
    b, h, l, d = q.shape
    # the training form: dropout and the log-sum-exp for the backward
    ms = time_ms(lambda: fa._forward(q, k, v, bias, mask, SEED, RATE, want_lse=True))
    ms_serving = time_ms(lambda: fa.fused_attention(q, k, v, bias, mask))
    plain_ms = time_ms(lambda: fa.fused_attention_plain(q, k, v, bias, mask, SEED, RATE), 5)
    float_mask = (bias + (mask[:, None, None, :].to(bias.dtype) - 1) * 1e9).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=float_mask, dropout_p=RATE, scale=1.0))
    nbytes = 4 * b * h * l * d * 2 + h * l * l * 2 + b * l * 4 + b * h * l * 4
    bms, by = bound(nbytes, 4 * b * h * l * l * d, H100_BF16_FLOPS)
    torch.cuda.synchronize()
    return {"name": "fused_attention_fwd", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/fused_attention_fwd.cu",
            "replaces": "vidchapters_tpu/ops/fused_attention.py:163",
            "max_abs_err": errs[("encoder", 1024, torch.bfloat16, RATE)],
            "max_abs_err_fp32": errs[("encoder", 1024, torch.float32, RATE)],
            "max_abs_err_all": max(errs.values()),
            "ms": ms, "ms_serving_form": ms_serving, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": "q/k/v [8,12,1024,64] bf16, bias [1,12,1024,1024], dropout 0.1, lse out"}


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
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library": f"SDPA fwd+bwd, float mask with bias grad, "
                                             f"backend {backend}",
            "shape": "q/k/v/out/dout [8,12,1024,64] bf16, bias [1,12,1024,1024], dropout 0.1"}


def serving_checks_generator():
    """The generator the top-k and decode-kernel checks draw from: seed 0,
    advanced past the draws of the original (forward-only) attention check,
    four sets of q/k/v [8,12,L,64] and a [32,12] table at L = 1024, 1024,
    1000, 1024, so these two checks keep the inputs they were validated on.
    (On other random inputs the bf16 decode kernel was seen 0.03125 from its
    plain version, past the check's 3e-2 / two-ulp bound: PERF.md, open
    questions.)"""
    import torch

    gen = torch.Generator().manual_seed(0)
    for length in (1024, 1024, 1000, 1024):
        for _ in range(3):
            torch.randn(8, 12, length, 64, generator=gen)
        torch.randn(32, 12, generator=gen)
    return gen


def check_topk(gen):
    import torch

    from vidchapters_tpu_torch.ops import decoding as dec

    rows, n, k = 8, 4 * 32200, 8
    x = torch.randn(rows, n, generator=gen) - 20.0
    x[0, 5] = x[0, 70000] = x[0].max() + 1.0
    x[1, 10:13] = x[1].max() + 2.0
    x[2] = -1e7                       # beam-search start rows: ulp 1.0
    x[2, 32200:32210] = -1e7 + 1.0
    x[3, ::97] = x[3].max() + 0.5
    x = x.cuda()
    got_v, got_i = dec._topk_small(x, k)
    ref_v, ref_i = dec._topk_iterative(x, k)
    torch.cuda.synchronize()
    check(torch.equal(got_i, ref_i) and torch.equal(got_v, ref_v), "top-k differs from plain")
    say("[check] topk [8,128800] f32 k=8: values and indices identical")
    ms = time_ms(lambda: dec._topk_small(x, k), 50)
    plain_ms = time_ms(lambda: dec._topk_iterative(x, k), 10)
    lib_ms = time_ms(lambda: torch.topk(x, k), 50)
    bms, by = bound(rows * n * 4 + rows * k * 8, rows * n * k, H100_FP32_FLOPS)
    return {"name": "topk", "route": "cuda", "source": "vidchapters_tpu_torch/csrc/topk.cu",
            "replaces": "vidchapters_tpu/ops/decoding.py:269", "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "shape": "[8, 128800] f32, k=8"}


def check_megakernel(gen):
    import torch

    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    b0, g, n, length, lenc, d, heads, dff = 8, 4, 12, 256, 1152, 768, 12, 3072
    inner, rows = d, b0 * g

    def w(*shape, fan_in):
        return torch.randn(*shape, generator=gen) * fan_in ** -0.5

    # T5's init scales: q carries the absent 1/sqrt(d_kv) of the scores
    dkv = inner // heads
    stacked = {"ln": 1.0 + 0.1 * torch.randn(n, 3, d, generator=gen),
               "wqkv": torch.cat([w(n, d, inner, fan_in=d * dkv),
                                  w(n, d, 2 * inner, fan_in=d)], dim=2),
               "wo_self": w(n, inner, d, fan_in=inner),
               "wq_cross": w(n, d, inner, fan_in=d * dkv),
               "wo_cross": w(n, inner, d, fan_in=inner),
               "wi": w(n, d, dff, fan_in=d), "wo_ff": w(n, dff, d, fan_in=dff),
               "final_ln": 1.0 + 0.1 * torch.randn(1, d, generator=gen)}
    x = torch.randn(rows, d, generator=gen)
    kc, vc = (torch.randn(rows, n, length, inner, generator=gen) for _ in range(2))
    kx, vx = (torch.randn(b0, n, lenc, inner, generator=gen) for _ in range(2))
    bias_all = torch.randn(length, length, heads, generator=gen)
    mask = torch.ones(b0, lenc, dtype=torch.int32)
    for e in range(b0):
        mask[e, 100 + 100 * e:] = 0   # 100 video frames + per-example ASR length
    src = torch.tensor([(r // g) * g + (r * 3 + 1) % g for r in range(rows)], dtype=torch.int32)

    def on(dtype):
        st = {kk: (v.cuda() if kk in ("ln", "final_ln") else v.to("cuda", dtype))
              for kk, v in stacked.items()}
        return st, [t.to("cuda", dtype) for t in (x, kc, vc, kx, vx)]

    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        st, (xx, kk, vv, kxx, vxx) = on(dtype)
        m, s = mask.cuda(), src.cuda()
        worst = 0.0
        for idx in (0, 1, 127, 128, 255):
            br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
            got = dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g, heads, src=s)
            ref = dm.mega_decode_step_plain(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g,
                                            heads, src=s)
            torch.cuda.synchronize()
            per = {name: (a.float() - r.float()).abs().max().item()
                   for name, a, r in zip(("hidden", "k_new", "v_new"), got, ref)}
            err = max(per.values())
            check(all(within(a, r, tol) for a, r in zip(got[:3], ref[:3])),
                  f"decode kernel {dtype} idx={idx}: err {per} > {tol}")
            for a, r, new in ((got[3], ref[3], got[1]), (got[4], ref[4], got[2])):
                check(torch.equal(a[:, :, :idx], r[:, :, :idx]),
                      f"decode kernel {dtype} idx={idx}: permuted cache rows differ")
                check(torch.equal(a[:, :, idx], new),
                      f"decode kernel {dtype} idx={idx}: cache row idx != new k/v")
            worst = max(worst, err)
        say(f"[check] decode kernel {dtype} idx 0/1/127/128/255: max_abs_err {worst:.3e} "
            f"(tol {tol}{', or 2 bf16 ulps' if dtype == torch.bfloat16 else ''}); "
            f"permuted rows and new rows exact")
        errs[dtype] = worst
    st, (xx, kk, vv, kxx, vxx) = on(torch.bfloat16)
    m, s, idx = mask.cuda(), src.cuda(), 128
    br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
    outs = (torch.empty_like(kk), torch.empty_like(vv))
    ms = time_ms(lambda: dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g,
                                             heads, src=s, out_caches=outs))
    plain_ms = time_ms(lambda: dm.mega_decode_step_plain(st, xx, kk, vv, kxx, vxx, br, b0b,
                                                         m, idx, g, heads, src=s), 3)
    params = n * (d * 3 * inner + 3 * inner * d + d * dff + dff * d)
    nbytes = (params * 2 + n * 4 * d * 4                       # weights, norms
              + 2 * b0 * n * lenc * inner * 2                  # cross K/V
              + 2 * rows * n * idx * inner * 2                 # self rows read
              + 2 * rows * n * (idx + 1) * inner * 2           # self rows written
              + rows * d * 2 * 2 + 2 * rows * n * inner * 2)   # x, hidden, k/v new
    flops = 2 * rows * params + 4 * rows * n * inner * (idx + 1 + lenc)
    bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
    torch.cuda.synchronize()
    return {"name": "decode_megakernel", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/decode_megakernel.cu",
            "replaces": "vidchapters_tpu/ops/decode_megakernel.py:519",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": "8 examples x 4 beams, 12 layers, L=256, Lenc=1152, idx=128, bf16"}


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5            # timed steps, after one warm-up step
FUSED_PER_STEP = 48        # 12 layers x (encoder self + decoder cross) x 2 passes


def _write_train_dataset(root: Path, n_videos: int, seed: int = 0) -> Path:
    """Features (.npy per video, 80-240 frames of 768), an annotation json
    of 8 chapters per video (enough to fill 256 output tokens) and an ASR
    pickle of 40 segments per video (enough to fill 1000 input tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "features").mkdir()
    ann, asr = {}, {}
    for i in range(n_videos):
        vid = f"vid{i:08d}"
        np.save(root / "features" / f"{vid}.npy",
                rng.standard_normal((int(rng.integers(80, 240)), 768)).astype(np.float32))
        starts = np.linspace(0.0, 540.0, 8)
        ann[vid] = {"duration": 600.0,
                    "timestamps": [[float(s), float(s) + 60.0] for s in starts],
                    "sentences": [f"chapter {j} of video {i}: we knead the dough, fold it "
                                  f"twice and let it rest" for j in range(8)]}
        st = np.linspace(0.0, 590.0, 40)
        asr[vid] = {"text": [f"in step {j} of video {i} we whisk eggs and fold in flour"
                             for j in range(40)],
                    "start": st.tolist(), "end": (st + 5.0).tolist()}
    (root / "ann.json").write_text(json.dumps(ann))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root


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
    kernels = {}  # device-side events only: operators and autograd nodes
    for ev in prof.key_averages():  # report their kernels' time as their own
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    groups = {"fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0, "matmul (cuBLAS)": 0.0,
              "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "fused_attention_fwd" in low:
            groups["fused_attention_fwd"] += ms
        elif any(w in low for w in ("dkdv_kernel", "dq_kernel", "delta_kernel")):
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
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / step_ms) if busy else None,
            "by_group_ms": groups, "top_kernels_ms": [[n[:90], t] for n, t in top]}


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
    fp32 = fp32_token_check(cfg, cpu_state, engine, payloads[:2])
    return e2e, launches, fp32


def fp32_token_check(cfg, state, engine, payloads):
    """Two 1000-bucket requests at max_length 64 in fp32: kernels on the card
    against the plain versions on the CPU; the tokens must be identical."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch.data.features import subsample_or_pad
    from vidchapters_tpu_torch.models.t5 import shift_right
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    mcfg = dataclasses.replace(cfg.model, t5=dataclasses.replace(cfg.model.t5, dtype="float32"),
                               vit=dataclasses.replace(cfg.model.vit, dtype="float32"))
    # the repetition penalty keeps the random model off one repeated token,
    # so the comparison spans 64 distinct decisions per hypothesis
    gen = dataclasses.replace(cfg.generation, max_length=64, repetition_penalty=3.0)
    videos = np.stack([subsample_or_pad(np.asarray(p["features"], np.float32), 100, 768)
                       for p in payloads])
    tokens = np.zeros((2, 1000), np.int32)
    for i, p in enumerate(payloads):
        ids = engine._input_tokens(p["asr"], p["duration"])[:1000]
        tokens[i, :len(ids)] = ids
    out = {}
    for path, dev in (("kernels", DEVICE), ("plain", "cpu")):
        model = Vid2Seq(mcfg)
        model.load_state_dict(state)
        model.to(dev).eval()
        t0 = time.time()
        seqs = make_generate_fn(model, gen)(torch.from_numpy(videos).to(dev),
                                            torch.from_numpy(tokens).to(dev))
        out[path] = seqs.cpu().numpy()
        say(f"[fp32] {path} on {dev}: {time.time() - t0:.1f} s, "
            f"first tokens {out[path][0, :8].tolist()}")
    if not np.array_equal(out["kernels"], out["plain"]):
        row, step = map(int, np.argwhere(out["kernels"] != out["plain"])[0])
        with torch.no_grad():  # the plain path's own logits at that step
            tv, tt = torch.from_numpy(videos[row:row + 1]), torch.from_numpy(tokens[row:row + 1])
            enc, mask = model.encode(tv, tt, (tt != 0).to(torch.int32))
            labels = torch.from_numpy(out["plain"][row:row + 1, :step + 1]).long()
            logits = model.t5.decode(shift_right(labels), torch.ones_like(labels), enc, mask)
            top2 = torch.topk(torch.log_softmax(logits[0, step], -1), 2).values
        raise SmokeFailure(f"fp32 tokens differ at row {row} step {step}: kernels "
                           f"{out['kernels'][row, step]} vs plain {out['plain'][row, step]}, "
                           f"top-2 log-prob gap there {float(top2[0] - top2[1]):.3e}")
    say(f"[fp32] tokens identical over {out['plain'].shape} (max_length 64)")
    return {"identical": True, "shape": list(out["plain"].shape)}


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
        gen = serving_checks_generator()
        table += [check_topk(gen), check_megakernel(gen)]
        for row in table:
            say(f"[time] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']}, bound {row['bound_ms']:.4f} by "
                f"{row['bound_by']}) on {card}")
        train, train_launches = phase_train(card)
        e2e, serve_launches, fp32 = phase_end_to_end(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    for row in table:  # each kernel's count on its own main path
        row["launches"] = train_launches.get(row["name"], serve_launches.get(row["name"]))
    table[0]["launches_serving"] = serve_launches["fused_attention_fwd"]
    record = {"kernels": table, "train": train, "end_to_end": e2e, "fp32_tokens": fp32,
              "card": card}
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
