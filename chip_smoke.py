#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vidchapters_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero with no result:

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel under vidchapters_tpu_torch/csrc/ compiled with nvcc (its
   -Xptxas -v lines: registers, shared memory, spills).
2. Kernels against their plain PyTorch versions on the card, at the serving
   path's shapes, from a fixed seed: fused attention [8,12,1024,64] (and a
   1000-long padded case) in fp32 and bf16; top-k over [8, 4*32200] with
   forced ties, exactly; the decode kernel at 8 examples x 4 beams, 12
   layers, L=256, Lenc=1152, at several cache indices with a beam
   permutation. Each kernel's time (CUDA events), its plain version's time,
   the one-call library yardstick where one exists, and its bound.
3. End to end at full width: Vid2Seq (T5-base + 12-layer ViT) with seeded
   random weights, beam 4 / max_length 256, behind serve() on 127.0.0.1;
   10 concurrent HTTP requests (8 in the 1000-token bucket, 2 short). The
   kernels' launch counts are zeroed just before the requests and read just
   after; each must be > 0. Then two requests at max_length 64 in fp32,
   once with the kernels on the card and once with the plain versions on
   the CPU: the tokens must be identical.

The last lines are the kernel table as one JSON object, the nvidia-smi
line, and {"ok": true, "device": {...}}. The full record also goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES = 3.35e12       # HBM3 bytes/s
DEVICE = "cuda"            # where phase 3 serves and runs the kernel path


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
    logs = _build.build(["fused_attention_fwd", "topk", "decode_megakernel"])
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "smem")):
                say(f"[build] {name}: {line.strip()}")
    say(f"[build] ok in {time.time() - t0:.1f} s ({', '.join(logs)})")
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def check_fused_attention(gen):
    import torch

    from vidchapters_tpu_torch.models.t5 import relative_position_bucket
    from vidchapters_tpu_torch.ops import fused_attention as fa

    b, h, l, d = 8, 12, 1024, 64
    dev = "cuda"

    def inputs(length, dtype):
        q, k, v = (torch.randn(b, h, length, d, generator=gen) * 0.5 for _ in range(3))
        emb = torch.randn(32, h, generator=gen) * 768 ** -0.5
        pos = torch.arange(length)
        bias = emb[relative_position_bucket(pos[None] - pos[:, None], True, 32, 128).long()]
        bias = bias.permute(2, 0, 1)[None].contiguous()
        mask = torch.ones(b, length, dtype=torch.int32)
        for i in range(b):  # per-example valid lengths, leaving padding
            mask[i, length - 37 * i:] = 0
        return [x.to(dev, dtype) for x in (q, k, v, bias)] + [mask.to(dev)]

    errs = {}
    for length, dtype, tol in ((l, torch.float32, 1e-4), (l, torch.bfloat16, 2e-2),
                               (1000, torch.float32, 1e-4)):
        q, k, v, bias, mask = inputs(length, dtype)
        got = fa.fused_attention_padded(q, k, v, bias, mask)
        ref = fa.fused_attention_plain(q, k, v, bias, mask)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        say(f"[check] fused_attention L={length} {dtype}: max_abs_err {err:.3e} (tol {tol})")
        check(err <= tol, f"fused_attention L={length} {dtype} err {err} > {tol}")
        errs[(length, dtype)] = err
    q, k, v, bias, mask = inputs(l, torch.bfloat16)
    ms = time_ms(lambda: fa.fused_attention(q, k, v, bias, mask))
    plain_ms = time_ms(lambda: fa.fused_attention_plain(q, k, v, bias, mask), 5)
    float_mask = (bias + (mask[:, None, None, :].to(bias.dtype) - 1) * 1e9).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=float_mask, scale=1.0))
    nbytes = 4 * b * h * l * d * 2 + h * l * l * 2 + b * l * 4
    bms, by = bound(nbytes, 4 * b * h * l * l * d, H100_BF16_FLOPS)
    torch.cuda.synchronize()
    return {"name": "fused_attention_fwd", "route": "cuda",
            "source": "vidchapters_tpu_torch/csrc/fused_attention_fwd.cu",
            "replaces": "vidchapters_tpu/ops/fused_attention.py:163",
            "max_abs_err": errs[(l, torch.bfloat16)], "max_abs_err_fp32": errs[(l, torch.float32)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "shape": "q/k/v [8,12,1024,64] bf16, bias [1,12,1024,1024]"}


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
# phase 3
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
        gen = torch.Generator().manual_seed(0)
        table = [check_fused_attention(gen), check_topk(gen), check_megakernel(gen)]
        for row in table:
            say(f"[time] {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']}, bound {row['bound_ms']:.4f} by "
                f"{row['bound_by']}) on {card}")
        e2e, launches, fp32 = phase_end_to_end(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    for row in table:
        row["launches"] = launches[row["name"]]
    record = {"kernels": table, "end_to_end": e2e, "fp32_tokens": fp32, "card": card}
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
