#!/usr/bin/env python3
"""Where the port's kernel-part numbers and A/B comparisons come from, on one GPU.

    python3 chip_kernel_parts.py

1. The bf16 decode kernel's bound (chip_smoke.decode_kernel_tol): at
   chip_smoke's full-width inputs (8 examples x 4 beams, 12 layers, bf16),
   cache indices 0/1/127/128/255, the largest |difference| of hidden, k_new
   and v_new between the kernel and its plain version on the card, and
   between the plain version on the CPU and on the card, with the largest
   reference element and the share of elements past 3e-2.
2. The top-k kernel's time by part: device time (CUDA-graph replay) at
   [8, 128800] f32 for k 1 / 5 / 8 / 16 and 1 / 16 / 31 / 64 blocks a row,
   on random rows and on descending rows (after the first k elements none
   enters a thread's list, so the scan costs one compare an element).

    python3 chip_kernel_parts.py --whisper-ab DIR

3. The Whisper decode kernel of this tree against the one of another
   checkout DIR (e.g. the parent commit, unpacked with git archive into a
   git-ignored directory): device time by CUDA-graph replay at large-v2
   width, bf16, int8 cross K/V, idx 111, at 8 x 1, 2 x 5 and 8 x 5 rows,
   each tree timed in its own process, in turns DIR, this, this, DIR.

    python3 chip_kernel_parts.py --t5-ab DIR

4. The T5 decode kernel of this tree against the one of another checkout
   DIR, the same way: device time by CUDA-graph replay at chip_smoke's
   full-width inputs (T5-base decoder, 12 layers, bf16, idx 128), at 8 x 4
   (serving), 8 x 1 (greedy) and 2 x 4 rows, each tree timed in its own
   process, in turns DIR, this, this, DIR.

    python3 chip_kernel_parts.py --cross-ab DIR

5. The decode cross-attention kernel (row 6) and probe p2 of this tree
   against those of another checkout DIR, the same way: device time by
   CUDA-graph replay at chip_smoke's shape (q [32 or 8,12,1,64] over k/v
   [8,12,1152,64] bf16, 1100 - 90 e live keys of example e; the live ends
   found once where the wrapper takes them), also with the L2 cache flushed
   by a 64 MB read before each call, and at p2's [8,12,1,64] .
   [8,12,32,64] f32.

    python3 chip_kernel_parts.py --deform-ab DIR

6. The deformable attention's forward and backward (rows 7 and 7b) and
   probe p3 of this tree against those of another checkout DIR, the same
   way: device time by CUDA-graph replay at chip_smoke's PDVC shapes (value
   [1,188,8,64], 4 levels x 4 points, the encoder's 188 and the decoder's
   100 queries, f32; the backward with whatever zeroing of dvalue its
   wrapper does) and at p3's [12,8,64] . [12,64,32] f32 on random inputs.

    python3 chip_kernel_parts.py --pdvc-ab DIR

7. PDVC end to end for this tree and the checkout DIR: chip_smoke's phase
   6 (pdvc_main at configs/chapters_pdvc.json, with its launch counts and
   fp32 checks) run by each tree in its own process, in turns DIR, this,
   this, DIR; for each, train ms/step after the first step and the
   profiled train step's device ms by kernel group (the deformable
   attention's among them).

    python3 chip_kernel_parts.py --zeroshot-steps

8. The zero-shot towers' decode steps at full width (bf16, seeded random
   weights): LLaMA-7B at batch 1 over a 512-token prompt's cache, and
   BLIP-2 Flan-T5-XL's greedy step at 8 frames (the standard cached decode,
   rows 5 and 6): wall ms by CUDA events and one profiled step's device
   busy ms by kernel group.

    python3 chip_kernel_parts.py --learning-sweep

9. chip_smoke's phase 17 model (T5-base widths at 2 + 2 T5 and 2 ViT
   layers, bf16, train/overfit.py's 8 synthetic videos) trained at the
   settings of ``LEARNING_SWEEP`` (tokenizer: the byte-level fallback or
   the phase's synthetic spiece.model; T5 and ViT layers, dropout, peak
   lr, schedule, the denoising loss's weight, steps), with a beam-4 and a
   greedy call on the decode kernel's route every ``every`` steps: the
   generative loss, the videos whose chapters equal their targets, the
   decode steps and the train seconds at each.

Prints one JSON object; needs the card (exits 1 without one).
"""

from __future__ import annotations

import json
import subprocess
import sys


WHISPER_FORMS = ((8, 1), (2, 5), (8, 5))


def whisper_times(root: str) -> dict:
    """Device ms of the Whisper decode kernel of the checkout at ``root``
    (its own chip_smoke inputs and wrapper) at each of WHISPER_FORMS."""
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for b0, group in WHISPER_FORMS:
        st, x, kc, vc, ((kx, ks), (vx, vs)), src = cs._whisper_step_inputs(
            gen, b0, group, torch.bfloat16, True)
        outs = (torch.empty_like(kc), torch.empty_like(vc)) if src is not None else None
        out[f"{b0}x{group}"] = cs.time_ms_graph(
            lambda: wm.whisper_mega_step(st, x, kc, vc, kx, vx, 111, cs.WHISPER_H,
                                         cs.WHISPER_LENC, ks, vs, group, src, outs), 10, 3)
        del st, x, kc, vc, kx, vx, outs
        torch.cuda.empty_cache()
    return out


T5_FORMS = ((8, 4), (8, 1), (2, 4))


def t5_times(root: str) -> dict:
    """Device ms of the T5 decode kernel of the checkout at ``root`` (its
    own chip_smoke inputs and wrapper; the kernel's weight layout where its
    wrapper has one) at each of T5_FORMS, bf16, idx 128: the first g beams
    of the first b0 examples of the 8 x 4 inputs, with their permutation
    (one beam: greedy, none)."""
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    gen = cs.serving_checks_generator()
    torch.randn(8, 4 * 32200, generator=gen)  # check_topk's draw: the same inputs as the smoke
    stacked, x, kc, vc, kx, vx, bias_all, mask, src = cs.megakernel_inputs(gen)
    full, heads, dt, idx = cs.MEGA_SHAPE["g"], cs.MEGA_SHAPE["heads"], torch.bfloat16, 128
    st = {k: (v.cuda() if k in ("ln", "final_ln") else v.to("cuda", dt))
          for k, v in stacked.items()}
    if hasattr(dm, "with_kernel_layout"):
        st = dm.with_kernel_layout(st)
    br, b0b = bias_all[idx].cuda(), bias_all[0, :1].cuda().contiguous()
    out = {}
    for b0, g in T5_FORMS:
        rows = [e * full + j for e in range(b0) for j in range(g)]
        xx, kk, vv = (t[rows].to("cuda", dt) for t in (x, kc, vc))
        kxx, vxx, m = kx[:b0].to("cuda", dt), vx[:b0].to("cuda", dt), mask[:b0].cuda()
        s = src[rows].cuda() if g > 1 else None
        outs = (torch.empty_like(kk), torch.empty_like(vv)) if s is not None else None
        out[f"{b0}x{g}"] = cs.time_ms_graph(
            lambda: dm.mega_decode_step(st, xx, kk, vv, kxx, vxx, br, b0b, m, idx, g, heads,
                                        src=s, out_caches=outs), 10, 3)
        del xx, kk, vv, kxx, vxx, outs
        torch.cuda.empty_cache()
    return out


def cross_times(root: str) -> dict:
    """Device ms of the decode cross-attention kernel of the checkout at
    ``root`` at 8 x 4 and 8 x 1 beams, and of its probe p2."""
    import inspect
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops import probes as pb

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    gen = torch.Generator().manual_seed(2)
    b0, h, lk, d = 8, 12, 1152, 64
    k, v = (torch.randn(b0, h, lk, d, generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    q4 = torch.randn(b0 * 4, h, 1, d, generator=gen).to("cuda", torch.bfloat16)
    mask = torch.ones(b0, lk, dtype=torch.int32)
    for e in range(b0):
        mask[e, 1100 - 90 * e:] = 0
    mask = mask.cuda()
    extra = ()
    if "live_ends" in inspect.signature(da.decode_cross_attention).parameters:
        extra = (da.cross_live_ends(mask),)
    junk = torch.zeros(16 << 20, dtype=torch.float32, device="cuda")  # 64 MB: flushes L2
    out = {}
    for g in (4, 1):
        q = q4[:b0 * g]
        fn = lambda: da.decode_cross_attention(q, k, v, mask, *extra)  # noqa: E731
        out[f"cross_8x{g}"] = cs.time_ms_graph(fn)
        out[f"cross_8x{g}_cold_l2"] = (cs.time_ms_graph(lambda: (junk.sum(), fn()), 10)
                                       - cs.time_ms_graph(junk.sum, 10))
    pq = torch.randn(8, 12, 1, 64, generator=gen).cuda()
    pc = torch.randn(8, 12, 32, 64, generator=gen).cuda()
    out["p2"] = cs.time_ms_graph(lambda: pb.dot_2batch(pq, pc))
    return out


def deform_times(root: str) -> dict:
    """Device ms of the deformable attention's forward and backward of the
    checkout at ``root`` at PDVC's shapes (Lq 188 and 100), and of its
    probe p3."""
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.ops import deformable_attention as da
    from vidchapters_tpu_torch.ops import probes as pb

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    gen = torch.Generator().manual_seed(3)
    out = {}
    for lq in (cs.PDVC_ENC_LQ, cs.PDVC_DEC_LQ):
        value, loc, attn, grad = cs._deformable_inputs(gen, lq)
        out[f"fwd_lq{lq}"] = cs.time_ms_graph(
            lambda: da.deformable_attention_1d(value, cs.PDVC_LEVELS, loc, attn))
        out[f"bwd_lq{lq}"] = cs.time_ms_graph(
            lambda: da.deformable_attention_1d_bwd(value, cs.PDVC_LEVELS, loc, attn, grad))
    g = torch.Generator(device="cuda").manual_seed(5)
    a, b = torch.randn(12, 8, 64, generator=g, device="cuda"), torch.randn(
        12, 64, 32, generator=g, device="cuda")
    out["p3"] = cs.time_ms_graph(lambda: pb.dot_1batch(a, b))
    out["p3_bmm"] = cs.time_ms_graph(lambda: torch.bmm(a, b))
    return out


def pdvc_times(root: str) -> dict:
    """chip_smoke's phase 6 of the checkout at ``root``: train ms/step after
    the first, and the profiled train step's device ms by kernel group."""
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    summary, launches = cs.phase_pdvc("")
    prof = summary["profile"]["train_step"]
    return {"train_step_ms_mean_after_first": summary["train_step_ms_mean_after_first"],
            "train_step_device_ms_by_group": prof["by_group_ms"],
            "train_step_device_busy_ms": prof["device_busy_ms"],
            "train_step_profiled_wall_ms": prof["wall_ms"], "launches": launches}


def zeroshot_steps() -> dict:
    """Section 8: LLaMA-7B's and BLIP-2's decode steps, timed and profiled."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.models import blip2, llama
    from vidchapters_tpu_torch.ops import decoding as dec

    out = {}
    cfg = dataclasses.replace(llama.LLAMA_7B, dtype="bfloat16")
    model = llama.init_llama(cfg, "cuda", seed=21)
    p_len, new = cs.LLAMA_PROMPT_LEN, cs.LLAMA_NEW_TOKENS
    cache = llama.init_cache(cfg, 1, p_len + new, device="cuda")
    ones = torch.ones((1, p_len + new), dtype=torch.int32, device="cuda")
    tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((1, 1), p_len, device="cuda")

    def step():
        return model(tok, position_ids=pos, cache=cache, cache_index=p_len, kv_pad_mask=ones)

    with torch.no_grad():
        ms = cs.time_ms(step, 10)
        out["llama_step_ms"] = ms
        out["llama_step_profile"] = cs._profile_step(lambda *_: step(), None, None, ms)
    del model, cache
    torch.cuda.empty_cache()
    base = blip2.Blip2Config()
    bcfg = blip2.Blip2Config(vision=dataclasses.replace(base.vision, dtype="bfloat16"),
                             qformer=dataclasses.replace(base.qformer, dtype="bfloat16"),
                             t5=dataclasses.replace(base.t5, dtype="bfloat16"))
    model = blip2.init_blip2(bcfg, "cuda", seed=22)
    g = torch.Generator(device="cuda").manual_seed(3)
    px = torch.randn(8, 3, 224, 224, generator=g, device="cuda")
    ids = torch.randint(3, 32000, (8, 22), generator=g, device="cuda")
    with torch.no_grad():
        enc, enc_mask = model.encode(px, ids, torch.ones_like(ids))
        fns = dec.make_decode_fns(model.t5, new)
        bcache = fns.init_cache(8, enc)
        toks = torch.zeros(8, dtype=torch.int32, device="cuda")
        bstep = lambda: fns.step(toks, bcache, 5, enc_mask)  # noqa: E731
        ms = cs.time_ms(bstep, 10)
        out["blip2_step_ms"] = ms
        out["blip2_step_profile"] = cs._profile_step(lambda *_: bstep(), None, None, ms)
    return out


def ab(other: str, what: str) -> dict:
    """``what`` ("whisper", "t5", "cross", "deform" or "pdvc") times of
    ``other`` and of this tree, each in a process of its own, in turns
    other, this, this, other."""
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
    runs = []
    for root in (other, here, here, other):
        res = subprocess.run([sys.executable, __file__, f"--{what}-times", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{what} times of {root} failed: {res.stderr[-2000:]}")
        runs.append({"tree": "other" if root == other else "this",
                     **json.loads(res.stdout.strip().splitlines()[-1])})
    return {"other": str(other), "runs": runs}


# (name, tokenizer, (T5 layers, ViT layers), dropout, lr, schedule, denoising, steps, every)
LEARNING_SWEEP = (
    ("bytes_drop0.1_lr1e-3_cos", "bytes", (2, 2), 0.1, 1e-3, "cosine_with_warmup", 1.0, 400, 50),
    ("bytes_drop0_lr1e-3_cos", "bytes", (2, 2), 0.0, 1e-3, "cosine_with_warmup", 1.0, 300, 50),
    ("bytes_drop0_gen_lr1e-3_cos", "bytes", (2, 2), 0.0, 1e-3, "cosine_with_warmup", 0.0, 600,
     50),
    ("bytes_4l_drop0_gen_lr1e-3_cos", "bytes", (4, 2), 0.0, 1e-3, "cosine_with_warmup", 0.0,
     400, 50),
    ("bytes_drop0_gen_lr1e-3_const", "bytes", (2, 2), 0.0, 1e-3, "", 0.0, 1000, 100),
    ("bytes_drop0.1_gen_lr1e-3_const", "bytes", (2, 2), 0.1, 1e-3, "", 0.0, 1000, 100),
    ("spm_drop0.1_lr1e-3_cos", "spm", (2, 2), 0.1, 1e-3, "cosine_with_warmup", 1.0, 400, 50),
)


def learning_sweep(settings=LEARNING_SWEEP, device: str = "cuda") -> dict:
    """Item 9: each of ``settings`` trained from the same seed on ``device``."""
    import dataclasses
    import tempfile
    import time
    from pathlib import Path

    import numpy as np
    import torch

    import chip_smoke as cs
    from vidchapters_tpu_torch.data.dvc_dataset import DenseVideoCaptioningDataset, EpochIterator
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train import overfit
    from vidchapters_tpu_torch.train.dvc_train import (TrainState, batch_to_device,
                                                       make_generate_fn, make_train_step)
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    out = {}
    for name, tokens, depth, drop, lr, schedule, denoising, steps, every in settings:
        with tempfile.TemporaryDirectory() as tmp:
            if tokens == "spm":
                cfg, _ = cs._learning_cfg(Path(tmp), steps, depth)
            else:
                paths = overfit.build_dataset(Path(tmp), 8, np.random.default_rng(0))
                cfg = cs.cut_depth(overfit.experiment_config(Path(tmp), *paths, steps, 8, lr,
                                                             smoke=False), *depth)
            t5 = dataclasses.replace(cfg.model.t5, dropout_rate=drop, encoder_dropout=drop,
                                     decoder_dropout=drop)
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, t5=t5),
                train=dataclasses.replace(cfg.train, denoising=denoising, optim=dataclasses.replace(
                    cfg.train.optim, lr=lr, schedule=schedule)))
            paths = cfg.datasets["chapters"]
            tok = build_tokenizer(cfg.tokenizer_path, num_bins=cfg.model.num_bins)
            ds = DenseVideoCaptioningDataset(paths.train_json_path, paths.features_path, tok,
                                             cfg.data, subtitles_path=paths.subtitles_path)
            it = EpochIterator(ds, 8, cfg.data, seed=cfg.train.seed)
            host = []
            for epoch in range(cs.LEARN_BATCHES):
                it.set_epoch(epoch)
                host.extend(it)
            val = next(iter(EpochIterator(ds, 8, cfg.data, shuffle=False, drop_last=False)))
        batches = [batch_to_device(b, device) for b in host]
        model = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(0)).to(device)
        state = TrainState(model, build_optimizer(cfg.train.optim, steps, model.parameters()))
        step = make_train_step(model, 1.0, denoising)
        targets = cs._chapters(tok, val["output_tokens"], 90.0, cfg.model.num_bins)
        video = torch.as_tensor(val["video"], dtype=torch.float32, device=device)
        inputs = torch.as_tensor(val["input_tokens"], device=device)
        rows, train_s, old = [], 0.0, t5_mod.USE_MEGA_DECODE
        try:
            t5_mod.USE_MEGA_DECODE = True
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.time()
                m = step(state, batches[i % len(batches)], cfg.train.seed)
                torch.cuda.synchronize()
                train_s += time.time() - t0
                if (i + 1) % every:
                    continue
                row = {"step": i + 1, "loss": float(m["loss"]), "train_s": train_s}
                for beams in (4, 1):
                    generate = make_generate_fn(model, dataclasses.replace(cfg.generation,
                                                                           num_beams=beams))
                    chapters = cs._chapters(tok, generate(video, inputs).cpu().numpy(), 90.0,
                                            cfg.model.num_bins)
                    row[f"beams{beams}"] = {
                        "videos_equal_targets": sum(c == t for c, t in zip(chapters, targets)),
                        "decode_steps": generate.decode_steps,
                        "first_sentence": chapters[0][0]["sentence"] if chapters[0] else None}
                rows.append(row)
                print(json.dumps({name: row}), flush=True)
        finally:
            t5_mod.USE_MEGA_DECODE = old
        out[name] = rows
        del model, state, step, batches
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this script measures on a GPU", flush=True)
        return 1
    times = {"--whisper-times": whisper_times, "--t5-times": t5_times,
             "--cross-times": cross_times, "--deform-times": deform_times,
             "--pdvc-times": pdvc_times}
    if len(sys.argv) == 3 and sys.argv[1] in times:
        print(json.dumps(times[sys.argv[1]](sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if sys.argv[1:] == ["--learning-sweep"]:
        import chip_smoke as cs

        torch.backends.cuda.matmul.allow_tf32 = False
        cs.phase_device_and_build()
        print(json.dumps({"card": card, "learning_sweep": learning_sweep()}), flush=True)
        return 0
    if sys.argv[1:] == ["--zeroshot-steps"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"card": card, **zeroshot_steps()}, indent=1), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] in ("--whisper-ab", "--t5-ab", "--cross-ab",
                                              "--deform-ab", "--pdvc-ab"):
        what = sys.argv[1][2:-3]
        print(json.dumps({"card": card, f"{what}_ab_ms": ab(sys.argv[2], what)}, indent=1),
              flush=True)
        return 0
    import chip_smoke as cs
    from vidchapters_tpu_torch.ops import decode_megakernel as dm
    from vidchapters_tpu_torch.ops import decoding as dec

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = cs.serving_checks_generator()
    torch.randn(8, 4 * 32200, generator=gen)  # check_topk's draw: the same inputs as the smoke
    stacked, x, kc, vc, kx, vx, bias_all, mask, src = cs.megakernel_inputs(gen)
    g, heads, dt = cs.MEGA_SHAPE["g"], cs.MEGA_SHAPE["heads"], torch.bfloat16

    def on(dev):
        st = {k: (v.to(dev) if k in ("ln", "final_ln") else v.to(dev, dt))
              for k, v in stacked.items()}
        if dev == "cuda":
            st = dm.with_kernel_layout(st)
        return st, [t.to(dev, dt) for t in (x, kc, vc, kx, vx)], mask.to(dev), src.to(dev)

    card_in, cpu_in = on("cuda"), on("cpu")
    rounding = []
    for idx in (0, 1, 127, 128, 255):
        br, b0b = bias_all[idx], bias_all[0, :1].contiguous()
        outs = {}
        for name, fn, (st, ts, m, s) in (("kernel", dm.mega_decode_step, card_in),
                                         ("plain_card", dm.mega_decode_step_plain, card_in),
                                         ("plain_cpu", dm.mega_decode_step_plain, cpu_in)):
            dev = ts[0].device
            outs[name] = [t.float().cpu() for t in fn(st, *ts, br.to(dev), b0b.to(dev), m, idx,
                                                      g, heads, src=s)[:3]]
        row = {"idx": idx}
        for j, part in enumerate(("hidden", "k_new", "v_new")):
            ref = outs["plain_card"][j]
            row[part] = {"largest": ref.abs().max().item()}
            for other in ("kernel", "plain_cpu"):
                diff = (outs[other][j] - ref).abs()
                row[part][f"{other}_vs_plain_card"] = diff.max().item()
                row[part][f"{other}_share_past_3e-2"] = (diff > 3e-2).float().mean().item()
        rounding.append(row)

    rand = torch.randn(8, 4 * 32200, generator=torch.Generator().manual_seed(0)).cuda()
    desc = torch.arange(4 * 32200, dtype=torch.float32).flip(0).repeat(8, 1).cuda()
    topk = {f"{name} k{k} S{s}": cs.time_ms_graph(lambda: dec._launch_topk(xx, k, s))
            for name, xx in (("random", rand), ("descending", desc))
            for k in (1, 5, 8, 16) for s in (1, 16, 31, 64)}
    print(json.dumps({"card": card, "decode_kernel_bf16_rounding": rounding,
                      "topk_ms_by_part": topk}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
