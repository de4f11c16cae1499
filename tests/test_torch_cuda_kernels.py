"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (the check is made when the test runs). The file imports
no JAX, so it also runs where only the port is installed:
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import pytest
import torch


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_fused_attention_matches_plain(dtype, tol):
    require_cuda()
    from vidchapters_tpu_torch.ops import fused_attention as fa

    g = _gen()
    q, k, v = (torch.randn(2, 3, 300, 64, generator=g) * 0.5 for _ in range(3))
    bias = torch.randn(1, 3, 300, 300, generator=g)
    mask = torch.ones(2, 300, dtype=torch.int32)
    mask[0, 250:] = 0
    t = [x.cuda().to(dtype) for x in (q, k, v, bias)]
    before = fa.KERNEL.launches
    got = fa.fused_attention_padded(*t, mask.cuda())
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    # padded keys carry mask 0 and add exactly nothing: the plain version on
    # the unpadded inputs is the same function
    ref = fa.fused_attention_plain(*t, mask.cuda())
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(4 * 32200, 8), (5 * 51865, 5), (51865, 5), (2 * 32128, 4)])
def test_topk_matches_plain_exactly(dtype, n, k):
    require_cuda()
    from chip_smoke import topk_thin_rows
    from vidchapters_tpu_torch.ops import decoding as dec

    x = torch.randn(8, n, generator=_gen())
    x[0, 5] = x[0, n - 905] = x[0].max() + 1.0  # ties at the top, far apart
    x[2] = -1e7                                 # beam-search start rows
    x[2, 1000:1010] = -1e7 + 1.0
    # and the rows on which the plain version re-picks an entry at finfo.min
    x = torch.cat([x.to(dtype), topk_thin_rows(n, dtype)])
    ref_v, ref_i = dec._topk_iterative(x, k)
    before = dec.TOPK_KERNEL.launches
    got_v, got_i = dec._topk_small(x.cuda(), k)
    torch.cuda.synchronize()
    assert dec.TOPK_KERNEL.launches == before + 1
    assert torch.equal(got_i.cpu(), ref_i)
    assert torch.equal(got_v.cpu(), ref_v)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx", [0, 7, 15])
def test_decode_megakernel_matches_plain(dtype, idx, gated):
    require_cuda()
    # decode_kernel_tol: fp32 1e-4; bf16 3e-2 or 2^-5 of the largest element
    # (the bf16 residual's rounding flips); within: or two bf16 ulps
    from chip_smoke import decode_kernel_tol, within
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    b0, grp, n, length, lenc, heads, d, dff = 2, 4, 2, 16, 40, 4, 128, 256
    g = _gen()
    w = lambda *s: torch.randn(*s, generator=g) * s[-2] ** -0.5  # noqa: E731
    st = {"ln": 1.0 + 0.1 * torch.randn(n, 3, d, generator=g),
          "wqkv": w(n, d, 3 * d), "wo_self": w(n, d, d), "wq_cross": w(n, d, d),
          "wo_cross": w(n, d, d), "wi": w(n, d, 2 * dff if gated else dff),
          "wo_ff": w(n, dff, d), "final_ln": 1.0 + 0.1 * torch.randn(1, d, generator=g)}
    st = dm.with_kernel_layout(
        {k: (v.cuda() if k in ("ln", "final_ln") else v.to("cuda", dtype)) for k, v in st.items()})
    rows = b0 * grp
    x, kc, vc = (torch.randn(*s, generator=g).to("cuda", dtype)
                 for s in ((rows, d), (rows, n, length, d), (rows, n, length, d)))
    kx, vx = (torch.randn(b0, n, lenc, d, generator=g).to("cuda", dtype) for _ in range(2))
    bias_row = torch.randn(length, heads, generator=g).cuda()
    bias0 = torch.randn(1, heads, generator=g).cuda()
    mask = torch.ones(b0, lenc, dtype=torch.int32)
    mask[1, 30:] = 0
    mask = mask.cuda()
    src = torch.tensor([(r // grp) * grp + (r * 3 + 1) % grp for r in range(rows)],
                       dtype=torch.int32).cuda()
    args = (x, kc, vc, kx, vx, bias_row, bias0, mask, idx, grp, heads)
    got = dm.mega_decode_step(st, *args, src=src, gated=gated)
    ref = dm.mega_decode_step_plain(st, *args, src=src, gated=gated)
    torch.cuda.synchronize()
    for a, r in zip(got[:3], ref[:3]):  # hidden, k_new, v_new
        assert within(a, r, decode_kernel_tol(r, dtype))
    for a, r, new in zip(got[3:], ref[3:], got[1:3]):
        assert torch.equal(a[:, :, :idx], r[:, :, :idx])  # permuted rows, exactly
        assert torch.equal(a[:, :, idx], new)              # the new row
    # greedy form: row idx written in place, no permutation
    kc2, vc2 = kc.clone(), vc.clone()
    hid, k_new, _ = dm.mega_decode_step(st, x, kc2, vc2, *args[3:], gated=gated)
    torch.cuda.synchronize()
    assert torch.equal(kc2[:, :, idx], k_new)
    ref_hid = dm.mega_decode_step_plain(st, x, kc.clone(), vc.clone(), *args[3:], gated=gated)[0]
    assert within(hid, ref_hid, decode_kernel_tol(ref_hid, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["greedy", "beam", "gated", "long", "passes"])
def test_decode_megakernel_forms_match_plain(dtype, form):
    """The emulated test's forms on the card (chip_smoke.MEGA_TEST_FORMS):
    greedy in place, beam ping-pong, gated, 1500 encoder keys split over
    blocks, 56 rows in two product passes; masks that end inside a tile,
    hold a hole, or leave no key; a second launch bit-identical; the
    counters left at 0."""
    require_cuda()
    from chip_smoke import (MEGA_TEST_FORMS, MEGA_TEST_L, decode_kernel_tol, mega_step_inputs,
                            within)
    from vidchapters_tpu_torch.ops import _build
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    b0, group, heads, dff, lenc, _, gated, indices = MEGA_TEST_FORMS[form]
    gen = torch.Generator().manual_seed(b0 * 10 + group + lenc)
    st, *ts, src = mega_step_inputs(gen, b0, group, heads, dff, lenc, gated, dtype)
    st = {k: ({kk: vv.cuda() for kk, vv in v.items()} if k == "kernel" else v.cuda())
          for k, v in st.items()}
    x, kc, vc, kx, vx, bias_row, bias0, mask = (t.cuda() for t in ts)
    src = None if src is None else src.cuda()
    for idx in list(indices) + [0, MEGA_TEST_L - 1]:
        args = (kx, vx, bias_row, bias0, mask, idx, group, heads)
        k_in, v_in = kc.clone(), vc.clone()
        got = dm.mega_decode_step(st, x, k_in, v_in, *args, src=src, gated=gated)
        ref = dm.mega_decode_step_plain(st, x, kc.clone(), vc.clone(), *args, src=src,
                                        gated=gated)
        again = dm.mega_decode_step(st, x, kc.clone(), vc.clone(), *args, src=src, gated=gated)
        torch.cuda.synchronize()
        for a, r in zip(got[:3], ref[:3]):
            assert within(a, r, decode_kernel_tol(r, dtype))
        for a, b in zip(got[:3], again[:3]):
            assert torch.equal(a, b)
        caches = got[3:] if src is not None else (k_in, v_in)
        for c_got, new in zip(caches, got[1:3]):
            assert torch.equal(c_got[:, :, idx], new)
        if src is not None:
            for a, r in zip(got[3:], ref[3:]):
                assert torch.equal(a[:, :, :idx], r[:, :, :idx])
        else:
            keep = [i for i in range(MEGA_TEST_L) if i != idx]
            assert torch.equal(k_in[:, :, keep], kc[:, :, keep])
    assert not _build.arrival_counters(x.device, 1).any()  # the kernel left them at 0


def _attention_case(dtype, bias: bool, lq: int = 304, lk: int = 384):
    """q/k/v/bias on the card (Lq not a multiple of the 64-row tile), the
    last 80 keys of example 0 masked, and a random output gradient."""
    g = _gen()
    q = torch.randn(2, 3, lq, 64, generator=g) * 0.5
    k, v = (torch.randn(2, 3, lk, 64, generator=g) * 0.5 for _ in range(2))
    b = torch.randn(1, 3, lq, lk, generator=g) if bias else None
    mask = torch.ones(2, lk, dtype=torch.int32)
    mask[0, lk - 80:] = 0
    dout = torch.randn(2, 3, lq, 64, generator=g)
    on = lambda t: None if t is None else t.cuda().to(dtype)  # noqa: E731
    return on(q), on(k), on(v), on(b), mask.cuda(), on(dout)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_fused_attention_forward_with_dropout_matches_plain(dtype, tol, bias):
    require_cuda()
    from vidchapters_tpu_torch.ops import fused_attention as fa

    q, k, v, b, mask, _ = _attention_case(dtype, bias)
    got, lse = fa._forward(q, k, v, b, mask, 1234, 0.1, want_lse=True)
    ref = fa.fused_attention_plain(q, k, v, b, mask, 1234, 0.1)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    scores = fa._scores(q, k, b, mask)
    assert torch.allclose(lse, torch.logsumexp(scores, dim=-1), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_fused_attention_backward_matches_plain(dtype, tol, bias, rate):
    require_cuda()
    from vidchapters_tpu_torch.ops import fused_attention as fa

    q, k, v, b, mask, dout = _attention_case(dtype, bias)
    out, lse = fa._forward(q, k, v, b, mask, 99, rate, want_lse=True)
    before = fa.BWD_KERNEL.launches
    got = fa.fused_attention_bwd(q, k, v, b, mask, 99, rate, out, dout, lse)
    again = fa.fused_attention_bwd(q, k, v, b, mask, 99, rate, out, dout, lse)
    ref = fa.fused_attention_bwd_plain(q, k, v, b, mask, 99, rate, out, dout)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == before + 2
    assert (got[3] is None) == (not bias)
    for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, ref):
        if r is None:
            continue
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, a2), f"{name}: two runs differ"  # no float atomics
        err = (a - r).abs().max().item()
        assert err <= tol, f"{name}: max abs err {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("idx", [0, 100, 127, 255])
@pytest.mark.parametrize("r", [8, 32])  # keys split over blocks at 8 rows, not at 32
def test_decode_self_attention_matches_plain(dtype, tol, idx, r):
    require_cuda()
    from vidchapters_tpu_torch.ops import decode_attention as da

    g = _gen()
    h, length, d = 12, 256, 64
    q, k_new, v_new = (torch.randn(r, h, 1, d, generator=g).to("cuda", dtype) for _ in range(3))
    kc, vc = (torch.randn(r, h, length, d, generator=g).to("cuda", dtype) for _ in range(2))
    bias = torch.randn(1, h, 1, length, generator=g)
    bias[..., idx + 1:] = da.NEG_INF
    bias = bias.to("cuda", dtype)
    kc2, vc2 = kc.clone(), vc.clone()
    before = da.SELF_KERNEL.launches
    out, k_out, v_out = da.decode_self_attention(q, k_new, v_new, kc, vc, bias, idx)
    ref, k_ref, v_ref = da.decode_self_attention_plain(q, k_new, v_new, kc2, vc2, bias, idx)
    torch.cuda.synchronize()
    assert da.SELF_KERNEL.launches == before + 1
    assert k_out is kc and v_out is vc                      # in place
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)  # only row idx written
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
@pytest.mark.parametrize("lk", [1100, 100])  # keys split across blocks, and not
@pytest.mark.parametrize("form", ["tail_hole", "no_key", "holes", "d128", "d40", "b32"])
def test_decode_cross_attention_matches_plain(dtype, tol, group, lk, form):
    """Over live keys only: a padded tail and a hole (tail_hole), an example
    with no unmasked key (the mean of V), holes inside the live keys, D 128,
    D 40 (bf16 on the CUDA-core route), 32 examples x 12 heads (one chunk an
    (example, head): more tiles a warp than the tensor-core route's ring
    holds); the live ends found by the wrapper and given by the caller alike."""
    require_cuda()
    from vidchapters_tpu_torch.ops import decode_attention as da

    g = _gen()
    b0, h, d = (32, 12, 64) if form == "b32" else (3, 3, {"d128": 128, "d40": 40}.get(form, 64))
    q = torch.randn(b0 * group, h, 1, d, generator=g).to("cuda", dtype)
    k, v = (torch.randn(b0, h, lk, d, generator=g).to("cuda", dtype) for _ in range(2))
    mask = torch.ones(b0, lk, dtype=torch.int32)
    mask[0, lk * 2 // 3:] = 0
    mask[1, 5:9] = 0
    mask[2, lk // 3:] = 0
    if form == "no_key":
        mask[1] = 0
    elif form == "holes":
        mask[0, 1:lk // 4] = 0
        mask[2, lk // 3 - 2] = 0
    mask = mask.cuda()
    before = da.CROSS_KERNEL.launches
    got = da.decode_cross_attention(q, k, v, mask)
    again = da.decode_cross_attention(q, k, v, mask, da.cross_live_ends(mask))
    ref = da.decode_cross_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert da.CROSS_KERNEL.launches == before + 2
    assert (got.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(got, again)  # the counters are back at 0


def _deformable_case(lq: int, m: int, d: int, shapes=(100, 50, 25, 13), p: int = 4):
    """value, locations in [-0.1, 1.1] with point 0 on pixel centres, softmaxed
    weights and an output gradient, on the card."""
    g = _gen()
    value = torch.randn(1, sum(shapes), m, d, generator=g)
    loc = torch.rand(1, lq, m, len(shapes), p, generator=g) * 1.2 - 0.1
    for lid, t in enumerate(shapes):
        k = torch.randint(0, t, (1, lq, m), generator=g)
        loc[:, :, :, lid, 0] = (k + 0.5) / t
    attn = torch.softmax(torch.randn(1, lq, m, len(shapes) * p, generator=g), -1)
    attn = attn.reshape(1, lq, m, len(shapes), p)
    grad = torch.randn(1, lq, m * d, generator=g)
    return [t.cuda() for t in (value, loc, attn, grad)], shapes


@pytest.mark.cuda
@pytest.mark.parametrize("lq,m,d", [(188, 8, 64), (100, 8, 64), (37, 4, 16)])
def test_deformable_attention_matches_plain(lq, m, d):
    require_cuda()
    from vidchapters_tpu_torch.ops import deformable_attention as da

    (value, loc, attn, grad), shapes = _deformable_case(lq, m, d)
    before = (da.FWD_KERNEL.launches, da.BWD_KERNEL.launches)
    out = da.deformable_attention_1d(value, shapes, loc, attn)
    got = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
    ref_out = da.deformable_attention_1d_plain(value, shapes, loc, attn)
    ref = da.deformable_attention_1d_bwd_plain(value, shapes, loc, attn, grad)
    torch.cuda.synchronize()
    assert (da.FWD_KERNEL.launches, da.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert (out - ref_out).abs().max().item() <= 1e-5
    dv, dloc, dattn = got
    assert ((dv - ref[0]).norm() / ref[0].norm()).item() <= 1e-5  # sums in another order
    for a, r in ((dloc, ref[1]), (dattn, ref[2])):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    # the cluster route: dvalue summed in shared memory in a fixed order
    again = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,m,d,shapes,p", [
    (12, 3, 24, (7, 1, 3), 4),        # 8 lanes a row, a level of length 1
    (9, 2, 128, (16,), 1),            # 32 lanes a row, one point
    (5, 2, 8, (6, 4, 2, 1), 9),       # 36 samples: more than a warp's lanes
    (20, 2, 64, (700, 300), 2),       # a slice past shared memory: the global route
])
def test_deformable_attention_forms_match_plain(lq, m, d, shapes, p):
    """The forms of tests/test_torch_deformable_attention_emulated.py on the
    card, with the same tolerances; the global route (fp32 atomics into a
    dvalue its launch zeroes) only within them, the cluster route also
    bit-identical on a second launch."""
    require_cuda()
    from vidchapters_tpu_torch.ops import deformable_attention as da

    (value, loc, attn, grad), shapes = _deformable_case(lq, m, d, shapes, p)
    out = da.deformable_attention_1d(value, shapes, loc, attn)
    got = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
    again = da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad)
    ref_out = da.deformable_attention_1d_plain(value, shapes, loc, attn)
    ref = da.deformable_attention_1d_bwd_plain(value, shapes, loc, attn, grad)
    torch.cuda.synchronize()
    assert (out - ref_out).abs().max().item() <= 1e-5
    for g in (got, again):
        assert ((g[0] - ref[0]).norm() / ref[0].norm()).item() <= 1e-5
        for a, r in zip(g[1:], ref[1:]):
            assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    if sum(shapes) < 700:
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_deformable_attention_launches_or_raises():
    """A CUDA tensor goes to the kernel, whose only type is float32: a
    bfloat16 one raises, and no plain version runs in its place."""
    require_cuda()
    from vidchapters_tpu_torch.ops import deformable_attention as da

    (value, loc, attn, grad), shapes = _deformable_case(20, 2, 32)
    before = da.FWD_KERNEL.launches
    with pytest.raises(TypeError, match="float32"):
        da.deformable_attention_1d(value.bfloat16(), shapes, loc, attn)
    with pytest.raises(TypeError, match="float32"):
        da.deformable_attention_1d_bwd(value, shapes, loc, attn, grad.bfloat16())
    assert da.FWD_KERNEL.launches == before
    v = value.clone().requires_grad_(True)
    da.deformable_attention_1d(v, shapes, loc, attn).backward(grad)
    torch.cuda.synchronize()
    assert da.FWD_KERNEL.launches == before + 1 and v.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b0,group", [(3, 1), (2, 5), (10, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_megakernel_matches_plain(dtype, b0, group, quant):
    """The Whisper decode kernel at 2 layers, d 256, 4 heads, d_ff 512, L 16
    and 40 encoder frames, greedy at 3 rows and beam at 2 x 5 and 10 x 5 (50
    rows: more than the 48 of one product pass): hidden and k/v new within
    1e-4 of the plain version's largest element in fp32 (bf16: 5e-2 of it),
    row idx the new k/v, the permuted rows exact, one launch per call, and a
    second call bit-identical to the first."""
    require_cuda()
    from chip_smoke import WHISPER_TOL, _whisper_step_inputs
    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    g = torch.Generator(device="cuda").manual_seed(1)
    st, x, kc, vc, ((kx, ks), (vx, vs)), src = _whisper_step_inputs(
        g, b0, group, dtype, quant, n=2, d=256, dff=512, length=16, lenc=40)
    for idx in (0, 7, 15):
        k1, v1 = kc.clone(), vc.clone()
        before = wm.KERNEL.launches
        got = wm.whisper_mega_step(st, x, k1, v1, kx, vx, idx, 4, 40, ks, vs, group, src)
        ref = wm.whisper_mega_step_plain(st, x, kc.clone(), vc.clone(), kx, vx, idx, 4, 40, ks,
                                         vs, group, src)
        torch.cuda.synchronize()
        assert wm.KERNEL.launches == before + 1
        top = ref[0].float().abs().max().item()
        tol = WHISPER_TOL[str(dtype).split(".")[-1]] * top
        for a, r in zip(got[:3], ref[:3]):
            assert (a.float() - r.float()).abs().max().item() <= tol
        caches = (k1, v1) if src is None else got[3:]
        assert torch.equal(caches[0][:, :, idx], got[1])
        assert torch.equal(caches[1][:, :, idx], got[2])
        if src is not None:
            assert torch.equal(got[3][:, :, :idx], ref[3][:, :, :idx])
            assert torch.equal(got[4][:, :, :idx], ref[4][:, :, :idx])
        again = wm.whisper_mega_step(st, x, kc.clone(), vc.clone(), kx, vx, idx, 4, 40, ks, vs,
                                     group, src)
        assert all(torch.equal(a, b) for a, b in zip(again[:3], got[:3]))
        if src is not None:  # rows past idx of the new caches are never written
            assert all(torch.equal(a[:, :, :idx + 1], b[:, :, :idx + 1])
                       for a, b in zip(again[3:], got[3:]))


@pytest.mark.cuda
def test_whisper_transcriber_tokens_match_cpu():
    """A small fp32 Whisper with the full vocab: one window decoded greedily
    under the timestamp rules and one with beam 3, the decode kernel on the
    card against its plain version on the CPU: identical tokens."""
    require_cuda()
    import copy

    import numpy as np

    from vidchapters_tpu_torch.factory.whisper_transcribe import WhisperTranscriber
    from vidchapters_tpu_torch.models.whisper import Whisper, WhisperConfig
    from vidchapters_tpu_torch.ops import whisper_megakernel as wm

    cfg = WhisperConfig(d_model=256, encoder_layers=2, decoder_layers=2, num_heads=4, d_ff=512,
                        dtype="float32")
    with torch.device("cuda"):
        model = Whisper(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(2))
    cpu = copy.deepcopy(model).to("cpu")
    mel = np.random.default_rng(0).normal(0, 1, (80, 3000)).astype(np.float32)
    kw = dict(language="en", temperatures=(0.0,), compression_ratio_threshold=None,
              logprob_threshold=None, no_speech_threshold=None, max_decode_len=32)
    for beam in (None, 3):
        before = wm.KERNEL.launches
        card = WhisperTranscriber(model, device="cuda", beam_size=beam, **kw)
        got = card._decode_window(mel, 0)
        assert wm.KERNEL.launches == before + 31
        ref = WhisperTranscriber(cpu, device="cpu", beam_size=beam, **kw)._decode_window(mel, 0)
        assert got[0] == ref[0]


@pytest.mark.cuda
def test_probes_match_known_answers():
    require_cuda()
    from vidchapters_tpu_torch.ops import probes

    before = probes.KERNEL.launches
    out = probes.run_probes()  # the card, unless asked for the CPU
    torch.cuda.synchronize()
    # one launch each, and p7's warm-up and 20 timed launches
    assert probes.KERNEL.launches == before + len(probes.PROBES) + 1 + 20
    assert all(r["ok"] for r in out.values()), out
    assert out["grid_cell_overhead"]["us_per_cell"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_i,n_b,d", [(12, 8, 768), (3, 5, 198)])
def test_grid_cells_probe_matches_known_answer_and_plain(n_i, n_b, d):
    """p7 at the probe's (12 x 8) grid of [8, 768] . [768, 768] and at a
    smaller odd one: ones give d exactly; random inputs equal the plain
    version to fp32 rounding (the sums are taken in another order)."""
    require_cuda()
    from vidchapters_tpu_torch.ops import probes

    ones = probes.grid_cells(torch.ones(n_i * n_b, 8, d, device="cuda"),
                             torch.ones(n_i, d, d, device="cuda"))
    assert torch.equal(ones.cpu(), torch.full((n_i * n_b, 8, d), float(d)))
    g = _gen()
    x = torch.randn(n_i * n_b, 8, d, generator=g)
    w = torch.randn(n_i, d, d, generator=g) * d ** -0.5
    ref = probes.grid_cells_plain(x, w)  # on the CPU
    got = probes.grid_cells(x.cuda(), w.cuda()).cpu()
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("a,b,m,d", [(8, 12, 32, 64), (2, 3, 37, 40), (1, 3, 70, 128)])
def test_dot_2batch_probe_matches_known_answer_and_plain(a, b, m, d):
    """p2 at the probe's shape and at ragged ones: ones give d exactly;
    random inputs equal the plain version within 1e-5 of its largest output
    (the sums are taken in another order)."""
    require_cuda()
    from vidchapters_tpu_torch.ops import probes

    ones = probes.dot_2batch(torch.ones(a, b, 1, d, device="cuda"),
                             torch.ones(a, b, m, d, device="cuda"))
    assert torch.equal(ones.cpu(), torch.full((a, b, 1, m), float(d)))
    g = _gen()
    q, c = torch.randn(a, b, 1, d, generator=g), torch.randn(a, b, m, d, generator=g)
    ref = probes.dot_2batch_plain(q, c)  # on the CPU
    got = probes.dot_2batch(q.cuda(), c.cuda()).cpu()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("a,r,m,d", [(12, 8, 32, 64), (2, 3, 37, 40), (1, 2, 70, 130)])
def test_dot_1batch_probe_matches_known_answer_and_plain(a, r, m, d):
    """p3 at the probe's shape and at ragged ones: ones give d exactly;
    random inputs equal the plain version within 1e-5 of its largest output
    (the sums are taken in another order)."""
    require_cuda()
    from vidchapters_tpu_torch.ops import probes

    ones = probes.dot_1batch(torch.ones(a, r, d, device="cuda"), torch.ones(a, d, m, device="cuda"))
    assert torch.equal(ones.cpu(), torch.full((a, r, m), float(d)))
    g = _gen()
    x, y = torch.randn(a, r, d, generator=g), torch.randn(a, d, m, generator=g)
    ref = probes.dot_1batch_plain(x, y)  # on the CPU
    got = probes.dot_1batch(x.cuda(), y.cuda()).cpu()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _bf16_grad_tol(ref) -> float:
    """2e-2, or 2^-7 of the largest reference element where that is larger:
    dS is rounded to bf16 before its products, and an element that the
    kernel and the plain version hold an fp32 ulp apart across a rounding
    boundary moves a gradient element by a bf16 ulp of |dS| |K| (chip_smoke.py,
    bf16_grad_tol)."""
    return max(2e-2, 2.0 ** -7 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("lq", [304, 1000, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_attention_bf16_tensor_cores_match_plain(d, lq, bias, rate):
    """The bf16 (tensor-core) forward and backward against the plain
    versions at every head width, with and without bias and dropout, at a
    ragged query length (304 over 904 keys), the padded 1000 and 1024; two
    backward runs bit-identical."""
    require_cuda()
    from vidchapters_tpu_torch.ops import fused_attention as fa

    g = torch.Generator().manual_seed(d + lq)
    lk = 904 if lq == 304 else lq
    q = torch.randn(2, 3, lq, d, generator=g) * 0.5
    k, v = (torch.randn(2, 3, lk, d, generator=g) * 0.5 for _ in range(2))
    b = torch.randn(1, 3, lq, lk, generator=g) if bias else None
    mask = torch.ones(2, lk, dtype=torch.int32)
    mask[1, lk - 150:] = 0
    dout = torch.randn(2, 3, lq, d, generator=g)
    on = lambda t: None if t is None else t.cuda().to(torch.bfloat16)  # noqa: E731
    q, k, v, b, dout, mask = on(q), on(k), on(v), on(b), on(dout), mask.cuda()
    before = (fa.KERNEL.launches, fa.BWD_KERNEL.launches)
    got = fa.fused_attention_padded(q, k, v, b, mask, seed=5, dropout_rate=rate)
    # the plain version at the lengths the wrapper pads to (the keep mask
    # hashes the padded Lk); padded keys are masked, padded rows sliced off
    lqp, lkp = fa.padded_lengths(lq, lk)
    qp, doutp = fa._pad_to(q, lqp, 2), fa._pad_to(dout, lqp, 2)
    kp, vp = fa._pad_to(k, lkp, 2), fa._pad_to(v, lkp, 2)
    bp = None if b is None else fa._pad_to(fa._pad_to(b, lqp, 2), lkp, 3)
    mp = fa._pad_to(mask, lkp, 1)
    ref = fa.fused_attention_plain(qp, kp, vp, bp, mp, 5, rate)[:, :, :lq]
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2

    out, lse = fa._forward(qp, kp, vp, bp, mp, 5, rate, want_lse=True)
    scores = fa._scores(qp, kp, bp, mp)
    assert torch.allclose(lse, torch.logsumexp(scores, dim=-1), atol=1e-4, rtol=1e-5)
    grads = fa.fused_attention_bwd(qp, kp, vp, bp, mp, 5, rate, out, doutp, lse)
    again = fa.fused_attention_bwd(qp, kp, vp, bp, mp, 5, rate, out, doutp, lse)
    refs = fa.fused_attention_bwd_plain(qp, kp, vp, bp, mp, 5, rate, out, doutp)
    torch.cuda.synchronize()
    assert (fa.KERNEL.launches, fa.BWD_KERNEL.launches) == (before[0] + 2, before[1] + 2)
    assert (grads[3] is None) == (not bias)
    for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), grads, again, refs):
        if r is None:
            continue
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, a2), f"{name}: two runs differ"  # no float atomics
        err, tol = (a - r).abs().max().item(), _bf16_grad_tol(r)
        assert err <= tol, f"{name}: max abs err {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_fused_attention_refuses_other_dtypes_on_the_card(dtype):
    require_cuda()
    from vidchapters_tpu_torch.ops import fused_attention as fa

    q = torch.zeros(1, 1, 64, 64, device="cuda", dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fused_attention(q, q, q, None, torch.ones(1, 64, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,frames", [(torch.float32, 1e-4, 2), (torch.bfloat16, 2e-2, 8)])
@pytest.mark.parametrize("heads,tokens", [(16, 257), (12, 50)])  # ViT-L/14; ViT-B/32
def test_fused_attention_vision_form_matches_plain(dtype, tol, frames, heads, tokens):
    """Row 1 at the CLIP image towers' forms: the query rows as they are
    (ViT-B/32's 50 are less than one query tile), keys padded to a multiple
    of 64 under a mask (320 for 257 tokens; one tile with 14 keys masked for
    50), q scaled by 1/8, no bias."""
    require_cuda()
    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import fused_attention as fa

    width = heads * 64
    qkv = torch.randn(frames, tokens, 3 * width, generator=_gen()).cuda().to(dtype)
    q, k, v, mask = clip.vision_attention_inputs(qkv, heads)
    assert tuple(k.shape) == (frames, heads, -(-tokens // 64) * 64, 64)
    assert int(mask.sum()) == frames * tokens
    before = fa.KERNEL.launches
    got = clip.fused_self_attention(qkv, heads)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    ref = fa.fused_attention_plain(q, k, v, None, mask).transpose(1, 2).reshape(frames, tokens,
                                                                                width)
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_clip_image_tower_on_the_card_matches_cpu():
    """Two fp32 layers at ViT-L/14's width: the card (row 1, one launch a
    layer) against the CPU (the plain version), within 1e-4 of the largest
    feature."""
    require_cuda()
    import copy

    from vidchapters_tpu_torch.models import clip
    from vidchapters_tpu_torch.ops import fused_attention as fa

    cfg = clip.CLIPVisionConfig(layers=2, dtype="float32")
    cpu = clip.CLIPImageEncoder(cfg).init_weights(_gen()).eval()
    card = copy.deepcopy(cpu).cuda()
    pixels = torch.randn(3, 224, 224, 3, generator=_gen())
    with torch.no_grad():
        ref = cpu(pixels)
        before = fa.KERNEL.launches
        got = card(pixels.cuda())
        torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 2
    assert (got.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_feature_extractor_waits_for_weights_copied_on_the_callers_stream():
    """CLIPFeatureExtractor runs the tower on a stream of its own. Weights
    copied to the card with non_blocking copies on the caller's stream,
    queued behind a long kernel there, are in place before the tower reads
    them: the features equal the CPU's (numpy preprocessing, plain
    attention) within 1e-4 of the largest, over 3 batches, the last one
    partial. The pinned weights are made first and a call on the initial
    weights (features of zeros) warms the extractor, so that its second
    call allocates no pinned host memory (which may synchronize the device
    and so order the streams for it)."""
    require_cuda()
    import copy
    import dataclasses

    import numpy as np

    from vidchapters_tpu_torch.factory.features import CLIPFeatureExtractor
    from vidchapters_tpu_torch.models import clip

    cfg = dataclasses.replace(clip.VIT_B32, width=64, layers=2, heads=1, output_dim=32,
                              dtype="float32")
    src = clip.CLIPImageEncoder(cfg).init_weights(_gen()).eval()
    frames = np.random.default_rng(0).integers(0, 256, (10, 96, 128, 3), dtype=np.uint8)
    ref = CLIPFeatureExtractor(copy.deepcopy(src), "cpu", batch_size=4)(frames)
    pinned = {name: t.pin_memory() for name, t in src.state_dict().items()}
    ext = CLIPFeatureExtractor(clip.CLIPImageEncoder(cfg), "cuda", batch_size=4)
    stale = ext(frames)
    assert np.abs(stale - ref).max() > 0.5 * np.abs(ref).max()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the caller's stream ahead of the copies
    with torch.no_grad():
        for name, t in ext.module.state_dict().items():
            t.copy_(pinned[name], non_blocking=True)
    got = ext(frames)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows", [8, 16, 2, 1])  # chip_smoke.BLIP2_SELF_ROWS
@pytest.mark.parametrize("idx", [0, 10, 19])
def test_decode_self_attention_blip2_form_matches_plain(dtype, tol, rows, idx):
    """Row 5 at BLIP-2 Flan-T5-XL's decode: 32 heads, L 20, at the rows of
    the smoke's calls (8 frames, beam 2's 8 x 2, 2 clips, one shot)."""
    require_cuda()
    from vidchapters_tpu_torch.ops import decode_attention as da

    g = _gen()
    h, length, d = 32, 20, 64
    q, k_new, v_new = (torch.randn(rows, h, 1, d, generator=g).to("cuda", dtype)
                       for _ in range(3))
    kc, vc = (torch.randn(rows, h, length, d, generator=g).to("cuda", dtype) for _ in range(2))
    bias = torch.randn(1, h, 1, length, generator=g)
    bias[..., idx + 1:] = da.NEG_INF
    bias = bias.to("cuda", dtype)
    kc2, vc2 = kc.clone(), vc.clone()
    before = da.SELF_KERNEL.launches
    out, _, _ = da.decode_self_attention(q, k_new, v_new, kc, vc, bias, idx)
    ref, k_ref, v_ref = da.decode_self_attention_plain(q, k_new, v_new, kc2, vc2, bias, idx)
    torch.cuda.synchronize()
    assert da.SELF_KERNEL.launches == before + 1
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("form", range(8))  # chip_smoke.blip2_cross_forms
def test_decode_cross_attention_blip2_form_matches_plain(dtype, tol, form, tmp_path):
    """Row 6 at BLIP-2's decode, 32 heads: (examples, beams) of the smoke's
    calls over its 32 query tokens + prompt keys all live, and at 8 x 1 and
    8 x 2 with the last key masked; then Flan-T5's own tokenizer's 46 keys,
    and 45 with the last masked (fewer than a tile, not a multiple of 8)."""
    require_cuda()
    from chip_smoke import blip2_cross_forms, blip2_path_keys
    from vidchapters_tpu_torch.ops import decode_attention as da

    b0, beams, lk, live = blip2_cross_forms(blip2_path_keys(tmp_path))[form]
    g = _gen()
    h, d = 32, 64
    q = torch.randn(b0 * beams, h, 1, d, generator=g).to("cuda", dtype)
    k, v = (torch.randn(b0, h, lk, d, generator=g).to("cuda", dtype) for _ in range(2))
    mask = torch.ones(b0, lk, dtype=torch.int32, device="cuda")
    mask[:, live:] = 0
    assert da.cross_live_ends(mask).tolist() == [live] * b0
    before = da.CROSS_KERNEL.launches
    got = da.decode_cross_attention(q, k, v, mask)
    ref = da.decode_cross_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert da.CROSS_KERNEL.launches == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_llama_tokens_on_the_card_match_cpu():
    """fp32 LLaMA (2 layers, d 256, GQA 8/2) greedy tokens over ragged
    left-padded prompts, card against CPU."""
    require_cuda()
    import copy

    from vidchapters_tpu_torch.models import llama

    cfg = llama.LlamaConfig(hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
                            num_kv_heads=2)
    cpu = llama.init_llama(cfg, "cpu", seed=1)
    card = copy.deepcopy(cpu).cuda()
    ids = torch.randint(3, cfg.vocab_size, (3, 20), generator=_gen(), dtype=torch.int32)
    mask = torch.ones_like(ids)
    ids[1, :6], mask[1, :6] = 1, 0
    ref = llama.llama_greedy_generate(cpu, ids, mask, 10)
    got = llama.llama_greedy_generate(card, ids.cuda(), mask.cuda(), 10)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("num_beams", [1, 2])
def test_blip2_tokens_on_the_card_match_cpu(num_beams):
    """fp32 BLIP-2 (2 + 2 + 2 + 2 layers at Flan-T5-XL's widths) tokens, card
    against CPU; the card's decode launches rows 5 and 6 once a layer a step
    (and row 3 once a step at beam 2)."""
    require_cuda()
    import copy
    import dataclasses

    from vidchapters_tpu_torch.models import blip2
    from vidchapters_tpu_torch.ops import decode_attention as da
    from vidchapters_tpu_torch.ops import decoding as dec

    base = blip2.Blip2Config()
    cfg = blip2.Blip2Config(
        vision=dataclasses.replace(base.vision, num_layers=2),
        qformer=dataclasses.replace(base.qformer, num_layers=2),
        t5=dataclasses.replace(base.t5, num_layers=2, num_decoder_layers=2, dtype="float32"))
    cpu = blip2.init_blip2(cfg, "cpu", seed=2)
    card = copy.deepcopy(cpu).cuda()
    g = _gen()
    px = torch.randn(2, 3, 224, 224, generator=g)
    ids = torch.randint(3, 32000, (2, 14), generator=g)
    mask = torch.ones_like(ids)
    ref = blip2.blip2_generate(cpu, px, ids, mask, 10, num_beams=num_beams)
    before = (da.SELF_KERNEL.launches, da.CROSS_KERNEL.launches, dec.TOPK_KERNEL.launches)
    got = blip2.blip2_generate(card, px.cuda(), ids.cuda(), mask.cuda(), 10, num_beams=num_beams)
    assert torch.equal(got.cpu(), ref)
    n_self, n_cross, n_topk = (a - b for a, b in zip(
        (da.SELF_KERNEL.launches, da.CROSS_KERNEL.launches, dec.TOPK_KERNEL.launches), before))
    assert n_self == n_cross > 0 and n_self % 2 == 0
    assert n_topk == (n_self // 2 if num_beams > 1 else 0)
