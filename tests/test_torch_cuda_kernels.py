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
def test_topk_matches_plain_exactly(dtype):
    require_cuda()
    from vidchapters_tpu_torch.ops import decoding as dec

    x = torch.randn(8, 4 * 32200, generator=_gen())
    x[0, 5] = x[0, 905] = x[0].max() + 1.0     # ties at the top
    x[2] = -1e7                                # beam-search start rows
    x[2, 1000:1010] = -1e7 + 1.0
    x = x.to(dtype)
    ref_v, ref_i = dec._topk_iterative(x, 8)
    got_v, got_i = dec._topk_small(x.cuda(), 8)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), ref_i)
    assert torch.equal(got_v.cpu(), ref_v)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("idx", [0, 7, 15])
def test_decode_megakernel_matches_plain(dtype, tol, idx, gated):
    require_cuda()
    from chip_smoke import within  # tol, or two bf16 ulps of larger values
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    b0, grp, n, length, lenc, heads, d, dff = 2, 4, 2, 16, 40, 4, 128, 256
    g = _gen()
    w = lambda *s: torch.randn(*s, generator=g) * s[-2] ** -0.5  # noqa: E731
    st = {"ln": 1.0 + 0.1 * torch.randn(n, 3, d, generator=g),
          "wqkv": w(n, d, 3 * d), "wo_self": w(n, d, d), "wq_cross": w(n, d, d),
          "wo_cross": w(n, d, d), "wi": w(n, d, 2 * dff if gated else dff),
          "wo_ff": w(n, dff, d), "final_ln": 1.0 + 0.1 * torch.randn(1, d, generator=g)}
    st = {k: (v.cuda() if k in ("ln", "final_ln") else v.to("cuda", dtype)) for k, v in st.items()}
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
        assert within(a, r, tol)
    for a, r, new in zip(got[3:], ref[3:], got[1:3]):
        assert torch.equal(a[:, :, :idx], r[:, :, :idx])  # permuted rows, exactly
        assert torch.equal(a[:, :, idx], new)              # the new row
    # greedy form: row idx written in place, no permutation
    kc2, vc2 = kc.clone(), vc.clone()
    hid, k_new, _ = dm.mega_decode_step(st, x, kc2, vc2, *args[3:], gated=gated)
    torch.cuda.synchronize()
    assert torch.equal(kc2[:, :, idx], k_new)
    assert within(hid, dm.mega_decode_step_plain(st, x, kc.clone(), vc.clone(), *args[3:],
                                                 gated=gated)[0], tol)


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
