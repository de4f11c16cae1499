"""The fused attention's CUDA sources, run on the CPU.

``csrc/fused_attention_fwd.cu`` and ``csrc/fused_attention_bwd.cu`` are
compiled with g++ against ``tests/cuda_emulation/emu_rt.h``, a CPU stand-in
for the CUDA runtime and the warp primitives the kernels use (one fiber
per CUDA thread, ``mma.sync`` / ``ldmatrix`` / shuffles computed from the
PTX fragment layouts, ``cp.async`` copying at once). The sources are used as
they are, except that in ``tensor_core.cuh`` the bodies of the six
functions holding inline PTX are replaced by their emulation, and launches
``k<<<...>>>(...)`` are rewritten as calls. The wrappers' own launch code
(``_launch_forward`` / ``_launch_backward``) drives them through ctypes.

This holds the kernels' index arithmetic (fragment layouts, the absolute
row and key of every accumulator element for the keep mask, the bias and the
mask, ragged query tiles, the dbias partials) against the plain versions
without a card; timing, the real asynchrony of cp.async and nvcc's own
arithmetic are the card's to show (test_torch_cuda_kernels.py,
chip_smoke.py). Skipped where there is no g++.
"""

import shutil

import pytest
import torch

from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import fused_attention as fa


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources against the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    return {attr: emulated_kernel(getattr(fa, attr), out) for attr in ("KERNEL", "BWD_KERNEL")}


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launch code bound to the emulated libraries."""
    for attr, kern in emulated.items():
        kern.launches = 0
        monkeypatch.setattr(fa, attr, kern)
    monkeypatch.setattr(fa, "stream_ptr", lambda: 0)
    return emulated


def _inputs(b, h, lq, lk, d, bias, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(b, h, lq, d, generator=g) * 0.5).to(dtype)
    k = (torch.randn(b, h, lk, d, generator=g) * 0.5).to(dtype)
    v = (torch.randn(b, h, lk, d, generator=g) * 0.5).to(dtype)
    bb = torch.randn(1, h, lq, lk, generator=g).to(dtype) if bias else None
    mask = torch.ones(b, lk, dtype=torch.int32)
    mask[0, lk - 40:] = 0
    dout = torch.randn(b, h, lq, d, generator=g).to(dtype)
    return q, k, v, bb, mask, dout


def _grad_tol(ref, dtype) -> float:
    """fp32: 1e-4; bf16: as the card tests (test_torch_cuda_kernels.py)."""
    return 1e-4 if dtype == torch.float32 else max(2e-2, 2.0 ** -7 * float(ref.abs().max()))


@pytest.mark.parametrize("b,h,lq,lk,d,bias,rate,dtype", [
    (2, 2, 128, 128, 64, True, 0.1, torch.bfloat16),
    (2, 1, 100, 128, 64, True, 0.1, torch.bfloat16),   # a ragged query tile
    (2, 1, 80, 192, 32, True, 0.1, torch.bfloat16),
    (2, 1, 72, 128, 128, False, 0.1, torch.bfloat16),  # D 128: 32-long walked tiles
    (1, 2, 64, 128, 64, True, 0.0, torch.bfloat16),    # B 1: dbias without the partials
    (2, 1, 130, 64, 64, False, 0.0, torch.bfloat16),
    (2, 1, 100, 128, 64, True, 0.1, torch.float32),    # the fp32 CUDA-core route
])
def test_emulated_kernels_match_plain(kernels, b, h, lq, lk, d, bias, rate, dtype):
    q, k, v, bb, mask, dout = _inputs(b, h, lq, lk, d, bias, dtype)
    out, lse = fa._launch_forward(q, k, v, bb, mask, 1234, rate, True)
    ref = fa.fused_attention_plain(q, k, v, bb, mask, 1234, rate)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    lse_ref = torch.logsumexp(fa._scores(q, k, bb, mask), dim=-1)
    assert torch.allclose(lse, lse_ref, atol=1e-4, rtol=1e-5)
    got = fa._launch_backward(q, k, v, bb, mask, 1234, rate, out, dout, lse)
    again = fa._launch_backward(q, k, v, bb, mask, 1234, rate, out, dout, lse)
    refs = fa.fused_attention_bwd_plain(q, k, v, bb, mask, 1234, rate, out, dout)
    assert kernels["KERNEL"].launches == 1 and kernels["BWD_KERNEL"].launches == 2
    assert (got[3] is None) == (not bias)
    for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, refs):
        if r is None:
            continue
        assert torch.equal(a, a2), f"{name}: two runs differ"
        err, tol = (a - r).abs().max().item(), _grad_tol(r, dtype)
        assert err <= tol, f"{name}: max abs err {err} > {tol}"


@pytest.mark.parametrize("tokens,dtype", [
    (50, torch.bfloat16),   # ViT-B/32: 50 query rows, one 64-key tile with 14 keys masked
    (50, torch.float32),
    (257, torch.bfloat16),  # ViT-L/14: 257 query rows over 320 keys
])
def test_emulated_forward_at_the_image_towers_forms(kernels, tokens, dtype):
    """Row 1 on the CLIP image towers' route (``models/clip.
    vision_attention_inputs``: q scaled by 1/8, keys padded to a multiple of
    64 under a mask, the query rows as they are), 2 frames and 2 heads of
    64, against the plain version: fp32 within 1e-4, bf16 within 2e-2."""
    from vidchapters_tpu_torch.models import clip

    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, tokens, 3 * 2 * 64, generator=g).to(dtype)
    q, k, v, mask = clip.vision_attention_inputs(qkv, 2)
    assert k.shape[2] == -(-tokens // 64) * 64
    out, _ = fa._launch_forward(q, k, v, None, mask, 0, 0.0, False)
    ref = fa.fused_attention_plain(q, k, v, None, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert kernels["KERNEL"].launches == 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("lk", [64, 128])  # one key tile; two
def test_emulated_forward_keep_mask_is_the_plain_one(kernels, lk):
    """With V the identity, out holds each row's dropped probabilities: it is
    zero exactly where the plain keep mask drops (every accumulator element's
    absolute row and key reach the hash; the dropout walk pairs key c with
    key c + Lk/2 in a tile and decides both from one hash)."""
    q, k, _, _, mask, _ = _inputs(2, 2, 64, lk, lk, False, torch.bfloat16, seed=3)
    mask[:] = 1
    v = torch.eye(lk, dtype=torch.bfloat16).expand(2, 2, lk, lk).contiguous()
    out, _ = fa._launch_forward(q * 0.2, k, v, None, mask, 77, 0.25, False)
    keep = fa._keep_full(77, 2, 2, 64, lk, 0.25, None)
    assert torch.equal(out == 0, keep == 0)


@pytest.mark.parametrize("lk", [64, 128])  # 128: D 128, four 32-key tiles
def test_emulated_backward_ds_is_the_plain_one(kernels, lk):
    """With K the identity (Lk = D), dq holds dS rounded to bf16 element by
    element: it equals dS computed from the kernel's lse in the plain
    version's order (fused_attention_bwd_plain) in at least 99% of the
    elements and lies within one bf16 ulp of it everywhere (exp on the CPU
    and in the kernel may differ by an fp32 ulp)."""
    q, _, v, _, mask, dout = _inputs(2, 1, 128, lk, lk, False, torch.bfloat16, seed=4)
    k = torch.eye(lk, dtype=torch.bfloat16).expand(2, 1, lk, lk).contiguous()
    q = q * 4
    out, lse = fa._launch_forward(q, k, v, None, mask, 9, 0.1, True)
    dq = fa._launch_backward(q, k, v, None, mask, 9, 0.1, out, dout, lse)[0]
    p = torch.exp(fa._scores(q, k, None, mask) - lse[..., None])
    keep = fa._keep_full(9, 2, 1, 128, lk, 0.1, None)
    delta = (dout.float() * out.float()).sum(-1)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2)) * keep
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    assert (dq == ds).float().mean().item() >= 0.99
    _, exp = torch.frexp(ds)
    assert bool(((dq - ds).abs() <= torch.ldexp(torch.ones_like(ds), exp - 8)).all())
