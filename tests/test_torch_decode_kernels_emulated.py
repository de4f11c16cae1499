"""The top-k and decode-attention CUDA sources, run on the CPU.

``csrc/topk.cu`` and ``csrc/decode_attention.cu`` are compiled with g++
against ``tests/cuda_emulation/emu_rt.h`` (tests/_cuda_emulation.py): one
OS thread per CUDA thread, shuffles through a warp's exchange buffer, the
blocks of a grid one after another, so the last-block merges across blocks
(an atomic arrival counter that the merging block sets back to 0) run as
they would on the card. The wrappers' own launch code drives them.

Held against the plain versions: the top-k bit for bit (aligned and odd
rows, a row start off the 16-byte boundary, one block a row and several,
k 1 / 5 / 8 / 16, ties, and the thin rows on which ``_topk_iterative``
re-picks); the decode self-attention within the card's bounds with the
caches bit for bit (idx 0 / 127 / 255, 8 and 32 rows, D 64 and 128, fp32
and bf16, one key split and several); the cross-attention at one shape.
Timing and nvcc's own code are the card's to show
(test_torch_cuda_kernels.py, chip_smoke.py). Skipped where there is no g++.
"""

import shutil

import pytest
import torch

from chip_smoke import topk_thin_rows
from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import decode_attention as da
from vidchapters_tpu_torch.ops import decoding as dec


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources against the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    return {(dec, "TOPK_KERNEL"): emulated_kernel(dec.TOPK_KERNEL, out),
            (da, "SELF_KERNEL"): emulated_kernel(da.SELF_KERNEL, out),
            (da, "CROSS_KERNEL"): emulated_kernel(da.CROSS_KERNEL, out)}


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launch code bound to the emulated libraries."""
    for (mod, attr), kern in emulated.items():
        kern.launches = 0
        monkeypatch.setattr(mod, attr, kern)
        monkeypatch.setattr(mod, "stream_ptr", lambda: 0)
    return {attr: kern for (_, attr), kern in emulated.items()}


def _scores(rows: int, n: int, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, n, generator=g)
    x[0, 5] = x[0, n - 3] = x[0].max() + 1.0       # a tie at the top, across blocks
    x[1, 10:13] = x[1].max() + 2.0                 # a three-way tie
    x[2] = -1e7                                    # beam-search start rows
    x[2, n // 3:n // 3 + 10] = -1e7 + 1.0
    x[3, ::97] = x[3].max() + 0.5                  # many equal maxima
    return x.to(dtype)


def _offset(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose first element is 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype)
    shift = (4 // x.element_size() - buf.data_ptr() // x.element_size()) % (16 // x.element_size())
    out = buf[shift:shift + x.numel()].view_as(x)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("n,splits,k,dtype,offset", [
    (8192, 1, 8, torch.float32, False),
    (8192, 3, 8, torch.float32, False),
    (4099, 2, 5, torch.float32, False),    # odd rows: a head and a tail
    (4099, 5, 16, torch.bfloat16, False),
    (4099, 1, 1, torch.bfloat16, False),
    (4096, 4, 5, torch.float32, True),     # the row start off the boundary
    (4100, 7, 8, torch.bfloat16, True),
])
def test_topk_matches_plain_exactly(kernels, n, splits, k, dtype, offset):
    x = _scores(4, n, dtype, seed=n + k)
    if offset:
        x = _offset(x)
    ref_v, ref_i = dec._topk_iterative(x, k)
    got_v, got_i = dec._launch_topk(x, k, splits)
    again = dec._launch_topk(x, k, splits)
    assert kernels["TOPK_KERNEL"].launches == 2
    assert torch.equal(got_i, ref_i) and torch.equal(got_v, ref_v)
    assert torch.equal(again[0], got_v) and torch.equal(again[1], got_i)  # counters reset


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,splits", [(5, 1), (8, 3), (16, 2)])
def test_topk_thin_rows_repick_as_plain(kernels, dtype, k, splits):
    x = topk_thin_rows(4099, dtype)
    ref_v, ref_i = dec._topk_iterative(x, k)
    got_v, got_i = dec._launch_topk(x, k, splits)
    assert torch.equal(got_i, ref_i)
    assert torch.equal(got_v, ref_v)
    assert got_i[0, :5].tolist() == [100, 3000, 7, 7, 7]
    assert got_i[1, :5].tolist() == [50, 0, 0, 0, 0]


def _self_inputs(r, h, length, d, idx, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k_new, v_new = (torch.randn(r, h, 1, d, generator=g).to(dtype) for _ in range(3))
    kc, vc = (torch.randn(r, h, length, d, generator=g).to(dtype) for _ in range(2))
    bias = torch.randn(1, h, 1, length, generator=g)
    bias[..., idx + 1:] = da.NEG_INF
    return q, k_new, v_new, kc, vc, bias.to(dtype)


@pytest.mark.parametrize("r,d,idx,dtype,splits", [
    (8, 64, 255, torch.bfloat16, 3),     # beam 1 at batch 8: keys split over blocks
    (8, 64, 127, torch.float32, 2),
    (8, 64, 0, torch.bfloat16, 1),
    (32, 64, 255, torch.bfloat16, 1),    # beam 4 at batch 8
    (32, 64, 127, torch.bfloat16, 1),
    (32, 64, 0, torch.float32, 1),
    (8, 128, 255, torch.float32, 4),     # D 128: a key row is 32 lanes in fp32
    (8, 128, 127, torch.bfloat16, 1),
    (8, 24, 100, torch.bfloat16, 2),     # D 24: 3 lanes of a 4-lane group
])
def test_decode_self_attention_matches_plain(kernels, r, d, idx, dtype, splits):
    h, length = 2, 256
    q, k_new, v_new, kc, vc, bias = _self_inputs(r, h, length, d, idx, dtype, seed=idx + d)
    kc2, vc2 = kc.clone(), vc.clone()
    span = -(-(idx + 1) // splits)
    out, k_out, v_out = da._launch_self(q, k_new, v_new, kc, vc, bias, idx, splits, span)
    ref, k_ref, v_ref = da.decode_self_attention_plain(q, k_new, v_new, kc2, vc2, bias, idx)
    assert kernels["SELF_KERNEL"].launches == 1
    assert k_out is kc and v_out is vc
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)  # only row idx written
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if splits > 1:  # the counters are back at 0: a second launch gives the same
        again, _, _ = da._launch_self(q, k_new, v_new, kc, vc, bias, idx, splits, span)
        assert torch.equal(again, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_cross_attention_unchanged(kernels, dtype):
    g = torch.Generator().manual_seed(5)
    b0, grp, h, lk, d = 2, 4, 2, 300, 64
    q = torch.randn(b0 * grp, h, 1, d, generator=g).to(dtype)
    k, v = (torch.randn(b0, h, lk, d, generator=g).to(dtype) for _ in range(2))
    mask = torch.ones(b0, lk, dtype=torch.int32)
    mask[0, 200:] = 0
    out = torch.empty_like(q)
    splits, span = 3, 128
    part = torch.empty(b0 * h * splits * grp * (d + 2))
    arrived = torch.zeros(b0 * h, dtype=torch.int32)
    kernels["CROSS_KERNEL"].launch(
        "decode_cross_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), part.data_ptr(), arrived.data_ptr(), b0, grp, h, lk, d, splits, span,
        da._DTYPE_CODE[dtype], 0)
    ref = da.decode_cross_attention_plain(q, k, v, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
