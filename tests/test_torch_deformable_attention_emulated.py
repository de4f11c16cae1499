"""The deformable attention's CUDA source (``csrc/deformable_attention.cu``),
run on the CPU.

The source is compiled with g++ against ``tests/cuda_emulation/emu_rt.h``
(tests/_cuda_emulation.py): one fiber per CUDA thread, shuffles and votes
through a warp's exchange buffer, the blocks of a thread-block cluster at
once with distributed shared memory mapped onto each other's buffers. The
wrappers' own launch code (``_launch_fwd``, ``_launch_bwd``) drives the
kernels, held against the plain versions with the tolerances of
``chip_smoke.check_deformable_attention``: the forward within 1e-5, dvalue
within 1e-5 of its norm, dloc and dattn within 1e-4 of their largest
element. The forms: head widths 4 to 128 (one to 32 lanes a row), 1 to 9
points, 1 to 4 levels with one of length 1, more samples than a warp has
lanes, PDVC's level lengths, locations on pixel centres, at 0 and 1 and past
both borders; dvalue on the cluster route (the slice in shared memory, a
second launch bit-identical) and on the global route (a slice larger than
shared memory, fp32 atomics). Timing and nvcc's own code are the card's to
show (test_torch_cuda_kernels.py, chip_smoke.py). Skipped where there is no
g++.
"""

import shutil

import pytest
import torch

from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import deformable_attention as da

SMEM_MAX = 232448  # the shared memory a block can take (the kernel's SMEM_MAX)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    return emulated_kernel(da.FWD_KERNEL, out), emulated_kernel(da.BWD_KERNEL, out)


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launch code bound to the emulated library."""
    fwd, bwd = emulated
    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(da, "FWD_KERNEL", fwd)
    monkeypatch.setattr(da, "BWD_KERNEL", bwd)
    monkeypatch.setattr(da, "stream_ptr", lambda: 0)
    return fwd, bwd


def _inputs(seed, n, lq, m, d, shapes, p):
    """value, locations in [-0.1, 1.1] with point 0 of each level on a pixel
    centre and, where there are 3 points or more, points 1 and 2 of query 0
    at 0 and 1 and of query 1 far past both borders; softmaxed weights and
    an output gradient."""
    g = torch.Generator().manual_seed(seed)
    levels = len(shapes)
    value = torch.randn(n, sum(shapes), m, d, generator=g)
    loc = torch.rand(n, lq, m, levels, p, generator=g) * 1.2 - 0.1
    for lid, t in enumerate(shapes):
        k = torch.randint(0, t, (n, lq, m), generator=g)
        loc[:, :, :, lid, 0] = (k + 0.5) / t
    if p >= 3:
        loc[:, 0, :, :, 1], loc[:, 0, :, :, 2] = 0.0, 1.0
        if lq > 1:
            loc[:, 1, :, :, 1], loc[:, 1, :, :, 2] = -3.0, 4.0
    attn = torch.softmax(torch.randn(n, lq, m, levels * p, generator=g), -1)
    attn = attn.reshape(n, lq, m, levels, p)
    grad = torch.randn(n, lq, m * d, generator=g)
    return value, loc, attn, grad


def _cluster_smem(lq, d, shapes, p):
    """The cluster route's shared memory, as deformable_attention_bwd sizes it."""
    qc = -(-lq // min(8, lq))
    ranks, s = -(-lq // qc), sum(shapes)
    return 4 * (-(-s // ranks) * ranks * d + qc * d + qc * s + s * -(-qc // 32))


FORMS = {  # n, lq, m, d, level lengths, points
    "d24_p4_levels_with_a_1": (2, 5, 2, 24, (7, 1, 3), 4),
    "d64_p1_one_level": (1, 9, 3, 64, (16,), 1),
    "d128_p4_four_levels": (1, 6, 2, 128, (10, 5, 3, 1), 4),
    "d16_36_samples": (1, 3, 1, 16, (6, 4, 2, 1), 9),
    "d8_p2": (1, 3, 2, 8, (4,), 2),
    "d4_p3": (1, 7, 1, 4, (5, 2), 3),
    "pdvc_levels": (1, 4, 2, 64, (100, 50, 25, 13), 4),
    "global_d64": (1, 5, 2, 64, (700, 300), 2),
    "global_d24": (1, 3, 1, 24, (2000, 500, 1), 4),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_deformable_attention_matches_plain(kernels, form):
    fwd, bwd = kernels
    n, lq, m, d, shapes, p = FORMS[form]
    clustered = not form.startswith("global")
    assert (_cluster_smem(lq, d, shapes, p) <= SMEM_MAX) == clustered
    value, loc, attn, grad = _inputs(len(form), n, lq, m, d, shapes, p)
    out = da._launch_fwd(value, shapes, loc, attn)
    ref = da.deformable_attention_1d_plain(value, shapes, loc, attn)
    assert fwd.launches == 1 and out.shape == ref.shape == (n, lq, m * d)
    assert (out - ref).abs().max().item() <= 1e-5
    got = da._launch_bwd(value, shapes, loc, attn, grad)
    want = da.deformable_attention_1d_bwd_plain(value, shapes, loc, attn, grad)
    assert bwd.launches == 1
    assert ((got[0] - want[0]).norm() / want[0].norm()).item() <= 1e-5
    for a, r in zip(got[1:], want[1:]):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    if clustered:  # no atomics: the same bits again
        again = da._launch_bwd(value, shapes, loc, attn, grad)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_deformable_attention_refuses_what_the_kernels_do_not_take(kernels):
    value, loc, attn, grad = _inputs(0, 1, 3, 2, 6, (4,), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        da._launch_fwd(value, (4,), loc, attn)
    with pytest.raises(ValueError, match="multiple of 4"):
        da._launch_bwd(value, (4,), loc, attn, grad)
    assert kernels[0].launches == kernels[1].launches == 0
