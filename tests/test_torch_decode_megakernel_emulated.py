"""The T5 decode kernel's CUDA source, run on the CPU.

``csrc/decode_megakernel.cu`` is compiled with g++ against
``tests/cuda_emulation/emu_rt.h`` (tests/_cuda_emulation.py): one fiber
per CUDA thread, and, since the kernel is a cooperative launch with grid
barriers between its phases, every block of the grid at once, on an SM
count of 2 to 4 (``EMU_SM_COUNT``). The wrapper's own launch code drives it
(``_launch_step``), with the workspace the kernel sizes for itself and the
weights in the kernel layout (``with_kernel_layout``).

Held against ``mega_decode_step_plain`` at 2 layers, d 128, L 16: float32
within 1e-4 and bfloat16 within ``chip_smoke.decode_kernel_tol`` (or two
bf16 ulps, ``chip_smoke.within``); the beam's permuted cache rows bit for
bit and row idx the new k/v; the greedy form's row idx written in place and
no other row touched; a second launch bit-identical to the first; the grid
barrier and merge counters left at 0. The encoder masks
(``chip_smoke.mega_step_inputs``) end one example's keys inside a 32-key
tile, mask a 32-key hole and the tail of another, and leave a third no
unmasked key (every key attended at -1e9, as in the plain version). Six
forms (``chip_smoke.MEGA_TEST_FORMS``): greedy 8 rows (2 heads of 64) at idx 0 and L-1; beam 2 x 4 (4 heads
of 32) at idx 7, in bf16 and, gated, in fp32; one example x 4 beams over
1500 encoder keys on 4 SMs, where each (example, head)'s keys are split over
blocks and merged by the last to arrive; and 7 x 8 = 56 rows, above the 48
of one product pass, so every product runs in two passes. Timing and nvcc's
own code are the card's to show (test_torch_cuda_kernels.py,
chip_smoke.py). Skipped where there is no g++.
"""

import shutil

import pytest
import torch

from chip_smoke import (MEGA_TEST_FORMS, MEGA_TEST_L, decode_kernel_tol, mega_step_inputs,
                        within)
from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import decode_megakernel as dm

FORMS, LENGTH = MEGA_TEST_FORMS, MEGA_TEST_L


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    return emulated_kernel(dm.KERNEL, tmp_path_factory.mktemp("cuda_emulation"))


@pytest.fixture
def kernel(emulated, monkeypatch):
    """The wrapper's launch code bound to the emulated library, with counters
    of its own."""
    emulated.launches = 0
    counters = torch.zeros(1024, dtype=torch.int32)
    monkeypatch.setattr(dm, "KERNEL", emulated)
    monkeypatch.setattr(dm, "stream_ptr", lambda: 0)
    monkeypatch.setattr(dm, "arrival_counters", lambda device, n: counters)
    emulated.counters = counters
    return emulated


def _launch(inputs, idx, group, heads, gated):
    """One kernel step through the wrapper's launch code: (hidden, k_new,
    v_new, the caches that received rows <= idx)."""
    st, x, kc, vc, kx, vx, bias_row, bias0, mask, src = inputs
    k_in, v_in = kc.clone(), vc.clone()
    if src is None:
        k_att, v_att = k_in, v_in
    else:
        k_att, v_att = torch.zeros_like(kc), torch.zeros_like(vc)
    out = dm._launch_step(st, x, k_in, v_in, k_att, v_att, kx, vx, bias_row, bias0, mask, idx,
                          group, heads, 1e-6, src, gated, None)
    return out + (k_att, v_att)


@pytest.mark.parametrize("dtype,form", [
    (torch.float32, "greedy"), (torch.bfloat16, "beam"), (torch.float32, "gated"),
    (torch.bfloat16, "long"), (torch.float32, "long"), (torch.bfloat16, "passes"),
])
def test_decode_kernel_matches_plain(kernel, monkeypatch, dtype, form):
    b0, group, heads, dff, lenc, sms, gated, indices = FORMS[form]
    monkeypatch.setenv("EMU_SM_COUNT", str(sms))
    gen = torch.Generator().manual_seed(b0 * 10 + group + lenc)
    inputs = mega_step_inputs(gen, b0, group, heads, dff, lenc, gated, dtype)
    st, x, kc, vc, kx, vx, bias_row, bias0, mask, src = inputs
    for idx in indices:
        got = _launch(inputs, idx, group, heads, gated)
        ref = dm.mega_decode_step_plain(st, x, kc.clone(), vc.clone(), kx, vx, bias_row, bias0,
                                        mask, idx, group, heads, src=src, gated=gated)
        for a, r in zip(got[:3], ref[:3]):  # hidden, k_new, v_new
            assert torch.isfinite(a.float()).all()
            assert within(a, r, decode_kernel_tol(r, dtype)), (a.float() - r.float()).abs().max()
        assert torch.equal(got[3][:, :, idx], got[1])  # row idx holds the new k/v
        assert torch.equal(got[4][:, :, idx], got[2])
        if src is not None:  # the permuted rows, bit for bit; rows past idx not written
            assert torch.equal(got[3][:, :, :idx], ref[3][:, :, :idx])
            assert torch.equal(got[4][:, :, :idx], ref[4][:, :, :idx])
            assert not got[3][:, :, idx + 1:].any() and not got[4][:, :, idx + 1:].any()
        else:  # greedy: in place, every other row untouched
            keep = [i for i in range(LENGTH) if i != idx]
            assert torch.equal(got[3][:, :, keep], kc[:, :, keep])
            assert torch.equal(got[4][:, :, keep], vc[:, :, keep])
        assert not kernel.counters.any()  # the grid barrier and merge counters back at 0
    again = _launch(inputs, indices[-1], group, heads, gated)  # sums in a fixed order
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    assert kernel.launches == len(indices) + 1
