"""The Whisper decode kernel's CUDA source, run on the CPU.

``csrc/whisper_megakernel.cu`` is compiled with g++ against
``tests/cuda_emulation/emu_rt.h`` (tests/_cuda_emulation.py): one fiber
per CUDA thread, and, since the kernel is a cooperative launch with grid
barriers between its phases, every block of the grid at once, on an SM
count of 3 or 4. The wrapper's own launch code drives it, with the
workspace the kernel sizes for itself.

Held against ``whisper_mega_step_plain`` at 2 layers, d 128, 2 heads and L
16: float32 within 1e-4 and bfloat16 within ``WHISPER_TOL`` of the largest
hidden element; cross K/V int8 and unquantized; cache indices 0 and 7; the
beam's copied cache rows bit for bit, row idx the new k/v, and a second
launch bit-identical to the first. Three forms: greedy at 8 rows (d_ff 256,
40 encoder frames, 3 SMs); beam 3 examples x 5 (15 rows, two n-tiles of the
tensor-core products) at d_ff 2304 on 6 SMs, where fc2's k is split over 2
blocks and merged by the last to arrive; and one example x 5 beams over
1500 frames on 4 SMs, where each (example, head)'s keys are split over 2
blocks and merged likewise; and 10 x 5 beams (50 rows), above the 48 rows
of one product pass, so every product runs in two passes. The beam form's
cases are in test_torch_whisper_megakernel_beam_emulated.py (the two files
take about the same time). Timing and nvcc's own code are the card's to show
(test_torch_cuda_kernels.py, chip_smoke.py). Skipped where there is no g++.
"""

import shutil

import pytest
import torch

from chip_smoke import WHISPER_TOL, _whisper_step_inputs
from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import whisper_megakernel as wm

N, D, HEADS, LENGTH = 2, 128, 2, 16
# form: (examples, beams, d_ff, encoder frames, SMs)
FORMS = {"greedy": (8, 1, 256, 40, 3), "beam": (3, 5, 2304, 40, 6),
         "long": (1, 5, 256, 1500, 4), "passes": (10, 5, 256, 40, 3)}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    return emulated_kernel(wm.KERNEL, tmp_path_factory.mktemp("cuda_emulation"))


@pytest.fixture
def kernel(emulated, monkeypatch):
    """The wrapper's launch code bound to the emulated library."""
    emulated.launches = 0
    monkeypatch.setattr(wm, "KERNEL", emulated)
    monkeypatch.setattr(wm, "stream_ptr", lambda: 0)
    return emulated


def _launch(st, x, kc, vc, cross, src, idx, group, lenc):
    """One kernel step through the wrapper's launch code: (hidden, k_new,
    v_new, the caches that received rows <= idx)."""
    (kx, ks), (vx, vs) = cross
    k_in, v_in = kc.clone(), vc.clone()
    if src is None:
        k_att, v_att = k_in, v_in
    else:
        k_att, v_att = torch.zeros_like(kc), torch.zeros_like(vc)
    out = wm._launch_step(st, x, k_in, v_in, k_att, v_att, kx, vx, idx, HEADS, lenc, ks, vs,
                          group, src, None)
    return out + (k_att, v_att)


@pytest.mark.parametrize("dtype,quant,form", [
    (torch.float32, True, "greedy"), (torch.float32, False, "greedy"),
    (torch.bfloat16, True, "greedy"), (torch.bfloat16, False, "greedy"),
    (torch.bfloat16, True, "long"), (torch.float32, False, "long"),
    (torch.bfloat16, True, "passes"),
])
def test_whisper_kernel_matches_plain(kernel, monkeypatch, dtype, quant, form):
    check_form(kernel, monkeypatch, dtype, quant, form)


def check_form(kernel, monkeypatch, dtype, quant, form):
    """One form against the plain version at cache indices 0 and 7, and a
    second launch bit-identical."""
    b0, group, dff, lenc, sms = FORMS[form]
    monkeypatch.setenv("EMU_SM_COUNT", str(sms))
    gen = torch.Generator().manual_seed(b0 * 10 + group + 2 * quant)
    st, x, kc, vc, cross, src = _whisper_step_inputs(
        gen, b0, group, dtype, quant, n=N, d=D, dff=dff, length=LENGTH, lenc=lenc,
        device="cpu")
    (kx, ks), (vx, vs) = cross
    tol = WHISPER_TOL[str(dtype).split(".")[-1]]
    for idx in (0, 7):
        got = _launch(st, x, kc, vc, cross, src, idx, group, lenc)
        ref = wm.whisper_mega_step_plain(st, x, kc.clone(), vc.clone(), kx, vx, idx, HEADS,
                                         lenc, ks, vs, group, src)
        top = ref[0].float().abs().max().item()
        for a, r in zip(got[:3], ref[:3]):
            assert torch.isfinite(a.float()).all()
            assert (a.float() - r.float()).abs().max().item() <= tol * top
        assert torch.equal(got[3][:, :, idx], got[1])  # row idx holds the new k/v
        assert torch.equal(got[4][:, :, idx], got[2])
        if src is not None:  # the permuted rows, bit for bit
            assert torch.equal(got[3][:, :, :idx], ref[3][:, :, :idx])
            assert torch.equal(got[4][:, :, :idx], ref[4][:, :, :idx])
    again = _launch(st, x, kc, vc, cross, src, 7, group, lenc)  # sums in a fixed order
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    assert kernel.launches == 3
