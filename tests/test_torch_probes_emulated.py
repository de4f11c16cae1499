"""Probe p2's CUDA source, run on the CPU.

``csrc/probes.cu`` is compiled with g++ against ``tests/cuda_emulation/emu_rt.h``
(tests/_cuda_emulation.py): one OS thread per CUDA thread, shuffles through a
warp's exchange buffer, the blocks of a grid one after another. The
wrapper's own launch code drives ``dot_2batch``'s kernel, held against
``dot_2batch_plain`` on seeded random inputs within 1e-5 of the largest
output (sums taken in another order), and exactly on the probe's ones
(64.0), at the probe's shape and at ragged ones (rows that fill no whole
block, widths that fill no whole lane group). Timing and nvcc's own code
are the card's to show (test_torch_cuda_kernels.py, chip_smoke.py). Skipped
where there is no g++.
"""

import shutil

import pytest
import torch

from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import probes as pb


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    return emulated_kernel(pb.KERNEL, tmp_path_factory.mktemp("cuda_emulation"))


@pytest.fixture
def kernel(emulated, monkeypatch):
    """The wrapper's launch code bound to the emulated library."""
    emulated.launches = 0
    monkeypatch.setattr(pb, "KERNEL", emulated)
    monkeypatch.setattr(pb, "stream_ptr", lambda: 0)
    return emulated


@pytest.mark.parametrize("a,b,m,d", [
    (8, 12, 32, 64),   # the probe's shape: a block per (a, b)
    (2, 3, 37, 64),    # rows past one block's 32
    (2, 2, 5, 40),     # a 10-lane row in a 16-lane group
    (1, 3, 70, 128),   # a row across the whole warp
    (3, 1, 9, 4),      # one lane a row
])
def test_dot_2batch_matches_plain(kernel, a, b, m, d):
    g = torch.Generator().manual_seed(a * 1000 + m * 10 + d)
    q, c = torch.randn(a, b, 1, d, generator=g), torch.randn(a, b, m, d, generator=g)
    got = pb._launch_dot_2batch(q, c)
    ref = pb.dot_2batch_plain(q, c)
    assert kernel.launches == 1 and got.shape == ref.shape == (a, b, 1, m)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    ones = pb._launch_dot_2batch(torch.ones(a, b, 1, d), torch.ones(a, b, m, d))
    assert torch.equal(ones, torch.full((a, b, 1, m), float(d)))


def test_dot_2batch_refuses_what_the_kernel_does_not_take(kernel):
    with pytest.raises(ValueError, match="multiple of 4"):
        pb._launch_dot_2batch(torch.ones(1, 1, 1, 6), torch.ones(1, 1, 3, 6))
    assert kernel.launches == 0
