"""The top-k CUDA source, run on the CPU.

``csrc/topk.cu`` is compiled with g++ against ``tests/cuda_emulation/emu_rt.h``
(tests/_cuda_emulation.py): one fiber per CUDA thread, shuffles through a
warp's exchange buffer, the blocks of a grid one after another, so the
last-block merge across blocks (an atomic arrival counter that the merging
block sets back to 0) runs as it would on the card. The wrapper's own launch
code drives it.

Held against the plain version bit for bit: aligned and odd rows, a row
start off the 16-byte boundary, one block a row and several, k 1 / 5 / 8 /
16, ties, and the thin rows on which ``_topk_iterative`` re-picks. The
decode-attention sources have their own file
(test_torch_decode_attention_emulated.py). Timing and nvcc's own code are
the card's to show (test_torch_cuda_kernels.py, chip_smoke.py). Skipped
where there is no g++.
"""

import shutil

import pytest
import torch

from chip_smoke import topk_thin_rows
from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import decoding as dec


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    return emulated_kernel(dec.TOPK_KERNEL, tmp_path_factory.mktemp("cuda_emulation"))


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrapper's launch code bound to the emulated library."""
    emulated.launches = 0
    monkeypatch.setattr(dec, "TOPK_KERNEL", emulated)
    monkeypatch.setattr(dec, "stream_ptr", lambda: 0)
    return {"TOPK_KERNEL": emulated}


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
