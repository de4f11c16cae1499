"""The decode-attention CUDA sources, run on the CPU.

``csrc/decode_attention.cu`` is compiled with g++ against
``tests/cuda_emulation/emu_rt.h`` (tests/_cuda_emulation.py): one fiber
per CUDA thread, shuffles through a warp's exchange buffer, the blocks of a
grid one after another, so the last-block merges across blocks (an atomic
arrival counter that the merging block sets back to 0) run as they would on
the card. The wrappers' own launch code drives them.

Held against the plain versions: the decode self-attention within the
card's bounds with the caches bit for bit (idx 0 / 127 / 255, 8 and 32 rows,
D 64 and 128, fp32 and bf16, one key split and several); the
cross-attention over live keys only, on its CUDA-core route (fp32, bf16 at
D 24) and its tensor-core route (bf16 at D 64 and 128), at groups of 1-8
beams, examples of different live lengths, holes in the live range, an
example with no unmasked key, one chunk and several per (example, head),
more tiles a warp than its ring of stages, a second launch bit-identical. The top-k has its own file
(test_torch_topk_emulated.py). Timing and nvcc's own code are the card's to
show (test_torch_cuda_kernels.py, chip_smoke.py). Skipped where there is no
g++.
"""

import shutil

import pytest
import torch

from tests._cuda_emulation import emulated_kernel
from vidchapters_tpu_torch.ops import decode_attention as da


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    return {"SELF_KERNEL": emulated_kernel(da.SELF_KERNEL, out),
            "CROSS_KERNEL": emulated_kernel(da.CROSS_KERNEL, out)}


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launch code bound to the emulated library."""
    for attr, kern in emulated.items():
        kern.launches = 0
        monkeypatch.setattr(da, attr, kern)
    monkeypatch.setattr(da, "stream_ptr", lambda: 0)
    return emulated


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


LK = 300
# per example: (one past its last unmasked key, holes inside that range);
# an end of 0 masks every key of the example
RAGGED = ((300, ()), (200, ()), (90, ()))
HOLES = ((300, (5, 6, 7, 150)), (250, tuple(range(60, 130))), (37, (0, 36)))
NO_KEY = ((0, ()), (180, (3, 100)), (300, ()))
# 520 keys in one chunk: a warp of the tensor-core route takes 5 tiles of 16,
# more than its ring holds
LONG = ((520, (7, 300)), (410, ()), (0, ()))


def _cross_inputs(b0, group, h, d, dtype, examples, seed):
    g = torch.Generator().manual_seed(seed)
    lk = max(LK, max(end for end, _ in examples))
    q = torch.randn(b0 * group, h, 1, d, generator=g).to(dtype)
    k, v = (torch.randn(b0, h, lk, d, generator=g).to(dtype) for _ in range(2))
    mask = torch.ones(b0, lk, dtype=torch.int32)
    for e, (end, holes) in enumerate(examples[:b0]):
        mask[e, end:] = 0
        mask[e, list(holes)] = 0
    return q, k, v, mask


@pytest.mark.parametrize("group,d,dtype,examples,b0,blocks", [
    (4, 64, torch.bfloat16, RAGGED, 3, 24),   # beam 4: several chunks an example
    (4, 64, torch.float32, HOLES, 3, 24),
    (4, 64, torch.bfloat16, NO_KEY, 3, 24),   # an example with no unmasked key
    (1, 64, torch.bfloat16, HOLES, 3, 30),    # nucleus / greedy
    (1, 128, torch.float32, NO_KEY, 2, 12),
    (8, 64, torch.bfloat16, HOLES, 2, 16),    # g 8
    (8, 128, torch.float32, RAGGED, 3, 6),    # one chunk per (example, head)
    (3, 128, torch.bfloat16, NO_KEY, 3, 6),
    (2, 24, torch.float32, RAGGED, 2, 10),    # D 24: 3 lanes of a 4-lane group in bf16
    (3, 24, torch.bfloat16, HOLES, 3, 18),
    (4, 64, torch.bfloat16, LONG, 3, 6),      # the tensor-core route's tile ring
    (2, 128, torch.bfloat16, LONG, 2, 4),
])
def test_decode_cross_attention_matches_plain(kernels, group, d, dtype, examples, b0, blocks):
    h = 2
    q, k, v, mask = _cross_inputs(b0, group, h, d, dtype, examples, seed=group + d)
    live = da.cross_live_ends(mask)
    out = da._launch_cross(q, k, v, mask, live, blocks)
    ref = da.decode_cross_attention_plain(q, k, v, mask)
    assert kernels["CROSS_KERNEL"].launches == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    # the counters are back at 0: a second launch gives the same, bit for bit
    again = da._launch_cross(q, k, v, mask, live, blocks)
    assert torch.equal(again, out)
