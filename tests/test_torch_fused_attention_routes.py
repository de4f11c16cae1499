"""The fused attention's wrapper logic around its two kernel routes, on the
CPU (no kernel is built or launched here): the dbias scratch the bf16
backward asks for, the padded lengths, 16-byte alignment of what the
kernels read, and the refusals before any launch (dtypes other than float32
and bfloat16, head widths the kernels are not built for)."""

import pytest
import torch

from vidchapters_tpu_torch.ops import fused_attention as fa


@pytest.mark.parametrize("b,h,lq,lk,dtype,has_bias,want", [
    (8, 12, 1152, 1152, torch.bfloat16, True, (8, 12, 1152, 1152)),  # the encoder in training
    (8, 12, 304, 1024, torch.bfloat16, False, None),    # cross-attention: no bias, no dbias
    (1, 12, 1024, 1024, torch.bfloat16, True, None),    # one example: dbias is the partial
    (2, 2, 1000, 1024, torch.float32, True, None),      # fp32 sums dbias in its own kernel
])
def test_dbias_scratch_shape(b, h, lq, lk, dtype, has_bias, want):
    assert fa.dbias_scratch_shape(b, h, lq, lk, dtype, has_bias) == want


def test_dbias_scratch_at_the_training_shape_is_at_most_8_x_64_mb():
    shape = fa.dbias_scratch_shape(8, 12, 1152, 1152, torch.bfloat16, True)
    per_example = 4 * shape[1] * shape[2] * shape[3]
    assert shape[0] == 8 and per_example <= 64 * 2 ** 20


@pytest.mark.parametrize("lq,lk,want", [
    (1100, 1100, (1152, 1152)),  # the encoder: 100 frames + 1000 tokens
    (304, 904, (304, 1024)),     # denoising cross-attention
    (256, 1152, (256, 1152)),    # generative cross-attention
    (1000, 1000, (1024, 1024)),
    (5, 70, (8, 128)),
    (513, 128, (640, 128)),
])
def test_padded_lengths(lq, lk, want):
    assert fa.padded_lengths(lq, lk) == want


def test_padded_wrapper_pads_to_padded_lengths(monkeypatch):
    seen = {}

    def fake(q, k, v, bias, key_mask, seed, dropout_rate, h0):
        seen["shapes"] = (q.shape[2], k.shape[2], tuple(bias.shape[2:]), key_mask.shape[1])
        seen["h0"] = h0
        return torch.zeros(q.shape)

    monkeypatch.setattr(fa, "fused_attention", fake)
    q = torch.zeros(1, 2, 300, 32)
    k = torch.zeros(1, 2, 200, 32)
    out = fa.fused_attention_padded(q, k, k, torch.zeros(1, 2, 300, 200),
                                    torch.ones(1, 200, dtype=torch.int32))
    assert seen["shapes"] == (304, 256, (304, 256), 256) and out.shape[2] == 300
    assert seen["h0"] == 0


def test_aligned_copies_only_a_misaligned_view():
    base = torch.zeros(4096, dtype=torch.bfloat16)
    aligned = base[:2048]
    assert fa._aligned(aligned) is aligned
    odd = base[3:3 + 2048]  # 6 bytes past an aligned start
    assert odd.data_ptr() % 16 != 0
    fixed = fa._aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)


def _inputs(dtype=torch.bfloat16, d=64, lk=128):
    q = torch.zeros(1, 2, 64, d, dtype=dtype)
    k = torch.zeros(1, 2, lk, d, dtype=dtype)
    return q, k, k, None, torch.ones(1, lk, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_routes_refuse_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._launch_forward(*_inputs(dtype), 0, 0.0, True)
    q, k, v, bias, mask = _inputs(dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._launch_backward(q, k, v, bias, mask, 0, 0.0, q, q, torch.zeros(1, 2, 64))


@pytest.mark.parametrize("d,lk", [(48, 128), (256, 128), (64, 96)])
def test_kernel_routes_refuse_unbuilt_widths_and_ragged_keys(d, lk):
    with pytest.raises(ValueError, match="kernel needs D in"):
        fa._launch_forward(*_inputs(torch.bfloat16, d, lk), 0, 0.0, False)
