"""The port's decode-step attention kernels: their plain versions (what CPU
tensors run) against the JAX package's ``decode_self_attention`` /
``decode_cross_attention`` in interpret mode, in fp32. The self-attention
at the first, a middle and the last cache slot, its caches compared
exactly; the cross-attention at groups of 1, 3 and 4 beams per example
with padded keys. Tolerance 2e-5 (sums taken in another order). The CUDA
kernels' own test is in test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

R, H, L, D = 6, 3, 16, 32
B0, LK = 2, 40
TOL = 2e-5
NEG = -1e9


@pytest.mark.parametrize("idx", [0, L // 2, L - 1])
def test_self_attention_plain_matches_pallas_interpret(idx):
    from vidchapters_tpu.ops.decode_attention import decode_self_attention as jax_self
    from vidchapters_tpu_torch.ops.decode_attention import decode_self_attention

    rng = np.random.default_rng(idx)
    q, k_new, v_new = (rng.normal(size=(R, H, 1, D)).astype(np.float32) for _ in range(3))
    k_cache, v_cache = (rng.normal(size=(R, H, L, D)).astype(np.float32) for _ in range(2))
    bias = rng.normal(size=(1, H, 1, L)).astype(np.float32)
    bias[..., idx + 1:] = NEG
    ref_out, ref_k, ref_v = jax_self(*(jnp.asarray(a) for a in (q, k_new, v_new, k_cache,
                                                                  v_cache, bias)),
                                     jnp.int32(idx), interpret=True)
    kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    out, k2, v2 = decode_self_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                                        torch.from_numpy(v_new), kc, vc,
                                        torch.from_numpy(bias), idx)
    assert k2 is kc and v2 is vc  # updated in place, as the kernel aliases them
    np.testing.assert_array_equal(kc.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(ref_v))
    assert out.shape == (R, H, 1, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("group", [1, 3, 4])
def test_cross_attention_plain_matches_pallas_interpret(group):
    from vidchapters_tpu.ops.decode_attention import decode_cross_attention as jax_cross
    from vidchapters_tpu_torch.ops.decode_attention import decode_cross_attention

    rng = np.random.default_rng(10 + group)
    q = rng.normal(size=(B0 * group, H, 1, D)).astype(np.float32)
    k, v = (rng.normal(size=(B0, H, LK, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B0, LK), np.int32)
    mask[0, 25:] = 0      # padded tail
    mask[1, 3:7] = 0      # a hole
    ref = jax_cross(*(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)
    got = decode_cross_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert got.shape == (B0 * group, H, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
