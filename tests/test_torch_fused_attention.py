"""The port's fused attention: its plain version (what CPU tensors run)
against the JAX package's Pallas kernel in interpret mode, with and without
bias, padded and rectangular. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

B, H, D = 2, 3, 16


def _inputs(rng, lq, lk, bias=True):
    q = rng.normal(size=(B, H, lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, lk, D)).astype(np.float32)
    b = rng.normal(size=(1, H, lq, lk)).astype(np.float32) if bias else None
    mask = np.ones((B, lk), np.int32)
    mask[0, -lk // 4:] = 0
    return q, k, v, b, mask


@pytest.mark.parametrize("lq,lk,bias", [
    (256, 256, True),     # block multiples
    (256, 256, False),    # no bias (cross-attention form)
    (165, 165, True),     # padded odd length
    (96, 300, True),      # rectangular, padded keys
    (640, 200, False),    # long queries: 128-row padding
])
def test_plain_matches_pallas_interpret(lq, lk, bias):
    from vidchapters_tpu.ops.fused_attention import fused_attention_padded as jax_fa
    from vidchapters_tpu_torch.ops import fused_attention as fa

    q, k, v, b, mask = _inputs(np.random.default_rng(lq + lk), lq, lk, bias)
    ref = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 None if b is None else jnp.asarray(b), jnp.asarray(mask), True)
    before = fa.KERNEL.launches
    got = fa.fused_attention_padded(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if b is None else torch.from_numpy(b), torch.from_numpy(mask))
    assert fa.KERNEL.launches == before  # CPU tensors never reach the kernel
    assert got.shape == (B, H, lq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
