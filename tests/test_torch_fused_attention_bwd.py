"""The port's fused attention in training: the hashed keep masks bit-exact
against the JAX package's, the forward with dropout against the Pallas
kernel in interpret mode, and the port's autograd (its plain forward and
backward, which CPU tensors run) against ``jax.grad`` through the interpret
kernel. The CUDA kernels' own tests are in test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

B, H, D = 2, 3, 16
SEED = 0x5EED1234


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, 2**32 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_keep_scale_bit_exact(seed, rate):
    from vidchapters_tpu.ops.fused_attention import _keep_scale
    from vidchapters_tpu_torch.ops.fused_attention import keep_scale

    for b, h, q0, bq, lk in ((0, 0, 0, 8, 128), (3, 7, 128, 16, 384),
                             (7, 11, 896, 128, 1152), (1, 2, 512, 304, 1024)):
        ref = np.asarray(_keep_scale(jnp.uint32(seed), b, h, q0, bq, lk, rate))
        got = keep_scale(seed, b, h, q0, bq, lk, rate).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("shape", [(2, 3, 40, 50), (1, 12, 64, 64)])
def test_dense_keep_scale_bit_exact(seed, shape):
    from vidchapters_tpu.models.t5 import _dense_keep_scale
    from vidchapters_tpu_torch.models.t5 import dense_keep_scale

    for rate in (0.1, 0.3):
        ref = np.asarray(_dense_keep_scale(jnp.asarray([seed], jnp.uint32), shape, rate))
        got = dense_keep_scale(seed, shape, rate).numpy()
        np.testing.assert_array_equal(got, ref)


def _inputs(rng, lq, lk, bias):
    q, k, v = (rng.normal(size=(B, H, n, D)).astype(np.float32) for n in (lq, lk, lk))
    b = rng.normal(size=(1, H, lq, lk)).astype(np.float32) if bias else None
    mask = np.ones((B, lk), np.int32)
    mask[0, -lk // 4:] = 0
    return q, k, v, b, mask


def _jax_fa(mask, rate):
    from vidchapters_tpu.ops.fused_attention import fused_attention_padded

    seed = jnp.full((1, 1), SEED, jnp.uint32)
    return lambda q, k, v, b: fused_attention_padded(q, k, v, b, jnp.asarray(mask), True,
                                                     seed, rate)


@pytest.mark.parametrize("lq,lk,bias", [(256, 256, True), (165, 165, True),
                                        (96, 300, False), (640, 200, True)])
def test_forward_with_dropout_matches_pallas_interpret(lq, lk, bias):
    from vidchapters_tpu_torch.ops import fused_attention as fa

    q, k, v, b, mask = _inputs(np.random.default_rng(lq + lk), lq, lk, bias)
    ref = _jax_fa(mask, 0.1)(*(None if a is None else jnp.asarray(a) for a in (q, k, v, b)))
    got = fa.fused_attention_padded(
        *(None if a is None else torch.from_numpy(a) for a in (q, k, v, b)),
        torch.from_numpy(mask), seed=SEED, dropout_rate=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # dropout really dropped: the rate-0 output differs
    plain = fa.fused_attention_padded(
        *(None if a is None else torch.from_numpy(a) for a in (q, k, v, b)),
        torch.from_numpy(mask))
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-2


@pytest.mark.parametrize("lq,lk,bias,rate", [
    (256, 256, True, 0.0),
    (256, 256, True, 0.1),
    (256, 256, False, 0.1),
    (165, 165, True, 0.1),    # padded odd length
    (96, 300, False, 0.0),    # rectangular, padded keys
    (96, 300, True, 0.1),
    (640, 200, False, 0.1),   # long queries: 128-row padding
])
def test_grads_match_jax_grad_through_interpret(lq, lk, bias, rate):
    from vidchapters_tpu_torch.ops import fused_attention as fa

    rng = np.random.default_rng(lq * 7 + lk)
    q, k, v, b, mask = _inputs(rng, lq, lk, bias)
    g = rng.normal(size=(B, H, lq, D)).astype(np.float32)
    f = _jax_fa(mask, rate)
    args = [jnp.asarray(a) for a in (q, k, v)] + ([jnp.asarray(b)] if bias else [])
    argnums = tuple(range(len(args)))
    ref = jax.grad(lambda *xs: jnp.sum(f(*xs[:3], xs[3] if bias else None) * g),
                   argnums=argnums)(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = torch.from_numpy(b).requires_grad_() if bias else None
    out = fa.fused_attention_padded(*ts, tb, torch.from_numpy(mask), seed=SEED,
                                    dropout_rate=rate)
    (out * torch.from_numpy(g)).sum().backward()
    got = [t.grad for t in ts] + ([tb.grad] if bias else [])
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_bwd_plain_mirrors_pallas_backward():
    """``fused_attention_bwd_plain`` against the JAX package's backward
    kernel called directly (interpret mode), fp32 dbias included."""
    from vidchapters_tpu.ops.fused_attention import _fused_backward, _fused_forward
    from vidchapters_tpu_torch.ops import fused_attention as fa

    rng = np.random.default_rng(3)
    q, k, v, b, mask = _inputs(rng, 256, 384, True)
    dout = rng.normal(size=q.shape).astype(np.float32)
    seed = jnp.full((1, 1), SEED, jnp.uint32)
    jq, jk, jv, jb, jm = (jnp.asarray(a) for a in (q, k, v, b, mask))
    out = _fused_forward(jq, jk, jv, jb, jm, seed, 0.1, True)
    ref = _fused_backward(jq, jk, jv, jb, jm, seed, 0.1, out, jnp.asarray(dout), True)
    got = fa.fused_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, b, mask)), SEED, 0.1,
        torch.from_numpy(np.array(out)), torch.from_numpy(dout))
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
