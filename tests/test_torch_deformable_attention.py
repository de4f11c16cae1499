"""The port's 1-D multi-scale deformable attention against the JAX package's,
on the CPU in float32, from numpy inputs:

- the plain forward against JAX's Pallas kernel (interpret mode), its
  einsum form and its gather oracle, with locations past both borders and
  exactly on pixel centres, within 1e-5;
- the port's gradients (dvalue, dloc, dattn), through its autograd Function
  and through the plain backward, against ``jax.grad`` through the Pallas
  function's custom VJP;
- ``deformable_sampling_1d`` against JAX's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.ops import deformable_attention as jda
from vidchapters_tpu_torch.ops import deformable_attention as tda

SHAPES = (16, 8, 4, 3)
N, M, D, P, LQ = 2, 4, 8, 3, 10


def _inputs(seed: int = 0):
    """value, locations in [-0.1, 1.1] (point 0 of each level on a pixel
    centre (k + 0.5) / T_l), softmaxed weights, an output gradient."""
    rng = np.random.default_rng(seed)
    value = rng.normal(size=(N, sum(SHAPES), M, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(N, LQ, M, len(SHAPES), P)).astype(np.float32)
    for lid, t in enumerate(SHAPES):
        k = rng.integers(0, t, size=(N, LQ, M))
        loc[:, :, :, lid, 0] = ((k + 0.5) / t).astype(np.float32)
    attn = rng.uniform(size=(N, LQ, M, len(SHAPES), P)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    grad = rng.normal(size=(N, LQ, M * D)).astype(np.float32)
    return value, loc, attn, grad


def _jax_form(name):
    if name == "pallas":
        return lambda v, s, l, a: jda.deformable_attention_1d_pallas(v, s, l, a, True)
    return {"einsum": jda.deformable_attention_1d,
            "gather": jda.deformable_attention_1d_reference}[name]


@pytest.mark.parametrize("form", ["pallas", "einsum", "gather"])
def test_plain_forward_matches_jax(form):
    value, loc, attn, _ = _inputs()
    ref = np.asarray(_jax_form(form)(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                     jnp.asarray(attn)))
    got = tda.deformable_attention_1d_plain(torch.from_numpy(value), SHAPES,
                                            torch.from_numpy(loc), torch.from_numpy(attn))
    assert got.shape == (N, LQ, M * D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_lerp_taps_match_jax_at_pixel_centres_and_borders():
    """The taps are integers: identical, including loc * T - 0.5 at a pixel
    centre (two roundings in both) and locations past either border."""
    t = 13
    loc = np.concatenate([((np.arange(t) + 0.5) / t), [-0.3, -0.04, 0.0, 1.0, 1.04, 1.7]]
                         ).astype(np.float32)
    ref = jda._lerp_indices(jnp.asarray(loc), t)
    got = tda._lerp_indices(torch.from_numpy(loc), t)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_gradients_match_jax_custom_vjp():
    value, loc, attn, grad = _inputs(1)

    def f(v, l, a):
        return jda.deformable_attention_1d_pallas(v, SHAPES, l, a, True)

    _, vjp = jax.vjp(f, jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(grad))]

    tv, tl, ta = (torch.from_numpy(x).requires_grad_(True) for x in (value, loc, attn))
    out = tda.deformable_attention_1d(tv, SHAPES, tl, ta)
    out.backward(torch.from_numpy(grad))
    plain = tda.deformable_attention_1d_bwd(torch.from_numpy(value), SHAPES,
                                            torch.from_numpy(loc), torch.from_numpy(attn),
                                            torch.from_numpy(grad))
    for name, r, g, p in zip(("dvalue", "dloc", "dattn"), ref, (tv.grad, tl.grad, ta.grad),
                             plain):
        scale = max(float(np.abs(r).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * scale, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=name)
    # both taps clamp to one pixel past the borders: no location gradient
    outside = (loc < 0.5 / np.array(SHAPES)[None, None, None, :, None]) | (
        loc > 1 - 0.5 / np.array(SHAPES)[None, None, None, :, None])
    assert np.all(tl.grad.numpy()[outside] == 0.0) and outside.any()


def test_sampling_matches_jax():
    value, loc, _, _ = _inputs(2)
    ref = np.asarray(jda.deformable_sampling_1d(jnp.asarray(value), SHAPES, jnp.asarray(loc)))
    got = tda.deformable_sampling_1d(torch.from_numpy(value), SHAPES, torch.from_numpy(loc))
    assert got.shape == (N, LQ, M, len(SHAPES), P, D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_cpu_tensors_never_count_a_launch():
    value, loc, attn, grad = _inputs(3)
    before = (tda.FWD_KERNEL.launches, tda.BWD_KERNEL.launches)
    tv = torch.from_numpy(value).requires_grad_(True)
    tda.deformable_attention_1d(tv, SHAPES, torch.from_numpy(loc),
                                torch.from_numpy(attn)).backward(torch.from_numpy(grad))
    assert (tda.FWD_KERNEL.launches, tda.BWD_KERNEL.launches) == before
