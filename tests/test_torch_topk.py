"""The port's beam top-k: its plain version (``_topk_iterative``, what CPU
tensors run) against the JAX package's Pallas top-k in interpret mode and
``lax.top_k``, exactly, with ties. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch


def _scores(rng, rows=8, n=4 * 1000):
    x = rng.normal(size=(rows, n)).astype(np.float32)
    x[0, 5] = x[0, 905] = x[0].max() + 1.0                 # a two-way tie at the top
    x[3, 10] = x[3, 11] = x[3, 12] = x[3].max() + 2.0      # a three-way tie
    x[5] = -1e7                                            # beam-search start rows:
    x[5, 1000:1010] = -1e7 + 1.0                           # ulp 1.0, ties everywhere
    x[6, ::7] = x[6].max() + 0.5                           # many equal maxima
    return x


@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_plain_matches_pallas_and_lax(k):
    from vidchapters_tpu.ops.decoding import _topk_pallas
    from vidchapters_tpu_torch.ops import decoding as dec

    x = _scores(np.random.default_rng(k))
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    pl_v, pl_i = _topk_pallas(jnp.asarray(x), k, interpret=True)
    before = dec.TOPK_KERNEL.launches
    got_v, got_i = dec._topk_small(torch.from_numpy(x), k)
    assert dec.TOPK_KERNEL.launches == before
    for v, i in ((ref_v, ref_i), (pl_v, pl_i)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [5, 8, 16])
def test_plain_matches_pallas_on_thin_rows(dtype, k):
    """Rows with -inf masks, rows at finfo.min, and rows with fewer than k
    entries above finfo.min: both overwrite each pick with finfo.min, so
    past the last such entry they pick the smallest index at finfo.min
    again and again (lax.top_k does not; the port follows the TPU kernel)."""
    from chip_smoke import topk_thin_rows
    from vidchapters_tpu.ops.decoding import _topk_pallas
    from vidchapters_tpu_torch.ops import decoding as dec

    x = topk_thin_rows(4099, getattr(torch, dtype))
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    pl_v, pl_i = _topk_pallas(xj, k, interpret=True)
    got_v, got_i = dec._topk_small(x, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pl_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(pl_v.astype(jnp.float32)))
    assert got_i[0, :5].tolist() == [100, 3000, 7, 7, 7]
    assert got_i[1, :5].tolist() == [50, 0, 0, 0, 0]
