"""The port's decode-step kernel: its plain version (what CPU tensors run)
against the JAX package's ``mega_decode_step`` in interpret mode, with and
without the deferred beam permutation, at the first step, at a cache-chunk
edge and at the last slot; the DecodeFns wiring (a skipped reorder is a
no-op) against the JAX DecodeFns. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_helpers import jax_params, port_model, small_cfgs

B0, G, N, L, LENC, H, DKV, D, DFF = 2, 4, 2, 16, 32, 4, 32, 128, 256
INNER = H * DKV
TOL = 1e-4


def _inputs(seed: int, gated: bool = False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=0.1: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    stacked = {
        "ln": (1.0 + f(N, 3, D)).astype(np.float32),
        "wqkv": f(N, D, 3 * INNER), "wo_self": f(N, INNER, D),
        "wq_cross": f(N, D, INNER), "wo_cross": f(N, INNER, D),
        "wi": f(N, D, 2 * DFF if gated else DFF), "wo_ff": f(N, DFF, D),
        "final_ln": (1.0 + f(1, D)).astype(np.float32),
    }
    b = B0 * G
    mask = np.ones((B0, LENC), np.int32)
    mask[0, 20:] = 0
    mask[1, 5:9] = 0
    # a non-trivial within-example beam permutation
    src = np.array([(r // G) * G + (r * 3 + 1) % G for r in range(b)], np.int32)
    return dict(stacked=stacked, x=f(b, D, scale=1.0), k=f(b, N, L, INNER, scale=1.0),
                v=f(b, N, L, INNER, scale=1.0), kx=f(B0, N, LENC, INNER, scale=1.0),
                vx=f(B0, N, LENC, INNER, scale=1.0), bias_row=f(L, H, scale=1.0),
                bias0=f(1, H, scale=1.0), mask=mask, src=src)


def _torch(a):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in a.items()}


def _jax(a):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in a.items()}


@pytest.mark.parametrize("use_src", [False, True])
@pytest.mark.parametrize("idx", [0, 7, 8, L - 1])
@pytest.mark.parametrize("gated", [False, True])
def test_plain_matches_pallas_interpret(monkeypatch, idx, use_src, gated):
    from vidchapters_tpu.ops import decode_megakernel as jdm
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    monkeypatch.setattr(jdm, "CACHE_CHUNK", 8)  # 2 chunks: idx 7 / 8 sit at the edge
    a = _inputs(idx, gated)
    j, t = _jax(a), _torch(a)
    ref = jdm.mega_decode_step(j["stacked"], j["x"], j["k"], j["v"], j["kx"], j["vx"],
                               j["bias_row"], j["bias0"], j["mask"], idx, G, H,
                               src=j["src"] if use_src else None, interpret=True,
                               gated=gated)
    k_in = t["k"].clone()
    before = dm.KERNEL.launches
    got = dm.mega_decode_step(t["stacked"], t["x"], t["k"], t["v"], t["kx"], t["vx"],
                              t["bias_row"], t["bias0"], t["mask"], idx, G, H,
                              src=t["src"] if use_src else None, gated=gated)
    assert dm.KERNEL.launches == before
    assert len(got) == len(ref)
    for g, r in zip(got[:3], ref[:3]):  # hidden, k_new, v_new
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=TOL)
    if use_src:
        # rows < idx are the permuted input rows, exactly; row idx is the new k/v
        for g, r, new in ((got[3], ref[3], got[1]), (got[4], ref[4], got[2])):
            np.testing.assert_array_equal(g[:, :, :idx].numpy(), np.asarray(r)[:, :, :idx])
            np.testing.assert_array_equal(g[:, :, idx].numpy(), new.numpy())
        assert torch.equal(t["k"], k_in)  # input caches untouched
    else:
        # greedy: row idx written in place, every other row untouched
        np.testing.assert_array_equal(t["k"][:, :, idx].numpy(), got[1].numpy())
        keep = [i for i in range(L) if i != idx]
        assert torch.equal(t["k"][:, :, keep], k_in[:, :, keep])


def test_decode_fns_match_jax_and_skipped_reorder_is_noop():
    """Three steps of beam-4 DecodeFns, port against JAX: a reorder, then a
    skipped reorder, which must be a no-op (pending_src back at identity)."""
    from vidchapters_tpu.ops.decode_megakernel import make_mega_decode_fns as jax_fns
    from vidchapters_tpu_torch.ops.decode_megakernel import make_mega_decode_fns

    jcfg, tcfg = small_cfgs()
    _, params = jax_params(jcfg)
    model = port_model(tcfg, params)
    rows = B0 * G
    rng = np.random.default_rng(7)
    enc = rng.normal(size=(B0, LENC, 128)).astype(np.float32)
    mask = np.ones((B0, LENC), np.int32)
    mask[1, 20:] = 0
    jf = jax_fns(jcfg.t5, params["t5"], L, num_beams=G, interpret=True)
    tf = make_mega_decode_fns(model.t5, L, num_beams=G)
    jc = jf.init_cache(rows, jnp.asarray(enc))
    tc = tf.init_cache(rows, torch.from_numpy(enc))
    parent = np.array([(i // G) * G + (G - 1 - i % G) for i in range(rows)], np.int32)
    with torch.no_grad():
        for i in range(3):
            toks = rng.integers(2, 32200, (rows,)).astype(np.int32)
            jl, jc = jf.step(jnp.asarray(toks), jc, i, jnp.asarray(mask))
            tl, tc = tf.step(torch.from_numpy(toks), tc, i, torch.from_numpy(mask))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
            np.testing.assert_array_equal(tc["pending_src"].numpy(), np.arange(rows))
            if i == 0:  # reorder after the first step only; the second is skipped
                jc = jf.reorder_cache(jc, jnp.asarray(parent))
                tc = tf.reorder_cache(tc, torch.from_numpy(parent))
