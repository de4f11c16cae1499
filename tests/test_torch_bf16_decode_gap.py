"""The bf16 gap between the port's decode and the JAX package's, measured on
the CPU at a small width (2+2 layers, d 128, bfloat16 compute, the same
weights and seeded numpy inputs), on both decode routes:

- the decode kernel: the port's plain version against JAX's
  ``mega_decode_step`` in interpret mode (both round the residual to bf16
  after every add);
- the standard cached decode: the port's (decode-attention plain versions,
  fp32 probabilities into p.v) against JAX's (probabilities cast to bf16
  before p.v, vidchapters_tpu/models/t5.py:396).

Both routes are fed the same encoder output and, step by step, the same
tokens, so each step's logits differ only by where bf16 rounds. Greedy
tokens from each package's ``make_generate_fn`` are compared as well; their
agreement is what PERF.md records. One step of the decode kernel's plain
version is also held to JAX's at a tighter bound (STEP_REL_TOL). The fp32 routes are token-identical
(test_torch_standard_decode.py, test_torch_decode_megakernel.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_helpers import batch, jax_params, port_model, small_cfgs

MAX_LEN = 16
B = 8  # JAX's decode kernel takes 8 rows a block at beam 1
# bf16 keeps 8 significant bits: one rounding of a logit of magnitude
# |z| moves it by up to 2^-8 |z|. The routes round the residual or the
# probabilities at different places, so a step's logits may differ by a
# few such roundings of the largest logit, carried through 2 layers and the
# tied output projection. The bound is 4 % of the step's largest logit:
# measured gaps are below 1 % (PERF.md), and a real fault (a wrong bias
# row, a dropped layer, a mask off by one) moves logits by tens of percent.
REL_TOL = 0.04


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = small_cfgs(dtype="bfloat16")
    jmodel, params = jax_params(jcfg, seed=11)
    return jcfg, jmodel, params, port_model(tcfg, params)


def _enc(jmodel, params, rng):
    video, tokens, _ = batch(rng, b=B)
    enc, mask = jmodel.apply({"params": params}, jnp.asarray(video), jnp.asarray(tokens),
                             jnp.asarray((tokens != 0).astype(np.int32)),
                             method=jmodel.encode_for_generation)
    return video, tokens, np.array(enc.astype(jnp.float32)), np.array(mask)


def _route_fns(route, jcfg, jmodel, params, model):
    if route == "decode_kernel":
        from vidchapters_tpu.ops.decode_megakernel import make_mega_decode_fns as jax_fns
        from vidchapters_tpu_torch.ops.decode_megakernel import make_mega_decode_fns

        return (jax_fns(jcfg.t5, params["t5"], MAX_LEN, num_beams=1, interpret=True),
                make_mega_decode_fns(model.t5, MAX_LEN, num_beams=1))
    from vidchapters_tpu.ops.decoding import make_decode_fns as jax_fns
    from vidchapters_tpu_torch.ops.decoding import make_decode_fns

    return jax_fns(jmodel, params, MAX_LEN), make_decode_fns(model, MAX_LEN)


@pytest.mark.parametrize("route", ["decode_kernel", "standard"])
def test_bf16_step_logits_gap(models, route):
    """Eight teacher-forced steps: each step's logits within REL_TOL of the
    step's largest JAX logit; the argmax agreement is printed."""
    jcfg, jmodel, params, model = models
    rng = np.random.default_rng(0)
    _, _, enc, mask = _enc(jmodel, params, rng)
    jf, tf = _route_fns(route, jcfg, jmodel, params, model)
    jc = jf.init_cache(B, jnp.asarray(enc, jnp.bfloat16))
    with torch.no_grad():
        tc = tf.init_cache(B, torch.from_numpy(enc).bfloat16())
        gaps, agree = [], 0
        for i in range(8):
            tok = rng.integers(3, 32200, size=B).astype(np.int32)
            ref, jc = jf.step(jnp.asarray(tok), jc, i, jnp.asarray(mask))
            got, tc = tf.step(torch.from_numpy(tok), tc, i, torch.from_numpy(mask))
            ref = np.asarray(ref.astype(jnp.float32))
            got = got.float().numpy()
            assert got.shape == ref.shape and np.isfinite(got).all()
            gap = np.abs(got - ref).max() / np.abs(ref).max()
            gaps.append(gap)
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            assert gap <= REL_TOL, f"step {i}: logits gap {gap:.4f} of the largest logit"
    print(f"[bf16 gap] {route}: max relative logit gap {max(gaps):.5f}, "
          f"argmax agreement {agree}/{8 * B}")


@pytest.mark.parametrize("route", ["decode_kernel", "standard"])
def test_bf16_greedy_token_agreement(models, monkeypatch, route):
    """Greedy tokens of 8 videos from each package's generate function on
    the same route; records the share of equal tokens (printed) and holds
    that both are valid token ids of the same shape."""
    import vidchapters_tpu.models.t5 as jt5
    from vidchapters_tpu.config import GenerationConfig as JGen
    from vidchapters_tpu.train.dvc_train import make_generate_fn as jax_generate
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.models import t5
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    import jax

    _, jmodel, params, model = models
    mega = route == "decode_kernel"
    monkeypatch.setattr(jt5, "USE_MEGA_DECODE", mega)
    monkeypatch.setattr(t5, "USE_MEGA_DECODE", None if mega else False)
    video, tokens, _, _ = _enc(jmodel, params, np.random.default_rng(1))
    ref = np.asarray(jax_generate(jmodel, JGen(max_length=MAX_LEN))(
        params, jnp.asarray(video), jnp.asarray(tokens), jax.random.PRNGKey(0)))
    got = make_generate_fn(model, GenerationConfig(max_length=MAX_LEN))(
        torch.from_numpy(video), torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (B, MAX_LEN)
    assert (got >= 0).all() and (got < 32200).all()
    same = float((got == ref).mean())
    first = [int(np.argmax(np.r_[g != r, True])) for g, r in zip(got, ref)]
    print(f"[bf16 gap] {route}: greedy tokens equal {same:.4f} "
          f"({int((got == ref).sum())}/{got.size}); first differing step per video {first}")


# One bf16 step of the decode kernel's plain version against JAX's
# mega_decode_step (interpret mode) on the same bf16 inputs, with a residual
# of ~16 (the input x scaled by 16) against sublayer outputs of ~0.1: bf16
# keeps a value of 16 to 2^-4, so each add rounds away much of its update,
# and the residual's rounding matters. Both now round the residual after
# every add, and after every weight product and every norm. What is left is
# the order of fp32 sums and the attention's own rounding (JAX rounds the
# q.k products to bf16 before its head sums), measured at up to 1.6 bf16
# ulps of the largest hidden element (6.4e-3 at idx 9). The bound is two
# ulps of it, 2^-7: the fp32 residual the port kept before parted from JAX
# by 8.4e-3 and 8.8e-3 at idx 0 and 15 on these inputs.
STEP_REL_TOL = 2.0 ** -7


@pytest.mark.parametrize("idx", [0, 9, 15])
def test_bf16_plain_step_matches_jax_kernel(idx):
    from tests.test_torch_decode_megakernel import G, H, _inputs, _jax, _torch
    from vidchapters_tpu.ops import decode_megakernel as jdm
    from vidchapters_tpu_torch.ops import decode_megakernel as dm

    a = _inputs(idx)
    a["x"] = a["x"] * 16.0
    j, t = _jax(a), _torch(a)
    bf = {k: (v if k in ("ln", "final_ln") else v.astype(jnp.bfloat16))
          for k, v in j["stacked"].items()}
    tbf = {k: (v if k in ("ln", "final_ln") else v.bfloat16()) for k, v in t["stacked"].items()}
    cast_j = [j[n].astype(jnp.bfloat16) for n in ("x", "k", "v", "kx", "vx")]
    cast_t = [t[n].bfloat16() for n in ("x", "k", "v", "kx", "vx")]
    ref = jdm.mega_decode_step(bf, *cast_j, j["bias_row"], j["bias0"], j["mask"], idx, G, H,
                               src=j["src"], interpret=True)
    got = dm.mega_decode_step_plain(tbf, *cast_t, t["bias_row"], t["bias0"], t["mask"], idx,
                                    G, H, src=t["src"])
    hid_ref = np.asarray(ref[0].astype(jnp.float32))
    hid = got[0].float().numpy()
    gap = np.abs(hid - hid_ref).max() / np.abs(hid_ref).max()
    print(f"[bf16 gap] one decode-kernel step, idx {idx}: hidden within {gap:.5f} "
          f"of the largest element")
    assert gap <= STEP_REL_TOL, f"hidden gap {gap:.5f} of the largest element"
    for g, r in zip(got[1:3], ref[1:3]):  # k_new, v_new: layer 0's are exact
        np.testing.assert_array_equal(g[:, 0].float().numpy(),
                                      np.asarray(r[:, 0].astype(jnp.float32)))
