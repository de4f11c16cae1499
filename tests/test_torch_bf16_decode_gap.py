"""The bf16 gap between the port's decode and the JAX package's, measured on
the CPU at a small width (2+2 layers, d 128, bfloat16 compute, the same
weights and seeded numpy inputs), on both decode routes:

- the decode kernel: the port's plain version (its residual stream stays
  fp32 through a step) against JAX's ``mega_decode_step`` in interpret mode
  (which rounds the residual to bf16 after every add);
- the standard cached decode: the port's (decode-attention plain versions,
  fp32 probabilities into p.v) against JAX's (probabilities cast to bf16
  before p.v, vidchapters_tpu/models/t5.py:396).

Both routes are fed the same encoder output and, step by step, the same
tokens, so each step's logits differ only by where bf16 rounds. Greedy
tokens from each package's ``make_generate_fn`` are compared as well; their
agreement is what PERF.md records. The fp32 routes are token-identical
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
