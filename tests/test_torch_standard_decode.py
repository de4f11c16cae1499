"""The port's standard cached decode (``init_cache`` / ``decode_step``, its
attentions through ``ops/decode_attention``'s plain versions on the CPU)
against the JAX package's, in fp32 at small width:

- per-step logits over 8 steps, beams sharing per-example cross K/V (2e-5);
- greedy and beam-3 tokens identical to the JAX package's standard decode,
  with its fused decode kernels off and on (interpret mode);
- tokens identical to the port's own decode-kernel route;
- ``reorder_beam_cache`` permutes the self K/V and leaves ``cross`` alone;
- nucleus sampling: the same filtered logits as JAX's ``nucleus_sample``,
  the same tokens as JAX (and as greedy) at ``top_p`` 1e-6, and draws whose
  frequencies follow the filtered softmax.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_helpers import batch, jax_params, port_model, small_cfgs

MAX_LEN = 16
TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg, seed=5)
    return jmodel, params, port_model(tcfg, params)


@pytest.fixture
def standard_route(monkeypatch):
    """The port's greedy and beam search on the standard decode."""
    from vidchapters_tpu_torch.models import t5

    monkeypatch.setattr(t5, "USE_MEGA_DECODE", False)


def _encode(jmodel, params, video, tokens):
    enc, mask = jmodel.apply({"params": params}, jnp.asarray(video), jnp.asarray(tokens),
                             jnp.asarray((tokens != 0).astype(np.int32)),
                             method=jmodel.encode_for_generation)
    return np.array(enc), np.array(mask)


def test_step_logits_match_jax(models):
    from vidchapters_tpu.ops.decoding import make_decode_fns as jax_decode_fns
    from vidchapters_tpu_torch.ops.decoding import make_decode_fns

    jmodel, params, model = models
    rng = np.random.default_rng(0)
    video, tokens, _ = batch(rng, b=2)
    enc, mask = _encode(jmodel, params, video, tokens)
    beams = 2
    jfns = jax_decode_fns(jmodel, params, MAX_LEN)
    fns = make_decode_fns(model, MAX_LEN)
    jcache = jfns.init_cache(2 * beams, jnp.asarray(enc))
    with torch.no_grad():
        cache = fns.init_cache(2 * beams, torch.from_numpy(enc))
        for i in range(8):
            tok = rng.integers(0, 32200, size=2 * beams).astype(np.int32)
            ref, jcache = jfns.step(jnp.asarray(tok), jcache, jnp.int32(i), jnp.asarray(mask))
            got, cache = fns.step(torch.from_numpy(tok), cache, i, torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL,
                                       err_msg=f"step {i}")


def _jax_tokens(jmodel, params, video, tokens, **gen):
    from vidchapters_tpu.config import GenerationConfig as JGen
    from vidchapters_tpu.train.dvc_train import make_generate_fn

    return np.asarray(make_generate_fn(jmodel, JGen(max_length=MAX_LEN, **gen))(
        params, jnp.asarray(video), jnp.asarray(tokens), jax.random.PRNGKey(0)))


def _port_tokens(model, video, tokens, generator=None, **gen):
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    return make_generate_fn(model, GenerationConfig(max_length=MAX_LEN, **gen))(
        torch.from_numpy(video), torch.from_numpy(tokens), generator).numpy()


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_tokens_identical_to_jax_standard_decode(models, standard_route, monkeypatch,
                                                 num_beams, fused):
    import vidchapters_tpu.models.t5 as jt5

    jmodel, params, model = models
    monkeypatch.setattr(jt5, "USE_FUSED_DECODE", fused)
    video, tokens, _ = batch(np.random.default_rng(num_beams), b=3)
    gen = dict(num_beams=num_beams, repetition_penalty=3.0)
    ref = _jax_tokens(jmodel, params, video, tokens, **gen)
    got = _port_tokens(model, video, tokens, **gen)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) > 6  # the penalty breaks the random model's repeats


@pytest.mark.parametrize("num_beams", [1, 3])
def test_standard_route_matches_megakernel_route(models, monkeypatch, num_beams):
    from vidchapters_tpu_torch.models import t5
    from vidchapters_tpu_torch.ops import decode_attention, decode_megakernel

    model = models[2]
    video, tokens, _ = batch(np.random.default_rng(7 + num_beams), b=2)
    gen = dict(num_beams=num_beams, repetition_penalty=3.0)
    calls = {"mega": 0, "self": 0}
    for name, mod, fn in (("mega", decode_megakernel, "mega_decode_step_plain"),
                          ("self", decode_attention, "decode_self_attention_plain")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, counted)
    mega = _port_tokens(model, video, tokens, **gen)
    assert calls == {"mega": MAX_LEN, "self": 0}
    monkeypatch.setattr(t5, "USE_MEGA_DECODE", False)
    standard = _port_tokens(model, video, tokens, **gen)
    assert calls == {"mega": MAX_LEN, "self": MAX_LEN * model.cfg.t5.num_decoder_layers}
    np.testing.assert_array_equal(standard, mega)


def test_reorder_beam_cache_skips_cross(models):
    from vidchapters_tpu_torch.ops.decoding import reorder_beam_cache

    model = models[2]
    rows = 4  # 2 examples x 2 beams; the cross K/V holds the 2 examples
    enc = torch.randn(2, 10, model.cfg.t5.d_model)
    cache = model.init_cache(rows, MAX_LEN, enc)
    for blk in cache.values():
        blk["self"]["k"].normal_()
        blk["self"]["v"].normal_()
    src = torch.tensor([1, 1, 2, 3])
    out = reorder_beam_cache(cache, src)
    assert out.keys() == cache.keys()
    for name, blk in cache.items():
        assert out[name]["cross"] is blk["cross"]
        for kv in ("k", "v"):
            assert torch.equal(out[name]["self"][kv], blk["self"][kv][src])


def test_topp_filter_identical_to_jax(monkeypatch):
    """The logits JAX's ``nucleus_sample`` hands to its draw, after the
    temperature, the min-length EOS mask and the top-p filter, against the
    port's ``topp_filter`` on the same logits (exact)."""
    from vidchapters_tpu.ops import decoding as jdec
    from vidchapters_tpu_torch.ops.decoding import NEG_INF, topp_filter

    rng = np.random.default_rng(3)
    steps, b, vocab, top_p, temp, min_len = 3, 4, 50, 0.8, 0.7, 3
    logits = (rng.normal(size=(steps, b, vocab)) * 3.0).astype(np.float32)
    seen = []

    def draw(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", draw)
    fns = jdec.DecodeFns(lambda batch, enc: jnp.zeros(()),
                         lambda tok, cache, i, mask: (jnp.asarray(logits)[i], cache))
    with jax.disable_jit():
        jdec.nucleus_sample(fns, jnp.zeros((b, 2, 8)), jnp.ones((b, 2), jnp.int32), steps,
                            jax.random.PRNGKey(0), top_p=top_p, temperature=temp,
                            eos_token_id=1, min_length=min_len)
    assert len(seen) == steps
    for i in range(steps):
        x = torch.from_numpy(logits[i]) / temp
        if i + 1 < min_len:
            x[:, 1] = NEG_INF
        got = topp_filter(x, top_p).numpy()
        np.testing.assert_array_equal(got, seen[i])
        assert ((got > NEG_INF).sum(1) < vocab).all() and ((got > NEG_INF).sum(1) >= 1).all()


def test_nucleus_at_tiny_top_p_is_greedy_and_matches_jax(models, standard_route):
    jmodel, params, model = models
    video, tokens, _ = batch(np.random.default_rng(11), b=3)
    gen = dict(repetition_penalty=1.0)
    ref = _jax_tokens(jmodel, params, video, tokens, use_nucleus_sampling=True, top_p=1e-6,
                      **gen)
    got = _port_tokens(model, video, tokens, torch.Generator().manual_seed(1),
                       use_nucleus_sampling=True, top_p=1e-6, **gen)
    greedy = _port_tokens(model, video, tokens, num_beams=1, **gen)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, greedy)


def test_nucleus_draws_follow_filtered_softmax():
    """20000 draws from one logits row: each token's frequency is within
    0.015 (above 4 standard deviations) of its filtered probability, and no
    token outside the nucleus is drawn."""
    from vidchapters_tpu_torch.ops.decoding import categorical, topp_filter

    row = torch.tensor([[2.0, 1.5, 1.2, 1.0, 0.3, -0.5, -1.0, -3.0]])
    n = 20000
    filtered = topp_filter(row.repeat(n, 1), 0.9)
    draws = categorical(filtered, torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=row.shape[1]).float() / n
    want = torch.softmax(filtered[0], dim=-1)
    assert (want[-3:] == 0).all() and (want[:4] > 0.05).all()
    assert (freq - want).abs().max().item() < 0.015, (freq, want)
    assert (freq[want == 0] == 0).all()
