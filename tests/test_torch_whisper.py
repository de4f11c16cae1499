"""The port's Whisper model against the JAX package's: the encoder, the
full-sequence decoder forward and the standard cached decode (logits within
1e-5), the grouped beam cross-attention, and both weight importers (the JAX
tree, and a synthetic HF-named state dict through JAX's
``convert_hf_whisper``). Small widths, fp32, inputs from numpy seeds."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.models import whisper as jw
from vidchapters_tpu_torch.models import whisper as tw
from vidchapters_tpu_torch.models.weights import (
    whisper_from_hf_state_dict,
    whisper_from_jax_params,
)

TOL = 1e-5
KW = dict(vocab_size=256, num_mel_bins=8, d_model=64, encoder_layers=1, decoder_layers=2,
          num_heads=4, d_ff=128, max_source_positions=30, max_target_positions=12,
          dtype="float32")


def _pair(seed: int = 0, **kw):
    cfg = {**KW, **kw}
    jm = jw.Whisper(jw.WhisperConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, cfg["num_mel_bins"], 60)),
                                    jnp.zeros((1, 4), jnp.int32))["params"])
    tm = tw.Whisper(tw.WhisperConfig(**cfg))
    tm.load_state_dict(whisper_from_jax_params(params, tm))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_config_matches_jax():
    assert tw.LARGE_V2 == tw.WhisperConfig()
    for field in ("vocab_size", "num_mel_bins", "max_source_positions", "max_target_positions",
                  "d_model", "encoder_layers", "decoder_layers", "num_heads", "d_ff", "dtype"):
        assert getattr(tw.LARGE_V2, field) == getattr(jw.LARGE_V2, field)
        assert getattr(tw.TINY, field) == getattr(jw.TINY, field)
    np.testing.assert_array_equal(tw.sinusoids(1500, 1280), jw.sinusoids(1500, 1280))


def test_encoder_and_forward_match_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    mel = rng.normal(size=(3, 8, 60)).astype(np.float32)
    toks = rng.integers(0, 256, (3, 9)).astype(np.int32)
    enc = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode))
    logits = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode(torch.from_numpy(mel)).numpy(), enc, atol=TOL)
        got = tm(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, logits, atol=TOL)


@pytest.mark.parametrize("beams", [1, 3])
def test_standard_decode_logits_match_jax(pair, beams):
    """Five cached decode steps (per-example cross K/V shared by the beams
    when ``beams`` > 1), each step's logits within 1e-5."""
    from vidchapters_tpu.ops.decoding import make_decode_fns

    jm, params, tm = pair
    rng = np.random.default_rng(2)
    mel = rng.normal(size=(2, 8, 60)).astype(np.float32)
    rows = 2 * beams
    jenc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    fns = make_decode_fns(jm, params, 12)
    jc = fns.init_cache(rows, jenc)
    toks = rng.integers(0, 256, rows).astype(np.int32)
    with torch.no_grad():
        tc = tm.init_cache(rows, 12, tm.encode(torch.from_numpy(mel)))
        for i in range(5):
            jl, jc = fns.step(jnp.asarray(toks), jc, jnp.asarray(i), None)
            tl, tc = tm.decode_step(torch.from_numpy(toks), tc, i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
            toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_grouped_cross_attention_matches_jax():
    """The grouped beam branch (K/V rows fewer than query rows) against the
    JAX module's, and against the same attention over repeated K/V."""
    cfg = dict(KW, d_model=32, num_heads=4)
    rng = np.random.default_rng(0)
    b, k, lk = 2, 3, 7
    enc = rng.normal(size=(b, lk, 32)).astype(np.float32)
    q_in = rng.normal(size=(b * k, 1, 32)).astype(np.float32)
    jattn = jw.WhisperAttention(jw.WhisperConfig(**cfg))
    params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(q_in), jnp.asarray(q_in))["params"]
    kv = jattn.apply({"params": params}, jnp.asarray(enc), method=jattn.precompute_kv)
    ref, _ = jattn.apply({"params": params}, jnp.asarray(q_in), None, cache=kv)
    tattn = tw.WhisperAttention(tw.WhisperConfig(**cfg))
    tattn.load_state_dict({f"{n}.{'weight' if leaf == 'kernel' else leaf}":
                           torch.from_numpy(np.array(v).T.copy() if leaf == "kernel"
                                            else np.array(v))
                           for n, d in params.items() for leaf, v in d.items()})
    with torch.no_grad():
        tkv = tattn.precompute_kv(torch.from_numpy(enc))
        got = tattn.decode_cross(torch.from_numpy(q_in), tkv)
        rep = tattn.decode_cross(torch.from_numpy(q_in),
                                 {n: t.repeat_interleave(k, dim=0) for n, t in tkv.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(got.numpy(), rep.numpy(), atol=1e-6)


def test_jax_importer_raises_on_leaves_it_cannot_place(pair):
    _, params, tm = pair
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["decoder"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        whisper_from_jax_params(bad, tm)
    short = jax.tree_util.tree_map(lambda x: x, params)
    del short["decoder"]["ln"]
    with pytest.raises(ValueError, match="decoder.ln"):
        whisper_from_jax_params(short, tm)


def _hf_state_dict(rng, cfg, prefix="model."):
    """A synthetic HF ``WhisperForConditionalGeneration`` state dict."""
    d, f, m = cfg["d_model"], cfg["d_ff"], cfg["num_mel_bins"]
    r = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    sd = {"encoder.conv1.weight": r(d, m, 3), "encoder.conv1.bias": r(d),
          "encoder.conv2.weight": r(d, d, 3), "encoder.conv2.bias": r(d),
          "encoder.embed_positions.weight": tw.sinusoids(cfg["max_source_positions"], d
                                                         ).astype(np.float32),
          "encoder.layer_norm.weight": 1 + r(d), "encoder.layer_norm.bias": r(d),
          "decoder.embed_tokens.weight": r(cfg["vocab_size"], d),
          "decoder.embed_positions.weight": r(cfg["max_target_positions"], d),
          "decoder.layer_norm.weight": 1 + r(d), "decoder.layer_norm.bias": r(d)}

    def attn(p):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}{n}.weight"] = r(d, d)
            if n != "k_proj":
                sd[f"{p}{n}.bias"] = r(d)

    def layer(p, cross):
        attn(p + "self_attn.")
        names = ["self_attn_layer_norm", "final_layer_norm"]
        if cross:
            attn(p + "encoder_attn.")
            names.append("encoder_attn_layer_norm")
        for n in names:
            sd[f"{p}{n}.weight"], sd[f"{p}{n}.bias"] = 1 + r(d), r(d)
        sd[p + "fc1.weight"], sd[p + "fc1.bias"] = r(f, d), r(f)
        sd[p + "fc2.weight"], sd[p + "fc2.bias"] = r(d, f), r(d)

    for i in range(cfg["encoder_layers"]):
        layer(f"encoder.layers.{i}.", False)
    for i in range(cfg["decoder_layers"]):
        layer(f"decoder.layers.{i}.", True)
    out = {prefix + k: v for k, v in sd.items()}
    out["proj_out.weight"] = sd["decoder.embed_tokens.weight"]
    return out


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_hf_importer_matches_convert_hf_whisper(prefix):
    cfg = dict(KW)
    rng = np.random.default_rng(5)
    sd = _hf_state_dict(rng, cfg, prefix)
    jm = jw.Whisper(jw.WhisperConfig(**cfg))
    params = jw.convert_hf_whisper(sd)
    tm = tw.Whisper(tw.WhisperConfig(**cfg))
    tm.load_state_dict(whisper_from_hf_state_dict(sd, tm))
    tm.eval()
    mel = rng.normal(size=(2, 8, 60)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 6)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    # torch tensors are taken as well
    as_tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    for name, t in whisper_from_hf_state_dict(as_tensors, tm).items():
        assert torch.equal(t, tm.state_dict()[name])


def test_hf_importer_raises_on_names_it_cannot_place():
    cfg = dict(KW)
    tm = tw.Whisper(tw.WhisperConfig(**cfg))
    sd = _hf_state_dict(np.random.default_rng(6), cfg)
    with pytest.raises(ValueError, match="unexpected"):
        whisper_from_hf_state_dict({**sd, "model.decoder.unexpected.weight": np.zeros(3)}, tm)
    short = {k: v for k, v in sd.items() if "decoder.layers.1.fc2.bias" not in k}
    with pytest.raises(ValueError, match="decoder.layers.1.fc2.bias"):
        whisper_from_hf_state_dict(short, tm)
    untied = {**sd, "proj_out.weight": sd["proj_out.weight"] + 1.0}
    with pytest.raises(ValueError, match="tied"):
        whisper_from_hf_state_dict(untied, tm)
    moved = {**sd, "model.encoder.embed_positions.weight":
             sd["model.encoder.embed_positions.weight"] + 1.0}
    with pytest.raises(ValueError, match="sinusoids"):
        whisper_from_hf_state_dict(moved, tm)


def test_init_weights_is_seeded():
    a, b = (tw.Whisper(tw.WhisperConfig(**KW)) for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(a.decoder.ln.weight, torch.ones(64))
    assert a.decoder.layers[0].self_attn.k.bias is None
