"""The port's Vid2Seq forward against the JAX package's, on the CPU in fp32:
relative-position buckets, T5 encoder states (including the long-sequence
route through the fused-attention wrapper), ViT states and the training
loss. Both packages get the same weights and the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_helpers import batch, jax_params, port_model, small_cfgs

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg)
    return jmodel, params, port_model(tcfg, params)


@pytest.mark.parametrize("bidirectional,buckets,max_distance",
                         [(True, 32, 128), (False, 32, 128), (True, 8, 16)])
def test_relative_position_buckets_match(bidirectional, buckets, max_distance):
    from vidchapters_tpu.models.t5 import relative_position_bucket as jax_bucket
    from vidchapters_tpu_torch.models.t5 import relative_position_bucket

    # every key - query offset of the encoder (L <= 1152) and decoder (256)
    rel = np.arange(-1200, 1201, dtype=np.int32)
    ref = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, buckets,
                                max_distance))
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                   buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seq", [20, 600])
def test_t5_encoder_matches_jax(models, seq):
    """seq 600 pads to 640 > 512: the port routes it through the fused
    attention wrapper (its plain version on the CPU)."""
    jmodel, params, model = models
    rng = np.random.default_rng(seq)
    tokens = rng.integers(3, 32200, size=(2, seq)).astype(np.int32)
    tokens[0, seq - 7:] = 0
    mask = (tokens != 0).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(mask),
                       method=lambda m, i, a: m.t5.encode(input_ids=i, attention_mask=a))
    with torch.no_grad():
        got = model.t5.encode(input_ids=torch.from_numpy(tokens),
                              attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_vit_matches_jax(models):
    jmodel, params, model = models
    video = np.random.default_rng(1).normal(size=(2, 16, 128)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(video),
                       method=lambda m, v: m.encode_video(v))
    with torch.no_grad():
        got = model.encode_video(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_vid2seq_loss_and_encoding_match_jax(models):
    jmodel, params, model = models
    video, tokens, labels = batch(np.random.default_rng(2))
    mask = (tokens != 0).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(video), jnp.asarray(tokens),
                       jnp.asarray(mask), jnp.asarray(labels))
    ref_enc, ref_mask = jmodel.apply(
        {"params": params}, jnp.asarray(video), jnp.asarray(tokens),
        jnp.asarray(mask), method=lambda m, v, t, a: m.encode_for_generation(v, t, a))
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in (video, tokens, mask, labels)]
        out = model(*t)
        enc, enc_mask = model.encode_for_generation(*t[:3])
    assert enc.shape[1] == 128  # 16 frames + 20 tokens, padded once to 128
    np.testing.assert_array_equal(enc_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out["video_embeds"].numpy(),
                               np.asarray(ref["video_embeds"]), atol=TOL, rtol=TOL)
