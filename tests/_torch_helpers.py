"""Shared set-up of the PyTorch port's parity tests: one small Vid2Seq
config, the JAX package's random init of it, and the port's model holding
the same weights (through ``from_jax_params``)."""

from __future__ import annotations

import numpy as np


def small_cfgs(num_decoder_layers: int = 2, feed_forward_proj: str = "relu",
               dtype: str = "float32"):
    """(JAX Vid2SeqConfig, port Vid2SeqConfig) at d 128, 2+2 layers, 4
    heads, compute in ``dtype`` (fp32 by default): the same fields in both
    packages."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    def make(m):
        t5 = m.T5Config(vocab_size=32200, d_model=128, d_kv=32, d_ff=256,
                        num_layers=2, num_decoder_layers=num_decoder_layers,
                        num_heads=4, dropout_rate=0.0, encoder_dropout=0.0,
                        decoder_dropout=0.0, dtype=dtype,
                        feed_forward_proj=feed_forward_proj)
        vit = m.TemporalViTConfig(num_features=16, embed_dim=128, depth=2,
                                  num_heads=4, mlp_dim=256, dtype=dtype)
        return m.Vid2SeqConfig(t5=t5, vit=vit, num_bins=100)

    return make(jc), make(tc)


def jax_params(jcfg, seed: int = 0):
    """The JAX package's Vid2Seq and its random init as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu.models.vid2seq import Vid2Seq

    model = Vid2Seq(jcfg)
    rng = jax.random.PRNGKey(seed)
    toks = jnp.ones((1, 8), jnp.int32)
    params = model.init({"params": rng, "dropout": rng},
                        jnp.zeros((1, jcfg.vit.num_features, jcfg.vit.embed_dim)),
                        toks, toks, toks)["params"]
    return model, jax.device_get(params)


def port_model(tcfg, params):
    """The port's Vid2Seq on the CPU, loaded with the JAX params."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params

    model = Vid2Seq(tcfg)
    model.load_state_dict(from_jax_params(params, model))
    return model.eval()


def batch(rng: np.random.Generator, b: int = 2, t: int = 16, d: int = 128,
          s: int = 20, out: int = 12):
    """Random video features, input tokens with padding, output labels."""
    video = rng.normal(size=(b, t, d)).astype(np.float32)
    tokens = rng.integers(3, 32200, size=(b, s)).astype(np.int32)
    tokens[0, s - 5:] = 0
    labels = rng.integers(3, 32200, size=(b, out)).astype(np.int32)
    labels[1, out - 3:] = 0
    return video, tokens, labels
