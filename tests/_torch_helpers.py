"""Shared set-up of the PyTorch port's parity tests: one small Vid2Seq
config, the JAX package's random init of it, and the port's model holding
the same weights (through ``from_jax_params``); one small BLIP-2 config and
a synthetic HF BLIP-2 checkpoint directory (which ``chip_smoke.py`` writes
too). Nothing here imports jax until a function that needs it is called."""

from __future__ import annotations

import json
from pathlib import Path

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


def blip2_small_cfgs(vocab: int = 120, dtype: str = "float32"):
    """(JAX Blip2Config, port Blip2Config) of the same small sizes: ViT 2 x
    32 over 28-pixel images in 14-pixel patches, Q-Former 2 x 32, T5 2+2 x 32
    gated-GELU, 4 query tokens."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.models import blip2 as jb
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.models import blip2 as tb

    def make(m, c):
        return m.Blip2Config(
            vision=m.Blip2VisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                                       num_heads=4, image_size=28, patch_size=14, dtype=dtype),
            qformer=m.QFormerConfig(hidden_size=32, num_layers=2, num_heads=4,
                                    intermediate_size=48, cross_attention_frequency=2,
                                    encoder_hidden_size=32, dtype=dtype),
            t5=c.T5Config(vocab_size=vocab, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                          num_decoder_layers=2, num_heads=4, feed_forward_proj="gated-gelu",
                          tie_word_embeddings=False, label_smoothing=0.0, dropout_rate=0.0,
                          encoder_dropout=0.0, decoder_dropout=0.0, dtype=dtype),
            num_query_tokens=4)

    return make(jb, jc), make(tb, tc)


def blip2_hf_state_dict(cfg, seed: int = 0):
    """A state dict of ``cfg``'s BLIP-2 (a ``models.blip2.Blip2Config``)
    under HF ``Blip2ForConditionalGeneration``'s names, seeded random float32
    tensors: N(0, 1/fan_in) matrices, T5's ``shared`` N(0, 1), the other
    tensors N(0, 0.02), norm scales 1 + N(0, 0.1); the T5's tied
    ``embed_tokens`` copies equal ``shared``."""
    import numpy as np
    import torch

    v, q, t = cfg.vision, cfg.qformer, cfg.t5
    d, p, dq = v.hidden_size, v.patch_size, q.hidden_size
    lm = "language_model."
    shapes = {"query_tokens": (1, cfg.num_query_tokens, dq),
              "vision_model.embeddings.class_embedding": (1, 1, d),
              "vision_model.embeddings.position_embedding": (1, (v.image_size // p) ** 2 + 1, d),
              "vision_model.embeddings.patch_embedding.weight": (d, 3, p, p),
              "vision_model.embeddings.patch_embedding.bias": (d,)}
    scales = set()

    def dense(name, n_out, n_in, bias=True):
        shapes[name + ".weight"] = (n_out, n_in)
        if bias:
            shapes[name + ".bias"] = (n_out,)

    def norm(name, n, bias=True):
        shapes[name + ".weight"] = (n,)
        scales.add(name + ".weight")
        if bias:
            shapes[name + ".bias"] = (n,)

    norm("vision_model.post_layernorm", d)
    for i in range(v.num_layers):
        lp = f"vision_model.encoder.layers.{i}."
        norm(lp + "layer_norm1", d)
        norm(lp + "layer_norm2", d)
        dense(lp + "self_attn.qkv", 3 * d, d)
        dense(lp + "self_attn.projection", d, d)
        dense(lp + "mlp.fc1", v.intermediate_size, d)
        dense(lp + "mlp.fc2", d, v.intermediate_size)
    norm("qformer.layernorm", dq)
    for i in range(q.num_layers):
        lp = f"qformer.encoder.layer.{i}."
        parts = ["attention."] + ["crossattention."] * (i % q.cross_attention_frequency == 0)
        for part in parts:
            n_kv = q.encoder_hidden_size if part == "crossattention." else dq
            dense(lp + part + "attention.query", dq, dq)
            dense(lp + part + "attention.key", dq, n_kv)
            dense(lp + part + "attention.value", dq, n_kv)
            dense(lp + part + "output.dense", dq, dq)
            norm(lp + part + "output.LayerNorm", dq)
        dense(lp + "intermediate_query.dense", q.intermediate_size, dq)
        dense(lp + "output_query.dense", dq, q.intermediate_size)
        norm(lp + "output_query.LayerNorm", dq)
    dense("language_projection", t.d_model, dq)
    inner = t.num_heads * t.d_kv
    shapes[lm + "shared.weight"] = (t.vocab_size, t.d_model)
    dense(lm + "lm_head", t.vocab_size, t.d_model, bias=False)
    for stack, n in (("encoder", t.num_layers), ("decoder", t.num_decoder_layers)):
        norm(f"{lm}{stack}.final_layer_norm", t.d_model, bias=False)
        shapes[f"{lm}{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            t.relative_attention_num_buckets, t.num_heads)
        for i in range(n):
            bp = f"{lm}{stack}.block.{i}.layer."
            for a in ["0.SelfAttention"] + ["1.EncDecAttention"] * (stack == "decoder"):
                for w in "qkv":
                    dense(f"{bp}{a}.{w}", inner, t.d_model, bias=False)
                dense(f"{bp}{a}.o", t.d_model, inner, bias=False)
                norm(bp + a[:2] + "layer_norm", t.d_model, bias=False)
            ff = bp + ("2." if stack == "decoder" else "1.")
            dense(ff + "DenseReluDense.wi_0", t.d_ff, t.d_model, bias=False)
            dense(ff + "DenseReluDense.wi_1", t.d_ff, t.d_model, bias=False)
            dense(ff + "DenseReluDense.wo", t.d_model, t.d_ff, bias=False)
            norm(ff + "layer_norm", t.d_model, bias=False)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        x = rng.standard_normal(shape)
        if name in scales:
            x = 1.0 + 0.1 * x
        elif name == lm + "shared.weight":
            pass
        elif len(shape) == 2:
            x = x * shape[1] ** -0.5
        else:
            x = 0.02 * x
        sd[name] = torch.from_numpy(x.astype(np.float32))
    for stack in ("encoder", "decoder"):
        sd[f"{lm}{stack}.embed_tokens.weight"] = sd[lm + "shared.weight"].clone()
    return sd


def blip2_hf_config(cfg) -> dict:
    """``config.json`` of an HF BLIP-2 checkpoint of ``cfg``'s sizes."""
    v, q, t = cfg.vision, cfg.qformer, cfg.t5
    return {"model_type": "blip-2", "num_query_tokens": cfg.num_query_tokens,
            "vision_config": {"hidden_size": v.hidden_size,
                              "intermediate_size": v.intermediate_size,
                              "num_hidden_layers": v.num_layers,
                              "num_attention_heads": v.num_heads,
                              "image_size": v.image_size, "patch_size": v.patch_size},
            "qformer_config": {"hidden_size": q.hidden_size, "num_hidden_layers": q.num_layers,
                               "num_attention_heads": q.num_heads,
                               "intermediate_size": q.intermediate_size,
                               "cross_attention_frequency": q.cross_attention_frequency,
                               "encoder_hidden_size": q.encoder_hidden_size},
            "text_config": {"model_type": "t5", "vocab_size": t.vocab_size,
                            "d_model": t.d_model, "d_kv": t.d_kv, "d_ff": t.d_ff,
                            "num_layers": t.num_layers,
                            "num_decoder_layers": t.num_decoder_layers,
                            "num_heads": t.num_heads, "feed_forward_proj": "gated-gelu",
                            "tie_word_embeddings": False}}


def write_blip2_dir(root: Path, cfg, seed: int = 0, shards: int = 1) -> Path:
    """An HF BLIP-2 checkpoint directory of seeded random weights:
    ``config.json``, ``pytorch_model.bin`` (or ``shards`` files and their
    ``pytorch_model.bin.index.json``) and a synthetic ``spiece.model`` of
    T5's 32,000 pieces (``chip_smoke._write_spm_model``)."""
    import torch

    from chip_smoke import _write_spm_model

    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(blip2_hf_config(cfg)))
    sd = blip2_hf_state_dict(cfg, seed)
    if shards == 1:
        torch.save(sd, root / "pytorch_model.bin")
    else:
        names = sorted(sd)
        weight_map = {}
        for k in range(shards):
            fname = f"pytorch_model-{k + 1:05d}-of-{shards:05d}.bin"
            part = names[k::shards]
            torch.save({n: sd[n] for n in part}, root / fname)
            weight_map.update({n: fname for n in part})
        (root / "pytorch_model.bin.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}))
    _write_spm_model(root / "spiece.model")
    return root
