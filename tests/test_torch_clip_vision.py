"""The port's CLIP image tower against the JAX package's, on the CPU with
seeded numpy inputs at a small width (patch 32, width 64, 2 layers):

- ``CLIPImageEncoder`` on both attention routes (``USE_FUSED_ATTENTION``
  True: ``ops/fused_attention``'s plain version here, against JAX's fused
  route with the Pallas kernel in interpret mode as ``tests/test_clip.py``
  runs it; False: the einsum route on both sides), fp32 within 1e-5 of the
  largest output; bf16 within 2e-2 of it (a few bf16 roundings apart);
- the fused route pads keys to a multiple of 64 under a mask and takes the
  query rows as they are;
- ``convert_openai_clip_visual`` and ``convert_hf_clip_visual`` on
  synthetic OpenAI- and HF-named state dicts against the JAX converters
  (through ``clip_vision_from_jax_params``), and their raises.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.models import clip as jclip
from vidchapters_tpu.ops import fused_attention as jfa
from vidchapters_tpu_torch.models import clip as tclip
from vidchapters_tpu_torch.models.weights import clip_vision_from_jax_params

KW = dict(image_size=64, patch_size=32, width=64, layers=2, heads=2, output_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops (the suite runs
    several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def routes():
    """Set both packages' attention route; JAX's fused route runs the
    Pallas kernel in interpret mode."""
    old = (jclip.USE_FUSED_ATTENTION, tclip.USE_FUSED_ATTENTION, jfa.fused_attention_padded)

    def set_route(fused: bool):
        jclip.USE_FUSED_ATTENTION = tclip.USE_FUSED_ATTENTION = fused
        jfa.fused_attention_padded = (functools.partial(old[2], interpret=True)
                                      if fused else old[2])

    yield set_route
    jclip.USE_FUSED_ATTENTION, tclip.USE_FUSED_ATTENTION, jfa.fused_attention_padded = old


def _pair(dtype="float32", seed=0, **kw):
    cfg = {**KW, "dtype": dtype, **kw}
    jenc = jclip.CLIPImageEncoder(jclip.CLIPVisionConfig(**cfg))
    enc = tclip.CLIPImageEncoder(tclip.CLIPVisionConfig(**cfg))
    px = jnp.zeros((1, cfg["image_size"], cfg["image_size"], 3))
    params = jax.device_get(jenc.init(jax.random.PRNGKey(seed), px)["params"])
    enc.load_state_dict(clip_vision_from_jax_params(params, enc))
    return jenc, params, enc.eval()


def _pixels(rng, b=3, size=64):
    return rng.normal(size=(b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("fused", [False, True])
def test_vision_tower_matches_jax(routes, fused, dtype, tol):
    jenc, params, enc = _pair(dtype)
    pixels = _pixels(np.random.default_rng(1))
    routes(fused)
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = enc(torch.from_numpy(pixels))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_fused_route_pads_keys_to_the_kernel_tile(monkeypatch):
    """At 257 tokens (ViT-L/14's 16 x 16 patches + the class token) the
    kernel sees 257 query rows and 320 keys, the last 63 masked out; the
    route equals the plain einsum route."""
    seen = []
    real = tclip.fused_attention

    def spy(q, k, v, bias, mask):
        seen.append((tuple(q.shape), tuple(k.shape), mask.sum(dim=1).tolist(), bias))
        return real(q, k, v, bias, mask)

    monkeypatch.setattr(tclip, "fused_attention", spy)
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(2, 257, 3 * 128)).astype(np.float32))
    got = tclip.fused_self_attention(qkv, heads=2)
    assert seen == [((2, 2, 257, 64), (2, 2, 320, 64), [257, 257], None)]
    q, k, v = (t.reshape(2, 257, 2, 64).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / 8.0, dim=-1)
    ref = torch.matmul(probs, v).transpose(1, 2).reshape(2, 257, 128)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * ref.abs().max().item())


def openai_clip_visual_sd(rng, width=64, layers=2, patch=32, size=64, out=32):
    """A synthetic OpenAI ``clip`` state dict: the image tower under
    ``visual.`` and two text-tower names beside it."""
    n = (size // patch) ** 2 + 1
    sd = {"visual.class_embedding": rng.normal(0, .5, width),
          "visual.positional_embedding": rng.normal(0, .5, (n, width)),
          "visual.proj": rng.normal(0, width ** -0.5, (width, out)),
          "visual.conv1.weight": rng.normal(0, (3 * patch * patch) ** -0.5,
                                            (width, 3, patch, patch)),
          "token_embedding.weight": rng.normal(size=(10, 8)), "logit_scale": np.ones(())}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = rng.uniform(.5, 1.5, width)
        sd[f"visual.{ln}.bias"] = rng.normal(0, .1, width)
    for i in range(layers):
        rb = f"visual.transformer.resblocks.{i}."
        sd[rb + "attn.in_proj_weight"] = rng.normal(0, width ** -0.5, (3 * width, width))
        sd[rb + "attn.in_proj_bias"] = rng.normal(0, .1, 3 * width)
        for name, (o, n_in) in (("attn.out_proj", (width, width)),
                                ("mlp.c_fc", (4 * width, width)),
                                ("mlp.c_proj", (width, 4 * width))):
            sd[rb + name + ".weight"] = rng.normal(0, n_in ** -0.5, (o, n_in))
            sd[rb + name + ".bias"] = rng.normal(0, .1, o)
        for ln in ("ln_1", "ln_2"):
            sd[rb + ln + ".weight"] = rng.uniform(.5, 1.5, width)
            sd[rb + ln + ".bias"] = rng.normal(0, .1, width)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _hf_visual_sd(sd):
    """The same weights under HF ``CLIPModel``'s names (q/k/v split)."""
    emb = "vision_model.embeddings."
    hf = {emb + "class_embedding": sd["visual.class_embedding"],
          emb + "position_embedding.weight": sd["visual.positional_embedding"],
          emb + "patch_embedding.weight": sd["visual.conv1.weight"],
          emb + "position_ids": np.arange(5)[None],
          "visual_projection.weight": sd["visual.proj"].T.copy(),
          "vision_model.pre_layrnorm.weight": sd["visual.ln_pre.weight"],
          "vision_model.pre_layrnorm.bias": sd["visual.ln_pre.bias"],
          "vision_model.post_layernorm.weight": sd["visual.ln_post.weight"],
          "vision_model.post_layernorm.bias": sd["visual.ln_post.bias"],
          "text_model.embeddings.token_embedding.weight": sd["token_embedding.weight"],
          "logit_scale": sd["logit_scale"]}
    i = 0
    while f"visual.transformer.resblocks.{i}.ln_1.weight" in sd:
        rb, lp = f"visual.transformer.resblocks.{i}.", f"vision_model.encoder.layers.{i}."
        for leaf in ("weight", "bias"):
            for c, part in zip("qkv", np.split(sd[rb + f"attn.in_proj_{leaf}"], 3)):
                hf[lp + f"self_attn.{c}_proj.{leaf}"] = part
            for ours, theirs in (("attn.out_proj", "self_attn.out_proj"), ("mlp.c_fc", "mlp.fc1"),
                                 ("mlp.c_proj", "mlp.fc2"), ("ln_1", "layer_norm1"),
                                 ("ln_2", "layer_norm2")):
                hf[lp + f"{theirs}.{leaf}"] = sd[rb + f"{ours}.{leaf}"]
        i += 1
    return hf


@pytest.mark.parametrize("names", ["openai", "hf"])
def test_converters_match_jax(names):
    rng = np.random.default_rng(3)
    sd = openai_clip_visual_sd(rng)
    if names == "hf":
        sd = _hf_visual_sd(sd)
    jconv = jclip.convert_openai_clip_visual if names == "openai" else jclip.convert_hf_clip_visual
    tconv = tclip.convert_openai_clip_visual if names == "openai" else tclip.convert_hf_clip_visual
    cfg = {**KW, "dtype": "float32"}
    jenc = jclip.CLIPImageEncoder(jclip.CLIPVisionConfig(**cfg))
    enc = tclip.CLIPImageEncoder(tclip.CLIPVisionConfig(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, jconv(sd))
    enc.load_state_dict(tconv(sd))
    for k, v in clip_vision_from_jax_params(jparams, enc).items():  # the two imports agree
        np.testing.assert_array_equal(v.numpy(), enc.state_dict()[k].numpy(), err_msg=k)
    pixels = _pixels(rng, b=2)
    ref = np.asarray(jax.jit(lambda x: jenc.apply({"params": jparams}, x))(jnp.asarray(pixels)))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_converters_raise_on_names_they_cannot_place():
    rng = np.random.default_rng(4)
    sd = openai_clip_visual_sd(rng)
    for conv, good, bogus in (
            (tclip.convert_openai_clip_visual, sd, "visual.transformer.resblocks.0.attn.bogus"),
            (tclip.convert_hf_clip_visual, _hf_visual_sd(sd),
             "vision_model.encoder.layers.0.self_attn.bogus.weight")):
        conv(good)
        with pytest.raises(ValueError, match="cannot place"):
            conv({**good, bogus: np.zeros(2, np.float32)})
        first_layer = next(k for k in good if ".0." in k and "weight" in k)
        with pytest.raises(ValueError, match="no value for"):
            conv({k: v for k, v in good.items() if k != first_layer})


def test_patch_grid_must_be_whole():
    enc = tclip.CLIPImageEncoder(tclip.CLIPVisionConfig(**{**KW, "dtype": "float32"}))
    with pytest.raises(ValueError, match="patches"):
        enc(torch.zeros(1, 60, 64, 3))


def test_init_weights_is_seeded():
    cfg = tclip.CLIPVisionConfig(**{**KW, "dtype": "float32"})
    a = tclip.CLIPImageEncoder(cfg).init_weights(torch.Generator().manual_seed(5))
    b = tclip.CLIPImageEncoder(cfg).init_weights(torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.patch_embed.weight.std() > 0 and a.blocks[1].mlp_fc.weight.std() > 0


def test_configs_match_jax():
    for name in ("VIT_L14", "VIT_B32", "TEXT_L14", "TEXT_B32"):
        assert (dataclasses.asdict(getattr(tclip, name))
                == dataclasses.asdict(getattr(jclip, name))), name
