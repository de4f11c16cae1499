"""The port's LLaMA (``models/llama.py``) against the JAX package's, on the
CPU in fp32 at a small width with grouped-query attention (8 heads over 2
K/V heads):

- logits within 2e-5 of JAX's without a cache, left-padded, and through the
  cache (prefill and a decode step);
- ``llama_greedy_generate`` tokens identical to JAX's on ragged left-padded
  prompts, and ``make_llama_generate_fn`` against JAX's generate over the
  same ids;
- ``llama_from_hf_state_dict`` of a synthetic HF state dict equal, tensor
  for tensor, to ``llama_from_jax_params(convert_hf_llama(sd))``;
- weights stored in bfloat16 give the same bfloat16 logits as fp32 ones;
- ``build_llama_titler`` raises on a missing directory before it reads a
  weight.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype: str = "float32"):
    from vidchapters_tpu.models import llama as jl
    from vidchapters_tpu_torch.models import llama as tl

    kw = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=8, num_kv_heads=2, max_position_embeddings=64, dtype=dtype)
    return jl.LlamaConfig(**kw), tl.LlamaConfig(**kw)


@pytest.fixture(scope="module")
def pair():
    """The JAX model with its seeded init (numpy) and the port's model
    holding the same weights."""
    from vidchapters_tpu.models.llama import LlamaForCausalLM as JLlama
    from vidchapters_tpu_torch.models.llama import LlamaForCausalLM
    from vidchapters_tpu_torch.models.weights import llama_from_jax_params

    jcfg, tcfg = _cfgs()
    jmodel = JLlama(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))
                            ["params"])
    model = LlamaForCausalLM(tcfg)
    model.load_state_dict(llama_from_jax_params(params, model))
    return jmodel, params, model.eval()


def _prompts(rng, b=3, p=9):
    ids = rng.integers(3, VOCAB, (b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    ids[0, :3], mask[0, :3] = 1, 0      # ragged left padding, <s> as pad
    ids[2, :5], mask[2, :5] = 1, 0
    return ids, mask


@pytest.mark.parametrize("form", ["plain", "left_padded", "cached"])
def test_llama_logits_match_jax(pair, form):
    from vidchapters_tpu.models.llama import init_cache as jinit_cache
    from vidchapters_tpu_torch.models.llama import init_cache

    jmodel, params, model = pair
    rng = np.random.default_rng(1)
    ids, mask = _prompts(rng)
    if form == "plain":
        ref = jmodel.apply({"params": params}, jnp.asarray(ids))
        with torch.no_grad():
            got = model(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
        return
    if form == "left_padded":
        ref = jmodel.apply({"params": params}, jnp.asarray(ids), attn_mask=jnp.asarray(mask))
        with torch.no_grad():
            got = model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
        return
    # the cache: a prefill of the padded prompts, then one decode step
    b, p = ids.shape
    kv_pad = np.concatenate([mask, np.ones((b, 3), np.int32)], axis=1)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    jcache = jinit_cache(jmodel.cfg, b, p + 3)
    ref0, jcache = jmodel.apply({"params": params}, jnp.asarray(ids), attn_mask=jnp.asarray(mask),
                                position_ids=jnp.asarray(pos), cache=jcache,
                                cache_index=jnp.asarray(0), kv_pad_mask=jnp.asarray(kv_pad))
    nxt = rng.integers(3, VOCAB, (b, 1)).astype(np.int32)
    step_pos = mask.sum(1, keepdims=True)
    ref1, _ = jmodel.apply({"params": params}, jnp.asarray(nxt), position_ids=jnp.asarray(step_pos),
                           cache=jcache, cache_index=p, kv_pad_mask=jnp.asarray(kv_pad))
    cache = init_cache(model.cfg, b, p + 3)
    with torch.no_grad():
        got0 = model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask),
                     position_ids=torch.from_numpy(pos).long(), cache=cache, cache_index=0,
                     kv_pad_mask=torch.from_numpy(kv_pad))
        got1 = model(torch.from_numpy(nxt), position_ids=torch.from_numpy(step_pos).long(),
                     cache=cache, cache_index=p, kv_pad_mask=torch.from_numpy(kv_pad))
        plain = model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=0, atol=2e-5)
    # the cached prefill is the uncached forward on every real (unpadded)
    # query (tests/test_llama.py:99); a pad query attends to no key in both
    real = mask.astype(bool)
    np.testing.assert_allclose(got0.numpy()[real], plain.numpy()[real], rtol=0, atol=1e-5)


def test_llama_greedy_generate_matches_jax(pair):
    from vidchapters_tpu.models.llama import llama_greedy_generate as jgenerate
    from vidchapters_tpu_torch.models.llama import llama_greedy_generate

    jmodel, params, model = pair
    ids, mask = _prompts(np.random.default_rng(2))
    ref = np.asarray(jgenerate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), 7))
    got = llama_greedy_generate(model, torch.from_numpy(ids), torch.from_numpy(mask), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    one = llama_greedy_generate(model, torch.from_numpy(ids), torch.from_numpy(mask), 1)
    np.testing.assert_array_equal(one.numpy(), ref[:, :1])


class _WordTokenizer:
    """A toy word-level tokenizer with HF's encode / decode signatures."""

    def __init__(self):
        self.words = [f"w{i}" for i in range(VOCAB)]

    def encode(self, text, add_special_tokens=False):
        assert not add_special_tokens
        return [3 + sum(map(ord, w)) % (VOCAB - 3) for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        assert skip_special_tokens
        return " ".join(self.words[i] for i in ids if i > 2)


def test_make_llama_generate_fn_matches_jax(pair):
    """Left padding with <s> to max_length, truncation, greedy tokens and
    decoding up to the first EOS, against JAX's generate over the same ids."""
    from vidchapters_tpu.models.llama import llama_greedy_generate as jgenerate
    from vidchapters_tpu_torch.models.llama import make_llama_generate_fn

    jmodel, params, model = pair
    tok = _WordTokenizer()
    for prompt, max_length in (("summarize the following speech transcript", 16),
                               (" ".join(f"word{i}" for i in range(30)), 16)):
        ids = ([1] + tok.encode(prompt))[:max_length]
        pad = max_length - len(ids)
        j_ids = np.array([[1] * pad + ids], np.int32)
        j_mask = np.array([[0] * pad + [1] * len(ids)], np.int32)
        ref = np.asarray(jgenerate(jmodel, params, jnp.asarray(j_ids), jnp.asarray(j_mask),
                                   6))[0].tolist()
        if 2 in ref:
            ref = ref[:ref.index(2)]
        fn = make_llama_generate_fn(model, tok, max_new_tokens=6, max_length=max_length)
        assert fn(prompt) == tok.decode(ref)


def _hf_state_dict(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.normal(size=(cfg.vocab_size, d)),
          "model.norm.weight": rng.normal(size=(d,)),
          "lm_head.weight": rng.normal(size=(cfg.vocab_size, d))}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        shapes = {"input_layernorm.weight": (d,), "post_attention_layernorm.weight": (d,),
                  "self_attn.q_proj.weight": (cfg.num_heads * hd, d),
                  "self_attn.k_proj.weight": (cfg.num_kv_heads * hd, d),
                  "self_attn.v_proj.weight": (cfg.num_kv_heads * hd, d),
                  "self_attn.o_proj.weight": (d, cfg.num_heads * hd),
                  "mlp.gate_proj.weight": (f, d), "mlp.up_proj.weight": (f, d),
                  "mlp.down_proj.weight": (d, f)}
        sd.update({lp + k: rng.normal(size=s) for k, s in shapes.items()})
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def test_llama_hf_importer_matches_jax_converter():
    from vidchapters_tpu.models.llama import convert_hf_llama
    from vidchapters_tpu_torch.models.llama import LlamaForCausalLM, rope_inv_freq
    from vidchapters_tpu_torch.models.weights import (llama_from_hf_state_dict,
                                                       llama_from_jax_params)

    _, cfg = _cfgs()
    model = LlamaForCausalLM(cfg)
    sd = _hf_state_dict(cfg)
    ref = llama_from_jax_params(convert_hf_llama({k: v.numpy() for k, v in sd.items()}), model)
    # an older checkpoint's rotary buffers pass when they equal the model's
    inv = torch.from_numpy(rope_inv_freq(cfg.head_dim, cfg.rope_theta))
    sd_rotary = {**sd, **{f"model.layers.{i}.self_attn.rotary_emb.inv_freq": inv
                          for i in range(cfg.num_layers)}}
    for variant in (sd, sd_rotary, {"model." + k: v for k, v in sd.items()}):
        got = llama_from_hf_state_dict(variant, model)
        assert set(got) == set(ref) == set(model.state_dict())
        for name in ref:
            assert torch.equal(got[name], ref[name]), name
    with pytest.raises(ValueError, match="model.layers.0.self_attn.rotary_emb.inv_freq"):
        llama_from_hf_state_dict({**sd, "model.layers.0.self_attn.rotary_emb.inv_freq": inv * 2},
                                 model)
    with pytest.raises(ValueError, match="model.extra.weight"):
        llama_from_hf_state_dict({**sd, "model.extra.weight": inv}, model)


def test_llama_bf16_storage_same_logits(pair):
    """Every weight is rounded to bfloat16 before use, so bfloat16 storage
    gives the bfloat16 model's logits and tokens exactly."""
    from vidchapters_tpu_torch.models.llama import LlamaForCausalLM, llama_greedy_generate

    _, _, model32 = pair
    _, cfg = _cfgs("bfloat16")
    full = LlamaForCausalLM(cfg)
    full.load_state_dict(model32.state_dict())
    half = LlamaForCausalLM(cfg)
    half.load_state_dict(model32.state_dict())
    half.to(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
    ids, mask = _prompts(np.random.default_rng(3))
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        a, b = full(ids, attn_mask=mask), half(ids, attn_mask=mask)
    assert torch.equal(a, b)
    assert torch.equal(llama_greedy_generate(full, ids, mask, 5),
                       llama_greedy_generate(half, ids, mask, 5))


def test_init_llama_seeded_in_compute_dtype():
    from vidchapters_tpu_torch.models.llama import init_llama

    _, cfg = _cfgs("bfloat16")
    a, b = init_llama(cfg, "cpu", seed=5), init_llama(cfg, "cpu", seed=5)
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu" for p in a.parameters())
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert torch.equal(a.layers[0].input_norm, torch.ones(cfg.hidden_size, dtype=torch.bfloat16))
    with torch.no_grad():
        assert torch.isfinite(a(torch.ones((1, 4), dtype=torch.int32))).all()


def test_build_llama_titler_raises_before_reading(tmp_path):
    """The loader (once a raise of its own) raises on a directory without a
    ``tokenizer.model`` before it reads any weight, and makes nothing; its
    reads are held in tests/test_torch_tokenizers.py."""
    from vidchapters_tpu_torch.models.llama import build_llama_titler

    missing = tmp_path / "no_such_dir"
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        build_llama_titler(str(missing), device="cpu")
    assert not missing.exists()
