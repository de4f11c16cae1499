"""The port's GPT-2 (``models/gpt2.py``) against the JAX package's, on the
CPU in fp32 at a small width (3 layers, 4 heads, 32 wide, vocab 97), with
the JAX init carried across by ``from_jax_params``'s names:

- logits within 1e-5 of JAX's, from tokens after a prefix, from embeddings
  with a padding mask, and at a position offset;
- ``gpt2_caption_loss`` within 1e-5;
- ``gpt2_greedy_sample`` tokens identical;
- ``gpt2_from_hf_state_dict`` of a ``transformers`` ``GPT2LMHeadModel``
  equal, tensor for tensor, to ``convert_hf_gpt2`` of the same state dict,
  and the port's logits within 1e-5 of HF's; an unread name raises.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

KW = dict(vocab_size=97, n_positions=32, n_embd=32, n_layer=3, n_head=4)


@pytest.fixture(scope="module")
def pair():
    from vidchapters_tpu.models.gpt2 import GPT2 as JGPT2
    from vidchapters_tpu.models.gpt2 import GPT2Config as JConfig
    from vidchapters_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from vidchapters_tpu_torch.models.weights import from_jax_params

    jmodel = JGPT2(JConfig(**KW))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)))["params"])
    # wider embeddings than N(0, 0.02) and N(0, 0.01), so greedy tokens
    # vary by step
    rng = np.random.default_rng(1)
    for name in ("wte", "wpe"):
        params[name] = rng.normal(size=params[name].shape).astype(np.float32)
    model = GPT2(GPT2Config(**KW))
    model.load_state_dict(from_jax_params(params, model))
    return jmodel, params, model.eval()


def test_logits_match_jax(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 97, (2, 7)).astype(np.int32)
    prefix = rng.normal(size=(2, 2, 32)).astype(np.float32)
    embeds = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ref = [jmodel.apply({"params": params}, tokens=jnp.asarray(tokens),
                        prefix_embeds=jnp.asarray(prefix)),
           jmodel.apply({"params": params}, jnp.asarray(embeds), jnp.asarray(mask)),
           jmodel.apply({"params": params}, jnp.asarray(embeds), position_offset=5)]
    with torch.no_grad():
        got = [model(tokens=torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix)),
               model(torch.from_numpy(embeds), torch.from_numpy(mask)),
               model(torch.from_numpy(embeds), position_offset=5)]
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and g.shape == (2, 9, 97)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_caption_loss_matches_jax(pair):
    from vidchapters_tpu.models.gpt2 import gpt2_caption_loss as jax_loss
    from vidchapters_tpu_torch.models.gpt2 import gpt2_caption_loss

    jmodel, params, model = pair
    rng = np.random.default_rng(2)
    prefix = rng.normal(size=(3, 1, 32)).astype(np.float32)
    seq = rng.integers(1, 97, (3, 6)).astype(np.int32)
    seq[1, 3:] = 0
    ref = float(jax_loss(jmodel, params, jnp.asarray(prefix), jnp.asarray(seq)))
    with torch.no_grad():
        got = float(gpt2_caption_loss(model, torch.from_numpy(prefix), torch.from_numpy(seq)))
    assert abs(got - ref) <= 1e-5, (got, ref)


def test_greedy_tokens_match_jax(pair):
    from vidchapters_tpu.models.gpt2 import gpt2_greedy_sample as jax_sample
    from vidchapters_tpu_torch.models.gpt2 import gpt2_greedy_sample

    jmodel, params, model = pair
    prefix = np.random.default_rng(3).normal(size=(4, 2, 32)).astype(np.float32)
    eos = 50256  # never emitted; then a token that row 0 emits at step 2
    for _ in range(2):
        ref = np.asarray(jax_sample(jmodel, params, jnp.asarray(prefix), 8, eos_id=eos))
        got = gpt2_greedy_sample(model, torch.from_numpy(prefix), 8, eos_id=eos)
        np.testing.assert_array_equal(got.numpy(), ref)
        if eos == 50256:
            assert len(np.unique(ref)) >= 4 and (ref[:, 1:] != ref[:, :-1]).any()
            eos = int(ref[0, 2])
    assert (ref[0, 2:] == eos).all()


def test_hf_importer_matches_convert_hf_gpt2():
    transformers = pytest.importorskip("transformers")
    from vidchapters_tpu.models.gpt2 import convert_hf_gpt2
    from vidchapters_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from vidchapters_tpu_torch.models.weights import from_jax_params, gpt2_from_hf_state_dict

    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(vocab_size=97, n_positions=32, n_embd=32, n_layer=3,
                                     n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    with torch.no_grad():  # non-trivial biases and norms
        for name, p in hf.named_parameters():
            if name.endswith("bias") or ".ln_" in name:
                p.add_(0.1 * torch.randn_like(p))
    sd = hf.state_dict()
    model = GPT2(GPT2Config(**KW))
    got = gpt2_from_hf_state_dict(sd, model)
    ref = from_jax_params(convert_hf_gpt2({k: v.numpy() for k, v in sd.items()}), model)
    assert set(got) == set(ref) == set(model.state_dict())
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    model.load_state_dict(got)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (2, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(tokens=ids).numpy(), hf(ids).logits.numpy(),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="stray"):
        gpt2_from_hf_state_dict(dict(sd, stray=torch.zeros(2)), model)
