"""The port's generate (encode, then greedy or beam-4 decode through the
decode kernel's plain version) gives the JAX package's ``make_generate_fn``
tokens exactly, on the CPU in fp32 at max_length 24."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_helpers import batch, jax_params, port_model, small_cfgs

MAX_LEN = 24


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg, seed=3)
    return jmodel, params, port_model(tcfg, params)


@pytest.mark.parametrize("num_beams,penalty", [(1, 1.0), (4, 1.0), (1, 3.0), (4, 3.0)])
def test_generate_tokens_identical_to_jax(models, num_beams, penalty):
    from vidchapters_tpu.config import GenerationConfig as JGen
    from vidchapters_tpu.train.dvc_train import make_generate_fn as jax_generate_fn
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    jmodel, params, model = models
    video, tokens, _ = batch(np.random.default_rng(num_beams), b=3)
    ref = np.asarray(jax_generate_fn(jmodel, JGen(
        num_beams=num_beams, max_length=MAX_LEN, repetition_penalty=penalty))(
        params, jnp.asarray(video), jnp.asarray(tokens), jax.random.PRNGKey(0)))
    got = make_generate_fn(model, GenerationConfig(
        num_beams=num_beams, max_length=MAX_LEN, repetition_penalty=penalty))(
        torch.from_numpy(video), torch.from_numpy(tokens))
    assert got.dtype == torch.int32 and got.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), ref)
    if penalty != 1.0:  # the penalty breaks the random model's repeats
        assert len(np.unique(ref)) > 8


def test_nucleus_sampling_is_not_ported(models):
    """Nucleus sampling (``num_beams == 0``), once refused, now generates
    through the standard cached decode: int32 tokens of the full length from
    a seeded generator, the same for the same seed (the test keeps its
    name; tests/test_torch_standard_decode.py holds the sampler to JAX)."""
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    video, tokens, _ = batch(np.random.default_rng(0), b=2)
    generate = make_generate_fn(models[2], GenerationConfig(num_beams=0, max_length=MAX_LEN))
    draws = [generate(torch.from_numpy(video), torch.from_numpy(tokens),
                      torch.Generator().manual_seed(7)) for _ in range(2)]
    assert draws[0].dtype == torch.int32 and draws[0].shape == (2, MAX_LEN)
    assert torch.equal(draws[0], draws[1])
