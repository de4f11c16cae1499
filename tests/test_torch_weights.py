"""``from_jax_params`` maps every leaf of a JAX Vid2Seq init onto the port's
parameters, and refuses a tree with a leaf it has no place for."""

import numpy as np
import pytest

from tests._torch_helpers import jax_params, small_cfgs


@pytest.fixture(scope="module")
def setup():
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    jcfg, tcfg = small_cfgs(feed_forward_proj="gated-gelu")
    _, params = jax_params(jcfg)
    return params, Vid2Seq(tcfg)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_every_leaf_maps(setup):
    from vidchapters_tpu_torch.models.weights import from_jax_params

    params, model = setup
    sd = from_jax_params(params, model)
    leaves = dict(_leaves(params))
    assert len(sd) == len(leaves) == len(model.state_dict())
    # spot values: an embedding, a transposed Dense kernel, a LayerNorm scale
    np.testing.assert_array_equal(sd["t5.shared.weight"].numpy(),
                                  leaves[("t5", "shared", "embedding")])
    np.testing.assert_array_equal(
        sd["t5.decoder.blocks.1.ff.wi_0.weight"].numpy(),
        leaves[("t5", "decoder", "block_1", "ff", "wi_0", "kernel")].T)
    np.testing.assert_array_equal(
        sd["visual_encoder.blocks.0.norm1.weight"].numpy(),
        leaves[("visual_encoder", "block_0", "norm1", "scale")])
    model.load_state_dict(sd)  # strict: every parameter filled


def test_leftover_leaf_raises(setup):
    from vidchapters_tpu_torch.models.weights import from_jax_params

    params, model = setup
    extra = dict(params)
    extra["t5"] = dict(params["t5"])
    extra["t5"]["lm_head"] = {"kernel": np.zeros((128, 32200), np.float32)}
    with pytest.raises(ValueError, match="lm_head"):
        from_jax_params(extra, model)


def test_missing_leaf_raises(setup):
    from vidchapters_tpu_torch.models.weights import from_jax_params

    params, model = setup
    short = dict(params)
    short["visual_encoder"] = {k: v for k, v in params["visual_encoder"].items()
                               if k != "norm"}
    with pytest.raises(ValueError, match="visual_encoder.norm"):
        from_jax_params(short, model)
