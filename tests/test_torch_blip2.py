"""The port's BLIP-2 (``models/blip2.py``) against the JAX package's, on the
CPU in fp32 at a small width (ViT 2 x 32, Q-Former 2 x 32, T5 2 + 2 x 32):

- the vision tower, the Q-Former, ``encode`` and the logits within 1e-5 of
  the largest element;
- ``blip2_generate`` tokens identical to JAX's, greedy and at
  ``num_beams=2``;
- ``preprocess_frames`` exact;
- ``blip2_from_hf_state_dict`` equal, tensor for tensor, to
  ``blip2_from_jax_params(convert_hf_blip2(sd))``;
- ``build_blip2_captioner`` on a synthetic HF directory (one ``.bin`` and
  three shards) gives JAX's captions: ``blip2_generate`` over
  ``convert_hf_blip2`` of the same weights, with the JAX package's
  tokenizer over the same ``spiece.model``;
- weights stored in their compute dtype (bfloat16) give the same numbers.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from tests._torch_helpers import (blip2_hf_config, blip2_hf_state_dict, blip2_small_cfgs,
                                 write_blip2_dir)

VOCAB = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int = 0, b: int = 2, p: int = 7):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(3, VOCAB, (b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    mask[1, p - 2:] = 0
    ids[1, p - 2:] = 0
    return px, ids, mask


@pytest.fixture(scope="module")
def pair():
    from vidchapters_tpu.models.blip2 import Blip2 as JBlip2
    from vidchapters_tpu_torch.models.blip2 import Blip2
    from vidchapters_tpu_torch.models.weights import blip2_from_jax_params

    jcfg, tcfg = blip2_small_cfgs()
    jmodel = JBlip2(jcfg)
    px, ids, mask = _inputs()
    init = jax.jit(lambda k: jmodel.init(k, px, ids, mask, ids[:, :3])["params"])
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    model = Blip2(tcfg)
    model.load_state_dict(blip2_from_jax_params(params, model))
    return jmodel, params, model.eval()


def _close(got: torch.Tensor, ref, tol: float = 1e-5):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max abs err {err:.3e} of the largest element"


@pytest.mark.parametrize("part", ["vision", "qformer", "encode", "logits"])
def test_blip2_parts_match_jax(pair, part):
    from vidchapters_tpu.models.blip2 import Blip2VisionModel as JVision
    from vidchapters_tpu.models.blip2 import QFormer as JQFormer

    jmodel, params, model = pair
    px, ids, mask = _inputs(1)
    tp, tids, tmask = (torch.from_numpy(x) for x in (px, ids, mask))
    with torch.no_grad():
        if part == "vision":
            ref = JVision(jmodel.cfg.vision).apply({"params": params["vision"]}, px)
            _close(model.vision(tp), ref)
        elif part == "qformer":
            enc = np.random.default_rng(2).normal(size=(2, 5, 32)).astype(np.float32)
            queries = np.broadcast_to(params["query_tokens"], (2, 4, 32))
            ref = JQFormer(jmodel.cfg.qformer).apply({"params": params["qformer"]}, queries, enc)
            _close(model.qformer(torch.from_numpy(np.ascontiguousarray(queries)),
                                 torch.from_numpy(enc)), ref)
        elif part == "encode":
            ref, ref_mask = jmodel.apply({"params": params}, px, ids, mask, method=jmodel.encode)
            got, got_mask = model.encode(tp, tids, tmask)
            _close(got, ref)
            np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
        else:
            dec = np.random.default_rng(3).integers(3, VOCAB, (2, 5)).astype(np.int32)
            ref = jmodel.apply({"params": params}, px, ids, mask, dec)
            _close(model(tp, tids, tmask, torch.from_numpy(dec)), ref)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_blip2_generate_matches_jax(pair, num_beams):
    """Greedy against JAX's ``blip2_generate``. At ``num_beams > 1`` JAX's
    ``blip2_generate`` unpacks ``beam_search``'s [B, T] array as a pair
    (vidchapters_tpu/models/blip2.py:265), which keeps example 0 only and
    raises unless B == 2; the port returns every example, held against
    JAX's ``beam_search`` over JAX's encoding, and example 0 against JAX's
    ``blip2_generate``."""
    from vidchapters_tpu.models.blip2 import blip2_generate as jgenerate
    from vidchapters_tpu.models.t5 import T5ForConditionalGeneration as JT5
    from vidchapters_tpu.ops import decoding as jdec
    from vidchapters_tpu_torch.models.blip2 import blip2_generate

    jmodel, params, model = pair
    px, ids, mask = _inputs(4)
    got = blip2_generate(model, *(torch.from_numpy(x) for x in (px, ids, mask)),
                         max_new_tokens=8, num_beams=num_beams)
    assert got.shape == (2, 8)
    ref = np.asarray(jgenerate(jmodel, params, jnp.asarray(px), jnp.asarray(ids),
                               jnp.asarray(mask), max_new_tokens=8, num_beams=num_beams))
    if num_beams == 1:
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    np.testing.assert_array_equal(got.numpy()[0], ref)
    enc, enc_mask = jmodel.apply({"params": params}, px, ids, mask, method=jmodel.encode)
    fns = jdec.make_decode_fns(JT5(jmodel.cfg.t5), params["t5"], 8)
    full = np.asarray(jdec.beam_search(fns, enc, enc_mask, 8, num_beams=num_beams))
    np.testing.assert_array_equal(got.numpy(), full)


def test_preprocess_frames_exact():
    from vidchapters_tpu.models.blip2 import preprocess_frames as jpre
    from vidchapters_tpu_torch.models.blip2 import preprocess_frames

    frames = np.random.default_rng(5).integers(0, 256, (3, 224, 224, 3)).astype(np.uint8)
    got = preprocess_frames(frames)
    assert got.shape == (3, 3, 224, 224) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jpre(frames))


def test_blip2_hf_importer_matches_jax_converter():
    from vidchapters_tpu.models.blip2 import convert_hf_blip2
    from vidchapters_tpu_torch.models.blip2 import Blip2
    from vidchapters_tpu_torch.models.weights import (blip2_from_hf_state_dict,
                                                       blip2_from_jax_params)

    _, cfg = blip2_small_cfgs()
    model = Blip2(cfg)
    sd = blip2_hf_state_dict(cfg, seed=6)
    ref = blip2_from_jax_params(convert_hf_blip2({k: v.numpy() for k, v in sd.items()}), model)
    got = blip2_from_hf_state_dict(sd, model)
    assert set(got) == set(ref) == set(model.state_dict())
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    with pytest.raises(ValueError, match="qformer.encoder.layer.0.intermediate.dense.weight"):
        blip2_from_hf_state_dict({**sd, "qformer.encoder.layer.0.intermediate.dense.weight":
                                  torch.zeros(48, 32)}, model)
    untied = dict(sd)
    untied["language_model.encoder.embed_tokens.weight"] = sd["language_model.shared.weight"] + 1
    with pytest.raises(ValueError, match="language_model.encoder.embed_tokens.weight"):
        blip2_from_hf_state_dict(untied, model)


@pytest.mark.parametrize("shards", [1, 3])
def test_build_blip2_captioner_matches_jax(tmp_path, shards):
    """The directory loader (config.json, the .bin or its shards, spiece.model)
    against JAX's blip2_generate over convert_hf_blip2 of the same weights,
    with the JAX package's SentencePiece tokenizer (``</s>`` appended)."""
    from vidchapters_tpu.data.tokenizer import SentencePieceUnigramTokenizer as JTok
    from vidchapters_tpu.models.blip2 import Blip2 as JBlip2
    from vidchapters_tpu.models.blip2 import blip2_generate as jgenerate
    from vidchapters_tpu.models.blip2 import convert_hf_blip2, preprocess_frames
    from vidchapters_tpu_torch.models.blip2 import build_blip2_captioner
    from vidchapters_tpu_torch.zeroshot.visual_vcg import BLIP2_PROMPT

    jcfg, tcfg = blip2_small_cfgs(vocab=32128)
    root = write_blip2_dir(tmp_path / "blip2", tcfg, seed=7, shards=shards)
    assert len(list(root.glob("pytorch_model*.bin"))) == shards
    caption_fn = build_blip2_captioner(str(root), max_new_tokens=8, device="cpu",
                                       dtype="float32")
    frames = np.random.default_rng(8).integers(0, 256, (3, 28, 28, 3)).astype(np.uint8)
    got = caption_fn(frames, BLIP2_PROMPT)

    tok = JTok(str(root / "spiece.model"), num_bins=0)
    ids = np.array([tok.encode(BLIP2_PROMPT, add_special_tokens=True)] * 3, np.int32)
    assert ids[0, -1] == 1                                          # </s> appended
    sd = blip2_hf_state_dict(tcfg, seed=7)
    params = convert_hf_blip2({k: v.numpy() for k, v in sd.items()})
    toks = jgenerate(JBlip2(jcfg), params, jnp.asarray(preprocess_frames(frames)),
                     jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids)), max_new_tokens=8)
    assert got == tok.batch_decode(np.asarray(toks), skip_special_tokens=True)


def test_build_blip2_captioner_reads_no_safetensors(tmp_path):
    """Safetensors are read now (``utils/hf.py``): an empty
    ``model.safetensors`` raises naming the file, a directory of no weights
    raises naming both formats, and the loader's state dict from a
    safetensors file equals that of the ``.bin`` of the same weights."""
    from tests._torch_helpers import blip2_hf_state_dict, write_safetensors
    from vidchapters_tpu_torch.models.blip2 import build_blip2_captioner, load_hf_state_dict

    _, cfg = blip2_small_cfgs()
    (tmp_path / "config.json").write_text(json.dumps(blip2_hf_config(cfg)))
    chip_smoke._write_spm_model(tmp_path / "spiece.model")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin.*model.safetensors"):
        build_blip2_captioner(str(tmp_path), device="cpu")
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="model.safetensors: 0 bytes"):
        build_blip2_captioner(str(tmp_path), device="cpu")
    sd = blip2_hf_state_dict(cfg, seed=3)
    write_safetensors(tmp_path / "model.safetensors", sd)
    got = load_hf_state_dict(str(tmp_path))
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    assert build_blip2_captioner(str(tmp_path), device="cpu")


def test_blip2_bf16_storage_same_numbers(pair):
    """Each weight that ``store_in_compute_dtype`` casts is rounded to the
    compute dtype before use: the same encoding and tokens, the norms and
    T5's relative-position table still fp32."""
    from vidchapters_tpu_torch.models.blip2 import Blip2, blip2_generate

    _, _, model32 = pair
    _, cfg = blip2_small_cfgs(dtype="bfloat16")
    full, half = Blip2(cfg), Blip2(cfg)
    full.load_state_dict(model32.state_dict())
    half.load_state_dict(model32.state_dict())
    half.store_in_compute_dtype()
    assert half.vision.layers[0].qkv.weight.dtype == torch.bfloat16
    assert half.t5.shared.weight.dtype == half.t5.lm_head.weight.dtype == torch.bfloat16
    assert half.vision.layers[0].norm1.weight.dtype == torch.float32
    assert half.t5.encoder.rel_bias.rel_embedding.dtype == torch.float32
    assert half.t5.encoder.final_norm.weight.dtype == torch.float32
    inputs = [torch.from_numpy(x) for x in _inputs(9)]
    with torch.no_grad():
        (a, _), (b, _) = full.encode(*inputs), half.encode(*inputs)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for beams in (1, 2):
        assert torch.equal(blip2_generate(full, *inputs, max_new_tokens=6, num_beams=beams),
                           blip2_generate(half, *inputs, max_new_tokens=6, num_beams=beams))


def test_init_blip2_seeded_in_compute_dtypes():
    from vidchapters_tpu_torch.models.blip2 import blip2_generate, init_blip2

    _, cfg = blip2_small_cfgs(dtype="bfloat16")
    a, b = init_blip2(cfg, "cpu", seed=3), init_blip2(cfg, "cpu", seed=3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert a.vision.layers[1].fc1.weight.dtype == torch.bfloat16
    assert torch.equal(a.qformer.embed_norm.weight, torch.ones(32))
    assert torch.equal(a.t5.decoder.final_norm.weight, torch.ones(32))
    toks = blip2_generate(a, *(torch.from_numpy(x) for x in _inputs(10)), max_new_tokens=4)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
