"""The port's import of the reference's Vid2Seq checkpoints
(``models/torch_import.py``) against the JAX package's, on the CPU in fp32.

A state dict under the reference's names (HF T5 under ``t5_model.``, the
reference ViT under ``visual_encoder.``) at T5 2+2 layers, d 64, ViT depth
2, is made from a seed with numpy, in four forms: ReLU and gated FFNs, tied
and untied ``lm_head``, with and without ``proj_v2t`` and the ViT's qkv
bias. The JAX package's ``convert_vid2seq_state_dict`` and Vid2Seq give the
reference logits; the port's import and Vid2Seq must give them within
``TOL`` (as ``tests/test_torch_model.py``), and the two routes must give
the port the same state dict bit for bit. Names that the port cannot place,
or that it misses, raise and are named; a ``.pth`` holding ``module.``
prefixes and an ``args`` Namespace loads under ``weights_only``; and
``dvc_main --load`` and ``serve.load_serving_params`` take such a file.
"""

import argparse
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

TOL = 1e-4
VOCAB, D, HEADS, DKV, DFF, LAYERS, BUCKETS = 512, 64, 4, 16, 128, 2, 32
VIT_FEATS, VIT_DEPTH, VIT_HEADS, VIT_MLP = 16, 2, 4, 96


def reference_state_dict(rng, *, gated=False, untied=False, vit_d=D, qkv_bias=True,
                         vocab=VOCAB, d=D, heads=HEADS, dkv=DKV, dff=DFF, layers=LAYERS,
                         buckets=BUCKETS, vit_feats=VIT_FEATS, vit_depth=VIT_DEPTH,
                         vit_mlp=VIT_MLP):
    """Seeded random weights under the reference Vid2Seq's names, with the
    HF tied copies of the embedding; ``proj_v2t`` when ``vit_d != d``."""
    sd = {}
    inner = heads * dkv

    def w(key, *shape):
        sd[key] = rng.normal(scale=0.1, size=shape).astype(np.float32)

    w("t5_model.shared.weight", vocab, d)
    for copy in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        sd["t5_model." + copy] = sd["t5_model.shared.weight"]
    if untied:
        w("t5_model.lm_head.weight", vocab, d)
    else:
        sd["t5_model.lm_head.weight"] = sd["t5_model.shared.weight"]
    for stack in ("encoder", "decoder"):
        w(f"t5_model.{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
          buckets, heads)
        for i in range(layers):
            b = f"t5_model.{stack}.block.{i}"
            for x in ("q", "k", "v"):
                w(f"{b}.layer.0.SelfAttention.{x}.weight", inner, d)
            w(f"{b}.layer.0.SelfAttention.o.weight", d, inner)
            sd[f"{b}.layer.0.layer_norm.weight"] = 1.0 + 0.1 * rng.normal(size=d).astype(
                np.float32)
            ff = 1
            if stack == "decoder":
                for x in ("q", "k", "v"):
                    w(f"{b}.layer.1.EncDecAttention.{x}.weight", inner, d)
                w(f"{b}.layer.1.EncDecAttention.o.weight", d, inner)
                w(f"{b}.layer.1.layer_norm.weight", d)
                ff = 2
            for wi in (("wi_0", "wi_1") if gated else ("wi",)):
                w(f"{b}.layer.{ff}.DenseReluDense.{wi}.weight", dff, d)
            w(f"{b}.layer.{ff}.DenseReluDense.wo.weight", d, dff)
            w(f"{b}.layer.{ff}.layer_norm.weight", d)
        w(f"t5_model.{stack}.final_layer_norm.weight", d)
    w("visual_encoder.pos_embed", 1, vit_feats, vit_d)
    for i in range(vit_depth):
        b = f"visual_encoder.blocks.{i}"
        w(f"{b}.norm1.weight", vit_d)
        w(f"{b}.norm1.bias", vit_d)
        w(f"{b}.attn.qkv.weight", 3 * vit_d, vit_d)
        if qkv_bias:
            w(f"{b}.attn.qkv.bias", 3 * vit_d)
        w(f"{b}.attn.proj.weight", vit_d, vit_d)
        w(f"{b}.attn.proj.bias", vit_d)
        w(f"{b}.norm2.weight", vit_d)
        w(f"{b}.norm2.bias", vit_d)
        w(f"{b}.mlp.fc1.weight", vit_mlp, vit_d)
        w(f"{b}.mlp.fc1.bias", vit_mlp)
        w(f"{b}.mlp.fc2.weight", vit_d, vit_mlp)
        w(f"{b}.mlp.fc2.bias", vit_d)
    w("visual_encoder.norm.weight", vit_d)
    w("visual_encoder.norm.bias", vit_d)
    if vit_d != d:
        w("proj_v2t.weight", d, vit_d)
        w("proj_v2t.bias", d)
    return sd


def cfgs(gated: bool, untied: bool, vit_d: int, qkv_bias: bool):
    """(JAX Vid2SeqConfig, port Vid2SeqConfig) of a form, fp32, no dropout."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    def make(m):
        t5 = m.T5Config(vocab_size=VOCAB, d_model=D, d_kv=DKV, d_ff=DFF, num_layers=LAYERS,
                        num_decoder_layers=LAYERS, num_heads=HEADS,
                        relative_attention_num_buckets=BUCKETS, dropout_rate=0.0,
                        encoder_dropout=0.0, decoder_dropout=0.0, dtype="float32",
                        feed_forward_proj="gated-gelu" if gated else "relu",
                        tie_word_embeddings=not untied)
        vit = m.TemporalViTConfig(num_features=VIT_FEATS, embed_dim=vit_d, depth=VIT_DEPTH,
                                  num_heads=VIT_HEADS, mlp_dim=VIT_MLP, qkv_bias=qkv_bias,
                                  dtype="float32")
        return m.Vid2SeqConfig(t5=t5, vit=vit, num_bins=100)

    return make(jc), make(tc)


# (gated, untied lm_head, ViT width, qkv bias): proj_v2t exists where the
# ViT's width is not T5's
FORMS = {"relu-tied-noproj-bias": (False, False, D, True),
         "relu-untied-proj-nobias": (False, True, 48, False),
         "gated-tied-proj-nobias": (True, False, 48, False),
         "gated-untied-noproj-bias": (True, True, D, True)}


def _inputs(seed: int, t: int, d: int):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(2, t, d)).astype(np.float32)
    tokens = rng.integers(3, VOCAB, size=(2, 12)).astype(np.int32)
    tokens[1, 8:] = 0
    labels = rng.integers(3, VOCAB, size=(2, 10)).astype(np.int32)
    dec_in = np.concatenate([np.zeros((2, 1), np.int32), labels[:, :-1]], axis=1)
    return video, tokens, (tokens != 0).astype(np.int32), dec_in


@pytest.mark.parametrize("form", list(FORMS))
def test_import_matches_jax_logits_and_state_dict(form):
    from vidchapters_tpu.models.torch_import import convert_vid2seq_state_dict as jax_convert
    from vidchapters_tpu.models.vid2seq import Vid2Seq as JaxVid2Seq
    from vidchapters_tpu_torch.models.torch_import import vid2seq_from_reference
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params

    gated, untied, vit_d, qkv_bias = FORMS[form]
    sd = reference_state_dict(np.random.default_rng(7), gated=gated, untied=untied,
                              vit_d=vit_d, qkv_bias=qkv_bias)
    jcfg, tcfg = cfgs(gated, untied, vit_d, qkv_bias)
    jparams = jax_convert(sd, gated=gated)
    model = Vid2Seq(tcfg)
    got_sd = vid2seq_from_reference(sd, model)
    via_jax = from_jax_params(jparams, model)
    assert set(got_sd) == set(via_jax) == set(model.state_dict())
    for name, t in via_jax.items():
        assert torch.equal(got_sd[name], t), name
    assert hasattr(model, "proj_v2t") == (vit_d != D)
    assert hasattr(model.t5, "lm_head") == untied
    model.load_state_dict(got_sd)
    model.eval()

    video, tokens, mask, dec_in = _inputs(3, VIT_FEATS, vit_d)

    def jax_logits(m, v, t, a, di):
        enc, emask = m.encode_for_generation(v, t, a)
        return m.t5.decode(di, jnp.ones_like(di), enc, emask)

    ref = JaxVid2Seq(jcfg).apply({"params": jparams}, *map(jnp.asarray, (video, tokens, mask,
                                                                         dec_in)),
                                 method=jax_logits)
    with torch.no_grad():
        v, t, a, di = map(torch.from_numpy, (video, tokens, mask, dec_in))
        enc, emask = model.encode_for_generation(v, t, a)
        got = model.t5.decode(di.long(), torch.ones_like(di), enc, emask)
    assert got.shape == (2, 10, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def _model(untied=True):
    """The port's Vid2Seq of a ReLU form with proj_v2t and no qkv bias."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    return Vid2Seq(cfgs(False, untied, 48, False)[1])


def test_unknown_and_missing_names_raise_naming_them():
    from vidchapters_tpu_torch.models.torch_import import vid2seq_from_reference

    base = reference_state_dict(np.random.default_rng(1), untied=True, vit_d=48,
                                qkv_bias=False)
    extra = dict(base)
    extra["t5_model.encoder.block.0.layer.0.SelfAttention.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="SelfAttention.extra.weight"):
        vid2seq_from_reference(extra, _model())
    missing = {k: v for k, v in base.items() if k != "visual_encoder.norm.bias"}
    with pytest.raises(KeyError, match="visual_encoder.norm.bias"):
        vid2seq_from_reference(missing, _model())
    # a tied copy of the embedding that differs from it has no place
    odd = dict(base)
    odd["t5_model.decoder.embed_tokens.weight"] = base["t5_model.shared.weight"] + 1.0
    with pytest.raises(ValueError, match="decoder.embed_tokens.weight"):
        vid2seq_from_reference(odd, _model())
    # an untied lm_head into a tied model, a missing proj_v2t, a qkv bias
    # the model lacks: each is named by the port's placement
    with pytest.raises(ValueError, match="lm_head"):
        vid2seq_from_reference(base, _model(untied=False))
    no_proj = {k: v for k, v in base.items() if not k.startswith("proj_v2t")}
    with pytest.raises(ValueError, match="proj_v2t"):
        vid2seq_from_reference(no_proj, _model())
    biased = reference_state_dict(np.random.default_rng(1), untied=True, vit_d=48)
    with pytest.raises(ValueError, match="qkv/bias"):
        vid2seq_from_reference(biased, _model())


def test_vocab_rows_other_than_the_models_raise_with_both_shapes():
    from vidchapters_tpu_torch.models.torch_import import vid2seq_from_reference

    sd = reference_state_dict(np.random.default_rng(2), vocab=VOCAB - 100, untied=True,
                              vit_d=48, qkv_bias=False)
    with pytest.raises(ValueError, match=rf"\({VOCAB - 100}, {D}\).*\({VOCAB}, {D}\)"):
        vid2seq_from_reference(sd, _model())


class _NotAllowed:
    """A class that a checkpoint must not make ``torch.load`` build."""


def _save_reference_pth(path, sd, epoch=4):
    torch.save({"model": {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "optimizer": {"state": {0: {"exp_avg": torch.zeros(2)}}, "param_groups": []},
                "epoch": epoch,
                "args": argparse.Namespace(num_bins=100, lr=3e-4, combine_datasets=["chapters"],
                                           load=None)}, path)


def test_pth_with_module_prefixes_and_args_loads_weights_only(tmp_path):
    from vidchapters_tpu_torch.models.torch_import import load_payload, load_torch_checkpoint

    sd = reference_state_dict(np.random.default_rng(3), untied=True, vit_d=48, qkv_bias=False)
    path = tmp_path / "vid2seq.pth"
    _save_reference_pth(path, sd)
    loaded = load_torch_checkpoint(str(path))
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k], v)
    assert load_payload(str(path))["args"].num_bins == 100
    evil = tmp_path / "evil.pth"
    torch.save({"model": {}, "hook": _NotAllowed()}, evil)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        load_payload(str(evil))


def _tiny_reference(cfg, seed=5):
    """A reference state dict at the width of ``test_torch_dvc_main``'s tiny
    config (T5 d 32, 1+1 layers, ViT 8 wide: proj_v2t)."""
    t5, vit = cfg.model.t5, cfg.model.vit
    return reference_state_dict(
        np.random.default_rng(seed), vocab=t5.vocab_size, d=t5.d_model, heads=t5.num_heads,
        dkv=t5.d_kv, dff=t5.d_ff, layers=t5.num_layers,
        buckets=t5.relative_attention_num_buckets, vit_d=vit.embed_dim,
        vit_feats=vit.num_features, vit_depth=vit.depth, vit_mlp=vit.mlp_dim)


def test_dvc_main_load_and_serve_ckpt_take_a_reference_pth(tmp_path, capsys):
    from tests.test_torch_dvc_main import _tiny_cfg, _write_dataset
    from vidchapters_tpu_torch.data.dvc_dataset import DenseVideoCaptioningDataset, EpochIterator
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.serve import load_serving_params
    from vidchapters_tpu_torch.train.dvc_main import main
    from vidchapters_tpu_torch.train.dvc_train import TrainState, evaluate
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    _write_dataset(tmp_path)
    cfg = _tiny_cfg(tmp_path, num_beams=1)
    sd = _tiny_reference(cfg)
    pth = tmp_path / "vid2seq.pth"
    _save_reference_pth(pth, sd)

    served = load_serving_params(Vid2Seq(cfg.model), str(pth))
    state = served.state_dict()
    np.testing.assert_array_equal(state["t5.shared.weight"].numpy(),
                                  sd["t5_model.shared.weight"])
    np.testing.assert_array_equal(state["t5.decoder.blocks.0.cross_attn.o.weight"].numpy(),
                                  sd["t5_model.decoder.block.0.layer.1.EncDecAttention.o.weight"])
    np.testing.assert_array_equal(state["proj_v2t.weight"].numpy(), sd["proj_v2t.weight"])
    assert "imported reference checkpoint" in capsys.readouterr().out

    # a `last` of an earlier run is not resumed from: the loaded weights are scored
    other = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(9))
    CheckpointManager(cfg.train.checkpoint.save_dir).save_last(
        TrainState(other, build_optimizer(cfg.train.optim, 10, other.parameters())), 0)
    capsys.readouterr()
    metrics = main(cfg, load=str(pth), eval_only=True, device="cpu")
    out = capsys.readouterr().out
    assert "imported reference checkpoint" in out and "resumed from" not in out
    paths = cfg.datasets["chapters"]
    tok = build_tokenizer("", num_bins=cfg.model.num_bins)
    ds = DenseVideoCaptioningDataset(paths.val_json_path, paths.features_path, tok, cfg.data,
                                     subtitles_path=paths.subtitles_path)
    it = EpochIterator(ds, cfg.train.eval_batch_size, cfg.data, shuffle=False, drop_last=False,
                       bucket_inputs=True)
    _, ref = evaluate(served, it, tok, cfg.generation, cfg.model.num_bins,
                      references=[paths.val_json_path])
    assert metrics == {f"chapters_{k}": v for k, v in ref.items()}
    assert all(np.isfinite(v) for v in metrics.values())
    assert json.loads((tmp_path / "ckpt" / "last.meta.json").read_text())["epoch"] == 0
