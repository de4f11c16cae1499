"""The port's Moment-DETR, CLIP text tower and BERT against the JAX
package's, on the CPU with seeded numpy inputs and the JAX package's
random init (imported through ``models/weights``):

- ``MomentDETR``'s forward, deterministic, every output within 1e-5 in fp32
  (with and without the speech stream, and the contrastive heads), and in
  bf16 within the bound of JAX's own bf16 test (atol 0.05, rtol 0.1);
- ``grounding_loss`` and every gradient with the exact (scipy) assignment,
  which JAX's gradient is taken under too; the auction's assignments equal
  the exact ones;
- ``postprocess_predictions``;
- the CLIP text tower and BERT on converted synthetic OpenAI, HF CLIP and
  HF BERT state dicts (within 1e-5 of the largest output), and the
  converters' and importers' raises on a name they cannot place or a
  missing one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops: the suite runs six
    workers on the machine's cores, where torch's thread pool spends these
    tests' time handing work between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    base = dict(hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=64,
                num_queries=5, v_feat_dim=16, t_feat_dim=12, s_feat_dim=8, dropout=0.0,
                input_dropout=0.0)
    base.update(kw)
    return jc.GroundingConfig(**base), tc.GroundingConfig(**base)


def _inputs(rng, b=2, lv=20, lt=7, ls=6, speech=False):
    vid_mask = np.ones((b, lv), np.int32)
    vid_mask[0, -5:] = 0
    txt_mask = np.ones((b, lt), np.int32)
    txt_mask[1, -2:] = 0
    out = [rng.normal(size=(b, lt, 12)).astype(np.float32), txt_mask,
           rng.normal(size=(b, lv, 16)).astype(np.float32), vid_mask]
    if speech:
        sp_mask = np.ones((b, ls), np.int32)
        sp_mask[0, -3:] = 0
        out += [rng.normal(size=(b, ls, 8)).astype(np.float32), sp_mask]
    return out


_INITS = {}


def _jax_setup(jcfg, inputs):
    """The JAX model, its init at ``inputs`` (jitted, cached by config)."""
    from vidchapters_tpu.models.grounding import MomentDETR as JModel

    jmodel = JModel(jcfg)
    key = (jcfg, len(inputs))
    if key not in _INITS:
        args = [jnp.asarray(x) for x in inputs]
        kw = {}
        if len(args) == 6:
            kw = dict(src_speech=args[4], src_speech_mask=args[5])
        _INITS[key] = jax.device_get(jax.jit(lambda k: jmodel.init(k, *args[:4], **kw))(
            jax.random.PRNGKey(0))["params"])
    return jmodel, _INITS[key]


def _port(tcfg, params):
    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.models.weights import grounding_from_jax_params

    model = MomentDETR(tcfg)
    model.load_state_dict(grounding_from_jax_params(params, model))
    return model


def _run_both(jcfg, tcfg, inputs, init_cfg=None):
    """Both packages' outputs at ``inputs`` from JAX's init of ``init_cfg``
    (``jcfg`` by default)."""
    from vidchapters_tpu.models.grounding import MomentDETR as JModel

    _, params = _jax_setup(init_cfg or jcfg, inputs)
    jmodel = JModel(jcfg)
    args = [jnp.asarray(x) for x in inputs]
    kw = dict(src_speech=args[4], src_speech_mask=args[5]) if len(args) == 6 else {}
    ref = jax.jit(lambda p: jmodel.apply({"params": p}, *args[:4], **kw))(params)
    t = [torch.from_numpy(x) for x in inputs]
    tkw = dict(src_speech=t[4], src_speech_mask=t[5]) if len(t) == 6 else {}
    return ref, _port(tcfg, params)(*t[:4], **tkw)


def _flat(out):
    items = {k: v for k, v in out.items() if k != "aux_outputs"}
    for i, aux in enumerate(out.get("aux_outputs", [])):
        items.update({f"aux{i}_{k}": v for k, v in aux.items()})
    return items


@pytest.mark.parametrize("variant", ["plain", "speech", "contrastive"])
def test_forward_matches_jax_fp32(variant):
    kw = {"speech": dict(use_speech=True), "contrastive": dict(contrastive_align_loss=True),
          "plain": {}}[variant]
    jcfg, tcfg = _cfgs(**kw)
    ref, got = _run_both(jcfg, tcfg, _inputs(np.random.default_rng(0),
                                              speech=variant == "speech"))
    ref, got = _flat(ref), _flat(got)
    assert set(got) == set(ref) and "aux0_pred_spans" in got
    for k, r in ref.items():
        g = got[k].detach()
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=k)


def test_forward_matches_jax_bf16():
    """bf16 products with the same fp32 parameters, against JAX's bf16 model
    within the bound JAX's own bf16 test holds bf16 to fp32 (tests/
    test_grounding.py::test_bfloat16_compute_dtype_close_and_trainable)."""
    jcfg32, _ = _cfgs()
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    ref, got = _run_both(jcfg, tcfg, _inputs(np.random.default_rng(0)), init_cfg=jcfg32)
    for k, r in _flat(ref).items():
        g = _flat(got)[k].detach()
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=0.05, rtol=0.1, err_msg=k)


def _targets():
    return {"spans": np.array([[[0.25, 0.5], [0.75, 0.3], [0.0, 0.0]],
                               [[0.5, 0.8], [0.0, 0.0], [0.0, 0.0]]], np.float32),
            "span_valid": np.array([[1, 1, 0], [1, 0, 0]], np.int32),
            "saliency_pos_labels": np.array([[2, 3], [1, 4]], np.int64),
            "saliency_neg_labels": np.array([[15, 16], [10, 11]], np.int64)}


@pytest.mark.parametrize("contrastive", [False, True])
def test_loss_and_gradients_match_jax(monkeypatch, contrastive):
    """The loss terms within rtol 1e-5 and every gradient within 1e-4 of its
    largest element, both packages under the exact assignment (JAX's is
    found eagerly, then fed to its traced loss); the port's auction gives
    the same assignments."""
    import vidchapters_tpu.models.grounding as jg
    from vidchapters_tpu_torch.models.grounding import grounding_loss, match_layers
    from vidchapters_tpu_torch.models.weights import grounding_from_jax_params

    jcfg, tcfg = _cfgs(contrastive_align_loss=contrastive)
    inputs = _inputs(np.random.default_rng(1))
    jmodel, params = _jax_setup(jcfg, inputs)
    args = [jnp.asarray(x) for x in inputs]
    tg = _targets()
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    out = jax.jit(lambda p: jmodel.apply({"params": p}, *args))(params)
    layers = [(out["pred_logits"], out["pred_spans"])] + [
        (a["pred_logits"], a["pred_spans"]) for a in out["aux_outputs"]]
    exact = [np.asarray(jg._match_batch(lg, sp, jt["spans"], jt["span_valid"].astype(bool),
                                        jcfg, exact=True)) for lg, sp in layers]
    calls = iter(exact + exact[:1])  # main layer, aux layers, then the contrastive term's

    monkeypatch.setattr(jg, "_match_batch", lambda *a, **k: jnp.asarray(next(calls)))

    def jloss(p):
        return jg.grounding_loss(jmodel.apply({"params": p}, *args), jt, jcfg)

    (ref_total, ref_losses), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    model = _port(tcfg, params)
    t = [torch.from_numpy(x) for x in inputs]
    tt = {k: torch.from_numpy(v) for k, v in tg.items()}
    pout = model(*t)
    total, losses = grounding_loss(pout, tt, tcfg, exact_match=True)
    total.backward()
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref = grounding_from_jax_params(jax.device_get(ref_grads), model)
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        g = np.zeros_like(r) if p.grad is None else p.grad.numpy()  # a head the loss skips
        if name.endswith("attn.k.bias"):
            # a bias on every key shifts each query's scores by one constant:
            # its gradient is 0, and both packages give fp32 rounding noise
            assert max(np.abs(g).max(), np.abs(r).max()) < 1e-6, name
            continue
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)
        assert err < 1e-4, f"{name}: gradient off by {err:.2e} of its largest element"

    layer_outs = [(pout["pred_logits"], pout["pred_spans"])] + [
        (a["pred_logits"], a["pred_spans"]) for a in pout["aux_outputs"]]
    for exact_flag in (True, False):
        got = match_layers(layer_outs, tt["spans"], tt["span_valid"], tcfg, exact=exact_flag)
        for g, e in zip(got, exact):
            np.testing.assert_array_equal(g.numpy(), e)


def test_match_layers_copies_to_the_host_once(monkeypatch):
    """Every layer's costs and the validity come to the host in one copy."""
    from vidchapters_tpu_torch.models.grounding import match_layers

    _, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    layers = [(torch.from_numpy(rng.normal(size=(3, 5, 2)).astype(np.float32)),
               torch.from_numpy(rng.uniform(0.1, 0.9, size=(3, 5, 2)).astype(np.float32)))
              for _ in range(4)]
    tg = torch.from_numpy(rng.uniform(0.1, 0.9, size=(3, 4, 2)).astype(np.float32))
    valid = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]])
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(
        self.shape) or real_cpu(self, *a, **k))
    out = match_layers(layers, tg, valid, tcfg)
    assert len(copies) == 1 and copies[0] == (4 * 3 * 5 * 4 + 3 * 4,)
    assert len(out) == 4 and out[0].shape == (3, 4)
    assert (out[0][2] == -1).all() and (out[0][1] >= 0).all()


def test_postprocess_predictions_matches_jax():
    from vidchapters_tpu.models.grounding import postprocess_predictions as jax_post
    from vidchapters_tpu_torch.models.grounding import postprocess_predictions

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 6, 2)).astype(np.float32)
    spans = rng.uniform(0, 1, size=(3, 6, 2)).astype(np.float32)
    spans[0, 0] = [0.99, 0.5]  # past the end: clipped
    dur = np.array([100.0, 37.5, 12.0], np.float32)
    for kw in ({}, dict(min_w_l=5.0, round_multiple=3)):
        ref = jax_post(jnp.asarray(logits), jnp.asarray(spans), jnp.asarray(dur), **kw)
        got = postprocess_predictions(torch.from_numpy(logits), torch.from_numpy(spans),
                                      torch.from_numpy(dur), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------


def openai_clip_text_sd(rng, width=32, layers=2, vocab=60, ctx=16, out=24):
    """A CLIP text tower's random weights under OpenAI's ``clip`` names, with
    two names of the rest of the model (``logit_scale``, ``visual.proj``)."""
    sd = {"token_embedding.weight": rng.normal(0, 0.5, (vocab, width)),
          "positional_embedding": rng.normal(0, 0.1, (ctx, width)),
          "text_projection": rng.normal(0, 0.2, (width, out)),
          "ln_final.weight": rng.uniform(0.5, 1.5, width), "ln_final.bias": rng.normal(0, .1, width),
          "logit_scale": np.array(4.6), "visual.proj": rng.normal(size=(4, 4))}
    for i in range(layers):
        rb = f"transformer.resblocks.{i}."
        sd.update({
            rb + "ln_1.weight": rng.uniform(0.5, 1.5, width), rb + "ln_1.bias": rng.normal(0, .1, width),
            rb + "ln_2.weight": rng.uniform(0.5, 1.5, width), rb + "ln_2.bias": rng.normal(0, .1, width),
            rb + "attn.in_proj_weight": rng.normal(0, width ** -0.5, (3 * width, width)),
            rb + "attn.in_proj_bias": rng.normal(0, .1, 3 * width),
            rb + "attn.out_proj.weight": rng.normal(0, width ** -0.5, (width, width)),
            rb + "attn.out_proj.bias": rng.normal(0, .1, width),
            rb + "mlp.c_fc.weight": rng.normal(0, width ** -0.5, (4 * width, width)),
            rb + "mlp.c_fc.bias": rng.normal(0, .1, 4 * width),
            rb + "mlp.c_proj.weight": rng.normal(0, (4 * width) ** -0.5, (width, 4 * width)),
            rb + "mlp.c_proj.bias": rng.normal(0, .1, width)})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _hf_clip_sd(openai):
    """The same weights under HF ``CLIPModel``'s names."""
    sd = {"text_model.embeddings.token_embedding.weight": openai["token_embedding.weight"],
          "text_model.embeddings.position_embedding.weight": openai["positional_embedding"],
          "text_model.embeddings.position_ids": np.arange(16)[None],
          "text_projection.weight": openai["text_projection"].T.copy(),
          "text_model.final_layer_norm.weight": openai["ln_final.weight"],
          "text_model.final_layer_norm.bias": openai["ln_final.bias"],
          "logit_scale": openai["logit_scale"], "vision_model.post_layernorm.bias": np.zeros(3),
          "visual_projection.weight": np.zeros((2, 3))}
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in openai:
        rb, lp = f"transformer.resblocks.{i}.", f"text_model.encoder.layers.{i}."
        w, b = openai[rb + "attn.in_proj_weight"], openai[rb + "attn.in_proj_bias"]
        for j, n in enumerate("qkv"):
            sd[lp + f"self_attn.{n}_proj.weight"] = w[j * len(b) // 3:(j + 1) * len(b) // 3]
            sd[lp + f"self_attn.{n}_proj.bias"] = b[j * len(b) // 3:(j + 1) * len(b) // 3]
        for hf, oa in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                       ("self_attn.out_proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
                       ("mlp.fc2", "mlp.c_proj")):
            for leaf in ("weight", "bias"):
                sd[f"{lp}{hf}.{leaf}"] = openai[f"{rb}{oa}.{leaf}"]
        i += 1
    return sd


def _tokens(rng, b=3, l=16, vocab=60):
    toks = rng.integers(1, vocab - 1, size=(b, l)).astype(np.int32)
    for i, n in enumerate((5, 9, l)):  # EOT = the highest id, then padding
        toks[i, n - 1] = vocab - 1
        toks[i, n:] = 0
    return toks


@pytest.mark.parametrize("names", ["openai", "hf"])
def test_clip_text_tower_matches_jax(names):
    from vidchapters_tpu.models import clip as jclip
    from vidchapters_tpu_torch.models import clip as tclip
    from vidchapters_tpu_torch.models.weights import clip_text_from_jax_params

    rng = np.random.default_rng(4)
    sd = openai_clip_text_sd(rng)
    if names == "hf":
        sd = _hf_clip_sd(sd)
    jconv = jclip.convert_openai_clip_text if names == "openai" else jclip.convert_hf_clip_text
    tconv = tclip.convert_openai_clip_text if names == "openai" else tclip.convert_hf_clip_text
    kw = dict(vocab_size=60, context_length=16, width=32, layers=2, heads=4, output_dim=24,
              dtype="float32")
    jenc, enc = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**kw)), tclip.CLIPTextEncoder(
        tclip.CLIPTextConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, jconv(sd))
    enc.load_state_dict(tconv(sd))
    for k, v in clip_text_from_jax_params(jparams, enc).items():  # the two imports agree
        np.testing.assert_array_equal(v.numpy(), enc.state_dict()[k].numpy(), err_msg=k)
    toks = _tokens(rng)
    for return_tokens in (True, False):
        ref = np.asarray(jax.jit(lambda t: jenc.apply({"params": jparams}, t,
                                                      return_tokens=return_tokens))(
            jnp.asarray(toks)))
        got = enc(torch.from_numpy(toks), return_tokens=return_tokens).detach()
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_clip_text_tower_bf16_matches_jax():
    """bf16 products and norms' outputs, fp32 projection: within 2e-2 of the
    largest output (a few bf16 roundings apart)."""
    from vidchapters_tpu.models import clip as jclip
    from vidchapters_tpu_torch.models import clip as tclip

    rng = np.random.default_rng(5)
    sd = openai_clip_text_sd(rng)
    kw = dict(vocab_size=60, context_length=16, width=32, layers=2, heads=4, output_dim=24,
              dtype="bfloat16")
    jenc, enc = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**kw)), tclip.CLIPTextEncoder(
        tclip.CLIPTextConfig(**kw))
    enc.load_state_dict(tclip.convert_openai_clip_text(sd))
    toks = _tokens(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, jclip.convert_openai_clip_text(sd))
    ref = np.asarray(jax.jit(lambda t: jenc.apply({"params": jparams}, t, return_tokens=True))(
        jnp.asarray(toks)))
    got = enc(torch.from_numpy(toks), return_tokens=True).detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2 * np.abs(ref).max(), rtol=0)


def _hf_bert_sd(rng, d=32, layers=2, ff=64, vocab=50, pos=24):
    sd = {"embeddings.word_embeddings.weight": rng.normal(0, .5, (vocab, d)),
          "embeddings.position_embeddings.weight": rng.normal(0, .5, (pos, d)),
          "embeddings.token_type_embeddings.weight": rng.normal(0, .5, (2, d)),
          "embeddings.LayerNorm.weight": rng.uniform(.5, 1.5, d),
          "embeddings.LayerNorm.bias": rng.normal(0, .1, d),
          "embeddings.position_ids": np.arange(pos)[None],
          "pooler.dense.weight": rng.normal(size=(d, d)), "pooler.dense.bias": np.zeros(d)}
    for i in range(layers):
        lp = f"encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                             ("attention.self.value", (d, d)),
                             ("attention.output.dense", (d, d)),
                             ("intermediate.dense", (ff, d)), ("output.dense", (d, ff))):
            sd[lp + name + ".weight"] = rng.normal(0, n ** -0.5, (o, n))
            sd[lp + name + ".bias"] = rng.normal(0, .1, o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[lp + name + ".weight"] = rng.uniform(.5, 1.5, d)
            sd[lp + name + ".bias"] = rng.normal(0, .1, d)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_bert_matches_jax():
    from vidchapters_tpu.models import bert as jbert
    from vidchapters_tpu_torch.models import bert as tbert
    from vidchapters_tpu_torch.models.weights import bert_from_jax_params

    rng = np.random.default_rng(6)
    sd = _hf_bert_sd(rng)
    kw = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=24)
    jmodel, model = jbert.BertModel(jbert.BertConfig(**kw)), tbert.BertModel(
        tbert.BertConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, jbert.convert_hf_bert(sd))
    model.load_state_dict(tbert.convert_hf_bert(sd))
    for k, v in bert_from_jax_params(jparams, model).items():
        np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy(), err_msg=k)
    ids = rng.integers(1, 50, size=(2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[0, -3:] = 0
    ref = np.asarray(jax.jit(lambda i, m: jmodel.apply({"params": jparams}, i, m))(
        jnp.asarray(ids), jnp.asarray(mask)))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_converters_and_importers_raise_on_names_they_cannot_place():
    from vidchapters_tpu_torch.models import bert as tbert
    from vidchapters_tpu_torch.models import clip as tclip
    from vidchapters_tpu_torch.models.weights import grounding_from_jax_params

    rng = np.random.default_rng(7)
    sd = openai_clip_text_sd(rng)
    for conv, good in ((tclip.convert_openai_clip_text, sd),
                       (tclip.convert_hf_clip_text, _hf_clip_sd(sd)),
                       (tbert.convert_hf_bert, _hf_bert_sd(rng))):
        conv(good)
        with pytest.raises(ValueError, match="cannot place"):
            conv({**good, "transformer.resblocks.0.attn.bogus": np.zeros(2)})
        first_layer = next(k for k in good if ".0." in k and "weight" in k)
        with pytest.raises(ValueError, match="no value for"):
            conv({k: v for k, v in good.items() if k != first_layer})

    jcfg, tcfg = _cfgs()
    _, params = _jax_setup(jcfg, _inputs(np.random.default_rng(0)))
    from vidchapters_tpu_torch.models.grounding import MomentDETR

    model = MomentDETR(tcfg)
    extra = {**params, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="bogus"):
        grounding_from_jax_params(extra, model)
    less = {k: v for k, v in params.items() if k != "saliency_proj"}
    with pytest.raises(ValueError, match="saliency_proj"):
        grounding_from_jax_params(less, model)
