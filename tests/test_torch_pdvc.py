"""The port's PDVC against the JAX package's, on the CPU in float32 at the
JAX tests' small widths (hidden 64, 4 heads, 2+2 layers, 3 levels), with
the JAX init carried across by ``pdvc_from_jax_params``, for the LSTM-DSA
("dsa", the recipe's) and the LSTM ("light") caption heads:

- every JAX leaf placed; the forward dict (logits, counts, boxes, hs)
  within 1e-5; teacher-forced caption log-probs within 1e-5; greedy
  caption tokens identical;
- ``pdvc_criterion``: the matcher's assignments identical, every loss term
  within 1e-5 relative, every gradient within 1e-4 of its norm (plus
  1e-7 for gradients that are 0 up to rounding);
- ``auction_lsap`` identical to JAX's and, on separated costs, to
  ``scipy_lsap``; the span ops against JAX's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

CFG = dict(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
           num_queries=8, num_feature_levels=3, dec_n_points=2, enc_n_points=2,
           feature_dim=16, frame_embedding_num=24, max_eseq_length=10, dropout=0.0,
           vocab_size=50, max_caption_len=8, rnn_size=32, cap_nheads=4,
           cap_num_feature_levels=3, cap_dec_n_points=2)


def _targets(rng):
    captions = rng.integers(1, 51, size=(2, 3, 8))
    captions[:, :, 0] = 0
    captions[0, 0, 5:] = 0
    captions[1, :, 3:] = 0
    return {"boxes": np.array([[[0.3, 0.2], [0.7, 0.3], [0.0, 0.0]],
                               [[0.5, 0.5], [0.2, 0.1], [0.0, 0.0]]], np.float32),
            "valid": np.array([[1, 1, 0], [1, 1, 0]], np.int32),
            "captions": captions.astype(np.int32)}


@pytest.fixture(scope="module", params=["dsa", "light"])
def setup(request):
    from vidchapters_tpu.config import PDVCConfig as JConfig
    from vidchapters_tpu.models.pdvc import PDVC as JPDVC
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params

    kw = dict(CFG, caption_decoder_type=request.param)
    jmodel = JPDVC(JConfig(**kw))
    rng = np.random.default_rng(0)
    vf = rng.normal(size=(2, 24, 16)).astype(np.float32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 18:] = 0
    params = jax.jit(lambda k, v, m: jmodel.init({"params": k}, v, m, method=jmodel.init_all)[
        "params"])(jax.random.PRNGKey(0), jnp.asarray(vf), jnp.asarray(mask))
    params = jax.device_get(params)
    # a wider logit layer than uniform(0.1), so greedy captions vary by step
    params["captioner"]["logit_w"] = rng.normal(
        size=params["captioner"]["logit_w"].shape).astype(np.float32)
    # the init's grid-prior offsets put every encoder sampling point of the
    # axis-aligned heads exactly on a pixel centre, where the location
    # gradient is one-sided: which side JAX takes there depends on how XLA
    # compiles the graph (its eager ops agree with the port's). Move the
    # points 0.1-0.4 pixel off the centres so the gradients are defined.
    for name in ("enc_0", "enc_1"):
        leaf = params[name]["self_attn"]["sampling_offsets"]
        leaf["bias"] = leaf["bias"] + rng.uniform(0.1, 0.4, leaf["bias"].shape).astype(np.float32)
    model = PDVC(PDVCConfig(**kw))
    model.load_state_dict(pdvc_from_jax_params(params, model))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jmodel, jparams, params, model.eval(), vf, mask, rng


def test_every_leaf_maps(setup):
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params

    _, _, params, model, _, _, _ = setup
    sd = pdvc_from_jax_params(params, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(params)) == len(model.state_dict())
    # a Conv kernel [k, in, out] -> [out, in, k], a GroupNorm scale, a listed
    # head, and the caption head's explicit [V+1, h] embedding kept as it is
    np.testing.assert_array_equal(sd["base_encoder.proj.1.conv.weight"].numpy(),
                                  params["base_encoder"]["proj_1"]["conv"]["kernel"]
                                  .transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["base_encoder.proj.2.gn.weight"].numpy(),
                                  params["base_encoder"]["proj_2"]["gn"]["scale"])
    np.testing.assert_array_equal(sd["count_heads.1.weight"].numpy(),
                                  params["count_head_1"]["kernel"].T)
    np.testing.assert_array_equal(sd["captioner.embedding"].numpy(),
                                  params["captioner"]["embedding"])
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        pdvc_from_jax_params(extra, model)


def _jax_forward(jmodel, jparams, vf, mask):
    return jax.jit(lambda p, v, m: {k: x for k, x in jmodel.apply({"params": p}, v, m).items()
                                    if k != "spatial_shapes"})(jparams, vf, mask)


def test_forward_matches_jax(setup):
    jmodel, jparams, _, model, vf, mask, _ = setup
    ref = _jax_forward(jmodel, jparams, vf, mask)
    with torch.no_grad():
        out = model(torch.from_numpy(vf), torch.from_numpy(mask))
    assert out["spatial_shapes"] == (24, 12, 6)
    for key in ("pred_logits", "pred_count", "pred_boxes", "hs", "memory", "cap_reference",
                "valid_ratios"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    # the two-stage path: decoding from given (center, length) proposals
    props = np.random.default_rng(9).uniform(0.1, 0.9, (2, 5, 2)).astype(np.float32)
    pmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    shapes = out["spatial_shapes"]
    jdec = jax.jit(lambda p, m, mm, vr, pr, pm: jmodel.apply(
        {"params": p}, m, mm, shapes, vr, proposals=pr, proposals_mask=pm,
        method=jmodel.decode))(jparams, ref["memory"], ref["memory_mask"], ref["valid_ratios"],
                               props, pmask)
    with torch.no_grad():
        tdec = model.decode(out["memory"], out["memory_mask"], shapes, out["valid_ratios"],
                            proposals=torch.from_numpy(props),
                            proposals_mask=torch.from_numpy(pmask))
    for r, g in zip(jdec, tdec):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def _contexts(setup):
    jmodel, jparams, _, model, vf, mask, _ = setup
    with torch.no_grad():
        tout = model(torch.from_numpy(vf), torch.from_numpy(mask))
    jout = dict(_jax_forward(jmodel, jparams, vf, mask), spatial_shapes=tout["spatial_shapes"])
    dsa = model.cfg.caption_decoder_type == "dsa"
    jctx = jmodel.apply({"params": jparams}, jout, method=jmodel.caption_context) if dsa else None
    tctx = model.caption_context(tout) if dsa else None
    return jout, tout, jctx, tctx


def test_caption_logprobs_and_greedy_tokens_match_jax(setup):
    jmodel, jparams, _, model, _, _, rng = setup
    jout, tout, jctx, tctx = _contexts(setup)
    feats_j = jout["hs"][-1].reshape(-1, 64)
    feats_t = tout["hs"][-1].reshape(-1, 64)
    seq = rng.integers(1, 51, size=(16, 8)).astype(np.int32)
    seq[:, 0] = 0
    seq[::3, 5:] = 0
    # the context holds the static level lengths: a constant of the jitted function
    ref = jax.jit(lambda p, f, s: jmodel.apply({"params": p}, f, s, jctx,
                                               method=jmodel.caption_logprobs))(
        jparams, feats_j, jnp.asarray(seq))
    with torch.no_grad():
        got = model.caption_logprobs(feats_t, torch.from_numpy(seq).long(), tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    jtok, jlp = jax.jit(lambda p, f: jmodel.apply({"params": p}, f, 8, jctx,
                                                  method=jmodel.caption_sample))(jparams, feats_j)
    with torch.no_grad():
        ttok, tlp = model.caption_sample(feats_t, 8, tctx)
    jtok = np.asarray(jtok)
    assert len(np.unique(jtok)) > 4  # the captions are not one repeated word
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)


def test_criterion_loss_and_gradients_match_jax(setup):
    from vidchapters_tpu.models.pdvc_loss import match_pdvc as jax_match
    from vidchapters_tpu.models.pdvc_loss import pdvc_criterion as jax_criterion
    from vidchapters_tpu_torch.models.pdvc_loss import match_pdvc, pdvc_criterion
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params

    jmodel, jparams, _, model, vf, mask, _ = setup
    cfg = model.cfg
    targets = _targets(np.random.default_rng(5))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(vf), jnp.asarray(mask))
        return jax_criterion(jmodel, p, out, jt, jmodel.cfg)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    jout = _jax_forward(jmodel, jparams, vf, mask)

    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(vf), torch.from_numpy(mask))
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    for lid in range(cfg.dec_layers):
        ref = jax_match(jout["pred_logits"][lid], jout["pred_boxes"][lid], jt["boxes"],
                        jt["valid"], jmodel.cfg, cost_class=cfg.cls_loss_coef,
                        cost_bbox=cfg.bbox_loss_coef, cost_giou=cfg.giou_loss_coef)
        got = match_pdvc(out["pred_logits"][lid], out["pred_boxes"][lid], tt["boxes"],
                         tt["valid"], cfg, cost_class=cfg.cls_loss_coef,
                         cost_bbox=cfg.bbox_loss_coef, cost_giou=cfg.giou_loss_coef)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    total, losses = pdvc_criterion(model, out, tt, cfg)
    total.backward()
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        r, g = float(jlosses[k]), float(v.detach())
        assert abs(g - r) <= 1e-5 * max(abs(r), 1e-3), (k, g, r)
    ref_grads = pdvc_from_jax_params(jax.device_get(jgrads), model)
    for name, p in model.named_parameters():
        r = ref_grads[name]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        # key biases get ~1e-8 (the softmax ignores them): an absolute floor
        err = float((g - r).norm())
        assert err <= 1e-4 * float(r.norm()) + 1e-7, (name, err, float(r.norm()))


def test_auction_matches_jax_and_scipy():
    from vidchapters_tpu.ops.matching import auction_lsap as jax_auction
    from vidchapters_tpu_torch.ops.matching import auction_lsap, hungarian_match, scipy_lsap

    rng = np.random.default_rng(0)
    solve = jax.jit(jax_auction)
    for q, t, n_valid, kind in ((12, 7, 7, "separated"), (100, 10, 4, "separated"),
                                (100, 10, 10, "tight"), (100, 50, 50, "tight"),
                                (100, 10, 6, "normal")):
        for _ in range(3):
            if kind == "tight":
                cost = np.round(rng.uniform(0, 1, (q, t)), 2).astype(np.float32)
            else:
                cost = (rng.normal(size=(q, t)) * (10 if kind == "separated" else 1)
                        ).astype(np.float32)
            valid = np.arange(t) < n_valid
            got = auction_lsap(cost, valid)
            np.testing.assert_array_equal(got, np.asarray(solve(jnp.asarray(cost),
                                                                jnp.asarray(valid))))
            assert np.all(got[n_valid:] == -1) and len(set(got[:n_valid])) == n_valid
            if kind == "separated":
                np.testing.assert_array_equal(got, scipy_lsap(cost, n_valid))
                np.testing.assert_array_equal(hungarian_match(cost, valid, exact=True), got)


def test_span_ops_match_jax():
    from vidchapters_tpu.ops import span_ops as js
    from vidchapters_tpu_torch.ops import span_ops as ts

    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 1, (6, 2)), axis=1).astype(np.float32)
    b = np.sort(rng.uniform(0, 1, (5, 2)), axis=1).astype(np.float32)
    b[0] = b[1]  # a duplicate and a zero-width span
    b[2, 1] = b[2, 0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("temporal_iou", "generalized_temporal_iou"):
        ref = getattr(js, name)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(ts, name)(ta, tb)
        for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                        got if isinstance(got, tuple) else (got,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.span_cxw_to_xx(ts.span_xx_to_cxw(ta)).numpy(), a, atol=1e-6)
    np.testing.assert_allclose(ts.span_xx_to_cxw(ta).numpy(),
                               np.asarray(js.span_xx_to_cxw(jnp.asarray(a))), atol=0)
    spans = np.array([[0, 10], [1, 11], [20, 30], [21, 29], [5, 25]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.95, 0.1], np.float32)
    ref = js.temporal_nms_indices(jnp.asarray(spans), jnp.asarray(scores), 0.5, 4)
    got = ts.temporal_nms_indices(torch.from_numpy(spans), torch.from_numpy(scores), 0.5, 4)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_gpt2_caption_head_builds_and_places_leaves():
    """Once a raise, the ``gpt2`` head now builds: ``build_captioner`` gives
    the GPT-2 head at ``cap_gpt2_*``'s geometry, and a JAX init's
    ``captioner/gpt2/...`` and ``captioner/query2cap`` leaves all place."""
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.pdvc import PDVC, GPT2Captioner, build_captioner

    cfg = PDVCConfig(**GPT2_CFG)
    head = build_captioner(cfg)
    assert isinstance(head, GPT2Captioner) and len(head.gpt2.blocks) == cfg.cap_gpt2_n_layer
    assert tuple(head.gpt2.wte.shape) == (cfg.cap_gpt2_vocab, cfg.cap_gpt2_n_embd)
    model = PDVC(cfg)
    names = {n for n in model.state_dict() if n.startswith("captioner.")}
    assert {"captioner.query2cap.weight", "captioner.gpt2.wte", "captioner.gpt2.wpe",
            "captioner.gpt2.blocks.0.c_attn.weight", "captioner.gpt2.ln_f.bias"} <= names


# the JAX caption-head tests' gpt2 widths (tests/test_pdvc_caption_heads.py::tiny_cfg)
GPT2_CFG = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
                num_queries=6, num_feature_levels=2, dec_n_points=2, enc_n_points=2,
                feature_dim=8, frame_embedding_num=16, dropout=0.0, vocab_size=40,
                max_caption_len=6, rnn_size=16, cap_nheads=4, cap_dec_n_points=2,
                cap_num_feature_levels=2, caption_decoder_type="gpt2", cap_gpt2_n_layer=1,
                cap_gpt2_n_head=2, cap_gpt2_n_embd=16, cap_gpt2_vocab=41, cap_gpt2_eos=0)


@pytest.fixture(scope="module")
def gpt2_setup():
    from vidchapters_tpu.config import PDVCConfig as JConfig
    from vidchapters_tpu.models.pdvc import PDVC as JPDVC
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.pdvc import PDVC
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params

    jmodel = JPDVC(JConfig(**GPT2_CFG))
    rng = np.random.default_rng(0)
    vf = rng.normal(size=(2, 16, 8)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 12:] = 0
    params = jax.device_get(jax.jit(lambda k, v, m: jmodel.init(
        {"params": k}, v, m, method=jmodel.init_all)["params"])(
        jax.random.PRNGKey(0), jnp.asarray(vf), jnp.asarray(mask)))
    # wider embeddings than the init's, so greedy captions vary by step, and
    # the encoder's sampling points off the pixel centres (see ``setup``)
    gpt2 = params["captioner"]["gpt2"]
    gpt2["wte"] = rng.normal(size=gpt2["wte"].shape).astype(np.float32)
    gpt2["wpe"] = rng.normal(size=gpt2["wpe"].shape).astype(np.float32)
    leaf = params["enc_0"]["self_attn"]["sampling_offsets"]
    leaf["bias"] = leaf["bias"] + rng.uniform(0.1, 0.4, leaf["bias"].shape).astype(np.float32)
    model = PDVC(PDVCConfig(**GPT2_CFG))
    sd = pdvc_from_jax_params(params, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(params)) == len(model.state_dict())
    model.load_state_dict(sd)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model.eval(), vf, mask


def test_gpt2_head_train_loss_and_gradients_match_jax(gpt2_setup):
    """The gpt2 head's train step: the criterion's every term within 1e-5
    relative and every gradient within 1e-4 of its norm (+1e-7)."""
    from vidchapters_tpu.models.pdvc_loss import pdvc_criterion as jax_criterion
    from vidchapters_tpu_torch.models.pdvc_loss import pdvc_criterion
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params

    jmodel, jparams, model, vf, mask = gpt2_setup
    rng = np.random.default_rng(5)
    captions = rng.integers(1, 41, size=(2, 3, 6)).astype(np.int32)
    captions[:, :, 0] = 0
    captions[0, 0, 4:] = 0
    captions[1, :, 3:] = 0
    targets = dict(_targets(rng), captions=captions)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(vf), jnp.asarray(mask))
        return jax_criterion(jmodel, p, out, jt, jmodel.cfg)

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(vf), torch.from_numpy(mask))
    total, losses = pdvc_criterion(model, out, {k: torch.from_numpy(v)
                                                for k, v in targets.items()}, model.cfg)
    total.backward()
    assert set(losses) == set(jlosses) and float(losses["loss_caption"].detach()) > 0
    for k, v in losses.items():
        r, g = float(jlosses[k]), float(v.detach())
        assert abs(g - r) <= 1e-5 * max(abs(r), 1e-3), (k, g, r)
    ref_grads = pdvc_from_jax_params(jax.device_get(jgrads), model)
    assert float(ref_grads["captioner.gpt2.wte"].norm()) > 0
    for name, p in model.named_parameters():
        r = ref_grads[name]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((g - r).norm())
        assert err <= 1e-4 * float(r.norm()) + 1e-7, (name, err, float(r.norm()))


def test_gpt2_head_logprobs_and_greedy_tokens_match_jax(gpt2_setup):
    """Teacher-forced log-probs within 1e-5; greedy tokens identical, with
    log-probs within 1e-5 (rows that emit the EOS 0 stop)."""
    jmodel, jparams, model, vf, mask = gpt2_setup
    jout = _jax_forward(jmodel, jparams, vf, mask)
    with torch.no_grad():
        tout = model(torch.from_numpy(vf), torch.from_numpy(mask))
    feats_j, feats_t = jout["hs"][-1].reshape(-1, 32), tout["hs"][-1].reshape(-1, 32)
    seq = np.random.default_rng(6).integers(1, 41, size=(12, 6)).astype(np.int32)
    seq[:, 0] = 0
    seq[::4, 3:] = 0
    ref = jax.jit(lambda p, f, s: jmodel.apply({"params": p}, f, s, None,
                                               method=jmodel.caption_logprobs))(
        jparams, feats_j, jnp.asarray(seq))
    with torch.no_grad():
        got = model.caption_logprobs(feats_t, torch.from_numpy(seq).long())
    assert got.shape == (12, 5, 41)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    jtok, jlp = jax.jit(lambda p, f: jmodel.apply({"params": p}, f, 8, None,
                                                  method=jmodel.caption_sample))(jparams, feats_j)
    ttok, tlp = model.caption_sample(feats_t, 8)
    jtok = np.asarray(jtok)
    assert len(np.unique(jtok)) > 4
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)


LIGHT_CFG = dict(CFG, caption_decoder_type="light", vocab_size=12)


def _light_head(peaked: bool):
    """The light LSTM head, seeded; ``peaked``: a logit layer x 1000, whose
    distributions are one-hot after ``exp`` (a draw is the argmax)."""
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.pdvc import LSTMCaptioner

    head = LSTMCaptioner(PDVCConfig(**LIGHT_CFG))
    head.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        head.logit_w.copy_(torch.randn(head.logit_w.shape,
                                       generator=torch.Generator().manual_seed(1)))
        if peaked:
            head.logit_w.mul_(1000.0)
    return head


def _ss_inputs(n: int, length: int = 8):
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(n, 64, generator=g)
    seq = torch.randint(1, 13, (n, length), generator=g)
    seq[:, 0] = 0
    return feats, seq


def test_scheduled_sampling_limits():
    """``ss_prob`` 0, or no generator, is teacher forcing exactly; at 1 over
    one-hot distributions every input from step 1 on is the previous step's
    argmax, so the run equals teacher forcing on that argmax sequence."""
    head = _light_head(peaked=True)
    feats, seq = _ss_inputs(16)
    with torch.no_grad():
        tf = head.teacher_forced_logprobs(feats, seq)
        assert torch.equal(head.teacher_forced_logprobs(
            feats, seq, 0.0, torch.Generator().manual_seed(3)), tf)
        assert torch.equal(head.teacher_forced_logprobs(feats, seq, 0.7, None), tf)
        ss = head.teacher_forced_logprobs(feats, seq, 1.0, torch.Generator().manual_seed(3))
        fed = seq.clone()
        fed[:, 1:-1] = ss[:, :-1].argmax(-1)
        assert not torch.equal(fed, seq)
        assert torch.equal(head.teacher_forced_logprobs(feats, fed), ss)


def test_scheduled_sampling_flip_rate_and_reproducibility():
    """At ``ss_prob`` 0.3 the share of steps >= 1 whose input was the draw
    (recovered step by step from the log-probs) is within 4 standard
    deviations of 0.3; step 0 never flips. The same generator seed gives
    the same log-probs, another seed others."""
    head = _light_head(peaked=True)
    n, length, p = 300, 8, 0.3
    feats, seq = _ss_inputs(n, length)
    with torch.no_grad():
        ss = head.teacher_forced_logprobs(feats, seq, p, torch.Generator().manual_seed(4))
        again = head.teacher_forced_logprobs(feats, seq, p, torch.Generator().manual_seed(4))
        other = head.teacher_forced_logprobs(feats, seq, p, torch.Generator().manual_seed(5))
        assert torch.equal(ss, again) and not torch.equal(ss, other)
        state = head._init_state(n, feats)
        flips = trials = 0
        for step in range(length - 1):
            cands = [seq[:, step]] + ([ss[:, step - 1].argmax(-1)] if step else [])
            runs = [head._cell(state, torch.cat([head.embedding[c], feats], dim=-1))
                    for c in cands]
            match = torch.stack([(head._logprobs(h) == ss[:, step]).all(-1) for _, h in runs])
            assert match.any(0).all()  # every row took one of the candidates
            if step == 0:
                continue_state = runs[0][0]
            else:
                took = match[1] & ~match[0]
                differ = cands[0] != cands[1]
                flips += int((took & differ).sum())
                trials += int(differ.sum())
                continue_state = tuple(torch.where(took[:, None], a, b)
                                       for a, b in zip(runs[1][0], runs[0][0]))
            state = continue_state
    rate, sd = flips / trials, (p * (1 - p) / trials) ** 0.5
    assert trials > 1000 and abs(rate - p) <= 4 * sd, (rate, trials)
