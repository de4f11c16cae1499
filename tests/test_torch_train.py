"""The port's training path against the JAX package's, on the CPU in fp32:
the Vid2Seq training loss and every parameter's gradient (with inputs long
enough for the fused-attention route), three steps of ``make_train_step``
(clip, lr 0 on the first update, AdamW, time-token renorm), the schedules,
and the per-step dropout stream. Dropout is 0 where the two are compared:
the two packages draw different random numbers (the keep masks of the
hashed routes are held bit-exact in test_torch_fused_attention_bwd.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_helpers import jax_params, port_model, small_cfgs


def _grads_as_state_dict(grads, model):
    from vidchapters_tpu_torch.models.weights import from_jax_params

    return from_jax_params(jax.device_get(grads), model)


def _train_batch(rng, b=2, t=16, s=20, out=12, den_in=16, den_out=8):
    def tokens(n, pad):
        x = rng.integers(3, 32100, size=(b, n)).astype(np.int32)
        x[0, n - pad:] = 0
        return x

    return {"video": rng.normal(size=(b, t, 128)).astype(np.float32),
            "input_tokens": tokens(s, 5), "output_tokens": tokens(out, 3),
            "denoising_input_tokens": tokens(den_in, 4),
            "denoising_output_tokens": tokens(den_out, 2)}


def test_loss_and_every_gradient_match_jax_on_the_fused_route(monkeypatch):
    """600 ASR tokens pad to 640 at the encoder's entry (self-attention
    640 x 640) and 420 output tokens meet 16 + 600 fused states padded to
    640 (decoder cross-attention 420 x 640): both take the fused route in
    both packages (JAX's Pallas kernel in interpret mode, the port's plain
    versions). The T5 feed-forward is gated-GELU here: ReLU's derivative
    jumps at 0, and a pre-activation within fp32 rounding of 0 flips it
    between the packages (seen at this seed: one flip moved the gradients
    below it by 1e-2 of their largest element)."""
    import vidchapters_tpu.models.t5 as jt5
    import vidchapters_tpu_torch.models.t5 as tt5
    from vidchapters_tpu_torch.runtime.rng import StepRng

    monkeypatch.setattr(jt5, "USE_FUSED_ATTENTION", True)
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[2])
        return fused(*args, **kw)

    fused = tt5.fused_attention_padded
    monkeypatch.setattr(tt5, "fused_attention_padded", counted)
    jcfg, tcfg = small_cfgs(feed_forward_proj="gated-gelu")
    jmodel, params = jax_params(jcfg)
    model = port_model(tcfg, params)
    rng = np.random.default_rng(5)
    video = rng.normal(size=(2, 16, 128)).astype(np.float32)
    tokens = rng.integers(3, 32100, size=(2, 600)).astype(np.int32)
    tokens[0, 550:] = 0
    labels = rng.integers(3, 32200, size=(2, 420)).astype(np.int32)
    labels[1, 400:] = 0
    mask = (tokens != 0).astype(np.int32)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(video), jnp.asarray(tokens),
                            jnp.asarray(mask), jnp.asarray(labels), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})["loss"]

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    t = [torch.from_numpy(a) for a in (video, tokens, mask, labels)]
    loss = model(*t, rng=StepRng(0, 0, "cpu"))["loss"]
    loss.backward()
    # 2 encoder + 2 cross layers, each again in its block's recompute (remat)
    assert sorted(calls) == [420] * 4 + [640] * 4
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref = _grads_as_state_dict(ref_grads, model)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        r = ref[name].numpy()
        scale = max(np.abs(r).max(), 1e-6)
        err = np.abs(p.grad.numpy() - r).max() / scale
        assert err < 1e-4, f"{name}: max error {err:.2e} of the largest gradient"


def _optim_cfgs(jc, tc, **kw):
    return jc.OptimConfig(**kw), tc.OptimConfig(**kw)


@pytest.mark.parametrize("remat", [True, False])
def test_three_train_steps_match_jax(remat):
    """The port's step with each T5 block checkpointed (``remat`` True) and
    without, against JAX's default, which checkpoints them. Clip at 0.1 (active: the raw norm is far above it), cosine schedule
    with 2 warmup updates of 10 (lr 0, then lr/2, then lr), weight decay,
    generative + denoising losses, time-token renorm after each update.

    Losses and norms agree to fp32 rounding (rtol 2e-5). Each parameter's
    total update is held norm-wise to 2e-3 of itself: Adam's m / sqrt(v)
    is scale-free, so a gradient element that is a near-cancelling sum,
    moved by a large fraction of itself by rounding, moves its update by up
    to lr (seen: 3.5e-4 of the norm, for the ViT's qkv bias). Weight decay is
    0.1 so that the decay term (~1e-2 of a weight's update) shows above that
    bound."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train import dvc_train as jtrain
    from vidchapters_tpu.train.schedules import build_optimizer as jax_optimizer
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.train import dvc_train as ttrain
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    jcfg, tcfg = small_cfgs()
    tcfg = dataclasses.replace(tcfg, t5=dataclasses.replace(tcfg.t5, remat=remat))
    jmodel, params = jax_params(jcfg)
    model = port_model(tcfg, params)
    kw = dict(lr=1e-3, weight_decay=0.1, clip_max_norm=0.1, fraction_warmup_steps=0.2,
              schedule="cosine_with_warmup")
    jopt, topt = _optim_cfgs(jc, tc, **kw)
    tx = jax_optimizer(jopt, 10)
    jstate = jtrain.TrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jmodel, tx))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = ttrain.TrainState(model, build_optimizer(topt, 10, model.parameters()))
    step = ttrain.make_train_step(model)
    rng = np.random.default_rng(11)
    for i in range(3):
        batch = _train_batch(rng)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        m = step(state, ttrain.batch_to_device(batch, "cpu"), seed=0)
        for key in ("loss", "denoising_loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-5,
                                       err_msg=f"step {i} {key}")
        assert float(m["grad_norm"]) > 0.1  # the clip is active
        emb = model.t5.shared.weight.detach()
        norms = emb.norm(dim=1)
        np.testing.assert_allclose(float(norms[-100:].mean()), float(norms[:-100].mean()),
                                   rtol=1e-5)
    assert state.step == 3 and state.optimizer.count == 3
    ref = from_jax_params(jax.device_get(jstate.params), model)
    for name, p in model.state_dict().items():
        got, want = p - before[name], ref[name] - before[name]
        assert float(want.norm()) > 0, name
        err = float((got - want).norm() / want.norm())
        assert err < 2e-3, f"{name}: update differs by {err:.2e} of its norm"


def test_first_update_has_lr_zero():
    """lr(0) = 0 under warmup: the first update moves no parameter (weight
    decay included), and the renorm leaves the rows as they were."""
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.train import dvc_train as ttrain
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    jcfg, tcfg = small_cfgs()
    model = port_model(tcfg, jax_params(jcfg)[1])
    ttrain.renorm_time_tokens(model, 100)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(tc.OptimConfig(lr=1e-3, weight_decay=0.1), 100,
                          model.parameters())
    state = ttrain.TrainState(model, opt)
    ttrain.make_train_step(model)(state, ttrain.batch_to_device(
        _train_batch(np.random.default_rng(0)), "cpu"), seed=0)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, before[name], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine_with_warmup", "linear_with_warmup", ""])
@pytest.mark.parametrize("total,frac", [(100, 0.01), (37, 0.2), (5, 0.0)])
def test_schedule_values_match_jax(schedule, total, frac):
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train.schedules import build_schedule as jax_schedule
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.train.schedules import build_schedule

    jopt, topt = _optim_cfgs(jc, tc, lr=3e-4, schedule=schedule,
                             fraction_warmup_steps=frac)
    ref, got = jax_schedule(jopt, total), build_schedule(topt, total)
    for s in range(total + 3):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {s}")


def test_mu_dtype_other_than_float32_raises():
    """float32 and bfloat16 moments are built; any other dtype raises."""
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    with pytest.raises(ValueError, match="float16"):
        build_optimizer(tc.OptimConfig(mu_dtype="float16"), 10, [torch.nn.Parameter(
            torch.zeros(2))])


def test_training_dropout_is_reproducible_from_seed_and_step():
    """With dropout on (0.1 everywhere) and every attention route taken, a
    step's loss is a function of (seed, step): the same pair gives the same
    loss, another step gives another."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.runtime.rng import StepRng

    _, tcfg = small_cfgs()
    t5 = dataclasses.replace(tcfg.t5, dropout_rate=0.1, encoder_dropout=0.1,
                             decoder_dropout=0.1)
    vit = dataclasses.replace(tcfg.vit, drop_rate=0.1, attn_drop_rate=0.1)
    model = Vid2Seq(dataclasses.replace(tcfg, t5=t5, vit=vit)).init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    video = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(3, 32100, size=(2, 600)))
    labels = torch.from_numpy(rng.integers(3, 32100, size=(2, 300)))  # 300^2: hash route
    mask = (tokens != 0).to(torch.int32)

    def loss(seed, step):
        with torch.no_grad():
            return float(model(video, tokens, mask, labels, rng=StepRng(seed, step, "cpu"))
                         ["loss"])

    with torch.no_grad():
        det = float(model(video, tokens, mask, labels)["loss"])
    a, b, c = loss(3, 7), loss(3, 7), loss(3, 8)
    assert np.isfinite(a) and a == b and a != c and a != det
