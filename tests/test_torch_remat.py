"""T5 block rematerialisation in the port's training step (``models/t5.py``'s
``REMAT_BLOCKS`` / ``T5Config.remat``, the JAX package's
``nn.checkpoint(body)`` at its t5.py:667-688), on the CPU in fp32.

A step with every block checkpointed is the step without, bit for bit:
losses, ``grad_norm``, every gradient and every parameter after two steps,
with dropout 0 and 0.1 on each attention route (fused, the dense route's
hashed mask, element masks). The recompute replays the dropout of the first
pass and leaves ``StepRng`` where the plain step leaves it. What the
backward pass keeps falls below half. Eval and generation never checkpoint.

At T5 2+2 layers, d_model 64, 4 heads, d_ff 128, ViT 64 wide, depth 1."""

from pathlib import Path

import numpy as np
import pytest

import torch

ROUTES = ("fused", "dense", "element")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small model's steps are small operators: one intra-op thread runs
    them about as fast, and does not spin against the threads of the other
    test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dropout: float, remat, layers: int = 2):
    from vidchapters_tpu_torch import config as tc

    t5 = tc.T5Config(vocab_size=32200, d_model=64, d_kv=16, d_ff=128, num_layers=layers,
                     num_decoder_layers=layers, num_heads=4, dropout_rate=dropout,
                     encoder_dropout=dropout, decoder_dropout=dropout, dtype="float32",
                     remat=remat)
    vit = tc.TemporalViTConfig(num_features=16, embed_dim=64, depth=1, num_heads=4,
                               mlp_dim=128, dtype="float32", drop_rate=dropout,
                               attn_drop_rate=dropout)
    return tc.Vid2SeqConfig(t5=t5, vit=vit, num_bins=100)


def _batch(rng, route: str, b: int = 2, s: int = 0, out: int = 0):
    """Route "fused": 600 ASR tokens (the encoder's 640 rows take the fused
    route; the decoder's 300 x 300 and 300 x 640 the hashed dense route);
    otherwise 20 tokens and 12 labels (element masks, or the hashed dense
    route under a lowered threshold). ``s`` / ``out`` set the lengths."""
    s, out = (s, out) if s else (600, 300) if route == "fused" else (20, 12)

    def tokens(n, pad):
        x = rng.integers(3, 32100, size=(b, n)).astype(np.int32)
        x[0, n - pad:] = 0
        return x

    return {"video": rng.normal(size=(b, 16, 64)).astype(np.float32),
            "input_tokens": tokens(s, 5), "output_tokens": tokens(out, 3),
            "denoising_input_tokens": tokens(16, 4),
            "denoising_output_tokens": tokens(8, 2)}


def _route(monkeypatch, route: str) -> list:
    """Sets up ``route`` and returns the list the fused route's calls go to."""
    import vidchapters_tpu_torch.models.t5 as tt5

    if route == "dense":  # every attention off the fused route takes the hashed mask
        monkeypatch.setattr(tt5, "DENSE_REMAT_MIN_ELEMS", 1)
    calls = []
    fused = tt5.fused_attention_padded

    def counted(*args, **kw):
        calls.append(args[0].shape[2])
        return fused(*args, **kw)

    monkeypatch.setattr(tt5, "fused_attention_padded", counted)
    return calls


def _steps(cfg, weights, batches):
    """Two steps of ``make_train_step`` (generative + denoising, lr > 0 from
    the first); each step's metrics and gradients, and the parameters after."""
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train import dvc_train as t
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    model = Vid2Seq(cfg)
    model.load_state_dict(weights)
    optim = tc.OptimConfig(lr=1e-3, weight_decay=0.1, fraction_warmup_steps=0.0)
    state = t.TrainState(model, build_optimizer(optim, 10, model.parameters()))
    step = t.make_train_step(model)
    out = []
    for batch in batches:
        m = step(state, t.batch_to_device(batch, "cpu"), seed=3)
        out.append((m, {n: p.grad.clone() for n, p in model.named_parameters()}))
    return out, model.state_dict()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route", ROUTES)
def test_remat_step_equals_the_plain_step_bit_for_bit(monkeypatch, route, dropout):
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    calls = _route(monkeypatch, route)
    weights = Vid2Seq(_cfg(dropout, False)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    batches = [_batch(rng, route) for _ in range(2)]
    plain, plain_params = _steps(_cfg(dropout, False), weights, batches)
    n_plain = len(calls)
    remat, remat_params = _steps(_cfg(dropout, True), weights, batches)
    # the fused route: 2 encoder layers a step; the recompute runs each again
    assert n_plain == (4 if route == "fused" else 0)
    assert len(calls) - n_plain == 2 * n_plain
    for i, ((mp, gp), (mr, gr)) in enumerate(zip(plain, remat)):
        assert set(mp) == set(mr) == {"loss", "denoising_loss", "total_loss", "grad_norm"}
        for key in mp:
            assert torch.equal(mp[key], mr[key]), (i, key, float(mp[key]), float(mr[key]))
        for name in gp:
            assert torch.equal(gp[name], gr[name]), (i, name)
    for name, p in plain_params.items():
        assert torch.equal(p, remat_params[name]), name
        assert not torch.equal(p, weights[name]) or name.endswith("qkv.bias"), name


def _forward_backward(model, batch, rng):
    from vidchapters_tpu_torch.train.dvc_train import batch_to_device

    b = batch_to_device(batch, "cpu")
    inp = b["input_tokens"]
    loss = model(b["video"], inp, (inp != 0).to(torch.int32), b["output_tokens"],
                 rng=rng)["loss"]
    loss.backward()
    return loss


@pytest.mark.parametrize("route", ROUTES)
def test_recompute_leaves_the_stream_where_the_plain_step_does(monkeypatch, route):
    """After a forward and backward with dropout 0.1, both parts of the
    ``StepRng`` (the generator's state and the host stream's) equal those
    after the plain step, and the next draws agree."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.runtime.rng import StepRng

    _route(monkeypatch, route)
    batch = _batch(np.random.default_rng(2), route)
    states = []
    for remat in (False, True):
        model = Vid2Seq(_cfg(0.1, remat)).init_weights(torch.Generator().manual_seed(0))
        rng = StepRng(5, 1, "cpu")
        _forward_backward(model, batch, rng)
        gen, host = rng.get_state()
        states.append((gen, host, rng.seed32(), rng.keep_mask(torch.zeros(64), 0.5)))
    (g0, h0, s0, k0), (g1, h1, s1, k1) = states
    assert torch.equal(g0, g1) and h0 == h1 and s0 == s1 and torch.equal(k0, k1)


def test_replay_draws_the_snapshot_and_restores_the_live_stream():
    from vidchapters_tpu_torch.runtime.rng import StepRng

    rng = StepRng(0, 0, "cpu")
    snap = rng.get_state()
    first = (rng.seed32(), rng.keep_mask(torch.zeros(32), 0.5))
    live = rng.get_state()
    replay = rng.replay(snap)
    for _ in range(2):  # re-entrant: a second backward recomputes again
        with replay:
            again = (rng.seed32(), rng.keep_mask(torch.zeros(32), 0.5))
        assert again[0] == first[0] and torch.equal(again[1], first[1])
        assert torch.equal(rng.get_state()[0], live[0]) and rng.get_state()[1] == live[1]


def _saved_bytes(model, batch) -> int:
    """Bytes of the distinct storages that autograd keeps for the backward
    pass of one training forward (parameters apart), counted by
    ``saved_tensors_hooks``. A checkpointed block's inputs are saved through
    them too (torch's ``_NoopSaveInputs``)."""
    from vidchapters_tpu_torch.runtime.rng import StepRng

    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _forward_backward(model, batch, StepRng(0, 0, "cpu"))
    return sum(seen.values())


def test_remat_keeps_less_than_half_for_the_backward():
    """At 4+4 layers, batch 4, 250 ASR tokens (the encoder's 256 rows on the
    hashed dense route, its probabilities kept) and 64 labels, dropout 0.1:
    what the backward keeps with each block checkpointed is below half the
    plain forward's (measured: 0.341). Outside the blocks stay the
    relative-position one-hot ([L, L, 32] a stack), the ViT and the loss."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    batch = _batch(np.random.default_rng(3), "dense", b=4, s=250, out=64)
    got = {}
    for remat in (False, True):
        model = Vid2Seq(_cfg(0.1, remat, layers=4)).init_weights(
            torch.Generator().manual_seed(0))
        got[remat] = _saved_bytes(model, batch)
    ratio = got[True] / got[False]
    assert ratio < 0.5, (got, ratio)


def test_remat_follows_the_config_and_the_module_default(monkeypatch):
    """``remat=None`` follows ``REMAT_BLOCKS``, ``remat=False`` keeps every
    activation; an eval forward (no ``rng``), a forward under ``no_grad`` and
    generation never checkpoint."""
    import vidchapters_tpu_torch.models.t5 as tt5
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.runtime.rng import StepRng
    from vidchapters_tpu_torch.train.dvc_train import batch_to_device, make_generate_fn

    calls = []
    real = tt5.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tt5, "checkpoint", counted)
    batch = batch_to_device(_batch(np.random.default_rng(4), "element"), "cpu")
    inp = batch["input_tokens"]
    args = (batch["video"], inp, (inp != 0).to(torch.int32), batch["output_tokens"])

    def blocks_checkpointed(remat, default=True, rng=True, grad=True):
        monkeypatch.setattr(tt5, "REMAT_BLOCKS", default)
        model = Vid2Seq(_cfg(0.1, remat)).init_weights(torch.Generator().manual_seed(0))
        calls.clear()
        with torch.set_grad_enabled(grad):
            model(*args, rng=StepRng(0, 0, "cpu") if rng else None)
        return len(calls)

    assert blocks_checkpointed(None) == 4  # 2 encoder + 2 decoder blocks
    assert blocks_checkpointed(None, default=False) == 0
    assert blocks_checkpointed(True, default=False) == 4
    assert blocks_checkpointed(False) == 0
    assert blocks_checkpointed(True, rng=False) == 0
    assert blocks_checkpointed(True, grad=False) == 0
    assert tt5.uses_remat(_cfg(0.0, None).t5) and not tt5.uses_remat(_cfg(0.0, False).t5)
    monkeypatch.setattr(tt5, "REMAT_BLOCKS", True)
    model = Vid2Seq(_cfg(0.1, True)).init_weights(torch.Generator().manual_seed(0)).eval()
    calls.clear()
    gen = make_generate_fn(model, GenerationConfig(num_beams=2, max_length=6))
    seqs = gen(batch["video"], inp)
    assert seqs is not None and not calls


def test_remat_default_is_on_in_a_config():
    """The recipes leave ``remat`` unset: their training checkpoints each
    block, as the JAX package's does."""
    import vidchapters_tpu_torch.models.t5 as tt5
    from vidchapters_tpu_torch import config as tc

    assert tt5.REMAT_BLOCKS is True
    for path in ("configs/htm_pretrain.json", "configs/chapters_vid2seq.json"):
        cfg = tc.load_config(tc.ExperimentConfig, str(ROOT / path))
        assert cfg.model.t5.remat is None and tt5.uses_remat(cfg.model.t5), path
