"""The port's tensor and sequence parallelism over gloo ranks on the CPU,
against the JAX package's unsharded step and the port's own one-process
step.

One 2-rank and one 4-rank launch of ``tests/torch_tp_worker.py`` run as
subprocesses (each with a wall limit) while this process computes the
references:

- the sequence collectives, the vocabulary-parallel embedding and loss,
  ``renorm_time_tokens`` and ``ClipAdamW``'s norm, with their gradients,
  against their one-process forms;
- the Vid2Seq train step at grids 1 x 2 (520 input tokens: the T5 encoder
  pads to 640 rows, takes the fused route, 320 rows a shard), 2 x 2 and
  1 x 4 against JAX's jitted step on the global batch at dropout 0:
  losses, ``grad_norm`` and every gathered parameter after each of two
  steps (the data-parallel tests' limits);
- with dropout on (T5 and ViT, 0.1): 1 x 2 at 520 tokens, each T5 block
  rematerialised (the default), with and without sequence parallelism,
  against the port's one-process step without remat at the same seed, and
  2 x 2 against 2 x 1, to 1e-5 (the fused, dense-hash and element routes
  all draw masks; the recompute redraws each rank's slice and head offset);
- a checkpoint saved at 1 x 2 restored at 1 x 1 and the reverse give the
  same next step;
- the vocabulary is 256 with 100 time tokens, so at model axis 2 and 4 a
  shard holds text and time rows both.

At 2+2 layers, d_model 64, 4 heads, d_ff 128, ViT 32 wide (a ``proj_v2t``)
and depth 1, fp32.
"""

import dataclasses
import json
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest

import torch

from tests._torch_helpers import jax_params, port_model
from tests.test_torch_data_parallel import VID2SEQ_OPTIM, _key_bias, _rel, launch, wait_all

HERE = Path(__file__).resolve().parent
RTOL = 2e-5        # against JAX (test_torch_data_parallel.py's limit)
SELF_RTOL = 1e-5   # the port against itself at another grid
BIAS_TOL = 2e-3    # zero-initialised parameters: of their update
METRICS = ("loss", "denoising_loss", "total_loss", "grad_norm")


def tp_cfgs(dropout: float = 0.0, remat=None):
    """(JAX Vid2SeqConfig, port Vid2SeqConfig): vocabulary 256 (156 text +
    100 time tokens), every width divisible by 4; ``remat`` the T5's."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    def make(m):
        t5 = m.T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                        num_decoder_layers=2, num_heads=4, dropout_rate=dropout,
                        encoder_dropout=dropout, decoder_dropout=dropout, dtype="float32",
                        remat=remat)
        vit = m.TemporalViTConfig(num_features=8, embed_dim=32, depth=1, num_heads=4,
                                  mlp_dim=128, dtype="float32", drop_rate=dropout,
                                  attn_drop_rate=dropout)
        return m.Vid2SeqConfig(t5=t5, vit=vit, num_bins=100)

    return make(jc), make(tc)


def _rows(rng, b: int, s: int, out: int, den_in: int = 16, den_out: int = 8, t: int = 8):
    """``b`` rows with padded inputs and targets of unequal lengths."""
    def tokens(n, cut):
        x = rng.integers(3, 256, size=(b, n)).astype(np.int32)
        for i in range(b):
            x[i, n - cut * (i % 3):] = 0
        return x

    return {"video": rng.normal(size=(b, t, 32)).astype(np.float32),
            "input_tokens": tokens(s, 5), "output_tokens": tokens(out, 3),
            "denoising_input_tokens": tokens(den_in, 4),
            "denoising_output_tokens": tokens(den_out, 2)}


def _port_steps(cfg, state_dict, optim, batches, out_dir=None, upto=None, restore=None):
    """The port's one-process steps; ``(metrics, params after each step)``.
    ``out_dir``: save ``last`` after the first step there."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.train import dvc_train as t
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    model = Vid2Seq(cfg)
    model.load_state_dict(state_dict)
    state = t.TrainState(model, build_optimizer(optim, 10, model.parameters()))
    if restore:
        CheckpointManager(restore).restore("last", state)
    step = t.make_train_step(model)
    metrics, params = [], []
    for rows in batches[state.step:upto]:
        m = step(state, t.batch_to_device(rows, "cpu"), 0)
        metrics.append({k: float(v) for k, v in m.items()})
        params.append({k: v.clone() for k, v in model.state_dict().items()})
        if out_dir is not None and state.step == 1:
            CheckpointManager(out_dir).save_last(state, 0)
    return metrics, params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Writes the inputs and a 1 x 1 checkpoint, starts the two launches and
    returns ``(inputs, wait)``; ``wait()`` gives each launch's ranks."""
    from vidchapters_tpu_torch import config as tc

    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(5)
    jcfg, tcfg = tp_cfgs()
    _, tdrop = tp_cfgs(0.1)
    _, tplain = tp_cfgs(0.1, remat=False)
    jmodel, params = jax_params(jcfg)
    state = port_model(tcfg, params).state_dict()
    batches = {"short": [_rows(rng, 4, 20, 12) for _ in range(2)],
               "long": [_rows(rng, 4, 520, 96) for _ in range(2)]}
    optim = tc.OptimConfig(**VID2SEQ_OPTIM)
    one = _port_steps(tdrop, state, optim, batches["short"], out_dir=tmp / "one_ckpt")

    def case(name, cfg, mp, which, **kw):
        return dict(name=name, cfg=cfg, mp=mp, batches=which, **kw)

    cases = {2: [{"name": "functions"},
                 case("jax_long", "base", 2, "long"),
                 case("drop_long", "drop", 2, "long"),
                 case("drop_long_nosp", "drop", 2, "long", sp=False),
                 case("dp_drop_short", "drop", 1, "short"),
                 case("ckpt_save", "drop", 2, "short", save_after=0),
                 case("ckpt_restore", "drop", 2, "short", restore=str(tmp / "one_ckpt"))],
             4: [{"name": "raises"},
                 case("jax_short", "base", 2, "short"),
                 case("drop_short", "drop", 2, "short"),
                 case("jax_mp4", "base", 4, "short")]}
    torch.save({"cfgs": {"base": tcfg, "drop": tdrop}, "states": {"base": state, "drop": state},
                "optim": optim, "optim_clip": optim, "batches": batches, "cases": cases},
               tmp / "tp_inputs.pt")
    outs = {w: tmp / f"w{w}" for w in (2, 4)}
    procs = {}
    for w, out in outs.items():
        out.mkdir()
        procs[w] = launch([sys.executable, str(HERE / "torch_tp_worker.py"), str(tmp), str(out)],
                          world=w)
    done = {}

    def wait(world):
        if world not in done:
            wait_all(procs[world], timeout=240)
            done[world] = [json.loads((outs[world] / f"rank{r}.json").read_text())
                           for r in range(world)]
        return done[world]

    inputs = {"dir": outs, "jax": (jcfg, jmodel, params), "state": state, "optim": optim,
              "cfgs": {"base": tcfg, "drop": tdrop, "plain": tplain}, "batches": batches,
              "one_short": one,
              "tmp": tmp}
    yield inputs, wait
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


_JAX_REFS = {}


def _jax_steps(inputs, which: str):
    """JAX's jitted steps on the global batches; (metrics, port-named params
    after each step)."""
    if which in _JAX_REFS:
        return _JAX_REFS[which]
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train import dvc_train as jtrain
    from vidchapters_tpu.train.schedules import build_optimizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params

    jcfg, jmodel, params = inputs["jax"]
    tx = build_optimizer(jc.OptimConfig(**VID2SEQ_OPTIM), 10)
    jstate = jtrain.TrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jmodel, tx))
    shell = Vid2Seq(inputs["cfgs"]["base"])
    metrics, after = [], []
    for rows in inputs["batches"][which]:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in rows.items()},
                           jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in jm.items()})
        after.append(from_jax_params(jax.device_get(jstate.params), shell))
    _JAX_REFS[which] = (metrics, after)
    return _JAX_REFS[which]


def _params_close(got: dict, ref: dict, before: dict, rtol: float, lr: float):
    """Each parameter against ``ref`` (key biases apart, ``_key_bias``): from
    a nonzero start within ``rtol`` norm-wise; from zeros (biases, all of it
    Adam's update) the update within ``BIAS_TOL``; one that barely moves in
    ``ref`` (below 1e-2 x lr RMS) barely moves here too."""
    def rms(x):
        return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))

    bad = []
    for name, r in ref.items():
        r = r.numpy()
        keep = ~_key_bias(name, r)
        if not keep.any():
            continue
        g, r, b = got[name].numpy()[keep], r[keep], before[name].numpy()[keep]
        if rms(r - b) < 1e-2 * lr:
            if rms(g - b) >= 1e-2 * lr:
                bad.append(f"{name}: moved {rms(g - b):.2e}, the reference {rms(r - b):.2e}")
            continue
        if b.any():
            err, limit = np.linalg.norm(g - r) / np.linalg.norm(r), rtol
        else:
            err, limit = np.linalg.norm(g - r) / np.linalg.norm(r - b), BIAS_TOL
        if not err < limit:
            bad.append(f"{name}: off by {err:.2e} (limit {limit:.0e})")
    assert not bad, "\n".join(bad)


def _ranks_agree(ranks, name: str):
    """Every rank recorded the same metrics and the same gathered weights."""
    first = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["steps"] == first["steps"], name
        assert r[name]["checksums"] == first["checksums"], name
    return first


def _gathered(inputs, world: int, name: str, step: int) -> dict:
    return torch.load(inputs["dir"][world] / f"{name}_step{step}.pt")


def _spec_paths(tree, prefix=()):
    """``{path: spec as a tuple}`` of a nested dict of PartitionSpecs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_spec_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v)
    return out


def test_param_specs_match_jax():
    """The port's ``infer_param_specs`` leaf by leaf against JAX's
    (``model_parallel=True``) through the name map; each cut against JAX's
    shard of the kernel (transposed); ViT ``qkv``: the port's shard holds
    the rank's heads of each of q, k and v where JAX's holds a contiguous
    run of the packed axis."""
    from vidchapters_tpu.parallel.sharding import infer_param_specs as jax_specs
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import _flatten, _port_name
    from vidchapters_tpu_torch.parallel.sharding import cut, infer_param_specs

    jcfg, tcfg = tp_cfgs()
    _, params = jax_params(jcfg)
    model = Vid2Seq(tcfg)
    ours = infer_param_specs(model, model_parallel=True)
    assert set(infer_param_specs(model).values()) == {()}  # replicated without the axis
    theirs = _spec_paths(jax_specs(params, model_parallel=True))
    leaves = _flatten(params)
    assert {_port_name(k) for k in theirs} == set(ours)
    sharded = 0
    for path, spec in theirs.items():
        name = _port_name(path)
        assert ours[name] == tuple(spec), (name, ours[name], spec)
        if not spec:
            continue
        sharded += 1
        # distinct values of the leaf's shape (a zero bias would hide its layout)
        leaf = torch.randn(np.shape(leaves[path]), generator=torch.Generator().manual_seed(1))
        port = leaf.t() if leaf.dim() == 2 else leaf  # Dense [in, out] -> Linear [out, in]
        jax_axis = list(spec).index("model")
        for r in range(2):
            n = leaf.shape[jax_axis] // 2
            jax_shard = leaf.narrow(jax_axis, r * n, n)
            if "qkv" in name:  # the heads of each of q, k and v
                ours_shard = cut(port, 0, 3, 2, r)
                thirds = leaf.reshape(leaf.shape[:-1] + (3, 2, -1))[..., r, :]
                assert torch.equal(ours_shard, thirds.reshape(leaf.shape[:-1] + (-1,)).t()
                                   if leaf.dim() == 2 else thirds.reshape(-1))
                assert not torch.equal(ours_shard.t() if leaf.dim() == 2 else ours_shard,
                                       jax_shard)
                continue
            if leaf.dim() == 2 and "shared" not in name:  # a Dense kernel
                got, want = cut(port, 1 - jax_axis, 1, 2, r), jax_shard.t()
            else:  # the embedding [vocab, d] and 1-D biases keep their layout
                got, want = cut(leaf, jax_axis, 1, 2, r), jax_shard
            assert torch.equal(got, want), name
    # T5: 2 encoder layers x (q, k, v, o, wi, wo), 2 decoder layers x 10, shared;
    # ViT: qkv weight and bias, proj, fc1 weight and bias, fc2
    assert sharded == 2 * 6 + 2 * 10 + 1 + 6


def test_keep_masks_take_a_head_offset():
    """``keep_scale`` / ``_keep_full`` / ``fused_attention_plain`` /
    ``fused_attention_bwd_plain`` / ``dense_keep_scale`` at ``h0``: the
    rank's heads ``[h0, h0 + 2)`` of a 4-head mask are those heads of the
    one-process mask."""
    from vidchapters_tpu_torch.models.t5 import dense_keep_scale
    from vidchapters_tpu_torch.ops import fused_attention as fa

    full = fa._keep_full(77, 2, 4, 16, 64, 0.3, "cpu")
    dense = dense_keep_scale(77, (2, 4, 16, 24), 0.3)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 16, 32, generator=g) for _ in range(3))
    bias = torch.randn(1, 4, 16, 64, generator=g)
    k, v = (torch.randn(2, 4, 64, 32, generator=g) for _ in range(2))
    mask = torch.ones(2, 64, dtype=torch.int32)
    dout = torch.randn(2, 4, 16, 32, generator=g)
    out = fa.fused_attention_plain(q, k, v, bias, mask, 77, 0.3)
    grads = fa.fused_attention_bwd_plain(q, k, v, bias, mask, 77, 0.3, out, dout)
    assert 0.6 < float((full > 0).float().mean()) < 0.8
    for h0 in (1, 2):
        hs = slice(h0, h0 + 2)
        assert torch.equal(fa._keep_full(77, 2, 2, 16, 64, 0.3, "cpu", h0), full[:, hs])
        assert torch.equal(dense_keep_scale(77, (2, 2, 16, 24), 0.3, h0=h0, heads=4),
                           dense[:, hs])
        # the same masks; the products may block a batch of 2 heads otherwise
        part = fa.fused_attention_plain(q[:, hs], k[:, hs], v[:, hs], bias[:, hs], mask,
                                        77, 0.3, h0=h0)
        assert torch.allclose(part, out[:, hs], rtol=1e-6, atol=1e-6)
        got = fa.fused_attention_bwd_plain(q[:, hs], k[:, hs], v[:, hs], bias[:, hs], mask,
                                           77, 0.3, out[:, hs], dout[:, hs], h0=h0)
        for a, b in zip(got, grads):
            assert torch.allclose(a, b[:, hs], rtol=1e-6, atol=1e-6)
    assert not torch.equal(fa._keep_full(77, 2, 2, 16, 64, 0.3, "cpu", 0), full[:, 2:])
    other = fa.fused_attention_plain(q[:, 2:], k[:, 2:], v[:, 2:], bias[:, 2:], mask, 77, 0.3)
    assert not torch.allclose(other, out[:, 2:], rtol=1e-3, atol=1e-3)


def test_functions_against_one_process(setup):
    _, wait = setup
    for res in (r["functions"] for r in wait(2)):
        errs = {k: v for k, v in res.items() if not k.startswith("grad_norm_")}
        assert max(v for k, v in errs.items() if k != "reduce_bf16") < 1e-6, errs
        assert errs["reduce_bf16"] == 0.0  # float32 sums of bf16 parts, rounded once
        assert res["grad_norm_value"] > 0.1  # the clip is active
        assert _rel(res["grad_norm_value"], res["grad_norm_expect"]) < 1e-6


@pytest.mark.parametrize("name,world,which", [("jax_long", 2, "long"),
                                              ("jax_short", 4, "short"),
                                              ("jax_mp4", 4, "short")])
def test_step_matches_jax_unsharded(setup, name, world, which):
    """Grids 1 x 2 (520 tokens), 2 x 2 and 1 x 4 against JAX's unsharded
    step at dropout 0: losses and ``grad_norm`` within 2e-5, every gathered
    parameter after each of two steps as ``_params_close``."""
    inputs, wait = setup
    res = _ranks_agree(wait(world), name)
    assert res["sequence_parallel"] and res["grid"] == {"jax_long": [1, 2], "jax_short": [2, 2],
                                                       "jax_mp4": [1, 4]}[name]
    ref, ref_params = _jax_steps(inputs, which)
    before = inputs["state"]
    for i, (got, jm) in enumerate(zip(res["steps"], ref)):
        for key in METRICS:
            assert _rel(got[key], jm[key]) < RTOL, (i, key, got[key], jm[key])
        _params_close(_gathered(inputs, world, name, i), ref_params[i], before, RTOL,
                      VID2SEQ_OPTIM["lr"])
    assert len(res["steps"]) == 2


@pytest.mark.parametrize("name,world,ref", [("drop_long", 2, "one_long"),
                                            ("drop_long_nosp", 2, "one_long"),
                                            ("drop_short", 4, "dp_drop_short")])
def test_dropout_step_matches_the_model_axis_of_one(setup, name, world, ref):
    """Dropout on, each T5 block rematerialised: 1 x 2 at 520 tokens (with
    and without sequence parallelism) against one process without remat, 2 x
    2 against 2 x 1: the same masks, so losses, ``grad_norm`` and the
    parameters within 1e-5."""
    inputs, wait = setup
    res = _ranks_agree(wait(world), name)
    assert res["remat"] and res["sequence_parallel"] == (not name.endswith("_nosp"))
    if ref == "one_long":
        if "one_long" not in inputs:
            inputs["one_long"] = _port_steps(inputs["cfgs"]["plain"], inputs["state"],
                                             inputs["optim"], inputs["batches"]["long"])
        metrics, params = inputs["one_long"]
    else:
        other = _ranks_agree(wait(2), ref)
        assert other["grid"] == [2, 1] and not other["sequence_parallel"]
        metrics = other["steps"]
        params = [_gathered(inputs, 2, ref, i) for i in range(2)]
    for i, want in enumerate(metrics):
        for key in METRICS:
            assert _rel(res["steps"][i][key], want[key]) < SELF_RTOL, (i, key)
        _params_close(_gathered(inputs, world, name, i), params[i], inputs["state"], SELF_RTOL,
                      VID2SEQ_OPTIM["lr"])
    # the masks drop something: dropout 0 on the same rows gives another loss
    no_drop = _ranks_agree(wait(world), name.replace("drop", "jax").removesuffix("_nosp")
                           )["steps"][0]["loss"]
    assert abs(res["steps"][0]["loss"] - no_drop) > 1e-3 * no_drop


def test_checkpoints_cross_grids(setup):
    """A checkpoint saved at 1 x 2 (whole, the one-process format) restored
    at 1 x 1, and one saved at 1 x 1 restored at 1 x 2, give the next step
    of the other grid within 1e-5."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    inputs, wait = setup
    ranks = wait(2)
    saved = _ranks_agree(ranks, "ckpt_save")
    ckpt = inputs["dir"][2] / "ckpt_save_ckpt"
    payload = torch.load(ckpt / "last", weights_only=True)
    plain = Vid2Seq(inputs["cfgs"]["drop"])
    plain.load_state_dict(payload["model"])  # the one-process names and shapes
    assert [tuple(m.shape) for m in payload["optimizer"]["mu"]] == [
        tuple(p.shape) for p in plain.parameters()]
    metrics, params = _port_steps(inputs["cfgs"]["drop"], inputs["state"], inputs["optim"],
                                  inputs["batches"]["short"], restore=ckpt)
    assert len(metrics) == 1
    for key in METRICS:
        assert _rel(saved["steps"][1][key], metrics[0][key]) < SELF_RTOL, key
    _params_close(_gathered(inputs, 2, "ckpt_save", 1), params[0], inputs["state"],
                  SELF_RTOL, VID2SEQ_OPTIM["lr"])

    restored = _ranks_agree(ranks, "ckpt_restore")
    one_metrics, one_params = inputs["one_short"]
    assert len(restored["steps"]) == 1
    for key in METRICS:
        assert _rel(restored["steps"][0][key], one_metrics[1][key]) < SELF_RTOL, key
    _params_close(_gathered(inputs, 2, "ckpt_restore", 1), one_params[1], inputs["state"],
                  SELF_RTOL, VID2SEQ_OPTIM["lr"])


def test_create_mesh_raises(setup):
    """A grid the world does not tile, and a model axis that does not
    divide a width (named with its size), raise."""
    from vidchapters_tpu_torch.config import MeshConfig, Vid2SeqConfig
    from vidchapters_tpu_torch.runtime import mesh

    with pytest.raises(ValueError, match="does not tile"):
        mesh.create_mesh(MeshConfig(model_parallel_size=2))
    with pytest.raises(ValueError, match=r"'t5.num_heads': 12.*'vit.num_heads': 12"):
        MeshConfig(model_parallel_size=8).check_widths(Vid2SeqConfig())
    MeshConfig(model_parallel_size=4).check_widths(Vid2SeqConfig())
    _, wait = setup
    for res in (r["raises"] for r in wait(4)):
        assert "'t5.num_heads': 6" in res["heads"], res
        assert "'t5.vocab_size': 254" in res["vocab"], res


def test_sharded_model_refuses_generation():
    """Generation runs on the gathered weights: a sharded model raises."""
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.parallel.sharding import shard_params
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    _, tcfg = tp_cfgs()
    model = shard_params(Vid2Seq(tcfg), mp=2, index=1)
    assert model.t5.shared.weight.shape == (128, 64)
    assert model.visual_encoder.blocks[0].attn.qkv.weight.shape == (48, 32)
    with pytest.raises(ValueError, match="gathered weights"):
        make_generate_fn(model, GenerationConfig())
    with pytest.raises(ValueError, match="sharded already"):
        shard_params(model, mp=2, index=1)
    assert dataclasses.is_dataclass(tcfg)
