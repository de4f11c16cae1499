"""The port's data parallelism over two gloo ranks on the CPU, against the
JAX package's step on the global batch.

Two ranks of ``tests/torch_dp_worker.py`` run as subprocesses (after the
pattern of test_multiprocess_rehearsal.py, each with a wall limit of its
own) while this process computes the JAX references:

- the collectives (``all_gather_object``, ``gather_results``,
  ``reduce_dict_mean``, ``is_main_process``, ``global_counts``, the
  parameter broadcast and the gradient all-reduce) against numpy;
- two Vid2Seq steps of ``make_train_step`` over 2 ranks x 2 rows whose
  target-token counts differ, against JAX's ``make_train_step`` on the 4
  rows; and two grounding steps, the ranks' valid spans unequal, against
  JAX's grounding step. The per-rank-mean form (each rank's own means
  through the one-process step, averaged) misses the same limits;
- the rank-folded dropout: masks differ across ranks, repeat, and rank 0's
  are one process's.

At 2+2 layers, d 128 (Vid2Seq) and hidden 32 (grounding), fp32, dropout 0.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from tests._torch_helpers import jax_params, port_model, small_cfgs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RTOL = 2e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """The environment of one rank: the ``VIDCHAPTERS_*`` rendezvous, one
    ``PYTHONHASHSEED`` for all, one torch thread."""
    return dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED="0", OMP_NUM_THREADS="1",
                VIDCHAPTERS_NUM_PROCESSES=str(world), VIDCHAPTERS_PROCESS_ID=str(rank),
                VIDCHAPTERS_COORDINATOR=f"localhost:{port}")


def launch(argv, world: int = 2, cwd=None):
    """Start ``world`` ranks of ``argv``; returns their Popen objects."""
    port = free_port()
    return [subprocess.Popen(argv, env=rank_env(r, world, port), cwd=cwd,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_all(procs, timeout: float):
    """Each rank's output; fails (killing the others) when a rank fails or
    outlasts ``timeout`` seconds."""
    outs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} timed out\n{p.communicate()[0][-3000:]}")
        if p.returncode != 0:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} exited with {p.returncode}\n{out[-3000:]}")
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# inputs


def _vid2seq_rows(rng, out_valid, den_valid, t=16, s=20, out=12, den_in=16, den_out=8):
    """Rows whose output and denoising targets hold ``out_valid`` /
    ``den_valid`` tokens each (the rest padding)."""
    b = len(out_valid)

    def tokens(n, valid):
        x = rng.integers(3, 32100, size=(b, n)).astype(np.int32)
        for i, v in enumerate(valid):
            x[i, v:] = 0
        return x

    return {"video": rng.normal(size=(b, t, 128)).astype(np.float32),
            "input_tokens": tokens(s, [s - 5, s]),
            "output_tokens": tokens(out, out_valid),
            "denoising_input_tokens": tokens(den_in, [den_in, den_in - 4]),
            "denoising_output_tokens": tokens(den_out, den_valid)}


# per step: each rank's (output, denoising) target tokens a row; rank 0 holds
# far fewer than rank 1, so a mean of per-rank means weighs its tokens more
VID2SEQ_COUNTS = [(([3, 5], [2, 3]), ([12, 10], [8, 7])),
                  (([2, 4], [1, 2]), ([11, 12], [8, 8]))]
VID2SEQ_OPTIM = dict(lr=1e-3, weight_decay=0.1, clip_max_norm=0.1, fraction_warmup_steps=0.0,
                     schedule="cosine_with_warmup")


def _grounding_cfgs():
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    kw = dict(hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=64,
              num_queries=5, v_feat_dim=16, t_feat_dim=12, dropout=0.0, input_dropout=0.0)
    return jc.GroundingConfig(**kw), tc.GroundingConfig(**kw)


def _grounding_rows(rng, valid, lv=20, lt=7):
    """Two rows with ``valid`` target spans each (of 3 slots)."""
    b = len(valid)
    vid_mask = np.ones((b, lv), np.int32)
    vid_mask[0, -5:] = 0
    txt_mask = np.ones((b, lt), np.int32)
    txt_mask[1, -2:] = 0
    spans = np.zeros((b, 3, 2), np.float32)
    span_valid = np.zeros((b, 3), np.int32)
    for i, n in enumerate(valid):
        spans[i, :n, 0] = rng.uniform(0.2, 0.8, size=n)
        spans[i, :n, 1] = rng.uniform(0.05, 0.3, size=n)
        span_valid[i, :n] = 1
    return {"query_feat": rng.normal(size=(b, lt, 12)).astype(np.float32),
            "query_mask": txt_mask,
            "video_feat": rng.normal(size=(b, lv, 16)).astype(np.float32),
            "video_mask": vid_mask, "spans": spans, "span_valid": span_valid,
            "saliency_pos_labels": rng.integers(0, 10, size=(b, 2)).astype(np.int64),
            "saliency_neg_labels": rng.integers(10, 15, size=(b, 2)).astype(np.int64)}


GROUNDING_VALID = [([1, 1], [3, 2]), ([1, 0], [3, 3])]
GROUNDING_OPTIM = dict(lr=1e-3, weight_decay=1e-4, lr_drop_step=1, steps_per_epoch=1)


def _global(rows):
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# the two ranks and the JAX references


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Writes the inputs, starts the two ranks and returns
    ``(inputs, wait)``; ``wait()`` gives each rank's result."""
    from vidchapters_tpu.models.grounding import MomentDETR as JMomentDETR
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.models.weights import grounding_from_jax_params

    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(3)
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg)
    v_batches = [[_vid2seq_rows(rng, *c) for c in step] for step in VID2SEQ_COUNTS]
    torch.save({"cfg": tcfg, "state": port_model(tcfg, params).state_dict(),
                "optim": tc.OptimConfig(**VID2SEQ_OPTIM), "batches": v_batches},
               tmp / "vid2seq.pt")

    gj, gt = _grounding_cfgs()
    g_batches = [[_grounding_rows(rng, v) for v in step] for step in GROUNDING_VALID]
    first = g_batches[0][0]
    gmodel = JMomentDETR(gj)
    gparams = jax.device_get(jax.jit(lambda k: gmodel.init(
        k, *(jnp.asarray(first[f]) for f in ("query_feat", "query_mask", "video_feat",
                                             "video_mask"))))(jax.random.PRNGKey(0))["params"])
    port_g = MomentDETR(gt)
    port_g.load_state_dict(grounding_from_jax_params(gparams, port_g))
    torch.save({"cfg": gt, "state": port_g.state_dict(), "optim": GROUNDING_OPTIM,
                "batches": g_batches}, tmp / "grounding.pt")

    procs = launch([sys.executable, str(HERE / "torch_dp_worker.py"), str(tmp), str(tmp)])
    done = {}

    def wait():
        if not done:
            wait_all(procs, timeout=240)
            done["ranks"] = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        return done["ranks"]

    inputs = {"dir": tmp, "vid2seq": (jcfg, jmodel, params, v_batches),
              "grounding": (gj, gmodel, gparams, g_batches)}
    yield inputs, wait
    for p in procs:
        if p.poll() is None:
            p.kill()


def _per_rank_mean(path, which: str) -> dict:
    """The first step's metrics in the per-rank-mean form: each rank's rows
    through the port's one-process step (each rank's own means) from the
    saved weights, the metrics and the gradients averaged over the ranks."""
    from vidchapters_tpu_torch.train.schedules import global_norm

    p = torch.load(path, weights_only=False)
    metrics, grads = [], []
    for rows in p["batches"][0]:
        if which == "vid2seq":
            from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
            from vidchapters_tpu_torch.train import dvc_train as t
            from vidchapters_tpu_torch.train.schedules import build_optimizer

            model = Vid2Seq(p["cfg"])
            state = t.TrainState(model, build_optimizer(p["optim"], 10, model.parameters()))
            step, batch = t.make_train_step(model), t.batch_to_device(rows, "cpu")
        else:
            from vidchapters_tpu_torch.models.grounding import MomentDETR
            from vidchapters_tpu_torch.train import grounding_train as t

            model = MomentDETR(p["cfg"])
            state = t.GroundingTrainState(model, t.build_grounding_optimizer(
                model.parameters(), **p["optim"]))
            step = t.make_grounding_train_step(model, None, p["cfg"])
            batch = t.grounding_batch_to_device(rows, "cpu")
        model.load_state_dict(p["state"])
        metrics.append({k: float(v) for k, v in step(state, batch, 0).items()})
        grads.append([q.grad if q.grad is not None else torch.zeros_like(q)
                      for q in model.parameters()])
    out = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
    out["grad_norm"] = float(global_norm([sum(g) / len(g) for g in zip(*grads)]))
    return out


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _key_bias(name: str, r: np.ndarray) -> np.ndarray:
    """The key bias's slice of a bias (a ``k.bias``, or the middle third of
    a fused ``qkv.bias``), else an empty slice. Its gradient is 0 exactly (a
    bias on every key shifts a query's scores by one constant), so both
    packages update it by Adam's ratio of fp32 rounding noise."""
    if name.endswith(".k.bias"):
        return np.ones(r.shape, bool)
    mask = np.zeros(r.shape, bool)
    if name.endswith("qkv.bias"):
        d = r.shape[0] // 3
        mask[d:2 * d] = True
    return mask


def _params_close(got: dict, ref: dict, before: dict, lr: float):
    """Each parameter after the steps against JAX's, key biases apart
    (``_key_bias``):

    - moved by more than 1e-2 x lr (RMS) in JAX, from a nonzero start:
      within ``RTOL`` of JAX's, norm-wise relative to itself;
    - moved so, from zeros (biases; all of it is Adam's update, a ratio that
      turns fp32 rounding in a near-cancelling gradient element into a large
      share of that element's update): the update within 2e-3 of JAX's,
      norm-wise, the limit of the one-process step against JAX
      (test_torch_train.py);
    - moved less (no gradient reaches it: weight decay or rounding noise
      only): moved less here too."""
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
                bad.append(f"{name}: moved {rms(g - b):.2e}, JAX's {rms(r - b):.2e}")
            continue
        if b.any():
            err = np.linalg.norm(g - r) / np.linalg.norm(r)
            limit = RTOL
        else:
            err = np.linalg.norm(g - r) / np.linalg.norm(r - b)
            limit = 2e-3
        if not err < limit:
            bad.append(f"{name}: off JAX's by {err:.2e} (limit {limit:.0e})")
    assert not bad, "\n".join(bad)


def test_collectives_against_numpy(setup):
    _, wait = setup
    ranks = [r["collectives"] for r in wait()]
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["world"] == 2
        assert res["is_main"] == (r == 0)
        assert res["gathered"] == [{"rank": 0, "items": [0, 1]}, {"rank": 1, "items": [0, 1, 2]}]
        assert res["merged"] == {"v0": 0, "v1": 1, "shared": 1}  # the later rank wins
        expect = np.array([[1.0, 0.5], [2.0, 10.5]], np.float32).mean(0)
        np.testing.assert_array_equal([res["mean"]["a"], res["mean"]["b"]], expect)
        assert res["counts"] == [1 + 2, 0 + 3]
        assert res["broadcast"] == [[[1.0] * 3] * 2, [0.0, 0.0]]  # rank 0's
        assert res["reduced_grads"] == [[[3.0] * 3] * 2, [0.0, 0.0]]  # 1 + 2; None as 0


def test_dropout_masks_fold_in_the_rank(setup):
    """Masks differ across ranks, repeat within one, and rank 0's are the
    masks one process draws: ``SeedSequence([seed, step])``."""
    _, wait = setup
    r0, r1 = (r["collectives"] for r in wait())
    for res in (r0, r1):
        assert res["masks"][0] == res["masks"][1] and res["seed32"][0] == res["seed32"][1]
    assert r0["masks"][0] != r1["masks"][0] and r0["seed32"][0] != r1["seed32"][0]
    torch_seed, host_seed = np.random.SeedSequence([5, 3]).generate_state(2, np.uint64)
    gen = torch.Generator().manual_seed(int(torch_seed))
    assert r0["masks"][0] == (torch.rand((64,), generator=gen) < 0.5).tolist()
    assert r0["seed32"][0] == int(np.random.default_rng(int(host_seed)).integers(
        0, 2**32, dtype=np.uint64))


def test_vid2seq_step_is_the_global_batch_step(setup):
    """Loss, denoising loss, total, ``grad_norm`` (clip active) and every
    parameter after two steps within 2e-5 of JAX's step on the 4 rows; the
    per-rank-mean form misses the limit; both ranks hold the same
    parameters bit for bit."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train import dvc_train as jtrain
    from vidchapters_tpu.train.schedules import build_optimizer
    from vidchapters_tpu_torch.models.weights import from_jax_params

    inputs, wait = setup
    jcfg, jmodel, params, batches = inputs["vid2seq"]
    tx = build_optimizer(jc.OptimConfig(**VID2SEQ_OPTIM), 10)
    jstate = jtrain.TrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jmodel, tx))
    ref = []
    for rows in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in _global(rows).items()},
                           jax.random.PRNGKey(0))
        ref.append({k: float(v) for k, v in jm.items()})
    r0, r1 = (r["vid2seq"] for r in wait())
    assert r0 == r1 and r0["optimizer_count"] == 2
    assert r0["needs_counts"]  # a step without the host batch's counts raises
    for i, (got, jm) in enumerate(zip(r0["steps"], ref)):
        for key in ("loss", "denoising_loss", "total_loss", "grad_norm"):
            assert _rel(got[key], jm[key]) < RTOL, (i, key, got[key], jm[key])
        assert got["grad_norm"] > 0.1  # the clip is active
    naive = _per_rank_mean(inputs["dir"] / "vid2seq.pt", "vid2seq")
    for key in ("loss", "denoising_loss", "total_loss", "grad_norm"):  # misses the limit
        assert _rel(naive[key], ref[0][key]) > RTOL, key

    tmp = inputs["dir"]
    p0, p1 = (torch.load(tmp / f"vid2seq_rank{r}.pt") for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    model = torch.load(tmp / "vid2seq.pt", weights_only=False)
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    shell = Vid2Seq(model["cfg"])
    _params_close(p0, from_jax_params(jax.device_get(jstate.params), shell), model["state"],
                  VID2SEQ_OPTIM["lr"])


def test_grounding_step_is_the_global_batch_step(setup):
    """Every loss term, ``total``, ``grad_norm`` and every parameter after
    two steps within 2e-5 of JAX's grounding step on the 4 rows, with
    unequal valid spans a rank; the per-rank-mean form misses it."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu.train import grounding_train as jg
    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.models.weights import grounding_from_jax_params

    inputs, wait = setup
    gcfg, gmodel, params, batches = inputs["grounding"]
    tx = jg.build_grounding_optimizer(**GROUNDING_OPTIM)
    jstate = jg.GroundingTrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax.jit(jg.make_grounding_train_step(gmodel, None, None, tx, gcfg))
    ref = []
    for rows in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in _global(rows).items()},
                           jax.random.PRNGKey(0))
        ref.append({k: float(v) for k, v in jm.items()})
    r0, r1 = (r["grounding"] for r in wait())
    assert r0 == r1 and r0["needs_counts"]  # a step without the span count raises
    for i, (got, jm) in enumerate(zip(r0["steps"], ref)):
        assert set(got) == set(jm)
        for key, v in jm.items():
            assert _rel(got[key], v) < RTOL, (i, key, got[key], v)
    naive = _per_rank_mean(inputs["dir"] / "grounding.pt", "grounding")
    for key in ("loss_span", "loss_giou", "total", "grad_norm"):  # misses the limit
        assert _rel(naive[key], ref[0][key]) > RTOL, key

    tmp = inputs["dir"]
    p0, p1 = (torch.load(tmp / f"grounding_rank{r}.pt") for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    saved = torch.load(tmp / "grounding.pt", weights_only=False)
    shell = MomentDETR(saved["cfg"])
    _params_close(p0, grounding_from_jax_params(jax.device_get(jstate.params), shell),
                  saved["state"], GROUNDING_OPTIM["lr"])


def test_one_process_and_what_raises(monkeypatch):
    """One process: no group, rank 0, the identities; a model axis that one
    rank cannot tile raises; NCCL on the CPU and CUDA without a card raise
    before any rendezvous; a rendezvous nobody answers raises at its
    timeout and leaves no group; NCCL ranks over several hosts reach the
    rendezvous, each on its card."""
    from vidchapters_tpu_torch.config import MeshConfig
    from vidchapters_tpu_torch.parallel.sharding import global_count
    from vidchapters_tpu_torch.runtime import collectives, mesh

    monkeypatch.delenv("VIDCHAPTERS_NUM_PROCESSES", raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)
    assert mesh.create_mesh(MeshConfig()) == (1, 1)
    assert collectives.all_gather_object({"a": 1}) == [{"a": 1}]
    assert collectives.reduce_dict_mean({"a": 2.5}) == {"a": 2.5}
    assert global_count(7) == 7
    with pytest.raises(ValueError, match="a world of 1 rank.* does not tile a grid with "
                                         "model axis 2"):
        mesh.create_mesh(MeshConfig(model_parallel_size=2))
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        mesh.maybe_initialize_distributed("cpu", backend="nccl", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError):
        mesh.maybe_initialize_distributed("cpu", num_processes=2, process_id=1,
                                          coordinator=f"localhost:{free_port()}", timeout_s=1)
    assert not mesh.distributed()

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.maybe_initialize_distributed("cuda", num_processes=2, process_id=0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.rank_device(None)

    # 16 NCCL ranks over two hosts of 8 cards: rank 11 takes card 3 and meets
    # the others; the world size is not held against this host's cards
    calls = {}
    monkeypatch.setattr(mesh, "_host_group", None)  # restored at teardown
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(mesh.dist, "new_group", lambda **kw: "host")
    assert mesh.maybe_initialize_distributed("cuda", num_processes=16, process_id=11,
                                             coordinator="node0:29500")
    assert (calls["card"], calls["backend"], calls["world_size"], calls["rank"],
            calls["init_method"]) == (3, "nccl", 16, 11, "tcp://node0:29500")
    assert mesh.host_group() == "host"
