"""One rank of the port's tensor-parallel tests (tests/test_torch_tensor_parallel.py).

    VIDCHAPTERS_NUM_PROCESSES=N VIDCHAPTERS_PROCESS_ID=r VIDCHAPTERS_COORDINATOR=host:port \\
        python tests/torch_tp_worker.py INPUT_DIR OUTPUT_DIR

Joins the gloo process group on the CPU and runs, in turn, the cases that
``INPUT_DIR/tp_inputs.pt`` lists for a world of N ranks:

- ``functions`` (N = 2): the sequence collectives, the vocabulary-parallel
  embedding and loss, the time-token renorm and ``ClipAdamW``'s norm over
  the shards, each with its gradients, against its one-process form
  computed here on the whole tensors; their largest differences are
  recorded;
- ``raises`` (N = 4): ``create_mesh`` at widths the model axis does not
  divide;
- train cases: ``create_mesh`` at the case's grid, sequence parallelism on
  when the model axis is above 1 (unless the case has ``sp`` False), T5
  blocks rematerialised as the case's config says, the Vid2Seq weights cut by
  ``shard_params``, then ``make_train_step`` over the case's global
  batches (each data rank its contiguous rows), optionally restoring a
  checkpoint first or saving one after a step. Each step's metrics and the
  checksum of the gathered weights are recorded, and rank 0 writes the
  gathered weights after each step.

Rank r writes ``rank{r}.json`` to ``OUTPUT_DIR``. Imports only the port.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from vidchapters_tpu_torch.config import MeshConfig
from vidchapters_tpu_torch.runtime import mesh


def _err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest difference relative to the largest element of ``ref``."""
    return float((got.detach().float() - ref.detach().float()).abs().max()
                 / ref.detach().float().abs().max().clamp(min=1e-30))


def functions(p) -> dict:
    """Each function on 2 ranks against its one-process form."""
    from vidchapters_tpu_torch.models.t5 import label_smoothed_cross_entropy
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.parallel import tensor_parallel as tp
    from vidchapters_tpu_torch.parallel.sharding import cut, gather_params, shard_params
    from vidchapters_tpu_torch.train.dvc_train import renorm_time_tokens
    from vidchapters_tpu_torch.train.schedules import build_optimizer, global_norm

    mesh.create_mesh(MeshConfig(model_parallel_size=2))
    r, mp = mesh.model_rank(), mesh.model_size()
    g = torch.Generator().manual_seed(11)
    b, l, d = 2, 8, 6
    x = torch.randn(b, l, d, generator=g)
    w = [torch.randn(b, l, d, generator=g) for _ in range(mp)]  # each rank's consumer
    out = {}

    def leaf(t):
        return t.clone().requires_grad_(True)

    # gather into column-sharded products: each rank's own consumer
    xs = leaf(x[:, r * l // mp:(r + 1) * l // mp])
    y = tp.gather_sequence(xs, 1, to_model=True)
    (y * w[r]).sum().backward()
    out["gather_fwd"] = _err(y, x)
    out["gather_bwd"] = _err(xs.grad, sum(w)[:, r * l // mp:(r + 1) * l // mp])
    # gather into a replicated consumer: one loss, the same on every rank
    xs = leaf(x[:, r * l // mp:(r + 1) * l // mp])
    (tp.gather_sequence(xs, 1, to_model=False) * w[0]).sum().backward()
    out["gather_replicated_bwd"] = _err(xs.grad, w[0][:, r * l // mp:(r + 1) * l // mp])
    # scatter of partial sums onto the rank's rows
    parts = [torch.randn(b, l, d, generator=g) for _ in range(mp)]
    ps = leaf(parts[r])
    y = tp.scatter_sequence(ps, 1)
    (y * w[0][:, r * l // mp:(r + 1) * l // mp]).sum().backward()
    out["scatter_fwd"] = _err(y, sum(parts)[:, r * l // mp:(r + 1) * l // mp])
    out["scatter_bwd"] = _err(ps.grad, w[0])
    # copy to the model group, reduce from it
    xc = leaf(x)
    (tp.copy_to_model(xc) * w[r]).sum().backward()
    out["copy_bwd"] = _err(xc.grad, sum(w))
    ps = leaf(parts[r])
    y = tp.reduce_from_model(ps)
    (y * w[0]).sum().backward()
    out["reduce_fwd"] = _err(y, sum(parts))
    out["reduce_bwd"] = _err(ps.grad, w[0])
    # bf16: the sums run in float32
    y = tp.reduce_from_model(parts[r].bfloat16())
    out["reduce_bf16"] = _err(y, sum(p.bfloat16().float() for p in parts).bfloat16())

    # the vocabulary-parallel embedding and loss, vocabulary 12 over 2 ranks
    vocab = 12
    table = torch.randn(vocab, d, generator=g)
    ids = torch.randint(0, vocab, (b, l), generator=g)
    wr = leaf(cut(table, 0, 1, mp, r))
    emb = tp.vocab_parallel_embedding(ids, wr)
    (emb * w[0]).sum().backward()
    full = leaf(table)
    (F.embedding(ids, full) * w[0]).sum().backward()
    out["embedding_fwd"] = _err(emb, F.embedding(ids, table))
    out["embedding_bwd"] = _err(wr.grad, cut(full.grad, 0, 1, mp, r))
    logits = torch.randn(b, l, vocab, generator=g) * 3
    labels = torch.randint(0, vocab, (b, l), generator=g)
    labels[0, -3:] = -100
    zr = leaf(cut(logits, 2, 1, mp, r))
    loss = tp.vocab_parallel_cross_entropy(zr, labels, vocab, 0.1, denom=9)
    loss.backward()
    zf = leaf(logits)
    ref = label_smoothed_cross_entropy(zf, labels, 0.1, denom=9)
    ref.backward()
    out["cross_entropy_fwd"] = _err(loss, ref)
    out["cross_entropy_bwd"] = _err(zr.grad, cut(zf.grad, 2, 1, mp, r))

    # the time-token renorm and the optimizer's norm over the shards
    whole = Vid2Seq(p["cfgs"]["base"])
    whole.load_state_dict(p["states"]["base"])
    sharded = Vid2Seq(p["cfgs"]["base"])
    sharded.load_state_dict(p["states"]["base"])
    shard_params(sharded)
    with torch.no_grad():  # time rows far from the text rows' norm
        whole.t5.shared.weight[-100:] *= 3.0
        sharded.t5.shared.weight.copy_(cut(whole.t5.shared.weight, 0, 1, mp, r))
    nb = p["cfgs"]["base"].num_bins
    renorm_time_tokens(whole, nb)
    renorm_time_tokens(sharded, nb)
    got = gather_params(sharded)["t5.shared.weight"]
    out["renorm"] = _err(got, whole.t5.shared.weight)
    grads = {n: torch.randn(q.shape, generator=g) for n, q in whole.named_parameters()}
    for model in (whole, sharded):
        for n, q in model.named_parameters():
            q.grad = (cut(grads[n], *q.model_cut[:2], mp, r)
                      if getattr(q, "model_cut", None) else grads[n].clone())
    optim = p["optim_clip"]
    norms = [build_optimizer(optim, 10, m.parameters()).step() for m in (whole, sharded)]
    out["grad_norm"] = _err(norms[1], norms[0])
    out["grad_norm_value"] = float(norms[0])
    out["grad_norm_expect"] = float(global_norm(grads.values()))
    after = gather_params(sharded)
    out["clipped_update"] = max(_err(after[n], q) for n, q in whole.state_dict().items())
    return out


def raises(p) -> dict:
    """``create_mesh`` refuses a model axis that does not divide a width."""
    import dataclasses

    cfg = p["cfgs"]["base"]
    out = {}
    for name, bad in (("heads", dataclasses.replace(cfg, t5=dataclasses.replace(
            cfg.t5, num_heads=6, d_kv=8))),
                      ("vocab", dataclasses.replace(cfg, t5=dataclasses.replace(
                          cfg.t5, vocab_size=254)))):
        try:
            mesh.create_mesh(MeshConfig(model_parallel_size=4), bad)
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out


def train(case: dict, p, out_dir: Path) -> dict:
    """The case's steps at its grid (see the module's docstring)."""
    from vidchapters_tpu_torch.models.t5 import uses_remat
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.parallel.sharding import (
        gather_params,
        parameter_checksum,
        shard_params,
    )
    from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.train.dvc_train import (
        TrainState,
        batch_to_device,
        gathered_model,
        make_train_step,
        target_counts,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    cfg = p["cfgs"][case["cfg"]]
    grid = mesh.create_mesh(MeshConfig(model_parallel_size=case["mp"]), cfg)
    sp = mesh.enable_sequence_parallelism(grid) if case.get("sp", True) else False
    model = Vid2Seq(cfg)
    model.load_state_dict(p["states"][case["cfg"]])
    shard_params(model)
    state = TrainState(model, build_optimizer(p["optim"], 10, model.parameters()))
    if case.get("restore"):
        CheckpointManager(case["restore"]).restore("last", state)
    step = make_train_step(model)
    dp, dr = mesh.data_size(), mesh.data_rank()
    steps, sums = [], []
    for rows in p["batches"][case["batches"]][state.step:case.get("steps")]:
        n = len(rows["video"]) // dp
        mine = {k: v[dr * n:(dr + 1) * n] for k, v in rows.items()}
        i = state.step
        m = step(state, batch_to_device(mine, "cpu"), 0, counts=target_counts(mine))
        steps.append({k: float(v) for k, v in m.items()})
        whole = gather_params(model)
        sums.append(parameter_checksum(gathered_model(model)))
        if mesh.is_main_process():
            torch.save(whole, out_dir / f"{case['name']}_step{i}.pt")
        if case.get("save_after") == i:
            CheckpointManager(out_dir / f"{case['name']}_ckpt").save_last(state, 0)
    mesh.disable_sequence_parallelism()
    return {"steps": steps, "checksums": sums, "grid": list(grid), "sequence_parallel": sp,
            "remat": uses_remat(cfg.t5)}


def main(inp: Path, out_dir: Path) -> None:
    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed("cpu", timeout_s=120)
    try:
        p = torch.load(inp / "tp_inputs.pt", weights_only=False)
        result = {}
        for case in p["cases"][mesh.world_size()]:
            if case["name"] == "functions":
                result["functions"] = functions(p)
            elif case["name"] == "raises":
                result["raises"] = raises(p)
            else:
                result[case["name"]] = train(case, p, out_dir)
        (out_dir / f"rank{mesh.rank()}.json").write_text(json.dumps(result))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(Path(sys.argv[1]), Path(sys.argv[2]))
