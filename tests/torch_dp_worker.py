"""One rank of the port's data-parallel tests (tests/test_torch_data_parallel.py).

    VIDCHAPTERS_NUM_PROCESSES=2 VIDCHAPTERS_PROCESS_ID=r VIDCHAPTERS_COORDINATOR=host:port \\
        python tests/torch_dp_worker.py INPUT_DIR OUTPUT_DIR

Joins the gloo process group on the CPU and runs three cases in turn: the
collectives and the rank-folded dropout (``collectives``), two Vid2Seq train
steps and two grounding train steps over the ranks (``vid2seq``,
``grounding``), their inputs read from ``INPUT_DIR``. Rank r writes
``rank{r}.json`` and its parameters after each case's steps to
``OUTPUT_DIR``. Imports only the port.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from vidchapters_tpu_torch.runtime import mesh


def collectives() -> dict:
    from vidchapters_tpu_torch.parallel.sharding import (
        all_reduce_gradients,
        broadcast_parameters,
        global_counts,
    )
    from vidchapters_tpu_torch.runtime.collectives import (
        all_gather_object,
        gather_results,
        reduce_dict_mean,
    )
    from vidchapters_tpu_torch.runtime.rng import StepRng

    r = mesh.rank()
    out = {"rank": r, "world": mesh.world_size(), "is_main": mesh.is_main_process(),
           "gathered": all_gather_object({"rank": r, "items": list(range(r + 2))}),
           "merged": gather_results({f"v{r}": r, "shared": r}),
           "mean": reduce_dict_mean({"a": float(r + 1), "b": 10.0 * r + 0.5}),
           "counts": global_counts([r + 1, 3 * r])}
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r + 1))
        lin.bias.fill_(-float(r))
    broadcast_parameters(lin)
    out["broadcast"] = [lin.weight.tolist(), lin.bias.tolist()]
    lin.weight.grad = torch.full_like(lin.weight, float(r + 1))  # bias.grad stays None
    all_reduce_gradients(lin.parameters())
    out["reduced_grads"] = [lin.weight.grad.tolist(), lin.bias.grad.tolist()]
    x = torch.zeros(64)
    out["masks"] = [StepRng(5, 3, "cpu", rank=r).keep_mask(x, 0.5).tolist() for _ in range(2)]
    out["seed32"] = [StepRng(5, 3, "cpu", rank=r).seed32() for _ in range(2)]
    return out


def vid2seq(inp: Path, out_dir: Path) -> dict:
    """Two steps of ``make_train_step`` over the ranks on this rank's rows."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.dvc_train import (
        TrainState,
        batch_to_device,
        make_train_step,
        target_counts,
    )
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    p = torch.load(inp / "vid2seq.pt", weights_only=False)
    r = mesh.rank()
    model = Vid2Seq(p["cfg"])
    model.load_state_dict(p["state"])
    state = TrainState(model, build_optimizer(p["optim"], 10, model.parameters()))
    step = make_train_step(model)
    try:  # in a process group the step takes the host batch's counts
        step(state, batch_to_device(p["batches"][0][r], "cpu"), 0)
        needs_counts = False
    except ValueError:
        needs_counts = True
    steps = []
    for rows in p["batches"]:
        m = step(state, batch_to_device(rows[r], "cpu"), 0, counts=target_counts(rows[r]))
        steps.append({k: float(v) for k, v in m.items()})
    torch.save(model.state_dict(), out_dir / f"vid2seq_rank{r}.pt")
    return {"steps": steps, "optimizer_count": state.optimizer.count,
            "needs_counts": needs_counts}


def grounding(inp: Path, out_dir: Path) -> dict:
    """Two steps of ``make_grounding_train_step`` over the ranks."""
    from vidchapters_tpu_torch.models.grounding import MomentDETR
    from vidchapters_tpu_torch.train.grounding_train import (
        GroundingTrainState,
        build_grounding_optimizer,
        grounding_batch_to_device,
        make_grounding_train_step,
        valid_spans,
    )

    p = torch.load(inp / "grounding.pt", weights_only=False)
    r = mesh.rank()
    model = MomentDETR(p["cfg"])
    model.load_state_dict(p["state"])
    state = GroundingTrainState(model, build_grounding_optimizer(model.parameters(),
                                                                 **p["optim"]))
    step = make_grounding_train_step(model, None, p["cfg"])
    try:  # in a process group the step takes the host batch's span count
        step(state, grounding_batch_to_device(p["batches"][0][r], "cpu"), 0)
        needs_counts = False
    except ValueError:
        needs_counts = True
    steps = []
    for rows in p["batches"]:
        m = step(state, grounding_batch_to_device(rows[r], "cpu"), 0,
                 num_spans=valid_spans(rows[r]))
        steps.append({k: float(v) for k, v in m.items()})
    torch.save(model.state_dict(), out_dir / f"grounding_rank{r}.pt")
    return {"steps": steps, "needs_counts": needs_counts}


def main(inp: Path, out_dir: Path) -> None:
    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed("cpu", timeout_s=120)
    try:
        result = {"collectives": collectives(), "vid2seq": vid2seq(inp, out_dir),
                  "grounding": grounding(inp, out_dir)}
        (out_dir / f"rank{mesh.rank()}.json").write_text(json.dumps(result))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(Path(sys.argv[1]), Path(sys.argv[2]))
