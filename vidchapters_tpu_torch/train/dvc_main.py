"""DVC / chapter-generation training and evaluation entry point (dvc.py).

Counterpart of ``vidchapters_tpu/train/dvc_main.py`` (the reference's
dvc.py:243-475): build the tokenizer, datasets, model and
optimizer; train epoch by epoch; evaluate on val every
``eval_every_epochs`` and keep the ``best`` checkpoint by CIDEr; save
``last`` for resume; write ``log.txt`` (one JSON line per epoch) and the
val predictions; then evaluate the ``best`` weights on the test split (val
when there is none).

    python -m vidchapters_tpu_torch.train.dvc_main --config exp.json [--eval]
        [--load CKPT] [--device cuda|cpu] [--dist-backend nccl|gloo]

Over N processes (ranks), one launched per rank with
``VIDCHAPTERS_NUM_PROCESSES=N``, ``VIDCHAPTERS_PROCESS_ID=r`` and
``VIDCHAPTERS_COORDINATOR=host:port`` (``runtime/mesh.py``): NCCL with a
card a rank by default, gloo on the CPU or for ranks sharing a card. The
ranks form the ``(data, model)`` grid of ``cfg.train.mesh``: at
``model_parallel_size`` mp > 1 the model is sharded over each group of mp
ranks (Megatron tensor parallelism, the T5 encoder's residual stream
sharded over the sequence, ``parallel/sharding.py``), and N / mp data
ranks each hold a replica. ``cfg.train.batch_size`` is the rows of one
data rank, as it is of one JAX process: each data rank reads its strided
shard of the epoch's order (the ranks of a model group read the same
rows), the train step is that of the global batch (``train/dvc_train.py``),
the val eval decodes each rank's shard of the videos on the gathered
weights and gathers, and the final eval runs whole on every rank. Rank 0
alone writes ``log.txt``, the predictions and the checkpoints (whole, as
one process's: a run resumes at another grid); every rank resumes.

``htm`` (HowTo100M pretraining, ``configs/htm_pretrain.json``) has a train
set only: no eval, no ``best``, ``last`` and ``log.txt`` each epoch, and
``main`` returns ``{}``. ``--load`` takes a checkpoint of this module, a
reference ``.pth`` (``models/torch_import.py``) or the JAX package's
checkpoint in npz form (``runtime/jax_checkpoint.py``; its params only, as
the JAX package's ``--load`` restores them). ``profile_dir`` writes a
``torch.profiler`` trace of the same steps the JAX package profiles.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from vidchapters_tpu_torch.config import ExperimentConfig, default_dataset_paths
from vidchapters_tpu_torch.data.dvc_dataset import (
    DenseVideoCaptioningDataset,
    EpochIterator,
    YTPretrainDataset,
)
from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
from vidchapters_tpu_torch.models import torch_import
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.models.weights import from_jax_params
from vidchapters_tpu_torch.parallel.sharding import (
    broadcast_parameters,
    replicas_agree,
    shard_params,
)
from vidchapters_tpu_torch.runtime import jax_checkpoint, mesh
from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
from vidchapters_tpu_torch.runtime.meters import MetricLogger
from vidchapters_tpu_torch.train.dvc_train import (
    TrainState,
    batch_to_device,
    evaluate,
    gathered_model,
    make_train_step,
    target_counts,
)
from vidchapters_tpu_torch.train.schedules import build_optimizer


def build_datasets(cfg: ExperimentConfig, tokenizer):
    """``(train, val, test)``: ``[(name, dataset)]`` and ``[(name, dataset,
    reference json)]`` for each of ``cfg.combine_datasets``."""
    train_sets, val_sets, test_sets = [], [], []
    for name in cfg.combine_datasets:
        # explicit per-dataset paths win; else the reference's standard layout
        paths = cfg.datasets.get(name) or default_dataset_paths(cfg.paths, name)
        if name == "htm":  # pretraining: a train set only
            train_sets.append((name, YTPretrainDataset.from_csv(
                paths.train_json_path, paths.features_path, tokenizer,
                paths.subtitles_path, cfg.data)))
            continue

        def make(json_path):
            return DenseVideoCaptioningDataset(json_path, paths.features_path, tokenizer,
                                               cfg.data, subtitles_path=paths.subtitles_path)

        train_sets.append((name, make(paths.train_json_path)))
        val_sets.append((name, make(paths.val_json_path), paths.val_json_path))
        if paths.test_json_path:
            test_sets.append((name, make(paths.test_json_path), paths.test_json_path))
    return train_sets, val_sets, test_sets


def _load_weights(model: Vid2Seq, load: str) -> None:
    """``--load``: the model weights of a checkpoint this module wrote, of a
    reference ``.pth`` (through ``models/torch_import``), or of the JAX
    package's npz checkpoint: its params, not its moments or step."""
    if jax_checkpoint.is_jax_npz(load):
        model.load_state_dict(from_jax_params(jax_checkpoint.read_params(load), model))
        print(f"imported the params of JAX checkpoint {load}")
        return
    payload = torch_import.load_payload(load)
    if torch_import.load_reference_weights(payload, model):
        print(f"imported reference checkpoint {load}")
    elif isinstance(payload, dict) and "model" in payload and "optimizer" in payload:
        model.load_state_dict(payload["model"])
    else:
        raise ValueError(f"{load} is neither a checkpoint of train/dvc_main nor a "
                         f"reference Vid2Seq .pth nor a JAX npz checkpoint")


def main(cfg: ExperimentConfig, load: str = "", eval_only: bool = False,
         device: "str | torch.device | None" = None) -> Dict[str, float]:
    """Train and evaluate as configured; returns the final eval's metrics,
    ``{f"{dataset}_{metric}": value}``. ``load``: start from the weights of
    that checkpoint (and evaluate them, not ``best``, at the end).
    ``eval_only``: no training, only the final eval. ``device``: CUDA unless
    the caller asks for the CPU (a rank's own card when the process group
    has several ranks); raises when CUDA is absent."""
    device = mesh.rank_device(device)
    grid = mesh.create_mesh(cfg.train.mesh, cfg.model)
    mesh.enable_sequence_parallelism(grid)  # at a model axis above 1, as dryrun_multichip
    shards = dict(num_shards=mesh.data_size(), shard_index=mesh.data_rank())  # training
    eval_shards = dict(num_shards=mesh.world_size(), shard_index=mesh.rank())
    tok_path = cfg.tokenizer_path
    if not tok_path and cfg.paths.presave_dir:
        cand = Path(cfg.paths.presave_dir) / "t5-base" / "spiece.model"
        tok_path = str(cand) if cand.exists() else ""
    tokenizer = build_tokenizer(tok_path, num_bins=cfg.model.num_bins)
    train_sets, val_sets, test_sets = build_datasets(cfg, tokenizer)
    d = cfg.data

    model = Vid2Seq(cfg.model).init_weights(torch.Generator().manual_seed(cfg.train.seed))
    model.to(device)
    if load:
        print(f"loading checkpoint {load}")
        _load_weights(model, load)
    print(f"number of params: {sum(p.numel() for p in model.parameters())}")  # dvc.py:339-341
    shard_params(model)  # this rank's slices at a model axis above 1
    broadcast_parameters(model)  # every replica starts from data rank 0's weights

    steps_per_epoch = sum(len(EpochIterator(ds, cfg.train.batch_size, d, **shards))
                          for _, ds in train_sets)
    optimizer = build_optimizer(cfg.train.optim, steps_per_epoch * cfg.train.epochs,
                                model.parameters())
    train_step = make_train_step(model, generative=cfg.train.generative,
                                 denoising=cfg.train.denoising, genasr=cfg.train.genasr)
    state = TrainState(model, optimizer)
    cc = cfg.train.checkpoint
    save_dir = cc.save_dir or str(Path(tempfile.gettempdir()) / "vidchapters_ckpt")
    ckpt = CheckpointManager(save_dir, best_metric=cc.best_metric, best_mode=cc.best_mode,
                             save_every_epochs=cc.save_every_epochs,
                             keep_last=cc.keep_last, keep_best=cc.keep_best)
    if ckpt.has("last") and not load:  # resume (dvc.py:354-361)
        ckpt.restore("last", state)
        print(f"resumed from epoch {ckpt.meta('last').get('epoch')}")

    log_path = ckpt.dir / "log.txt"
    start_epoch = int(ckpt.meta("last").get("epoch", -1)) + 1
    for epoch in range(start_epoch, start_epoch if eval_only else cfg.train.epochs):
        logger = MetricLogger()
        for name, ds in train_sets:
            it = EpochIterator(ds, cfg.train.batch_size, d, seed=cfg.train.seed, **shards)
            it.set_epoch(epoch)

            def drain(pending_metrics):
                """Read a finished step's metrics; the NaN stop (dvc.py:107-110)
                fires one step late."""
                vals = {k: float(v) for k, v in pending_metrics.items()}
                logger.update(**vals)
                if not np.isfinite(vals["total_loss"]):
                    raise RuntimeError("Loss is not finite, stopping training")

            # one-step-delayed metric read: step i-1's values are fetched after
            # step i is queued, so the host's batch preparation overlaps the
            # device's work instead of waiting for it
            pending = None
            prof = None
            for step_i, batch in enumerate(logger.log_every(
                    it, cfg.train.print_freq, f"Epoch [{epoch}] {name}")):
                if (cfg.train.profile_dir and epoch == 0
                        and step_i == cfg.train.profile_start):
                    prof = torch.profiler.profile()
                    prof.start()
                metrics = train_step(state, batch_to_device(batch, device), cfg.train.seed,
                                     counts=target_counts(batch))
                if pending is not None:
                    drain(pending)
                pending = metrics
                if prof is not None and (step_i == cfg.train.profile_start
                                         + cfg.train.profile_steps):
                    prof.stop()
                    out = Path(cfg.train.profile_dir)
                    out.mkdir(parents=True, exist_ok=True)
                    suffix = f"_r{mesh.rank()}" if mesh.world_size() > 1 else ""
                    prof.export_chrome_trace(str(out / f"trace_e{epoch}{suffix}.json"))
                    print(f"profile written to {out}")
                    prof = None
            if prof is not None:  # the epoch ended inside the window
                prof.stop()
            if pending is not None:
                drain(pending)

        epoch_stats = {f"train_{k}": v for k, v in logger.global_averages().items()}
        if (epoch + 1) % cfg.train.eval_every_epochs == 0:
            whole = gathered_model(model)
            for name, ds, ref_path in val_sets:
                it = EpochIterator(ds, cfg.train.eval_batch_size, d, shuffle=False,
                                   drop_last=False, bucket_inputs=True, **eval_shards)
                preds, metrics = evaluate(whole, it, tokenizer, cfg.generation,
                                          cfg.model.num_bins, references=[ref_path])
                epoch_stats.update({f"{name}_{k}": v for k, v in metrics.items()})
                if mesh.is_main_process():
                    with open(ckpt.dir / f"{name}_val_preds_e{epoch}.json", "w") as f:
                        json.dump({"results": preds}, f)
                ckpt.maybe_save_best(state, epoch, metrics)
            del whole

        last_every = max(1, cfg.train.checkpoint.save_last_every_epochs)
        if (epoch + 1) % last_every == 0 or epoch == cfg.train.epochs - 1:
            ckpt.save_last(state, epoch)
        if mesh.is_main_process():
            with open(log_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **epoch_stats}) + "\n")

    whole = gathered_model(model)
    if mesh.distributed():  # raises unless every rank holds the same (gathered) weights
        print(f"rank {mesh.rank()}: parameters identical on {mesh.world_size()} ranks "
              f"(checksum {replicas_agree(whole)})")

    # the final eval with the best weights, on test when configured, else val
    # (dvc.py:447-464), whole on every rank as JAX's; with --load, the loaded
    # weights
    final_metrics: Dict[str, float] = {}
    if ckpt.has("best") and not load:
        ckpt.restore("best", state)
        whole = gathered_model(model)
    for name, ds, ref_path in (test_sets or val_sets):
        it = EpochIterator(ds, cfg.train.eval_batch_size, d, shuffle=False,
                           drop_last=False, bucket_inputs=True)
        _, metrics = evaluate(whole, it, tokenizer, cfg.generation, cfg.model.num_bins,
                              references=[ref_path])
        final_metrics.update({f"{name}_{k}": v for k, v in metrics.items()})
    mesh.disable_sequence_parallelism()
    return final_metrics


if __name__ == "__main__":
    import argparse

    from vidchapters_tpu_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="experiment json")
    p.add_argument("--load", default="",
                   help="start from the weights of a checkpoint written by this module, "
                        "of a reference .pth, or of the JAX package's npz checkpoint "
                        "(its params)")
    p.add_argument("--eval", action="store_true",
                   help="skip training; evaluate the loaded or best weights on the test "
                        "(or val) split")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend (VIDCHAPTERS_NUM_PROCESSES ranks; named "
                        "with one, a group of one): nccl (the default on cuda, a card a rank) "
                        "or gloo (the CPU, or ranks sharing a card)")
    a = p.parse_args()
    # the rendezvous of VIDCHAPTERS_NUM_PROCESSES / _PROCESS_ID / _COORDINATOR,
    # before any work
    mesh.maybe_initialize_distributed(a.device, a.dist_backend)
    print(main(load_config(ExperimentConfig, a.config), load=a.load, eval_only=a.eval,
               device=a.device))
    mesh.shutdown()
