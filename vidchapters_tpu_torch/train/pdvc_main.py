"""PDVC training and evaluation entry point (PDVC/train.py and eval.py).

Counterpart of ``vidchapters_tpu/train/pdvc_main.py`` on one GPU: the epoch
loop of the PDVC recipe (AdamW, StepLR every ``lr_drop_epochs``), a val
eval every epoch, ``best`` on METEOR + SODA (train.py:286-289), ``last``
and ``info.json`` (options and metric histories) for resume, the caption
vocab in ``translator.json``; ``eval_main`` scores a saved checkpoint
standalone (the port's own, or the JAX package's in npz form:
``runtime/jax_checkpoint.py``), or runs inference on unlabeled videos (test
mode).

    python -m vidchapters_tpu_torch.train.pdvc_main --recipe configs/chapters_pdvc.json \\
        --save-dir DIR [--eval --load DIR [--test-meta-csv CSV]] [--device cuda|cpu]

The checkpoints hold the whole train state (weights, Adam moments, step),
and a second call resumes from ``last``. (The JAX package saves ``last`` as
``(params,)`` and restores a three-part state from it, which raises:
ROADMAP.md.)
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import PDVCConfig, to_dict
from vidchapters_tpu_torch.data.pdvc_dataset import PDVCDataset, Translator, pdvc_collate
from vidchapters_tpu_torch.models.pdvc import PDVC
from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params
from vidchapters_tpu_torch.runtime import jax_checkpoint
from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
from vidchapters_tpu_torch.runtime.meters import MetricLogger
from vidchapters_tpu_torch.train.pdvc_train import (
    PDVCTrainState,
    build_pdvc_optimizer,
    evaluate_pdvc,
    make_pdvc_infer,
    make_pdvc_train_step,
    pdvc_batch_to_device,
)
from vidchapters_tpu_torch.utils.io import load_json


def scheduled_sampling_prob(epoch: int, start: int = 20, inc_every: int = 5,
                            inc: float = 0.05, max_prob: float = 0.25) -> float:
    """PDVC/train.py:193-197 ramp."""
    if epoch < start:
        return 0.0
    return min(inc * ((epoch - start) // inc_every + 1), max_prob)


def transfer_params(src: Mapping[str, torch.Tensor], tgt: Mapping[str, torch.Tensor],
                    verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Cross-dataset checkpoint surgery (PDVC/train.py:100-125) over state
    dicts: every entry of ``tgt`` whose name and shape ``src`` has comes from
    ``src``; the rest (query count, caption vocab, count-head sizes) keeps
    the target's fresh init."""
    out, skipped = {}, []
    for name, leaf in tgt.items():
        s = src.get(name)
        if s is not None and tuple(s.shape) == tuple(leaf.shape):
            out[name] = s
        else:
            out[name] = leaf
            skipped.append(name)
    if verbose and skipped:
        print(f"transfer_params: kept fresh init for {len(skipped)} leaves "
              f"(e.g. {skipped[:3]})")
    return out


def _batches(ds: PDVCDataset, batch_size: int):
    for s in range(0, len(ds), batch_size):
        yield pdvc_collate([ds[i] for i in range(s, min(s + batch_size, len(ds)))])


def main(train_json: str, val_json: str, features_path, cfg: PDVCConfig, save_dir: str,
         translator: Optional[Translator] = None, n_epochs: int = 5, batch_size: int = 2,
         lr: float = 1e-4, lr_drop_epochs: int = 8, max_events: int = 10, seed: int = 0,
         self_iou: bool = False, device: "str | torch.device | None" = None
         ) -> Dict[str, float]:
    """Train ``n_epochs`` (resuming from ``save_dir/last`` when there is one),
    evaluating on val after each, then evaluate the ``best`` weights on val;
    returns that final eval's metrics."""
    device = resolve_device(device)
    if translator is None:
        translator = Translator.build(
            [s for a in load_json(train_json).values() for s in a["sentences"]])
        if len(translator) > cfg.vocab_size:
            raise ValueError(f"the captions' vocab of {len(translator)} words does not fit "
                             f"the caption head's vocab_size {cfg.vocab_size}")
    train_ds = PDVCDataset(train_json, features_path, translator, cfg, max_events=max_events)
    val_ds = PDVCDataset(val_json, features_path, translator, cfg, max_events=max_events)

    model = PDVC(cfg).init_weights(torch.Generator().manual_seed(seed)).to(device)
    print(f"number of params: {sum(p.numel() for p in model.parameters())}")
    # the caption vocab (the reference's dict_file), so that eval_main can
    # rebuild the exact word <-> id mapping
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    translator.to_json(Path(save_dir) / "translator.json")

    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    optimizer = build_pdvc_optimizer(model.parameters(), lr=lr, lr_drop_step=lr_drop_epochs,
                                     steps_per_epoch=steps_per_epoch)
    train_step = make_pdvc_train_step(model, cfg, self_iou=self_iou)
    infer = make_pdvc_infer(model, cfg)
    state = PDVCTrainState(model, optimizer)
    ckpt = CheckpointManager(save_dir, best_metric="meteor_soda")

    info_path = Path(save_dir) / "info.json"
    histories: List[dict] = []
    start_epoch = 0
    if ckpt.has("last"):  # info.json-style resume (PDVC/train.py:46-60)
        ckpt.restore("last", state)
        start_epoch = int(ckpt.meta("last").get("epoch", -1)) + 1
        if info_path.exists():
            histories = json.loads(info_path.read_text()).get("histories", [])
        print(f"resumed PDVC training at epoch {start_epoch}")
    np_rng = np.random.default_rng(seed)
    for epoch in range(start_epoch, n_epochs):
        logger = MetricLogger()
        order = np_rng.permutation(len(train_ds))
        pending = None  # the step before's loss is read after this step is queued
        for s in range(0, len(order) - batch_size + 1, batch_size):
            batch = pdvc_collate([train_ds[int(i)] for i in order[s:s + batch_size]])
            metrics = train_step(state, pdvc_batch_to_device(batch, device), seed)
            if pending is not None:
                logger.update(loss=float(pending["total"]))
            pending = metrics
        if pending is not None:
            logger.update(loss=float(pending["total"]))

        _, metrics = evaluate_pdvc(infer, _batches(val_ds, batch_size), translator,
                                   references=[val_json])
        # model-best on METEOR + SODA (PDVC/train.py:286-289)
        metrics["meteor_soda"] = metrics.get("METEOR", 0.0) + metrics.get("soda_c", 0.0)
        histories.append({"epoch": epoch, **logger.global_averages(), **metrics})
        ckpt.maybe_save_best(state, epoch, metrics)
        ckpt.save_last(state, epoch)
        info_path.write_text(json.dumps({"opt": to_dict(cfg), "histories": histories},
                                        indent=1))

    if ckpt.has("best"):
        ckpt.restore("best", state)
    _, final_metrics = evaluate_pdvc(infer, _batches(val_ds, batch_size), translator,
                                     references=[val_json])
    return final_metrics


def fake_test_caption_file(meta_csv: str, out_path: str) -> str:
    """Ground truth for unlabeled videos (PDVC/eval.py:28-35): one dummy
    [0, 0.5] "None" event per video of a metadata CSV with ``filename`` /
    ``video-duration`` columns."""
    out = {}
    with open(meta_csv, newline="") as f:
        for row in csv.DictReader(f):
            vid = os.path.basename(row["filename"]).split(".")[0]
            out[vid] = {"duration": float(row["video-duration"]),
                        "timestamps": [[0, 0.5]], "sentences": ["None"]}
    Path(out_path).write_text(json.dumps(out))
    return out_path


def eval_main(load_dir: str, eval_json: str, features_path, cfg: PDVCConfig,
              save_dir: Optional[str] = None, batch_size: int = 2, max_events: int = 10,
              translator: Optional[Translator] = None, test_mode: bool = False,
              alpha: float = 0.3, which: str = "best",
              device: "str | torch.device | None" = None) -> Dict[str, float]:
    """Standalone checkpoint evaluation (PDVC/eval.py:37-117): the weights of
    ``which`` (else ``last``) in ``load_dir``, the port's checkpoint or the
    JAX package's ``{which}.npz`` (its params), inference and reranking over
    ``eval_json``, the submission json written, and its scores, unless
    ``test_mode`` (unlabeled videos against a fake one-event ground truth)."""
    device = resolve_device(device)
    load_path = Path(load_dir)
    name, npz = jax_checkpoint.find(load_path, (which, "last"))
    if translator is None:
        tpath = load_path / "translator.json"
        if not tpath.exists():
            raise FileNotFoundError(f"{tpath} not found: pass translator= for a checkpoint "
                                    f"written without one")
        translator = Translator.from_json(str(tpath))
    val_ds = PDVCDataset(eval_json, features_path, translator, cfg, max_events=max_events)

    model = PDVC(cfg).to(device)
    ckpt = CheckpointManager(str(load_path))
    if npz is not None:
        model.load_state_dict(pdvc_from_jax_params(jax_checkpoint.read_params(npz), model))
    else:
        model.load_state_dict(ckpt.load(name, map_location=device)["model"])
    epoch = int(ckpt.meta(name).get("epoch", -1))
    print(f"loaded PDVC '{name}' checkpoint (epoch {epoch}) from {load_dir}")

    results, metrics = evaluate_pdvc(make_pdvc_infer(model, cfg), _batches(val_ds, batch_size),
                                     translator, alpha=alpha,
                                     references=None if test_mode else [eval_json])
    out_dir = Path(save_dir or load_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_name = ("dvc_results.json" if test_mode
                else f"eval_epoch{epoch}_num{len(val_ds)}_alpha{alpha}.json")
    (out_dir / out_name).write_text(json.dumps({"results": results}))
    print(f"saved results json to {out_dir / out_name}")
    return metrics


def _cli(argv=None) -> None:
    import argparse
    import dataclasses

    from vidchapters_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description="PDVC dense-captioning training")
    p.add_argument("--recipe", default=None,
                   help="recipe json with model/train/data sections (e.g. "
                        "configs/chapters_pdvc.json); explicit flags override it")
    p.add_argument("--train-json", default=None)
    p.add_argument("--val-json", default=None)
    p.add_argument("--features-path", default=None)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--config", default=None, help="PDVCConfig json (defaults if omitted)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-drop-epochs", type=int, default=8)
    p.add_argument("--max-events", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="standalone evaluation of the checkpoint in --load: no training")
    p.add_argument("--load", default=None,
                   help="checkpoint dir for --eval (a --save-dir of training; restores "
                        "'best', else 'last')")
    p.add_argument("--test-meta-csv", default=None,
                   help="test mode: inference on the unlabeled videos of this metadata CSV "
                        "(filename / video-duration columns), no scoring")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pre, _ = p.parse_known_args(argv)
    recipe = {}
    if pre.recipe:
        recipe = load_json(pre.recipe)
        tr, da = recipe.get("train", {}), recipe.get("data", {})
        p.set_defaults(epochs=tr.get("epochs", 5), batch_size=tr.get("batch_size", 2),
                       lr=tr.get("lr", 1e-4), lr_drop_epochs=tr.get("lr_drop_epochs", 8),
                       max_events=tr.get("max_events", 10), train_json=da.get("train_json"),
                       val_json=da.get("val_json"), features_path=da.get("features_path"))
    a = p.parse_args(argv)
    required = (("val_json", "features_path") if a.eval and not a.test_meta_csv
                else ("features_path",) if a.eval
                else ("train_json", "val_json", "features_path"))
    for req in required:
        if getattr(a, req) is None:
            p.error(f"--{req.replace('_', '-')} required (flag or recipe)")
    if recipe.get("model"):
        cfg = dataclasses.replace(PDVCConfig(), **recipe["model"])
    else:
        cfg = load_config(PDVCConfig, a.config) if a.config else PDVCConfig()
    if a.eval:
        if not a.load:
            p.error("--eval requires --load <checkpoint dir>")
        eval_json = a.val_json
        if a.test_meta_csv:
            Path(a.save_dir).mkdir(parents=True, exist_ok=True)
            eval_json = fake_test_caption_file(a.test_meta_csv,
                                               str(Path(a.save_dir) / ".fake_test.json"))
        print(json.dumps(eval_main(a.load, eval_json, a.features_path, cfg, save_dir=a.save_dir,
                                   batch_size=a.batch_size, max_events=a.max_events,
                                   test_mode=bool(a.test_meta_csv), device=a.device)))
    else:
        print(json.dumps(main(a.train_json, a.val_json, a.features_path, cfg, a.save_dir,
                              n_epochs=a.epochs, batch_size=a.batch_size, lr=a.lr,
                              lr_drop_epochs=a.lr_drop_epochs, max_events=a.max_events,
                              seed=a.seed, device=a.device)))


if __name__ == "__main__":
    _cli()
