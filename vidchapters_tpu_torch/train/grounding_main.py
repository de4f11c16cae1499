"""Chapter-grounding (Moment-DETR) training and evaluation entry point.

Counterpart of ``vidchapters_tpu/train/grounding_main.py`` (the reference's
moment_detr train.py) on one GPU: the epoch loop with AdamW and StepLR, an
eval every ``eval_every`` epochs, early stop when MR-full-mAP has not
improved for ``early_stop_patience`` epochs (train.py:155-179), ``best`` /
``last`` checkpoints and ``log.txt`` (160-208), a final eval with the
``best`` weights (277-288), and a held-out test split whose predictions go
to ``test_preds.jsonl``. Each step's losses are read one step late, so the
host prepares the next batch while the card runs the step.

    python -m vidchapters_tpu_torch.train.grounding_main \\
        --recipe configs/chapters_momentdetr.json --save-dir D \\
        [--train-jsonl T --val-jsonl V --v-feat-dirs F ...] \\
        [--clip-text-ckpt ViT-L-14.pt] [--device cuda|cpu]

``--clip-text-ckpt`` takes OpenAI's released TorchScript archive or a
plain state dict under its names; without it the text tower is one seeded
random layer (smoke mode). With ``use_speech`` and no ``--bert-ckpt`` the
speech tower is one seeded random BERT layer behind a per-process hash
tokenizer (smoke mode). Not ported: ``--bert-ckpt`` (it needs HF's
WordPiece tokenizer; ROADMAP.md §1) and the data-parallel mesh (one
process; ROADMAP.md §1, "More than one GPU").
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import GroundingConfig
from vidchapters_tpu_torch.data.grounding_dataset import GroundingDataset, grounding_collate
from vidchapters_tpu_torch.models.grounding import MomentDETR
from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
from vidchapters_tpu_torch.runtime.meters import MetricLogger
from vidchapters_tpu_torch.train.grounding_train import (
    GroundingTrainState,
    build_grounding_optimizer,
    evaluate_grounding,
    grounding_batch_to_device,
    make_grounding_infer,
    make_grounding_train_step,
)
from vidchapters_tpu_torch.utils.io import load_jsonl


def batches(dataset: GroundingDataset, batch_size: int, max_v_l: int, max_spans: int,
            shuffle: bool, seed: int, text_featurizer=None, speech_featurizer=None,
            max_q_l: int = 32):
    """Collated batches of ``dataset`` (the last partial batch dropped), in a
    ``default_rng(seed)`` shuffle when ``shuffle``. ``text_featurizer``
    adds CLIP ``query_tokens``; ``speech_featurizer`` turns the ASR strings
    into static-shape BERT ids (prepare_batch_inputs,
    start_end_dataset.py:299-306)."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    for s in range(0, len(order) - batch_size + 1, batch_size):
        batch = grounding_collate([dataset[int(i)] for i in order[s:s + batch_size]],
                                  max_v_l, max_spans, max_q_l=max_q_l)
        if text_featurizer is not None:
            batch["query_tokens"] = text_featurizer(batch["query"])
        if speech_featurizer is not None and "speech" in batch:
            batch["speech_tokens"] = speech_featurizer(batch["speech"])
        yield batch


def main(train_jsonl: str, val_jsonl: str, v_feat_dirs: List[str], cfg: GroundingConfig,
         save_dir: str, text_encoder=None, clip_tokenizer=None, n_epochs: int = 50,
         batch_size: int = 32, lr: float = 1e-4, max_spans: int = 5, eval_every: int = 5,
         early_stop_patience: int = 10, seed: int = 0,
         max_train_batches: Optional[int] = None, test_jsonl: Optional[str] = None,
         subtitles_path: Optional[str] = None, speech_encoder=None, speech_tokenizer=None,
         device: "str | torch.device | None" = None) -> Dict[str, float]:
    """Train with evals and early stop, then evaluate the ``best`` weights on
    val (and on ``test_jsonl``); returns the brief metrics (``test_``
    prefixed for the test split when it has ground truth). The towers
    (``text_encoder``, ``speech_encoder``: the port's CLIP text and BERT
    modules) are frozen and moved to ``device``."""
    device = resolve_device(device)
    use_speech = cfg.use_speech and speech_encoder is not None
    ds_kw = dict(max_v_l=cfg.max_v_l, clip_len=cfg.clip_length, use_speech=use_speech,
                 subtitles_path=subtitles_path)
    train_ds = GroundingDataset(train_jsonl, v_feat_dirs, train=True, **ds_kw)
    val_ds = GroundingDataset(val_jsonl, v_feat_dirs, train=False, **ds_kw)
    ground_truth = load_jsonl(val_jsonl)

    towers = [t for t in (text_encoder, speech_encoder) if t is not None]
    for tower in towers:
        tower.to(device).eval().requires_grad_(False)
    if not use_speech:
        speech_encoder = None
    model = MomentDETR(cfg).init_weights(torch.Generator().manual_seed(seed)).to(device)
    print(f"number of params: {sum(p.numel() for p in model.parameters())}")
    tokenize = (lambda qs: np.asarray(clip_tokenizer(qs))) if clip_tokenizer else None
    # static-shape BERT ids for the ASR stream (max_speech_l, start_end_dataset.py:122)
    sp_tok = ((lambda texts: np.asarray(speech_tokenizer(texts, max_length=cfg.speech_max_l)))
              if use_speech and speech_tokenizer is not None else None)

    def eval_batches(ds):
        return batches(ds, min(batch_size, len(ds)), cfg.max_v_l, max_spans, False, 0,
                       tokenize, speech_featurizer=sp_tok, max_q_l=cfg.max_q_l)

    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    optimizer = build_grounding_optimizer(model.parameters(), lr=lr,
                                          steps_per_epoch=steps_per_epoch)
    state = GroundingTrainState(model, optimizer)
    train_step = make_grounding_train_step(model, text_encoder, cfg, speech_encoder)
    infer = make_grounding_infer(model, text_encoder, speech_encoder)
    eval_tokenizer = clip_tokenizer if tokenize is not None else None
    ckpt = CheckpointManager(save_dir, best_metric="MR-full-mAP")

    best_epoch = -1
    log_path = Path(save_dir) / "log.txt"
    for epoch in range(n_epochs):
        logger = MetricLogger()
        pending = None  # the step before's losses are read after this step is queued
        for bi, batch in enumerate(batches(train_ds, batch_size, cfg.max_v_l, max_spans, True,
                                           seed + epoch, tokenize, speech_featurizer=sp_tok,
                                           max_q_l=cfg.max_q_l)):
            if max_train_batches and bi >= max_train_batches:
                break
            metrics = train_step(state, grounding_batch_to_device(batch, device), seed)
            if pending is not None:
                logger.update(loss=float(pending["total"]))
            pending = metrics
        if pending is not None:
            logger.update(loss=float(pending["total"]))
        stats = {"epoch": epoch, **logger.global_averages()}

        if (epoch + 1) % eval_every == 0 or epoch == n_epochs - 1:
            _, metrics = evaluate_grounding(infer, eval_batches(val_ds), ground_truth,
                                            tokenizer=eval_tokenizer)
            stats.update(metrics["brief"])
            if ckpt.maybe_save_best(state, epoch, metrics["brief"]):
                best_epoch = epoch
            elif early_stop_patience > 0 and epoch - best_epoch >= early_stop_patience:
                print(f"early stop at epoch {epoch} (best {best_epoch})")
                ckpt.save_last(state, epoch)
                break
        ckpt.save_last(state, epoch)
        with open(log_path, "a") as f:
            f.write(json.dumps(stats) + "\n")

    if ckpt.has("best"):
        ckpt.restore("best", state)
    _, final_metrics = evaluate_grounding(infer, eval_batches(val_ds), ground_truth,
                                          tokenizer=eval_tokenizer)
    results = dict(final_metrics["brief"])

    # the held-out split with the best weights: predictions always, metrics
    # when the split carries ground-truth windows
    if test_jsonl:
        test_ds = GroundingDataset(test_jsonl, v_feat_dirs, train=False, **ds_kw)
        test_gt = load_jsonl(test_jsonl)
        submission, test_metrics = evaluate_grounding(infer, eval_batches(test_ds), test_gt,
                                                      tokenizer=eval_tokenizer)
        with open(Path(save_dir) / "test_preds.jsonl", "w") as f:
            for row in submission:
                f.write(json.dumps(row) + "\n")
        if any("relevant_windows" in g for g in test_gt):
            results.update({f"test_{k}": v for k, v in test_metrics["brief"].items()})
    return results


def load_clip_text_checkpoint(path: str):
    """The text tower's state dict from OpenAI's released TorchScript
    archive or from a plain state dict under its names
    (``models/clip.load_openai_clip``)."""
    from vidchapters_tpu_torch.models.clip import convert_openai_clip_text, load_openai_clip

    return convert_openai_clip_text(load_openai_clip(path))


def smoke_speech_tower(cfg: GroundingConfig):
    """(tower, tokenizer) of smoke mode: one seeded random BERT layer at
    ``s_feat_dim`` and a hash tokenizer (``hash(word) % (vocab - 1) + 1``;
    Python salts string hashes per process, so the ids are stable within a
    process only, as the JAX module's)."""
    from vidchapters_tpu_torch.models.bert import BertConfig, BertModel

    bcfg = BertConfig(hidden_size=cfg.s_feat_dim, num_layers=1,
                      num_heads=next(h for h in (12, 8, 4, 2, 1) if cfg.s_feat_dim % h == 0))
    tower = BertModel(bcfg).init_weights(torch.Generator().manual_seed(1))

    def tokenizer(texts, max_length=512, _vocab=bcfg.vocab_size):
        out = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            words = t.split()[:max_length]
            out[i, : len(words)] = [hash(w) % (_vocab - 1) + 1 for w in words]
        return out

    return tower, tokenizer


def _cli(argv=None) -> None:
    import argparse
    import dataclasses

    from vidchapters_tpu_torch.config import DatasetPaths, load_config
    from vidchapters_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vidchapters_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from vidchapters_tpu_torch.utils.io import load_json

    p = argparse.ArgumentParser(description="Chapter-grounding (Moment-DETR) training")
    p.add_argument("--recipe", default=None,
                   help="recipe json with model/train/data sections (e.g. "
                        "configs/chapters_momentdetr.json); explicit flags override it")
    p.add_argument("--train-jsonl", default=None)
    p.add_argument("--val-jsonl", default=None)
    p.add_argument("--test-jsonl", default=None,
                   help="held-out split: final inference with the best weights -> "
                        "save_dir/test_preds.jsonl (+ metrics if it has relevant_windows)")
    p.add_argument("--v-feat-dirs", nargs="+", default=None)
    p.add_argument("--subtitles-path", default=None,
                   help="ASR pickle/dir for the speech stream (model.use_speech recipes)")
    p.add_argument("--bert-ckpt", default=None,
                   help="HF bert-base-uncased dir for the speech tower: not ported (it "
                        "needs HF's WordPiece tokenizer); omitted = one random BERT layer "
                        "and a hash tokenizer (smoke only)")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--config", default=None, help="GroundingConfig json (defaults if omitted)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-spans", type=int, default=5)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--early-stop-patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip-text-ckpt", default=None,
                   help="OpenAI CLIP .pt (TorchScript archive or state dict) for the frozen "
                        "text tower; omitted = one random layer (smoke/debug only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # recipe defaults are applied before re-parsing so explicit flags win
    pre, _ = p.parse_known_args(argv)
    recipe = {}
    if pre.recipe:
        recipe = load_json(pre.recipe)
        tr, da = recipe.get("train", {}), recipe.get("data", {})
        p.set_defaults(
            epochs=tr.get("epochs", 50), batch_size=tr.get("batch_size", 32),
            lr=tr.get("lr", 1e-4), max_spans=tr.get("max_spans", 5),
            eval_every=tr.get("eval_every", 5),
            early_stop_patience=tr.get("early_stop_patience", 10),
            train_jsonl=da.get("train_jsonl"), val_jsonl=da.get("val_jsonl"),
            test_jsonl=da.get("test_jsonl"), subtitles_path=da.get("subtitles_path"),
            v_feat_dirs=da.get("v_feat_dirs"))
    a = p.parse_args(argv)
    ds_paths = DatasetPaths(train_jsonl_path=a.train_jsonl or "",
                            val_jsonl_path=a.val_jsonl or "",
                            test_jsonl_path=a.test_jsonl or "",
                            subtitles_path=a.subtitles_path or "")
    for req in ("train_jsonl", "val_jsonl", "v_feat_dirs"):
        if getattr(a, req) is None:
            p.error(f"--{req.replace('_', '-')} required (flag or recipe)")
    if recipe.get("model"):
        cfg = dataclasses.replace(GroundingConfig(), **recipe["model"])
    else:
        cfg = load_config(GroundingConfig, a.config) if a.config else GroundingConfig()

    # the frozen CLIP text tower (moment_detr uses ViT-L/14's token features)
    tcfg = CLIPTextConfig(width=cfg.t_feat_dim, output_dim=cfg.t_feat_dim,
                          heads=max(cfg.t_feat_dim // 64, 1),
                          layers=12 if a.clip_text_ckpt else 1)
    text_encoder = CLIPTextEncoder(tcfg)
    if a.clip_text_ckpt:
        text_encoder.load_state_dict(load_clip_text_checkpoint(a.clip_text_ckpt))
    else:
        print("WARNING: no --clip-text-ckpt; random text tower (smoke mode)")
        text_encoder.init_weights(torch.Generator().manual_seed(0))

    # the frozen BERT speech tower (model.py:47-50 / 131-136), with use_speech only
    if a.bert_ckpt:
        raise NotImplementedError(
            "--bert-ckpt needs HF's WordPiece tokenizer (BertTokenizer), which the port "
            "does not have yet (ROADMAP.md §1); omit it for the smoke-mode speech tower")
    speech_encoder = speech_tokenizer = None
    if cfg.use_speech:
        print("WARNING: no --bert-ckpt; random speech tower + hash tokenizer (smoke mode)")
        speech_encoder, speech_tokenizer = smoke_speech_tower(cfg)

    print(json.dumps(main(ds_paths.train_jsonl_path, ds_paths.val_jsonl_path, a.v_feat_dirs,
                          cfg, a.save_dir, text_encoder=text_encoder,
                          clip_tokenizer=CLIPTokenizer(), n_epochs=a.epochs,
                          batch_size=a.batch_size, lr=a.lr, max_spans=a.max_spans,
                          eval_every=a.eval_every, early_stop_patience=a.early_stop_patience,
                          seed=a.seed, test_jsonl=ds_paths.test_jsonl_path or None,
                          subtitles_path=ds_paths.subtitles_path or None,
                          speech_encoder=speech_encoder, speech_tokenizer=speech_tokenizer,
                          device=a.device)))


if __name__ == "__main__":
    _cli()
