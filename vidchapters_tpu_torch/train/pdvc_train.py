"""PDVC training step, inference and evaluation.

Counterpart of ``vidchapters_tpu/train/pdvc_train.py`` (the reference's
PDVC/train.py:33-360 and eval_utils.py:109-242): a train step over the full
set-prediction criterion; an inference pass giving per-proposal scores,
boxes and greedy captions; count-based reranking (joint score = proposal
score + alpha x length-normalized sentence score, truncated to the count
head's prediction, sorted by time); and DVC + SODA scoring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.config import PDVCConfig
from vidchapters_tpu_torch.models.pdvc import PDVC
from vidchapters_tpu_torch.models.pdvc_loss import pdvc_criterion, pdvc_postprocess
from vidchapters_tpu_torch.runtime.rng import StepRng
from vidchapters_tpu_torch.train.schedules import ClipAdamW, staircase_decay

# the collated fields the model and the criterion read, and their dtypes
PDVC_BATCH_FIELDS = {"video": torch.float32, "video_mask": torch.int32,
                     "boxes": torch.float32, "valid": torch.int32, "captions": torch.int64}


@dataclass
class PDVCTrainState:
    """The model, the optimizer and the step; ``train_step`` updates all
    three in place. ``runtime/checkpoint.py`` saves and restores it whole."""

    model: PDVC
    optimizer: ClipAdamW
    step: int = 0


def build_pdvc_schedule(lr: float = 1e-4, lr_drop_step: int = 8, gamma: float = 0.5
                        ) -> Callable[[int], float]:
    """optax's ``exponential_decay(lr, lr_drop_step, gamma, staircase=True)``."""
    return staircase_decay(lr, lr_drop_step, gamma)


def build_pdvc_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                         weight_decay: float = 1e-4, lr_drop_step: int = 8,
                         gamma: float = 0.5, clip_norm: float = 100.0,
                         steps_per_epoch: int = 1) -> ClipAdamW:
    """Global-norm clip then AdamW with a StepLR staircase (PDVC/opts.py
    defaults: lr 1e-4, x0.5 every 8 epochs, clip 100)."""
    return ClipAdamW(params, build_pdvc_schedule(lr, lr_drop_step * steps_per_epoch, gamma),
                     weight_decay=weight_decay, clip_max_norm=clip_norm)


def pdvc_batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(device, non_blocking=True)
            for k, dt in PDVC_BATCH_FIELDS.items() if k in batch}


def make_pdvc_train_step(model: PDVC, cfg: PDVCConfig, self_iou: bool = False) -> Callable:
    """``train_step(state, batch, seed) -> metrics``: one update of ``state``
    in place on ``batch`` (``pdvc_batch_to_device`` fields on the model's
    device), dropout drawn from ``StepRng(seed, state.step)``. Metrics are
    0-d tensors on the device: every loss term, ``total`` and ``grad_norm``
    of the raw gradients."""

    def train_step(state: PDVCTrainState, batch: Mapping[str, torch.Tensor], seed: int):
        device = batch["video"].device
        rng = StepRng(seed, state.step, device)
        state.model.zero_grad(set_to_none=True)
        out = state.model(batch["video"], batch["video_mask"], rng=rng)
        targets = {k: batch[k] for k in ("boxes", "valid", "captions")}
        total, losses = pdvc_criterion(state.model, out, targets, cfg, self_iou=self_iou)
        total.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_pdvc_infer(model: PDVC, cfg: PDVCConfig) -> Callable:
    """``infer(video, video_mask, durations)`` (numpy) -> the post-processed
    proposals with greedy captions of every query, as numpy arrays."""

    @torch.no_grad()
    def infer(video, video_mask, durations) -> Dict[str, np.ndarray]:
        device = next(model.parameters()).device
        out = model(torch.as_tensor(np.asarray(video), dtype=torch.float32, device=device),
                    torch.as_tensor(np.asarray(video_mask), dtype=torch.int32, device=device))
        hs_last = out["hs"][-1]
        b, q, c = hs_last.shape
        ctx = (model.caption_context(out)
               if cfg.caption_decoder_type in ("standard", "dsa") else None)
        seq, lps = model.caption_sample(hs_last.reshape(b * q, c), cfg.max_caption_len, ctx)
        post = pdvc_postprocess(
            out, torch.as_tensor(np.asarray(durations), dtype=torch.float32, device=device),
            seq.reshape(b, q, -1), lps.sum(-1).reshape(b, q))
        return {k: v.cpu().numpy() for k, v in post.items()}

    return infer


def rerank_proposals(proposals: List[dict], alpha: float = 0.3,
                     temperature: float = 2.0) -> List[dict]:
    """Count-based reranking (eval_utils.py:152-170)."""
    if not proposals:
        return proposals
    joint = []
    for p in proposals:
        n_words = len(p["sentence"].split())
        sent = p["sentence_score"] / (float(n_words) ** temperature + 1e-5)
        joint.append(alpha * sent + p["proposal_score"])
    order = sorted(range(len(proposals)), key=lambda i: -joint[i])
    top_n = proposals[order[0]]["pred_event_count"]
    kept = [proposals[i] for i in order[:top_n]]
    return sorted(kept, key=lambda p: p["timestamp"])


def evaluate_pdvc(infer_fn: Callable, data_iter: Iterable[Mapping], translator,
                  references: Optional[List] = None, rerank: bool = True, alpha: float = 0.3,
                  score_threshold: float = 0.0
                  ) -> Tuple[Dict[str, list], Dict[str, float]]:
    """The DVC submission (eval_utils.py:174-242 schema) of every batch, and
    its ``eval_dvc`` + ``eval_soda`` scores against ``references``."""
    results: Dict[str, list] = {}
    for batch in data_iter:
        post = infer_fn(batch["video"], batch["video_mask"], batch["duration"])
        scores, boxes, seq = post["scores"], post["boxes"], post["seq"]
        cap_scores, counts = post["caption_scores"], post["pred_seq_len"]
        for i, vid in enumerate(batch["video_id"]):
            props = []
            for pid in range(scores.shape[1]):
                if scores[i, pid] <= score_threshold:
                    continue
                props.append({
                    "timestamp": [float(boxes[i, pid, 0]), float(boxes[i, pid, 1])],
                    "proposal_score": float(scores[i, pid]),
                    "sentence": translator.rtranslate(seq[i, pid]),
                    "sentence_score": float(cap_scores[i, pid]),
                    "pred_event_count": int(counts[i]),
                })
            if rerank:
                props = rerank_proposals(props, alpha=alpha)
            results[vid] = props
    metrics: Dict[str, float] = {}
    if references:
        from vidchapters_tpu_torch.evals.dvc import eval_dvc
        from vidchapters_tpu_torch.evals.soda import eval_soda

        submission = {"results": results}
        metrics.update(eval_dvc(submission, references))
        metrics.update(eval_soda(submission, references))
    return results, metrics
