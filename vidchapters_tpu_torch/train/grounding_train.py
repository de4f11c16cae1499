"""Chapter-grounding training and inference (the Moment-DETR task).

Counterpart of ``vidchapters_tpu/train/grounding_train.py`` (the reference's
moment_detr/moment_detr/train.py:40-179 + inference.py:88-274): a train step
that runs the frozen CLIP text tower (and the frozen BERT speech tower of
``use_speech`` recipes) without gradients, the grounding transformer, the
Hungarian-matched losses, the global-norm clip and AdamW with a StepLR
staircase; inference decodes spans and scores, and ``evaluate_grounding``
builds the submission (optional temporal NMS) and scores it with
``evals.moment.eval_submission``. Over several ranks the train step is that
of the global batch (``parallel/sharding.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.config import GroundingConfig
from vidchapters_tpu_torch.models.grounding import (
    MomentDETR,
    grounding_loss,
    postprocess_predictions,
)
from vidchapters_tpu_torch.ops.span_ops import temporal_nms_indices
from vidchapters_tpu_torch.parallel.sharding import (
    all_reduce_gradients,
    global_count,
    sum_shares,
)
from vidchapters_tpu_torch.runtime import mesh
from vidchapters_tpu_torch.runtime.rng import StepRng
from vidchapters_tpu_torch.train.schedules import ClipAdamW, staircase_decay

# the collated fields the step reads, and their dtypes
GROUNDING_BATCH_FIELDS = {"query_tokens": torch.int64, "query_feat": torch.float32,
                          "query_mask": torch.int32, "video_feat": torch.float32,
                          "video_mask": torch.int32, "spans": torch.float32,
                          "span_valid": torch.int32, "saliency_pos_labels": torch.int64,
                          "saliency_neg_labels": torch.int64, "speech_tokens": torch.int64,
                          "duration": torch.float32}


@dataclass
class GroundingTrainState:
    """The model, the optimizer and the step; ``train_step`` updates all
    three in place. ``runtime/checkpoint.py`` saves and restores it whole."""

    model: MomentDETR
    optimizer: ClipAdamW
    step: int = 0


def build_grounding_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                              weight_decay: float = 1e-4, lr_drop_step: int = 400,
                              gamma: float = 0.1, clip_norm: float = 0.1,
                              steps_per_epoch: int = 1) -> ClipAdamW:
    """Global-norm clip, then AdamW with weight decay on every parameter and
    the lr x ``gamma`` every ``lr_drop_step`` epochs (moment_detr
    train.py:210-211; config defaults lr 1e-4, wd 1e-4, lr_drop 400 epochs,
    grad_clip 0.1)."""
    return ClipAdamW(params, staircase_decay(lr, lr_drop_step * steps_per_epoch, gamma),
                     weight_decay=weight_decay, clip_max_norm=clip_norm)


def grounding_batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(device, non_blocking=True)
            for k, dt in GROUNDING_BATCH_FIELDS.items() if k in batch}


def _text_inputs(text_encoder, batch: Mapping[str, torch.Tensor]):
    """(token features, mask) of the queries: the frozen tower's per-token
    features of ``query_tokens``, else the precomputed ``query_feat``."""
    if text_encoder is not None:
        toks = batch["query_tokens"]
        with torch.no_grad():
            return text_encoder(toks, return_tokens=True), (toks != 0).to(torch.int32)
    return batch["query_feat"], batch["query_mask"]


def _speech_inputs(speech_encoder, speech_tokens: Optional[torch.Tensor]):
    if speech_encoder is None or speech_tokens is None:
        return None, None
    mask = (speech_tokens != 0).to(torch.int32)
    with torch.no_grad():
        return speech_encoder(speech_tokens, attention_mask=mask), mask


def valid_spans(batch: Mapping) -> int:
    """The valid target spans of a batch (``span_valid``): the count the
    span losses divide by."""
    return int((batch["span_valid"] != 0).sum())


def make_grounding_train_step(model: MomentDETR, text_encoder, cfg: GroundingConfig,
                              speech_encoder=None) -> Callable:
    """``train_step(state, batch, seed, num_spans=None) -> metrics``: one
    update of ``state`` in place on ``batch`` (``grounding_batch_to_device``
    fields on the model's device), dropout drawn from ``StepRng(seed,
    state.step, rank)``. Only the grounding model trains: the text tower
    (model.py:53-56) and the speech tower (model.py:131-136) run without
    gradients. Metrics are 0-d device tensors: every loss term, ``total``
    and ``grad_norm`` of the raw gradients.

    In a process group (``runtime/mesh.py``) the ranks hold equal batches
    and the step is the global batch's:
    the span losses divide by the global count of valid spans
    (``num_spans``, this rank's ``valid_spans`` of the host batch, summed
    over the ranks; required there), the per-row means
    by the number of ranks, the gradients are summed over the ranks before
    the clip, and the metrics are the global batch's."""
    data_parallel = mesh.distributed()

    def train_step(state: GroundingTrainState, batch: Mapping[str, torch.Tensor],
                   seed: int, num_spans: Optional[int] = None) -> Dict[str, torch.Tensor]:
        share = {}
        if data_parallel:
            if num_spans is None:
                raise ValueError("in a process group the step takes the host batch's "
                                 "valid_spans as num_spans")
            share = dict(num_spans=global_count(num_spans), num_ranks=mesh.world_size())
        rng = StepRng(seed, state.step, batch["video_feat"].device, rank=mesh.rank())
        state.model.zero_grad(set_to_none=True)
        src_txt, txt_mask = _text_inputs(text_encoder, batch)
        src_speech, speech_mask = _speech_inputs(speech_encoder, batch.get("speech_tokens"))
        out = state.model(src_txt, txt_mask, batch["video_feat"], batch["video_mask"],
                          src_speech=src_speech, src_speech_mask=speech_mask, rng=rng)
        targets = {k: batch[k] for k in ("spans", "span_valid", "saliency_pos_labels",
                                         "saliency_neg_labels")}
        total, losses = grounding_loss(out, targets, cfg, **share)
        total.backward()
        if data_parallel:
            all_reduce_gradients(state.model.parameters())
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics = sum_shares(metrics)  # the ranks' shares sum to the global losses
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_grounding_infer(model: MomentDETR, text_encoder, speech_encoder=None) -> Callable:
    """``infer(query_tokens_or_feat, txt_mask, video_feat, video_mask,
    durations, speech_tokens=None)`` (numpy) -> (spans in seconds [B, Q, 2],
    scores [B, Q], saliency [B, Lv]) as numpy arrays. With a text tower the
    first argument is CLIP token ids and ``txt_mask`` is ignored."""

    @torch.inference_mode()
    def infer(query_tokens_or_feat, txt_mask, video_feat, video_mask, durations,
              speech_tokens=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        device = next(model.parameters()).device
        batch = {"video_feat": video_feat, "video_mask": video_mask, "duration": durations}
        if text_encoder is not None:
            batch["query_tokens"] = query_tokens_or_feat
        else:
            batch["query_feat"], batch["query_mask"] = query_tokens_or_feat, txt_mask
        if speech_tokens is not None:
            batch["speech_tokens"] = speech_tokens
        batch = grounding_batch_to_device(batch, device)
        src_txt, mask = _text_inputs(text_encoder, batch)
        src_speech, speech_mask = _speech_inputs(speech_encoder, batch.get("speech_tokens"))
        out = model(src_txt, mask, batch["video_feat"], batch["video_mask"],
                    src_speech=src_speech, src_speech_mask=speech_mask)
        spans_sec, scores = postprocess_predictions(out["pred_logits"], out["pred_spans"],
                                                    batch["duration"])
        return tuple(t.cpu().numpy() for t in (spans_sec, scores, out["saliency_scores"]))

    return infer


def predictions_to_submission(qids: List, spans_sec: np.ndarray, scores: np.ndarray,
                              saliency: Optional[np.ndarray] = None,
                              nms_threshold: float = -1.0, max_keep: int = 10) -> List[dict]:
    """eval_submission rows, sorted by confidence, with optional temporal
    NMS (inference.py:117-165)."""
    rows = []
    for i, qid in enumerate(qids):
        order = np.argsort(-scores[i])
        windows = [[float(spans_sec[i, j, 0]), float(spans_sec[i, j, 1]), float(scores[i, j])]
                   for j in order]
        if nms_threshold > 0:
            keep, valid = temporal_nms_indices(torch.as_tensor(spans_sec[i]),
                                               torch.as_tensor(scores[i]), nms_threshold,
                                               max_keep)
            keep = keep.numpy()[valid.numpy()]
            windows = [[float(spans_sec[i, j, 0]), float(spans_sec[i, j, 1]),
                        float(scores[i, j])] for j in keep]
        row = {"qid": qid, "pred_relevant_windows": windows[:max_keep]}
        if saliency is not None:
            row["pred_saliency_scores"] = [float(x) for x in saliency[i]]
        rows.append(row)
    return rows


def evaluate_grounding(infer_fn: Callable, data_iter: Iterable[Mapping],
                       ground_truth: List[dict], tokenizer=None, nms_threshold: float = -1.0,
                       dataset: str = "chapters") -> Tuple[List[dict], Dict]:
    """Run ``infer_fn`` over every batch (tokenizing ``query`` with the CLIP
    ``tokenizer`` when given, else reading ``query_feat``), build the
    submission and score it against ``ground_truth``."""
    from vidchapters_tpu_torch.evals.moment import eval_submission

    submission: List[dict] = []
    for batch in data_iter:
        if tokenizer is not None:
            toks, txt_mask = np.asarray(tokenizer(batch["query"])), None
        else:
            toks, txt_mask = batch["query_feat"], batch["query_mask"]
        spans_sec, scores, saliency = infer_fn(toks, txt_mask, batch["video_feat"],
                                               batch["video_mask"], batch["duration"],
                                               speech_tokens=batch.get("speech_tokens"))
        submission.extend(predictions_to_submission(batch["qid"], spans_sec, scores, saliency,
                                                    nms_threshold))
    metrics = eval_submission(submission, ground_truth, match_number=False, dataset=dataset)
    return submission, metrics
