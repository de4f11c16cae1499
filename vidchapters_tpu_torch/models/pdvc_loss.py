"""PDVC set-prediction criterion and post-processing in PyTorch.

Counterpart of ``vidchapters_tpu/models/pdvc_loss.py`` (the reference's
SetCriterion + HungarianMatcher, PDVC/pdvc/criterion.py:14-258 and
matcher.py:14-152):

- the matcher cost is a focal-style class cost + L1 + gIoU over (center,
  length) boxes, solved by ``ops/matching.auction_lsap`` on the host (one
  copy of the [B, Q, T] cost per decoder layer);
- sigmoid focal classification over one foreground class, scaled by the
  number of queries; the Gaussian-smeared event-count BCE; L1 + gIoU box
  losses over the total target count; the optional self-IoU penalty; and
  the caption NLL over matched (query, target) pairs.

Targets are padded: boxes [B, T, 2] (center, length, normalized), valid
[B, T], captions [B, T, L_cap] word ids (0 = BOS / EOS / pad).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vidchapters_tpu_torch.config import PDVCConfig
from vidchapters_tpu_torch.models.pdvc import PDVC, box_cl_to_xy
from vidchapters_tpu_torch.ops.matching import hungarian_match
from vidchapters_tpu_torch.ops.span_ops import generalized_temporal_iou, temporal_iou

# empirical event-count prior from ActivityNet (criterion.py:38-46)
COUNTER_CLASS_RATE = np.array([
    0.0, 0.0, 1.93425917e-1, 4.12129084e-1, 1.88929963e-1, 7.81296833e-2,
    5.09541413e-2, 3.12718553e-2, 1.84833650e-2, 8.39244680e-3,
    6.59406534e-3, 4.49595364e-3, 2.19802178e-3, 1.79838146e-3,
    5.99460486e-4, 4.99550405e-4, 4.99550405e-4, 1.99820162e-4,
    2.99730243e-4, 3.99640324e-4, 2.99730243e-4, 0.0, 1.99820162e-4,
    0.0, 0.0, 0.0, 9.99100809e-5, 9.99100809e-5])


@torch.no_grad()
def match_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
               cfg: PDVCConfig, cost_class: float = 2.0, cost_bbox: float = 5.0,
               cost_giou: float = 2.0) -> torch.Tensor:
    """The matcher's cost [B, Q, T] (matcher.py:75-101): focal-style class
    cost + L1 + negative gIoU of (center, length) boxes."""
    p = torch.sigmoid(pred_logits[..., 0])[:, :, None]  # single fg class, [B, Q, 1]
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    neg = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p + 1e-8))
    pos = alpha * ((1 - p) ** gamma) * (-torch.log(p + 1e-8))
    c_class = (pos - neg).expand(-1, -1, tgt_boxes.shape[1])
    c_l1 = (pred_boxes[:, :, None] - tgt_boxes[:, None]).abs().sum(-1)
    c_giou = -generalized_temporal_iou(box_cl_to_xy(pred_boxes), box_cl_to_xy(tgt_boxes))
    return cost_bbox * c_l1 + cost_class * c_class + cost_giou * c_giou


@torch.no_grad()
def match_pdvc(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
               tgt_valid: torch.Tensor, cfg: PDVCConfig, cost_class: float = 2.0,
               cost_bbox: float = 5.0, cost_giou: float = 2.0,
               exact: bool = False) -> torch.Tensor:
    """[B, Q, 1], [B, Q, 2] against padded targets -> [B, T] query per target
    (int64 on the predictions' device, -1 for an invalid target)."""
    cost = match_cost(pred_logits, pred_boxes, tgt_boxes, cfg, cost_class, cost_bbox, cost_giou)
    cost_h = cost.float().cpu().numpy()
    valid_h = tgt_valid.cpu().numpy() > 0
    assign = np.stack([hungarian_match(c, v, exact=exact) for c, v in zip(cost_h, valid_h)])
    return torch.from_numpy(assign.astype(np.int64)).to(pred_boxes.device)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, num_boxes: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    prob = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(dim=1).sum() / num_boxes


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` form."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def count_loss(pred_count: torch.Tensor, tgt_counts: torch.Tensor, cfg: PDVCConfig,
               gau_mask: bool = True, beta: float = 1.0) -> torch.Tensor:
    """Gaussian-smeared BCE count loss (criterion.py:202-223)."""
    n_bins = pred_count.shape[1]
    counts = tgt_counts.clamp(0, n_bins - 1)
    onehot = F.one_hot(counts.long(), n_bins).float()
    pos = torch.arange(n_bins, dtype=torch.float32, device=pred_count.device)
    gaussian = torch.exp(-(pos[None, :] - counts[:, None].float()) ** 2 / (2 * 2.0 ** 2))
    weight = torch.as_tensor(COUNTER_CLASS_RATE[:n_bins], dtype=torch.float32,
                             device=pred_count.device)
    loss = sigmoid_ce(pred_count, onehot) * (1.0 - weight)[None, :]
    if gau_mask:
        coef = onehot + ((1 - gaussian) ** beta) * (1 - onehot)
    else:
        coef = torch.ones_like(onehot)
    return (loss * coef).mean(dim=1).mean()


def caption_nll(logprobs: torch.Tensor, seq: torch.Tensor,
                pair_valid: torch.Tensor) -> torch.Tensor:
    """Per-pair caption NLL (LSTM.py:52-56): the mean over the input
    positions (the first, and every one holding a word) of -log P(next
    token), averaged over valid pairs. logprobs [N, L-1, V+1] predicting
    seq[:, 1:]; seq [N, L]; pair_valid [N]."""
    targets = seq[:, 1:]
    inp_mask = (seq[:, :-1] > 0).float()
    inp_mask = torch.cat([torch.ones_like(inp_mask[:, :1]), inp_mask[:, 1:]], dim=1)
    nll = -torch.gather(logprobs, 2, targets[..., None].long())[..., 0]
    per_pair = (nll * inp_mask).sum(1) / (inp_mask.sum(1) + 1e-6)
    per_pair = per_pair * pair_valid.float()
    return per_pair.sum() / pair_valid.sum().clamp(min=1)


def pdvc_criterion(model: PDVC, outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], cfg: PDVCConfig,
                   self_iou: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss over all decoder layers plus the final layer's caption loss.
    ``outputs`` is the model's forward dict; ``targets``: boxes [B, T, 2],
    valid [B, T], captions [B, T, L_cap]."""
    tgt_boxes = targets["boxes"]
    tgt_valid = targets["valid"] > 0
    b, t = tgt_valid.shape
    num_boxes = tgt_valid.sum().float().clamp(min=1.0)
    tgt_counts = tgt_valid.sum(dim=1)

    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    n_layers = outputs["pred_logits"].shape[0]
    last_assign = None
    for lid in range(n_layers):
        logits = outputs["pred_logits"][lid]  # [B, Q, 1]
        boxes = outputs["pred_boxes"][lid]
        assign = match_pdvc(logits, boxes, tgt_boxes, tgt_valid, cfg,
                            cost_class=cfg.cls_loss_coef, cost_bbox=cfg.bbox_loss_coef,
                            cost_giou=cfg.giou_loss_coef)
        last_assign = assign
        q = boxes.shape[1]
        safe = assign.clamp(min=0)
        valid_pair = (assign >= 0) & tgt_valid

        # focal classification: matched queries are the positives
        slot = torch.where(valid_pair, safe, torch.full_like(safe, q))
        fg = torch.zeros((b, q + 1), dtype=torch.float32, device=logits.device)
        fg = fg.scatter(1, slot, 1.0)[:, :q]
        loss_ce = sigmoid_focal_loss(logits, fg[..., None], num_boxes,
                                     cfg.focal_alpha, cfg.focal_gamma) * q
        loss_counter = count_loss(outputs["pred_count"][lid], tgt_counts, cfg)

        # box losses over the matched pairs
        matched = torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 2))
        l1 = (matched - tgt_boxes).abs().sum(-1)
        giou_mat = generalized_temporal_iou(box_cl_to_xy(matched), box_cl_to_xy(tgt_boxes))
        giou_diag = torch.diagonal(giou_mat, dim1=1, dim2=2)
        zero = torch.zeros_like(l1)
        loss_bbox = torch.where(valid_pair, l1, zero).sum() / num_boxes
        loss_giou = torch.where(valid_pair, 1.0 - giou_diag, zero).sum() / num_boxes

        layer_total = (cfg.cls_loss_coef * loss_ce + cfg.count_loss_coef * loss_counter
                       + cfg.bbox_loss_coef * loss_bbox + cfg.giou_loss_coef * loss_giou)
        if self_iou:
            xy = box_cl_to_xy(matched)
            iou_mat = temporal_iou(xy, xy)[0]
            pair_mask = valid_pair[:, :, None] & valid_pair[:, None, :]
            upper = torch.triu(torch.ones((t, t), dtype=torch.bool, device=logits.device),
                               diagonal=1)[None]
            n_i = valid_pair.sum(1).float()
            denom = (0.5 * n_i * (n_i - 1)).clamp(min=1.0)
            loss_self_iou = (torch.where(pair_mask & upper, iou_mat, torch.zeros_like(iou_mat))
                             .sum(dim=(1, 2)) / denom).sum()
            losses[f"loss_self_iou_{lid}"] = loss_self_iou
            layer_total = layer_total + loss_self_iou

        suffix = "" if lid == n_layers - 1 else f"_{lid}"
        losses[f"loss_ce{suffix}"] = loss_ce
        losses[f"loss_counter{suffix}"] = loss_counter
        losses[f"loss_bbox{suffix}"] = loss_bbox
        losses[f"loss_giou{suffix}"] = loss_giou
        total = total + layer_total

    # caption loss on the final layer's matched pairs
    if "captions" in targets:
        hs_last = outputs["hs"][-1]  # [B, Q, C]
        safe = last_assign.clamp(min=0)
        feats = torch.gather(hs_last, 1, safe[..., None].expand(-1, -1, hs_last.shape[-1]))
        valid_pair = (last_assign >= 0) & tgt_valid
        flat_feats = feats.reshape(b * t, -1)
        flat_seq = targets["captions"].reshape(b * t, -1)
        # the DSA head samples the encoder memory around each matched event's
        # reference point (pdvc.py:390: reference[:, feat_bigids])
        ctx = (model.caption_context(outputs, safe)
               if cfg.caption_decoder_type in ("standard", "dsa") else None)
        logprobs = model.caption_logprobs(flat_feats, flat_seq, ctx)
        loss_caption = caption_nll(logprobs, flat_seq, valid_pair.reshape(b * t))
        losses["loss_caption"] = loss_caption
        total = total + cfg.caption_loss_coef * loss_caption

    losses["total"] = total
    return total, losses


def pdvc_postprocess(outputs: Dict[str, torch.Tensor], durations: torch.Tensor,
                     seq: Optional[torch.Tensor] = None,
                     cap_logprob_sums: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Proposals sorted by score, boxes in seconds, and the count head's
    event count (PostProcess, pdvc.py:534-593); with one foreground class the
    top-k over queries is a sort by sigmoid score (stable, as ``jnp.argsort``)."""
    prob = torch.sigmoid(outputs["pred_logits"][-1][..., 0])  # [B, Q]
    order = torch.argsort(-prob, dim=1, stable=True)
    scores = torch.gather(prob, 1, order)
    xy = box_cl_to_xy(outputs["pred_boxes"][-1]).clamp(0.0, 1.0)
    xy = torch.gather(xy, 1, order[..., None].expand(-1, -1, 2)) * durations[:, None, None]
    eseq_len = torch.argmax(outputs["pred_count"][-1], dim=-1).clamp(min=1)
    out = {"scores": scores, "boxes": xy, "query_order": order, "pred_seq_len": eseq_len}
    if seq is not None:
        out["seq"] = torch.gather(seq, 1, order[..., None].expand(-1, -1, seq.shape[-1]))
        out["caption_scores"] = torch.gather(cap_logprob_sums, 1, order)
    return out
