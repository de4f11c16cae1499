"""Temporal span math (xx <-> cxw, IoU, generalized IoU, NMS) in PyTorch.

Counterpart of ``vidchapters_tpu/ops/span_ops.py``, with the conventions of
moment_detr/moment_detr/span_utils.py: ``xx`` = (start, end), ``cxw`` =
(center, width); gIoU subtracts the normalized enclosing-hull slack. The
pairwise functions take ``[..., N, 2]`` x ``[..., M, 2]`` and broadcast over
the leading dimensions (the JAX functions take 2-D spans and are vmapped).
"""

from __future__ import annotations

from typing import Tuple

import torch


def span_xx_to_cxw(xx: torch.Tensor) -> torch.Tensor:
    return torch.stack([xx.sum(-1) * 0.5, xx[..., 1] - xx[..., 0]], dim=-1)


def span_cxw_to_xx(cxw: torch.Tensor) -> torch.Tensor:
    return torch.stack([cxw[..., 0] - 0.5 * cxw[..., 1], cxw[..., 0] + 0.5 * cxw[..., 1]],
                       dim=-1)


def temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of [..., N, 2] x [..., M, 2] xx spans -> (iou, union),
    each [..., N, M]."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = (right - left).clamp(min=0.0)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))
    return iou, union


def generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Pairwise gIoU of [..., N, 2] x [..., M, 2] xx spans -> [..., N, M]."""
    iou, union = temporal_iou(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclosing = (right - left).clamp(min=0.0)
    slack = torch.where(enclosing > 0, (enclosing - union) / enclosing.clamp(min=1e-12),
                        torch.zeros_like(enclosing))
    return iou - slack


def temporal_nms_indices(spans: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                         max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy temporal NMS (moment_detr/utils/temporal_nms.py:25: sort by
    score, keep a span whose IoU with every kept span is <= threshold).
    Returns (keep_indices [max_keep] int32, -1 past the kept ones, and
    valid_mask [max_keep])."""
    n = spans.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou, _ = temporal_iou(spans[order], spans[order])
    positions = torch.arange(n, device=spans.device)
    suppressed = torch.zeros(n, dtype=torch.bool, device=spans.device)
    for i in range(n):
        live = ~suppressed[i]
        suppressed = torch.where(live, suppressed | ((iou[i] > iou_threshold) & (positions > i)),
                                 suppressed)
    kept = torch.nonzero(~suppressed)[:, 0][:max_keep]
    src = torch.full((max_keep,), -1, dtype=torch.int32, device=spans.device)
    src[:kept.numel()] = order[kept].int()
    return src, src >= 0
