"""Chapter-grounding model (Moment-DETR) and its criterion in PyTorch.

Counterpart of ``vidchapters_tpu/models/grounding.py`` (the reference's
moment_detr/moment_detr/model.py:19-196 + transformer.py): LayerNorm ->
Dropout -> Linear (+ReLU) input projections for video and text features,
a sine position encoding over the valid video clips, a post-norm DETR
transformer (2 encoder + 2 decoder layers, positions added to q/k only),
learned moment queries with one shared ``dec_norm`` applied to every
decoder layer's output, and three heads: a 3-layer span MLP with (center,
width) sigmoid, a 2-way foreground/background classifier and a per-clip
saliency score on the video memory. The frozen text tower
(``models/clip.py``) runs outside the model.

The dtypes are the JAX module's: each product computes in ``cfg.dtype``
(bf16 in the recipe) while the parameters stay fp32; the norms run in fp32
(their output is fp32); scores and the softmax are fp32 and the
probabilities are cast to the compute dtype before dropout and p.v; the key
mask is additive, ``(1 - mask) * -1e9``; ``class_embed``, the span MLP's
last layer and the saliency head run in fp32. The attention is plain
PyTorch, as the JAX module's is plain XLA.

The criterion (``grounding_loss``, SetCriterion, model.py:198-330) matches
every decoder layer's queries to the padded targets with
``ops/matching.hungarian_match`` (the auction, as the JAX train step, or
scipy with ``exact_match``) on costs computed detached: every layer's cost
comes to the host in one device-to-host copy a call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vidchapters_tpu_torch.config import GroundingConfig
from vidchapters_tpu_torch.models.clip import _layer_norm
from vidchapters_tpu_torch.models.t5 import _apply_dropout, _linear
from vidchapters_tpu_torch.ops.matching import hungarian_match
from vidchapters_tpu_torch.ops.span_ops import generalized_temporal_iou, span_cxw_to_xx
from vidchapters_tpu_torch.runtime.rng import StepRng

NEG_INF = -1e9
FOREGROUND, BACKGROUND = 0, 1


def sine_position_encoding(mask: torch.Tensor, dim: int, temperature: float = 10000.0,
                           normalize: bool = True) -> torch.Tensor:
    """[B, L] validity mask -> [B, L, dim] fp32 sine embedding over cumsum positions."""
    x_embed = torch.cumsum(mask.float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(dim, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)
    pos = x_embed[:, :, None] / dim_t
    return torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])],
                       dim=3).reshape(pos.shape[0], pos.shape[1], dim)


def _dense(x: torch.Tensor, lin: nn.Linear, dt: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``Dense(dtype=dt)``: input and parameters cast to ``dt``; with
    ``dt`` None, the promoted type of the input and the fp32 parameters."""
    return _linear(x, lin, dt or torch.promote_types(x.dtype, lin.weight.dtype))


def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm()`` with fp32 parameters: computed and returned in fp32."""
    return _layer_norm(x, ln, torch.float32)


class InputProj(nn.Module):
    """LayerNorm -> Dropout -> Linear (+ReLU) stack (model.py LinearLayer)."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dropout, self.dtype = n_layers, dropout, dtype
        dims = [in_dim] + [hidden_dim] * n_layers
        for i in range(n_layers):
            setattr(self, f"norm_{i}", nn.LayerNorm(dims[i], eps=1e-5))
            setattr(self, f"dense_{i}", nn.Linear(dims[i], hidden_dim))

    def forward(self, x: torch.Tensor, rng: Optional[StepRng] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = _apply_dropout(_norm(x, getattr(self, f"norm_{i}")), self.dropout, rng)
            x = _dense(x, getattr(self, f"dense_{i}"), self.dtype)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


class MHAttention(nn.Module):
    """Scaled multi-head attention with separate q/k/v inputs + key mask."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dropout, self.dtype = heads, dropout, dtype
        self.q, self.k, self.v, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                rng: Optional[StepRng] = None) -> torch.Tensor:
        dt, h = self.dtype, self.heads
        b, lq, dim = q.shape
        lk = k.shape[1]
        qh = _dense(q, self.q, dt).reshape(b, lq, h, dim // h).transpose(1, 2)
        kh = _dense(k, self.k, dt).reshape(b, lk, h, dim // h).transpose(1, 2)
        vh = _dense(v, self.v, dt).reshape(b, lk, h, dim // h).transpose(1, 2)
        # scores from the rounded q and k, accumulated and kept in fp32; the
        # in-place scale and mask keep one [B, H, Lq, Lk] fp32 buffer alive
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)).div_(math.sqrt(dim // h))
        if key_mask is not None:
            scores.add_((1.0 - key_mask.float())[:, None, None, :] * NEG_INF)
        probs = _apply_dropout(torch.softmax(scores, dim=-1).to(dt), self.dropout, rng)
        # p.v accumulates in fp32 and rounds once to the compute dtype
        out = torch.matmul(probs, vh)
        return _dense(out.transpose(1, 2).reshape(b, lq, dim), self.out, dt)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.dtype = cfg, dt
        self.self_attn = MHAttention(cfg.hidden_dim, cfg.nheads, cfg.dropout, dt)
        self.norm1 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)
        self.ff1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward)
        self.ff2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim)
        self.norm2 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)

    def forward(self, src, mask, pos, rng: Optional[StepRng] = None):
        rate, dt = self.cfg.dropout, self.dtype
        qk = src + pos
        h = self.self_attn(qk, qk, src, key_mask=mask, rng=rng)
        src = _norm(src + _apply_dropout(h, rate, rng), self.norm1)
        h = _apply_dropout(torch.relu(_dense(src, self.ff1, dt)), rate, rng)
        h = _dense(h, self.ff2, dt)
        return _norm(src + _apply_dropout(h, rate, rng), self.norm2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.dtype = cfg, dt
        self.self_attn = MHAttention(cfg.hidden_dim, cfg.nheads, cfg.dropout, dt)
        self.norm1 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)
        self.cross_attn = MHAttention(cfg.hidden_dim, cfg.nheads, cfg.dropout, dt)
        self.norm2 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)
        self.ff1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward)
        self.ff2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim)
        self.norm3 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)

    def forward(self, tgt, memory, mem_mask, pos, query_pos, rng: Optional[StepRng] = None):
        rate, dt = self.cfg.dropout, self.dtype
        qk = tgt + query_pos
        h = self.self_attn(qk, qk, tgt, rng=rng)
        tgt = _norm(tgt + _apply_dropout(h, rate, rng), self.norm1)
        h = self.cross_attn(tgt + query_pos, memory + pos, memory, key_mask=mem_mask, rng=rng)
        tgt = _norm(tgt + _apply_dropout(h, rate, rng), self.norm2)
        h = _apply_dropout(torch.relu(_dense(tgt, self.ff1, dt)), rate, rng)
        h = _dense(h, self.ff2, dt)
        return _norm(tgt + _apply_dropout(h, rate, rng), self.norm3)


class SpanMLP(nn.Module):
    """3-layer ReLU MLP span head (model.py MLP); the last layer in fp32."""

    def __init__(self, hidden_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc0 = nn.Linear(hidden_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_dense(x, self.fc0, self.dtype))
        x = torch.relu(_dense(x, self.fc1, self.dtype))
        return _dense(x.float(), self.fc2, None)


class MomentDETR(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        h = cfg.hidden_dim
        self.input_vid_proj = InputProj(cfg.v_feat_dim, h, dropout=cfg.input_dropout, dtype=dt)
        self.input_txt_proj = InputProj(cfg.t_feat_dim, h, dropout=cfg.input_dropout, dtype=dt)
        if cfg.use_speech:
            self.speech_proj = nn.Linear(cfg.s_feat_dim, h)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, h))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.dec_norm = nn.LayerNorm(h, eps=1e-5)
        span_dim = 2 if cfg.span_loss_type == "l1" else cfg.max_v_l * 2
        self.span_embed = SpanMLP(h, span_dim, dt)
        self.class_embed = nn.Linear(h, 2)
        self.saliency_proj = nn.Linear(h, 1)
        if cfg.contrastive_align_loss:
            self.contrastive_query_proj = nn.Linear(h, cfg.contrastive_hdim)
            self.contrastive_txt_proj = nn.Linear(h, cfg.contrastive_hdim)
            self.contrastive_vid_proj = nn.Linear(h, cfg.contrastive_hdim)

    def forward(self, src_txt: torch.Tensor, src_txt_mask: torch.Tensor,
                src_vid: torch.Tensor, src_vid_mask: torch.Tensor,
                src_speech: Optional[torch.Tensor] = None,
                src_speech_mask: Optional[torch.Tensor] = None,
                rng: Optional[StepRng] = None) -> Dict[str, object]:
        """The heads' outputs of the last decoder layer (fp32), the saliency
        scores [B, Lv], and ``aux_outputs`` of the earlier layers; dropout
        when ``rng`` is given."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        vid = self.input_vid_proj(src_vid, rng)
        txt = self.input_txt_proj(src_txt, rng)
        parts, masks = [vid, txt], [src_vid_mask, src_txt_mask]
        poss = [sine_position_encoding(src_vid_mask, cfg.hidden_dim), torch.zeros_like(txt)]
        if cfg.use_speech and src_speech is not None:
            sp = _dense(src_speech, self.speech_proj, dt)
            parts.append(sp)
            masks.append(src_speech_mask)
            poss.append(torch.zeros_like(sp))
        src = torch.cat(parts, dim=1)
        mask = torch.cat([m.to(torch.int32) for m in masks], dim=1)
        # the video's positions are fp32, so the concatenation is (jnp's promotion)
        pos = torch.cat([p.float() for p in poss], dim=1)

        memory = src
        for layer in self.enc_layers:
            memory = layer(memory, mask, pos, rng)

        b = src.shape[0]
        query_pos = self.query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        hs = []
        for layer in self.dec_layers:
            tgt = layer(tgt, memory, mask, pos, query_pos, rng)
            hs.append(_norm(tgt, self.dec_norm))  # DETR return_intermediate
        hs = torch.stack(hs)  # [layers, B, Q, D] fp32

        spans = self.span_embed(hs)
        if cfg.span_loss_type == "l1":
            spans = torch.sigmoid(spans)
        logits = _dense(hs.float(), self.class_embed, None)
        vid_len = src_vid.shape[1]
        vid_mem = memory[:, :vid_len].float()
        saliency = _dense(vid_mem, self.saliency_proj, None)[..., 0]
        out: Dict[str, object] = {"pred_logits": logits[-1], "pred_spans": spans[-1],
                                  "saliency_scores": saliency}
        if cfg.contrastive_align_loss:  # model.py:85-90,168-176
            txt_mem = memory[:, vid_len:vid_len + src_txt.shape[1]]

            def unit(x):
                return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)

            out["proj_queries"] = unit(_dense(hs[-1], self.contrastive_query_proj, None))
            out["proj_txt_mem"] = unit(_dense(txt_mem, self.contrastive_txt_proj, None))
            out["proj_vid_mem"] = unit(_dense(vid_mem, self.contrastive_vid_proj, None))
        if cfg.aux_loss:
            out["aux_outputs"] = [{"pred_logits": logits[i], "pred_spans": spans[i]}
                                  for i in range(cfg.dec_layers - 1)]
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MomentDETR":
        """Seeded random weights with the JAX module's laws: products
        N(0, 1/fan_in) with zero biases, norms at 1 and 0, the moment
        queries N(0, 1)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.query_embed.copy_(torch.randn(self.query_embed.shape, generator=generator))
        return self


# ---------------------------------------------------------------------------
# Criterion (SetCriterion; fixed-size padded targets)
# ---------------------------------------------------------------------------


@torch.no_grad()
def match_cost(pred_logits: torch.Tensor, pred_spans: torch.Tensor, tgt_spans: torch.Tensor,
               cfg: GroundingConfig) -> torch.Tensor:
    """The matcher's cost [..., Q, T] (matcher.py:37-117) of predictions
    [..., Q, 2] against padded targets [..., T, 2]: span L1, negative gIoU
    and the negative foreground probability, weighted."""
    prob = torch.softmax(pred_logits.float(), dim=-1)[..., FOREGROUND]
    t = tgt_spans.shape[-2]
    cost_class = -prob[..., :, None].expand(*prob.shape, t)
    cost_l1 = (pred_spans[..., :, None, :] - tgt_spans[..., None, :, :]).abs().sum(-1)
    cost_giou = -generalized_temporal_iou(span_cxw_to_xx(pred_spans), span_cxw_to_xx(tgt_spans))
    return (cfg.set_cost_span * cost_l1 + cfg.set_cost_giou * cost_giou
            + cfg.set_cost_class * cost_class)


def match_layers(layers: List[Tuple[torch.Tensor, torch.Tensor]], tgt_spans: torch.Tensor,
                 tgt_valid: torch.Tensor, cfg: GroundingConfig,
                 exact: bool = False) -> List[torch.Tensor]:
    """Per-example assignments ([B, T] query per target, -1 when padded;
    int64 on the predictions' device) of each decoder layer's (logits,
    spans). Every layer's cost and the validity come to the host in one
    copy; ``exact`` solves with scipy, else the auction."""
    with torch.no_grad():
        cost = torch.stack([match_cost(lg, sp, tgt_spans, cfg) for lg, sp in layers])
        host = torch.cat([cost.float().flatten(), tgt_valid.float().flatten()]).cpu().numpy()
    n, b, q, t = cost.shape
    cost_h = host[:cost.numel()].reshape(n, b, q, t)
    valid_h = host[cost.numel():].reshape(b, t) > 0
    out = []
    for layer_cost in cost_h:
        assign = np.stack([hungarian_match(c, v, exact=exact)
                           for c, v in zip(layer_cost, valid_h)])
        out.append(torch.from_numpy(assign.astype(np.int64)).to(tgt_spans.device))
    return out


def _scatter_true(assign: torch.Tensor, valid: torch.Tensor, q: int) -> torch.Tensor:
    """[B, Q] bool: True at each valid target's assigned query."""
    slot = torch.where(valid, assign.clamp(min=0), torch.full_like(assign, q))
    fg = torch.zeros((assign.shape[0], q + 1), dtype=torch.bool, device=assign.device)
    return fg.scatter(1, slot, True)[:, :q]


def grounding_loss(outputs: Dict[str, object], targets: Dict[str, torch.Tensor],
                   cfg: GroundingConfig, exact_match: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of span L1 + gIoU + label CE (+ the aux layers') +
    saliency margin (+ contrastive alignment) losses (model.py:367-434).

    ``targets``: spans [B, T, 2] (cxw, normalized), span_valid [B, T],
    optionally saliency_pos/neg_labels [B, P]. The label loss is
    ``(ce * weight).mean()`` over B x Q, not divided by the weights' sum;
    the saliency loss is ``* 2 / (B * P)``."""
    losses: Dict[str, torch.Tensor] = {}
    tgt_spans = targets["spans"].float()
    tgt_valid = targets["span_valid"].bool()
    num_spans = tgt_valid.sum().clamp(min=1).float()
    layers = [(outputs["pred_logits"], outputs["pred_spans"], "")]
    layers += [(aux["pred_logits"], aux["pred_spans"], f"aux{i}_")
               for i, aux in enumerate(outputs.get("aux_outputs", []))]
    assigns = match_layers([(lg, sp) for lg, sp, _ in layers], tgt_spans, tgt_valid, cfg,
                           exact=exact_match)

    total = 0.0
    for (pred_logits, pred_spans, prefix), assign in zip(layers, assigns):
        q = pred_spans.shape[1]
        safe = assign.clamp(min=0)
        matched = torch.gather(pred_spans, 1, safe[..., None].expand(-1, -1, 2))  # [B, T, 2]
        valid = (assign >= 0) & tgt_valid
        l1 = (matched - tgt_spans).abs().sum(-1)
        giou = torch.diagonal(generalized_temporal_iou(span_cxw_to_xx(matched),
                                                       span_cxw_to_xx(tgt_spans)),
                              dim1=1, dim2=2)
        zero = torch.zeros_like(l1)
        loss_span = torch.where(valid, l1, zero).sum() / num_spans
        loss_giou = torch.where(valid, 1.0 - giou, zero).sum() / num_spans
        # matched queries are foreground, the others background at eos_coef
        fg = _scatter_true(assign, valid, q)
        logp = torch.log_softmax(pred_logits, dim=-1)
        ce = -torch.where(fg, logp[..., FOREGROUND], logp[..., BACKGROUND])
        weight = torch.where(fg, torch.ones_like(ce), torch.full_like(ce, cfg.eos_coef))
        loss_label = (ce * weight).mean()
        losses[prefix + "loss_span"] = loss_span
        losses[prefix + "loss_giou"] = loss_giou
        losses[prefix + "loss_label"] = loss_label
        total = total + (cfg.span_loss_coef * loss_span + cfg.giou_loss_coef * loss_giou
                         + cfg.label_loss_coef * loss_label)

    if cfg.contrastive_align_loss and "proj_queries" in outputs:
        # NCE between matched queries and text tokens (model.py:305-322)
        logits_nce = torch.einsum("bqh,bth->bqt", outputs["proj_queries"],
                                  outputs["proj_txt_mem"]).sum(2) / 0.07
        assign = assigns[0]
        pos_map = _scatter_true(assign, (assign >= 0) & tgt_valid, logits_nce.shape[1])
        pos_term = torch.where(pos_map, logits_nce, torch.zeros_like(logits_nce)).sum(1)
        num_pos = pos_map.sum(1).clamp(min=1)
        loss_nce = (-pos_term / num_pos + torch.logsumexp(logits_nce, dim=1)).mean()
        losses["loss_contrastive_align"] = loss_nce
        total = total + loss_nce

    if "saliency_pos_labels" in targets:
        s = outputs["saliency_scores"]  # [B, L]
        pos = torch.gather(s, 1, targets["saliency_pos_labels"].long())
        neg = torch.gather(s, 1, targets["saliency_neg_labels"].long())
        n_pairs = targets["saliency_pos_labels"].shape[1]
        loss_sal = (cfg.saliency_margin + neg - pos).clamp(min=0.0).sum() / (
            s.shape[0] * n_pairs) * 2.0
        losses["loss_saliency"] = loss_sal
        total = total + cfg.lw_saliency * loss_sal

    losses["total"] = total
    return total, losses


def postprocess_predictions(pred_logits: torch.Tensor, pred_spans: torch.Tensor,
                            durations: torch.Tensor, min_w_l: float = 2.0,
                            max_w_l: float = 0.0, round_multiple: int = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Span decode + confidence (inference.py:88-165 + PostProcessorDETR):
    the softmax foreground probability as score; (cx, w) -> (st, ed) in
    seconds, clipped to [0, duration]. Returns (spans_sec [B, Q, 2],
    scores [B, Q])."""
    prob = torch.softmax(pred_logits, dim=-1)[..., FOREGROUND]
    dur = durations.float()[:, None, None]
    xx = torch.minimum(torch.clamp(span_cxw_to_xx(pred_spans) * dur, min=0.0), dur)
    if round_multiple > 1:
        xx = torch.round(xx / round_multiple) * round_multiple
    st = xx[..., 0]
    ed = torch.minimum(torch.maximum(xx[..., 1], st + min_w_l), durations.float()[:, None])
    return torch.stack([st, ed], dim=-1), prob
