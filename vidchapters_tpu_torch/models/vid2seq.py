"""Vid2Seq: temporal ViT + T5, fused by sequence concatenation.

Counterpart of ``vidchapters_tpu/models/vid2seq.py`` (reference
model/vid2seq.py:20-167): the visual encoder output goes in front of the
T5-encoded ASR states, the fused states pad once to a multiple of 128 with
padded keys masked, and the training forward returns the label-smoothed
loss over time+text output tokens. Every forward takes ``rng`` (a
``runtime.rng.StepRng``) for training mode, None for deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.config import Vid2SeqConfig
from vidchapters_tpu_torch.models.t5 import (
    SEQ_PAD_BLOCK,
    T5ForConditionalGeneration,
    label_smoothed_cross_entropy,
    shift_right,
)
from vidchapters_tpu_torch.models.vit import TemporalViT
from vidchapters_tpu_torch.runtime.rng import StepRng


class Vid2Seq(nn.Module):
    def __init__(self, cfg: Vid2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.t5 = T5ForConditionalGeneration(cfg.t5)
        if cfg.use_video:
            self.visual_encoder = TemporalViT(cfg.vit)
            if cfg.t5.d_model != cfg.vit.embed_dim:
                self.proj_v2t = nn.Linear(cfg.vit.embed_dim, cfg.t5.d_model)

    def encode_video(self, video: torch.Tensor,
                     rng: Optional[StepRng] = None) -> torch.Tensor:
        feats = self.visual_encoder(video, rng)
        if self.cfg.t5.d_model != self.cfg.vit.embed_dim:
            # the projection computes in the promoted type of input and weights
            w = self.proj_v2t.weight
            dt = torch.promote_types(feats.dtype, w.dtype)
            feats = F.linear(feats.to(dt), w.to(dt), self.proj_v2t.bias.to(dt))
        return feats

    def encode(self, video: Optional[torch.Tensor], input_ids: Optional[torch.Tensor],
               attention_mask: Optional[torch.Tensor],
               video_embeds: Optional[torch.Tensor] = None,
               rng: Optional[StepRng] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused encoder states and their [B, L] int32 mask, L a multiple
        of 128. ``video_embeds`` stands in for the visual tower (the
        denoising pass reuses the generative pass's, with its gradient)."""
        cfg = self.cfg
        parts, masks = [], []
        if cfg.use_video:
            v = video_embeds if video_embeds is not None else self.encode_video(video, rng)
            parts.append(v)
            masks.append(torch.ones(v.shape[:2], dtype=torch.int32, device=v.device))
        if cfg.use_speech:
            parts.append(self.t5.encode(input_ids=input_ids,
                                        attention_mask=attention_mask, rng=rng))
            masks.append(attention_mask.to(torch.int32))
        enc_out = torch.cat(parts, dim=1)
        enc_mask = torch.cat(masks, dim=1)
        l = enc_out.shape[1]
        lp = -(-l // SEQ_PAD_BLOCK) * SEQ_PAD_BLOCK
        if lp != l:
            enc_out = F.pad(enc_out, (0, 0, 0, lp - l))
            enc_mask = F.pad(enc_mask, (0, lp - l))
        return enc_out, enc_mask

    def forward(self, video, input_ids, attention_mask, labels,
                video_embeds: Optional[torch.Tensor] = None,
                rng: Optional[StepRng] = None) -> Dict[str, torch.Tensor]:
        """Training forward: {"loss", "video_embeds"}, with dropout when
        ``rng`` is given. ``labels`` are output ids with 0-padding, ignored
        in the loss."""
        enc_out, enc_mask = self.encode(video, input_ids, attention_mask, video_embeds,
                                        rng)
        targets = torch.where(labels == 0, torch.full_like(labels, -100), labels)
        logits = self.t5.decode(shift_right(labels), (labels != 0).to(torch.int32),
                                enc_out, enc_mask, rng)
        out = {"loss": label_smoothed_cross_entropy(logits, targets,
                                                    self.cfg.t5.label_smoothing)}
        if self.cfg.use_video:
            out["video_embeds"] = (video_embeds if video_embeds is not None
                                   else enc_out[:, :video.shape[1]])
        return out

    def encode_for_generation(self, video, input_ids, attention_mask):
        return self.encode(video, input_ids, attention_mask)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Vid2Seq":
        """Seeded random weights (see the towers' ``init_weights``)."""
        self.t5.init_weights(generator)
        if self.cfg.use_video:
            self.visual_encoder.init_weights(generator)
            if hasattr(self, "proj_v2t"):
                self.proj_v2t.weight.copy_(
                    torch.randn(self.proj_v2t.weight.shape, generator=generator)
                    * self.proj_v2t.in_features ** -0.5)
                self.proj_v2t.bias.zero_()
        return self
