"""Whisper encoder-decoder in PyTorch: the ASR factory's model.

Counterpart of ``vidchapters_tpu/models/whisper.py``: log-mel spectrogram ->
two ``Conv1d`` (exact GELU) -> sinusoidal positions -> transformer encoder;
a text decoder with learned positions, causal self-attention,
cross-attention and tied output embeddings. The decoder exposes the same
``init_cache`` / ``decode_step`` API as the port's T5 (cache keys
``layer_{i}`` -> ``self`` / ``cross``), which ``ops/decoding.make_decode_fns``
style callers drive; ``ops/whisper_megakernel.py`` runs the same decode step
in one kernel launch.

Parameters are held in their stored dtype (float32 by default) and every
product runs in ``cfg.dtype``, as the JAX package's ``Dense(dtype=...)``
does; LayerNorm statistics are float32. The encoder's attention and every
product stay plain ``torch`` operations: none is a Pallas kernel in the JAX
package. Weights come from ``models/weights.whisper_from_jax_params`` or
``whisper_from_hf_state_dict``, or from ``init_weights`` (seeded random).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    max_source_positions: int = 1500  # 30 s at 100 Hz, conv stride 2
    max_target_positions: int = 448
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    d_ff: int = 5120
    dtype: str = "bfloat16"


LARGE_V2 = WhisperConfig()
TINY = WhisperConfig(d_model=384, encoder_layers=4, decoder_layers=4,
                     num_heads=6, d_ff=1536)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed audio position embedding."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def _dtype(cfg: WhisperConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with float32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(dim, eps=1e-5)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.out_dtype)


class WhisperAttention(nn.Module):
    """Multi-head attention whose k projection has no bias. Layouts as in the
    JAX module: heads split to ``[B, H, L, d_head]``."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        h = self.cfg.num_heads
        return x.view(b, l, h, self.cfg.d_model // h).transpose(1, 2)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        b, h, l, d = x.shape
        return _linear(x.transpose(1, 2).reshape(b, l, h * d), self.out, _dtype(self.cfg))

    def _q(self, hidden: torch.Tensor) -> torch.Tensor:
        d_head = self.cfg.d_model // self.cfg.num_heads
        return self._split(_linear(hidden, self.q, _dtype(self.cfg))) * (d_head ** -0.5)

    @staticmethod
    def _attend(q, k, v, mask: Optional[torch.Tensor] = None,
                probs_sink: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        if probs_sink is not None:
            probs_sink(probs)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)

    def forward(self, hidden: torch.Tensor, kv: torch.Tensor, causal: bool = False,
                key_mask: Optional[torch.Tensor] = None,
                probs_sink: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
        """Full-sequence attention of ``hidden`` over ``kv``. When asked,
        ``probs_sink`` receives the probabilities [B, H, Lq, Lk] in the
        compute dtype (what the JAX module ``sow``s as ``attn_probs``)."""
        dt = _dtype(self.cfg)
        q = self._q(hidden)
        k = self._split(_linear(kv, self.k, dt))
        v = self._split(_linear(kv, self.v, dt))
        mask = None
        if causal:
            l = hidden.shape[1]
            mask = torch.tril(torch.ones(l, l, dtype=torch.bool, device=q.device))[None, None]
        if key_mask is not None:
            km = key_mask[:, None, None, :].bool()
            mask = km if mask is None else mask & km
        return self._merge(self._attend(q, k, v, mask, probs_sink))

    def precompute_kv(self, kv: torch.Tensor) -> Dict[str, torch.Tensor]:
        dt = _dtype(self.cfg)
        return {"k": self._split(_linear(kv, self.k, dt)).contiguous(),
                "v": self._split(_linear(kv, self.v, dt)).contiguous()}

    def decode_self(self, hidden: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cache_index: int) -> torch.Tensor:
        """One step: the new k/v row is written at ``cache_index`` of the
        cache in place, and the step attends to positions ``<= cache_index``
        (the rest would carry -1e9 and add exactly nothing)."""
        dt = _dtype(self.cfg)
        q = self._q(hidden)
        cache["k"][:, :, cache_index] = self._split(_linear(hidden, self.k, dt))[:, :, 0]
        cache["v"][:, :, cache_index] = self._split(_linear(hidden, self.v, dt))[:, :, 0]
        n = cache_index + 1
        return self._merge(self._attend(q, cache["k"][:, :, :n], cache["v"][:, :, :n]))

    def decode_cross(self, hidden: torch.Tensor, cache: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        """Cross-attention over precomputed K/V. With fewer K/V rows than
        query rows (beam search), ``group`` consecutive query rows (one
        example's beams) share their example's K/V."""
        q = self._q(hidden)
        k, v = cache["k"], cache["v"]
        if k.shape[0] == q.shape[0]:
            return self._merge(self._attend(q, k, v))
        b0, h, lk, dh = k.shape
        group = q.shape[0] // b0
        qg = q.reshape(b0, group, h, q.shape[2], dh)
        scores = torch.einsum("bghqd,bhkd->bghqk", qg, k).float()
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bghqk,bhkd->bghqd", probs, v)
        return self._merge(out.reshape(q.shape[0], h, q.shape[2], dh))


class WhisperLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, is_decoder: bool):
        super().__init__()
        dt = _dtype(cfg)
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.self_attn_norm = LayerNorm(cfg.d_model, dt)
        self.self_attn = WhisperAttention(cfg)
        if is_decoder:
            self.cross_attn_norm = LayerNorm(cfg.d_model, dt)
            self.cross_attn = WhisperAttention(cfg)
        self.ff_norm = LayerNorm(cfg.d_model, dt)
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, cfg.d_model)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype(self.cfg)
        return _linear(F.gelu(_linear(self.ff_norm(x), self.fc1, dt)), self.fc2, dt)

    def forward(self, x: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
                cross_sink: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
        normed = self.self_attn_norm(x)
        x = x + self.self_attn(normed, normed, causal=self.is_decoder)
        if self.is_decoder and enc_out is not None:
            x = x + self.cross_attn(self.cross_attn_norm(x), enc_out, probs_sink=cross_sink)
        return x + self._ff(x)

    def decode(self, x: torch.Tensor, cache: dict, cache_index: int) -> torch.Tensor:
        x = x + self.self_attn.decode_self(self.self_attn_norm(x), cache["self"], cache_index)
        x = x + self.cross_attn.decode_cross(self.cross_attn_norm(x), cache["cross"])
        return x + self._ff(x)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoids(cfg.max_source_positions,
                                                    cfg.d_model)).float(),
            persistent=False)
        self.layers = nn.ModuleList([WhisperLayer(cfg, is_decoder=False)
                                     for _ in range(cfg.encoder_layers)])
        self.ln_post = LayerNorm(cfg.d_model, _dtype(cfg))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, num_mel_bins, 3000] -> [B, 1500, d_model]."""
        dt = _dtype(self.cfg)
        x = mel.to(dt)
        x = F.gelu(F.conv1d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight.to(dt), self.conv2.bias.to(dt),
                            stride=2, padding=1))
        x = x.transpose(1, 2)
        x = x + self.positions[: x.shape[1]].to(dt)[None]
        for layer in self.layers:
            x = layer(x)
        return self.ln_post(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Parameter(torch.zeros(cfg.max_target_positions,
                                                        cfg.d_model))
        self.layers = nn.ModuleList([WhisperLayer(cfg, is_decoder=True)
                                     for _ in range(cfg.decoder_layers)])
        self.ln = LayerNorm(cfg.d_model, _dtype(cfg))

    def embed(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Token embeddings plus learned positions from ``start``, in the
        compute dtype."""
        dt = _dtype(self.cfg)
        x = F.embedding(tokens.long(), self.embed_tokens.weight).to(dt)
        return x + self.embed_positions[start: start + tokens.shape[1]].to(dt)[None]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits of the final-normed ``x``, float32."""
        return torch.matmul(x, self.embed_tokens.weight.to(x.dtype).t()).float()

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        enc = enc_out.to(_dtype(self.cfg))
        for layer in self.layers:
            x = layer(x, enc_out=enc)
        return self.logits(self.ln(x))

    def cross_attention_mean(self, tokens: torch.Tensor, enc_out: torch.Tensor
                             ) -> torch.Tensor:
        """The teacher-forced pass of ``forward`` -> the mean over layers and
        heads of the cross-attention probabilities, float32 [B, T_tok,
        T_aud]: the pooling of word alignment (``factory/align``). Each
        layer's [B, H, T_tok, T_aud] is added into one float32 sum as it
        comes, head by head, layer by layer (numpy's order for
        ``mean(axis=(0, 1))`` of the stacked maps), so no [B, layers, heads,
        ...] stack is kept; the final norm and the logits are skipped."""
        x = self.embed(tokens)
        enc = enc_out.to(_dtype(self.cfg))
        total = None

        def add(probs: torch.Tensor) -> None:
            nonlocal total
            for h in range(probs.shape[1]):
                p = probs[:, h].float()
                total = p.clone() if total is None else total.add_(p)

        for layer in self.layers:
            x = layer(x, enc_out=enc, cross_sink=add)
        return total / float(len(self.layers) * self.cfg.num_heads)

    # ops/decoding cache API -------------------------------------------

    def init_cache(self, batch: int, max_len: int, enc_out: torch.Tensor) -> dict:
        """Self caches ``[batch, H, max_len, d_head]`` of zeros and each
        layer's cross K/V of ``enc_out`` (``enc_out`` has ``batch`` rows, or
        ``batch / beams`` for beam search, whose beams then share it)."""
        cfg = self.cfg
        dt = _dtype(cfg)
        shape = (batch, cfg.num_heads, max_len, cfg.d_model // cfg.num_heads)
        enc = enc_out.to(dt)
        return {f"layer_{i}": {"self": {"k": torch.zeros(shape, dtype=dt, device=enc.device),
                                        "v": torch.zeros(shape, dtype=dt, device=enc.device)},
                               "cross": layer.cross_attn.precompute_kv(enc)}
                for i, layer in enumerate(self.layers)}

    def decode_step(self, token_ids: torch.Tensor, cache: dict, cache_index: int,
                    enc_mask: Optional[torch.Tensor] = None, max_len: Optional[int] = None):
        """One step for ``token_ids [B]`` at position ``cache_index``:
        ``(logits [B, V] float32, cache)``. The self caches are updated in
        place; ``enc_mask`` is unused (Whisper attends to the full
        encoding)."""
        del enc_mask, max_len
        x = self.embed(token_ids[:, None], cache_index)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache[f"layer_{i}"], cache_index)
        return self.logits(self.ln(x))[:, 0], cache


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def init_cache(self, batch: int, max_len: int, enc_out: torch.Tensor) -> dict:
        return self.decoder.init_cache(batch, max_len, enc_out)

    def decode_step(self, token_ids, cache, cache_index, enc_mask=None, max_len=None):
        return self.decoder.decode_step(token_ids, cache, cache_index, enc_mask, max_len)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights on the device of ``generator``: ``nn.Linear``
        and ``Conv1d`` weights normal with std 1/sqrt(fan_in) and zero
        biases (the JAX package's LeCun init, untruncated), LayerNorms at
        one and zero, token embeddings normal with std 1/sqrt(d_model),
        decoder positions normal with std 0.02."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.decoder.embed_tokens.weight.normal_(0.0, self.cfg.d_model ** -0.5,
                                                 generator=generator)
        self.decoder.embed_positions.normal_(0.0, 0.02, generator=generator)
