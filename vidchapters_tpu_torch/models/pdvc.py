"""PDVC dense video captioner in PyTorch.

Counterpart of ``vidchapters_tpu/models/pdvc.py`` (the reference's
PDVC/pdvc/pdvc.py, deformable_transformer.py, base_encoder.py and
CaptioningHead/): a conv1d multi-scale pyramid with GroupNorm and sine
position embeddings; a 1-D multi-scale deformable attention encoder and
decoder (``ops/deformable_attention``, the CUDA kernels on the card); event
queries with iterative box refinement; per-layer class, event-count and box
heads; and a caption head (LSTM, LSTM with deformable soft attention,
GPT-2 over a projected event-query prefix (``models/gpt2.py``), or a no-op
puppet).

Parameters keep the JAX module's names (``enc_{i}`` -> ``enc_layers.{i}``,
``class_head_{i}`` -> ``class_heads.{i}``, ...) so that
``models/weights.pdvc_from_jax_params`` can carry them across; the caption
heads' explicit matrices keep their ``[in, out]`` orientation (``x @ w``).
Dropout runs when a ``StepRng`` is passed (training) and not otherwise.
``init_weights`` draws the JAX package's initializers: the same
distributions, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vidchapters_tpu_torch.config import PDVCConfig
from vidchapters_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_greedy_sample
from vidchapters_tpu_torch.models.t5 import _apply_dropout
from vidchapters_tpu_torch.ops.deformable_attention import (
    deformable_attention_1d,
    deformable_sampling_1d,
)
from vidchapters_tpu_torch.runtime.rng import StepRng

NEG_INF = -1e9


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def box_cl_to_xy(cl: torch.Tensor) -> torch.Tensor:
    """(center, length) -> (start, end)."""
    return torch.stack([cl[..., 0] - 0.5 * cl[..., 1], cl[..., 0] + 0.5 * cl[..., 1]], dim=-1)


def box_xy_to_cl(xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([(xy[..., 0] + xy[..., 1]) * 0.5, xy[..., 1] - xy[..., 0]], dim=-1)


def sine_position_encoding(mask: torch.Tensor, dim: int, temperature: float = 10000.0,
                           normalize: bool = True) -> torch.Tensor:
    """[B, L] validity mask -> [B, L, dim] sine embedding over cumsum
    positions (the JAX package's ``models/grounding.py:42-53``)."""
    x_embed = torch.cumsum(mask.float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(dim, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)
    pos = x_embed[:, :, None] / dim_t
    pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], dim)


def _lecun_normal(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated at 2 std, scaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.copy_(x * std)


def _xavier_uniform(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in, fan_out = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * limit)


def _uniform(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """Flax's ``uniform(scale)``: U[0, scale)."""
    w.copy_(torch.rand(w.shape, generator=generator) * scale)


# ---------------------------------------------------------------------------
# base encoder: conv pyramid
# ---------------------------------------------------------------------------


class ConvGN(nn.Module):
    """Conv1d over time then GroupNorm(32) with Flax's epsilon 1e-6, on
    ``[B, T, C]`` (the layout of the JAX module; torch wants ``[B, C, T]``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride=stride, padding=kernel // 2)
        self.gn = nn.GroupNorm(32, out_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(self.conv(x.transpose(1, 2))).transpose(1, 2)


class BaseEncoder(nn.Module):
    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.proj = nn.ModuleList(
            [ConvGN(cfg.feature_dim, d, 1, 1)]
            + [ConvGN(cfg.feature_dim if lvl == 1 else d, d, 3, 2)
               for lvl in range(1, cfg.num_feature_levels)])

    def forward(self, vf: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """vf [B, T, C_in], mask [B, T] (1 = valid) -> per level (srcs
        [B, T_l, D], masks [B, T_l], pos [B, T_l, D])."""
        d = self.cfg.hidden_dim
        srcs = [self.proj[0](vf)]
        masks = [mask]
        poses = [sine_position_encoding(mask, d)]
        prev, prev_mask = vf, mask
        for lvl in range(1, self.cfg.num_feature_levels):
            prev = self.proj[lvl](prev)
            # nearest mask downsample (base_encoder.py:76)
            t_new = prev.shape[1]
            idx = torch.arange(t_new, device=mask.device) * prev_mask.shape[1] // t_new
            prev_mask = prev_mask[:, idx]
            srcs.append(prev)
            masks.append(prev_mask)
            poses.append(sine_position_encoding(prev_mask, d))
        return srcs, masks, poses


# ---------------------------------------------------------------------------
# deformable attention module
# ---------------------------------------------------------------------------


class MSDeformAttn1D(nn.Module):
    def __init__(self, cfg: PDVCConfig, n_points: int):
        super().__init__()
        self.cfg = cfg
        self.n_points = n_points
        d, m, levels = cfg.hidden_dim, cfg.nheads, cfg.num_feature_levels
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, m * levels * n_points)
        self.attention_weights = nn.Linear(d, m * levels * n_points)
        self.output_proj = nn.Linear(d, d)

    @torch.no_grad()
    def init_offsets(self) -> None:
        """Zero offset and weight kernels, zero weight bias, and the
        grid-prior offset bias (modules/ms_deform_attn.py:62-71, the x
        component; cos of each head's angle divided by max(|cos|, 1e-6))."""
        m, levels, p = self.cfg.nheads, self.cfg.num_feature_levels, self.n_points
        thetas = torch.arange(m, dtype=torch.float32) * (2 * math.pi / m)
        grid = torch.cos(thetas)
        grid = grid / torch.clamp(grid.abs(), min=1e-6)
        base = grid[:, None, None].expand(m, levels, p)
        scale = torch.arange(1, p + 1, dtype=torch.float32)[None, None, :]
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_((base * scale).reshape(-1))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value_src: torch.Tensor, spatial_shapes: Sequence[int],
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Lq, D]; reference_points [B, Lq, L, 1] in [0, 1] (or
        [B, Lq, L, 2] (center, length) boxes); value_src [B, S, D];
        padding_mask [B, S] (1 = valid)."""
        m = self.cfg.nheads
        levels, p = len(spatial_shapes), self.n_points
        b, lq, _ = query.shape
        s = value_src.shape[1]
        value = self.value_proj(value_src)
        if padding_mask is not None:
            value = value * padding_mask[..., None].to(value.dtype)
        value = value.reshape(b, s, m, -1)
        offsets = self.sampling_offsets(query).reshape(b, lq, m, levels, p)
        attn = torch.softmax(self.attention_weights(query).reshape(b, lq, m, levels * p), dim=-1)
        attn = attn.reshape(b, lq, m, levels, p)
        if reference_points.shape[-1] == 1:
            shapes = torch.tensor(spatial_shapes, dtype=torch.float32, device=query.device)
            loc = reference_points[:, :, None, :, None, 0] + offsets / shapes[None, None, None, :, None]
        else:  # (center, length) reference boxes
            loc = (reference_points[:, :, None, :, None, 0]
                   + offsets / p * reference_points[:, :, None, :, None, 1] * 0.5)
        out = deformable_attention_1d(value, tuple(spatial_shapes), loc, attn)
        return self.output_proj(out)


# ---------------------------------------------------------------------------
# encoder / decoder layers
# ---------------------------------------------------------------------------


class EncoderLayer(nn.Module):
    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.self_attn = MSDeformAttn1D(cfg, cfg.enc_n_points)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ff1 = nn.Linear(d, cfg.dim_feedforward)
        self.ff2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask,
                rng: Optional[StepRng] = None):
        rate = self.cfg.dropout
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask)
        src = self.norm1(src + _apply_dropout(h, rate, rng))
        h = _apply_dropout(torch.relu(self.ff1(src)), rate, rng)
        h = self.ff2(h)
        return self.norm2(src + _apply_dropout(h, rate, rng))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.sa_q, self.sa_k, self.sa_v, self.sa_out = (nn.Linear(d, d) for _ in range(4))
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MSDeformAttn1D(cfg, cfg.dec_n_points)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ff1 = nn.Linear(d, cfg.dim_feedforward)
        self.ff2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, memory, spatial_shapes, memory_mask,
                query_mask, rng: Optional[StepRng] = None):
        cfg = self.cfg
        rate, heads = cfg.dropout, cfg.nheads
        d_head = cfg.hidden_dim // heads
        # plain self-attention over the queries
        q = tgt + query_pos
        b, nq, _ = q.shape
        qh = self.sa_q(q).reshape(b, nq, heads, d_head)
        kh = self.sa_k(q).reshape(b, nq, heads, d_head)
        vh = self.sa_v(tgt).reshape(b, nq, heads, d_head)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d_head)
        scores = scores + (1.0 - query_mask.float())[:, None, None, :] * NEG_INF
        probs = torch.softmax(scores, dim=-1)
        sa = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, nq, cfg.hidden_dim)
        tgt = self.norm2(tgt + _apply_dropout(self.sa_out(sa), rate, rng))
        # deformable cross-attention into the memory
        h = self.cross_attn(tgt + query_pos, reference_points, memory, spatial_shapes,
                            memory_mask)
        tgt = self.norm1(tgt + _apply_dropout(h, rate, rng))
        h = self.ff2(_apply_dropout(torch.relu(self.ff1(tgt)), rate, rng))
        return self.norm3(tgt + _apply_dropout(h, rate, rng))


class BoxMLP(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.fc0 = nn.Linear(hidden_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 2)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(torch.relu(self.fc0(x)))))


# ---------------------------------------------------------------------------
# caption heads
# ---------------------------------------------------------------------------


class _LSTMHead(nn.Module):
    """What the two LSTM heads share: the word embedding, the LSTM cell over
    an input of ``in_dim`` (torch ``nn.LSTM(bias=False)`` gate order i, f,
    g, o) and the logit layer, as explicit ``[in, out]`` matrices."""

    def __init__(self, cfg: PDVCConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.rnn_size, cfg.vocab_size + 1
        self.embedding = nn.Parameter(torch.zeros(v, h))
        self.w_x = nn.Parameter(torch.zeros(in_dim, 4 * h))
        self.w_h = nn.Parameter(torch.zeros(h, 4 * h))
        self.logit_w = nn.Parameter(torch.zeros(h, v))
        self.logit_b = nn.Parameter(torch.zeros(v))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _uniform(self.embedding, 0.1, generator)
        _xavier_uniform(self.w_x, generator)
        _xavier_uniform(self.w_h, generator)
        _uniform(self.logit_w, 0.1, generator)
        self.logit_b.zero_()

    def _cell(self, state, x):
        h_prev, c_prev = state
        gates = x @ self.w_x + h_prev @ self.w_h
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def _logprobs(self, h):
        return torch.log_softmax(h @ self.logit_w + self.logit_b, dim=-1)

    def _init_state(self, n: int, ref: torch.Tensor):
        z = ref.new_zeros((n, self.cfg.rnn_size))
        return (z, z)

    def _greedy(self, n: int, max_len: int, step_input, ref: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decoding from BOS = 0: ``step_input(state, tok)`` is the
        LSTM input of a step. Tokens after the first generated 0 are 0, and
        their log-probs 0 (LSTM.py:96-139)."""
        state = self._init_state(n, ref)
        tok = torch.zeros(n, dtype=torch.long, device=ref.device)
        alive = torch.ones(n, dtype=torch.bool, device=ref.device)
        toks, lps = [], []
        for _ in range(max_len):
            state, h = self._cell(state, step_input(state, tok))
            logp = self._logprobs(h)
            nxt = torch.argmax(logp, dim=-1)
            lp = torch.gather(logp, 1, nxt[:, None])[:, 0]
            nxt = torch.where(alive, nxt, torch.zeros_like(nxt))
            lp = torch.where(alive, lp, torch.zeros_like(lp))
            alive = alive & (nxt > 0)
            toks.append(nxt)
            lps.append(lp)
            tok = nxt
        return torch.stack(toks, dim=1), torch.stack(lps, dim=1)


class LSTMCaptioner(_LSTMHead):
    """LSTM over [word embedding ; event-query feature] per step (the
    reference's LightCaptioner: the "clip" context is the query feature)."""

    def __init__(self, cfg: PDVCConfig):
        super().__init__(cfg, cfg.rnn_size + cfg.hidden_dim)

    def teacher_forced_logprobs(self, feats: torch.Tensor, seq: torch.Tensor,
                                ss_prob: float = 0.0,
                                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats [N, C]; seq [N, L] ([0, w1..wk, 0, pad...]) -> log-probs
        [N, L-1, V+1] predicting seq[:, 1:] (the input at step i is
        seq[:, i]).

        ``ss_prob`` > 0 with a ``generator`` turns on scheduled sampling
        (LSTM.py:66-77, the ramp at PDVC/train.py:193-197): from step 1 on,
        each row's input is, with that probability, a draw from the previous
        step's distribution instead of the ground truth. Both draws come
        from ``generator`` (on the device of ``feats``); without one, or at
        0, this is teacher forcing. No entry point passes ``ss_prob``."""
        use_ss = ss_prob > 0.0 and generator is not None
        n = feats.shape[0]
        state = self._init_state(n, feats)
        logps = []
        for step in range(seq.shape[1] - 1):
            tok = seq[:, step]
            if use_ss and step >= 1:
                flip = torch.rand(n, generator=generator, device=feats.device) < ss_prob
                sampled = torch.multinomial(logps[-1].exp(), 1, generator=generator)[:, 0]
                tok = torch.where(flip, sampled.to(tok.dtype), tok)
            state, h = self._cell(state, torch.cat([self.embedding[tok], feats], dim=-1))
            logps.append(self._logprobs(h))
        return torch.stack(logps, dim=1)

    forward = teacher_forced_logprobs

    def greedy_sample(self, feats: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [N, C] -> (tokens [N, max_len], log-probs [N, max_len])."""
        return self._greedy(feats.shape[0], max_len,
                            lambda state, tok: torch.cat([self.embedding[tok], feats], dim=-1),
                            feats)


class DSACaptioner(_LSTMHead):
    """LSTM with deformable soft attention (LSTM_DSA.py:16-270): each step
    samples heads x levels x points clip vectors around the event's
    reference point (offsets from [h_state ; query]), pools them with
    additive attention against the LSTM state, and feeds [word ; pooled ;
    query] to the LSTM."""

    def __init__(self, cfg: PDVCConfig):
        super().__init__(cfg, cfg.rnn_size + 2 * cfg.hidden_dim)
        h, d = cfg.rnn_size, cfg.hidden_dim
        m, levels, p = cfg.cap_nheads, cfg.cap_num_feature_levels, cfg.cap_dec_n_points
        self.d_head = d // m
        self.w_value = nn.Parameter(torch.zeros(d, d))
        self.b_value = nn.Parameter(torch.zeros(d))
        self.w_offset = nn.Parameter(torch.zeros(h + d, m * levels * p))
        self.b_offset = nn.Parameter(torch.zeros(m * levels * p))
        self.w_ctx2att = nn.Parameter(torch.zeros(self.d_head, h))
        self.w_h2att = nn.Parameter(torch.zeros(h, h))
        self.w_alpha = nn.Parameter(torch.zeros(h, 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        for w in (self.w_value, self.w_ctx2att, self.w_h2att, self.w_alpha):
            _xavier_uniform(w, generator)
        for w in (self.b_value, self.w_offset, self.b_offset):
            w.zero_()

    def _level_lengths(self, spatial_shapes, device) -> torch.Tensor:
        """The sampled levels' lengths as a float tensor, made once per call
        (a host-to-device copy in every step would wait on the device)."""
        levels = self.cfg.cap_num_feature_levels
        return torch.tensor(spatial_shapes[:levels], dtype=torch.float32, device=device)

    def _attend(self, h_state, query, reference_points, value, spatial_shapes, lengths):
        """One step of deformable soft attention -> pooled clip feature [N, d]."""
        cfg = self.cfg
        m, levels, p = cfg.cap_nheads, cfg.cap_num_feature_levels, cfg.cap_dec_n_points
        n = query.shape[0]
        joint = torch.cat([h_state, query], dim=-1)
        offsets = (joint @ self.w_offset + self.b_offset).reshape(n, m, levels, p)
        loc = reference_points[:, None, :levels, None] + offsets / lengths[None, None, :, None]
        samples = deformable_sampling_1d(value, tuple(spatial_shapes[:levels]), loc[:, None])
        samples = samples[:, 0].reshape(n, m, levels * p, self.d_head)
        att = torch.tanh(samples @ self.w_ctx2att + (h_state @ self.w_h2att)[:, None, None, :])
        alpha = torch.softmax((att @ self.w_alpha)[..., 0], dim=-1)
        pooled = torch.einsum("nms,nmsd->nmd", alpha, samples)
        return pooled.reshape(n, m * self.d_head)

    def _prep_value(self, memory, memory_mask):
        value = memory @ self.w_value + self.b_value
        value = value * memory_mask[..., None].to(value.dtype)
        n, s, _ = value.shape
        return value.reshape(n, s, self.cfg.cap_nheads, self.d_head)

    def teacher_forced_logprobs(self, feats: torch.Tensor, seq: torch.Tensor,
                                reference_points: torch.Tensor, memory: torch.Tensor,
                                memory_mask: torch.Tensor,
                                spatial_shapes: Tuple[int, ...]) -> torch.Tensor:
        """feats [N, C] (event queries); reference_points [N, L] (per-level
        normalized centers); memory [N, S, C]. Returns [N, L_seq-1, V+1]."""
        value = self._prep_value(memory, memory_mask)
        lengths = self._level_lengths(spatial_shapes, feats.device)
        emb = self.embedding[seq[:, :-1]]
        state = self._init_state(feats.shape[0], feats)
        logps = []
        for step in range(emb.shape[1]):
            pooled = self._attend(state[0], feats, reference_points, value, spatial_shapes,
                                  lengths)
            state, h = self._cell(state, torch.cat([emb[:, step], pooled, feats], dim=-1))
            logps.append(self._logprobs(h))
        return torch.stack(logps, dim=1)

    forward = teacher_forced_logprobs

    def greedy_sample(self, feats: torch.Tensor, reference_points: torch.Tensor,
                      memory: torch.Tensor, memory_mask: torch.Tensor,
                      spatial_shapes: Tuple[int, ...], max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        value = self._prep_value(memory, memory_mask)
        lengths = self._level_lengths(spatial_shapes, feats.device)

        def step_input(state, tok):
            pooled = self._attend(state[0], feats, reference_points, value, spatial_shapes,
                                  lengths)
            return torch.cat([self.embedding[tok], pooled, feats], dim=-1)

        return self._greedy(feats.shape[0], max_len, step_input, feats)


class PuppetCaptioner(nn.Module):
    """No-op caption head for localization-only runs (Puppet.py): uniform
    log-probs (a constant NLL with zero gradient), empty samples."""

    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        self.cfg = cfg

    def init_weights(self, generator: torch.Generator) -> None:
        pass

    def teacher_forced_logprobs(self, feats: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
        n, length = seq.shape
        return feats.new_zeros((n, length - 1, self.cfg.vocab_size + 1), dtype=torch.float32)

    forward = teacher_forced_logprobs

    def greedy_sample(self, feats: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = feats.shape[0]
        return (torch.zeros((n, max_len), dtype=torch.long, device=feats.device),
                torch.zeros((n, max_len), dtype=torch.float32, device=feats.device))


class GPT2Captioner(nn.Module):
    """GPT-2 caption head conditioned on a projected event-query prefix
    (PDVC/pdvc/pdvc.py:56-57, 413-427: ``inputs_embeds = [query2cap(event);
    wte(seq)]``, prefix label -100), at ``cfg.cap_gpt2_*``'s geometry."""

    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        self.cfg = cfg
        self.gpt2 = GPT2(GPT2Config(vocab_size=cfg.cap_gpt2_vocab, n_embd=cfg.cap_gpt2_n_embd,
                                    n_layer=cfg.cap_gpt2_n_layer, n_head=cfg.cap_gpt2_n_head))
        self.query2cap = nn.Linear(cfg.hidden_dim, cfg.cap_gpt2_n_embd)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.gpt2.init_weights(generator)
        _lecun_normal(self.query2cap.weight, self.query2cap.in_features, generator)
        self.query2cap.bias.zero_()

    def teacher_forced_logprobs(self, feats: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
        """feats [N, C]; seq [N, L] -> log-probs [N, L-1, V] predicting
        seq[:, 1:], the LSTM heads' convention: inputs = [prefix ;
        wte(seq[:, :-1])], so logit position j >= 1 predicts seq[:, j]
        (pdvc.py:413-418 with HF's internal label shift)."""
        prefix = self.query2cap(feats)[:, None]
        logits = self.gpt2(tokens=seq[:, :-1], prefix_embeds=prefix)
        return torch.log_softmax(logits[:, 1:], dim=-1)

    forward = teacher_forced_logprobs

    @torch.no_grad()
    def greedy_sample(self, feats: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy continuation after the projected prefix (the reference's
        ``cap_head.generate(inputs_embeds=query2cap(clip))``, pdvc.py:516-519)
        -> (tokens [N, max_len], log-probs [N, max_len]) by
        ``gpt2_greedy_sample``. Tokens after the first ``cap_gpt2_eos`` or 0
        are 0, and their log-probs 0, as in the LSTM heads' samples (the
        model is causal, so what it ran after that token changes nothing
        before it)."""
        toks, lps = gpt2_greedy_sample(self.gpt2, self.query2cap(feats)[:, None], max_len,
                                       eos_id=self.cfg.cap_gpt2_eos, with_logprobs=True)
        stop = ((toks == self.cfg.cap_gpt2_eos) | (toks == 0)).int()
        after = (torch.cumsum(stop, dim=1) - stop) > 0
        return toks.masked_fill(after, 0), lps.masked_fill(after, 0.0)


def build_captioner(cfg: PDVCConfig) -> nn.Module:
    """Caption head by ``cfg.caption_decoder_type`` (CaptioningHead/__init__.py:6-24;
    "standard" is the reference's name for the DSA head, "dsa" an alias; the
    gpt2 branch is PDVC/pdvc/pdvc.py:56-57)."""
    kind = cfg.caption_decoder_type
    if kind == "none":
        return PuppetCaptioner(cfg)
    if kind == "light":
        return LSTMCaptioner(cfg)
    if kind in ("standard", "dsa"):
        return DSACaptioner(cfg)
    if kind == "gpt2":
        return GPT2Captioner(cfg)
    raise ValueError(f"caption decoder type is invalid: {kind!r}")


def _uses_context(cfg: PDVCConfig) -> bool:
    return cfg.caption_decoder_type in ("standard", "dsa")


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------


class PDVC(nn.Module):
    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(f"PDVC dtype {cfg.dtype!r}: only float32 is ported")
        self.cfg = cfg
        d = cfg.hidden_dim
        self.base_encoder = BaseEncoder(cfg)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, 2 * d))
        self.reference_points = nn.Linear(d, 1)
        # two-stage / proposal path (deformable_transformer.py:137-143)
        self.pos_trans = nn.Linear(2 * (d // 2 * 2), 2 * d)
        self.pos_trans_norm = nn.LayerNorm(2 * d, eps=1e-5)
        self.class_heads = nn.ModuleList(nn.Linear(d, 1) for _ in range(cfg.dec_layers))
        self.count_heads = nn.ModuleList(nn.Linear(d, cfg.max_eseq_length + 1)
                                         for _ in range(cfg.dec_layers))
        self.bbox_heads = nn.ModuleList(BoxMLP(d) for _ in range(cfg.dec_layers))
        self.captioner = build_captioner(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PDVC":
        """The JAX module's initializers: lecun-normal Dense and Conv
        kernels with zero biases, unit norms, normal(1) level and query
        embeddings, the deformable grid prior, the focal class prior
        -log(99), BoxMLP's zero last layer with bias [0, -2], and the caption
        head's uniform(0.1) / Xavier matrices."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                _lecun_normal(mod.weight, mod.in_channels * mod.kernel_size[0], generator)
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, MSDeformAttn1D):
                mod.init_offsets()
        self.level_embed.copy_(torch.randn(self.level_embed.shape, generator=generator))
        self.query_embed.copy_(torch.randn(self.query_embed.shape, generator=generator))
        prior = 0.01
        for head in self.class_heads:
            head.bias.fill_(-math.log((1 - prior) / prior))
        for head in self.bbox_heads:
            head.fc2.weight.zero_()
            head.fc2.bias.copy_(torch.tensor([0.0, -2.0]))
        self.captioner.init_weights(generator)
        return self

    # -- encoder ------------------------------------------------------------

    def encode(self, vf: torch.Tensor, mask: torch.Tensor, rng: Optional[StepRng] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...], torch.Tensor]:
        srcs, masks, poses = self.base_encoder(vf, mask)
        spatial_shapes = tuple(int(s.shape[1]) for s in srcs)
        src_flat = torch.cat(srcs, dim=1)
        mask_flat = torch.cat(masks, dim=1)
        pos_flat = torch.cat([p + self.level_embed[i][None, None] for i, p in enumerate(poses)],
                             dim=1)
        # valid ratios per level (deformable_transformer.py:66-68)
        valid_ratios = torch.stack([m.sum(1).float() / m.shape[1] for m in masks], dim=1)
        # encoder reference points: per-level normalized centers scaled by
        # the valid ratios (deformable_transformer.py:199-208)
        refs = []
        for lvl, t_l in enumerate(spatial_shapes):
            centers = torch.arange(t_l, dtype=torch.float32, device=vf.device) + 0.5
            refs.append(centers[None, :] / (valid_ratios[:, lvl:lvl + 1] * t_l))
        ref_flat = torch.cat(refs, dim=1)  # [B, S]
        reference_points = (ref_flat[:, :, None] * valid_ratios[:, None, :])[..., None]
        memory = src_flat
        for layer in self.enc_layers:
            memory = layer(memory, pos_flat, reference_points, spatial_shapes, mask_flat, rng)
        return memory, mask_flat, spatial_shapes, valid_ratios

    # -- decoder with iterative refinement ----------------------------------

    def _proposal_pos_embed(self, proposals_unact: torch.Tensor,
                            num_pos_feats: int = 256) -> torch.Tensor:
        """Sine embedding of (center, length) proposal logits
        (deformable_transformer.py:64-78)."""
        temperature, scale = 10000.0, 2 * math.pi
        dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals_unact.device)
        dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
        pos = torch.sigmoid(proposals_unact) * scale
        pos = pos[..., None] / dim_t  # [B, Q, 2, num_pos_feats]
        pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
        return pos.reshape(pos.shape[0], pos.shape[1], -1)

    def decode(self, memory: torch.Tensor, mask_flat: torch.Tensor,
               spatial_shapes: Tuple[int, ...], valid_ratios: torch.Tensor,
               rng: Optional[StepRng] = None, proposals: Optional[torch.Tensor] = None,
               proposals_mask: Optional[torch.Tensor] = None):
        """Learned-query decoding, or the two-stage proposal path when
        ``proposals`` [B, Q, 2] (center, length in (0, 1)) is given
        (pdvc.py:141-151)."""
        cfg = self.cfg
        b = memory.shape[0]
        if proposals is not None:
            unact = inverse_sigmoid(proposals)
            pos_out = self.pos_trans_norm(self.pos_trans(
                self._proposal_pos_embed(unact, cfg.hidden_dim // 2 * 2)))
            query_pos, tgt = torch.chunk(pos_out, 2, dim=-1)
            query_mask = (proposals_mask.int() if proposals_mask is not None
                          else torch.ones(proposals.shape[:2], dtype=torch.int32,
                                          device=memory.device))
            return self._run_decoder(tgt, query_pos, proposals[..., :1], query_mask, memory,
                                     mask_flat, spatial_shapes, valid_ratios, rng)
        qe = self.query_embed[None].expand((b,) + tuple(self.query_embed.shape))
        query_pos, tgt = torch.chunk(qe, 2, dim=-1)
        reference = torch.sigmoid(self.reference_points(query_pos))  # [B, Q, 1]
        query_mask = torch.ones((b, cfg.num_queries), dtype=torch.int32, device=memory.device)
        return self._run_decoder(tgt, query_pos, reference, query_mask, memory, mask_flat,
                                 spatial_shapes, valid_ratios, rng)

    def _run_decoder(self, tgt, query_pos, reference, query_mask, memory, mask_flat,
                     spatial_shapes, valid_ratios, rng):
        init_reference = reference
        hs_layers, ref_layers = [], []
        for lid, layer in enumerate(self.dec_layers):
            ref_input = reference[:, :, None, :] * valid_ratios[:, None, :, None]
            tgt = layer(tgt, query_pos, ref_input, memory, spatial_shapes, mask_flat,
                        query_mask, rng)
            if self.cfg.with_box_refine:
                delta = self.bbox_heads[lid](tgt)
                reference = torch.sigmoid(delta[..., :1] + inverse_sigmoid(reference)).detach()
            hs_layers.append(tgt)
            ref_layers.append(reference)
        return torch.stack(hs_layers), init_reference, torch.stack(ref_layers)

    # -- full forward --------------------------------------------------------

    def forward(self, vf: torch.Tensor, mask: torch.Tensor, rng: Optional[StepRng] = None
                ) -> Dict[str, Any]:
        cfg = self.cfg
        memory, mask_flat, spatial_shapes, valid_ratios = self.encode(vf, mask, rng)
        hs, init_reference, inter_references = self.decode(memory, mask_flat, spatial_shapes,
                                                           valid_ratios, rng)
        logits_layers, count_layers, boxes_layers = [], [], []
        for lid in range(cfg.dec_layers):
            hs_lid = hs[lid]
            reference = init_reference if lid == 0 else inter_references[lid - 1]
            logits_layers.append(self.class_heads[lid](hs_lid))
            count_layers.append(self.count_heads[lid](hs_lid.max(dim=1).values))
            delta = self.bbox_heads[lid](hs_lid)
            boxes_layers.append(torch.sigmoid(torch.cat(
                [delta[..., :1] + inverse_sigmoid(reference), delta[..., 1:]], dim=-1)))
        # the DSA head's context: the final layer's pre-refinement reference
        # (the one its boxes use, pdvc.py:390) and the encoder memory
        cap_reference = (init_reference if cfg.dec_layers == 1
                         else inter_references[cfg.dec_layers - 2])
        return {
            "pred_logits": torch.stack(logits_layers),  # [Lyr, B, Q, 1]
            "pred_count": torch.stack(count_layers),  # [Lyr, B, max_eseq+1]
            "pred_boxes": torch.stack(boxes_layers),  # [Lyr, B, Q, 2] (c, l)
            "hs": hs,  # [Lyr, B, Q, C]
            "cap_reference": cap_reference,  # [B, Q, 1]
            "memory": memory,  # [B, S, C]
            "memory_mask": mask_flat,  # [B, S]
            "valid_ratios": valid_ratios,  # [B, L]
            "spatial_shapes": spatial_shapes,  # tuple of ints
        }

    def caption_context(self, outputs: Dict[str, Any],
                        query_idx: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Per-event DSA context from a forward's outputs (pdvc.py:385-396):
        reference points per level and the encoder memory broadcast to every
        event. ``query_idx`` [B, T] picks queries per batch row (matched
        events); None takes all Q. Arrays are flattened to N = B*T rows."""
        ref = outputs["cap_reference"]  # [B, Q, 1]
        vr = outputs["valid_ratios"]  # [B, L]
        memory, mmask = outputs["memory"], outputs["memory_mask"]
        if query_idx is not None:
            ref = torch.gather(ref, 1, query_idx[..., None])
        b, t = ref.shape[:2]
        ref_levels = ref[..., 0][:, :, None] * vr[:, None, :]  # [B, T, L]
        s, c = memory.shape[1:]
        return {
            "reference_points": ref_levels.reshape(b * t, -1),
            "memory": memory[:, None].expand(b, t, s, c).reshape(b * t, s, c),
            "memory_mask": mmask[:, None].expand(b, t, s).reshape(b * t, s),
            "spatial_shapes": outputs["spatial_shapes"],
        }

    def caption_logprobs(self, feats: torch.Tensor, seq: torch.Tensor,
                         ctx: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Teacher-forced log-probs of the configured head; the DSA head also
        needs a ``caption_context`` dict."""
        if _uses_context(self.cfg):
            return self.captioner.teacher_forced_logprobs(
                feats, seq, ctx["reference_points"], ctx["memory"], ctx["memory_mask"],
                ctx["spatial_shapes"])
        return self.captioner.teacher_forced_logprobs(feats, seq)

    def caption_sample(self, feats: torch.Tensor, max_len: int,
                       ctx: Optional[Dict[str, Any]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        if _uses_context(self.cfg):
            return self.captioner.greedy_sample(
                feats, ctx["reference_points"], ctx["memory"], ctx["memory_mask"],
                ctx["spatial_shapes"], max_len)
        return self.captioner.greedy_sample(feats, max_len)
