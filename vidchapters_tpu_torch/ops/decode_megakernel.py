"""One T5 decoder step over all layers in one kernel launch.

``mega_decode_step`` launches ``csrc/decode_megakernel.cu`` for CUDA tensors
and runs ``mega_decode_step_plain`` (the same function in plain PyTorch)
for CPU tensors. The host side stacks the decoder weights layer-major (the
JAX package's ``[N, in, out]``, which the plain version takes, plus once the
kernel's ``[N, out, in]`` copy, ``with_kernel_layout``), precomputes the
relative-position bias table and the cross-attention K/V, and wires it all
into ``DecodeFns`` for ``ops/decoding.py``. Counterpart of
``vidchapters_tpu/ops/decode_megakernel.py``; its prefix-skip over cache
chunks and int8 cross K/V are not carried over (neither changes results).

Layouts (as in the JAX package): x ``[B, d]``; self caches ``[B, N, L,
inner]``; cross K/V ``[B0, N, Lenc, inner]`` with ``B = B0 * group``;
``bias_row [L, H]`` and ``bias0 [1, H]`` float32; ``enc_mask [B0, Lenc]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vidchapters_tpu_torch.ops._build import (F, I, P, CudaKernel, arrival_counters,
                                              stream_ptr)

NEG_INF = -1e9
MAX_GROUP = 8  # beams per example the kernel takes
PHASES = 8  # grid barriers a layer: q|k|v, self-attention, self out, cross q,
            # cross-attention, cross out, wi, wo_ff

KERNEL = CudaKernel("decode_megakernel", {
    "mega_decode_step": [P] * 25 + [I] * 11 + [F, I, P],
    "mega_decode_workspace": [I] * 11,
    "mega_decode_barriers": [P, P, I, P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("wqkv", "wo_self", "wq_cross", "wo_cross", "wi", "wo_ff")


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float, cdt) -> torch.Tensor:
    """fp32 RMSNorm of fp32 ``x``, rounded through the working type."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (w * (x * torch.rsqrt(var + eps))).to(cdt).float()


def _gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    return 0.5 * g * (1.0 + torch.tanh(0.7978845608028654 * (g + 0.044715 * g * g * g)))


def mega_decode_step_plain(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           k_cross: torch.Tensor, v_cross: torch.Tensor,
                           bias_row: torch.Tensor, bias0: torch.Tensor,
                           enc_mask: torch.Tensor, cache_index: int, group: int,
                           heads: int, eps: float = 1e-6,
                           src: Optional[torch.Tensor] = None,
                           out_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           gated: bool = False):
    """The kernel's function in plain PyTorch (fp32 arithmetic, rounded
    through x's dtype where the kernel and the TPU kernel round: after each
    weight product, each norm and each residual add, so the residual stream
    holds x's dtype through the step). Same arguments and results as
    ``mega_decode_step``."""
    cdt = x.dtype
    r = lambda t: t.to(cdt).float()  # noqa: E731 - rounding through the working type
    bsz, d = x.shape
    _, n_layers, _, inner = k_cache.shape
    b0, _, lenc, _ = k_cross.shape
    dkv = inner // heads
    idx = int(cache_index)
    if src is not None:
        k_att = k_cache.index_select(0, src.long())
        v_att = v_cache.index_select(0, src.long())
    else:
        k_att, v_att = k_cache, v_cache
    k_new = torch.empty(bsz, n_layers, inner, dtype=cdt, device=x.device)
    v_new = torch.empty_like(k_new)
    valid = (enc_mask > 0)[:, None, None, :]
    xs = x.float()
    for i in range(n_layers):
        ln = stacked["ln"][i].float()
        # self-attention over rows 0..idx (row idx is this step's k/v)
        h = _rms(xs, ln[0], eps, cdt)
        qkv = r(h @ stacked["wqkv"][i].float())
        q, kn, vn = qkv[:, :inner], qkv[:, inner:2 * inner], qkv[:, 2 * inner:]
        k_att[:, i, idx] = kn.to(cdt)
        v_att[:, i, idx] = vn.to(cdt)
        k_new[:, i] = kn.to(cdt)
        v_new[:, i] = vn.to(cdt)
        keys = k_att[:, i, :idx + 1].float().view(bsz, idx + 1, heads, dkv)
        vals = v_att[:, i, :idx + 1].float().view(bsz, idx + 1, heads, dkv)
        s = torch.einsum("bhd,blhd->bhl", q.view(bsz, heads, dkv), keys)
        bias = torch.cat([bias_row[:idx].float(), bias0.float().view(1, heads)], 0)
        s = s + bias.t()[None]
        p = torch.softmax(s, dim=-1)
        ctx = r(torch.einsum("bhl,blhd->bhd", p, vals).reshape(bsz, inner))
        xs = r(xs + r(ctx @ stacked["wo_self"][i].float()))
        # cross-attention: the beams of an example share its K/V
        h = _rms(xs, ln[1], eps, cdt)
        qc = r(h @ stacked["wq_cross"][i].float()).view(b0, group, heads, dkv)
        kx = k_cross[:, i].float().view(b0, lenc, heads, dkv)
        vx = v_cross[:, i].float().view(b0, lenc, heads, dkv)
        s = torch.einsum("bghd,blhd->bghl", qc, kx)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        ctx = r(torch.einsum("bghl,blhd->bghd", p, vx).reshape(bsz, inner))
        xs = r(xs + r(ctx @ stacked["wo_cross"][i].float()))
        # feed-forward
        h = _rms(xs, ln[2], eps, cdt)
        hh = r(h @ stacked["wi"][i].float())
        if gated:
            dff = hh.shape[-1] // 2
            act = r(_gelu_tanh(hh[:, :dff]) * hh[:, dff:])
        else:
            act = torch.relu(hh)
        xs = r(xs + r(act @ stacked["wo_ff"][i].float()))
    hidden = _rms(xs, stacked["final_ln"][0].float(), eps, cdt).to(cdt)
    if src is None:
        return hidden, k_new, v_new
    if out_caches is not None:
        out_caches[0].copy_(k_att)
        out_caches[1].copy_(v_att)
        k_att, v_att = out_caches
    return hidden, k_new, v_new, k_att, v_att


def with_kernel_layout(stacked: Dict[str, torch.Tensor]) -> Dict:
    """``stacked`` and, under ``"kernel"``, its six weights in the kernel's
    layout: each ``[N, in, out]`` transposed to ``[N, out, in]`` (the rows
    of a weight are the tensor cores' A operand); a gated ``wi`` ``[N, d,
    2 dff]`` (gate | linear) becomes ``[N, 2 dff, d]`` with the halves
    interleaved 8 columns at a time (rows 16 j .. 16 j + 7 are gate columns
    8 j .. 8 j + 7, the next 8 rows the same linear columns). Made once per
    set of weights, on their device, before the steps that launch the
    kernel."""
    out = {name: stacked[name].transpose(1, 2).contiguous() for name in _WEIGHTS}
    n, width, d = out["wi"].shape
    if width == 2 * stacked["wo_ff"].shape[1]:  # gated
        dff = width // 2
        gate, lin = out["wi"][:, :dff], out["wi"][:, dff:]
        out["wi"] = torch.cat([gate.reshape(n, dff // 8, 8, d), lin.reshape(n, dff // 8, 8, d)],
                              dim=2).reshape(n, width, d).contiguous()
    return {**stacked, "kernel": out}


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mega_decode_step: {name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"mega_decode_step: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"mega_decode_step: {name} must be a contiguous CUDA tensor")


def mega_decode_step(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_cross: torch.Tensor, v_cross: torch.Tensor,
                     bias_row: torch.Tensor, bias0: torch.Tensor,
                     enc_mask: torch.Tensor, cache_index: int, group: int,
                     heads: int, eps: float = 1e-6,
                     src: Optional[torch.Tensor] = None,
                     out_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     gated: bool = False, timeline: Optional[torch.Tensor] = None):
    """One decoder step over all layers.

    Returns ``(hidden [B, d] after the final norm, k_new [B, N, inner],
    v_new)``. Without ``src`` (greedy), row ``cache_index`` of k_cache /
    v_cache is written in place. With ``src [B]`` (beam search), the caches
    are first permuted by rows (the previous step's deferred beam reorder)
    into a second pair of buffers, ``out_caches`` or new ones, whose row
    ``cache_index`` holds the new k/v; the kernel writes their rows up to
    ``cache_index`` only. Then the result also carries those two buffers.

    On CUDA, ``stacked`` must carry the kernel's weight layout
    (``with_kernel_layout``). ``timeline`` (CUDA only; an int64 tensor of
    ``8 N + 3`` slots) receives the device clock in ns at the start, after
    the set-up and after each phase, and at the end.
    """
    if x.device.type == "cpu":
        return mega_decode_step_plain(stacked, x, k_cache, v_cache, k_cross,
                                      v_cross, bias_row, bias0, enc_mask,
                                      cache_index, group, heads, eps, src,
                                      out_caches, gated)
    cdt = x.dtype
    if cdt not in _DTYPE_CODE:
        raise TypeError(f"mega_decode_step takes float32 or bfloat16, not {cdt}")
    bsz, d = x.shape
    _, n_layers, length, inner = k_cache.shape
    b0, _, lenc, _ = k_cross.shape
    dff = stacked["wo_ff"].shape[1]
    idx = int(cache_index)
    if d % 8 or inner % 8 or dff % 8:
        raise ValueError("mega_decode_step: d, inner and d_ff must be multiples of 8")
    if inner % heads or (inner // heads) % 32 or inner // heads > 128:
        raise ValueError(f"mega_decode_step: {heads} heads of {inner} lanes: the head "
                         f"width must be 32, 64, 96 or 128")
    if not 1 <= group <= MAX_GROUP or bsz != b0 * group:
        raise ValueError(f"mega_decode_step: {bsz} rows is not {b0} examples "
                         f"x group {group} (group <= {MAX_GROUP})")
    if not 0 <= idx < length:
        raise ValueError(f"mega_decode_step: cache_index {idx} outside [0, {length})")
    _check("x", x, (bsz, d), cdt)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, t, (bsz, n_layers, length, inner), cdt)
    for name, t in (("k_cross", k_cross), ("v_cross", v_cross)):
        _check(name, t, (b0, n_layers, lenc, inner), cdt)
    _check("ln", stacked["ln"], (n_layers, 3, d), torch.float32)
    _check("final_ln", stacked["final_ln"], (1, d), torch.float32)
    wshapes = {"wqkv": (d, 3 * inner), "wo_self": (inner, d),
               "wq_cross": (d, inner), "wo_cross": (inner, d),
               "wi": (d, 2 * dff if gated else dff), "wo_ff": (dff, d)}
    if "kernel" not in stacked:
        raise ValueError("mega_decode_step: the weights need the kernel layout on the card: "
                         "pass with_kernel_layout(stacked), made once")
    for name in _WEIGHTS:
        _check(f"kernel {name}", stacked["kernel"][name],
               (n_layers,) + wshapes[name][::-1], cdt)
    _check("bias_row", bias_row, (length, heads), torch.float32)
    _check("bias0", bias0, (1, heads), torch.float32)
    _check("enc_mask", enc_mask, (b0, lenc), torch.int32)
    if timeline is not None:
        _check("timeline", timeline, (PHASES * n_layers + 3,), torch.int64)
    if src is not None:
        _check("src", src, (bsz,), torch.int32)
        if out_caches is None:
            out_caches = (torch.empty_like(k_cache), torch.empty_like(v_cache))
        k_att, v_att = out_caches
        _check("out k cache", k_att, k_cache.shape, cdt)
        _check("out v cache", v_att, v_cache.shape, cdt)
        if k_att.data_ptr() in (k_cache.data_ptr(), v_cache.data_ptr()):
            raise ValueError("mega_decode_step: out_caches must not alias the caches")
    else:
        k_att, v_att = k_cache, v_cache
    hidden, k_new, v_new = _launch_step(stacked, x, k_cache, v_cache, k_att, v_att, k_cross,
                                        v_cross, bias_row, bias0, enc_mask, idx, group, heads,
                                        eps, src, gated, timeline)
    if src is None:
        return hidden, k_new, v_new
    return hidden, k_new, v_new, k_att, v_att


def _launch_step(stacked, x, k_cache, v_cache, k_att, v_att, k_cross, v_cross, bias_row,
                 bias0, enc_mask, idx: int, group: int, heads: int, eps: float, src,
                 gated: bool, timeline) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Allocate the outputs and the kernel's scratch on x's device and launch
    (shapes already checked). Returns (hidden, k_new, v_new)."""
    cdt = x.dtype
    bsz, d = x.shape
    _, n_layers, length, inner = k_cache.shape
    lenc = k_cross.shape[2]
    dff = stacked["wo_ff"].shape[1]
    hidden = torch.empty(bsz, d, dtype=cdt, device=x.device)
    k_new = torch.empty(bsz, n_layers, inner, dtype=cdt, device=x.device)
    v_new = torch.empty_like(k_new)
    # the kernel's scratch (residual, q, context, FF rows, partial sums and
    # softmax states) and its grid barrier and merge counters, as it sizes
    # them; the counters are at 0 and the kernel leaves them at 0
    sizes = [KERNEL._load().mega_decode_workspace(bsz, length, lenc, d, inner, heads, dff,
                                                  int(gated), group, _DTYPE_CODE[cdt], which)
             for which in (0, 1)]
    if min(sizes) < 0:
        raise ValueError(f"mega_decode_step: no workspace for {bsz} rows at d {d}, d_ff {dff}")
    ws = torch.empty(sizes[0], dtype=torch.float32, device=x.device)
    counters = arrival_counters(x.device, sizes[1])
    kw = stacked["kernel"]
    KERNEL.launch(
        "mega_decode_step", x.data_ptr(), stacked["ln"].data_ptr(),
        *(kw[n].data_ptr() for n in _WEIGHTS),
        stacked["final_ln"].data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_att.data_ptr(), v_att.data_ptr(), k_cross.data_ptr(),
        v_cross.data_ptr(), bias_row.data_ptr(), bias0.data_ptr(),
        enc_mask.data_ptr(), 0 if src is None else src.data_ptr(),
        hidden.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), 0 if timeline is None else timeline.data_ptr(),
        bsz, n_layers, length, lenc, d, inner, heads, dff, int(gated), group,
        idx, float(eps), _DTYPE_CODE[cdt], stream_ptr())
    return hidden, k_new, v_new


def barrier_step(n_barriers: int) -> torch.Tensor:
    """The kernel's grid barriers alone: ``n_barriers`` of them on the same
    cooperative grid, nothing else (CUDA only). Returns the device clock in
    ns at the start and after each barrier (``n_barriers + 1`` int64)."""
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    timeline = torch.zeros(n_barriers + 1, dtype=torch.int64, device="cuda")
    rc = KERNEL._load().mega_decode_barriers(bar.data_ptr(), timeline.data_ptr(),
                                             n_barriers, stream_ptr())
    if rc != 0:
        raise RuntimeError(f"mega_decode_barriers failed to launch: cudaError_t {rc}")
    return timeline


# ---------------------------------------------------------------------------
# Host side: weight stacking, bias table, DecodeFns
# ---------------------------------------------------------------------------


def stack_decoder_weights(t5, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Layer-major decoder weights in the JAX package's ``[in, out]`` layout
    (packed q|k|v for self-attention, wi_0|wi_1 when gated), from the port's
    ``T5ForConditionalGeneration``; ``with_kernel_layout`` adds the kernel's."""
    blocks = t5.decoder.blocks
    tw = lambda lin: lin.weight.detach().t()  # noqa: E731 - nn.Linear [out, in] -> [in, out]

    def stack(fn, dt=dtype):
        return torch.stack([fn(b) for b in blocks]).to(dt).contiguous()

    def wi(b):
        if t5.cfg.is_gated_act:
            return torch.cat([tw(b.ff.wi_0), tw(b.ff.wi_1)], dim=1)
        return tw(b.ff.wi)

    return {
        "ln": stack(lambda b: torch.stack([b.self_attn_norm.weight,
                                           b.cross_attn_norm.weight,
                                           b.ff_norm.weight]).detach(),
                    torch.float32),
        "wqkv": stack(lambda b: torch.cat([tw(b.self_attn.q), tw(b.self_attn.k),
                                           tw(b.self_attn.v)], dim=1)),
        "wo_self": stack(lambda b: tw(b.self_attn.o)),
        "wq_cross": stack(lambda b: tw(b.cross_attn.q)),
        "wo_cross": stack(lambda b: tw(b.cross_attn.o)),
        "wi": stack(wi),
        "wo_ff": stack(lambda b: tw(b.ff.wo)),
        "final_ln": t5.decoder.final_norm.weight.detach()[None].float().contiguous(),
        # used once per generate call to precompute the cross K/V
        "wk_cross": stack(lambda b: tw(b.cross_attn.k)),
        "wv_cross": stack(lambda b: tw(b.cross_attn.v)),
    }


def precompute_bias_table(t5, max_len: int) -> torch.Tensor:
    """[Lq, Lk, H] float32 decoder rel-pos bias for every slot pair."""
    from vidchapters_tpu_torch.models.t5 import relative_position_bucket

    cfg = t5.cfg
    emb = t5.decoder.rel_bias.rel_embedding.detach().float()
    pos = torch.arange(max_len, device=emb.device)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], False, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    return emb[buckets].contiguous()


def make_mega_decode_fns(t5, max_length: int, num_beams: int = 1):
    """``DecodeFns`` backed by the decode kernel, for the port's
    ``T5ForConditionalGeneration`` ``t5`` (its parameters already in the
    decode weight dtype, on the device to run on).

    ``init_cache(batch, enc_out)`` takes the per-beam row count (B0 *
    beams) and the per-example encoder states. Beam search keeps the
    permutation deferred: ``reorder_cache`` stores it as ``pending_src`` and
    the next step's kernel applies it while it copies the cache rows into
    the spare pair of buffers, which then become the live pair.
    """
    from vidchapters_tpu_torch.ops.decoding import DecodeFns

    cfg = t5.cfg
    cdt = getattr(torch, cfg.dtype)
    group = max(1, num_beams)
    heads, inner, n = cfg.num_heads, cfg.num_heads * cfg.d_kv, cfg.num_decoder_layers
    stacked = stack_decoder_weights(t5, cdt)
    if stacked["wqkv"].device.type == "cuda":
        stacked = with_kernel_layout(stacked)
    bias_all = precompute_bias_table(t5, max_length)      # [L, L, H]
    bias0 = bias_all[0, :1, :].contiguous()               # distance-0 bias [1, H]
    emb = t5.shared.weight.detach()
    # logits operand, transposed once: bf16 values held in fp32 so the
    # product accumulates in fp32 and is returned unrounded
    if cfg.tie_word_embeddings:
        head_t = emb.to(cdt).float().t().contiguous()
    else:
        head_t = t5.lm_head.weight.detach().to(cdt).t().contiguous()

    def init_cache(batch: int, enc_out: torch.Tensor):
        enc = enc_out.to(cdt)
        kx = torch.einsum("bld,ndi->bnli", enc, stacked["wk_cross"]).contiguous()
        vx = torch.einsum("bld,ndi->bnli", enc, stacked["wv_cross"]).contiguous()
        shape = (batch, n, max_length, inner)
        cache = {
            "self_k": torch.zeros(shape, dtype=cdt, device=enc.device),
            "self_v": torch.zeros(shape, dtype=cdt, device=enc.device),
            "cross": {"k": kx, "v": vx},
        }
        if group > 1:
            cache["spare_k"] = torch.empty(shape, dtype=cdt, device=enc.device)
            cache["spare_v"] = torch.empty(shape, dtype=cdt, device=enc.device)
            cache["pending_src"] = torch.arange(batch, dtype=torch.int32,
                                                device=enc.device)
        return cache

    def step(tokens: torch.Tensor, cache, index: int, enc_mask: torch.Tensor):
        x = emb[tokens.long()].to(cdt)
        mask = enc_mask.to(torch.int32).contiguous()
        src = cache.get("pending_src")
        out = mega_decode_step(
            stacked, x, cache["self_k"], cache["self_v"], cache["cross"]["k"],
            cache["cross"]["v"], bias_all[index], bias0, mask, index, group,
            heads, eps=cfg.layer_norm_epsilon, src=src,
            out_caches=(None if src is None
                        else (cache["spare_k"], cache["spare_v"])),
            gated=cfg.is_gated_act)
        if src is not None:
            hidden, _, _, self_k, self_v = out
            # the permutation has been applied: pending_src goes back to the
            # identity, so a caller that skips reorder_cache gets a no-op
            cache = {**cache, "self_k": self_k, "self_v": self_v,
                     "spare_k": cache["self_k"], "spare_v": cache["self_v"],
                     "pending_src": torch.arange(x.shape[0], dtype=torch.int32,
                                                 device=x.device)}
        else:
            hidden = out[0]
        if cfg.tie_word_embeddings:
            hidden = hidden * (cfg.d_model ** -0.5)
            logits = hidden.float() @ head_t
        else:
            logits = (hidden @ head_t).float()
        return logits, cache

    def reorder_cache(cache, flat_src: torch.Tensor):
        return {**cache, "pending_src": flat_src.to(torch.int32).contiguous()}

    return DecodeFns(init_cache, step, reorder_cache if group > 1 else None)
