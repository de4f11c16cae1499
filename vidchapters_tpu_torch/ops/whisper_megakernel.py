"""One Whisper decoder step over all layers in one kernel launch.

``whisper_mega_step`` launches ``csrc/whisper_megakernel.cu`` for CUDA
tensors and runs ``whisper_mega_step_plain`` (the same function in plain
PyTorch) for CPU tensors. The host side stacks the decoder weights into the
layer-major layout the kernel streams, precomputes the cross-attention K/V
(int8 with per-lane scales by default at d_model >= 1280), and
wires it all into ``DecodeFns`` for the transcriber. Counterpart of
``vidchapters_tpu/ops/whisper_megakernel.py``; its TPU tiling knobs
(``CACHE_CHUNK``, ``CHUNK_GREEDY``, ``BATCH_BLOCK_ROWS``) change no result
and are not carried over.

Layouts: x ``[B, d]`` in the compute dtype; self caches ``[B, N, L,
inner]``; cross K/V ``[B0, N, Lencp, inner]`` (int8 or the compute dtype)
with ``B = B0 * group`` and float32 scales ``[B0, N, 1, inner]``. The stacked
weights keep the JAX package's keys, LayerNorm rows ``[N, 3, d]`` and
float32 bias rows ``[N, 1, out]``, but each product's weight is stored
``[N, out, in]`` (``nn.Linear``'s layout), so that the kernel reads each
output column's weights as one contiguous row.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.ops._build import I, P, CudaKernel, stream_ptr

NEG_INF = -1e9
MAX_GROUP = 8  # beams per example the kernel takes

KERNEL = CudaKernel("whisper_megakernel", {
    "whisper_mega_step": [P] * 30 + [I] * 13 + [P],
    "whisper_mega_workspace": [I] * 11,
    "whisper_mega_barriers": [P, P, I, P]})
PHASES = 9  # grid barriers a layer: q|k|v, self-attention, self out, cross q,
#             cross scores, cross p.v, cross out, fc1, fc2

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("wqkv", "wo_self", "wq_cross", "wo_cross", "wi", "wo_ff")
_BIASES = ("bqkv", "bo_self", "bq_cross", "bo_cross", "bi", "bo_ff")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU of float32 ``x``."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 LayerNorm (eps 1e-5) of float32 ``x``, unrounded."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return w * (xc * torch.rsqrt(var + 1e-5)) + b


def whisper_mega_step_plain(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            k_cross: torch.Tensor, v_cross: torch.Tensor,
                            cache_index: int, heads: int, lenc: int,
                            k_cross_scale: Optional[torch.Tensor] = None,
                            v_cross_scale: Optional[torch.Tensor] = None,
                            group: int = 1, src: Optional[torch.Tensor] = None,
                            out_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The kernel's function in plain PyTorch: float32 arithmetic rounded
    through x's dtype where the TPU kernel rounds (each product after its
    float32 bias, each norm, q after its scale, the attention contexts, the
    self-attention probabilities before p.v, the current token's q*k
    products, and the residual stream after every add). Same arguments and
    results as ``whisper_mega_step``."""
    cdt = x.dtype
    r = lambda t: t.to(cdt).float()  # noqa: E731 - rounding through the working type
    bsz, d = x.shape
    _, n_layers, _, inner = k_cache.shape
    b0 = k_cross.shape[0]
    dkv = inner // heads
    scale = float(np.float32(dkv ** -0.5))
    idx = int(cache_index)
    quant = k_cross_scale is not None
    if src is not None:
        k_att = k_cache.index_select(0, src.long())
        v_att = v_cache.index_select(0, src.long())
    else:
        k_att, v_att = k_cache, v_cache
    k_new = torch.empty(bsz, n_layers, inner, dtype=cdt, device=x.device)
    v_new = torch.empty_like(k_new)
    w = {n: stacked[n].float() for n in _WEIGHTS}
    b = {n: stacked[n].float()[:, 0] for n in _BIASES}
    lns, lnb = stacked["ln_scale"].float(), stacked["ln_bias"].float()
    xs = x.float()
    for i in range(n_layers):
        # ---- self-attention over rows < idx plus the current row ----
        h = r(_layer_norm(xs, lns[i, 0], lnb[i, 0]))
        qkv = r(h @ w["wqkv"][i].t() + b["bqkv"][i])
        q = r(qkv[:, :inner] * scale).view(bsz, heads, dkv)
        kn, vn = qkv[:, inner:2 * inner], qkv[:, 2 * inner:]
        k_new[:, i], v_new[:, i] = kn.to(cdt), vn.to(cdt)
        if idx > 0:
            keys = k_att[:, i, :idx].float().view(bsz, idx, heads, dkv)
            vals = v_att[:, i, :idx].float().view(bsz, idx, heads, dkv)
            s = torch.einsum("bhd,blhd->bhl", q, keys)
            m = s.max(dim=-1).values
            e = torch.exp(s - m[..., None])
            den = e.sum(dim=-1)
            acc = torch.einsum("bhl,blhd->bhd", r(e), vals)
        else:
            m = torch.full((bsz, heads), NEG_INF, device=x.device)
            den = torch.zeros(bsz, heads, device=x.device)
            acc = torch.zeros(bsz, heads, dkv, device=x.device)
        knh, vnh = kn.view(bsz, heads, dkv), vn.view(bsz, heads, dkv)
        s_new = r(q * knh).sum(dim=-1)
        m2 = torch.maximum(m, s_new)
        sc, e_new = torch.exp(m - m2), torch.exp(s_new - m2)
        ctx = (acc * sc[..., None] + e_new[..., None] * vnh) / (den * sc + e_new)[..., None]
        k_att[:, i, idx], v_att[:, i, idx] = kn.to(cdt), vn.to(cdt)
        xs = r(xs + r(r(ctx.reshape(bsz, inner)) @ w["wo_self"][i].t() + b["bo_self"][i]))
        # ---- cross-attention: the beams of an example share its K/V ----
        h = r(_layer_norm(xs, lns[i, 1], lnb[i, 1]))
        qc = r(r(h @ w["wq_cross"][i].t() + b["bq_cross"][i]) * scale)
        qc = qc.view(b0, group, heads, dkv)
        kx = k_cross[:, i, :lenc].float().view(b0, lenc, heads, dkv)
        vx = v_cross[:, i, :lenc].float().view(b0, lenc, heads, dkv)
        if quant:
            qc = r(qc * r(k_cross_scale[:, i, 0].float().view(b0, 1, heads, dkv)))
        s = torch.einsum("bghd,blhd->bghl", qc, kx)
        ec = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        p = ec / ec.sum(dim=-1, keepdim=True)
        part = torch.einsum("bghl,blhd->bghd", r(p), vx)
        if quant:
            part = part * v_cross_scale[:, i, 0].float().view(b0, 1, heads, dkv)
        ctx = r(part.reshape(bsz, inner))
        xs = r(xs + r(ctx @ w["wo_cross"][i].t() + b["bo_cross"][i]))
        # ---- feed-forward ----
        h = r(_layer_norm(xs, lns[i, 2], lnb[i, 2]))
        hh = r(gelu_erf(h @ w["wi"][i].t() + b["bi"][i]))
        xs = r(xs + r(hh @ w["wo_ff"][i].t() + b["bo_ff"][i]))
    hidden = xs.to(cdt)
    if src is None:
        return hidden, k_new, v_new
    if out_caches is not None:
        out_caches[0].copy_(k_att)
        out_caches[1].copy_(v_att)
        k_att, v_att = out_caches
    return hidden, k_new, v_new, k_att, v_att


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"whisper_mega_step: {name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"whisper_mega_step: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"whisper_mega_step: {name} must be a contiguous CUDA tensor")


def whisper_mega_step(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_cross: torch.Tensor, v_cross: torch.Tensor,
                      cache_index: int, heads: int, lenc: int,
                      k_cross_scale: Optional[torch.Tensor] = None,
                      v_cross_scale: Optional[torch.Tensor] = None,
                      group: int = 1, src: Optional[torch.Tensor] = None,
                      out_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      timeline: Optional[torch.Tensor] = None):
    """One decoder step over all layers.

    Returns ``(hidden [B, d] before the final LayerNorm, k_new [B, N,
    inner], v_new)``. The cross K/V has ``Lencp >= lenc`` rows, of which the
    first ``lenc`` are attended; with ``k_cross_scale`` / ``v_cross_scale``
    it is int8, dequantized by its per-lane scales. Without ``src``
    (greedy), row ``cache_index`` of k_cache / v_cache is written in place.
    With ``src [B]`` (beam search), the caches are first permuted by rows
    (the previous step's deferred beam reorder) into a second pair of
    buffers, ``out_caches`` or new ones, whose row ``cache_index`` holds the
    new k/v; the kernel writes their rows up to ``cache_index`` only. Then
    the result also carries those two buffers.

    ``timeline`` (CUDA only; an int64 tensor of ``9 N + 2`` slots) receives
    the device clock in ns at the kernel's start, after its set-up, and at
    the end of each of a layer's 9 phases (q|k|v, self-attention, its
    output, cross q, cross scores, cross p.v, its output, fc1, fc2).
    """
    if x.device.type == "cpu":
        return whisper_mega_step_plain(stacked, x, k_cache, v_cache, k_cross, v_cross,
                                       cache_index, heads, lenc, k_cross_scale,
                                       v_cross_scale, group, src, out_caches)
    cdt = x.dtype
    if cdt not in _DTYPE_CODE:
        raise TypeError(f"whisper_mega_step takes float32 or bfloat16, not {cdt}")
    bsz, d = x.shape
    _, n_layers, length, inner = k_cache.shape
    b0, _, lencp, _ = k_cross.shape
    dff = stacked["wi"].shape[1]
    idx = int(cache_index)
    quant = k_cross_scale is not None
    if inner % heads or (inner // heads) % 16 or inner // heads > 128:
        raise ValueError(f"whisper_mega_step: {heads} heads of {inner} lanes: the head "
                         "width must be a multiple of 16, at most 128")
    if d % 8 or dff % 8:
        raise ValueError("whisper_mega_step: d and d_ff must be multiples of 8")
    if not 1 <= group <= MAX_GROUP or bsz != b0 * group:
        raise ValueError(f"whisper_mega_step: {bsz} rows is not {b0} examples "
                         f"x group {group} (group <= {MAX_GROUP})")
    if not 0 <= idx < length:
        raise ValueError(f"whisper_mega_step: cache_index {idx} outside [0, {length})")
    if not 1 <= lenc <= lencp:
        raise ValueError(f"whisper_mega_step: lenc {lenc} outside [1, {lencp}]")
    _check("x", x, (bsz, d), cdt)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, t, (bsz, n_layers, length, inner), cdt)
    kdt = torch.int8 if quant else cdt
    for name, t in (("k_cross", k_cross), ("v_cross", v_cross)):
        _check(name, t, (b0, n_layers, lencp, inner), kdt)
    if quant:
        if v_cross_scale is None:
            raise ValueError("whisper_mega_step: k_cross_scale without v_cross_scale")
        for name, t in (("k_cross_scale", k_cross_scale), ("v_cross_scale", v_cross_scale)):
            _check(name, t, (b0, n_layers, 1, inner), torch.float32)
    for name in ("ln_scale", "ln_bias"):
        _check(name, stacked[name], (n_layers, 3, d), torch.float32)
    outs = {"wqkv": 3 * inner, "wo_self": d, "wq_cross": inner, "wo_cross": d,
            "wi": dff, "wo_ff": d}
    ins = {"wqkv": d, "wo_self": inner, "wq_cross": d, "wo_cross": inner, "wi": d,
           "wo_ff": dff}
    for wn, bn in zip(_WEIGHTS, _BIASES):
        _check(wn, stacked[wn], (n_layers, outs[wn], ins[wn]), cdt)
        _check(bn, stacked[bn], (n_layers, 1, outs[wn]), torch.float32)
    if src is not None:
        _check("src", src, (bsz,), torch.int32)
        if out_caches is None:
            out_caches = (torch.empty_like(k_cache), torch.empty_like(v_cache))
        k_att, v_att = out_caches
        _check("out k cache", k_att, k_cache.shape, cdt)
        _check("out v cache", v_att, v_cache.shape, cdt)
        if {k_att.data_ptr(), v_att.data_ptr()} & {k_cache.data_ptr(), v_cache.data_ptr()}:
            raise ValueError("whisper_mega_step: out_caches must not alias the caches")
    else:
        k_att, v_att = k_cache, v_cache
    if timeline is not None:
        _check("timeline", timeline, (PHASES * n_layers + 2,), torch.int64)
    hidden, k_new, v_new = _launch_step(stacked, x, k_cache, v_cache, k_att, v_att, k_cross,
                                        v_cross, idx, heads, lenc, k_cross_scale,
                                        v_cross_scale, group, src, timeline)
    if src is None:
        return hidden, k_new, v_new
    return hidden, k_new, v_new, k_att, v_att


def _launch_step(stacked, x, k_cache, v_cache, k_att, v_att, k_cross, v_cross, idx: int,
                 heads: int, lenc: int, k_cross_scale, v_cross_scale, group: int, src,
                 timeline) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Allocate the outputs and the kernel's scratch on x's device and launch
    (shapes already checked). Returns (hidden, k_new, v_new)."""
    cdt = x.dtype
    bsz, d = x.shape
    _, n_layers, length, inner = k_cache.shape
    lencp = k_cross.shape[2]
    dff = stacked["wi"].shape[1]
    quant = k_cross_scale is not None
    hidden = torch.empty(bsz, d, dtype=cdt, device=x.device)
    k_new = torch.empty(bsz, n_layers, inner, dtype=cdt, device=x.device)
    v_new = torch.empty_like(k_new)
    # the kernel's scratch (residual, q, context, FF rows, partial sums,
    # scores) and its grid barrier and arrival counters, as it sizes them
    sizes = [KERNEL._load().whisper_mega_workspace(bsz, length, lencp, lenc, d, inner, heads,
                                                   dff, group, _DTYPE_CODE[cdt], which)
             for which in (0, 1)]
    if min(sizes) < 0:
        raise ValueError(f"whisper_mega_step: no workspace for {bsz} rows at d {d}, d_ff {dff}")
    ws = torch.empty(sizes[0], dtype=torch.float32, device=x.device)
    barrier = torch.zeros(sizes[1], dtype=torch.int32, device=x.device)
    KERNEL.launch(
        "whisper_mega_step", x.data_ptr(), stacked["ln_scale"].data_ptr(),
        stacked["ln_bias"].data_ptr(),
        *(t for wn, bn in zip(_WEIGHTS, _BIASES)
          for t in (stacked[wn].data_ptr(), stacked[bn].data_ptr())),
        k_cache.data_ptr(), v_cache.data_ptr(), k_att.data_ptr(), v_att.data_ptr(),
        k_cross.data_ptr(), v_cross.data_ptr(),
        k_cross_scale.data_ptr() if quant else 0, v_cross_scale.data_ptr() if quant else 0,
        0 if src is None else src.data_ptr(), hidden.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ws.data_ptr(), barrier.data_ptr(),
        0 if timeline is None else timeline.data_ptr(), bsz, n_layers, length, lencp, lenc, d,
        inner, heads, dff, group, idx, _DTYPE_CODE[cdt], int(quant), stream_ptr())
    return hidden, k_new, v_new


def barrier_step(n_barriers: int) -> torch.Tensor:
    """The kernel's grid barriers alone: ``n_barriers`` of them on the same
    cooperative grid, nothing else (CUDA only). Returns the device clock in
    ns at the start and after each barrier (``n_barriers + 1`` int64)."""
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    timeline = torch.zeros(n_barriers + 1, dtype=torch.int64, device="cuda")
    rc = KERNEL._load().whisper_mega_barriers(bar.data_ptr(), timeline.data_ptr(),
                                              n_barriers, stream_ptr())
    if rc != 0:
        raise RuntimeError(f"whisper_mega_barriers failed to launch: cudaError_t {rc}")
    return timeline


# ---------------------------------------------------------------------------
# Host side: weight stacking, cross K/V quantization, DecodeFns
# ---------------------------------------------------------------------------


def stack_whisper_decoder_weights(model, dtype: Optional[torch.dtype] = None
                                  ) -> Dict[str, torch.Tensor]:
    """The port's ``Whisper`` decoder -> layer-stacked tensors: packed q|k|v
    (the bias-free k projection contributes zero bias rows), weights
    ``[N, out, in]`` in ``dtype`` (default: the config's compute dtype),
    LayerNorm rows and biases float32; plus the cross K/V projections used
    once per decode call and the final LayerNorm."""
    dec = model.decoder
    cdt = dtype or getattr(torch, model.cfg.dtype)
    layers = dec.layers

    def stack(fn, dt=cdt):
        return torch.stack([fn(lay).detach() for lay in layers]).to(dt).contiguous()

    def bias(lin):
        return lin.bias.detach()[None]

    f32 = torch.float32
    return {
        "ln_scale": stack(lambda l: torch.stack([l.self_attn_norm.weight,
                                                 l.cross_attn_norm.weight,
                                                 l.ff_norm.weight]), f32),
        "ln_bias": stack(lambda l: torch.stack([l.self_attn_norm.bias,
                                                l.cross_attn_norm.bias,
                                                l.ff_norm.bias]), f32),
        "wqkv": stack(lambda l: torch.cat([l.self_attn.q.weight, l.self_attn.k.weight,
                                           l.self_attn.v.weight], dim=0)),
        "bqkv": stack(lambda l: torch.cat([l.self_attn.q.bias,
                                           torch.zeros_like(l.self_attn.q.bias),
                                           l.self_attn.v.bias])[None], f32),
        "wo_self": stack(lambda l: l.self_attn.out.weight),
        "bo_self": stack(lambda l: bias(l.self_attn.out), f32),
        "wq_cross": stack(lambda l: l.cross_attn.q.weight),
        "bq_cross": stack(lambda l: bias(l.cross_attn.q), f32),
        "wo_cross": stack(lambda l: l.cross_attn.out.weight),
        "bo_cross": stack(lambda l: bias(l.cross_attn.out), f32),
        "wi": stack(lambda l: l.fc1.weight),
        "bi": stack(lambda l: bias(l.fc1), f32),
        "wo_ff": stack(lambda l: l.fc2.weight),
        "bo_ff": stack(lambda l: bias(l.fc2), f32),
        "wk_cross": stack(lambda l: l.cross_attn.k.weight),
        "wv_cross": stack(lambda l: l.cross_attn.v.weight),
        "bv_cross": stack(lambda l: bias(l.cross_attn.v), f32),
        "ln_final_scale": dec.ln.weight.detach().float().contiguous(),
        "ln_final_bias": dec.ln.bias.detach().float().contiguous(),
    }


def _quantize_lanes(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane int8 of ``a [B0, N, Lencp, inner]``: the scale is the lane's
    absolute maximum over the frames / 127 (1 for an all-zero lane), as
    float32; zero padding rows do not move it."""
    amax = torch.amax(torch.abs(a.float()), dim=2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(a.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_whisper_mega_fns(model, max_length: int, quantize: Optional[bool] = None):
    """``DecodeFns`` backed by the Whisper decode kernel for the port's
    ``Whisper`` ``model`` (on the device to run on).

    ``init_cache(batch, enc_out)`` takes the row count and the per-example
    encodings; ``batch / enc rows`` consecutive rows (one example's beams)
    share the example's cross K/V. Beam search keeps the permutation
    deferred: ``reorder_cache`` stores it as ``pending_src`` and the next
    step's kernel applies it while it copies the cache rows into the spare
    pair of buffers, which then become the live pair.

    ``quantize`` stores the cross K/V as int8 with per-lane scales. None (the
    default) turns it on at d_model >= 1280 (large-v2, where a bf16 cross K/V
    is ~245 MB per example) and off below; True / False force it."""
    from vidchapters_tpu_torch.ops.decoding import DecodeFns

    cfg = model.cfg
    cdt = getattr(torch, cfg.dtype)
    stacked = stack_whisper_decoder_weights(model, cdt)
    emb = model.decoder.embed_tokens.weight.detach()
    # logits operand, transposed once: compute-dtype values held in float32,
    # so the product accumulates in float32 and is returned unrounded
    emb_t = emb.to(cdt).float().t().contiguous()
    pos = model.decoder.embed_positions.detach()
    heads, d, n = cfg.num_heads, cfg.d_model, cfg.decoder_layers
    if quantize is None:
        quantize = d >= 1280
    static: Dict[str, int] = {}

    def init_cache(batch: int, enc_out: torch.Tensor):
        b0, lenc, _ = enc_out.shape
        if batch % b0:
            raise ValueError(f"enc batch {b0} does not divide cache batch {batch}")
        lencp = _round_up(lenc, 32 if quantize else 16)
        enc = enc_out.to(cdt).float()
        shape = (b0, n, lencp, d)
        kx = torch.zeros(shape, dtype=cdt, device=enc.device)
        vx = torch.zeros(shape, dtype=cdt, device=enc.device)
        for i in range(n):  # float32 products, one rounding, as the JAX einsums
            kx[:, i, :lenc] = (enc @ stacked["wk_cross"][i].float().t()).to(cdt)
            vx[:, i, :lenc] = (enc @ stacked["wv_cross"][i].float().t()
                               + stacked["bv_cross"][i]).to(cdt)
        cross = {"k": kx, "v": vx}
        if quantize:
            cross["k"], cross["k_scale"] = _quantize_lanes(kx)
            cross["v"], cross["v_scale"] = _quantize_lanes(vx)
        static["lenc"], static["group"] = lenc, batch // b0
        cshape = (batch, n, max_length, d)
        cache = {"self_k": torch.zeros(cshape, dtype=cdt, device=enc.device),
                 "self_v": torch.zeros(cshape, dtype=cdt, device=enc.device),
                 "cross": cross}
        if static["group"] > 1:
            cache["spare_k"] = torch.empty(cshape, dtype=cdt, device=enc.device)
            cache["spare_v"] = torch.empty(cshape, dtype=cdt, device=enc.device)
            cache["pending_src"] = torch.arange(batch, dtype=torch.int32, device=enc.device)
        return cache

    def step(tokens: torch.Tensor, cache, index: int, enc_mask=None):
        del enc_mask  # Whisper attends to the full encoding
        x = emb[tokens.long()].to(cdt) + pos[index].to(cdt)
        src = cache.get("pending_src")
        cross = cache["cross"]
        out = whisper_mega_step(
            stacked, x, cache["self_k"], cache["self_v"], cross["k"], cross["v"], index,
            heads, static["lenc"], k_cross_scale=cross.get("k_scale"),
            v_cross_scale=cross.get("v_scale"), group=static["group"], src=src,
            out_caches=None if src is None else (cache["spare_k"], cache["spare_v"]))
        hidden = out[0]
        if src is not None:
            # the permutation has been applied: pending_src goes back to the
            # identity, so a caller that skips reorder_cache gets a no-op
            cache = {**cache, "self_k": out[3], "self_v": out[4],
                     "spare_k": cache["self_k"], "spare_v": cache["self_v"],
                     "pending_src": torch.arange(x.shape[0], dtype=torch.int32,
                                                 device=x.device)}
        # final LayerNorm and the tied-embedding logits outside the kernel
        normed = _layer_norm(hidden.float(), stacked["ln_final_scale"],
                             stacked["ln_final_bias"])
        return normed.to(cdt).float() @ emb_t, cache

    def reorder_cache(cache, flat_src: torch.Tensor):
        if "pending_src" not in cache:
            from vidchapters_tpu_torch.ops.decoding import reorder_beam_cache

            return reorder_beam_cache(cache, flat_src)
        return {**cache, "pending_src": flat_src.to(torch.int32).contiguous()}

    return DecodeFns(init_cache, step, reorder_cache)
