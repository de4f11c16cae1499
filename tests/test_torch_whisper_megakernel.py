"""The port's Whisper decode kernel: its plain version (what CPU tensors
run) against the JAX package's ``whisper_mega_step`` in interpret mode,
greedy and with the deferred beam permutation, cross K/V int8 and not, at
the first, a middle and the last cache index (hidden and k/v within 1e-5,
the copied cache rows exact); the int8 quantization against the JAX
``init_cache``'s (identical values and scales); and the ``DecodeFns``
wiring: greedy tokens and the beam ancestry loop of
``tests/test_whisper_megakernel.py`` identical to the JAX package's, and a
skipped reorder a no-op. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.models import whisper as jw
from vidchapters_tpu.ops import whisper_megakernel as jwm
from vidchapters_tpu_torch.models import whisper as tw
from vidchapters_tpu_torch.models.weights import whisper_from_jax_params
from vidchapters_tpu_torch.ops import whisper_megakernel as twm

MAX_LEN = 12
TOL = 1e-5
KW = dict(vocab_size=256, num_mel_bins=8, d_model=64, encoder_layers=1, decoder_layers=2,
          num_heads=4, d_ff=128, max_source_positions=30, max_target_positions=MAX_LEN,
          dtype="float32")


@pytest.fixture(scope="module")
def setup():
    jm = jw.Whisper(jw.WhisperConfig(**KW))
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(4, 8, 60)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(mel[:1]),
                                    jnp.zeros((1, 4), jnp.int32))["params"])
    tm = tw.Whisper(tw.WhisperConfig(**KW))
    tm.load_state_dict(whisper_from_jax_params(params, tm))
    tm.eval()
    enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    return jm, params, tm, np.array(enc)


def _quantize_np(a):
    amax = np.abs(a).max(axis=2, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    return np.clip(np.round(a / scale), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("idx", [0, 5, MAX_LEN - 1])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("use_src", [False, True])
def test_plain_matches_pallas_interpret(setup, use_src, quant, idx):
    jm, params, tm, _ = setup
    js = jwm.stack_whisper_decoder_weights(params, jm.cfg)
    ts = twm.stack_whisper_decoder_weights(tm)
    b0, n, d, heads, lenc, lencp = 2, 2, 64, 4, 30, 32
    g = 3 if use_src else 1
    rows = b0 * g
    rng = np.random.default_rng(100 + idx)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(rows, n, MAX_LEN, d)).astype(np.float32) for _ in range(2))
    kx, vx = (np.zeros((b0, n, lencp, d), np.float32) for _ in range(2))
    kx[:, :, :lenc] = rng.normal(size=(b0, n, lenc, d))
    vx[:, :, :lenc] = rng.normal(size=(b0, n, lenc, d))
    ks = vs = None
    if quant:
        (kx, ks), (vx, vs) = _quantize_np(kx), _quantize_np(vx)
    src = (np.array([(r // g) * g + (r * 2 + 1) % g for r in range(rows)], np.int32)
           if use_src else None)
    jopt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    topt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = jwm.whisper_mega_step(js, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kx), jnp.asarray(vx), jnp.asarray(idx), heads, lenc,
                                k_cross_scale=jopt(ks), v_cross_scale=jopt(vs), group=g,
                                src=jopt(src), interpret=True)
    k_in, v_in = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    before = twm.KERNEL.launches
    got = twm.whisper_mega_step(ts, torch.from_numpy(x), k_in, v_in, torch.from_numpy(kx),
                                torch.from_numpy(vx), idx, heads, lenc, topt(ks), topt(vs), g,
                                topt(src))
    assert twm.KERNEL.launches == before  # CPU tensors run the plain version
    assert len(got) == len(ref)
    for a, r in zip(got[:3], ref[:3]):  # hidden, k_new, v_new
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL, rtol=TOL)
    if use_src:
        # rows < idx are the permuted input rows, exactly; row idx is the new k/v
        for a, r, new in ((got[3], ref[3], got[1]), (got[4], ref[4], got[2])):
            np.testing.assert_array_equal(a[:, :, :idx].numpy(), np.asarray(r)[:, :, :idx])
            np.testing.assert_array_equal(a[:, :, idx].numpy(), new.numpy())
        np.testing.assert_array_equal(k_in.numpy(), kc)  # input caches untouched
    else:
        # greedy: row idx written in place, every other row untouched
        np.testing.assert_array_equal(k_in[:, :, idx].numpy(), got[1].numpy())
        keep = [i for i in range(MAX_LEN) if i != idx]
        np.testing.assert_array_equal(k_in[:, :, keep].numpy(), kc[:, :, keep])


def test_quantized_cross_matches_jax_init_cache(setup):
    """The int8 cross K/V and its per-lane scales, port against the JAX
    ``init_cache``: identical, on weights and encodings whose products are
    exact in float32 (so both sides quantize the same values); the padding
    (30 -> 32 frames) leaves the scales alone."""
    jm, params, _, _ = setup
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(np.array, params)
    for i in range(KW["decoder_layers"]):
        cross = p["decoder"][f"layer_{i}"]["cross_attn"]
        cross["k"]["kernel"] = rng.integers(-3, 4, (64, 64)).astype(np.float32) / 4
        cross["v"]["kernel"] = rng.integers(-3, 4, (64, 64)).astype(np.float32) / 4
        cross["v"]["bias"] = rng.integers(-3, 4, 64).astype(np.float32) / 8
    tm = tw.Whisper(tw.WhisperConfig(**KW))
    tm.load_state_dict(whisper_from_jax_params(p, tm))
    enc = rng.integers(-4, 5, (2, 30, 64)).astype(np.float32)
    jf = jwm.make_whisper_mega_fns(jm.cfg, p, MAX_LEN, interpret=True, quantize=True)
    tf = twm.make_whisper_mega_fns(tm, MAX_LEN, quantize=True)
    jc = jf.init_cache(2, jnp.asarray(enc))["cross"]
    with torch.no_grad():
        tc = tf.init_cache(2, torch.from_numpy(enc))["cross"]
    assert tc["k"].dtype == torch.int8 and tc["k"].shape == (2, 2, 32, 64)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)
    q, s = twm._quantize_lanes(torch.from_numpy(enc[:, None]))
    qn, sn = _quantize_np(enc[:, None])
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)


def test_quantize_default_follows_width():
    cfg = tw.WhisperConfig(**{**KW, "vocab_size": 64})
    small = twm.make_whisper_mega_fns(tw.Whisper(cfg), MAX_LEN)
    with torch.no_grad():
        cache = small.init_cache(1, torch.zeros(1, 30, 64))
    assert cache["cross"]["k"].dtype == torch.float32 and "k_scale" not in cache["cross"]
    forced = twm.make_whisper_mega_fns(tw.Whisper(cfg), MAX_LEN, quantize=True)
    with torch.no_grad():
        cache = forced.init_cache(1, torch.zeros(1, 30, 64))
    assert cache["cross"]["k"].dtype == torch.int8 and "k_scale" in cache["cross"]


def test_mega_greedy_tokens_match_jax(setup):
    from vidchapters_tpu.ops.decoding import greedy_decode as jax_greedy
    from vidchapters_tpu.ops.decoding import make_decode_fns
    from vidchapters_tpu_torch.ops.decoding import greedy_decode

    jm, params, tm, enc = setup
    ref = np.asarray(jax_greedy(make_decode_fns(jm, params, MAX_LEN), jnp.asarray(enc),
                                jnp.ones(enc.shape[:2], jnp.int32), MAX_LEN))
    fns = twm.make_whisper_mega_fns(tm, MAX_LEN, quantize=False)
    with torch.no_grad():
        got = greedy_decode(fns, torch.from_numpy(enc), torch.ones(enc.shape[:2]), MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), ref)


def _beam_loop(fns, cache, b, k, vocab, jax_side: bool):
    """tests/test_whisper_megakernel.py's beam loop: six steps of top-K
    over [b, K * vocab], the ancestry through the cache's reorder."""
    from vidchapters_tpu.ops.decoding import reorder_beam_cache as jax_reorder
    from vidchapters_tpu_torch.ops.decoding import _topk_small, reorder_beam_cache

    rows = b * k
    tokens = np.full(rows, 5, np.int32)
    sum_lp = np.concatenate([np.zeros((b, 1)), np.full((b, k - 1), -1e9)], 1).astype(np.float32)
    picked = []
    for i in range(6):
        if jax_side:
            logits, cache = fns.step(jnp.asarray(tokens), cache, jnp.asarray(i), None)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            flat = (jnp.asarray(sum_lp)[..., None] + logp.reshape(b, k, vocab)).reshape(b, -1)
            top, idx = (np.asarray(a) for a in jax.lax.top_k(flat, k))
        else:
            with torch.no_grad():
                logits, cache = fns.step(torch.from_numpy(tokens), cache, i, None)
            logp = torch.log_softmax(logits.float(), -1)
            flat = (torch.from_numpy(sum_lp)[..., None] + logp.view(b, k, vocab)).reshape(b, -1)
            top, idx = (a.numpy() for a in _topk_small(flat, k))
        sum_lp = top
        parent = (np.arange(b)[:, None] * k + idx // vocab).reshape(-1).astype(np.int32)
        tokens = (idx % vocab).reshape(-1).astype(np.int32)
        if jax_side:
            cache = jax_reorder(cache, jnp.asarray(parent))
        else:
            cache = (fns.reorder_cache or reorder_beam_cache)(cache, torch.from_numpy(parent))
        picked.append(tokens)
    return np.stack(picked)


def test_mega_beam_ancestry_matches_jax(setup):
    """The beam loop on the JAX standard decode (cross K/V shared per
    example) against the port's kernel route: the grouped layout (the
    permutation deferred into the next step), and the repeated-encoding
    layout (group 1, the cache gathered by ``reorder_beam_cache``)."""
    from vidchapters_tpu.ops.decoding import make_decode_fns

    jm, params, tm, enc = setup
    k, b = 3, enc.shape[0]
    ref_fns = make_decode_fns(jm, params, MAX_LEN)
    ref = _beam_loop(ref_fns, ref_fns.init_cache(b * k, jnp.asarray(enc)), b, k, 256, True)
    mega = twm.make_whisper_mega_fns(tm, MAX_LEN, quantize=False)
    with torch.no_grad():
        grouped = mega.init_cache(b * k, torch.from_numpy(enc))
    assert "pending_src" in grouped
    np.testing.assert_array_equal(_beam_loop(mega, grouped, b, k, 256, False), ref)
    mega2 = twm.make_whisper_mega_fns(tm, MAX_LEN, quantize=False)
    with torch.no_grad():
        repeated = mega2.init_cache(b * k, torch.from_numpy(np.repeat(enc, k, axis=0)))
    assert "pending_src" not in repeated
    np.testing.assert_array_equal(_beam_loop(mega2, repeated, b, k, 256, False), ref)


def test_skipped_reorder_is_noop_after_applied_permutation(setup):
    """step() applies pending_src in the kernel, so the cache it returns
    carries the identity: a caller that skips reorder_cache on a step gets a
    no-op, not a stale re-permutation (logits against the JAX standard
    decode, 2e-4 as in the JAX package's own test)."""
    from vidchapters_tpu.ops.decoding import make_decode_fns, reorder_beam_cache

    jm, params, tm, enc = setup
    k, rows = 2, 2 * enc.shape[0]
    ref = make_decode_fns(jm, params, MAX_LEN)
    mega = twm.make_whisper_mega_fns(tm, MAX_LEN, quantize=False)
    cr = ref.init_cache(rows, jnp.asarray(enc))
    parent = np.array([(i // k) * k + (k - 1 - i % k) for i in range(rows)], np.int32)
    with torch.no_grad():
        cm = mega.init_cache(rows, torch.from_numpy(enc))
        for i, toks in enumerate((np.arange(rows) % 7 + 3, np.arange(rows) % 5 + 2,
                                  np.arange(rows) % 9 + 1)):
            toks = toks.astype(np.int32)
            lr, cr = ref.step(jnp.asarray(toks), cr, jnp.asarray(i), None)
            lm, cm = mega.step(torch.from_numpy(toks), cm, i, None)
            np.testing.assert_allclose(lm.numpy(), np.asarray(lr), atol=2e-4, rtol=2e-4)
            np.testing.assert_array_equal(cm["pending_src"].numpy(), np.arange(rows))
            if i == 0:  # reorder after the first step only; the second is skipped
                cr = reorder_beam_cache(cr, jnp.asarray(parent))
                cm = mega.reorder_cache(cm, torch.from_numpy(parent))


def test_gelu_erf_matches_exact_gelu():
    x = torch.linspace(-6, 6, 4097)
    np.testing.assert_allclose(twm.gelu_erf(x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)),
                               atol=2e-6)
    np.testing.assert_allclose(twm.gelu_erf(x).numpy(), np.asarray(jwm.gelu_erf(x.numpy())),
                               atol=2e-6)


def test_wrapper_raises_on_cuda_shape_errors():
    """CUDA tensors never fall back to the plain version: the wrapper checks
    and launches. Without a card the device check raises first."""
    st = {"ln_scale": torch.zeros(1, 3, 64)}
    x = torch.zeros(2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        twm.whisper_mega_step(st, x.to("meta"), x, x, x, x, 0, 4, 1)
