"""The port's word alignment against the JAX package's, on the CPU with a
small Whisper (d 64, 2+2 layers, fp32) holding the JAX init:

- ``median_filter``, ``dtw_path`` and ``token_times_from_attention`` equal
  on the same inputs;
- the decoder's pooled cross-attention (``cross_attention_mean``) within
  1e-6 of the mean of the maps the JAX decoder ``sow``s;
- ``align_words_batch`` word times identical to JAX's over segments of
  unequal mel lengths and token counts with a teacher-forced prefix, in one
  batch and in chunks of 1 and 2 segments (each chunk padded to the
  longest mel of the whole call);
- ``align_segments`` turns a sweep transcript into whisperx ``segments``
  whose words are JAX's word times shifted by each segment's start, and
  which ``proc_asr`` / ``merge_and_process`` read back.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.factory import align as ja
from vidchapters_tpu.models import whisper as jw
from vidchapters_tpu_torch.factory import align as ta
from vidchapters_tpu_torch.models import whisper as tw
from vidchapters_tpu_torch.models.weights import whisper_from_jax_params

KW = dict(vocab_size=256, num_mel_bins=8, d_model=64, encoder_layers=2, decoder_layers=2,
          num_heads=4, d_ff=128, max_source_positions=40, max_target_positions=16,
          dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    cfg = {**KW, **kw}
    jm = jw.Whisper(jw.WhisperConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, cfg["num_mel_bins"], 80)),
                                    jnp.zeros((1, 4), jnp.int32))["params"])
    tm = tw.Whisper(tw.WhisperConfig(**cfg))
    tm.load_state_dict(whisper_from_jax_params(params, tm))
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_dtw_and_token_times_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.random((3, 40))
    for width in (1, 3, 7):
        np.testing.assert_array_equal(ta.median_filter(x, width), ja.median_filter(x, width))
    for shape in ((5, 12), (1, 9), (12, 30)):
        cost = rng.random(shape)
        for got, ref in zip(ta.dtw_path(cost), ja.dtw_path(cost)):
            np.testing.assert_array_equal(got, ref)
    attn = rng.random((2, 3, 6, 50)).astype(np.float32)
    for n in (50, 31):
        for got, ref in zip(ta.token_times_from_attention(attn, n),
                            ja.token_times_from_attention(attn, n)):
            np.testing.assert_array_equal(got, ref)


def test_pooled_cross_attention_matches_jax_maps(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    mel = rng.normal(size=(2, 8, 70)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    _, inter = jm.apply({"params": params}, jnp.asarray(toks), enc,
                        method=lambda m, t, e: m.decoder(t, e), mutable=["intermediates"])
    dec = inter["intermediates"]["decoder"]
    maps = np.stack([np.asarray(dec[f"layer_{i}"]["cross_attn"]["attn_probs"][0])
                     for i in range(2)], axis=1)  # [B, layers, heads, T_tok, T_aud]
    ref = maps.mean(axis=(1, 2))
    with torch.no_grad():
        got = tm.decoder.cross_attention_mean(torch.from_numpy(toks),
                                              tm.encode(torch.from_numpy(mel))).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 9, 35)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _segments(rng):
    """Four segments: mel lengths 80 / 52 / 66 / 40 frames, 1-5 tokens,
    continuation tokens ("") and audio shorter than the padded mel."""
    lens = (80, 52, 66, 40)
    mels = [rng.normal(size=(8, n)).astype(np.float32) for n in lens]
    ids = [[5, 11, 12, 13, 1], [40, 41], [7, 8, 9], [99]]
    words = [["", "hello", "wor", "", "ld"], ["so", ""], ["a", "b", "c"], ["end"]]
    secs = [0.8, 0.5, 0.66, 0.3]
    return mels, ids, words, secs


@pytest.mark.parametrize("chunk_size", [None, 1, 2])
def test_align_words_batch_equals_jax(pair, chunk_size):
    jm, params, tm = pair
    mels, ids, words, secs = _segments(np.random.default_rng(2))
    prefix = (3, 4)
    ref = ja.align_words_batch(jm, params, mels, ids, words, secs, prefix_ids=prefix)
    got = ta.align_words_batch(tm, mels, ids, words, secs, prefix_ids=prefix,
                               chunk_size=chunk_size)
    assert got == ref
    assert [[w["word"] for w in seg] for seg in got] == [["hello", "wor", "ld"], ["so"],
                                                         ["a", "b", "c"], ["end"]]
    for seg, s in zip(got, secs):
        starts = [w["start"] for w in seg]
        assert starts == sorted(starts)
        assert all(0.0 <= w["start"] <= w["end"] <= s + 1e-6 for w in seg)


def test_align_words_single_and_empty(pair):
    jm, params, tm = pair
    mels, ids, words, secs = _segments(np.random.default_rng(3))
    assert (ta.align_words(tm, mels[1], ids[1], words[1], secs[1])
            == ja.align_words(jm, params, mels[1], ids[1], words[1], secs[1]))
    assert ta.align_words_batch(tm, [], [], [], []) == []
    assert ta.align_words_batch(tm, mels[:2], [[], ids[1]], [[], words[1]],
                                [0.5, 0.0]) == [[], []]


def test_align_segments_gives_whisperx_segments(tmp_path):
    from vidchapters_tpu_torch.factory.asr import merge_and_process, proc_asr
    from vidchapters_tpu_torch.factory.audio import log_mel_spectrogram
    from vidchapters_tpu_torch.utils.io import save_pickle

    jm, params, tm = _pair(num_mel_bins=80, encoder_layers=1, max_source_positions=1500)
    rng = np.random.default_rng(4)
    audio = (0.1 * rng.normal(size=16000 * 9)).astype(np.float32)
    result = {"text": ["12 40 7", "99 5"], "start": [0.5, 4.0], "end": [3.2, 8.75],
              "language": "en"}

    def tokenize(text):
        toks = [int(t) for t in text.split()]
        return toks, [f"w{t}" for t in toks]

    got = ta.align_segments(tm, audio, result, tokenize, prefix_ids=(1,), chunk_size=1)
    assert got["language"] == "en" and len(got["segments"]) == 2
    mels = [log_mel_spectrogram(audio[int(s * 16000):int(e * 16000)])
            for s, e in zip(result["start"], result["end"])]
    ref = ja.align_words_batch(jm, params, mels, [[12, 40, 7], [99, 5]],
                               [["w12", "w40", "w7"], ["w99", "w5"]], [2.7, 4.75],
                               prefix_ids=(1,))
    for seg, text, st, ed, words in zip(got["segments"], result["text"], result["start"],
                                        result["end"], ref):
        assert (seg["text"], seg["start"], seg["end"]) == (text, st, ed)
        assert seg["words"] == [{"word": w["word"], "start": st + w["start"],
                                 "end": st + w["end"]} for w in words]
        assert all(st <= w["start"] <= w["end"] <= ed + 1e-6 for w in seg["words"])
    assert proc_asr(got) == {k: result[k] for k in ("text", "start", "end", "language")}
    save_pickle(got, tmp_path / "abcdefghijk.pkl")
    merged = merge_and_process(str(tmp_path), str(tmp_path / "merged.pkl"))
    assert merged["abcdefghijk"]["text"] == result["text"]
