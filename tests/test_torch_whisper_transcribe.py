"""The port's ASR factory against the JAX package's: language ID, the
timestamp rules and their state (exact), segmentation, the compression
ratio, ``transcribe`` / ``transcribe_batch`` segments identical at
temperature 0 (greedy, beam 5, VAD, conditioning, no-speech skipping, both
decode routes), the sampled rungs held by a temperature of 1e-6 (tokens
equal to greedy) and by a frequency test, the decode-step count behind the
kernel's launch count, and ``run_batched_asr`` / ``proc_asr`` / the merges.
A tiny Whisper (d 32, 1+1 layers) with the full 51865-token vocab, so that
the timestamp and language tokens exist; fp32; inputs from numpy seeds."""

import pickle
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.factory import asr as jasr
from vidchapters_tpu.factory import whisper_transcribe as jwt
from vidchapters_tpu.models import whisper as jw
from vidchapters_tpu_torch.factory import asr as tasr
from vidchapters_tpu_torch.factory import whisper_transcribe as twt
from vidchapters_tpu_torch.models import whisper as tw
from vidchapters_tpu_torch.models.weights import whisper_from_jax_params

VOCAB = twt.TIMESTAMP_BEGIN + 1501  # = 51865
KW = dict(vocab_size=VOCAB, num_mel_bins=80, d_model=32, encoder_layers=1, decoder_layers=1,
          num_heads=4, d_ff=64, max_source_positions=1500, max_target_positions=64,
          dtype="float32")
GREEDY = dict(max_decode_len=12, temperatures=(0.0,), compression_ratio_threshold=None,
              logprob_threshold=None, no_speech_threshold=None)


@pytest.fixture(scope="module")
def models():
    jm = jw.Whisper(jw.WhisperConfig(**KW))
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 80, 3000)),
                                    jnp.zeros((1, 4), jnp.int32))["params"])
    tm = tw.Whisper(tw.WhisperConfig(**KW))
    tm.load_state_dict(whisper_from_jax_params(params, tm))
    return jm, params, tm


def _pair(models, **kw):
    jm, params, tm = models
    return (jwt.JaxWhisperTranscriber(jm, params, **kw),
            twt.WhisperTranscriber(tm, device="cpu", **kw))


def _noise(seed, seconds, scale=0.05):
    return (np.random.default_rng(seed).normal(size=int(16000 * seconds)) * scale
            ).astype(np.float32)


def _tones_with_gaps(seed, seconds):
    """Tones plus noise with silent stretches (the VAD's work)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)
    audio += rng.normal(size=t.shape) * 0.02
    for start in rng.uniform(0, seconds - 8, 2):
        audio[int(start * 16000):int((start + 6) * 16000)] = 0.0
    return audio.astype(np.float32)


# ---- pure functions --------------------------------------------------------


def test_language_table_and_tokens_match_jax():
    assert twt.WHISPER_LANGUAGES == jwt.WHISPER_LANGUAGES
    for name in ("SOT", "TRANSCRIBE", "NO_TIMESTAMPS", "TIMESTAMP_BEGIN", "EOT", "LANG_EN",
                 "NO_SPEECH", "SOT_PREV", "TIME_PRECISION", "LANG_BEGIN"):
        assert getattr(twt, name) == getattr(jwt, name), name
    for code in ("en", "ja", "su", "haw"):
        assert twt.language_token_for(code) == jwt.language_token_for(code)
        assert twt.language_code_for(twt.language_token_for(code)) == code
    with pytest.raises(ValueError):
        twt.language_token_for("xx")
    with pytest.raises(ValueError):
        twt.language_code_for(twt.SOT)


def test_compression_ratio_matches_jax():
    for text in ("", "the cat sat " * 60, "chapters are segments of a longer video",
                 " ".join(str(i) for i in range(300))):
        assert twt.compression_ratio(text) == jwt.compression_ratio(text)


def test_detect_language_from_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, VOCAB)).astype(np.float32)
    logits[0, twt.language_token_for("fr")] = 9.0
    logits[0, 123] = 50.0                        # a dominant text token is ignored
    logits[1, twt.TIMESTAMP_BEGIN + 3] = 60.0     # and a dominant timestamp
    jt, jp = jwt.detect_language_from_logits(jnp.asarray(logits))
    tt, tp = twt.detect_language_from_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    assert twt.language_code_for(int(tt[0])) == "fr"


def _random_states(rng, n):
    tb = twt.TIMESTAMP_BEGIN
    kinds = rng.integers(0, 3, (3, n))
    prev = np.where(kinds[0] == 0, -1, np.where(kinds[0] == 1, rng.integers(0, tb, n),
                                                rng.integers(tb, VOCAB, n)))
    prevprev = np.where(kinds[1] == 0, tb, np.where(kinds[1] == 1, rng.integers(0, tb, n),
                                                    rng.integers(tb, VOCAB, n)))
    ts_last = np.where(kinds[2] == 0, tb - 1, rng.integers(tb, VOCAB, n))
    return [a.astype(np.int32) for a in (prev, prevprev, ts_last)]


@pytest.mark.parametrize("is_first,max_initial", [(False, 50), (True, 50), (True, None)])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_timestamp_rules_exact(is_first, max_initial, scale):
    """Random logits and states (sentinel, text or timestamp in each slot):
    the filtered logits are identical, and so are the updated states."""
    rng = np.random.default_rng(int(scale * 10) + is_first)
    n = 64
    logits = (rng.normal(size=(n, VOCAB)) * scale).astype(np.float32)
    logits[: n // 4, twt.TIMESTAMP_BEGIN:] += 3.0   # rows where the mass rule forces
    state = _random_states(rng, n)
    ref = jwt.apply_timestamp_rules(jnp.asarray(logits), tuple(jnp.asarray(s) for s in state),
                                    is_first, max_initial)
    got = twt.apply_timestamp_rules(torch.from_numpy(logits),
                                    tuple(torch.from_numpy(s) for s in state), is_first,
                                    max_initial)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    nxt = rng.integers(0, VOCAB, n).astype(np.int32)
    jst = jwt.update_timestamp_state(tuple(jnp.asarray(s) for s in state), jnp.asarray(nxt))
    tst = twt.update_timestamp_state(tuple(torch.from_numpy(s) for s in state),
                                     torch.from_numpy(nxt))
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(twt.init_timestamp_state(3), jwt.init_timestamp_state(3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_segments_from_tokens_match_jax():
    rng = np.random.default_rng(7)
    tb = twt.TIMESTAMP_BEGIN

    class _J:
        _segments_from_tokens = jwt.JaxWhisperTranscriber._segments_from_tokens

    for trial in range(40):
        toks = [int(t) for t in np.where(rng.random(30) < 0.3, rng.integers(tb, VOCAB, 30),
                                         rng.integers(0, 50000, 30))][: trial % 30]
        offset = float(rng.uniform(0, 100))
        assert (twt.WhisperTranscriber._segments_from_tokens(None, toks, offset)
                == _J._segments_from_tokens(_J(), toks, offset))


# ---- transcription ---------------------------------------------------------


@pytest.mark.parametrize("mega", [True, False])
def test_transcribe_matches_jax(models, monkeypatch, mega):
    """Language detection, the timestamp rules and long-form seeking, on
    the kernel route (its plain version here) and the standard route."""
    monkeypatch.setattr(twt, "USE_MEGA_DECODE", None if mega else False)
    jt, tt = _pair(models, **GREEDY)
    audio = _noise(0, 31)
    assert tt.transcribe(audio) == jt.transcribe(audio)
    assert tt.detect_language(audio) == pytest.approx(jt.detect_language(audio), abs=1e-6)
    assert ("pending_src" in tt.decode_fns.init_cache(3, torch.zeros(1, 1500, 32))) == mega


def test_transcribe_batch_matches_jax(models):
    jt, tt = _pair(models, **GREEDY)
    audios = [_noise(1, s) for s in (8, 35, 61)]
    assert tt.transcribe_batch(audios) == jt.transcribe_batch(audios)
    assert tt.transcribe_batch([]) == []


def test_vad_skips_windows_and_matches_jax(models):
    jt, tt = _pair(models, vad=True, **GREEDY)
    audios = [np.concatenate([np.zeros(16000 * 40, np.float32), _noise(2, 20, 0.3)]),
              _tones_with_gaps(3, 45)]
    out = tt.transcribe(audios[0])
    assert out == jt.transcribe(audios[0])
    assert out["start"] and min(out["start"]) > 39.0  # the silent 40 s are skipped
    plain = twt.WhisperTranscriber(models[2], device="cpu", **GREEDY)
    plain.transcribe(audios[0])
    assert tt.decode_calls < plain.decode_calls
    assert tt.transcribe_batch(audios) == jt.transcribe_batch(audios)


def test_beam5_matches_jax(models):
    jt, tt = _pair(models, beam_size=5, **{**GREEDY, "temperatures": (0.0, 0.5)})
    mel = np.random.default_rng(4).normal(0, 1, (80, 3000)).astype(np.float32)
    got, ref = tt._decode_window(mel, 0), jt._decode_window(mel, 0)
    assert got[0] == ref[0] and got[3] == ref[3] == 0.0
    assert got[1:3] == pytest.approx(ref[1:3], rel=1e-5)
    audios = [_noise(5, 31), _noise(6, 12)]
    assert tt.transcribe_batch(audios) == jt.transcribe_batch(audios)


def test_conditioning_and_no_speech_skip_match_jax(models):
    jt, tt = _pair(models, condition_on_previous_text=True, prompt_len=8, **GREEDY)
    assert tt._prompt_prefix([101, 102, 103]) == jt._prompt_prefix([101, 102, 103])
    audio = _noise(8, 35)
    assert tt.transcribe(audio) == jt.transcribe(audio)
    jt, tt = _pair(models, **{**GREEDY, "no_speech_threshold": -1.0})
    out = tt.transcribe(audio)
    assert out == jt.transcribe(audio) and out["text"] == []


def test_near_zero_temperature_rung_equals_greedy_and_jax(models):
    """A rung at temperature 1e-6 takes the sampled path; its draws equal
    the greedy tokens, and the JAX package's."""
    jt, tt = _pair(models, **{**GREEDY, "temperatures": (1e-6,)})
    mel = np.random.default_rng(9).normal(0, 1, (80, 3000)).astype(np.float32)
    greedy = twt.WhisperTranscriber(models[2], device="cpu", **GREEDY)
    got = tt._decode_window(mel, 3)
    assert got[0] == greedy._decode_window(mel, 3)[0]
    ref = jt._decode_window(mel, 3)
    assert got[0] == ref[0] and got[2] == pytest.approx(ref[2], abs=1e-6)


def test_sampled_rung_draws_follow_softmax():
    """``_pick`` at temperature 0.7 over fixed logits: the frequencies of
    4000 draws (one seed each) against softmax(logits / 0.7); a row at
    temperature 0 in the same batch stays greedy."""
    cfg = tw.WhisperConfig(**{**KW, "vocab_size": 8, "max_source_positions": 30})
    tr = twt.WhisperTranscriber(tw.Whisper(cfg), device="cpu", max_decode_len=12)
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5, 1.5, -2.0, 0.2]] * 2)
    temp = torch.tensor([0.7, 0.0])
    counts = np.zeros(8)
    for key in range(4000):
        nxt, logp = tr._pick(logits, temp, key, 0, sample=True)
        counts[int(nxt[0])] += 1
        assert int(nxt[1]) == 2
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    assert np.abs(counts / 4000 - want).max() < 0.03
    np.testing.assert_allclose(logp.numpy(), torch.log_softmax(logits, -1)[[0, 1], nxt].numpy())


def test_decode_steps_per_call(models, monkeypatch):
    """Every decode call runs max_decode_len - 1 decoder steps (the prefix
    plus the fixed-length loop, greedy, sampled or beam) and every language
    detection one: the count the card run holds the kernel's launches to."""
    _, _, tm = models
    tr = twt.WhisperTranscriber(tm, device="cpu", max_decode_len=12, beam_size=5)
    steps = []
    real = tr.decode_fns.step
    monkeypatch.setattr(tr, "decode_fns", tr.decode_fns._replace(
        step=lambda *a: steps.append(1) or real(*a)))
    out = tr.transcribe_batch([_noise(10, 20), _noise(11, 40)])
    assert set(out[0]) == {"text", "start", "end", "language"}
    assert tr.decode_calls >= 6 and tr.detect_calls == 1
    assert len(steps) == 11 * tr.decode_calls + tr.detect_calls


def test_param_dtype_bfloat16_transcribes(models):
    cfg = tw.WhisperConfig(**KW)
    model = tw.Whisper(cfg)
    model.load_state_dict(models[2].state_dict())
    tr = twt.WhisperTranscriber(model, device="cpu", max_decode_len=8, param_dtype="bfloat16",
                                language="fr")
    assert all(p.dtype == torch.bfloat16 for p in tr.model.parameters())
    out = tr.transcribe(np.zeros(16000 * 5, np.float32))
    assert set(out) == {"text", "start", "end", "language"} and out["language"] == "fr"


# ---- the factory -----------------------------------------------------------


def _write_wavs(tmp_path, n):
    paths = []
    for i in range(n):
        p = tmp_path / f"vid_{i:011d}.wav"
        sig = _noise(20 + i, 3 + 2 * i)
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((sig * 32767).astype(np.int16).tobytes())
        paths.append(str(p))
    return paths


def test_run_batched_asr_pickles_and_merges_match_jax(models, tmp_path):
    jt, tt = _pair(models, **GREEDY)
    paths = _write_wavs(tmp_path, 3)
    assert tasr.run_batched_asr(paths, str(tmp_path / "t"), tt, batch_size=2) == 3
    assert jasr.run_batched_asr(paths, str(tmp_path / "j"), jt, batch_size=2) == 3
    for p in paths:
        name = p.rsplit("/", 1)[1].replace(".wav", ".pkl")
        got = pickle.load(open(tmp_path / "t" / name, "rb"))
        assert set(got) == {"text", "start", "end", "language"}
        assert got == pickle.load(open(tmp_path / "j" / name, "rb"))
    assert tasr.run_batched_asr(paths, str(tmp_path / "t"), tt, batch_size=2) == 0  # idempotent
    merged = tasr.merge_asr_pickles(str(tmp_path / "t"), str(tmp_path / "m.pkl"))
    assert merged == jasr.merge_asr_pickles(str(tmp_path / "j"), str(tmp_path / "mj.pkl"))
    assert merged == pickle.load(open(tmp_path / "m.pkl", "rb"))
    proc = tasr.merge_and_process(str(tmp_path / "t"), str(tmp_path / "p.pkl"))
    assert proc == jasr.merge_and_process(str(tmp_path / "j"), str(tmp_path / "pj.pkl"))


def test_proc_asr_normalize_and_sharded_match_jax(tmp_path):
    raws = [{"segments": [{"text": " hi ", "start": 0, "end": 1.5}, {"text": "", "start": 2,
                                                                      "end": 3},
                          {"text": "no end", "start": 4}], "language": "de"},
            {"segments": []}]
    for raw in raws:
        assert tasr.proc_asr(raw) == jasr.proc_asr(raw)
    for name in ("v_abcdefghijk_extra.pkl", "xx_ABCDEFGHIJK.pkl", "short.pkl"):
        assert tasr.normalize_video_id(name) == jasr.normalize_video_id(name)
    fn = lambda p: {"text": [p[-5:]], "start": [0.0], "end": [1.0]}  # noqa: E731
    paths = [f"/data/video_{i}.mp4" for i in range(5)]
    assert tasr.run_sharded_asr(paths, str(tmp_path / "t"), fn, seed=3) == 5
    assert jasr.run_sharded_asr(paths, str(tmp_path / "j"), fn, seed=3) == 5
    assert tasr.run_sharded_asr(paths, str(tmp_path / "t"), fn, seed=3) == 0
    for i in range(5):
        assert (pickle.load(open(tmp_path / "t" / f"video_{i}.pkl", "rb"))
                == pickle.load(open(tmp_path / "j" / f"video_{i}.pkl", "rb")))


def test_audio_and_vad_copies_match_jax(tmp_path):
    from vidchapters_tpu.factory import audio as ja
    from vidchapters_tpu.factory import vad as jv
    from vidchapters_tpu_torch.factory import audio as ta
    from vidchapters_tpu_torch.factory import vad as tv

    audio = _tones_with_gaps(12, 20)
    np.testing.assert_array_equal(ta.log_mel_spectrogram(audio), ja.log_mel_spectrogram(audio))
    assert tv.speech_segments(audio) == jv.speech_segments(audio)
    segs = tv.speech_segments(audio)
    for seek in (0, 16000 * 3, 16000 * 11):
        assert (tv.next_voiced_seek(segs, seek, 480000, len(audio))
                == jv.next_voiced_seek(segs, seek, 480000, len(audio)))
    path = _write_wavs(tmp_path, 1)[0]
    np.testing.assert_array_equal(ta.load_audio(path), ja.load_audio(path))
