"""The port's ``demo_asr`` path against the JAX package's on one tiny HF
Whisper directory.

The directory is ``transformers.WhisperForConditionalGeneration`` at d_model
32, 1 + 1 layers and the multilingual vocabulary's 51865 ids, written by
``save_pretrained`` as safetensors and as sharded ``pytorch_model.bin``,
with a synthetic byte-level BPE tokenizer beside it
(``tests/_torch_helpers.write_whisper_tokenizer``). The JAX package reads it
through ``transformers``, the port through its own readers.

Both packages compute in bf16 by default, on different backends; the
comparisons run both at fp32 (each package's ``WhisperConfig`` given
``dtype="float32"``). The transcribers keep every default but the
temperature ladder, pinned to its greedy rung: the sampled rungs draw from
``jax.random`` in one package and ``torch.Generator`` in the other, which
cannot give the same draws (``tests/test_torch_whisper_transcribe.py``
holds them by their filter and distribution), and a random model climbs
every rung."""

import functools
import pickle
import wave

import numpy as np
import pytest
import torch

from tests._torch_helpers import WHISPER_TEXTS, byte_bpe_merges, whisper_vocab
from tests._torch_helpers import write_whisper_tokenizer

TIMESTAMP_BEGIN = 50364
FORMATS = ("safetensors", "bin_shards", "safetensors_fp16")


def _write_dir(root, fmt: str, seed: int = 0):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    torch.manual_seed(seed)
    hf = WhisperForConditionalGeneration(WhisperConfig(
        vocab_size=TIMESTAMP_BEGIN + 1501, num_mel_bins=80, d_model=32, encoder_layers=1,
        decoder_layers=1, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=1500,
        max_target_positions=448))
    if fmt.startswith("safetensors"):
        # fp16 rounds the stored sinusoids past 1e-4 of their fp32 values
        (hf.half() if fmt.endswith("fp16") else hf).save_pretrained(root, safe_serialization=True)
        assert (root / "model.safetensors").exists()
    else:
        hf.save_pretrained(root, safe_serialization=False, max_shard_size="2MB")
        assert (root / "pytorch_model.bin.index.json").exists()
    merges = byte_bpe_merges(WHISPER_TEXTS.splitlines(), 400)
    write_whisper_tokenizer(root, whisper_vocab(merges), merges)
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's decode steps are small operators: one intra-op
    thread runs them as fast, and does not spin against the threads of
    the other test processes on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    return {fmt: _write_dir(tmp_path_factory.mktemp(fmt), fmt) for fmt in FORMATS}


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' loaders build fp32 Whisper configs."""
    import vidchapters_tpu.models.whisper as jw

    import vidchapters_tpu_torch.models.whisper as tw

    for mod in (jw, tw):
        monkeypatch.setattr(mod, "WhisperConfig",
                            functools.partial(mod.WhisperConfig, dtype="float32"))


@pytest.fixture
def greedy(monkeypatch):
    """Both demos' transcribers at their greedy rung only."""
    import vidchapters_tpu.factory.whisper_transcribe as jt

    import vidchapters_tpu_torch.factory.whisper_transcribe as tt

    monkeypatch.setattr(jt, "JaxWhisperTranscriber",
                        functools.partial(jt.JaxWhisperTranscriber, temperatures=(0.0,)))
    monkeypatch.setattr(tt, "WhisperTranscriber",
                        functools.partial(tt.WhisperTranscriber, temperatures=(0.0,)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_hf_whisper_matches_jax(hf_dirs, fp32, fmt):
    """The port's ``load_hf_whisper`` and JAX's on the same directory
    (fp32 safetensors, sharded ``.bin``, fp16 safetensors): encoder outputs
    and decoder logits within 1e-5 at fp32; the config's fields as JAX
    reads them; the parameters held in float32."""
    import jax.numpy as jnp

    from vidchapters_tpu.models.whisper import load_hf_whisper as jax_load

    from vidchapters_tpu_torch.models.whisper import load_hf_whisper

    jm, params = jax_load(str(hf_dirs[fmt]))
    model = load_hf_whisper(str(hf_dirs[fmt]), device="cpu")
    assert {f: getattr(model.cfg, f) for f in vars(model.cfg)} == {
        f: getattr(jm.cfg, f) for f in vars(model.cfg)}
    assert model.cfg.dtype == "float32" and next(model.parameters()).dtype == torch.float32
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, 80, 3000)).astype(np.float32)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    enc = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode))
    logits = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    with torch.no_grad():
        got_enc = model.encode(torch.from_numpy(mel)).numpy()
        got = model(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got_enc, enc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, logits, atol=1e-5, rtol=0)


def _wav(path, seconds: float = 30.0, seed: int = 0):
    """Tones and noise with a silent gap of 3 s, 16 kHz mono (30 s: the
    random model's timestamps run to the end of its window, and segments
    past the audio get no words)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (180.0, 440.0, 730.0))
    sig = sig + rng.normal(size=t.shape) * 0.05
    sig[int(4 * 16000):int(7 * 16000)] = 0.0
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


RUNS = {"plain": [], "vad_align": ["--vad", "--align"], "language_en": ["--language", "en"]}


@pytest.mark.parametrize("run", list(RUNS))
def test_demo_asr_matches_jax(hf_dirs, fp32, greedy, tmp_path, run):
    """``vidchapters_tpu.demo.demo_asr.main(--backend jax)`` and the port's
    ``main(--device cpu)`` on the same directory and audio write equal
    pickles: segments with their texts, starts and ends, ``words`` and
    ``word_segments`` when aligned, and the language."""
    from vidchapters_tpu.demo import demo_asr as jax_demo

    from vidchapters_tpu_torch.demo import demo_asr

    wav = _wav(tmp_path / "in.wav")
    model = str(hf_dirs["safetensors"])
    outs = {}
    for name, fn, extra in (("jax", jax_demo.main, ["--backend", "jax"]),
                            ("port", demo_asr.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.pkl"
        fn(["--video_path", str(wav), "--out", str(out), "--model", model] + extra + RUNS[run])
        with open(out, "rb") as f:
            outs[name] = pickle.load(f)
    got, want = outs["port"], outs["jax"]
    assert got == want
    aligned = run == "vad_align"
    assert set(got) == ({"segments", "word_segments", "language"} if aligned
                        else {"segments", "language"})
    assert got["segments"], "the tiny model wrote no segment: the comparison would be empty"
    for seg in got["segments"]:
        assert set(seg) == ({"text", "start", "end", "words"} if aligned
                            else {"text", "start", "end"})
    if aligned:
        assert got["word_segments"] == [w for s in got["segments"] for w in s["words"]]
        assert got["word_segments"]
    if run == "language_en":
        assert got["language"] == "en"


def test_resolve_hf_dir_hub_cache(tmp_path, monkeypatch, hf_dirs):
    """A hub name resolves through ``refs/main`` to its snapshot in the hub
    cache, found in ``huggingface_hub``'s order (``$HF_HUB_CACHE``,
    ``$HUGGINGFACE_HUB_CACHE``, ``$HF_HOME/hub``,
    ``$XDG_CACHE_HOME/huggingface/hub``, ``~/.cache/huggingface/hub``),
    each case the cache ``huggingface_hub`` itself names; a directory
    resolves to itself; an absent name raises, naming every path looked in;
    the demo's default ``--model`` reads the cache."""
    import os
    import shutil
    import subprocess
    import sys

    from vidchapters_tpu_torch.utils.hf import resolve_hf_dir

    def snapshot(hub):
        repo = hub / "models--openai--whisper-large-v2"
        shutil.copytree(hf_dirs["safetensors"], repo / "snapshots" / "0123abcd")
        (repo / "refs").mkdir()
        (repo / "refs" / "main").write_text("0123abcd\n")
        return repo / "snapshots" / "0123abcd"

    def hub_cache_of_huggingface_hub():
        return subprocess.run(
            [sys.executable, "-c", "from huggingface_hub import constants; "
                                   "print(constants.HF_HUB_CACHE)"],
            env=dict(os.environ), capture_output=True, text=True, check=True).stdout.strip()

    for name in ["HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"]:
        monkeypatch.delenv(name, raising=False)
    # each variable set in turn over the ones before it: the last one set wins
    cases = [("HOME", tmp_path / "home", tmp_path / "home/.cache/huggingface/hub"),
             ("XDG_CACHE_HOME", tmp_path / "xdg", tmp_path / "xdg/huggingface/hub"),
             ("HF_HOME", tmp_path / "hf_home", tmp_path / "hf_home/hub"),
             ("HUGGINGFACE_HUB_CACHE", tmp_path / "legacy", tmp_path / "legacy"),
             ("HF_HUB_CACHE", tmp_path / "hub", tmp_path / "hub")]
    for name, value, hub in cases:
        monkeypatch.setenv(name, str(value))
        snap = snapshot(hub)
        assert resolve_hf_dir("openai/whisper-large-v2") == str(snap), name
        assert hub_cache_of_huggingface_hub() == str(hub), name
    repo = hub / "models--openai--whisper-large-v2"
    assert resolve_hf_dir(str(snap)) == str(snap)
    with pytest.raises(FileNotFoundError) as err:
        resolve_hf_dir("openai/whisper-tiny")
    assert str(hub / "models--openai--whisper-tiny" / "refs" / "main") in str(err.value)
    assert "openai/whisper-tiny" in str(err.value)
    (repo / "refs" / "main").write_text("ffff")
    with pytest.raises(FileNotFoundError, match="snapshots/ffff"):
        resolve_hf_dir("openai/whisper-large-v2")
    (repo / "refs" / "main").write_text("0123abcd")

    from vidchapters_tpu_torch.demo import demo_asr

    wav = _wav(tmp_path / "in.wav", seconds=3.0)
    demo_asr.main(["--video_path", str(wav), "--out", str(tmp_path / "o.pkl"), "--device",
                   "cpu", "--language", "en"])
    with open(tmp_path / "o.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"segments", "language"}


@pytest.mark.parametrize("backend", ["hf", "whisperx"])
def test_other_backends_raise_before_any_work(tmp_path, monkeypatch, backend):
    """``--backend hf`` / ``whisperx`` raise ``NotImplementedError`` naming
    what they would wrap, before reading the audio or the model."""
    from vidchapters_tpu_torch.demo import demo_asr
    from vidchapters_tpu_torch.factory import asr, audio

    monkeypatch.setattr(audio, "load_audio", lambda *a: pytest.fail("audio was read"))
    with pytest.raises(NotImplementedError, match="transformers" if backend == "hf"
                       else "whisperx"):
        demo_asr.main(["--video_path", str(tmp_path / "missing.wav"), "--out",
                       str(tmp_path / "o.pkl"), "--backend", backend, "--model", "nowhere"])
    with pytest.raises(NotImplementedError, match="transformers"):
        asr.make_hf_whisper_transcribe()
    assert not (tmp_path / "o.pkl").exists()


def test_default_device_is_cuda(tmp_path, hf_dirs):
    """Without ``--device`` the demo runs on the card: on a machine with no
    CUDA it raises, and does not carry on on the CPU."""
    from vidchapters_tpu_torch.demo import demo_asr

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    wav = _wav(tmp_path / "in.wav", seconds=2.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_asr.main(["--video_path", str(wav), "--out", str(tmp_path / "o.pkl"),
                       "--model", str(hf_dirs["safetensors"])])
    assert not (tmp_path / "o.pkl").exists()
