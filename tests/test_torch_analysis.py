"""The port's dataset analysis (``factory/analysis.py``, ``factory/langid.py``,
``factory/genbit.py``) and host utilities (``utils/misc.py``,
``utils/preproc_answer.py``) against the JAX package's, on the CPU, on the
JAX tests' own inputs (``tests/test_langid_genbit.py``,
``tests/test_utils_misc.py``):

- ``langid.detect_langs`` (every language's posteriors) equal; GenBit's
  ``get_metrics`` equal; ``language_stats``, ``gender_stats`` and
  ``toxicity_stats``'s blocklist equal; both jobs' outputs equal, the
  language job idempotent;
- ``utils/misc`` and ``preprocess_answer`` equal;
- the toxicity scorer within 1e-5 of JAX's ``build_toxicity_scorer`` on a
  tiny HF ``BertForSequenceClassification`` directory saved as
  ``pytorch_model.bin`` and as safetensors (each read by ``utils/hf.py``
  here and by ``transformers`` there);
- the NSFW head within 1e-6.
"""

import json
import pickle

import numpy as np
import pytest

import torch

from tests.test_langid_genbit import HELD_OUT, HELD_OUT_MULTI


def test_langid_posteriors_equal_jax():
    from vidchapters_tpu.factory import langid as jl
    from vidchapters_tpu_torch.factory import langid as tl

    assert tl.supported_languages() == jl.supported_languages()
    k = len(jl.supported_languages())
    texts = list(HELD_OUT.values()) + [s for v in HELD_OUT_MULTI.values() for s in v[::3]]
    for text in texts:
        assert tl.detect_langs(text, top_k=k) == jl.detect_langs(text, top_k=k)
        assert tl.detect(text) == jl.detect(text)
    with pytest.raises(ValueError):
        tl.detect("   ")


def test_genbit_metrics_equal_jax():
    from vidchapters_tpu.factory import genbit as jg
    from vidchapters_tpu_torch.factory import genbit as tg

    docs = (["the nurse helped her patient today"] * 6 + ["the doctor finished his shift today"]
            * 6 + ["his hammer"] * 20 + ["his chisel", "she and he walked the dog",
                                          "he saw her", "the man and the woman walked"])
    for kw in (dict(), dict(percentile_cutoff=0), dict(context_window=3, distance_weight=0.5)):
        got, ref = tg.GenBitMetrics("en", **kw), jg.GenBitMetrics("en", **kw)
        got.add_data(docs, tokenized=False)
        ref.add_data(docs, tokenized=False)
        assert (got.get_metrics(output_statistics=True, output_word_list=True)
                == ref.get_metrics(output_statistics=True, output_word_list=True))
    assert tg.gender_metrics(docs) == jg.gender_metrics(docs)


def test_stats_equal_jax():
    from vidchapters_tpu.factory import analysis as ja
    from vidchapters_tpu_torch.factory import analysis as ta

    asr = {f"v{i}": {"text": [t]} for i, t in enumerate(list(HELD_OUT.values()) + ["", "  "])}
    assert ta.language_stats(asr) == ja.language_stats(asr)
    assert ta.detect_language("") == ja.detect_language("") == "unknown"
    texts = ["She and her sister met the King", "he told his brother", "the dog sat", "",
             "what the fuck", "a nice bastard"]
    assert ta.gender_stats(texts) == ja.gender_stats(texts)
    assert ta.toxicity_stats(texts) == ja.toxicity_stats(texts)
    assert ta.toxicity_stats(texts, scorer=len, threshold=10) == ja.toxicity_stats(
        texts, scorer=len, threshold=10)


def test_jobs_equal_jax(tmp_path):
    from vidchapters_tpu.factory import analysis as ja
    from vidchapters_tpu_torch.factory import analysis as ta

    asr_dir = tmp_path / "asr"
    asr_dir.mkdir()
    for i, text in enumerate([HELD_OUT["en"], HELD_OUT["de"], "", HELD_OUT["ja"]]):
        with open(asr_dir / f"v{i}.pkl", "wb") as f:
            pickle.dump({"text": [text], "start": [0.0], "end": [1.0]}, f)
    outs = {}
    for name, mod in (("jax", ja), ("port", ta)):
        out = tmp_path / f"lang_{name}"
        assert mod.analyze_language_job(str(asr_dir), str(out)) == 4
        assert mod.analyze_language_job(str(asr_dir), str(out)) == 0  # idempotent
        outs[name] = {f.stem: pickle.loads(f.read_bytes()) for f in out.glob("*.pkl")}
    assert outs["port"] == outs["jax"] and outs["port"]["v2"] == {"asr_lang": None}
    chapters = {"vid1": {"chapters": [{"label": "the king and his men"},
                                      {"label": "she bakes bread"}]},
                "vid0": {"chapters": [{"label": "her mother and the nurse"}]}}
    pkl = tmp_path / "chapters.pkl"
    pkl.write_bytes(pickle.dumps(chapters))
    got = ta.analyze_gender_job(str(pkl), str(tmp_path / "port.json"))
    ref = ja.analyze_gender_job(str(pkl), str(tmp_path / "jax.json"))
    assert got == ref
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_utils_misc_and_preproc_answer_equal_jax(tmp_path):
    from vidchapters_tpu.utils import misc as jm
    from vidchapters_tpu.utils.preproc_answer import preprocess_answer as jp
    from vidchapters_tpu_torch.utils import misc as tm
    from vidchapters_tpu_torch.utils.preproc_answer import preprocess_answer as tp

    seqs = [np.ones((3, 2)), np.arange(10.0).reshape(5, 2)]
    for kw in (dict(), dict(fixed_length=4)):
        for g, r in zip(tm.pad_sequences_1d(seqs, **kw), jm.pad_sequences_1d(seqs, **kw)):
            np.testing.assert_array_equal(g, r)
    seqs2 = [[np.ones(2), np.arange(4.0)], [np.ones(3)]]
    for g, r in zip(tm.pad_sequences_2d(seqs2), jm.pad_sequences_2d(seqs2)):
        np.testing.assert_array_equal(g, r)
    x = np.array([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_array_equal(tm.l2_normalize_np_array(x), jm.l2_normalize_np_array(x))
    a, b = tm.AverageMeter(), jm.AverageMeter()
    for v, n in ((1.0, 1), (3.0, 2)):
        a.update(v, n)
        b.update(v, n)
    assert vars(a) == vars(b)
    src = tmp_path / "code"
    (src / "pkg").mkdir(parents=True)
    (src / "pkg" / "a.py").write_text("x = 1")
    (src / "pkg" / "b.pyc").write_text("junk")
    import zipfile

    tm.make_zipfile(str(src), str(tmp_path / "t.zip"), enclosing_dir="code")
    jm.make_zipfile(str(src), str(tmp_path / "j.zip"), enclosing_dir="code")
    assert (zipfile.ZipFile(tmp_path / "t.zip").namelist()
            == zipfile.ZipFile(tmp_path / "j.zip").namelist())
    d = {"lr": 0.001, "name": "test", "long": "x" * 300}
    assert tm.dict_to_markdown(d) == jm.dict_to_markdown(d)
    for ans in ("The TWO dogs!", "dont", "a cat.", "It's 3,000.5 dollars", "Yes, ten!!"):
        assert tp(ans) == jp(ans)


@pytest.fixture(scope="module")
def cls_dirs(tmp_path_factory):
    """A tiny ``BertForSequenceClassification`` directory written by
    ``transformers`` as ``pytorch_model.bin`` and as safetensors."""
    transformers = pytest.importorskip("transformers")
    from tests._torch_helpers import write_wordpiece_vocab

    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=400, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=64, type_vocab_size=2, num_labels=6,
                                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    hf = transformers.BertForSequenceClassification(cfg).eval()
    dirs = {}
    for fmt, safe in (("bin", False), ("safetensors", True)):
        d = tmp_path_factory.mktemp(f"toxbert_{fmt}")
        write_wordpiece_vocab(d / "vocab.txt", 400)
        hf.save_pretrained(str(d), safe_serialization=safe)
        assert (d / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
        dirs[fmt] = d
    return dirs


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_toxicity_scorer_matches_jax(cls_dirs, fmt):
    from vidchapters_tpu.factory import analysis as ja
    from vidchapters_tpu_torch.factory import analysis as ta

    texts = ["hello world this video is great", "awful terrible content", "Bread, dough!",
             "nice " * 40]
    ref = ja.build_toxicity_scorer(str(cls_dirs[fmt]), max_length=16)
    got = ta.build_toxicity_scorer(str(cls_dirs[fmt]), max_length=16, device="cpu")
    for text in texts:
        r, g = ref(text), got(text)
        assert isinstance(g, float) and abs(g - r) <= 1e-5, (text, g, r)
    assert (ta.toxicity_stats(texts, scorer=got) == pytest.approx(
        ja.toxicity_stats(texts, scorer=ref), abs=1e-5))


def test_nsfw_scorer_matches_jax(tmp_path):
    from vidchapters_tpu.factory import analysis as ja
    from vidchapters_tpu_torch.factory import analysis as ta

    rng = np.random.default_rng(0)
    dims = (768, 64, 16, 1)
    arrays = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        arrays[f"w{i}"] = (rng.normal(size=(a, b)) * a ** -0.5).astype(np.float32)
        arrays[f"b{i}"] = rng.normal(size=(b,)).astype(np.float32)
    np.savez(tmp_path / "nsfw.npz", **arrays)
    emb = rng.normal(size=(9, 768)).astype(np.float32)
    ref = ja.build_nsfw_scorer(str(tmp_path / "nsfw.npz"))(emb)
    got = ta.build_nsfw_scorer(str(tmp_path / "nsfw.npz"), device="cpu")(emb)
    assert got.shape == (9,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.savez(tmp_path / "empty.npz", x=np.zeros(1))
    with pytest.raises(ValueError, match="no dense layers"):
        ta.build_nsfw_scorer(str(tmp_path / "empty.npz"), device="cpu")


def test_analysis_cli(tmp_path, capsys, monkeypatch):
    import sys

    from vidchapters_tpu_torch.factory import analysis as ta

    asr_dir = tmp_path / "asr"
    asr_dir.mkdir()
    (asr_dir / "v0.pkl").write_bytes(pickle.dumps({"text": [HELD_OUT["fr"]]}))
    monkeypatch.setattr(sys, "argv", ["analysis", "language", "--asr-dir", str(asr_dir),
                                      "--out-dir", str(tmp_path / "out")])
    ta._main()
    assert json.loads(capsys.readouterr().out) == {"processed": 1}
    (tmp_path / "c.pkl").write_bytes(pickle.dumps({"v": {"chapters": [{"label": "his dog"}]}}))
    monkeypatch.setattr(sys, "argv", ["analysis", "gender", "--chapters-pkl",
                                      str(tmp_path / "c.pkl"), "--out-json",
                                      str(tmp_path / "g.json")])
    ta._main()
    out = json.loads(capsys.readouterr().out)
    assert out["percentage_of_male_gender_definition_words"] > 0
