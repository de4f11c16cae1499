"""The port's host-side C++ libraries (``vidchapters_tpu_torch/native``):

- the SentencePiece Viterbi (``data/native_spm.py``) gives the ids of the
  port's Python Viterbi and of the JAX package's tokenizer, on
  ``tests/test_native_spm.py``'s texts and on 200 random strings;
- the feature loader (``data/native_loader.py``) gives ``subsample_or_pad``'s
  rows, through ``FeatureSource`` too, and its prefetch fills the cache,
  from ``EpochIterator`` for a DVC set and not for ``YTPretrainDataset``;
- both build into ``build/vidchapters_tpu_torch/``, never into ``native/``.

Skipped only where g++ is absent.
"""

import random
import shutil
import time

import numpy as np
import pytest

from tests.test_native_spm import TEXTS
from tests.test_spm_tokenizer import PIECES, make_spm_model

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build native/")


@pytest.fixture
def model_path(tmp_path):
    p = tmp_path / "spiece.model"
    make_spm_model(p, PIECES)
    return str(p)


def _random_texts(n=200, seed=0):
    rng = random.Random(seed)
    alphabet = list("the cats dog") + ["▁", "é", "☃", "日", "  ", "\t", "x", "\x00"]
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 60)))
            for _ in range(n)]


def test_native_spm_ids_equal_python_and_jax(model_path):
    from vidchapters_tpu.data.tokenizer import SentencePieceUnigramTokenizer as JaxSpm
    from vidchapters_tpu_torch.data import _native_build, native_spm
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceUnigramTokenizer

    nat = SentencePieceUnigramTokenizer(model_path, extra_ids=4, use_native=True)
    py = SentencePieceUnigramTokenizer(model_path, extra_ids=4, use_native=False)
    auto = SentencePieceUnigramTokenizer(model_path, extra_ids=4)
    ref = JaxSpm(model_path, extra_ids=4, use_native=False)
    assert nat._native is not None and auto._native is not None and py._native is None
    calls = native_spm.NativeSpmEncoder.calls
    for text in TEXTS + _random_texts():
        want = ref._encode_text(text)
        assert nat._encode_text(text) == py._encode_text(text) == want, repr(text)
        assert (nat.encode(text, add_special_tokens=True)
                == ref.encode(text, add_special_tokens=True)), repr(text)
    assert native_spm.NativeSpmEncoder.calls > calls
    lib = _native_build.library("spm_encoder")
    assert lib.parent == _native_build.BUILD_DIR and lib.parent.name == "vidchapters_tpu_torch"


def _loader():
    from vidchapters_tpu_torch.data.native_loader import NativeFeatureLoader

    return NativeFeatureLoader(num_threads=2, cache_bytes=1 << 24)


@pytest.mark.parametrize("rows,dtype", [(7, np.float32), (10, np.float32), (37, np.float32),
                                        (23, np.float64)])
def test_native_loader_equals_subsample_or_pad(tmp_path, rows, dtype):
    from vidchapters_tpu_torch.data.features import FeatureSource, subsample_or_pad

    arr = np.random.default_rng(rows).normal(size=(rows, 6)).astype(dtype)
    np.save(tmp_path / "vid.mp4.npy", arr)
    want = subsample_or_pad(arr.astype(np.float32), 10, 6)
    loader = _loader()
    assert loader.shape(str(tmp_path / "vid.mp4.npy")) == (rows, 6)
    np.testing.assert_array_equal(loader.load(str(tmp_path / "vid.mp4.npy"), 10, 6), want)
    native = FeatureSource(str(tmp_path), max_feats=10, features_dim=6, native=True)
    plain = FeatureSource(str(tmp_path), max_feats=10, features_dim=6, native=False)
    np.testing.assert_array_equal(native("vid"), want)
    np.testing.assert_array_equal(plain("vid"), want)
    assert native._native_loader() is not None and plain._native_loader() is None


def _wait_for(cond, seconds=10.0):
    end = time.time() + seconds
    while not cond() and time.time() < end:
        time.sleep(0.01)
    return cond()


def test_prefetch_fills_the_cache(tmp_path):
    from tests.test_torch_pretrain import _data_cfgs, write_htm
    from vidchapters_tpu_torch.data.dvc_dataset import (
        DenseVideoCaptioningDataset,
        EpochIterator,
        YTPretrainDataset,
    )
    from vidchapters_tpu_torch.data.tokenizer import ByteLevelTokenizer

    rng = np.random.default_rng(0)
    (tmp_path / "f").mkdir()
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / "f" / f"v{i:010d}.npy"))
        np.save(paths[-1], rng.normal(size=(12, 8)).astype(np.float32))
    loader = _loader()
    loader.prefetch(paths[:3])
    assert _wait_for(lambda: loader.cache_entries() == 3)

    cfg = _data_cfgs()[1]
    ann = {f"v{i:010d}": {"duration": 10.0, "timestamps": [[0.0, 5.0]], "sentences": ["a"]}
           for i in range(4)}
    ds = DenseVideoCaptioningDataset(ann, str(tmp_path / "f"), ByteLevelTokenizer(), cfg)
    it = EpochIterator(ds, 2, cfg, shuffle=False)
    next(iter(it))  # the first batch prefetches the second
    native = ds.features._native_loader()
    assert native is not None and _wait_for(lambda: native.cache_entries() >= 2)

    write_htm(tmp_path / "htm", n=4)
    yt = YTPretrainDataset.from_csv(str(tmp_path / "htm" / "htm.csv"),
                                    str(tmp_path / "htm" / "feats"), ByteLevelTokenizer(),
                                    str(tmp_path / "htm" / "asr.pkl"), cfg)
    list(EpochIterator(yt, 2, cfg, seed=0))
    assert yt.features._native is None  # read through raw + subsample_or_pad only
