"""The port's training data path against the JAX package's, on the same
synthetic files and seeds: span corruption, ``collate`` and the batches of
``EpochIterator`` over ``DenseVideoCaptioningDataset`` (features directory,
annotation json, ASR pickle) must be equal, field by field."""

import json
import pickle

import numpy as np
import pytest


def _write_dataset(root, n_videos=6, frames=(40, 130), seed=0):
    rng = np.random.default_rng(seed)
    feats = root / "features"
    feats.mkdir()
    ann, asr = {}, {}
    for i in range(n_videos):
        vid = f"v_{i:09d}ab"[-11:] if i % 2 else f"prefix_{i:011d}"
        np.save(feats / f"{vid[-11:]}.npy",
                rng.normal(size=(int(rng.integers(*frames)), 32)).astype(np.float32))
        duration = float(rng.uniform(60, 300))
        n = int(rng.integers(2, 5))
        starts = sorted(rng.uniform(0, duration - 5, size=n).round(2).tolist())
        ann[vid] = {"duration": duration,
                    "timestamps": [[s, min(s + 20.0, duration)] for s in starts],
                    "sentences": [f"chapter {j} of video {i}" for j in range(n)]}
        if i != 3:  # one video without ASR
            m = int(rng.integers(3, 12))
            st = sorted(rng.uniform(0, duration, size=m).round(2).tolist())
            asr[vid[-11:]] = {"text": [f"we say thing {k} in clip {i} now" for k in range(m)],
                              "start": st, "end": [s + 3.0 for s in st]}
    (root / "ann.json").write_text(json.dumps(ann))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root


def _both(tmp_path, **data_kw):
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.data import dvc_dataset as jd
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jtok
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.data import dvc_dataset as td
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer as ttok

    root = _write_dataset(tmp_path)
    out = []
    for cfgmod, mod, tok in ((jc, jd, jtok), (tc, td, ttok)):
        cfg = cfgmod.DataConfig(features_dim=32, max_feats=50, **data_kw)
        ds = mod.DenseVideoCaptioningDataset(str(root / "ann.json"), str(root / "features"),
                                             tok("", num_bins=100), cfg,
                                             subtitles_path=str(root / "asr.pkl"))
        out.append((mod, cfg, ds))
    return out


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if key == "video_id":
            assert a[key] == b[key]
        else:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("length", [2, 17, 120, 1000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_corrupt_equal(length, seed):
    from vidchapters_tpu.data.span_corruption import span_corrupt as jax_span
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jtok
    from vidchapters_tpu_torch.data.span_corruption import span_corrupt
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer

    ids = np.random.default_rng(length).integers(3, 32000, size=length)
    ref = jax_span(ids, jtok("", 100), rng=np.random.default_rng(seed))
    got = span_corrupt(ids, build_tokenizer("", 100), rng=np.random.default_rng(seed))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("max_input,max_output", [(64, 32), (200, 48)])
def test_epoch_iterator_batches_equal(tmp_path, max_input, max_output):
    """Two epochs of one shuffled batch of 4 (two of the six videos
    dropped), with span corruption drawn from each epoch's generator."""
    (jmod, jcfg, jds), (tmod, tcfg, tds) = _both(
        tmp_path, max_input_tokens=max_input, max_output_tokens=max_output)
    jit = jmod.EpochIterator(jds, 4, jcfg, seed=7)
    tit = tmod.EpochIterator(tds, 4, tcfg, seed=7)
    assert len(tit) == len(jit) == 1
    for epoch in range(2):
        jit.set_epoch(epoch)
        tit.set_epoch(epoch)
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) == 1
        for a, b in zip(tb, jb):
            _assert_batches_equal(a, b)
            assert a["input_tokens"].shape == (4, max_input)
            assert a["denoising_input_tokens"].shape[1] == tmod.denoise_length_bounds(
                max_input)[0]


def test_collate_with_buckets_equal(tmp_path):
    (jmod, jcfg, jds), (tmod, tcfg, tds) = _both(tmp_path)
    examples = [(jds.__getitem__(i, rng=np.random.default_rng(i)),
                 tds.__getitem__(i, rng=np.random.default_rng(i))) for i in range(len(tds))]
    for buckets in (None, (16, 64, 128)):
        ref = jmod.collate([e[0] for e in examples], 1000, 256,
                           input_buckets=buckets, output_buckets=buckets)
        got = tmod.collate([e[1] for e in examples], 1000, 256,
                           input_buckets=buckets, output_buckets=buckets)
        _assert_batches_equal(got, ref)
    assert tmod.denoise_length_bounds(1000) == jmod.denoise_length_bounds(1000) == (804, 304)
    for n in (1, 64, 65, 999, 5000):
        assert tmod.pick_bucket(n, (64, 256), 1000) == jmod.pick_bucket(n, (64, 256), 1000)
