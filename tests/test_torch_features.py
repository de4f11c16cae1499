"""The port's frame-feature factory against the JAX package's, on the CPU
with seeded numpy frames and a small CLIP image tower (patch 32, width 64,
2 layers, fp32):

- ``preprocess_frames`` equal bit for bit; ``preprocess_frames_torch`` (the
  on-card route's arithmetic, here on CPU tensors) within 1e-5 of it;
- ``CLIPFeatureExtractor`` over a video whose last batch is partial,
  within 1e-5 of the JAX extractor's largest feature, from uint8 frames
  and from preprocessed ones; the tower on ``preprocess_frames_torch``'s
  pixels within 1e-5 of the tower on numpy's;
- ``extract_features_sharded`` writes the JAX package's files (within 1e-5),
  is idempotent, and runs in its synchronous mode; ``decode_video_1fps``
  raises without ffmpeg.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.factory import features as jf
from vidchapters_tpu.models import clip as jclip
from vidchapters_tpu_torch.factory import features as tf
from vidchapters_tpu_torch.models import clip as tclip
from vidchapters_tpu_torch.models.weights import clip_vision_from_jax_params

KW = dict(image_size=224, patch_size=32, width=64, layers=2, heads=2, output_dim=32,
          dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    """The JAX tower and its params, and the port's tower holding them."""
    jenc = jclip.CLIPImageEncoder(jclip.CLIPVisionConfig(**KW))
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
                            ["params"])
    enc = tclip.CLIPImageEncoder(tclip.CLIPVisionConfig(**KW))
    enc.load_state_dict(clip_vision_from_jax_params(params, enc))
    return jenc, params, enc


def _frames(rng, t, h=120, w=200):
    return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(3, 360, 640), (2, 301, 199), (1, 224, 224), (2, 100, 480)])
def test_preprocess_frames_matches_jax(shape):
    frames = _frames(np.random.default_rng(0), *shape)
    ref = jf.preprocess_frames(frames)
    np.testing.assert_array_equal(tf.preprocess_frames(frames), ref)
    got = tf.preprocess_frames_torch(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_extractor_matches_jax_with_a_partial_batch(towers):
    jenc, params, enc = towers
    frames = _frames(np.random.default_rng(1), 5)
    ref = jf.CLIPFeatureExtractor(jenc, params, batch_size=2)(frames)
    ext = tf.CLIPFeatureExtractor(enc, "cpu", batch_size=2)
    got = ext(frames)
    assert ext.batches == 3 and got.dtype == np.float32 and got.shape == ref.shape == (5, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # preprocessed float frames are taken as they are
    pre = jf.preprocess_frames(frames)
    np.testing.assert_allclose(ext(pre), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_tower_on_torch_preprocessing_matches_numpys(towers):
    """What the card computes from uint8 frames (the torch preprocessing,
    then the tower), here on CPU tensors."""
    enc = towers[2]
    frames = _frames(np.random.default_rng(5), 3)
    with torch.no_grad():
        ref = enc(torch.from_numpy(tf.preprocess_frames(frames))).numpy()
        got = enc(tf.preprocess_frames_torch(torch.from_numpy(frames))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_extractor_raises_without_cuda_unless_asked(towers):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.CLIPFeatureExtractor(towers[2])
    with pytest.raises(ValueError, match="no frames"):
        tf.CLIPFeatureExtractor(towers[2], "cpu")(np.zeros((0, 8, 8, 3), np.uint8))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_extract_features_sharded_matches_jax_and_is_idempotent(towers, tmp_path, prefetch):
    jenc, params, enc = towers
    rng = np.random.default_rng(2)
    videos = {f"vid{i}.mp4": _frames(rng, t) for i, t in enumerate((3, 1, 4))}
    decoded = []

    def decode(path):
        decoded.append(path)
        return videos[path]

    ext = tf.CLIPFeatureExtractor(enc, "cpu", batch_size=2)
    n = tf.extract_features_sharded(list(videos), str(tmp_path / "port"), ext, decode,
                                    seed=3, prefetch=prefetch)
    assert n == 3 and sorted(decoded) == sorted(videos)
    assert tf.extract_features_sharded(list(videos), str(tmp_path / "port"), ext, decode,
                                       seed=3, prefetch=prefetch) == 0
    assert len(decoded) == 3  # nothing decoded again
    jf.extract_features_sharded(list(videos), str(tmp_path / "jax"),
                                jf.CLIPFeatureExtractor(jenc, params, batch_size=2),
                                lambda p: videos[p], seed=3, prefetch=prefetch)
    for name in videos:
        stem = name.split(".")[0]
        ref = np.load(tmp_path / "jax" / f"{stem}.npy")
        got = np.load(tmp_path / "port" / f"{stem}.npy")
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_decode_raises_without_ffmpeg(monkeypatch):
    monkeypatch.setattr(tf.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg not available"):
        tf.decode_video_1fps("missing.mp4")
