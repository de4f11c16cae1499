"""The port's two demos against the JAX package's, on the CPU:

- ``demo/demo_vid2seq.main`` driven through its argparse CLI: the oracle
  round trip of ``tests/test_demo_cli.py`` (the ASR arrives as quantized
  time+text tokens, the emitted ids decode into chapters), with the video
  and input tokens equal to those the JAX demo hands its generate function;
  a tiny reference ``.pth`` (``--ckpt_path``) at beam 2 whose generated ids
  and chapters equal the JAX demo's; and the raw-video branch
  (``--video_path`` + ``--clip_ckpt``, an OpenAI-named state dict of a small
  image tower standing in for ViT-L/14, the decode injected) whose features
  equal the JAX extractor's within 1e-5 and whose chapters equal the
  ``--features_path`` run's on those features;
- ``demo/run_on_video.MomentDETRPredictor``: the run.py schema, windows
  ranked by score, window bounds within 1e-5 of the video's duration and
  scores and saliency within 1e-5 of the JAX predictor's with the same
  weights (fp32), from features and from frames through the image tower.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vidchapters_tpu.config import (
    DataConfig,
    ExperimentConfig,
    GenerationConfig,
    T5Config,
    TemporalViTConfig,
    Vid2SeqConfig,
    save_config,
)
from vidchapters_tpu.utils.io import save_pickle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_config(tmp_path) -> str:
    """The CPU-sized Vid2Seq of tests/test_demo_cli.py, as an experiment
    json for --config."""
    t5 = T5Config(vocab_size=32200, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                  num_decoder_layers=1, num_heads=4, relative_attention_num_buckets=8,
                  relative_attention_max_distance=16, dtype="float32", dropout_rate=0.0,
                  encoder_dropout=0.0, decoder_dropout=0.0)
    vit = TemporalViTConfig(num_features=8, embed_dim=8, depth=1, num_heads=2, mlp_dim=16,
                            dtype="float32")
    cfg = ExperimentConfig(
        model=Vid2SeqConfig(t5=t5, vit=vit, num_bins=100),
        data=DataConfig(max_feats=8, features_dim=8, max_input_tokens=32,
                        max_output_tokens=24),
        generation=GenerationConfig(num_beams=1, max_length=16))
    path = tmp_path / "exp.json"
    save_config(cfg, str(path))
    return str(path)


def _inputs(tmp_path, n_frames=50, dim=8):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n_frames, dim)).astype(np.float32)
    np.save(tmp_path / "feats.npy", feats)
    # the ASR in whisperx form: the demo runs proc_asr on it
    save_pickle({"segments": [{"text": " today we bake bread", "start": 2.0, "end": 8.0},
                              {"text": "and eat it", "start": 30.0, "end": 61.0}],
                 "language": "en"}, str(tmp_path / "asr.pkl"))
    return str(tmp_path / "feats.npy"), str(tmp_path / "asr.pkl")


COMMON = ["--max_feats", "8", "--max_input_tokens", "32", "--max_output_tokens", "16"]


def test_demo_vid2seq_oracle_roundtrip_matches_jax(tmp_path, monkeypatch):
    from vidchapters_tpu.data.tokenizer import build_tokenizer
    from vidchapters_tpu.demo import demo_vid2seq as jdemo
    from vidchapters_tpu_torch.demo import demo_vid2seq as tdemo

    cfg_path = _tiny_config(tmp_path)
    feat_path, asr_path = _inputs(tmp_path)
    duration = 50.0
    tok = build_tokenizer("", num_bins=100)
    oracle = np.array([[tok.time_token_id(10), tok.time_token_id(20),
                        *tok.encode("hello world", add_special_tokens=False),
                        tok.eos_token_id]], np.int32)
    seen = {}

    def jax_fake(model, gen_cfg):
        def generate(params, video, input_tokens, rng):
            seen["jax"] = (np.asarray(video), np.asarray(input_tokens))
            return jnp.asarray(oracle)
        return generate

    def port_fake(model, gen_cfg):
        assert gen_cfg.num_beams == 1 and gen_cfg.max_length == 16
        def generate(video, input_tokens, generator=None):
            seen["port"] = (video.numpy(), input_tokens.numpy())
            return torch.from_numpy(oracle)
        return generate

    monkeypatch.setattr("vidchapters_tpu.train.dvc_train.make_generate_fn", jax_fake)
    monkeypatch.setattr("vidchapters_tpu_torch.train.dvc_train.make_generate_fn", port_fake)
    args = ["--config", cfg_path, "--features_path", feat_path, "--asr_path", asr_path,
            "--num_beams", "1", *COMMON]
    ref = jdemo.main(args)
    out_path = tmp_path / "chapters.json"
    got = tdemo.main(args + ["--out_path", str(out_path), "--device", "cpu"])
    assert got == ref and json.loads(out_path.read_text()) == got
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    # [t_start, t_end, text...] with int((num_bins-1)*t/duration); the second
    # segment ends past the duration and is filtered out
    num_text = len(tok) - 100
    assert seen["port"][1].shape == (1, 32) and seen["port"][0].shape == (1, 8, 8)
    assert seen["port"][1][0, 0] == int(99 * 2.0 / duration) + num_text
    assert seen["port"][1][0, 1] == int(99 * 8.0 / duration) + num_text
    assert len(got) == 1 and got[0]["sentence"] == "hello world"
    assert got[0]["timestamp"] == pytest.approx([10 * duration / 99, 20 * duration / 99])


def _capture_generate(monkeypatch, target: str, store: list, to_numpy):
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    real = getattr(mod, attr)

    def wrapped(model, gen_cfg):
        gen = real(model, gen_cfg)

        def generate(*a, **k):
            out = gen(*a, **k)
            store.append(to_numpy(out))
            return out
        return generate

    monkeypatch.setattr(mod, attr, wrapped)


def test_demo_vid2seq_tiny_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A tiny released-layout .pth through --ckpt_path, beam 2: the port's
    generated ids and chapters equal the JAX demo's."""
    from tests.test_checkpoint_import_fullscale import _synth_reference_state_dict
    from vidchapters_tpu.demo import demo_vid2seq as jdemo
    from vidchapters_tpu_torch.demo import demo_vid2seq as tdemo

    cfg_path = _tiny_config(tmp_path)
    feat_path, asr_path = _inputs(tmp_path)
    rng = np.random.default_rng(1)
    sd = _synth_reference_state_dict(rng, vocab=32200, d=32, heads=4, dkv=8, dff=64,
                                     layers=1, rel_buckets=8, vit_mlp=16, vit_depth=1,
                                     vit_d=8, vit_feats=8)
    sd["proj_v2t.weight"] = rng.normal(scale=0.02, size=(32, 8)).astype(np.float32)
    sd["proj_v2t.bias"] = np.zeros(32, np.float32)
    ckpt = tmp_path / "released.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, str(ckpt))
    ids = {"jax": [], "port": []}
    _capture_generate(monkeypatch, "vidchapters_tpu.train.dvc_train.make_generate_fn",
                      ids["jax"], np.asarray)
    _capture_generate(monkeypatch, "vidchapters_tpu_torch.train.dvc_train.make_generate_fn",
                      ids["port"], lambda t: t.numpy())
    args = ["--config", cfg_path, "--features_path", feat_path, "--asr_path", asr_path,
            "--ckpt_path", str(ckpt), "--num_beams", "2", *COMMON]
    ref = jdemo.main(args)
    got = tdemo.main(args + ["--device", "cpu"])
    np.testing.assert_array_equal(ids["port"][0], ids["jax"][0])
    assert got == ref
    for ch in got:
        assert 0.0 <= ch["timestamp"][0] <= ch["timestamp"][1] <= 50.0


def _openai_tower_sd(rng):
    from test_torch_clip_vision import openai_clip_visual_sd

    return openai_clip_visual_sd(rng, width=64, layers=2, patch=32, size=224, out=8)


VISION = dict(image_size=224, patch_size=32, width=64, layers=2, heads=2, output_dim=8,
              dtype="float32")


def test_demo_vid2seq_video_path_matches_features_path(tmp_path, monkeypatch):
    """--video_path + --clip_ckpt: the frames go through the image tower of
    the checkpoint (a small one stands in for ViT-L/14); the features equal
    the JAX extractor's on the same weights, and the chapters equal those
    of a --features_path run on them."""
    from vidchapters_tpu.factory import features as jf
    from vidchapters_tpu.models import clip as jclip
    from vidchapters_tpu_torch.factory import features as tf
    from vidchapters_tpu_torch.models import clip as tclip
    from vidchapters_tpu_torch.demo import demo_vid2seq as tdemo

    cfg_path = _tiny_config(tmp_path)
    _, asr_path = _inputs(tmp_path)
    rng = np.random.default_rng(2)
    sd = _openai_tower_sd(rng)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "clip.pt"))
    frames = rng.integers(0, 256, (12, 90, 160, 3), dtype=np.uint8)
    monkeypatch.setattr(tf, "decode_video_1fps", lambda path: frames)
    monkeypatch.setattr(tclip, "VIT_L14", tclip.CLIPVisionConfig(**VISION))
    captured = []
    real_extract = tdemo.clip_features

    def spy(*a):
        captured.append(real_extract(*a))
        return captured[-1]

    monkeypatch.setattr(tdemo, "clip_features", spy)
    args = ["--config", cfg_path, "--asr_path", asr_path, *COMMON, "--device", "cpu"]
    got = tdemo.main(args + ["--video_path", "v.mp4", "--clip_ckpt", str(tmp_path / "clip.pt")])
    jenc = jclip.CLIPImageEncoder(jclip.CLIPVisionConfig(**VISION))
    ref = jf.CLIPFeatureExtractor(jenc, jclip.convert_openai_clip_visual(sd))(frames)
    assert captured[0].shape == (12, 8)
    np.testing.assert_allclose(captured[0], ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    np.save(tmp_path / "video_feats.npy", captured[0])
    assert got == tdemo.main(args + ["--features_path", str(tmp_path / "video_feats.npy")])


def _predictors(extractors=(None, None)):
    """The JAX predictor of tests/test_demo_cli.py and the port's with the
    same weights (JAX's random init imported)."""
    from vidchapters_tpu.config import GroundingConfig as JG
    from vidchapters_tpu.data.clip_tokenizer import CLIPTokenizer as JTok
    from vidchapters_tpu.demo.run_on_video import MomentDETRPredictor as JPred
    from vidchapters_tpu.models import clip as jclip
    from vidchapters_tpu.models.grounding import MomentDETR as JModel
    from vidchapters_tpu_torch.config import GroundingConfig as TG
    from vidchapters_tpu_torch.data.clip_tokenizer import CLIPTokenizer as TTok
    from vidchapters_tpu_torch.demo.run_on_video import MomentDETRPredictor as TPred
    from vidchapters_tpu_torch.models import clip as tclip
    from vidchapters_tpu_torch.models.grounding import MomentDETR as TModel
    from vidchapters_tpu_torch.models.weights import (
        clip_text_from_jax_params,
        grounding_from_jax_params,
    )

    text_kw = dict(vocab_size=49408, context_length=77, width=16, layers=1, heads=2,
                   output_dim=12, mlp_dim=32, dtype="float32")
    jtext = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**text_kw))
    toks = jnp.asarray(JTok()(["init"]))
    text_params = jtext.init(jax.random.PRNGKey(0), toks)["params"]
    gkw = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
               num_queries=5, v_feat_dim=10, t_feat_dim=12, dropout=0.0, input_dropout=0.0,
               max_v_l=30, clip_length=2)
    jmodel = JModel(JG(**gkw))
    src = jtext.apply({"params": text_params}, toks, return_tokens=True)
    params = jmodel.init(jax.random.PRNGKey(1), src, jnp.ones(src.shape[:2], jnp.int32),
                         jnp.zeros((1, 30, 10), jnp.float32),
                         jnp.ones((1, 30), jnp.int32))["params"]
    jpred = JPred(jmodel, params, jtext, text_params, JTok(), feature_extractor=extractors[0],
                  clip_len=2.0, max_v_l=30, v_feat_dim=10)
    ttext = tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**text_kw))
    ttext.load_state_dict(clip_text_from_jax_params(jax.device_get(text_params), ttext))
    tmodel = TModel(TG(**gkw))
    tmodel.load_state_dict(grounding_from_jax_params(jax.device_get(params), tmodel))
    tpred = TPred(tmodel.eval(), ttext.eval(), TTok(), feature_extractor=extractors[1],
                  clip_len=2.0, max_v_l=30, v_feat_dim=10)
    return jpred, tpred


QUERIES = ["baking the bread", "kneading the dough", "the oven"]


def _same_predictions(got, ref, duration: float):
    """Window bounds (seconds) within 1e-5 of the video's duration, scores
    and saliency within 1e-5: fp32 rounding apart."""
    assert len(got) == len(ref) == len(QUERIES)
    for g, r, q in zip(got, ref, QUERIES):
        assert set(g) == {"query", "vid", "pred_relevant_windows", "pred_saliency_scores"}
        assert g["query"] == r["query"] == q and g["vid"] == r["vid"]
        scores = [w[2] for w in g["pred_relevant_windows"]]
        assert scores == sorted(scores, reverse=True)  # confidence-ranked
        gw, rw = np.asarray(g["pred_relevant_windows"]), np.asarray(r["pred_relevant_windows"])
        np.testing.assert_allclose(gw[:, :2], rw[:, :2], atol=1e-5 * duration, rtol=0)
        np.testing.assert_allclose(gw[:, 2], rw[:, 2], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["pred_saliency_scores"], r["pred_saliency_scores"],
                                   atol=1e-5, rtol=0)


def test_run_on_video_predictor_matches_jax():
    jpred, tpred = _predictors()
    feats = np.random.default_rng(3).normal(size=(40, 8)).astype(np.float32)  # cut to 30
    ref = jpred.localize_moment(None, QUERIES, video_features=feats)
    got = tpred.localize_moment(None, QUERIES, video_features=feats)
    _same_predictions(got, ref, duration=60.0)
    for row in got:
        assert len(row["pred_saliency_scores"]) == 30
        for st, ed, _ in row["pred_relevant_windows"]:
            assert 0.0 <= st <= 60.0 and 0.0 <= ed <= 60.0


def test_run_on_video_from_frames_matches_jax(monkeypatch):
    """The raw-video branch: 1-FPS frames strided by clip_len through the
    image tower (decode injected), equal to the JAX predictor's."""
    from vidchapters_tpu.factory import features as jf
    from vidchapters_tpu.models import clip as jclip
    from vidchapters_tpu_torch.factory import features as tf
    from vidchapters_tpu_torch.models import clip as tclip

    rng = np.random.default_rng(4)
    sd = _openai_tower_sd(rng)
    jenc = jclip.CLIPImageEncoder(jclip.CLIPVisionConfig(**VISION))
    tenc = tclip.CLIPImageEncoder(tclip.CLIPVisionConfig(**VISION))
    tenc.load_state_dict(tclip.convert_openai_clip_visual(sd))
    jext = jf.CLIPFeatureExtractor(jenc, jclip.convert_openai_clip_visual(sd), batch_size=4)
    text = tf.CLIPFeatureExtractor(tenc, "cpu", batch_size=4)
    frames = rng.integers(0, 256, (13, 90, 160, 3), dtype=np.uint8)
    monkeypatch.setattr(jf, "decode_video_1fps", lambda path: frames)
    monkeypatch.setattr(tf, "decode_video_1fps", lambda path: frames)
    jpred, tpred = _predictors((jext, text))
    ref = jpred.localize_moment("v.mp4", QUERIES)
    got = tpred.localize_moment("v.mp4", QUERIES)
    _same_predictions(got, ref, duration=14.0)
    assert text.batches == 2 and len(got[0]["pred_saliency_scores"]) == 7
