"""The port's VC task (chapter titles from ground-truth boundaries) against
the JAX package's, on the CPU in fp32 at a small width:

- ``VideoCaptioningDataset`` examples in both modes equal JAX's for the same
  generator, a video with no features giving one zero frame;
- ``tokenize_batch`` with and without buckets, and ``strip_time_tokens``;
- one ``make_vc_train_step`` update at T5 2+2 with dropout off: loss,
  gradient norm, every gradient and every parameter update against JAX's
  step under ``optax.chain(clip_by_global_norm(0.1), adam(lr))``;
- ``evaluate_vc``'s beam-4 titles equal JAX's, and ``eval_vc`` /
  ``eval_para`` scores equal JAX's on fixed texts;
- ``vc_main`` end to end on the CPU (``best``, ``last``, ``log.txt``), and
  its CLI's ``--eval --model-type random``, ``blip2`` (a synthetic HF
  directory) and ``llama`` (its loader's message);
- ``get_raw_video``'s black-frame fallback, ``raw_first_frames`` at train
  and eval, and the BLIP-2 / LLaMA evaluators with the same callables,
  against JAX's.
"""

import dataclasses
import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_helpers import port_model, small_cfgs

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops: the suite runs six
    workers on the machine's cores, where torch's thread pool spends these
    tests' time handing work between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_params(jcfg, seed: int = 0):
    """The JAX package's Vid2Seq and its init (jitted: eager Flax init takes
    ~10 s at this width) as numpy arrays."""
    from vidchapters_tpu.models.vid2seq import Vid2Seq as JVid2Seq

    model = JVid2Seq(jcfg)
    toks = jnp.ones((1, 8), jnp.int32)
    video = jnp.zeros((1, jcfg.vit.num_features, jcfg.vit.embed_dim))
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k}, video, toks, toks,
                                        toks)["params"])
    return model, jax.device_get(init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def models():
    """One JAX init (T5 2+2, gated-GELU: ReLU's kink flips at rounding
    distance from 0, ROADMAP.md §3) for the train-step and eval tests."""
    jcfg, tcfg = small_cfgs(feed_forward_proj="gated-gelu")
    jmodel, params = jax_params(jcfg, seed=1)
    return jmodel, params, tcfg


VIDS = ("vcvideo0001", "vcvideo0002", "vcvideo0003")


def _write_vc(root, d: int = 128, seed: int = 0, missing: bool = True):
    """Three videos of 2-3 chapters: features ``[T, d]`` at one frame a second
    (the third video has none when ``missing``), an ASR pickle, and
    train / val annotation jsons."""
    rng = np.random.default_rng(seed)
    (root / "feats").mkdir()
    ann, asr = {}, {}
    for i, vid in enumerate(VIDS):
        dur = 40.0 + 10 * i
        if i < 2 or not missing:
            np.save(root / "feats" / f"{vid}.npy", rng.normal(size=(int(dur), d)).astype(np.float32))
        cuts = [0.0, dur / 3, 2 * dur / 3, dur][: 3 + (i % 2)]
        ann[vid] = {"duration": dur, "timestamps": [[a, b] for a, b in zip(cuts, cuts[1:])],
                    "sentences": [f"Chapter {j} of video {i}!" for j in range(len(cuts) - 1)]}
        asr[vid] = {"text": ["hello there", "we cook", "the end now"],
                    "start": [1.0, 15.0, dur - 8.0], "end": [5.0, 22.0, dur - 1.0]}
    (root / "ann.json").write_text(json.dumps(ann))
    with open(root / "asr.pkl", "wb") as f:
        pickle.dump(asr, f)
    return root / "ann.json", root / "feats", root / "asr.pkl"


def _datasets(root, training, max_feats=16, d=128):
    from vidchapters_tpu.config import DataConfig as JData
    from vidchapters_tpu.data.vc_dataset import VideoCaptioningDataset as JDataset
    from vidchapters_tpu_torch.config import DataConfig
    from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset

    ann, feats, asr = root / "ann.json", root / "feats", root / "asr.pkl"
    kw = dict(max_feats=max_feats, features_dim=d, max_input_tokens=32, max_output_tokens=16)
    return (JDataset(str(ann), str(feats), training=training, cfg=JData(**kw),
                     subtitles_path=str(asr)),
            VideoCaptioningDataset(str(ann), str(feats), training=training,
                                   cfg=DataConfig(**kw), subtitles_path=str(asr)))


@pytest.mark.parametrize("training", [True, False])
def test_dataset_examples_equal_jax(tmp_path, training):
    from vidchapters_tpu.data.vc_dataset import vc_collate as jax_collate
    from vidchapters_tpu_torch.data.vc_dataset import vc_collate

    _write_vc(tmp_path)
    jds, ds = _datasets(tmp_path, training)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(ds)):
        for _ in range(3):  # three draws of the same generators
            ref, got = jds.__getitem__(i, rng=jrng), ds.__getitem__(i, rng=rng)
            assert got.keys() == ref.keys()
            np.testing.assert_array_equal(got["video"], ref["video"])
            for k in ("video_id", "input_text", "output_text"):
                assert got[k] == ref[k]
    if training:
        batch = [ds.__getitem__(i, rng=np.random.default_rng(1)) for i in range(3)]
        jbatch = [jds.__getitem__(i, rng=np.random.default_rng(1)) for i in range(3)]
        got, ref = vc_collate(batch), jax_collate(jbatch)
        np.testing.assert_array_equal(got["video"], ref["video"])
        assert got["input_text"] == ref["input_text"] and got["output_text"] == ref["output_text"]
    else:  # the video with no features: one zero frame, padded
        ex = ds[2]
        assert ex["video"].shape == (2, 16, 128) and not ex["video"].any()
        assert ex["input_text"] == ["Hello there.", ""]


def test_feature_source_strict(tmp_path):
    from vidchapters_tpu_torch.data.features import FeatureSource

    _write_vc(tmp_path, d=4)
    for src in (FeatureSource(str(tmp_path / "feats"), 8, 4),
                FeatureSource({"vcvideo0001": np.ones((3, 4))}, 8, 4)):
        with pytest.raises((KeyError, FileNotFoundError, OSError)):
            src.raw("vcvideo0003")
        np.testing.assert_array_equal(src.raw("vcvideo0003", strict=False), np.zeros((1, 4)))
    assert FeatureSource(str(tmp_path / "feats"), 8, 4).raw("vcvideo0001").shape == (40, 4)


def test_get_raw_video_zero_frame_fallback(tmp_path):
    """No ffmpeg, or a file that does not decode: one black frame, as JAX's."""
    from vidchapters_tpu.data.vc_dataset import get_raw_video as jax_get_raw_video
    from vidchapters_tpu_torch.data.vc_dataset import get_raw_video

    (tmp_path / "broken.mp4").write_bytes(b"not a video")
    for path in (str(tmp_path / "missing.mp4"), str(tmp_path / "broken.mp4"), None):
        for res in (224, 64):
            got = get_raw_video(path, res)
            assert got.shape == (1, res, res, 3) and got.dtype == np.uint8 and not got.any()
            np.testing.assert_array_equal(got, jax_get_raw_video(path, res))


def _fake_decode(path, resolution=224):
    """A stand-in for the 1-FPS decode: 25 frames whose pixels are their
    second plus the path's length (one black frame without a path)."""
    if path is None:
        return np.zeros((1, 8, 8, 3), np.uint8)
    return (np.arange(25, dtype=np.uint8)[:, None, None, None] + len(path)
            + np.zeros((1, 8, 8, 3), np.uint8))


@pytest.mark.parametrize("training", [True, False])
def test_raw_first_frames_equal_jax(tmp_path, monkeypatch, training):
    """``videos_path``: the first decoded frame of each clip (clamped to the
    video's last frame; a video without a path gives the black frame), at
    train and eval, and ``vc_collate``'s field, against JAX's."""
    from vidchapters_tpu.config import DataConfig as JData
    from vidchapters_tpu.data import vc_dataset as jax_vc
    from vidchapters_tpu_torch.config import DataConfig
    from vidchapters_tpu_torch.data import vc_dataset as port_vc

    monkeypatch.setattr(jax_vc, "get_raw_video", _fake_decode)
    monkeypatch.setattr(port_vc, "get_raw_video", _fake_decode)
    ann, feats, asr = _write_vc(tmp_path, d=8)
    videos = {VIDS[0]: "a.mp4", VIDS[2]: "video_c.mp4"}   # the second has no path
    (tmp_path / "videos.json").write_text(json.dumps(videos))
    kw = dict(max_feats=8, features_dim=8, max_input_tokens=32, max_output_tokens=16)
    jds = jax_vc.VideoCaptioningDataset(str(ann), str(feats), training=training,
                                        cfg=JData(**kw), subtitles_path=str(asr),
                                        videos_path=videos)
    ds = port_vc.VideoCaptioningDataset(str(ann), str(feats), training=training,
                                        cfg=DataConfig(**kw), subtitles_path=str(asr),
                                        videos_path=str(tmp_path / "videos.json"))
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    got = [ds.__getitem__(i, rng=rng) for i in range(3) for _ in range(2)]
    ref = [jds.__getitem__(i, rng=jrng) for i in range(3) for _ in range(2)]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() and "raw_first_frames" in g
        np.testing.assert_array_equal(g["raw_first_frames"], r["raw_first_frames"])
        assert g["output_text"] == r["output_text"]
    if not training:
        # video 3 (60 s, clips from 0 and 20 s) over frames of 11 + second
        assert [int(f[0, 0, 0]) for f in got[4]["raw_first_frames"]] == [11, 31]
    batch = got[0::2] if training else got[:1]
    jbatch = ref[0::2] if training else ref[:1]
    np.testing.assert_array_equal(port_vc.vc_collate(batch)["raw_first_frames"],
                                  jax_vc.vc_collate(jbatch)["raw_first_frames"])
    assert "raw_first_frames" not in _datasets(tmp_path, training, 8, 8)[1][0]


def _eval_dataset(root, videos=None):
    from vidchapters_tpu.config import DataConfig as JData
    from vidchapters_tpu.data.vc_dataset import VideoCaptioningDataset as JDataset
    from vidchapters_tpu_torch.config import DataConfig
    from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset

    ann, feats, asr = _write_vc(root, d=8)
    kw = dict(max_feats=8, features_dim=8, max_input_tokens=32, max_output_tokens=16)
    return (JDataset(str(ann), str(feats), training=False, cfg=JData(**kw),
                     subtitles_path=str(asr), videos_path=videos),
            VideoCaptioningDataset(str(ann), str(feats), training=False, cfg=DataConfig(**kw),
                                   subtitles_path=str(asr), videos_path=videos))


def test_evaluate_vc_blip2_equals_jax(tmp_path):
    """The BLIP-2 dispatch over every clip's first frame (the black frame
    here: no video decodes), with the same captioner: results and scores."""
    from vidchapters_tpu.train import vc_train as jax_vc
    from vidchapters_tpu_torch.train import vc_train as port_vc

    assert port_vc.VC_BLIP2_PROMPT == jax_vc.VC_BLIP2_PROMPT
    jds, ds = _eval_dataset(tmp_path, {v: str(tmp_path / "missing.mp4") for v in VIDS})
    calls = {"port": [], "jax": []}

    def captioner(key):
        def caption_fn(frames, prompt):
            calls[key].append((frames.shape, int(frames.sum()), prompt))
            return [f" chapter {i} of {len(frames)} " for i in range(len(frames))]
        return caption_fn

    got = port_vc.evaluate_vc_blip2(ds, captioner("port"))
    ref = jax_vc.evaluate_vc_blip2(jds, captioner("jax"))
    assert got == ref and len(got[0]) == 7 and got[0][0]["sentence"] == "chapter 0 of 2"
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ((2, 224, 224, 3), 0, port_vc.VC_BLIP2_PROMPT)


def test_evaluate_vc_llama_equals_jax(tmp_path):
    """The LLaMA dispatch over every clip's ASR prompt, with the same
    generate function: prompts, results and scores."""
    from vidchapters_tpu.train import vc_train as jax_vc
    from vidchapters_tpu_torch.train import vc_train as port_vc

    assert port_vc.VC_LLAMA_PROMPT == jax_vc.VC_LLAMA_PROMPT
    jds, ds = _eval_dataset(tmp_path)
    prompts = {"port": [], "jax": []}

    def generator(key):
        def generate_fn(prompt):
            prompts[key].append(prompt)
            return f" Title of {len(prompt)} characters "
        return generate_fn

    got = port_vc.evaluate_vc_llama(ds, generator("port"))
    ref = jax_vc.evaluate_vc_llama(jds, generator("jax"))
    assert got == ref and len(got[0]) == 7
    assert prompts["port"] == prompts["jax"]
    assert prompts["port"][0] == port_vc.VC_LLAMA_PROMPT.format("Hello there.")


def test_tokenize_batch_and_strip_time_tokens_equal_jax():
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jax_tokenizer
    from vidchapters_tpu.train.vc_train import strip_time_tokens as jax_strip
    from vidchapters_tpu.train.vc_train import tokenize_batch as jax_tokenize
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.train.vc_train import strip_time_tokens, tokenize_batch

    texts = ["a short title", "", "a much longer chapter title " * 6]
    for max_tokens, buckets in ((64, None), (256, (16, 32, 64, 128)), (8, (16,)), (40, (8,))):
        got = tokenize_batch(texts, build_tokenizer(""), max_tokens, buckets)
        ref = jax_tokenize(texts, jax_tokenizer(""), max_tokens, buckets)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert tokenize_batch(texts[:2], build_tokenizer(""), 256, (16, 32)).shape == (2, 16)

    # an untied lm_head: both tables lose their time-token rows
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    _, tcfg = small_cfgs()
    tcfg = dataclasses.replace(tcfg, t5=dataclasses.replace(tcfg.t5, tie_word_embeddings=False))
    sd = Vid2Seq(tcfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    got = strip_time_tokens(sd, 100)
    # the JAX package's tree holds the same tables, the head as [d, vocab]
    stripped = jax_strip({"t5": {"shared": {"embedding": sd["t5.shared.weight"].numpy()},
                                 "lm_head": {"kernel": sd["t5.lm_head.weight"].numpy().T}}},
                         100)
    assert got["t5.shared.weight"].shape == (32100, 128)
    np.testing.assert_array_equal(got["t5.shared.weight"].numpy(),
                                  stripped["t5"]["shared"]["embedding"])
    np.testing.assert_array_equal(got["t5.lm_head.weight"].numpy(),
                                  np.asarray(stripped["t5"]["lm_head"]["kernel"]).T)
    assert sd["t5.shared.weight"].shape == (32200, 128)  # the input is left as it was
    # the stripped dict loads into a VC model of the text-only vocab
    Vid2Seq(dataclasses.replace(tcfg, t5=dataclasses.replace(
        tcfg.t5, vocab_size=32100))).load_state_dict(got)


class _WordText:
    """The byte tokenizer's encoding, and a decoding that turns every id into
    a word (``w{id % 7}``), so that random weights give titles to score."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.eos_token_id = tokenizer.eos_token_id

    def encode(self, *a, **k):
        return self.tok.encode(*a, **k)

    def batch_decode(self, seqs, skip_special_tokens=True):
        return [" ".join(f"w{int(t) % 7}" for t in row if t > 1) for row in np.asarray(seqs)]


def test_vc_train_step_matches_jax(models):
    """One update at T5 2+2, dropout off, the clip active. Loss and
    gradient norm within rtol 2e-5, each gradient within 1e-4 of its largest
    element, each parameter's update within 2e-3 of its norm (the
    tolerances of tests/test_torch_train.py)."""
    import optax

    from vidchapters_tpu.train.dvc_train import TrainState as JState
    from vidchapters_tpu.train.vc_train import make_vc_train_step as jax_step
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.train.dvc_train import TrainState
    from vidchapters_tpu_torch.train.schedules import ClipAdamW
    from vidchapters_tpu_torch.train.vc_train import make_vc_train_step

    jmodel, params, tcfg = models
    model = port_model(tcfg, params).train()
    rng = np.random.default_rng(3)
    batch = {"video": rng.normal(size=(2, 16, 128)).astype(np.float32),
             "input_tokens": rng.integers(3, 32100, size=(2, 24)).astype(np.int64),
             "output_tokens": rng.integers(3, 32100, size=(2, 8)).astype(np.int64)}
    batch["input_tokens"][1, 15:] = 0
    batch["output_tokens"][0, 5:] = 0
    lr = 1e-3
    # a pass-through first link keeps the step's raw gradients in its state
    keep = optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, optax.clip_by_global_norm(0.1), optax.adam(lr))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jm = jax.jit(jax_step(jmodel, tx))(
        JState(params, tx.init(params), jnp.asarray(0)), jbatch, jax.random.PRNGKey(0))
    ref_grads = from_jax_params(jax.device_get(jstate.opt_state[0]), model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, ClipAdamW(model.parameters(), lambda count: lr, clip_max_norm=0.1))
    m = make_vc_train_step(model)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  seed=0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
    assert float(m["grad_norm"]) > 0.1 and state.step == 1  # the clip is active
    for name, p in model.named_parameters():
        r = ref_grads[name].numpy()
        err = np.abs(p.grad.numpy() - r).max() / max(np.abs(r).max(), 1e-6)
        assert err < 1e-4, f"{name}: gradient off by {err:.2e} of its largest element"
    ref = from_jax_params(jax.device_get(jstate.params), model)
    for name, p in model.state_dict().items():
        got, want = p - before[name], ref[name] - before[name]
        if float(want.norm()) == 0:  # a parameter with no gradient (time-token rows' bias)
            assert float(got.norm()) == 0, name
            continue
        err = float((got - want).norm() / want.norm())
        assert err < 2e-3, f"{name}: update differs by {err:.2e} of its norm"


def test_evaluate_vc_titles_equal_jax(tmp_path, models):
    """Beam 4 at max_length 6, two clips a generate call, with the JAX
    package's weights: every title and every metric equal."""
    from vidchapters_tpu.config import GenerationConfig as JGen
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jax_tokenizer
    from vidchapters_tpu.train.vc_train import evaluate_vc as jax_evaluate
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.train.vc_train import evaluate_vc

    _write_vc(tmp_path, missing=False)
    jds, ds = _datasets(tmp_path, training=False)
    jmodel, params, tcfg = models
    model = port_model(tcfg, params)
    kw = dict(num_beams=4, max_length=6, repetition_penalty=2.0)
    ref, ref_metrics = jax_evaluate(jmodel, params, jds, _WordText(jax_tokenizer("")),
                                    JGen(**kw), max_input_tokens=32, batch_clips=2)
    got, metrics = evaluate_vc(model, ds, _WordText(build_tokenizer("")),
                               GenerationConfig(**kw), max_input_tokens=32, batch_clips=2)
    assert len(got) == 7 and got == ref
    assert len({r["sentence"] for r in got.values()}) > 1
    assert metrics == ref_metrics


def test_eval_vc_and_eval_para_equal_jax():
    from vidchapters_tpu.evals.captioning import eval_vc as jax_eval_vc
    from vidchapters_tpu.evals.para import eval_para as jax_eval_para
    from vidchapters_tpu_torch.evals import eval_para, eval_vc

    results = {0: {"sentence": "how to cook the pasta", "gt": "cooking the pasta"},
               1: {"sentence": "intro", "gt": "introduction and welcome"},
               2: {"sentence": "final thoughts on the recipe", "gt": "final thoughts"},
               3: {"sentence": "cooking the pasta", "gt": "the sauce"}}
    got, ref = eval_vc(results), jax_eval_vc(results)
    assert got == ref and set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                                       "ROUGE_L", "CIDEr"}
    assert got["CIDEr"] > 0
    sub = {"results": {"v1": [{"sentence": "we cook pasta.", "timestamp": [5.0, 9.0]},
                              {"sentence": "Welcome!", "timestamp": [0.0, 5.0]}],
                       "v2": [{"sentence": "the end", "timestamp": [1.0, 2.0]}]}}
    refs = [{"v1": {"sentences": ["welcome to the show", "we cook pasta"]},
             "v2": "the end of it"}, {"v1": "welcome we cook"}]
    got, ref = eval_para(sub, refs), jax_eval_para(sub, refs)
    assert got == ref and got["Para_Bleu_1"] > 0


def _tiny_model_cfg():
    from vidchapters_tpu_torch import config as c

    t5 = c.T5Config(d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=1,
                    num_heads=4, relative_attention_num_buckets=8,
                    relative_attention_max_distance=16, dtype="float32")
    vit = c.TemporalViTConfig(num_features=8, embed_dim=8, depth=1, num_heads=2, mlp_dim=16,
                              dtype="float32")
    return (c.Vid2SeqConfig(t5=t5, vit=vit),
            c.DataConfig(max_feats=8, features_dim=8, max_input_tokens=16,
                         max_output_tokens=24, output_buckets=(8, 16)))


def test_vc_main_end_to_end_and_random_eval(tmp_path, capsys):
    from vidchapters_tpu_torch.config import GenerationConfig
    from vidchapters_tpu_torch.train import vc_main

    ann, feats, asr = _write_vc(tmp_path, d=8)
    mcfg, dcfg = _tiny_model_cfg()
    save = tmp_path / "ckpt"
    metrics = vc_main.main(str(ann), str(ann), str(feats), mcfg, dcfg, str(save),
                           subtitles_path=str(asr), n_epochs=1, batch_size=2, lr=1e-3,
                           generation=GenerationConfig(num_beams=2, max_length=6),
                           device="cpu")
    assert {"CIDEr", "METEOR", "Bleu_4", "ROUGE_L"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    log = [json.loads(line) for line in (save / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [0] and np.isfinite(log[0]["loss"])
    for name in ("best", "last"):
        assert (save / name).exists()
    payload = torch.load(save / "last", weights_only=True)
    assert payload["step"] == 1 and payload["optimizer"]["count"] == 1  # 3 videos: one step

    from vidchapters_tpu_torch.config import save_config

    save_config(dcfg, str(tmp_path / "data.json"))
    capsys.readouterr()
    args = ["--val-json", str(ann), "--features-path", str(feats), "--save-dir", str(save),
            "--subtitles-path", str(asr), "--data-config", str(tmp_path / "data.json"),
            "--eval", "--model-type", "random"]
    vc_main._cli(args)
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) >= {"CIDEr", "Bleu_1"} and all(np.isfinite(v) for v in scores.values())
    # --model-type blip2 from a synthetic HF directory (bfloat16 on the CPU);
    # every clip's first frame is the black frame (no video decodes here)
    from tests._torch_helpers import blip2_small_cfgs, write_blip2_dir

    _, bcfg = blip2_small_cfgs(vocab=32128)
    bcfg = dataclasses.replace(bcfg, vision=dataclasses.replace(bcfg.vision, image_size=224,
                                                                patch_size=112))
    blip2_dir = write_blip2_dir(tmp_path / "blip2", bcfg, seed=2)
    (tmp_path / "videos.json").write_text(json.dumps({v: "missing.mp4" for v in VIDS}))
    vc_main._cli(args[:-1] + ["blip2", "--blip2-dir", str(blip2_dir), "--videos-path",
                              str(tmp_path / "videos.json"), "--device", "cpu"])
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) >= {"CIDEr", "Bleu_1"} and all(np.isfinite(v) for v in scores.values())
    llama_dir = str(tmp_path / "llama")
    message = (f"build_llama_titler({llama_dir!r}) needs an encoder for LLaMA's tokenizer.model, "
               "a SentencePiece BPE model, which the port does not have yet (ROADMAP.md §1, "
               "\"SentencePiece BPE encoder for LLaMA's tokenizer.model\"); "
               "make_llama_generate_fn takes a LlamaForCausalLM and any tokenizer with "
               "encode / decode")
    with pytest.raises(NotImplementedError) as err:
        vc_main._cli(args[:-1] + ["llama", "--llama-dir", llama_dir, "--device", "cpu"])
    assert str(err.value) == message
