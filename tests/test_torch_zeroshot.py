"""The port's zero-shot baselines (``vidchapters_tpu_torch/zeroshot``)
against the JAX package's, on the CPU:

- TextTiling segments, ``speech_chapters`` predictions (first-sentence,
  seeded random and LLM titlers) and the LLM prompt identical;
- shot boundaries, shots and visual chapters identical; ``ffprobe`` absent
  raises in both;
- grounding spans (clip, bert, random with one seed) and
  ``evaluate_predictions`` identical;
- ``run_speech_vcg``, ``run_visual_vcg``, ``run_visual_vcg_raw`` (no
  ffprobe: one shot, zero frames) and ``run_vcgr`` (random / clip / bert)
  give JAX's predictions and metrics on ``tests/test_zeroshot_run.py``'s
  fixture; the ``main`` CLI's ``speech`` and ``vcgr`` outputs equal JAX's,
  and its ``visual`` subcommand on a synthetic BLIP-2 directory
  (``--device cpu``) equals JAX's runner with JAX's captioner over the same
  weights; the ``--paths`` default reaches ``build_llama_titler``.
"""

import json
import pickle
import shutil

import numpy as np
import pytest


def _topic_text():
    part1 = "the cat sat on the mat . cats like milk and fish . " * 8
    part2 = "rockets burn fuel in space . orbital mechanics govern satellites . " * 8
    return part1.replace(" . ", " .\n") + part2.replace(" . ", " .\n")


def _random_text(seed=0, lines=60):
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(40)] + ["the", "and", "of", "a", "to"]
    return "\n".join(" ".join(rng.choice(vocab, rng.integers(3, 12)))
                     for _ in range(lines))


@pytest.mark.parametrize("text,kw", [
    (_topic_text(), dict(w=8, k=4)), (_topic_text(), dict(w=8, k=4, cutoff_policy="LC")),
    ("too short", {}), (_random_text(), dict(w=10, k=3, smoothing_rounds=2)),
    (_random_text(1, 200), {})])
def test_texttiling_matches_jax(text, kw):
    from vidchapters_tpu.zeroshot.texttiling import TextTilingTokenizer as J
    from vidchapters_tpu_torch.zeroshot.texttiling import TextTilingTokenizer

    got = TextTilingTokenizer(**kw).tokenize(text)
    assert got == J(**kw).tokenize(text)
    assert "".join(got).split() == text.split()


def _subs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    topics = (["cook", "pasta", "boil", "salt"], ["race", "car", "engine", "track"],
              ["paint", "brush", "canvas", "color"])
    text = [" ".join(rng.choice(topics[(i * 3) // n], 6)) for i in range(n)]
    return {"text": text, "start": [5.0 * i for i in range(n)],
            "end": [5.0 * i + 4.0 for i in range(n)]}


@pytest.mark.parametrize("titler", ["first", "random", "llm"])
def test_speech_chapters_match_jax(titler):
    from vidchapters_tpu.zeroshot import speech_vcg as J
    from vidchapters_tpu.zeroshot.texttiling import TextTilingTokenizer as JT
    from vidchapters_tpu_torch.zeroshot import speech_vcg as T
    from vidchapters_tpu_torch.zeroshot.texttiling import TextTilingTokenizer

    assert T.LLM_PROMPT == J.LLM_PROMPT
    prompts = {"port": [], "jax": []}

    def make(mod, key):
        if titler == "first":
            return mod.first_sentence_titler
        if titler == "random":
            return mod.make_random_titler(np.random.default_rng(3))
        return mod.make_llm_titler(lambda p: prompts[key].append(p) or f" Title {len(p)}\nmore")

    sub = _subs()
    got = T.speech_chapters(sub, 190.0, make(T, "port"), TextTilingTokenizer(w=6, k=3))
    ref = J.speech_chapters(sub, 190.0, make(J, "jax"), JT(w=6, k=3))
    assert got == ref and len(got) >= 2
    assert prompts["port"] == prompts["jax"]
    assert T.speech_chapters({"text": []}, 10.0) == []


def test_shots_and_visual_chapters_match_jax():
    from vidchapters_tpu.zeroshot import visual_vcg as J
    from vidchapters_tpu_torch.zeroshot import visual_vcg as T

    assert T.BLIP2_PROMPT == J.BLIP2_PROMPT
    rng = np.random.default_rng(4)
    blocks = [np.tile(rng.normal(size=(1, 16)), (n, 1)) + 0.05 * rng.normal(size=(n, 16))
              for n in (7, 2, 11, 5, 9)]
    feats = np.concatenate(blocks).astype(np.float32)
    times = [min(float(i), 30.0) for i in range(len(feats))]
    for thr, min_len in ((0.3, 3), (0.1, 1), (0.9, 3)):
        got = T.feature_shot_detection(feats, times, thr, min_len)
        assert got == J.feature_shot_detection(feats, times, thr, min_len)
    bounds = T.feature_shot_detection(feats, times)
    for dur in (34.0, 20.0):
        shots = T.shots_from_boundaries(bounds + [0.0, dur + 1], dur)
        assert shots == J.shots_from_boundaries(bounds + [0.0, dur + 1], dur)
        cap = lambda t: "" if t > 25 else f"shot at {t:.1f}"  # noqa: E731
        assert T.visual_chapters(shots, cap) == J.visual_chapters(shots, cap)
    frame = np.zeros((224, 224, 3), np.uint8)
    fn = lambda frames, prompt: [f" {prompt[:9]} {frames.shape} "]  # noqa: E731
    assert (T.make_blip2_captioner(fn, lambda s: frame)(3.5)
            == J.make_blip2_captioner(fn, lambda s: frame)(3.5))


def test_ffprobe_shot_detection_raises_without_ffprobe(monkeypatch):
    from vidchapters_tpu.zeroshot import visual_vcg as J
    from vidchapters_tpu_torch.zeroshot import visual_vcg as T

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (T, J):
        with pytest.raises(RuntimeError, match="ffprobe not available"):
            mod.ffprobe_shot_detection("video.mp4")


def test_grounding_spans_and_metrics_match_jax():
    from vidchapters_tpu.zeroshot import grounding as J
    from vidchapters_tpu_torch.zeroshot import grounding as T

    rng = np.random.default_rng(5)
    frames = rng.normal(size=(30, 16)).astype(np.float32)
    text = frames[[3, 17, 25]] + 0.2 * rng.normal(size=(3, 16)).astype(np.float32)
    times = [float(i) for i in range(30)]
    for thr in (0.05, 0.3):
        got = T.clip_grounding_spans(text, frames, times, 31.0, thr)
        assert got == J.clip_grounding_spans(text, frames, times, 31.0, thr)
    asr = rng.normal(size=(6, 16)).astype(np.float32)
    starts, ends = [0.0, 4, 9, 15, 20, 26], [4.0, 9, 15, 20, 26, 30]
    assert (T.bert_grounding_spans(text, asr, starts, ends)
            == J.bert_grounding_spans(text, asr, starts, ends))
    for args in ((3, 40.0, starts, ends), (3, 40.0), (2, 0.5)):
        got = T.random_grounding_spans(*args, rng=np.random.default_rng(6))
        assert got == J.random_grounding_spans(*args, rng=np.random.default_rng(6))
    results = {"a": {"pred": [[0, 10], [5, 9]], "gt": [[1, 10], [20, 30]]},
               "b": {"pred": [[3, 4]], "gt": [[3.5, 4.5]]}}
    assert T.evaluate_predictions(results) == J.evaluate_predictions(results)
    assert T.iou([0, 2], [1, 3]) == J.iou([0, 2], [1, 3])


@pytest.fixture
def data(tmp_path):
    """``tests/test_zeroshot_run.py``'s fixture, with a second video whose
    features are missing and ASR pickle entry absent."""
    rng = np.random.default_rng(0)
    ann = {"ddddddddd01": {"duration": 80.0, "timestamps": [[0.0, 40.0], [40.0, 80.0]],
                           "sentences": ["cooking the meal", "eating the meal"]},
           "eeeeeeeee02": {"duration": 30.0, "timestamps": [[0.0, 30.0]],
                           "sentences": ["a talk"]}}
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))
    subs = {"ddddddddd01": {
        "text": [f"talking about cooking food {i}" for i in range(4)]
        + [f"talking about eating dinner {i}" for i in range(4)],
        "start": [10.0 * i for i in range(8)], "end": [10.0 * i + 8 for i in range(8)]}}
    subs_path = tmp_path / "subs.pkl"
    subs_path.write_bytes(pickle.dumps(subs))
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    feats = np.concatenate([np.tile(rng.normal(size=(1, 8)), (40, 1)),
                            np.tile(rng.normal(size=(1, 8)), (40, 1))]).astype(np.float32)
    np.save(feat_dir / "ddddddddd01", feats)
    np.save(feat_dir / "eeeeeeeee02", rng.normal(size=(30, 8)).astype(np.float32))
    return str(ann_path), str(subs_path), str(feat_dir), feats


def _same(got, ref):
    assert json.dumps(got[0], sort_keys=True) == json.dumps(ref[0], sort_keys=True)
    assert got[1] == ref[1]


def test_run_speech_and_visual_vcg_match_jax(data):
    from vidchapters_tpu.zeroshot import run as J
    from vidchapters_tpu_torch.zeroshot import run as T

    ann, subs, feat_dir, _ = data
    _same(T.run_speech_vcg(ann, subs), J.run_speech_vcg(ann, subs))
    cap = lambda vid, t: f"scene of {vid[:3]} at {int(t)} seconds"  # noqa: E731
    got = T.run_visual_vcg(ann, feat_dir, captioner=cap)
    _same(got, J.run_visual_vcg(ann, feat_dir, captioner=cap))
    assert len(got[0]["ddddddddd01"]) == 2 and "soda_c" in got[1]


def test_run_visual_vcg_raw_matches_jax(tmp_path, data):
    """No ffprobe / video: one whole-video shot and the zero frame."""
    from vidchapters_tpu.zeroshot import run as J
    from vidchapters_tpu_torch.zeroshot import run as T
    from vidchapters_tpu_torch.zeroshot.visual_vcg import BLIP2_PROMPT

    ann = data[0]
    seen = []

    def caption_fn(frames, prompt):
        seen.append((frames.shape, int(frames.sum()), prompt))
        return [" Generated title "] * frames.shape[0]

    videos = {"ddddddddd01": str(tmp_path / "missing.mp4"),
              "eeeeeeeee02": str(tmp_path / "missing2.mp4")}
    got = T.run_visual_vcg_raw(ann, videos, caption_fn)
    port_seen, seen[:] = list(seen), []
    _same(got, J.run_visual_vcg_raw(ann, videos, caption_fn))
    assert port_seen == seen == [((1, 224, 224, 3), 0, BLIP2_PROMPT)] * 2
    assert got[0]["ddddddddd01"] == [{"sentence": "Generated title", "timestamp": [0.0, 80.0]}]


@pytest.mark.parametrize("mode", ["random", "clip", "bert"])
def test_run_vcgr_matches_jax(data, mode):
    from vidchapters_tpu.zeroshot import run as J
    from vidchapters_tpu_torch.zeroshot import run as T

    ann, subs, feat_dir, feats = data

    def embed(texts):
        return np.stack([feats[10] if "cook" in t else feats[60] for t in texts])

    kw = dict(random=dict(subtitles_path=subs, seed=4),
              clip=dict(features_path=feat_dir, text_embed_fn=embed, threshold=0.1),
              bert=dict(text_embed_fn=embed, subtitles_path=subs, seed=2))[mode]
    _same(T.run_vcgr(ann, mode=mode, **kw), J.run_vcgr(ann, mode=mode, **kw))


def test_zeroshot_cli_speech_and_vcgr_match_jax(tmp_path, data, capsys):
    from vidchapters_tpu.zeroshot import run as J
    from vidchapters_tpu_torch.zeroshot import run as T

    ann, subs, _, _ = data
    for task in (["speech", "--ann", ann, "--subtitles", subs],
                 ["vcgr", "--ann", ann, "--mode", "random", "--subtitles", subs, "--seed", "3"]):
        outs = []
        for mod, name in ((T, "port"), (J, "jax")):
            out = tmp_path / f"{task[0]}_{name}.json"
            extra = ["--device", "cpu"] if mod is T and task[0] == "speech" else []
            mod.main(task + ["--out", str(out)] + extra)
            outs.append((out.read_text(), capsys.readouterr().out.strip().splitlines()[-1]))
        assert outs[0] == outs[1]
    with pytest.raises(SystemExit):
        T.main(["vcgr", "--ann", ann, "--mode", "clip"])


def test_zeroshot_cli_speech_paths_default_reaches_llama(tmp_path, data, capsys):
    """``--paths`` with ``<model_dir>/7BHF`` present takes the LLaMA titler:
    an empty directory raises in its loader (no ``tokenizer.model``), a
    synthetic HF LLaMA directory titles the sections."""
    from tests._torch_helpers import write_llama_dir
    from vidchapters_tpu_torch.config import PathsConfig, save_config
    from vidchapters_tpu_torch.models.llama import LlamaConfig
    from vidchapters_tpu_torch.zeroshot import run as T

    (tmp_path / "models" / "7BHF").mkdir(parents=True)
    save_config(PathsConfig(model_dir=str(tmp_path / "models")), str(tmp_path / "paths.json"))
    argv = ["speech", "--ann", data[0], "--subtitles", data[1], "--paths",
            str(tmp_path / "paths.json"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        T.main(argv)
    write_llama_dir(tmp_path / "models" / "7BHF", LlamaConfig(
        vocab_size=700, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2), seed=6)
    capsys.readouterr()
    T.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out and all(np.isfinite(v) for v in out.values())


def test_zeroshot_cli_visual_matches_jax(tmp_path, data, capsys, monkeypatch):
    """``visual --blip2_dir`` on a synthetic HF directory, on the CPU, against
    JAX's ``run_visual_vcg_raw`` with a captioner of JAX's ``blip2_generate``
    over ``convert_hf_blip2`` of the same weights. Both run in fp32: the
    loader's bfloat16 default gives tokens that two frameworks need not
    share."""
    import functools

    import jax.numpy as jnp

    from vidchapters_tpu_torch.models import blip2 as port_blip2

    monkeypatch.setattr(port_blip2, "build_blip2_captioner",
                        functools.partial(port_blip2.build_blip2_captioner, dtype="float32"))

    from tests._torch_helpers import blip2_hf_state_dict, blip2_small_cfgs, write_blip2_dir
    from vidchapters_tpu.data.tokenizer import SentencePieceUnigramTokenizer as JTok
    from vidchapters_tpu.models.blip2 import Blip2, blip2_generate, convert_hf_blip2
    from vidchapters_tpu.models.blip2 import preprocess_frames
    from vidchapters_tpu.zeroshot import run as J
    from vidchapters_tpu_torch.zeroshot import run as T

    jcfg, tcfg = blip2_small_cfgs(vocab=32128)
    jcfg = type(jcfg)(vision=type(jcfg.vision)(**{**jcfg.vision.__dict__, "image_size": 224,
                                                   "patch_size": 112}),
                      qformer=jcfg.qformer, t5=jcfg.t5, num_query_tokens=4)
    tcfg = type(tcfg)(vision=type(tcfg.vision)(**{**tcfg.vision.__dict__, "image_size": 224,
                                                   "patch_size": 112}),
                      qformer=tcfg.qformer, t5=tcfg.t5, num_query_tokens=4)
    root = write_blip2_dir(tmp_path / "blip2", tcfg, seed=11)
    ann = data[0]
    videos = tmp_path / "videos.json"
    videos.write_text(json.dumps({"ddddddddd01": "missing.mp4", "eeeeeeeee02": "missing2.mp4"}))
    out = tmp_path / "visual.json"
    T.main(["visual", "--ann", ann, "--videos", str(videos), "--blip2_dir", str(root),
            "--out", str(out), "--device", "cpu"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    tok = JTok(str(root / "spiece.model"), num_bins=0)
    params = convert_hf_blip2({k: v.numpy() for k, v in
                               blip2_hf_state_dict(tcfg, seed=11).items()})

    def caption_fn(frames, prompt):
        ids = jnp.asarray([tok.encode(prompt, add_special_tokens=True)] * len(frames))
        toks = blip2_generate(Blip2(jcfg), params, jnp.asarray(preprocess_frames(frames)), ids,
                              jnp.ones_like(ids), max_new_tokens=20)
        return tok.batch_decode(np.asarray(toks), skip_special_tokens=True)

    ref_results, ref_metrics = J.run_visual_vcg_raw(ann, str(videos), caption_fn)
    assert json.loads(out.read_text()) == json.loads(json.dumps({"results": ref_results}))
    assert metrics == json.loads(json.dumps(ref_metrics))
