"""Zero-shot baseline runners over DVC-format datasets.

The port's counterpart of ``vidchapters_tpu/zeroshot/run.py``, the
script-level equivalents of zs_speechvcg.py / zs_visualvcg.py / zs_vcgr.py:
iterate a dataset's annotation json (+ ASR pickle / features dir), produce
predictions, and score — speech/visual chapter generation with eval_dvc +
SODA, grounding with the zero-shot recall metrics (zs_vcgr.py:20-48).

    python -m vidchapters_tpu_torch.zeroshot.run speech --ann A --subtitles S [--device cpu]
    python -m vidchapters_tpu_torch.zeroshot.run visual --ann A --videos V --blip2_dir D
    python -m vidchapters_tpu_torch.zeroshot.run vcgr --ann A --mode random

The models run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from vidchapters_tpu_torch.data.dvc_dataset import SubtitleSource
from vidchapters_tpu_torch.utils.io import load_json
from vidchapters_tpu_torch.zeroshot.grounding import (
    clip_grounding_spans,
    evaluate_predictions,
    random_grounding_spans,
)
from vidchapters_tpu_torch.zeroshot.speech_vcg import (
    first_sentence_titler,
    speech_chapters,
)
from vidchapters_tpu_torch.zeroshot.visual_vcg import (
    feature_shot_detection,
    shots_from_boundaries,
    visual_chapters,
)


def run_speech_vcg(ann_json: str, subtitles_path: str,
                   titler: Callable = first_sentence_titler,
                   references: Optional[List] = None
                   ) -> Tuple[Dict, Dict[str, float]]:
    """zs_speechvcg equivalent: TextTiling + title per section."""
    data = load_json(ann_json)
    subs = SubtitleSource(subtitles_path)
    results = {}
    for vid, ann in data.items():
        sub = subs.get(vid)
        results[vid] = (speech_chapters(sub, float(ann["duration"]),
                                        titler=titler) if sub else [])
    metrics = _score_dvc(results, references or [ann_json])
    return results, metrics


def run_visual_vcg(ann_json: str, features_path,
                   captioner: Callable[[str, float], str],
                   shot_threshold: float = 0.3,
                   references: Optional[List] = None
                   ) -> Tuple[Dict, Dict[str, float]]:
    """zs_visualvcg equivalent on precomputed frame features:
    feature-based shot detection + ``captioner(vid, midpoint_sec)``."""
    from vidchapters_tpu_torch.data.features import FeatureSource

    data = load_json(ann_json)
    feats = FeatureSource(features_path, max_feats=10 ** 9)
    results = {}
    for vid, ann in data.items():
        duration = float(ann["duration"])
        f = feats.raw(vid[-11:])
        # assume 1 feature per second (the reference's 1-FPS features)
        times = [min(i, duration) for i in range(len(f))]
        bounds = feature_shot_detection(f, times, threshold=shot_threshold)
        shots = shots_from_boundaries(bounds, duration)
        results[vid] = visual_chapters(
            shots, captioner=lambda t, _vid=vid: captioner(_vid, t))
    metrics = _score_dvc(results, references or [ann_json])
    return results, metrics


def run_visual_vcg_raw(ann_json: str, videos_json, caption_fn,
                       shot_threshold: float = 0.7,
                       references: Optional[List] = None
                       ) -> Tuple[Dict, Dict[str, float]]:
    """The reference's raw-video visual VCG path (zs_visualvcg.py:240-266):
    ffprobe scene detection at ``threshold=0.7`` + BLIP-2 captions of each
    shot's midpoint frame, batched per video.

    ``videos_json``: path to (or dict of) ``{vid: video_path}``;
    ``caption_fn(frames_uint8 [B, 224, 224, 3], prompt) -> list[str]``
    (``models.blip2.build_blip2_captioner``)."""
    from vidchapters_tpu_torch.data.vc_dataset import get_raw_video
    from vidchapters_tpu_torch.zeroshot.visual_vcg import (
        BLIP2_PROMPT,
        ffprobe_shot_detection,
        shots_from_boundaries,
    )

    data = load_json(ann_json)
    vid2path = (load_json(videos_json) if isinstance(videos_json, str)
                else videos_json)
    results = {}
    for vid, ann in data.items():
        duration = float(ann["duration"])
        path = vid2path.get(vid, vid2path.get(vid[-11:]))
        try:
            bounds = ffprobe_shot_detection(path, threshold=shot_threshold)
        except Exception:
            bounds = []
        shots = shots_from_boundaries(bounds, duration)
        if not shots:
            results[vid] = []
            continue
        frames = get_raw_video(path)  # 1 FPS, zeros fallback
        mids = np.stack([
            frames[min(int(round((st + ed) / 2.0)), len(frames) - 1)]
            for st, ed in shots])
        captions = caption_fn(mids, BLIP2_PROMPT)
        results[vid] = [
            {"sentence": c.strip(), "timestamp": [st, ed]}
            for c, (st, ed) in zip(captions, shots) if c.strip()]
    metrics = _score_dvc(results, references or [ann_json])
    return results, metrics


def run_vcgr(ann_json: str, features_path=None, text_embed_fn=None,
             subtitles_path: Optional[str] = None, mode: str = "clip",
             threshold: float = 0.05, seed: int = 0
             ) -> Tuple[Dict, Dict[str, float]]:
    """zs_vcgr equivalent.

    mode="clip": ``text_embed_fn(titles) -> [N, D]`` against frame features;
    mode="bert": ``text_embed_fn(texts) -> [N, D]`` for titles AND ASR lines;
    mode="random": random spans.
    """
    data = load_json(ann_json)
    subs = SubtitleSource(subtitles_path) if subtitles_path else None
    feats = None
    if features_path is not None:
        from vidchapters_tpu_torch.data.features import FeatureSource

        feats = FeatureSource(features_path, max_feats=10 ** 9)
    rng = np.random.default_rng(seed)
    results = {}
    for vid, ann in data.items():
        duration = float(ann["duration"])
        queries = ann["sentences"]
        gt = ann["timestamps"]
        sub = subs.get(vid) if subs else None
        if mode == "random":
            starts = sub["start"] if sub else None
            ends = sub["end"] if sub else None
            pred = random_grounding_spans(len(queries), duration, starts,
                                          ends, rng)
        elif mode == "bert":
            if not sub or not sub["text"]:
                pred = random_grounding_spans(len(queries), duration, rng=rng)
            else:
                from vidchapters_tpu_torch.zeroshot.grounding import (
                    bert_grounding_spans,
                )

                q = text_embed_fn(queries)
                a = text_embed_fn(sub["text"])
                pred = bert_grounding_spans(q, a, sub["start"], sub["end"])
        else:  # clip
            f = feats.raw(vid[-11:], strict=False)
            times = [float(i) for i in range(len(f))]
            q = text_embed_fn(queries)
            pred = clip_grounding_spans(q, f, times, duration,
                                        threshold=threshold)
        results[vid] = {"pred": pred, "gt": gt}
    return results, evaluate_predictions(results)


def _score_dvc(results: Dict, references: List) -> Dict[str, float]:
    from vidchapters_tpu_torch.evals.dvc import eval_dvc
    from vidchapters_tpu_torch.evals.soda import eval_soda

    submission = {"results": results}
    metrics = dict(eval_dvc(submission, references))
    metrics.update(eval_soda(submission, references))
    return metrics


def main(args=None) -> None:
    """CLI mirroring the reference's standalone zs_*.py scripts."""
    import argparse
    import json as _json

    p = argparse.ArgumentParser(description="Zero-shot chaptering baselines")
    sub = p.add_subparsers(dest="task", required=True)

    sp = sub.add_parser("speech", help="TextTiling over ASR (zs_speechvcg.py)")
    sp.add_argument("--ann", required=True, help="annotation json")
    sp.add_argument("--subtitles", required=True, help="ASR pickle/dir")
    sp.add_argument("--llama_dir", default=None,
                    help="HF LLaMA checkpoint dir -> LLM section titler "
                         "(zs_speechvcg.py:150-200); defaults to "
                         "<paths.model_dir>/7BHF when a --paths config "
                         "points at the reference model root (args.py:221); "
                         "else first-sentence titling")
    sp.add_argument("--paths", default=None,
                    help="PathsConfig json (model_dir root for the 7BHF "
                         "LLaMA default)")
    sp.add_argument("--random", action="store_true",
                    help="random ASR line per section (zs_speechvcg.py:183)")
    sp.add_argument("--out", default=None, help="write predictions json here")
    sp.add_argument("--no-score", action="store_true")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    vp = sub.add_parser("visual", help="shot detect + BLIP-2 captions "
                                       "(zs_visualvcg.py)")
    vp.add_argument("--ann", required=True)
    vp.add_argument("--videos", required=True,
                    help="json mapping vid -> raw video path")
    vp.add_argument("--blip2_dir", required=True,
                    help="HF BLIP-2 checkpoint dir (blip2-flan-t5-xl)")
    vp.add_argument("--threshold", type=float, default=0.7)
    vp.add_argument("--out", default=None)
    vp.add_argument("--no-score", action="store_true")
    vp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    gp = sub.add_parser("vcgr", help="zero-shot grounding (zs_vcgr.py)")
    gp.add_argument("--ann", required=True)
    gp.add_argument("--mode", default="random",
                    choices=["random", "clip", "bert"],
                    help="clip/bert need embedding callables; see run_vcgr")
    gp.add_argument("--features", default=None)
    gp.add_argument("--subtitles", default=None)
    gp.add_argument("--threshold", type=float, default=0.05)
    gp.add_argument("--seed", type=int, default=0)
    gp.add_argument("--out", default=None)

    a = p.parse_args(args)
    if a.task == "speech":
        refs = None if a.no_score else [a.ann]
        if not a.llama_dir and a.paths:
            import os

            from vidchapters_tpu_torch.config import PathsConfig, load_config

            roots = load_config(PathsConfig, a.paths)
            cand = os.path.join(roots.model_dir, "7BHF")
            if roots.model_dir and os.path.isdir(cand):
                a.llama_dir = cand
        if a.llama_dir:
            from vidchapters_tpu_torch.models.llama import build_llama_titler
            from vidchapters_tpu_torch.zeroshot.speech_vcg import make_llm_titler

            titler = make_llm_titler(build_llama_titler(a.llama_dir, device=a.device))
        elif a.random:
            from vidchapters_tpu_torch.zeroshot.speech_vcg import make_random_titler

            titler = make_random_titler()
        else:
            titler = first_sentence_titler
        results, metrics = run_speech_vcg(a.ann, a.subtitles, titler=titler,
                                          references=refs)
        if a.out:
            with open(a.out, "w") as f:
                _json.dump({"results": results}, f)
        print(_json.dumps(metrics))
    elif a.task == "visual":
        from vidchapters_tpu_torch.models.blip2 import build_blip2_captioner

        refs = None if a.no_score else [a.ann]
        results, metrics = run_visual_vcg_raw(
            a.ann, a.videos, build_blip2_captioner(a.blip2_dir, device=a.device),
            shot_threshold=a.threshold, references=refs)
        if a.out:
            with open(a.out, "w") as f:
                _json.dump({"results": results}, f)
        print(_json.dumps(metrics))
    else:
        if a.mode != "random":
            p.error(f"mode {a.mode!r} needs an embedding callable; use the "
                    "run_vcgr API directly (zs_vcgr.py clip/bert paths)")
        results, metrics = run_vcgr(a.ann, features_path=a.features,
                                    subtitles_path=a.subtitles, mode="random",
                                    threshold=a.threshold, seed=a.seed)
        if a.out:
            serializable = {v: {"pred": [list(map(float, s))
                                         for s in r["pred"]],
                                "gt": [list(map(float, g))
                                       for g in r["gt"]]}
                            for v, r in results.items()}
            with open(a.out, "w") as f:
                _json.dump(serializable, f)
        print(_json.dumps(metrics))


if __name__ == "__main__":
    main()
