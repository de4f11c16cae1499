"""Annotation preprocessing: mined chapters -> task-specific files.

Counterpart of ``vidchapters_tpu/factory/preproc.py``, a copy over the
port's ``evals/ptb.py``. Behavioral ports of preproc/:
- ``chapters_to_dvc`` (chapters_to_dvc.py:29-87): chapters.pkl-style dict ->
  DVC json ``{vid: {duration, timestamps, sentences, path}}``; segments run
  to the next chapter start (last to video end), out-of-range dropped,
  videos with any empty-after-PTB-tokenization title skipped;
- ``chapters_to_vmr`` (chapters_to_vmr.py:13-61): -> moment-retrieval jsonl;
  windows covering >= 0.9 x duration dropped; train rows carry the full
  query list per video, val/test one row per query with disambiguated vids;
- ``vitt_to_dvc`` (vitt.py:29-89): ViTT annotation rows (timestamps in ms)
  -> DVC json, deduping on >3-annotator videos by keeping the first;
- ``youcook_to_dvc`` (youcook.py:6-23): YouCook2 annotation schema -> same.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

from vidchapters_tpu_torch.evals.ptb import ptb_tokenize_sentence

_PUNCT = [",", ":", "!", "_", ";", "-", ".", "?", "/", '"', "\\n", "\\"]


def _filterable(sentence: str) -> str:
    for m in _PUNCT:
        sentence = sentence.replace(m, " ")
    return re.sub(r"\s+", " ", sentence).strip().lower()


def chapters_to_dvc(data: Dict[str, dict],
                    splits: Optional[Dict[str, set]] = None
                    ) -> Dict[str, Dict[str, dict]]:
    """{vid: {"duration", "chapters": [{"label","time"}]}} -> per-split DVC
    jsons (single "all" split when ``splits`` is None)."""
    out: Dict[str, dict] = {}
    for vid, anns in data.items():
        if "duration" not in anns:
            continue
        duration = float(anns["duration"])
        chapters = anns["chapters"]
        timestamps = []
        for i, ch in enumerate(chapters):
            end = (float(chapters[i + 1]["time"]) if i < len(chapters) - 1
                   else duration)
            timestamps.append([float(ch["time"]), end])
        timestamps = [t for t in timestamps if t[0] <= t[1] <= duration]
        if not timestamps:
            continue
        if not all(_filterable(c["label"]) for c in chapters):
            continue
        if not all(ptb_tokenize_sentence(c["label"]).strip() for c in chapters):
            continue
        out[vid] = {
            "duration": duration,
            "timestamps": timestamps,
            "sentences": [c["label"] for c in chapters],
            "path": vid + ".mp4.npy",
        }
    if splits is None:
        return {"all": out}
    return {name: {v: out[v] for v in out if v in vids}
            for name, vids in splits.items()}


def chapters_to_vmr(data: Dict[str, dict], splits: Dict[str, set]
                    ) -> Dict[str, List[dict]]:
    """-> per-split jsonl rows (chapters_to_vmr.py:13-61)."""
    rows: Dict[str, List[dict]] = {name: [] for name in splits}
    qid = 0
    cnt: Dict[str, int] = {}
    for vid, anns in data.items():
        split = next((n for n, vids in splits.items() if vid in vids), None)
        if split is None or "duration" not in anns:
            continue
        duration = float(anns["duration"])
        cur = []
        for i, ch in enumerate(anns["chapters"]):
            end = (float(anns["chapters"][i + 1]["time"])
                   if i < len(anns["chapters"]) - 1 else duration)
            window = [float(ch["time"]), end]
            if window[1] - window[0] >= 0.9 * duration:
                continue
            if window[0] <= window[1] <= duration:
                cur.append({"label": ch["label"], "window": window})
        if not cur:
            continue
        if split == "train":  # one row, all queries (multi-query sampling)
            rows[split].append({
                "qid": qid, "query": [c["label"] for c in cur], "vid": vid,
                "duration": int(duration), "split": split,
                "relevant_windows": [[c["window"]] for c in cur]})
            qid += 1
        else:  # one row per query; vid disambiguated by a counter prefix
            for c in cur:
                rows[split].append({
                    "qid": qid, "query": c["label"],
                    "vid": str(cnt.get(vid, 0)) + vid,
                    "duration": int(duration), "split": split,
                    "relevant_windows": [c["window"]]})
                cnt[vid] = cnt.get(vid, 0) + 1
                qid += 1
    return rows


def vitt_to_dvc(rows: Iterable[dict], durations: Dict[str, float],
                max_annotators_dedup: int = 3) -> Dict[str, dict]:
    """ViTT annotation rows {id, annotations: [{timestamp_ms, tag}]} -> DVC
    json; videos with >3 annotation sets keep only the first (vitt.py:29-89)."""
    seen: Dict[str, int] = {}
    out: Dict[str, dict] = {}
    for row in rows:
        vid = row["id"]
        seen[vid] = seen.get(vid, 0) + 1
        if seen[vid] > 1:
            continue
        if vid not in durations:
            continue
        duration = float(durations[vid])
        anns = sorted(row["annotations"], key=lambda a: a["timestamp_ms"])
        timestamps = []
        sentences = []
        for i, a in enumerate(anns):
            start = a["timestamp_ms"] / 1000.0
            end = (anns[i + 1]["timestamp_ms"] / 1000.0
                   if i < len(anns) - 1 else duration)
            if start <= end <= duration and a.get("tag", "").strip():
                timestamps.append([start, end])
                sentences.append(a["tag"])
        if timestamps:
            out[vid] = {"duration": duration, "timestamps": timestamps,
                        "sentences": sentences}
    return out


def youcook_to_dvc(data: Dict[str, dict]) -> Dict[str, dict]:
    """YouCook2 schema {vid: {duration, annotations: [{segment, sentence}]}}
    -> DVC json (youcook.py:6-23)."""
    out = {}
    for vid, ann in data.items():
        segs = ann.get("annotations", [])
        timestamps = [[float(s["segment"][0]), float(s["segment"][1])]
                      for s in segs]
        sentences = [s["sentence"] for s in segs]
        if timestamps:
            out[vid] = {"duration": float(ann["duration"]),
                        "timestamps": timestamps, "sentences": sentences}
    return out
