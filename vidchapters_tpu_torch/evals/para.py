"""Paragraph-level captioning evaluation.

Counterpart of PDVC/densevid_eval3/para_evaluate.py:25-180: each video's
predicted captions are joined (time-sorted) into one paragraph, normalized to
letters-only lowercase tokens (parse_sent), and scored against per-video
ground-truth paragraphs with BLEU / METEOR / CIDEr over the whole corpus
(multi-reference when several GT files are given). The port's own copy of
``vidchapters_tpu/evals/para.py``, changed only in its imports.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Sequence, Union

from vidchapters_tpu_torch.evals.bleu import Bleu
from vidchapters_tpu_torch.evals.cider import Cider
from vidchapters_tpu_torch.evals.meteor import Meteor


def parse_sent(sent: str) -> List[str]:
    return re.sub("[^a-zA-Z]", " ", sent).strip().lower().split()


def prediction_to_paragraphs(submission: Dict[str, list]) -> Dict[str, str]:
    """DVC submission {vid: [{sentence, timestamp}]} -> {vid: paragraph}."""
    out = {}
    for vid, props in submission.items():
        ordered = sorted(props, key=lambda p: p["timestamp"][0])
        out[vid] = ". ".join(p["sentence"].strip().rstrip(".")
                             for p in ordered) + "."
    return out


def _load(obj: Union[str, dict]) -> dict:
    if isinstance(obj, dict):
        return obj
    with open(obj) as f:
        return json.load(f)


def eval_para(submission: Union[str, dict],
              para_references: Sequence[Union[str, dict]]) -> Dict[str, float]:
    """submission: DVC json (``results`` schema) or {vid: paragraph};
    references: files/dicts mapping vid -> paragraph (or DVC-style with
    ``sentences`` lists, joined)."""
    sub = _load(submission)
    if "results" in sub:
        preds = prediction_to_paragraphs(sub["results"])
    else:
        preds = sub
    gts_list = []
    for ref in para_references:
        gt = _load(ref)
        norm = {}
        for vid, v in gt.items():
            if isinstance(v, dict) and "sentences" in v:
                norm[vid] = " ".join(v["sentences"])
            else:
                norm[vid] = v
        gts_list.append(norm)

    vid_ids = sorted({v for gt in gts_list for v in gt})
    gts = {i: [" ".join(parse_sent(gt[vid]))
               for gt in gts_list if vid in gt]
           for i, vid in enumerate(vid_ids)}
    res = {i: [" ".join(parse_sent(preds.get(vid, "")))]
           for i, vid in enumerate(vid_ids)}

    out: Dict[str, float] = {}
    bleu_scores, _ = Bleu(4).compute_score(gts, res)
    for i, s in enumerate(bleu_scores):
        out[f"Para_Bleu_{i + 1}"] = float(s)
    meteor, _ = Meteor().compute_score(gts, res)
    out["Para_METEOR"] = float(meteor)
    cider, _ = Cider().compute_score(gts, res)
    out["Para_CIDEr"] = float(cider)
    return out
