"""Clip-level captioning evaluation with GT boundaries (VC task).

Behavioral port of dvc_eval/eval_vc.py:7-80: BLEU-1..4 / METEOR / ROUGE-L /
CIDEr over (prediction, single ground truth) pairs. The reference feeds the
*prediction* into the scorers' reference slot and the *GT* into the
hypothesis slot (eval_vc.py:16-22); that orientation is preserved for parity
(symmetric for BLEU-with-one-ref, asymmetric for METEOR/ROUGE and for CIDEr,
whose document frequencies come from the reference slot). The port's own
copy of ``vidchapters_tpu/evals/captioning.py``, changed only in its imports.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from vidchapters_tpu_torch.evals.bleu import Bleu
from vidchapters_tpu_torch.evals.cider import Cider
from vidchapters_tpu_torch.evals.meteor import Meteor
from vidchapters_tpu_torch.evals.ptb import PTBTokenizer
from vidchapters_tpu_torch.evals.rouge import Rouge


class COCOEvalCap:
    """``results`` maps id -> {"sentence": prediction, "gt": ground truth}."""

    def __init__(self, results: Dict[object, Dict[str, str]]):
        self.gts = {i: [{"caption": r["sentence"]}] for i, r in results.items()}
        self.res = {i: [{"caption": r["gt"]}] for i, r in results.items()}
        self.eval: Dict[str, float] = {}

    def evaluate(self) -> Dict[str, float]:
        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize(self.gts)
        res = tokenizer.tokenize(self.res)
        scorers: List[Tuple[object, object]] = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        out: Dict[str, float] = {}
        for scorer, method in scorers:
            score, _ = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for m, s in zip(method, score):
                    out[m] = float(s)
            else:
                out[method] = float(score)
        self.eval = out
        return out


def eval_vc(results: Dict[object, Dict[str, str]]) -> Dict[str, float]:
    return COCOEvalCap(results).evaluate()
