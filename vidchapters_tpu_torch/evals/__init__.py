"""The metric stack of dense video captioning, chapter generation, chapter
titles (``captioning``), paragraphs (``para``) and chapter grounding
(``moment``): the port's own copy of ``vidchapters_tpu/evals`` (pure Python
and numpy there too), changed only in its imports."""

from vidchapters_tpu_torch.evals.ptb import PTBTokenizer
from vidchapters_tpu_torch.evals.bleu import Bleu
from vidchapters_tpu_torch.evals.rouge import Rouge
from vidchapters_tpu_torch.evals.cider import Cider
from vidchapters_tpu_torch.evals.meteor import Meteor
from vidchapters_tpu_torch.evals.dvc import eval_dvc
from vidchapters_tpu_torch.evals.soda import eval_soda
from vidchapters_tpu_torch.evals.captioning import COCOEvalCap, eval_vc
from vidchapters_tpu_torch.evals.moment import eval_submission
from vidchapters_tpu_torch.evals.para import eval_para

__all__ = [
    "PTBTokenizer",
    "Bleu",
    "Rouge",
    "Cider",
    "Meteor",
    "eval_dvc",
    "eval_soda",
    "COCOEvalCap",
    "eval_vc",
    "eval_submission",
    "eval_para",
]
