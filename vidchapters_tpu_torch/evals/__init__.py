"""The DVC / SODA / captioning metric stack of dense video captioning and
chapter generation: the port's own copy of ``vidchapters_tpu/evals`` (pure
Python and numpy there too), changed only in its imports. The VC
(``captioning``), moment and paragraph evaluators are not copied yet."""

from vidchapters_tpu_torch.evals.ptb import PTBTokenizer
from vidchapters_tpu_torch.evals.bleu import Bleu
from vidchapters_tpu_torch.evals.rouge import Rouge
from vidchapters_tpu_torch.evals.cider import Cider
from vidchapters_tpu_torch.evals.meteor import Meteor
from vidchapters_tpu_torch.evals.dvc import eval_dvc
from vidchapters_tpu_torch.evals.soda import eval_soda

__all__ = [
    "PTBTokenizer",
    "Bleu",
    "Rouge",
    "Cider",
    "Meteor",
    "eval_dvc",
    "eval_soda",
]
