"""PyTorch / CUDA port of vidchapters_tpu for one NVIDIA H100.

Entry points:

- ``serve``: Vid2Seq chapter generation behind an HTTP server (beam or
  greedy decoding through the T5 decode kernel), from seeded weights, a
  checkpoint of ``train/dvc_main`` or a reference ``.pth``
  (``models/torch_import``);
- ``train/dvc_main``: Vid2Seq fine-tuning and evaluation (beam, greedy or
  nucleus on the standard cached decode, DVC / SODA metrics), and
  HowTo100M pretraining (``htm``: ``data/dvc_dataset.YTPretrainDataset``,
  bf16 Adam moments);
- ``train/vc_main``: chapter titles from ground-truth boundaries (VC):
  Vid2Seq trained on clips and evaluated per clip (beam search on the
  decode kernel, the COCO captioning metrics), and the ``random``
  zero-shot evaluator;
- ``train/grounding_main``: chapter grounding with Moment-DETR and its
  frozen CLIP text tower (``configs/chapters_momentdetr.json``), with the
  optional BERT speech tower;
- ``train/pdvc_main``: the PDVC baseline;
- ``factory/asr``: the Whisper ASR factory, with word alignment
  (``factory/align``);
- ``factory/features``: CLIP ViT-L/14 frame features (the datasets'
  features); ``factory/chapters`` and ``factory/preproc``: chapters mined
  from descriptions and the DVC / VMR annotations;
- ``demo/demo_vid2seq`` and ``demo/run_on_video``: chapters and moments
  from one raw video.
- ``zeroshot/run``: the paper's zero-shot baselines (TextTiling + LLaMA
  speech chapters, shot detection + BLIP-2 visual chapters, zero-shot
  grounding); ``train/vc_main`` takes the same LLaMA and BLIP-2 towers as
  its ``llama`` / ``blip2`` evaluators.

The kernels are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built at first use by ``ops/_build.py``. Each kernel's wrapper launches the
kernel for CUDA tensors and runs a plain PyTorch version of the same
function for CPU tensors. Two host-side C++ libraries under ``native/``
(the SentencePiece Viterbi and the feature loader) are built with g++ at
first use by ``data/_native_build.py``.

The package imports ``torch``, ``numpy`` and the standard library only.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for (or defaulted to) and absent:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
