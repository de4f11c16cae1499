"""PyTorch / CUDA port of vidchapters_tpu for one NVIDIA H100.

This slice serves Vid2Seq chapter generation end to end: the temporal ViT
and T5 encoders, beam or greedy decoding through the cross-layer decode
kernel, and the HTTP server. The kernels are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use by ``ops/_build.py``. Each
kernel's wrapper launches the kernel for CUDA tensors and runs a plain
PyTorch version of the same function for CPU tensors.

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
