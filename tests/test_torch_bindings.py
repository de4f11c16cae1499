"""Every ctypes binding of the port's CUDA kernels against its C signature
in ``csrc/``: the same number of parameters, each of the same kind (pointer,
int, float, uint32). A mismatch would pass a pointer where the C function
reads an int, which only the card would show, as a crash."""

import ctypes
import re
from pathlib import Path

import pytest

from vidchapters_tpu_torch.ops import (
    decode_attention,
    decode_megakernel,
    decoding,
    deformable_attention,
    fused_attention,
    probes,
    whisper_megakernel,
)
from vidchapters_tpu_torch.ops._build import CSRC

KERNELS = [decode_attention.SELF_KERNEL, decode_attention.CROSS_KERNEL, decode_megakernel.KERNEL,
           decoding.TOPK_KERNEL, deformable_attention.FWD_KERNEL, deformable_attention.BWD_KERNEL,
           fused_attention.KERNEL, fused_attention.BWD_KERNEL, probes.KERNEL,
           whisper_megakernel.KERNEL]
SIGNATURE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str):
    param = " ".join(param.split())
    if "*" in param:
        return ctypes.c_void_p
    if re.match(r"^(const\s+)?(unsigned|uint32_t)\b", param):
        return ctypes.c_uint32
    if re.match(r"^(const\s+)?int\b", param):
        return ctypes.c_int
    if re.match(r"^(const\s+)?float\b", param):
        return ctypes.c_float
    raise AssertionError(f"unknown C parameter type: {param!r}")


def _signatures():
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in SIGNATURE.findall(src.read_text()):
            out[(src.stem, name)] = [_kind(p) for p in params.split(",") if p.strip()]
    return out


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_bindings_match_c_signatures(kernel):
    sigs = _signatures()
    assert (Path(CSRC) / f"{kernel.name}.cu").exists()
    for symbol, argtypes in kernel.symbols.items():
        assert (kernel.name, symbol) in sigs, f"{symbol} not in csrc/{kernel.name}.cu"
        assert list(argtypes) == sigs[(kernel.name, symbol)], symbol
