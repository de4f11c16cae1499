"""Build a CUDA source of ``vidchapters_tpu_torch/csrc`` for the CPU: g++
against ``tests/cuda_emulation/emu_rt.h`` (a stand-in for the CUDA runtime
and the warp primitives: one OS thread per CUDA thread, the blocks of a grid
one after another, or all at once for a cooperative launch). The sources are
used as they are, except that the bodies of the functions holding inline PTX
(in ``tensor_core.cuh``, and in the kernel's own source where it has them)
are replaced by their emulation, launches ``k<<<...>>>(...)`` are rewritten
as calls, and the dynamic shared memory is the running block's own buffer.
``emulated_kernel`` binds the library to a ``CudaKernel`` as the card's
build would, so the wrappers' own launch code drives it."""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

from vidchapters_tpu_torch.ops._build import CSRC, CudaKernel

EMU = Path(__file__).resolve().parent / "cuda_emulation"
# tensor_core.cuh's functions that hold inline PTX, and their emulation
PTX_BODIES = {
    "cp_async16": "std::memset(dst, 0, 16); if (bytes) std::memcpy(dst, src, bytes);",
    "cp_async4": "std::memset(dst, 0, 4); if (bytes) std::memcpy(dst, src, bytes);",
    "cp_async_commit": "",
    "cp_async_wait": "",
    "ldsm_x4": "emu::ldmatrix(r, p, false);",
    "ldsm_x4_t": "emu::ldmatrix(r, p, true);",
    "mma": "emu::mma(c, a, b0, b1);",
}
# functions of a kernel's own source or of a shared header (other than
# tensor_core.cuh) that hold inline PTX, where they have them
KERNEL_PTX_BODIES = {
    "prefetch_l2": "(void)p;",
    "global_ns": "return emu::now_ns();",
}


def replace_body(src: str, name: str, body: str) -> str:
    m = re.search(r"__device__ __forceinline__ [^\n]*\b%s\([^)]*\) \{" % name, src)
    assert m, f"{name} not found"
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    return src[:m.end()] + "\n  " + body + "\n}" + src[i:]


def _kernel_ptx(src: str) -> str:
    """``src`` with the bodies of its KERNEL_PTX_BODIES functions emulated."""
    for fn, body in KERNEL_PTX_BODIES.items():
        if re.search(r"__device__ __forceinline__ [^\n]*\b%s\(" % fn, src):
            src = replace_body(src, fn, body)
    return src


def emulated_library(name: str, out: Path) -> Path:
    """``csrc/<name>.cu`` built for the CPU into ``out`` (once)."""
    lib = out / f"lib{name}.so"
    if lib.exists():
        return lib
    header = (CSRC / "tensor_core.cuh").read_text()
    for fn, body in PTX_BODIES.items():
        header = replace_body(header, fn, body)
    (out / "tensor_core.cuh").write_text('#include "emu_rt.h"\n' + header)
    for other in CSRC.glob("*.cuh"):
        if other.name != "tensor_core.cuh":
            (out / other.name).write_text(_kernel_ptx(other.read_text()))
    for stub in ("cuda_runtime.h", "cuda_bf16.h", "math_constants.h"):
        (out / stub).write_text('#include "emu_rt.h"\n')
    src = _kernel_ptx((CSRC / f"{name}.cu").read_text())
    src = re.sub(r"(\w+(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\(", r"vc_bind(\1, \2)(", src,
                 flags=re.S)
    # the block's dynamic shared memory is the running block's buffer
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?(\w+(?: \w+)?) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu::dyn_smem();", src)
    (out / f"{name}.cpp").write_text(src)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(out), "-I", str(EMU), "-o", str(lib),
                          str(out / f"{name}.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return lib


def emulated_kernel(ref: CudaKernel, out: Path) -> CudaKernel:
    """A ``CudaKernel`` with ``ref``'s name and entry points, bound to the
    source built for the CPU in ``out``."""
    kern = CudaKernel(ref.name, ref.symbols)
    lib = ctypes.CDLL(str(emulated_library(ref.name, out)))
    for sym, argtypes in kern.symbols.items():
        fn = getattr(lib, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    kern._lib = lib
    return kern
