"""Feature probes: the seven TPU probes of ``ops_probe_tpu.py`` (``p1`` ...
``p7``) as small CUDA kernels (``csrc/probes.cu``) beside plain PyTorch
versions of the same outputs.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; ``PROBES`` lists them with their inputs and known answers,
and ``run_probes`` runs all seven and compares. ``p7`` is a timing probe:
on the card ``run_probes`` also reports its microseconds per grid cell.

One finding of the port: the TPU probe ``p5`` asserts 12 * 32 * 64 per row,
but the function it computes (``c[0].sum(axis=(1, 2))[:, :1]`` of a
``[8, 12, 32, 64]`` block of ones) is 12 * 32 = 384 per row; the known
answer here is what the function computes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from vidchapters_tpu_torch.ops._build import I, P, CudaKernel, stream_ptr

KERNEL = CudaKernel("probes", {
    "probe_split_merge": [P, P, I, I, P],
    "probe_dot_2batch": [P, P, P, I, I, I, I, P],
    "probe_dot_1batch": [P, P, P, I, I, I, I, P],
    "probe_scratch": [P, P, I, I, I, P],
    "probe_block_sum": [P, P, I, I, I, I, I, P],
    "probe_lane_slice": [P, P, I, I, P],
    "probe_grid_cells": [P, P, P, I, I, I, P],
})


def _cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA inputs (the kernel), False for CPU ones (the plain
    version); raises on inputs split over devices or not contiguous."""
    dev = ts[0].device
    if any(t.device != dev or not t.is_contiguous() for t in ts):
        raise ValueError("probe inputs must be contiguous and on one device")
    return dev.type == "cuda"


# ---- p1: split and merge of the minor dimension ----

def split_merge_plain(x: torch.Tensor) -> torch.Tensor:
    r, c = x.shape
    return (x.reshape(r, c // 64, 64) * 2.0).reshape(r, c)


def split_merge(x: torch.Tensor) -> torch.Tensor:
    if not _cuda(x):
        return split_merge_plain(x)
    out = torch.empty_like(x)
    KERNEL.launch("probe_split_merge", x.data_ptr(), out.data_ptr(), *x.shape, stream_ptr())
    return out


# ---- p2: a dot with two batch dimensions ----

def dot_2batch_plain(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.einsum("abqd,abmd->abqm", q, c)


def dot_2batch(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if not _cuda(q, c):
        return dot_2batch_plain(q, c)
    return _launch_dot_2batch(q, c)


def _launch_dot_2batch(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch p2's kernel on contiguous inputs of one device."""
    a, b, m, d = c.shape
    if (tuple(q.shape) != (a, b, 1, d) or d % 4 or not 4 <= d <= 128
            or q.dtype != torch.float32 or c.dtype != torch.float32
            or q.data_ptr() % 16 or c.data_ptr() % 16):
        raise ValueError("dot_2batch takes float32 q [A, B, 1, D] and c [A, B, M, D] on "
                         "16-byte boundaries, D a multiple of 4 in [4, 128]")
    out = torch.empty(a, b, 1, m, dtype=torch.float32, device=q.device)
    KERNEL.launch("probe_dot_2batch", q.data_ptr(), c.data_ptr(), out.data_ptr(), a, b, m, d,
                  stream_ptr())
    return out


# ---- p3: a one-batch 3-D dot ----

def dot_1batch_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b)


def dot_1batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _cuda(a, b):
        return dot_1batch_plain(a, b)
    na, r, d = a.shape
    m = b.shape[2]
    out = torch.empty(na, r, m, dtype=torch.float32, device=a.device)
    KERNEL.launch("probe_dot_1batch", a.data_ptr(), b.data_ptr(), out.data_ptr(), na, r, m, d,
                  stream_ptr())
    return out


# ---- p4: scratch that persists across the cells of a sequential grid ----

def scratch_plain(x: torch.Tensor, n_i: int = 2) -> torch.Tensor:
    xs = torch.empty_like(x)
    out = torch.empty_like(x)
    for i in range(n_i):
        for b in range(x.shape[0]):
            if i == 0:
                xs[b] = x[b]
            xs[b] = xs[b] + 1.0
            out[b] = xs[b]
    return out


def scratch(x: torch.Tensor, n_i: int = 2) -> torch.Tensor:
    if not _cuda(x):
        return scratch_plain(x, n_i)
    nb = x.shape[0]
    out = torch.empty_like(x)
    KERNEL.launch("probe_scratch", x.data_ptr(), out.data_ptr(), n_i, nb, x[0].numel(),
                  stream_ptr())
    return out


# ---- p5: a 5-D bfloat16 block sum ----

def block_sum_plain(c: torch.Tensor) -> torch.Tensor:
    return c[-1].float().sum(dim=(1, 2))[:, :1]


def block_sum(c: torch.Tensor) -> torch.Tensor:
    if not _cuda(c):
        return block_sum_plain(c)
    g, r, p, q, s = c.shape
    out = torch.empty(r, 1, dtype=torch.float32, device=c.device)
    KERNEL.launch("probe_block_sum", c.data_ptr(), out.data_ptr(), g, r, p, q, s, stream_ptr())
    return out


# ---- p6: a lane slice 64:128 ----

def lane_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, 64:128].clone()


def lane_slice(x: torch.Tensor) -> torch.Tensor:
    if not _cuda(x):
        return lane_slice_plain(x)
    out = torch.empty(x.shape[0], 64, dtype=x.dtype, device=x.device)
    KERNEL.launch("probe_lane_slice", x.data_ptr(), out.data_ptr(), *x.shape, stream_ptr())
    return out


# ---- p7: per-cell cost of a (12 x 8) grid of [8, 768] . [768, 768] ----

def grid_cells_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n_i = w.shape[0]
    cells = x.view(n_i, x.shape[0] // n_i, 8, -1)
    return torch.einsum("ibrk,iko->ibro", cells, w).reshape(x.shape)


def grid_cells(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not _cuda(x, w):
        return grid_cells_plain(x, w)
    n_i, d, _ = w.shape
    out = torch.empty_like(x)
    KERNEL.launch("probe_grid_cells", x.data_ptr(), w.data_ptr(), out.data_ptr(), n_i,
                  x.shape[0] // n_i, d, stream_ptr())
    return out


class Probe(NamedTuple):
    name: str           # the TPU probe's label
    replaces: str       # file:line of its pl.pallas_call
    fn: Callable
    plain: Callable
    inputs: Callable[[torch.device], List[torch.Tensor]]
    expected: Callable[[List[torch.Tensor]], torch.Tensor]


def _arange(device, *shape):
    n = 1
    for s in shape:
        n *= s
    return torch.arange(n, dtype=torch.float32, device=device).reshape(shape)


PROBES = (
    Probe("reshape_split_minor", "ops_probe_tpu.py:40", split_merge, split_merge_plain,
          lambda dev: [_arange(dev, 8, 768)], lambda xs: xs[0] * 2.0),
    Probe("dot_general_2batch", "ops_probe_tpu.py:58", dot_2batch, dot_2batch_plain,
          lambda dev: [torch.ones(8, 12, 1, 64, device=dev), torch.ones(8, 12, 32, 64, device=dev)],
          lambda xs: torch.full((8, 12, 1, 32), 64.0)),
    Probe("dot_general_1batch_3d", "ops_probe_tpu.py:74", dot_1batch, dot_1batch_plain,
          lambda dev: [torch.ones(12, 8, 64, device=dev), torch.ones(12, 64, 32, device=dev)],
          lambda xs: torch.full((12, 8, 32), 64.0)),
    Probe("scratch_persist_dynidx", "ops_probe_tpu.py:94", scratch, scratch_plain,
          lambda dev: [torch.zeros(4, 8, 128, device=dev)],
          lambda xs: torch.full((4, 8, 128), 2.0)),
    Probe("blockspec_5d_bf16", "ops_probe_tpu.py:111", block_sum, block_sum_plain,
          lambda dev: [torch.ones(3, 8, 12, 32, 64, dtype=torch.bfloat16, device=dev)],
          lambda xs: torch.full((8, 1), 12 * 32.0)),
    Probe("lane_slice_64", "ops_probe_tpu.py:126", lane_slice, lane_slice_plain,
          lambda dev: [_arange(dev, 8, 768)], lambda xs: xs[0][:, 64:128]),
    Probe("grid_cell_overhead", "ops_probe_tpu.py:143", grid_cells, grid_cells_plain,
          lambda dev: [torch.ones(96, 8, 768, device=dev), torch.ones(12, 768, 768, device=dev)],
          lambda xs: torch.full((96, 8, 768), 768.0)),
)


def run_probes(device: str = "cuda") -> Dict[str, Dict]:
    """Every probe on ``device`` against its known answer and its plain
    version: ``{name: {"ok", "max_abs_err", "plain_max_abs_err"}}``. On the
    card, ``grid_cell_overhead`` also carries ``us_per_cell``: p7's time per
    cell of its (weights x row blocks) grid, by CUDA events over 20 launches
    after a warm-up (None on the CPU, where no device time exists)."""
    out = {}
    for pr in PROBES:
        xs = pr.inputs(torch.device(device))
        got = pr.fn(*xs).float().cpu()
        ref = pr.plain(*xs).float().cpu()
        want = pr.expected([x.cpu() for x in xs]).float()
        err = (got - want).abs().max().item()
        out[pr.name] = {"ok": err == 0.0 and tuple(got.shape) == tuple(want.shape),
                        "max_abs_err": err,
                        "plain_max_abs_err": (ref - want).abs().max().item()}
        if pr.name == "grid_cell_overhead":
            x, w = xs
            cells = w.shape[0] * (x.shape[0] // w.shape[0])
            out[pr.name]["us_per_cell"] = (
                _device_ms(lambda: pr.fn(*xs), 20) * 1e3 / cells if x.is_cuda else None)
    return out


def _device_ms(fn: Callable, iters: int) -> float:
    """Per-call device time of ``fn`` in ms, by CUDA events over ``iters``
    calls after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
