"""The feature probes' plain versions (what CPU tensors run) against the
known answers of ``ops_probe_tpu.py``'s ``p1`` ... ``p7``, and the probe
functions of both packages on the same inputs where the JAX probe's own
kernel can run here (interpret mode). The CUDA kernels' test is in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from vidchapters_tpu_torch.ops import probes as pb


@pytest.mark.parametrize("probe", pb.PROBES, ids=lambda p: p.name)
def test_plain_versions_give_the_known_answers(probe):
    xs = probe.inputs(torch.device("cpu"))
    before = pb.KERNEL.launches
    got = probe.fn(*xs)
    assert pb.KERNEL.launches == before  # CPU tensors run the plain version
    want = probe.expected(xs)
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got.float(), want.float())
    assert torch.equal(probe.plain(*xs).float(), want.float())


def test_run_probes_reports_every_probe():
    out = pb.run_probes("cpu")
    assert list(out) == [p.name for p in pb.PROBES]
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in out.values())
    assert out["grid_cell_overhead"]["us_per_cell"] is None  # no device time on the CPU


def test_run_probes_runs_on_the_card_unless_asked():
    import inspect

    assert inspect.signature(pb.run_probes).parameters["device"].default == "cuda"


def test_block_sum_is_the_function_the_tpu_probe_computes():
    """``p5`` sums its [8, 12, 32, 64] block over axes 1 and 2 and keeps
    lane 0: 12 * 32 = 384 per row, as JAX computes the same expression."""
    import jax.numpy as jnp

    c = np.random.default_rng(0).normal(size=(3, 8, 12, 32, 64)).astype(np.float32)
    c = torch.from_numpy(c).to(torch.bfloat16)
    ref = (jnp.asarray(c[2].float().numpy()).sum(axis=(1, 2)))[:, :1]
    np.testing.assert_allclose(pb.block_sum(c).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    ones = torch.ones(3, 8, 12, 32, 64, dtype=torch.bfloat16)
    assert torch.equal(pb.block_sum(ones), torch.full((8, 1), 384.0))


def test_scratch_probe_persists_across_cells():
    x = torch.arange(4 * 8 * 128, dtype=torch.float32).view(4, 8, 128)
    assert torch.equal(pb.scratch(x, n_i=3), x + 3.0)


@pytest.mark.parametrize("fn,args", [
    (pb.dot_2batch, (torch.ones(2, 3, 1, 16), torch.ones(2, 3, 5, 16).to("meta"))),
    (pb.split_merge, (torch.ones(768, 8).t(),)),
])
def test_split_or_strided_inputs_raise(fn, args):
    with pytest.raises(ValueError, match="one device"):
        fn(*args)
