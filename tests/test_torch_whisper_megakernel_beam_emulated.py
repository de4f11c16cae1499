"""The Whisper decode kernel's CUDA source on the CPU: the beam form.

The beam cases of test_torch_whisper_megakernel_emulated.py, which holds the
emulation, the fixtures and the checks (``check_form``): 3 examples x 5
beams (15 rows, two n-tiles of the tensor-core products) at d_ff 2304 on 6
SMs, where fc2's k is split over 2 blocks and merged by the last to arrive;
float32 and bfloat16, cross K/V int8 and unquantized. Skipped where there is
no g++.
"""

import pytest
import torch

from tests.test_torch_whisper_megakernel_emulated import check_form, emulated, kernel  # noqa: F401


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False),
])
def test_whisper_kernel_matches_plain(kernel, monkeypatch, dtype, quant):  # noqa: F811
    check_form(kernel, monkeypatch, dtype, quant, "beam")
