"""The port's hand-written CUDA flash kernels held against their plain
PyTorch versions on the card (bf16), and the rule that holds them.  The
kernel tests need a CUDA device and skip without one; the file imports no
JAX, so it runs on a machine with the card and no JAX, without the suite's
conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_flash_kernels.py -q -m cuda
"""

import pytest
import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import kernel_check as kc

#: (h, hk, causal): GQA causal and non-causal, plus an MHA case
CASES = [(4, 2, True), (4, 2, False), (4, 4, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hk,causal", CASES)
def test_cuda_kernels_match_plain_versions(cuda_device, d, h, hk, causal):
    """Each kernel against its plain version on the card, bf16, at a small
    shape, element by element under kernel_check's rule: one bf16 ulp of
    the element plus a floor of 2^-5 of the tensor's RMS."""
    inputs = kc.random_inputs(2 * h, 2 * hk, 256, d, 0, cuda_device)
    readings, _ = kc.compare(*inputs, causal, h, hk)
    assert not kc.failures(readings), readings


def test_the_rule_follows_each_element():
    """On the CPU: a one-ulp difference everywhere passes; a quarter of the
    value lost on the small elements alone (one GQA member of four missing
    where the values are small) fails, though it is far below the largest
    entry."""
    g = torch.Generator().manual_seed(0)
    want = torch.randn(64, 128, generator=g).to(torch.bfloat16)
    want[0, 0] = 8.0
    one_ulp = want.float() * (1 + 2.0 ** -8)
    assert not kc.failures({"x": kc.bf16_reading(one_ulp, want)})
    small = want.float().abs() < 0.5
    dropped = torch.where(small, want.float() * 0.75, want.float())
    assert (dropped - want.float()).abs().max() < 2e-2 * 8.0
    assert kc.failures({"x": kc.bf16_reading(dropped, want)})
    nan = want.float().clone()
    nan[3, 3] = float("nan")
    assert kc.failures({"x": kc.bf16_reading(nan, want)})


def test_every_planted_fault_edits_its_source_once():
    for name, (lib, source, text, planted) in kc.FAULTS.items():
        code = (_build.CSRC / source).read_text()
        assert code.count(text) == 1, name
        assert _build.SOURCES[lib] == source and planted != text
