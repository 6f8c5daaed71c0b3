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
from edl_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [384, 1024])
def test_cuda_kernels_gqa_at_ring_corners(cuda_device, s, d, causal):
    """GQA 4:1 at s 384 and at FLAGSHIP's s 1024, under the same rule.
    At s 384 the forward's 3 key tiles go once round its 2-stage ring (d
    128) and the dK/dV blocks walk 8, 16 or 24 steps through 3 stages, so
    the causal ones stop part-way through a round; at s 1024 the forward
    walks 8 tiles (4 rounds of 2 stages, 2 rounds and 2 steps of 3).  dQ
    streams 64-key tiles through 4 stages: at s 384 a non-causal block
    walks 6 tiles (the ring wraps once, 2 steps into its second round) and
    the causal q tiles walk 2, 4 (neither wraps) or 6; at s 1024 a
    non-causal block walks 16 tiles (4 whole rounds) and the causal ones 2
    to 16 in steps of 2, ending half-way through a round or at its end."""
    inputs = kc.random_inputs(2 * 4, 2 * 1, s, d, 1, cuda_device)
    readings, _ = kc.compare(*inputs, causal, 4, 1)
    assert not kc.failures(readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernels_repeat_bitwise(cuda_device, causal):
    """Two launches of the forward, of dQ and of dK/dV on the same inputs
    give the same bits: each dQ row and the GQA group's dK/dV sums are
    taken in a fixed order with no atomics."""
    h, hk = 4, 1
    q, k, v, do = kc.random_inputs(2 * h, 2 * hk, 384, 128, 2, cuda_device)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward_cuda(q, k, v, causal, h, hk)
        delta = (do.float() * out.float()).sum(-1)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, h, hk)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, h,
                                       hk)
        runs.append((out, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


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


@pytest.mark.parametrize("kernel",
                         ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_kernels_raise_on_a_length_off_their_tile(kernel):
    """On the CPU, before any launch: every flash kernel takes s % 128 == 0
    (its 128-row tiles) and raises on s 192."""
    assert fa.KERNEL_TILES[kernel] == 128
    q, k, v, do = kc.random_inputs(4, 2, 192, 64, 0, torch.device("cpu"))
    lse = torch.zeros(4, 192)
    with pytest.raises(ValueError, match="s % 128"):
        if kernel == "flash_fwd":
            fa.flash_forward_cuda(q, k, v, True, 2, 1)
        elif kernel == "flash_bwd_dq":
            fa.flash_bwd_dq_cuda(q, k, v, do, lse, lse, True, 2, 1)
        else:
            fa.flash_bwd_dkv_cuda(q, k, v, do, lse, lse, True, 2, 1)
