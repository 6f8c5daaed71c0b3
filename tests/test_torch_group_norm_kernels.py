"""The port's hand-written CUDA GroupNorm kernels held against their plain
PyTorch versions on the card, and the kernels inside the autograd path.
The kernel tests need a CUDA device and skip without one; the file imports
no JAX, so it runs on a machine with the card and no JAX, without the
suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_group_norm_kernels.py -q -m cuda
"""

import pytest
import torch

from edl_tpu_torch.ops import group_norm as gn
from edl_tpu_torch.ops import kernel_check as kc

#: (b, hw, c, groups): TINY widths (2 channels a group, 8 channels in all),
#: a ragged last slice in the backward (clusters of 4, 513 rows a block),
#: and ResNet-50 sites at a small batch (the stem's backward in fp32 keeps
#: 843 of each block's 2 x 784 rows and reads the rest again)
SMALL = [(3, 30, 8, 4), (2, 64, 16, 4), (2, 49, 96, 32), (5, 2050, 64, 32)]
RESNET = [(2, 12544, 64, 32), (4, 784, 512, 32), (4, 49, 2048, 32)]
#: (b, hw, c, backward, k): a bf16 shape at each cluster size the plan
#: takes, in each direction; the backward at (49, 2048) splits 49 rows 25 +
#: 24, and at (3137, 128) the forward's last block holds 782 rows of 785
CLUSTERS = [(4, 49, 512, False, 1), (4, 196, 1024, False, 2),
            (4, 784, 512, False, 4), (2, 12544, 64, False, 8),
            (4, 3137, 128, False, 4),
            (4, 196, 256, True, 1), (4, 49, 2048, True, 2),
            (4, 784, 256, True, 4), (4, 784, 512, True, 8),
            (2, 12544, 64, True, 16), (2, 3136, 256, True, 16)]
#: (b, hw, c, dtype): rows read again from device memory: twice the stem in
#: bf16 (clusters of 16 keep dy and 119 of x's 1568 rows a block), the fp32
#: stem, and an hw past what a cluster of 16 holds in either direction
REREAD = [(1, 25088, 64, torch.bfloat16), (2, 12544, 64, torch.float32),
          (1, 100000, 64, torch.bfloat16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,c,groups", SMALL + RESNET)
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, b, hw, c,
                                           groups):
    """Forward (y, mean, inv) and backward (dx, dγ/dβ partials) against
    the plain versions, element by element under kernel_check's rule."""
    inputs = kc.gn_random_inputs(b, hw, c, 0, cuda_device, dtype)
    readings, _ = kc.gn_compare(*inputs, groups)
    assert not kc.failures(readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,backward,k", CLUSTERS)
def test_each_cluster_size_matches_plain_versions(cuda_device, b, hw, c,
                                                  backward, k):
    plan = gn.cluster_plan(hw, c, 2, backward)
    assert plan[0] == k
    assert gn.active_clusters(c, torch.bfloat16, backward, plan) > 0
    inputs = kc.gn_random_inputs(b, hw, c, 4, cuda_device)
    readings, _ = kc.gn_compare(*inputs, 32)
    assert not kc.failures(readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,dtype", REREAD)
def test_rows_read_again_match_plain_versions(cuda_device, b, hw, c, dtype):
    item = torch.finfo(dtype).bits // 8
    k, rows, resident = gn.cluster_plan(hw, c, item, True)
    assert resident < 2 * rows  # the backward reads x again
    inputs = kc.gn_random_inputs(b, hw, c, 5, cuda_device, dtype)
    readings, _ = kc.gn_compare(*inputs, 32)
    assert not kc.failures(readings), readings


@pytest.mark.cuda
def test_autograd_path_launches_the_kernels_once_each(cuda_device):
    x, dy, scale, bias = kc.gn_random_inputs(2, 49, 64, 1, cuda_device)
    x4 = x.view(2, 7, 7, 64).requires_grad_()
    sc, bi = scale.requires_grad_(), bias.requires_grad_()
    gn.reset_launches()
    y = gn.group_norm(x4, sc, bi, 32)
    y.backward(dy.view(2, 7, 7, 64))
    assert gn.launches == {"group_norm_fwd": 1, "group_norm_bwd": 1}
    ref_dx, ref_dg, ref_db = gn.group_norm_bwd_plain(
        x, dy, scale.detach(), *gn.group_norm_fwd_cuda(
            x, scale.detach(), bias.detach(), 32, 1e-5)[1:], 32)
    assert not kc.failures({"dx": kc.bf16_reading(x4.grad.view_as(x),
                                                  ref_dx)})
    torch.testing.assert_close(sc.grad, ref_dg.sum(0), rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(bi.grad, ref_db.sum(0), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_plain_knob_launches_nothing(cuda_device, monkeypatch):
    x, dy, scale, bias = kc.gn_random_inputs(2, 49, 64, 2, cuda_device)
    monkeypatch.setenv("EDL_GN_PALLAS", "0")
    gn.reset_launches()
    gn.group_norm(x.view(2, 7, 7, 64), scale, bias, 32)
    assert gn.launches == {"group_norm_fwd": 0, "group_norm_bwd": 0}
    monkeypatch.delenv("EDL_GN_PALLAS")
    gn.group_norm(x.view(2, 7, 7, 64), scale, bias, 32)
    assert gn.launches["group_norm_fwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,dtype", [(4, 3136, 64, torch.bfloat16)]
                         + REREAD[:2])
def test_kernels_give_the_same_bits_every_run(cuda_device, b, hw, c, dtype):
    """Clusters of 2 (forward) and 4 (backward), then clusters of 16 that
    read rows again."""
    inputs = kc.gn_random_inputs(b, hw, c, 3, cuda_device, dtype)
    first = kc.gn_compare(*inputs, 32)[1]
    again = kc.gn_compare(*inputs, 32)[1]
    for name, t in first.items():
        assert torch.equal(t, again[name]), name


def test_every_group_norm_fault_edits_the_kernel_source_once():
    from edl_tpu_torch.ops import _build

    names = [n for n, f in kc.FAULTS.items() if f[0] == "group_norm"]
    assert len(names) == 6
    code = (_build.CSRC / "group_norm.cu").read_text()
    for name in names:
        assert code.count(kc.FAULTS[name][2]) == 1, name
