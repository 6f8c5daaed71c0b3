"""Device time of the GroupNorm kernels of the ``edl_tpu_torch`` package on
``sys.path``, at the 12 site shapes of the ResNet-50 step (b 256 x 224²,
bf16, G 32): one JSON line a shape, then the sums over the step's 53
sites.  It keeps its own timing and calls only the kernel wrappers every
revision of the port has, so that one call on the card times two trees
alike (in turns: parent, change, change, parent):

    PYTHONPATH=<tree> python scripts/time_group_norm.py --label parent

The kernels' outputs are checked by ``chip_smoke.py`` phase (e) and
``tests/test_torch_group_norm_kernels.py``, not here.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from edl_tpu_torch.models import resnet
from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import group_norm as gn
from edl_tpu_torch.ops import kernel_check as kc

BATCH, IMAGE = 256, 224
ITERS = 20
#: ~10 ms at the H100's boost clock: the card sleeps while the host queues
#: every timed call, so that a call shorter than its launch cost on the host
#: is timed on the card
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn) -> float:
    """Mean device time of ``fn`` over ``ITERS`` back-to-back calls queued
    behind a device sleep, after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_group_norm: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    dev, groups = torch.device("cuda"), resnet.RESNET50.groups
    sites = resnet.group_norm_sites(resnet.RESNET50, IMAGE)
    step = {"fwd_ms": 0.0, "bwd_ms": 0.0}
    for seed, ((hw, c), count) in enumerate(sorted(sites.items())):
        x, dy, scale, bias = kc.gn_random_inputs(BATCH, hw, c, seed, dev)
        _, mean, inv = gn.group_norm_fwd_cuda(x, scale, bias, groups, 1e-5)
        row = {
            "fwd_ms": cuda_ms(lambda: gn.group_norm_fwd_cuda(
                x, scale, bias, groups, 1e-5)),
            "bwd_ms": cuda_ms(lambda: gn.group_norm_bwd_cuda(
                x, dy, scale, mean, inv, groups)),
        }
        for key, ms in row.items():
            step[key] += count * ms
        print(json.dumps({"label": args.label, "shape": [BATCH, hw, c],
                          "sites": count, **row}), flush=True)
    print(json.dumps({"label": args.label, "per_step": step,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
