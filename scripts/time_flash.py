"""Device time of the flash kernels of the ``edl_tpu_torch`` package on
``sys.path``, at the shapes of the FLAGSHIP step (b 16, s 1024, h 8, hk 2,
d 128; causal, and non-causal for contrast) and of the BERT-base step
(b 32, s 512, h = hk = 12, d 64, non-causal): one JSON line a shape.  It
times as ``scripts/time_group_norm.py`` does and calls only the kernel
wrappers every revision of the port has, so that one call on the card
times two trees alike (in turns: parent, change, change, parent):

    PYTHONPATH=<tree> python scripts/time_flash.py --label parent

The kernels' outputs are checked by ``chip_smoke.py`` phases (b), (f) and
``tests/test_torch_flash_kernels.py``, not here.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.ops import kernel_check as kc
from time_group_norm import cuda_ms  # this script's directory

#: (name, b, s, h, hk, d, causal)
SHAPES = (("flagship_causal", 16, 1024, 8, 2, 128, True),
          ("flagship_full", 16, 1024, 8, 2, 128, False),
          ("bert_base", 32, 512, 12, 12, 64, False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    dev = torch.device("cuda")
    for seed, (name, b, s, h, hk, d, causal) in enumerate(SHAPES):
        q, k, v, do = kc.random_inputs(b * h, b * hk, s, d, seed, dev)
        out, lse = fa.flash_forward_cuda(q, k, v, causal, h, hk)
        delta = (do.float() * out.float()).sum(-1)
        row = {
            "fwd_ms": cuda_ms(lambda: fa.flash_forward_cuda(
                q, k, v, causal, h, hk)),
            "dq_ms": cuda_ms(lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, causal, h, hk)),
            "dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, causal, h, hk)),
        }
        print(json.dumps({"label": args.label, "shape": name, **row,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
