"""The multi-process elastic job of ``chip_smoke.py`` phase (s) over NCCL,
one card a rank: two supervisors form a world of 2 on FLAGSHIP (rank r on
``cuda:r``), one is SIGKILLed after step 4, the survivor reforms a world
of 1 from the newest generation, a third joins late and a world of 2 forms
again until the queue drains.  The same gates as (s) hold; the lines
printed are (s)'s, with the backend named.

Under NCCL a survivor's collective does not fail when its peer dies: it
blocks until the process group's timeout (``--timeout-s``), when NCCL's
watchdog ends the process, or until the supervisor's stall watchdog
(the same floor) SIGKILLs it, whichever comes first.  The kill-to-reform
time is bounded by that timeout, where gloo's is not.

    PYTHONPATH=. python scripts/time_multihost.py --timeout-s 30

(needs two cards; measured on a host with four H100s).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

import chip_smoke
from edl_tpu_torch.ops import _build


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="the process groups' timeout and the stall "
                         "watchdog's floor")
    args = ap.parse_args()
    if torch.cuda.device_count() < 2:
        print("time_multihost: needs two CUDA devices", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"{card} x {torch.cuda.device_count()}", flush=True)
    print(f"build: {_build.build():.2f} s", flush=True)
    t0 = time.perf_counter()
    launches = chip_smoke.phase_multihost(card, device="cuda",
                                          timeout_s=args.timeout_s,
                                          n_layers=0)
    print(f"time_multihost: nccl job {time.perf_counter() - t0:.1f} s, "
          f"flash launches {launches}, on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
