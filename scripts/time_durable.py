"""The durable phases of ``chip_smoke.py`` alone, with their wall time:
phase (k) (the virtual-worker loop's kill, restore and checkpoint drills)
and, where the tree has it, phase (o) (the sharded lineage, fed (k)'s
control and drills).  ``chip_smoke`` is imported from ``sys.path``, so that
one call on the card runs two trees alike (in turns: parent, change,
change, parent):

    PYTHONPATH=<tree> python scripts/time_durable.py --label parent

Every line the phases print is echoed with the label in front, then
``<label> phase (k) <s> s`` (and ``phase (o)``).  The phases raise on a
failed gate, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_durable: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build()

    def run(name: str, fn, *fn_args):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = fn(*fn_args)
        seconds = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            print(f"{args.label} {line}", flush=True)
        print(f"{args.label} phase ({name}) {seconds:.1f} s", flush=True)
        return got

    virtual = run("k", cs.phase_virtual, "card")
    if hasattr(cs, "phase_durable"):
        run("o", cs.phase_durable, "card", virtual["control"],
            virtual["drills"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
