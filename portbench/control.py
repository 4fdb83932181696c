"""Readings for the limits of the comparison that decides ``correct``.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds <s> [--side control|program]

For each seed, one run of the cell in this process with the float32
reference in the program's place (``--side control``, the default) or
with the program itself (``--side program``), each at the cell's own
size; prints a JSON line a seed with the two compared numbers. The limits
in ``limits/<cell>.json`` lie between the program's largest reading over
a dozen seeds and more and the control's smallest. Needs the card, like
``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_factory(spec, workload):
    """The ``program`` argument of ``harness.run_cell`` that puts the
    float32 reference in the program's place."""
    from portbench.check import Control
    from portbench.reference.case import load_case

    def make(case_path, traffic, device, prep):
        entry = spec.entry(traffic["entry"])
        case = load_case(str(case_path))
        return Control(entry, case, prep, traffic, device,
                       entry.chunk(case, prep))

    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import set_cache_dirs
    set_cache_dirs()

    import torch

    from portbench.harness import run_cell
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    make = control_factory(spec, args.workload) \
        if args.side == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run_cell(spec, args.workload, seed, args.seconds, False,
                             program=make)
        line = {k: c["value"] for k, c in result["checks"].items()}
        print(json.dumps(dict(workload=args.workload, side=args.side,
                              seed=seed, correct=result["correct"],
                              attempted=result["attempted"],
                              failed=result["failed"], **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
