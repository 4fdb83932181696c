"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result's JSON object; the
numbers the comparison with the reference judged, each beside its limit,
are the last lines of standard error. Without CUDA, with fewer cards than
the cell needs, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def set_cache_dirs():
    """Every compile cache inside the checkout, at fixed paths; the port's
    own kernels build into ``build/juliagrid_tpu_torch`` beside these."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import run_cell
    from portbench.spec import Spec

    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, found = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda")
    if found:
        print(f"the process held {', '.join(found)} once the window had "
              "closed", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
