#!/usr/bin/env python3
"""Write the numpy-only snapshots of the HDF5 cases in ``tests/data``.

    python3 scripts/make_snapshots.py [case ...]

Each ``tests/data/<case>.h5`` becomes ``tests/data/<case>.npz``
(``juliagrid_tpu_torch/system/snapshot.py``), which
``power_system("....npz")`` loads with numpy alone. The default cases are
``case1354pegase`` and ``case_ACTIVSg10k``. Needs h5py.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from juliagrid_tpu_torch.system.snapshot import h5_to_npz  # noqa: E402

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"


def main(cases):
    for case in cases or ("case1354pegase", "case_ACTIVSg10k"):
        src, dst = DATA / f"{case}.h5", DATA / f"{case}.npz"
        h5_to_npz(str(src), str(dst))
        print(f"{src.name} -> {dst.name} ({dst.stat().st_size} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
