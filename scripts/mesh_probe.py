#!/usr/bin/env python3
"""What the mesh's transports do with ranks that share one card.

Run from the root of a checkout, on a machine with one card or more:

    python3 scripts/mesh_probe.py [--ranks R] [--mib M]

It starts ``R`` gloo ranks on card 0 through ``parallel/mesh.py::launch``
and, in each, checks that gloo's ``all_reduce`` (sum and max) and
``broadcast`` take CUDA tensors and give every rank the same bits; times
a sum of ``M`` MiB of f64 on the card (CUDA events, the median of 5 after
a warm-up); and prints the ``torch.distributed.device_mesh.DeviceMesh``
that each rank's mesh built over the gloo group. Then a world of one over
NCCL on card 0 does the same sum. Prints the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from juliagrid_tpu_torch.parallel.mesh import launch  # noqa: E402


def probe(mesh, mib):
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend}
    x = torch.full((4,), float(mesh.rank + 1), dtype=torch.float64,
                   device=dev)
    out["sum"] = mesh.all_reduce(x.clone()).tolist()
    out["max"] = mesh.all_reduce(x.clone(), "max").tolist()
    bcast = x.clone()
    dist.broadcast(bcast, 0, group=mesh.group)
    out["broadcast"] = bcast.tolist()
    big = torch.randn(mib * 2**17, dtype=torch.float64, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    mesh.all_reduce(big.clone())
    times = []
    for _ in range(5):
        buf = big.clone()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        mesh.barrier()
        start.record()
        mesh.all_reduce(buf)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["ms"] = sorted(times)[2]
    out["checksum"] = float(buf.sum())
    dm = mesh.device_mesh
    out["device_mesh"] = (f"{dm.device_type}: shape {tuple(dm.shape)} "
                          f"(positional), names {dm.mesh_dim_names}")
    dist.barrier()
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mib", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: this probe needs one")
    for n, backend in ((args.ranks, "gloo"), (1, "nccl")):
        outs = launch(probe, n, backend=backend, device="cuda",
                      args=(args.mib,), timeout=300.0)
        same = all(o["sum"] == outs[0]["sum"] and o["max"] == outs[0]["max"]
                   and o["checksum"] == outs[0]["checksum"] for o in outs)
        for o in outs:
            print(f"{backend} rank {o['rank']} on {o['device']}: sum "
                  f"{o['sum'][0]!r}, max {o['max'][0]!r}, broadcast "
                  f"{o['broadcast'][0]!r}; all_reduce of {args.mib} MiB "
                  f"{o['ms']!r} ms; DeviceMesh {o['device_mesh']}")
        print(f"{backend}: {n} ranks, every rank the same bits: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
