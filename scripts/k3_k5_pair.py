#!/usr/bin/env python3
"""K3 (``se_fill``, dense and routed) and K5 (``schur_gather``) timed on
the shapes of the port's main paths, for one checkout of the package.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k3_k5_pair.py [--root DIR]

``--root`` names the checkout whose ``juliagrid_tpu_torch`` and
``chip_smoke.py`` are used (this one by default), so that an older tree
unpacked into ``build/`` (``git archive``) is timed by the same script in
the same call. The bounds and timers come from that tree's
``chip_smoke.py`` (``bound``, ``tensor_bytes``, ``k5_bound``; ``cuda_ms``,
``queued_ms``, ``host_us``, ``graph_nodes``), counted over the same
tensors as its phases 5, 13 and 15; an older tree lacks the last two
timers and a ``k5_bound`` that leaves out the base where a call passes
none (the estimators'), and gets copies. Compare two trees only within
one call, in turns (old, new, new, old): host times move 30-50% between
processes.

Shapes: K3 with the Jacobian on case14test and case30test (every row
type, B = 8), case118 (bench config 4's set, B = 1, and B = 1024), the
1,369-bus grid (B = 1 and B = 32); K3's routed mode on the 1,369-bus set
at k = 8 and on the 10k and 25k zero-noise sets at k = 16; K5 on the 10k
and 25k NR layouts (a border block, scale -1) and on the three SE borders
(no base, scale 1). For each it prints:

- ``cuda_ms``: CUDA events around back-to-back calls, as ``chip_smoke.py``
  times a kernel (the host's launch path between calls included);
- ``queued_ms``: the device time of one call, the calls enqueued behind a
  sleep kernel so that the host leaves no gap between them;
- ``host_us``: the host's µs per call while the card is held busy;
- the bound (ms, and what sets it) and the share ``bound / queued_ms``;
- ``ops``: the kernels, memsets and memcpys one call puts on the card
  (the nodes of a CUDA graph that captured it);
- for K3, ``H.zero_()``: the device time of zeroing a tensor of H's size
  with PyTorch's fill, the write of H alone;
- ``sha``: a digest of the outputs, equal between two trees that give the
  same bits;

K3 also without the Jacobian (``lean``); for a tree whose K5 has two
kernels, K5 also through the kernel its rule did not pick (``by_rows``),
with the bits of both compared. Then the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPS = 20


def _host_us(fn, reps):
    """``chip_smoke.host_us``, for a tree whose smoke run lacks it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000 * reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def _graph_nodes(fn):
    """``chip_smoke.graph_nodes``, for a tree whose smoke run lacks it."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    cuda.cuGraphGetNodes(handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    return kinds


class Timers:
    """The timing helpers of the tree's ``chip_smoke.py``; an older tree's
    lacks ``host_us`` and ``graph_nodes``, and gets the copies above."""

    def __init__(self, cs):
        self.cs = cs
        self.host = getattr(cs, "host_us", _host_us)
        self.nodes = getattr(cs, "graph_nodes", _graph_nodes)

    def lone_ms(self, fn):
        return self.cs.cuda_ms(fn, REPS)

    def queued_ms(self, fn):
        return self.cs.queued_ms(fn, REPS)

    def host_us(self, fn):
        return self.host(fn, REPS)

    def device_ops(self, fn):
        """``kernels/memsets/memcpys`` one call puts on the card."""
        kinds = self.nodes(fn)
        return f"{kinds.count(0)}/{kinds.count(2)}/{kinds.count(1)}"


def k5_bound(cs, route, base):
    """``chip_smoke.k5_bound`` of the tree; for a tree whose ``k5_bound``
    counts reading a base on every call, the same count from ``bsel``,
    with the base read only where the call passes one."""
    try:
        return cs.k5_bound(route, base=base)
    except TypeError:
        real = (route.bsel < route.nb).sum(dim=1)
        sources = int((real * real).sum() + real.sum())
        border = 8 * (route.nb * route.nb + route.nb)
        return cs.bound(8 * sources + cs.tensor_bytes(route.bsel)
                        + (2 if base else 1) * border, 2 * sources)


def digest(tensors):
    """A digest of the tensors' bits, taken on the card (two wrapping
    integer sums of the 64-bit words a tensor, in chunks)."""
    sums = []
    for t in tensors:
        if t is None:
            continue
        bits = t.contiguous().view(torch.int64).flatten()
        for chunk in bits.split(1 << 26):
            sums += [int(chunk.sum()), int((chunk ^ (chunk >> 17)).sum())]
    return hashlib.sha256(repr(sums).encode()).hexdigest()[:16]


def report(timers, kind, label, fn, least, lean=None, zero=None):
    """Print one shape's line; ``zero``: a tensor of H's size, whose
    ``zero_()`` is timed beside the call."""
    out = fn()
    torch.cuda.synchronize()
    sha = digest(out)
    del out
    dev = timers.queued_ms(fn)
    text = (f"{kind} {label}: cuda_ms {timers.lone_ms(fn)!r}, queued_ms "
            f"{dev!r}, host_us {timers.host_us(fn)!r}, bound {least[0]!r} "
            f"ms by {least[1]}, share {least[0] / dev:.3f}")
    if zero is not None:
        text += f"; H.zero_() queued_ms {timers.queued_ms(zero.zero_)!r}"
    if lean is not None:
        text += (f"; lean cuda_ms {timers.lone_ms(lean)!r}, queued_ms "
                 f"{timers.queued_ms(lean)!r}, host_us "
                 f"{timers.host_us(lean)!r}, ops {timers.device_ops(lean)}")
    print(f"{text}; ops {timers.device_ops(fn)} (kernels/memsets/memcpys); "
          f"sha {sha}", flush=True)


def other_kernel(timers, k5, label, route, call):
    """A tree with two K5 kernels: ``call(route)`` through the one its
    rule did not pick (a copy of the route with ``by_rows`` flipped and
    its own ``slot_ptr``, so that its tables are its own), timed and held
    to the picked one's bits."""
    if "by_rows" not in k5.SchurRoute._fields:
        return
    other = route._replace(slot_ptr=route.slot_ptr.clone(),
                           by_rows=not route.by_rows)
    want = call(route)
    got = call(other)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = timers.queued_ms(lambda: call(other))
    kind = "row" if other.by_rows else "merge"
    print(f"K5 {label} through the {kind} kernel: queued_ms {ms!r}, same "
          f"bits {same}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from juliagrid_tpu_torch import (add_varmeter, add_voltmeter,
                                     add_wattmeter, measurement,
                                     newton_raphson_bbd, power_flow_bbd)
    from juliagrid_tpu_torch.estimation.acse_bbd import gauss_newton_bbd
    from juliagrid_tpu_torch.kernels import _build
    from juliagrid_tpu_torch.kernels import schur_gather as k5
    from juliagrid_tpu_torch.kernels import se_fill as k3
    from juliagrid_tpu_torch.postprocessing import ac as ac_post
    from juliagrid_tpu_torch.powerflow.newton_bbd import compile_nr_bbd
    from juliagrid_tpu_torch.utils.synthetic import synthetic_grid
    print(f"tree {root}", flush=True)
    _build.load_library("se_fill"), _build.load_library("schur_gather")
    timers = Timers(cs)
    rng = np.random.default_rng(cs.SEED)

    # K3 dense
    def dense(label, system, mon, pf, batch):
        arr, net, _, (vm, va, mean) = cs.k3_inputs(system, mon, pf, batch,
                                                   rng)
        got = k3.se_fill(arr, net, vm, va, mean)
        least = cs.bound(
            cs.tensor_bytes(arr.desc.idx, arr.desc.coef, arr.status,
                            net.row_ptr, net.cols, net.yg, net.yb, net.diag,
                            vm, va, mean, *got),
            batch * mean.shape[1] * cs.K3_OPS_PER_ROW)
        jac = got.jac
        del got
        report(timers, "K3", f"{label} B={batch} m={mean.shape[1]}",
               lambda: k3.se_fill(arr, net, vm, va, mean), least,
               lambda: k3.se_fill(arr, net, vm, va, mean, jacobian=False),
               zero=jac)

    for case in ("case14test", "case30test"):
        system, pf = cs.solved_case(case)
        dense(case, system, cs.every_row_type(system, pf), pf, 8)
    system = cs.power_system(str(cs.DATA / "case118.m"))
    mon, pf = cs.scada_pmu(system)
    dense("case118 (config 4's set)", system, mon, pf, 1)
    dense("case118", system, mon, pf, cs.SE_FLEET)
    grid = synthetic_grid(*cs.SE_GRID)
    mon_1369, pf = cs.scada_pmu(grid)
    dense("1,369-bus", grid, mon_1369, pf, 1)
    dense("1,369-bus", grid, mon_1369, pf, cs.SE_CHUNK)
    torch.cuda.empty_cache()

    # K3 routed and K5 on the SE borders
    def routed(label, se):
        sb = se._bbd
        arr, route, net = sb.base, sb.route, sb.net
        vm, va = se._state()
        scale = arr.w.sqrt()
        got = k3.se_fill_routed(arr, net, route, vm, va, scale)
        least = cs.bound(
            cs.tensor_bytes(arr.desc.idx, arr.desc.coef, arr.status,
                            arr.mean, net.row_ptr, net.cols, net.yg, net.yb,
                            net.diag, route.row_block, route.row_slot,
                            route.colmap, scale, vm, va, *got),
            arr.mean.numel() * cs.K3_OPS_PER_ROW)
        jac = got.jac
        del got
        report(timers, "K3 routed", f"{label} m={arr.mean.numel()}",
               lambda: k3.se_fill_routed(arr, net, route, vm, va, scale),
               least, zero=jac)
        del jac
        k, width = sb.schur.bsel.shape
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        contrib = torch.randn((k, width, width), generator=gen,
                              dtype=torch.float64, device="cuda")
        parts = torch.randn((k, width), generator=gen, dtype=torch.float64,
                            device="cuda")
        label = f"{label} SE border nb={sb.schur.nb} k={k} L={width}"
        report(timers, "K5", label,
               lambda: k5.schur_gather(sb.schur, contrib, parts),
               k5_bound(cs, sb.schur, base=False))
        other_kernel(timers, k5, label, sb.schur,
                     lambda route: k5.schur_gather(route, contrib, parts))

    routed("1,369-bus k=8", gauss_newton_bbd(mon_1369, n_blocks=8,
                                             device="cuda"))
    for label, shape in (("10k", cs.GRID), ("25k", cs.BBD_GRID)):
        system = synthetic_grid(*shape)
        nr = newton_raphson_bbd(system, n_blocks=cs.BBD_BLOCKS,
                                device="cuda")
        power_flow_bbd(nr)
        ac_post.power(nr)
        ac_post.current(nr)
        mon = measurement(nr.system)
        for add in (add_voltmeter, add_wattmeter, add_varmeter):
            add(mon, analysis=nr, noise=False)
        routed(f"{label} k={cs.BBD_BLOCKS}",
               gauss_newton_bbd(mon, n_blocks=cs.BBD_BLOCKS, device="cuda"))
        del nr, mon
        torch.cuda.empty_cache()

        # K5 on the NR layout (chip_smoke's phase 13 inputs)
        arr, _ = compile_nr_bbd(system, cs.BBD_BLOCKS, "cuda")
        route = arr.schur
        k, width = route.bsel.shape
        nb = route.nb
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

        def randn(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float64,
                               device="cuda")

        contrib, parts = randn(k, width, width), randn(k, width)
        a_bb, r_bb = randn(nb, nb), randn(nb)

        def call(route=route):
            return k5.schur_gather(route, contrib, parts, a_bb, r_bb, -1.0)

        label = f"{label} NR layout nb={nb} k={k} L={width}"
        report(timers, "K5", label, call, k5_bound(cs, route, base=True))
        other_kernel(timers, k5, label, route, call)
        del arr, route
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
