"""K2 ``fleet_solve``: a fleet of dense f64 solves ``A x = b`` in one launch.

The scenario fleets' Newton-Raphson step (``powerflow/ac.py::_nr_update``)
and Gauss-Newton step (``estimation/acse.py::_solve_normal``) each solve one
dense f64 system per scenario. The JAX package does it per scenario under
``jax.vmap`` with an f32 LU and f64 refinement
(``juliagrid_tpu/ops/linalg.py:147-162``, ``estimation/acse.py:671``); the
port solves in f64 directly. Two wrappers, one kernel:

- ``fleet_lu_solve(a, b, *, lu=None, piv=None) -> (x, info)``: partial
  pivoting as getrf does it, ``info`` LAPACK's (0, or the 1-based index of
  the first zero pivot); a singular scenario comes out inf or NaN and
  leaves the others untouched. The factors and the 1-based pivots are
  written into ``lu`` and ``piv`` when they are given.
- ``fleet_cholesky_solve(g, b) -> (x, info)``: a symmetric positive
  definite ``g`` without pivoting, of which only the lower triangle is
  read (as ``cholesky_ex`` reads it), ``info`` the first pivot that is not
  positive.

Which solver runs at which order is decided here, for every call site. A
CUDA tensor of order 1 to ``CAP`` goes to the kernel (``csrc/fleet_solve.cu``,
which describes its mapping and what bounds it: a block a scenario; the
Cholesky and the LU up to ``THREADS`` keep the working matrix in device
memory and stage a panel of ``PANEL`` columns in shared memory; the LU above
``THREADS`` streams its first panels so and keeps the trailing matrix in
shared memory once it fits there, one block an SM; ``fleet_plan`` gives the
layout), and the call raises if the kernel does not build or launch. A CPU
tensor, or any other order, goes to the plain versions
``fleet_lu_solve_ref`` (``lu_factor_ex`` + ``lu_solve``) and
``fleet_cholesky_solve_ref`` (``cholesky_ex`` + ``cholesky_solve``), the
library route (cuSOLVER on the card): above ``CAP``, the 10k-bus
Newton-Raphson's getrf and the large estimators' gains.
``fleet_lu_solve.launches`` and ``fleet_cholesky_solve.launches`` count
kernel launches, ``fleet_lu_solve.on_chip`` the LU launches that factored
panels in place in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._build import I64, INT, PTR

#: the largest N K2 takes (``kMaxN``: a thread a row while a panel is
#: factored, two rows a thread)
CAP = 256
#: columns of a panel (``kW`` in csrc/fleet_solve.cu)
PANEL = 32
#: threads of a block (``kThreads``)
THREADS = 128
#: columns of a warp's group of trailing columns (``kCols``)
COLUMNS = 8
#: doubles of the shared region that is first the pivot step's buffers
#: (``PanelSmall``, 355 doubles) and then the warps' U12 blocks, the larger
#: (``kRegion``)
REGION = THREADS // 32 * PANEL * COLUMNS
#: threads of a block of the LU above ``THREADS`` (``kWideThreads``: a
#: thread a row up to ``CAP``), the doubles of its region, and the trailing
#: columns a round of its warps' groups covers
WIDE_THREADS = CAP
WIDE_REGION = WIDE_THREADS // 32 * PANEL * COLUMNS
ROUND = WIDE_THREADS // 32 * COLUMNS
#: dynamic shared memory a block can take on an H100 (227 KB); the card's
#: own figure is queried before a launch
H100_ROOM = 232448


class FleetPlan(NamedTuple):
    """How K2 lays out a scenario of order ``n``: one block a scenario."""

    ld: int             # leading dimension of the first panel in shared
                        # memory
    shared_bytes: int   # dynamic shared memory of a block
    scratch: bool       # whether a launch without factors needs a working
                        # matrix in device memory
    first_on_chip: int  # the first panel factored in place in shared
                        # memory; the panel count where none is


def shared_bytes(n: int) -> int:
    """Dynamic shared memory of an order-``n`` block of the panel layout
    (the Cholesky, the LU up to ``THREADS``): the panel (``PANEL`` columns
    of ``n | 1`` doubles), the shared region, the right-hand side and 1 /
    U's diagonal, then the row permutation, the panel's pivots and info
    (ints)."""
    doubles = PANEL * (n | 1) + REGION + 2 * n
    return 8 * doubles + 4 * (n + PANEL + 1)


def on_chip_bytes(n: int, first: int) -> int:
    """Dynamic shared memory of an order-``n`` block of the LU above
    ``THREADS`` whose panels from ``first`` on are factored in place (a
    block of ``WIDE_THREADS``): the region, the right-hand side and 1 / U's
    diagonal, the matrix area, then the ints. The area holds the on-chip
    matrix (rows and columns ``k = PANEL * first`` to ``n - 1``,
    column-major at leading dimension ``(n - k) | 1``) and the streamed
    panels' staging (panel ``p`` at leading
    dimension ``(n - PANEL p) | 1``; the last, whose trailing update writes
    the on-chip matrix, over the columns that the update's last round
    writes, which holds its stores until every warp is done with it)."""
    m = max(n - PANEL * first, 0)
    area = m * (m | 1)
    rounds = -(-m // ROUND)
    for p in range(first):
        at = (m | 1) * ROUND * (rounds - 1) if p == first - 1 and m else 0
        area = max(area, at + PANEL * ((n - PANEL * p) | 1))
    return 8 * (WIDE_REGION + 2 * n + area) + 4 * (n + PANEL + 1)


def fleet_plan(n: int, room: int = H100_ROOM,
               cholesky: bool = False) -> FleetPlan:
    """K2's layout for order ``n`` in a mode on a device whose blocks take
    ``room`` bytes of dynamic shared memory. The LU above ``THREADS`` keeps
    its working matrix in shared memory from the first panel at which the
    trailing matrix fits there; the Cholesky and the LU up to ``THREADS``
    stage a panel at a time. How many blocks an SM holds is the card's
    answer (``blocks_per_sm``). Raises above ``CAP`` or where a block does
    not fit."""
    if not 1 <= n <= CAP:
        raise ValueError(f"K2 solves orders 1 to {CAP}, not {n}; the "
                         f"wrappers take the plain versions at the others")
    panels = -(-n // PANEL)
    if cholesky or n <= THREADS:
        first, nbytes, scratch = panels, shared_bytes(n), n > PANEL
    else:
        first = next((p for p in range(panels + 1)
                      if on_chip_bytes(n, p) <= room), panels)
        nbytes, scratch = on_chip_bytes(n, first), first > 0
    if nbytes > room:
        raise ValueError(f"K2 cannot hold an order-{n} block ({nbytes} "
                         f"bytes of shared memory) in {room} bytes")
    return FleetPlan(n | 1, nbytes, scratch, first)


def _check(a, b, name):
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"{name}: the matrices must be [B, N, N], got "
                         f"{tuple(a.shape)}")
    if b.shape != a.shape[:2]:
        raise ValueError(f"{name}: the right-hand sides must be "
                         f"{list(a.shape[:2])}, got {list(b.shape)}")
    for what, t in (("matrices", a), ("right-hand sides", b)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: the {what} must be float64, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the {what} must be contiguous")
    if b.device != a.device:
        raise ValueError(f"{name}: the right-hand sides are on {b.device}, "
                         f"the matrices on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{a.device}")
    if a.shape[0] < 1:
        raise ValueError(f"{name}: empty batch {tuple(a.shape)}")


def _launches_k2(a) -> bool:
    """Whether K2 solves the fleet ``a``: a CUDA tensor of order 1 to
    ``CAP``; anything else takes the plain version."""
    return a.device.type == "cuda" and 1 <= a.shape[1] <= CAP


def _check_out(a, lu, piv):
    bsz, n = a.shape[:2]
    for what, t, shape, dtype in (("lu", lu, (bsz, n, n), torch.float64),
                                  ("piv", piv, (bsz, n), torch.int32)):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fleet_lu_solve: {what} must be {dtype} of "
                             f"shape {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"fleet_lu_solve: {what} must be contiguous "
                             f"and on {a.device}")


def fleet_lu_solve(a: torch.Tensor, b: torch.Tensor, *, lu=None, piv=None):
    """``x [B, N]`` and ``info [B]`` (int32) of ``a [B, N, N] x = b [B,
    N]`` by LU with partial pivoting; the factors into ``lu [B, N, N]`` and
    the 1-based pivots into ``piv [B, N]`` (int32) where given."""
    _check(a, b, "fleet_lu_solve")
    _check_out(a, lu, piv)
    if not _launches_k2(a):
        return fleet_lu_solve_ref(a, b, lu=lu, piv=piv)
    x, info = _launch(a, b, lu, piv, cholesky=False)
    n = a.shape[1]
    fleet_lu_solve.launches += 1
    fleet_lu_solve.on_chip += (
        PANEL * _plan(a.device.index, n, False).first_on_chip < n)
    return x, info


fleet_lu_solve.launches = 0
fleet_lu_solve.on_chip = 0


def fleet_cholesky_solve(g: torch.Tensor, b: torch.Tensor):
    """``x [B, N]`` and ``info [B]`` (int32) of ``g [B, N, N] x = b [B, N]``
    for symmetric positive definite ``g``, by Cholesky."""
    _check(g, b, "fleet_cholesky_solve")
    if not _launches_k2(g):
        return fleet_cholesky_solve_ref(g, b)
    x, info = _launch(g, b, None, None, cholesky=True)
    fleet_cholesky_solve.launches += 1
    return x, info


fleet_cholesky_solve.launches = 0


def fleet_lu_solve_ref(a, b, *, lu=None, piv=None):
    """Plain PyTorch K2, LU mode: ``lu_factor_ex`` and ``lu_solve``, the
    port's route before K2 (``linalg.factorize(check=False)`` +
    ``linalg.solve``), so the CPU keeps its bits."""
    lu_, piv_, info = torch.linalg.lu_factor_ex(a)
    x = torch.linalg.lu_solve(lu_, piv_, b.unsqueeze(-1)).squeeze(-1)
    if lu is not None:
        lu.copy_(lu_)
    if piv is not None:
        piv.copy_(piv_)
    return x, info


def fleet_cholesky_solve_ref(g, b):
    """Plain PyTorch K2, Cholesky mode: ``cholesky_ex`` and
    ``cholesky_solve``, the estimators' route before K2."""
    chol, info = torch.linalg.cholesky_ex(g)
    return torch.cholesky_solve(b[..., None], chol)[..., 0], info


LIBRARY = _build.Library(
    "fleet_solve",
    fleet_solve_launch=(INT, [PTR] * 6 + [INT] * 5 + [PTR]),
    fleet_solve_room=(I64, [INT]),
    fleet_solve_shared_bytes=(I64, [INT, INT, I64, PTR]),
    fleet_solve_blocks_per_sm=(INT, [INT, INT, INT]),
    fleet_solve_attributes=(INT, [INT, INT, PTR]),
    fleet_solve_config=(None, [PTR]))


@functools.lru_cache(maxsize=128)
def _plan(device: int, n: int, cholesky: bool) -> FleetPlan:
    """``fleet_plan`` on ``device``, whose room is queried once; the
    library's configuration (threads, panel, cap) and its layout (shared
    bytes, first on-chip panel) must be the plan's."""
    lib = LIBRARY.load()
    config = (ctypes.c_int * 3)()
    lib.fleet_solve_config(config)
    if tuple(config) != (THREADS, PANEL, CAP):
        raise RuntimeError(f"fleet_solve was built for (threads, panel, "
                           f"cap) {tuple(config)}, the wrapper plans "
                           f"{(THREADS, PANEL, CAP)}")
    room = lib.fleet_solve_room(device)
    if room <= 0:
        raise RuntimeError(f"fleet_solve cannot query cuda:{device}")
    plan = fleet_plan(n, room, cholesky)
    first = ctypes.c_int()
    built = (lib.fleet_solve_shared_bytes(n, int(cholesky), room,
                                          ctypes.byref(first)), first.value)
    if built != (plan.shared_bytes, plan.first_on_chip):
        raise RuntimeError(f"fleet_solve lays out order {n} as (shared "
                           f"bytes, first on-chip panel) {built}, the plan "
                           f"{(plan.shared_bytes, plan.first_on_chip)}")
    return plan


def blocks_per_sm(n: int, cholesky: bool = False, device: int = 0) -> int:
    """Blocks (scenarios) of K2's order-``n`` launch in a mode one SM of
    the card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``:
    shared memory, threads and registers)."""
    _plan(device, n, cholesky)
    out = LIBRARY.load().fleet_solve_blocks_per_sm(n, int(cholesky), device)
    LIBRARY.check("fleet_solve_blocks_per_sm", -min(out, 0))
    return out


def kernel_attributes(n: int, cholesky: bool = False) -> tuple:
    """``(registers, local bytes)`` a thread of the kernel of a mode at
    order ``n`` as built (``cudaFuncGetAttributes``; local bytes are what
    ptxas spilled). Orders up to ``THREADS`` have their own kernel, one
    row a thread in the panel's column steps."""
    out = (ctypes.c_int * 3)()
    LIBRARY.check("fleet_solve_attributes", LIBRARY.load()
                  .fleet_solve_attributes(n, int(cholesky), out))
    return out[0], out[1]


def _launch(a, b, lu, piv, cholesky: bool):
    """One K2 launch (``_build.Library.launch``): a block a scenario, the
    working matrix ``lu`` when the factors are asked for, else a scratch
    tensor unless one panel, or shared memory from the first panel on,
    holds the whole matrix."""
    bsz, n = a.shape[:2]
    device = a.device
    plan = _plan(device.index, n, cholesky)
    x = torch.empty((bsz, n), dtype=torch.float64, device=device)
    info = torch.empty(bsz, dtype=torch.int32, device=device)
    work = lu
    if work is None and plan.scratch:
        work = torch.empty_like(a)
    LIBRARY.launch(
        "fleet_solve_launch", device, a.data_ptr(), b.data_ptr(),
        x.data_ptr(), info.data_ptr(),
        None if work is None else work.data_ptr(),
        None if piv is None else piv.data_ptr(), bsz, n, int(lu is not None),
        int(cholesky), device.index)
    return x, info
