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
  definite ``g`` without pivoting, ``info`` the first pivot that is not
  positive.

A CUDA tensor goes to the kernel (``csrc/fleet_solve.cu``, which describes
its mapping and what bounds it), and the call raises if the kernel does not
build or launch or if ``N`` is above ``CAP``; a CPU tensor goes to the plain
versions ``fleet_lu_solve_ref`` (``lu_factor_ex`` + ``lu_solve``) and
``fleet_cholesky_solve_ref`` (``cholesky_ex`` + ``cholesky_solve``). Above
``CAP`` the call sites keep ``torch.linalg`` (cuSOLVER on the card): the
10k-bus Newton-Raphson's 20,000² getrf and the large estimators' gains.
``fleet_lu_solve.launches`` and ``fleet_cholesky_solve.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: the largest N K2 takes (a thread a row while a panel is factored)
CAP = 256
#: columns of a panel (``kW`` in csrc/fleet_solve.cu)
PANEL = 16
#: the cluster sizes K2 chooses from, fewest first
CLUSTERS = (1, 2, 4, 8)
#: bytes of the small arrays at the front of a block's shared memory
#: (``kSmallBytes``)
SMALL_BYTES = 3328
#: dynamic shared memory a block can take on an H100 (227 KB); the card's
#: own figure is queried before a launch
H100_ROOM = 232448


class FleetPlan(NamedTuple):
    """How K2 lays out a scenario of order ``n``."""

    cluster: int       # blocks of a scenario's cluster
    panel: int         # columns of a panel
    ld: int            # leading dimension of a column in shared memory
    columns: int       # columns (of the n + 1) of the widest block
    shared_bytes: int  # dynamic shared memory of a block


def block_columns(n: int, cluster: int, rank: int) -> int:
    """Columns of ``[A | b]`` that block ``rank`` holds: the panels
    ``rank, rank + cluster, ...`` of ``PANEL`` columns each, the last one
    short."""
    total = n + 1
    panels = -(-total // PANEL)
    return sum(min(PANEL, total - p * PANEL)
               for p in range(rank, panels, cluster))


def shared_bytes(n: int, cluster: int) -> int:
    """Dynamic shared memory of a block of an ``(n, cluster)`` launch: its
    columns, a copy of another block's panel (``cluster > 1``), the back
    substitution's vector and the reciprocals of U's diagonal, each
    ``n | 1`` doubles long, after the small arrays."""
    columns = max(block_columns(n, cluster, r) for r in range(cluster))
    doubles = (n | 1) * (columns + (PANEL if cluster > 1 else 0) + 2)
    return SMALL_BYTES + 8 * doubles


def fleet_plan(n: int, room: int = H100_ROOM,
               cluster: int | None = None) -> FleetPlan:
    """K2's layout for order ``n`` on a device whose blocks take ``room``
    bytes of dynamic shared memory: the fewest blocks of ``CLUSTERS`` whose
    share fits, unless ``cluster`` is given. Raises above ``CAP`` or where
    nothing fits."""
    if not 1 <= n <= CAP:
        raise ValueError(f"K2 solves orders 1 to {CAP}, not {n}; above "
                         f"{CAP} the call sites keep torch.linalg")
    sizes = CLUSTERS if cluster is None else (cluster,)
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"a K2 cluster has one of {CLUSTERS} blocks, not "
                         f"{cluster}")
    for c in sizes:
        nbytes = shared_bytes(n, c)
        if nbytes <= room:
            columns = max(block_columns(n, c, r) for r in range(c))
            return FleetPlan(c, PANEL, n | 1, columns, nbytes)
    raise ValueError(f"K2 cannot hold an order-{n} matrix in a cluster of "
                     f"{sizes[-1]} blocks of {room} bytes")


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
    if a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"{name}: empty batch {tuple(a.shape)}")
    if a.shape[1] > CAP:
        raise ValueError(f"{name}: order {a.shape[1]} is above K2's cap "
                         f"of {CAP}; the call sites keep torch.linalg there")


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
    if a.device.type == "cpu":
        return fleet_lu_solve_ref(a, b, lu=lu, piv=piv)
    x, info = _launch(a, b, lu, piv, cholesky=False)
    fleet_lu_solve.launches += 1
    return x, info


fleet_lu_solve.launches = 0


def fleet_cholesky_solve(g: torch.Tensor, b: torch.Tensor):
    """``x [B, N]`` and ``info [B]`` (int32) of ``g [B, N, N] x = b [B, N]``
    for symmetric positive definite ``g``, by Cholesky."""
    _check(g, b, "fleet_cholesky_solve")
    if g.device.type == "cpu":
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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fleet_solve")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fleet_solve_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.fleet_solve_launch.restype = i32
    lib.fleet_solve_room.argtypes = [i32]
    lib.fleet_solve_room.restype = ctypes.c_int64
    lib.fleet_solve_active_clusters.argtypes = [i32, i32, i32, i32]
    lib.fleet_solve_active_clusters.restype = i32
    lib.fleet_solve_error_string.argtypes = [i32]
    lib.fleet_solve_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _plan(device: int, n: int, cluster: int | None) -> FleetPlan:
    """``fleet_plan`` on ``device``, whose room is queried once."""
    room = _library().fleet_solve_room(device)
    if room <= 0:
        raise RuntimeError(f"fleet_solve cannot query cuda:{device}")
    return fleet_plan(n, room, cluster)


def active_clusters(n: int, cluster: int | None = None,
                    cholesky: bool = False, device: int = 0) -> int:
    """Clusters of K2's launch at order ``n`` in a mode the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    plan = _plan(device, n, cluster)
    out = _library().fleet_solve_active_clusters(n, plan.cluster,
                                                 int(cholesky), device)
    if out < 0:
        raise RuntimeError("fleet_solve occupancy query failed: "
                           + _library().fleet_solve_error_string(-out)
                           .decode())
    return out


def _launch(a, b, lu, piv, cholesky: bool, cluster: int | None = None):
    """One K2 launch on the current stream of ``a``'s device; ``cluster``
    overrides the plan's cluster size (any size gives the same bits)."""
    bsz, n = a.shape[:2]
    device = a.device
    plan = _plan(device.index, n, cluster)
    x = torch.empty((bsz, n), dtype=torch.float64, device=device)
    info = torch.empty(bsz, dtype=torch.int32, device=device)
    ctx, stream = _build.launch_context(device)
    with ctx:
        err = _library().fleet_solve_launch(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), info.data_ptr(),
            None if lu is None else lu.data_ptr(),
            None if piv is None else piv.data_ptr(), bsz, n, plan.cluster,
            int(cholesky), device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"fleet_solve launch ({'Cholesky' if cholesky else 'LU'}, "
            f"order {n}, {plan.cluster}-block cluster) failed: "
            + _library().fleet_solve_error_string(err).decode())
    return x, info
