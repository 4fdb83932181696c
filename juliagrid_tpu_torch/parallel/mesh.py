"""A one-axis device mesh over ``torch.distributed`` ranks, and a launcher.

The counterpart of the JAX package's ``jax.sharding.Mesh(devices, (axis,))``
(``parallel/batch.py::scenario_mesh``): where JAX runs one program over the
devices of a mesh, the port runs one process per rank, each on its own
device, and the ranks meet in collectives. ``Mesh`` holds a one-dimensional
``torch.distributed.device_mesh.DeviceMesh`` with the axis as its dimension
name, the axis's process group, its size (``mesh.shape[axis]``, by name as
in JAX: a ``DeviceMesh``'s ``shape`` is a positional tuple), this rank's
index and this rank's ``torch.device``. The sharded solvers use two
collectives only, ``all_reduce`` and ``barrier`` (gloo offers these and
``broadcast`` on CUDA tensors, no more), so one code serves both backends.

Backends, by a fixed rule (``launch``):

* ``"nccl"``: one rank per card (world size up to the card count, a world
  of one on one card included);
* ``"gloo"``: ranks on the CPU, and several ranks that share one card.
  NCCL refuses two ranks on one GPU; gloo takes CUDA tensors for
  ``all_reduce`` and ``broadcast`` and reduces them on the host.

``launch(fn, n_ranks, backend, device, args)`` starts the ranks with
``torch.multiprocessing`` (spawn), rendezvouses them through a ``file://``
store in a fresh temporary directory (so concurrent launches never share a
port), and runs ``fn(mesh, *args)`` on each. A rank that raises, or a launch
that outlives its deadline, raises in the caller; every rank is stopped.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device
from ..utils.profiling import mark

BACKENDS = ("nccl", "gloo")

#: this process's device, set by ``launch`` in each rank it starts
_rank_device: torch.device | None = None


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group: "
            "run the ranks through juliagrid_tpu_torch.parallel.mesh.launch, "
            "or call torch.distributed.init_process_group(backend, "
            "init_method=..., world_size=..., rank=...) in each of them "
            "first")


class Mesh:
    """One named axis over every rank of the process group, with this
    rank's device: a one-dimensional ``DeviceMesh`` (the default group's
    ranks, ``mesh_dim_names=(axis,)``) and its group."""

    def __init__(self, axis: str, device):
        _require_group()
        self.axis = axis
        self.axis_names = (axis,)
        self.device = torch.device(device)
        self.device_mesh = DeviceMesh(self.device.type,
                                      list(range(dist.get_world_size())),
                                      mesh_dim_names=(axis,))
        self.group = self.device_mesh.get_group(axis)
        self.size = self.device_mesh.size(0)
        self.rank = self.device_mesh.get_local_rank(axis)
        self.backend = dist.get_backend(self.group)
        #: the axis sizes by name, as ``jax.sharding.Mesh.shape``
        self.shape = {axis: self.size}

    def __repr__(self):
        return (f"Mesh({self.axis!r}: {self.size}, rank {self.rank}, "
                f"{self.backend}, {self.device})")

    def renamed(self, axis: str) -> "Mesh":
        """The same ranks and devices under another axis name (the JAX
        package builds a ``scenario`` and a ``block`` mesh over one set of
        devices)."""
        return Mesh(axis, self.device)

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """``tensor`` reduced in place over the axis (``"sum"`` or
        ``"max"``) and returned; every rank gets the same bits. Marked as
        the stage ``all-reduce`` for ``utils.profiling.device_stages``."""
        mark("all-reduce")
        dist.all_reduce(tensor, {"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return tensor

    def barrier(self):
        dist.barrier(group=self.group)

    def any(self, flags: torch.Tensor) -> bool:
        """True where any rank's ``flags`` holds a True: one all-reduce
        (max) and one readback, the same answer on every rank."""
        hit = flags.any().to(torch.int32).reshape(1)
        return bool(self.all_reduce(hit, "max").item())

    def rows(self, count: int) -> slice:
        """This rank's contiguous share of ``count`` rows; ``count`` must
        divide by the axis size, as a JAX ``NamedSharding`` of the leading
        axis requires."""
        if count % self.size:
            raise ValueError(
                f"{count} rows do not divide over the {self.size} ranks of "
                f"mesh axis {self.axis!r}")
        per = count // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def scenario_mesh(n_devices: int | None = None, axis: str = "scenario",
                  device=None) -> Mesh:
    """The one-axis mesh over every rank of the initialized process group
    (``parallel/batch.py::scenario_mesh`` of the JAX package). ``device``
    defaults to the device ``launch`` gave this rank, else to
    ``config.device`` (the card, as this rank's current CUDA device).
    ``n_devices``, where given, must be the world size: a mesh spans every
    rank. Raises without a process group: it never makes one of its
    own."""
    _require_group()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, "
                         f"world size {world}")
    if device is None and _rank_device is not None:
        device = _rank_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis, dev)


def backend_for(n_ranks: int, device) -> str:
    """The backend rule: gloo on the CPU; on cards, nccl while there is a
    card per rank, gloo for ranks that share a card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def _device_of_rank(device: torch.device, backend: str, rank: int):
    """Rank ``rank``'s device: the CPU, card ``rank`` under nccl, and under
    gloo card ``rank`` modulo the card count (all ranks on card 0 of a
    one-card machine)."""
    if device.type == "cpu":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check(n_ranks: int, backend: str, device: torch.device):
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be at least 1, got {n_ranks}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs ranks on cards; pass "
                             "device='cuda' or backend='gloo'")
        cards = torch.cuda.device_count()
        if n_ranks > cards:
            raise ValueError(
                f"nccl takes one rank per card: {n_ranks} ranks, {cards} "
                "cards; ranks that share a card run with backend='gloo'")


def _rank_main(rank, fn, n_ranks, backend, device, root, timeout, args):
    """One rank: join the group, run ``fn(mesh, *args)``, save its result
    for the caller. An exception propagates (torch.multiprocessing reports
    it to the caller, which stops the other ranks)."""
    global _rank_device
    dev = _device_of_rank(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _rank_device = dev
    dist.init_process_group(
        backend, init_method=f"file://{root}/rendezvous",
        world_size=n_ranks, rank=rank, timeout=timedelta(seconds=timeout))
    out = fn(Mesh("scenario", dev), *args)
    torch.save(out, Path(root) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def _thread_share(n_ranks: int):
    """The ranks share the host's cores: each starts with its share as
    ``OMP_NUM_THREADS`` (unless the caller set one), or their CPU threads
    spin against each other's in every collective. (Set in the
    environment the ranks inherit: ``torch.set_num_threads`` inside a rank
    breaks MKL's batched LU on some CPU builds.)"""
    key = "OMP_NUM_THREADS"
    if key in os.environ:
        yield
        return
    os.environ[key] = str(max(1, (os.cpu_count() or 1) // n_ranks))
    try:
        yield
    finally:
        del os.environ[key]


def launch(fn, n_ranks: int, backend: str | None = None, device=None,
           args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned processes, ``mesh``
    a ``scenario`` axis over all of them, and return each rank's result in
    rank order (results are pickled through a file: move tensors to the
    CPU first where the caller has no card). ``device`` defaults to
    ``config.device`` (the card; CUDA without a card raises), ``backend``
    to ``backend_for``'s rule. ``fn`` must be importable by name (a
    module-level function). ``timeout`` bounds the whole launch, and each
    collective through the process group's own timeout; past it, or when a
    rank raises, every rank is stopped and this raises."""
    dev = resolve_device(device)
    backend = backend or backend_for(n_ranks, dev)
    _check(n_ranks, backend, dev)
    with tempfile.TemporaryDirectory(prefix="jgt-mesh-") as root, \
            _thread_share(n_ranks):
        ctx = mp.start_processes(
            _rank_main, args=(fn, n_ranks, backend, dev, root, timeout,
                              tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(
                    f"mesh launch of {n_ranks} {backend} ranks on {dev} did "
                    f"not finish within {timeout} s; every rank was stopped")
        return [torch.load(os.path.join(root, f"rank{rank}.pt"),
                           weights_only=False) for rank in range(n_ranks)]
