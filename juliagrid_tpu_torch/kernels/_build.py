"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher that takes
raw device pointers (``tensor.data_ptr()``, or a ctypes struct of them) and
a stream (``launch_context``), so the build needs neither PyTorch's headers
nor ninja: one ``nvcc`` call of a few seconds per source.

The library is built at first use into ``build/juliagrid_tpu_torch/`` at the
root of the checkout. Its file name carries a hash of the source, the
headers it includes from ``csrc/`` and the flags, so an edited source or
header builds anew, and a file lock lets concurrent
processes share one build.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.profiling import default_timings

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "juliagrid_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")
#: flags of one source on top of NVCC_FLAGS. K3, K4, K6, K7 and K8 are built
#: without fused multiply-add contraction so that they round as their plain
#: versions do (see csrc/se_fill.cu, csrc/gs_sweep.cu, csrc/opf_fill.cu,
#: csrc/kkt_fill.cu and csrc/gain_fill.cu).
SOURCE_FLAGS = {"se_fill": ("-fmad=false",), "gs_sweep": ("-fmad=false",),
                "opf_fill": ("-fmad=false",), "kkt_fill": ("-fmad=false",),
                "gain_fill": ("-fmad=false",)}


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags ``csrc/<name>.cu`` is built with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header it includes from ``csrc/``
    (``#include "..."``, followed into the headers), in a fixed order."""
    seen = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for line in path.read_text().splitlines():
            words = line.split()
            if len(words) >= 2 and words[0] == "#include" and \
                    words[1].startswith('"'):
                todo.append(CSRC / words[1].strip('"'))
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, the headers
    it includes and the flags."""
    key = b"\0".join(p.read_bytes() for p in sources(name)) + b"\0" + \
        "\0".join(nvcc_flags(name)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless already built, and load it. The
    whole load is the span ``kernels.load`` of
    ``utils.profiling.default_timings``, the nvcc run alone
    ``kernels.build``."""
    with default_timings.span("kernels.load"):
        nvcc = nvcc_path()
        so = library_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                with default_timings.span("kernels.build"):
                    res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed with code {res.returncode} building "
                        f"{name}:\n{res.stdout}{res.stderr}")
                os.replace(tmp, so)
        return ctypes.CDLL(str(so))


def launch_context(device: torch.device):
    """``(context, stream)`` for a launch on ``device``: the context makes
    ``device`` current (nothing to do when it already is) and ``stream`` is
    the raw handle of its current stream."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    ctx = (contextlib.nullcontext() if index == current
           else torch.cuda.device(index))
    return ctx, torch._C._cuda_getCurrentRawStream(index)
