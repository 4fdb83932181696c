"""Build the port's CUDA sources into shared libraries loaded with ctypes,
and bind the kernel wrappers to them.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers that take
raw device pointers (``tensor.data_ptr()``, or a ctypes struct of them) and
a stream, so the build needs neither PyTorch's headers nor ninja: one
``nvcc`` call of a few seconds per source.

The binding is decided here once for every wrapper under ``kernels/``:

- ``Library`` declares a library's entry points (name -> restype,
  argtypes) where it is loaded, with ``<name>_error_string``, and
  ``Library.launch`` is the one way a launcher is called: on the device of
  its tensors (made current where it is not), with that device's current
  stream as the last argument, and a ``RuntimeError`` naming the entry
  point and the library's error string unless it returns 0.
- ``Table`` caches the tensors a kernel reads through raw pointers:
  keyed by one of them, holding the others (not the key, so that the entry
  goes when the key does), built anew when any held tensor is another
  object, each checked once at the build for its dtype and contiguity.
  ``Struct`` is a ``Table`` mirrored by a C struct, whose address a
  launcher takes.

The library is built at first use into ``build/juliagrid_tpu_torch/`` at the
root of the checkout. Its file name carries a hash of the source, the
headers it includes from ``csrc/`` and the flags, so an edited source or
header builds anew, and a file lock lets concurrent
processes share one build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.utils.weak import WeakIdKeyDictionary

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


#: ctypes kinds of the entry points' parameters: a pointer (a tensor's
#: ``data_ptr()``, a struct's address, a stream), an int, an int64, a double
PTR, INT, I64, F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_double)


class Library:
    """The library built from ``csrc/<name>.cu``, its entry points declared
    once as ``entry=(restype, argtypes)``; ``<name>_error_string`` is
    declared with them. Loaded (built first if need be) at the first
    ``load``, never at import."""

    def __init__(self, name: str, **entries):
        self.name = name
        self.entries = {**entries,
                        f"{name}_error_string": (ctypes.c_char_p, [INT])}
        self.dll = None

    def bind(self, dll: ctypes.CDLL) -> ctypes.CDLL:
        """``dll`` with the entry points' signatures declared on it: this
        library's build, or a copy of its source built otherwise."""
        for entry, (restype, argtypes) in self.entries.items():
            fn = getattr(dll, entry)
            fn.restype, fn.argtypes = restype, list(argtypes)
        return dll

    def load(self) -> ctypes.CDLL:
        """The bound library (``load_library`` once)."""
        if self.dll is None:
            self.dll = self.bind(load_library(self.name))
        return self.dll

    def check(self, entry: str, code: int) -> None:
        """Raise ``RuntimeError`` naming ``entry`` and the library's error
        string unless ``code`` is 0."""
        if code != 0:
            error = getattr(self.load(), f"{self.name}_error_string")
            raise RuntimeError(f"{entry} failed: {error(code).decode()}")

    def launch(self, entry: str, device: torch.device, *args) -> None:
        """Call the launcher ``entry`` with ``args`` and, last, the raw
        handle of ``device``'s current stream, ``device`` current for the
        call (nothing to do when it already is); ``check`` its code."""
        fn = getattr(self.load(), entry)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        self.check(entry, code)


class Entry:
    """One table in a ``Table``'s cache: the tensors it holds, its struct
    and the struct's address (None without one), and ``extra``, what its
    wrapper derives from it once (None until then)."""

    __slots__ = ("held", "struct", "address", "extra")

    def __init__(self, held: tuple, struct):
        self.held, self.struct = held, struct
        self.address = None if struct is None else ctypes.addressof(struct)
        self.extra = None


class Table:
    """Tensors a kernel reads through raw pointers, each of the dtype
    ``dtypes`` names for it (field name -> dtype), cached per table."""

    def __init__(self, name: str, dtypes: dict):
        self.name, self.dtypes = name, dtypes
        self.cache = WeakIdKeyDictionary()

    def get(self, key: str, tensors: dict, **ints) -> Entry:
        """The entry of the table ``tensors`` (field name -> tensor),
        keyed by its field ``key`` and holding the others; built anew when
        one of them is another object than the entry holds. A build
        checks every tensor's dtype and contiguity (``TypeError`` naming
        the field); ``ints`` go into the struct."""
        held = list(tensors.values())
        del held[list(tensors).index(key)]
        entry = self.cache.get(tensors[key])
        if entry is None or len(entry.held) != len(held) or not all(
                map(operator.is_, entry.held, held)):
            for name, t in tensors.items():
                want = self.dtypes[name]
                if t.dtype != want or not t.is_contiguous():
                    raise TypeError(f"{self.name}.{name} must be contiguous "
                                    f"{want}, got {t.dtype} of strides "
                                    f"{t.stride()}")
            entry = Entry(tuple(held), self.build(tensors, ints))
            self.cache[tensors[key]] = entry
        return entry

    def build(self, tensors: dict, ints: dict):
        """The struct of a checked table: none for a plain ``Table``."""
        return None


class Struct(Table):
    """A ``Table`` mirrored by the C struct ``name`` of ``csrc/``: the
    dtypes' fields as pointers in their order, then ``ints``, each a name
    (an ``int``) or ``(name, k)`` (an ``int[k]``). A field the table does
    not give, or an empty tensor, is a null pointer."""

    def __init__(self, name: str, dtypes: dict, ints: tuple):
        super().__init__(name, dtypes)
        fields = [(field, PTR) for field in dtypes] + [
            (i, INT) if isinstance(i, str) else (i[0], INT * i[1])
            for i in ints]
        self.struct = type(name, (ctypes.Structure,), {"_fields_": fields})

    def build(self, tensors: dict, ints: dict):
        return self.struct(**{name: t.data_ptr() if t.numel() else None
                              for name, t in tensors.items()}, **ints)
