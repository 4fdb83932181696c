"""The binding between the port and its CUDA libraries (``kernels/_build.py``),
on the CPU: no launch is needed.

- Every pointer table a wrapper builds (``_build.Table``/``Struct``) is
  built once for the same tensors, built anew when a tensor it holds is
  another object, gone when its key is, and refused at the build when a
  field has the wrong dtype or is not contiguous.
- Every ctypes struct has its C struct's field names, order and kinds, and
  every declared entry point its ``extern "C"`` definition's parameters
  (count and kinds) and return kind, read from ``csrc/``.
"""

import ctypes
import gc
import re

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.estimation.acse import compile_se_arrays
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels import fleet_solve as k2
from juliagrid_tpu_torch.kernels import gain_fill as k8
from juliagrid_tpu_torch.kernels import gs_sweep as k4
from juliagrid_tpu_torch.kernels import kkt_fill as k7
from juliagrid_tpu_torch.kernels import nr_fill as k1
from juliagrid_tpu_torch.kernels import opf_fill as k6
from juliagrid_tpu_torch.kernels import schur_gather as k5
from juliagrid_tpu_torch.kernels import se_fill as k3
from juliagrid_tpu_torch.opf import acopf
from juliagrid_tpu_torch.opf.kkt_bbd import AcKktBbd
from juliagrid_tpu_torch.powerflow.ac import compile_ac_arrays
from juliagrid_tpu_torch.powerflow.fast_decoupled import compile_fnr_arrays

MODULES = (k1, k2, k3, k4, k5, k6, k7, k8)


def _case14(data_path):
    return jgt.power_system(str(data_path / "case14test.m"))


def _se(data_path):
    system = _case14(data_path)
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True)
    mon = jgt.measurement(system)
    for add in (jgt.add_voltmeter, jgt.add_wattmeter, jgt.add_varmeter):
        add(mon, analysis=pf, noise=False)
    return {"arr": compile_se_arrays(system, mon, device="cpu")[0],
            "net": compile_ac_arrays(system, "cpu")}


def _opf(data_path):
    spec = acopf._AcSpec(_case14(data_path), device="cpu")
    return {"arr": spec.arrays, "tab": AcKktBbd(spec, 3).table}


def _gain():
    host = k8.gain_fill_table([0, 0, 1, 1, 2, 2], [0, 1, 1, 2, 0, 2], 3, 3)
    return {"table": k8.device_table(host, "cpu")}


def _se_route(objs):
    n = objs["net"].row_ptr.numel() - 1
    route = k3.SeRoute(*[None] * len(k3.SeRoute._fields))._replace(
        slot_row=torch.tensor([0, 1, -1, 2], dtype=torch.int32),
        colmap=torch.zeros((2, n), dtype=torch.int32), mr=2, ni=1, lb=1)
    return {**objs, "route": route}


def _k3_routed(o):
    r = o["route"]
    return k3._tables(o["arr"], o["net"], "slot_row",
                      dict(slot_row=r.slot_row, colmap=r.colmap), ni=r.ni,
                      lb=r.lb, mr=r.mr, k=r.colmap.shape[0])


#: each table: (the table, its objects, the wrapper's build of its entry,
#: the key's path, a held tensor's path, the path of the field broken)
TABLES = {
    "K1 mismatch": lambda d: (
        k1._NETWORK, {"arr": compile_fnr_arrays(_case14(d), True, "cpu")},
        lambda o: k1._network(k1._NETWORK, o["arr"]), ("arr", "cols"),
        ("arr", "yb"), ("arr", "bus_type")),
    "K1 dense": lambda d: (
        k1._JACOBIAN_NETWORK, {"arr": compile_ac_arrays(_case14(d), "cpu")},
        lambda o: k1._network(k1._JACOBIAN_NETWORK, o["arr"]),
        ("arr", "cols"), ("arr", "yg"), ("arr", "pos")),
    "K1 routed": lambda d: (
        k1._ROUTED_NETWORK, {"arr": compile_ac_arrays(_case14(d), "cpu")},
        lambda o: k1._network(k1._ROUTED_NETWORK, o["arr"]), ("arr", "cols"),
        ("arr", "p_sched"), ("arr", "row_ptr")),
    "K3 dense": lambda d: (
        k3._Tables, _se(d), lambda o: k3._tables(o["arr"], o["net"], "idx",
                                                {}),
        ("arr", "desc", "idx"), ("net", "yg"), ("arr", "desc", "coef")),
    "K3 entries": lambda d: (
        k3._Tables, _se(d), lambda o: k3._tables(
            o["arr"], o["net"], "epos", dict(epos=o["arr"].desc.epos),
            entries=o["arr"].desc.entries),
        ("arr", "desc", "epos"), ("arr", "desc", "order"), ("net", "diag")),
    "K3 routed": lambda d: (
        k3._Tables, _se_route(_se(d)), _k3_routed, ("route", "slot_row"),
        ("route", "colmap"), ("route", "colmap")),
    "K5": lambda d: (
        k5._Tables, {"route": k5.schur_route(np.array([[0, 1, 3], [1, 2, 3]]),
                                            3, "cpu")},
        lambda o: k5._tables(o["route"]), ("route", "slot_ptr"),
        ("route", "slot_loc"), ("route", "bsel")),
    "K6": lambda d: (
        k6._Tables, _opf(d), lambda o: k6._tables(o["arr"]),
        ("arr", "fill", "row_ptr"), ("arr", "yb"), ("arr", "fill", "item_at")),
    "K7": lambda d: (
        k7._Tables, _opf(d), lambda o: k7._tables(o["tab"], o["arr"]),
        ("tab", "rows"), ("arr", "fill", "fl_y"), ("tab", "dest_off")),
    "K8": lambda d: (
        k8._Tables, _gain(), lambda o: k8._tables(o["table"], None),
        ("table", "nz_ptr"), ("table", "c_a"), ("table", "col_row")),
    "K8 fleet": lambda d: (
        k8._FleetTables, _gain(), lambda o: k8._tables(
            o["table"], k8.fleet_bands(o["table"])),
        ("table", "nz_ptr"), ("table", "c_b"), ("table", "c_w")),
}


def _at(objs, path):
    obj = objs[path[0]]
    for field in path[1:]:
        obj = getattr(obj, field)
    return obj


def _replace(objs, path, fn):
    """``objs`` with the tensor at ``path`` replaced by ``fn`` of it, each
    named tuple on the way ``_replace``d."""
    def sub(obj, fields):
        if not fields:
            return fn(obj)
        return obj._replace(**{fields[0]: sub(getattr(obj, fields[0]),
                                              fields[1:])})
    return {**objs, path[0]: sub(objs[path[0]], path[1:])}


def _strided(t):
    """``t``'s values in a tensor that is not contiguous."""
    return torch.stack([t, t], -1)[..., 0]


@pytest.mark.parametrize("case", list(TABLES))
def test_pointer_tables_are_built_once_a_key_and_go_with_it(data_path, case):
    """Built once for the same tensors; built anew after a held tensor is
    another object; a wrong dtype or a non-contiguous field refused at the
    build, naming it; the entry gone once its key is collected. (K6's and
    K7's cases take over the check that their structs go with their
    layout and spec.)"""
    table, objs, build, key, held, bad = TABLES[case](data_path)
    before = len(table.cache)
    first = build(objs)
    assert build(objs) is first and len(table.cache) == before + 1
    assert all(t is not _at(objs, key) for t in first.held)
    fresh = _replace(objs, held, torch.clone)
    again = build(fresh)
    assert again is not first and build(fresh) is again
    assert any(t is _at(fresh, held) for t in again.held)
    assert len(table.cache) == before + 1
    assert _at(objs, bad).numel() > 1
    for broken in (lambda t: t.to(torch.float32), _strided):
        with pytest.raises(TypeError, match=f"{table.name}\\.{bad[-1]} "
                           "must be contiguous"):
            build(_replace(objs, bad, broken))
    del objs, fresh, first, again
    gc.collect()
    assert len(table.cache) == before


# ---- the declarations against csrc/ ----------------------------------------

def _sources() -> str:
    return "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))


def _enums(src: str) -> dict:
    """Each enumerator of the sources' enums and its value."""
    out = {}
    for body in re.findall(r"enum \w+ \{([^}]*)\}", src):
        for value, name in enumerate(re.findall(r"\w+", body)):
            out[name] = value
    return out


def _c_kind(ctype: str):
    ctype = " ".join(w for w in ctype.split() if w != "const")
    if "*" in ctype:
        return "pointer"
    return {"int": "int", "int64_t": "int64", "long long": "int64",
            "double": "double", "void": None}[ctype]


def _ctypes_kind(ctype):
    if ctype is None:
        return None
    if ctype in (ctypes.c_void_p, ctypes.c_char_p):
        return "pointer"
    if ctype is ctypes.c_double:
        return "double"
    if issubclass(ctype, ctypes.Array):
        return f"int[{ctype._length_}]"
    return {4: "int", 8: "int64"}[ctypes.sizeof(ctype)]


STRUCTS = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": table
           for mod in MODULES for name, table in vars(mod).items()
           if isinstance(table, _build.Struct)}


@pytest.mark.parametrize("name", list(STRUCTS))
def test_structs_mirror_their_c_structs(name):
    """Field names, order and kinds (pointer, int, int array) of each
    ctypes struct against its ``struct`` in ``csrc/``."""
    table = STRUCTS[name]
    src = _sources()
    found = re.findall(rf"^struct {table.name} \{{\n(.*?)^\}};", src,
                       re.S | re.M)
    assert len(found) == 1, f"struct {table.name} is not in csrc/ once"
    enums = _enums(src)
    want = []
    for line in found[0].splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        ctype, field, size = re.fullmatch(
            r"(.+?)\s*\b(\w+)(?:\[(\w+)\])?;", decl).groups()
        kind = _c_kind(ctype)
        if size is not None:
            kind = f"int[{enums[size] if size in enums else int(size)}]"
        want.append((field, kind))
    got = [(field, _ctypes_kind(ctype))
           for field, ctype in table.struct._fields_]
    assert got == want


ENTRIES = [(mod.LIBRARY, entry) for mod in MODULES
           for entry in mod.LIBRARY.entries]


@pytest.mark.parametrize("library,entry", ENTRIES,
                         ids=[entry for _, entry in ENTRIES])
def test_entry_points_match_their_extern_c_definitions(library, entry):
    """Each declared entry point has as many parameters as its ``extern
    "C"`` definition in ``csrc/<library>.cu``, of the same kinds, and its
    return kind."""
    src = (_build.CSRC / f"{library.name}.cu").read_text()
    found = re.findall(rf'extern "C" ([\w\s*]+?)\s*\b{entry}\(([^)]*)\)',
                       src)
    assert len(found) == 1, f"{entry} is not defined once"
    ret, params = found[0]
    params = [p.strip() for p in params.split(",") if p.strip()]
    restype, argtypes = library.entries[entry]
    assert len(argtypes) == len(params)
    assert [_ctypes_kind(t) for t in argtypes] == \
        [_c_kind(p.rsplit(None, 1)[0] if "*" not in p.split()[-1]
                 else p) for p in params]
    assert _ctypes_kind(restype) == _c_kind(ret)
