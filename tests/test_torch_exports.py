"""The port's package root against the JAX package's: every public name
resolves; the builders, templates, ``drop_zeros``, ``physical_island`` and
``save_power_system`` give identical system tables from the same edits; and
the port's ``entry()`` step equals the JAX package's
``__graft_entry__.entry()`` step within 1e-12."""

import ast
import dataclasses
import pathlib
import types

import h5py
import numpy as np
import pytest

import __graft_entry__
import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.entry import entry

REPO = pathlib.Path(__file__).resolve().parents[1]
ENTRY_TOL = 1e-12


def _jax_root_names():
    """The names ``juliagrid_tpu/__init__.py`` imports into the root."""
    tree = ast.parse((REPO / "juliagrid_tpu" / "__init__.py").read_text())
    return sorted({a.asname or a.name for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom) for a in node.names
                   if not (a.asname or a.name).startswith("_")})


def test_every_public_name_resolves():
    """Each name resolves to the port's own object: a function, module or
    value of ``juliagrid_tpu_torch`` (``config`` is the port's Config)."""
    names = _jax_root_names()
    assert len(names) == 86
    for name in names:
        obj = getattr(jgt, name)
        module = obj.__name__ if isinstance(obj, types.ModuleType) \
            else getattr(obj, "__module__", type(obj).__module__)
        assert module.startswith("juliagrid_tpu_torch"), (name, module)
    assert type(jgt.config).__module__ == "juliagrid_tpu_torch.config"
    assert jgt.__version__ == jg.__version__


def _tables(obj, path="system"):
    """(path, value) of every table of a power system: each Vec's live
    array, each label list, each scalar; the model separately."""
    if hasattr(obj, "array") and hasattr(obj, "append"):
        yield path, np.asarray(obj.array)
    elif hasattr(obj, "labels") and hasattr(obj, "counter"):
        yield path, (obj.labels(), obj.counter)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name != "model":
                yield from _tables(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for key in sorted(obj, key=repr):
            yield from _tables(obj[key], f"{path}[{key!r}]")
    else:
        yield path, obj


def _same_tables(a, b):
    ta, tb = dict(_tables(a)), dict(_tables(b))
    assert ta.keys() == tb.keys()
    for key, val in ta.items():
        if isinstance(val, np.ndarray):
            assert tb[key].dtype == val.dtype, key
            assert np.array_equal(tb[key], val, equal_nan=True), key
        else:
            assert tb[key] == val, key


def _edit(pkg, path):
    """One chain of root-level edits: templates, adds, updates, costs."""
    pkg.default("template")
    try:
        pkg.set_template("bus", active=0.05, min_magnitude=0.95)
        pkg.set_template("branch", reactance=0.21, resistance=0.01)
        pkg.set_template("generator", max_active=1.5, min_reactive=-0.3)
        system = pkg.power_system(path)
        b = system.bus.label
        pkg.add_bus(system, label="new bus", type=1, reactive=0.02,
                    base=138e3)
        pkg.add_branch(system, from_bus=b.label(2), to_bus="new bus")
        pkg.add_branch(system, from_bus="new bus", to_bus=b.label(5),
                       reactance=0.35, turns_ratio=0.98, shift_angle=0.02)
        k = pkg.add_generator(system, bus="new bus", active=0.2,
                              reactive=0.05)
        pkg.cost(system, system.generator.label.label(k), active=2,
                 polynomial=[100.0, 20.0, 0.01])
        pkg.update_bus(system, b.label(3), active=0.3, susceptance=0.1)
        pkg.update_branch(system, system.branch.label.label(4), status=0)
        pkg.update_generator(system, system.generator.label.label(1),
                             active=0.5, max_active=0.9)
        pkg.ac_model(system)
        pkg.dc_model(system)
        islands = pkg.physical_island(system)
        pkg.drop_zeros(system)
    finally:
        pkg.default("template")
    return system, islands


@pytest.mark.parametrize("case", ["case14test.m", "case30test.m"])
def test_root_builders_give_identical_tables(data_path, case, tmp_path):
    path = str(data_path / case)
    (js, jisl), (ts, tisl) = (_edit(pkg, path) for pkg in (jg, jgt))
    _same_tables(js, ts)
    assert [sorted(i) for i in jisl] == [sorted(i) for i in tisl]
    for kind in ("ac", "dc"):
        jm, tm = getattr(js.model, kind), getattr(ts.model, kind)
        assert (jm.nodal != tm.nodal).nnz == 0, kind
        assert jm.nodal.nnz == tm.nodal.nnz, kind
    assert dataclasses.asdict(js.model.revision) == \
        dataclasses.asdict(ts.model.revision)

    files = []
    for pkg, system in ((jg, js), (jgt, ts)):
        out = str(tmp_path / f"{pkg.__name__}.h5")
        pkg.save_power_system(system, out, reference="ref", note="note")
        files.append(out)
    with h5py.File(files[0]) as a, h5py.File(files[1]) as b:
        assert dict(a.attrs) == dict(b.attrs)
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        for name in names:
            if isinstance(a[name], h5py.Dataset):
                assert np.array_equal(a[name][()], b[name][()]), name
    _same_tables(jgt.power_system(files[0]), jgt.power_system(files[1]))


def test_templates_match():
    """``template`` after ``set_template`` and after ``default``."""
    for pkg in (jg, jgt):
        pkg.set_template("wattmeter", variance_bus=2e-3, label="W ?")
    try:
        assert dataclasses.asdict(jg.template) == \
            dataclasses.asdict(jgt.template)
    finally:
        for pkg in (jg, jgt):
            pkg.default("template")
    assert dataclasses.asdict(jg.template) == dataclasses.asdict(jgt.template)


def test_entry_step_matches_jax():
    """One Newton-Raphson step of ``juliagrid_tpu_torch.entry.entry`` on the
    CPU against one step of the JAX package's ``__graft_entry__.entry``,
    from the same start, within 1e-12. The port's packaged case is the
    file the JAX entry point reads."""
    import juliagrid_tpu_torch.entry as port_entry
    assert (port_entry.CASE.read_bytes()
            == pathlib.Path(__graft_entry__._case_path()).read_bytes())
    jfn, jargs = __graft_entry__.entry()
    tfn, targs = entry(device="cpu")
    for j, t in zip(jargs[1:], targs[1:]):
        assert np.array_equal(np.asarray(j), t.numpy())
    (jvm, jva), (tvm, tva) = jfn(*jargs), tfn(*targs)
    assert np.abs(tvm.numpy() - np.asarray(jvm)).max() <= ENTRY_TOL
    assert np.abs(tva.numpy() - np.asarray(jva)).max() <= ENTRY_TOL
    assert np.abs(tva.numpy() - targs[2].numpy()).max() > 1e-3  # it moved
    assert targs[0].cols.device.type == "cpu"
