"""K7 ``kkt_fill`` on the CPU: its host tables and mapping, walked in numpy
as ``csrc/kkt_fill.cu`` walks them (one source item a thread, then one
destination a thread), against the plain version; the route check; the
build's key on the headers a source includes; the 10,000-bus layout.

Tolerance: the walk repeats the kernel's closed forms (the flow rows' by
the chain rule, as K6's), the plain version the JAX package's arithmetic
(the flow rows through ``torch.func``), so they agree to rounding: 1e-12
of the row's scale (``|a - b| <= 1e-12 max(1, max |row of b|)``)."""

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels import kkt_fill as k7
from juliagrid_tpu_torch.kernels.opf_fill import opf_fill_table
from juliagrid_tpu_torch.opf import acopf
from juliagrid_tpu_torch.opf.kkt_bbd import AcKktBbd
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

from .test_torch_opf_fill import _flow_derivs, _systems

ROW_TOL = 1e-12


def _walk(tab, spec, x, y, z, sigma, delta, sf, ge, gi):
    """K7's two launches in numpy: the value items write each COO value
    once (asserted) and fold |value| into its row's max unless the entry
    crosses two interiors; then each destination sums its entries' scaled
    values in list order, the pads get 1.0, and d follows."""
    s = tab["size"]
    b = dict(zip(k7.BASES, tab["base"]))
    n, g, nnz, nf = s["n"], s["g"], s["nnz"], s["n_fl"]
    ftab = opf_fill_table(spec)
    yg, yb = spec.yg, spec.yb
    vals = np.full(s["n_entries"], np.nan)
    seen = np.zeros(s["n_entries"], dtype=bool)
    rmax = np.zeros(s["n_aug"])

    def put(pos, v):
        assert not seen[pos], ("two writers", pos)
        seen[pos] = True
        r = tab["erow"][pos]
        if r < 0:
            vals[pos] = 0.0
            return
        vals[pos] = v
        rmax[r] = max(rmax[r], abs(v))

    def sig(r):
        return sigma[r] * gi[r] * gi[r]

    def raw(scale, dual, r):
        return scale[r] * dual[r] / sf

    for p in range(s["n_cost"]):                      # cost terms
        col = tab["rows"][p]
        v = col - 2 * n
        total = None
        for t in range(ftab["term_ptr"][v], ftab["term_ptr"][v + 1]):
            deg, off = ftab["term"][:, t]
            acc = 0.0
            for j in range(deg - 1):
                kk = deg - j
                acc = acc * x[col] + ftab["term_co"][off + j] * kk * (kk - 1)
            total = acc if total is None else total + acc
        put(p, sf * total)
    for e in range(nnz):                              # Y-bus entries
        i, j = tab["yrow"][e], ftab["ycol"][e]
        vi, vj, th = x[n + i], x[n + j], x[i] - x[j]
        off = 1.0 if i != j else 0.0
        yrp, yrq = raw(ge, y, i), raw(ge, y, n + i)
        gc = yg[e] * np.cos(th) + yb[e] * np.sin(th)
        gs = yg[e] * np.sin(th) - yb[e] * np.cos(th)
        t1, t2 = vi * vj * gc, vi * vj * gs
        yp, yq = yrp * off, yrq * off
        tt = -(yp * t1 + yq * t2)
        tivi = -yp * vj * gs + yq * vj * gc
        tivj = -yp * vi * gs + yq * vi * gc
        tjvi = yp * vj * gs - yq * vj * gc
        tjvj = yp * vi * gs - yq * vi * gc
        vv = yp * gc + yq * gs
        dd = (yrp * 2.0 * yg[e] - yrq * 2.0 * yb[e]) * (1.0 - off)
        for t, c in enumerate((tt, tt, -tt, -tt, tivi, tivi, tivj, tivj,
                               tjvi, tjvi, tjvj, tjvj, vv, vv, dd)):
            put(b["stencil"] + t * nnz + e, sf * c)
        for name, scale, v in (("je_p_theta", ge[i], -t2 * off),
                               ("je_p_v", ge[i], -vi * gc * off),
                               ("je_q_theta", ge[n + i], t1 * off),
                               ("je_q_v", ge[n + i], -vi * gs * off)):
            put(b[name] + e, scale * v)
            put(b[name] + nnz + e, scale * v)
    for f in range(nf):                               # flow rows
        gz, hz = _flow_derivs(ftab, x, n, f)
        lo, hi = ftab["fl_idx"][4][f], ftab["fl_idx"][5][f]
        w = 0.0
        if lo >= 0:
            w = w + -raw(gi, z, lo)
        if hi >= 0:
            w = w + raw(gi, z, hi)
        for ab in range(16):
            put(b["flow_h"] + ab * nf + f, sf * w * hz[ab // 4, ab % 4])
        for row, name, first, count in (
                (lo, "flow_lo", s["flo_row"], s["n_lo"]),
                (hi, "flow_hi", s["fhi_row"], s["n_hi"])):
            if row < 0:
                continue
            for ab in range(16):
                put(b[name] + ab * count + row - first,
                    sig(row) * gz[ab // 4] * gz[ab % 4])
    for r in range(s["n_bound"]):
        put(b["bound"] + r, sig(r))
    for name, count, values in (
            ("cc", s["n_cc"], lambda c: (
                lambda sc, aq, ap: (sc * aq * aq, sc * aq * ap, sc * ap * aq,
                                    sc * ap * ap))(
                sig(s["cc_row"] + c), spec.cc_aq[c], spec.cc_ap[c])),
            ("angle", s["n_an"], lambda a: (
                lambda sl: (sl, -sl, -sl, sl))(
                sig(s["an_lo_row"] + a) + sig(s["an_hi_row"] + a))),
            ("pwp", s["n_pwp"], lambda c: (
                lambda sr, sl: (sr * sl * sl, -sr * sl, -sr * sl, sr))(
                sig(s["pwp_row"] + c), spec.pwp[2][c])),
            ("pwq", s["n_pwq"], lambda c: (
                lambda sr, sl: (sr * sl * sl, -sr * sl, -sr * sl, sr))(
                sig(s["pwq_row"] + c), spec.pwq[2][c]))):
        for c in range(count):
            for t, v in enumerate(values(c)):
                put(b[name] + t * count + c, v)
    for v in range(s["n_x"]):
        put(b["delta"] + v, delta)
    for k in range(n):                                # buses
        vk = x[n + k]
        p = q = 0.0
        for e in range(ftab["row_ptr"][k], ftab["row_ptr"][k + 1]):
            j = ftab["ycol"][e]
            th = x[k] - x[j]
            p = p + vk * x[n + j] * (yg[e] * np.cos(th) + yb[e] * np.sin(th))
            q = q + vk * x[n + j] * (yg[e] * np.sin(th) - yb[e] * np.cos(th))
        d = ftab["diag"][k]
        gii, bii = (yg[d], yb[d]) if d >= 0 else (0.0, 0.0)
        for name, scale, v in (
                ("je_p_theta_d", ge[k], q + bii * vk * vk),
                ("je_p_v_d", ge[k], -(p / vk + gii * vk)),
                ("je_q_theta_d", ge[n + k], -(p - gii * vk * vk)),
                ("je_q_v_d", ge[n + k], -(q / vk - bii * vk))):
            put(b[name] + k, scale * v)
            put(b[name] + n + k, scale * v)
    for i in range(g):                                # generators
        bus, on = tab["gbus"][i], ftab["gen_on"][i]
        for name, scale in (("je_pg", ge[bus]), ("je_qg", ge[n + bus])):
            put(b[name] + i, scale * on)
            put(b[name] + g + i, scale * on)
    for u in range(s["n_unit"]):                      # unit rows of J_E
        put(tab["unit_pos"][0][u], ge[2 * n + u] * 1.0)
        put(tab["unit_pos"][1][u], ge[2 * n + u] * 1.0)
    for r in range(s["m_e"]):
        put(b["eq_diag"] + r, -1e-10)
    assert seen.all()

    d = 1.0 / np.sqrt(np.maximum(rmax, 1e-12))
    blocks = np.zeros(sum(k7._block_sizes(s["k"], s["ni"], s["mb"],
                                          s["mbl"])))
    ptr = tab["dest_ptr"]
    for i, off in enumerate(tab["dest_off"]):
        acc = 0.0
        for e in tab["dest_ent"][ptr[i]:ptr[i + 1]]:
            acc = acc + vals[e] * d[tab["rows"][e]] * d[tab["cols"][e]]
        blocks[off] = acc
    blocks[tab["pad_off"]] = 1.0
    return vals, d, blocks


def _random_iterate(spec, x0, seed, flat=False):
    rng = np.random.default_rng(seed)
    x = np.array(x0, dtype=np.float64)
    if flat:
        x[:spec.n], x[spec.n:2 * spec.n] = 0.0, 1.0
    else:
        x[:spec.n] += 0.1 * rng.standard_normal(spec.n)
        x[spec.n:2 * spec.n] *= 1.0 + 0.05 * rng.standard_normal(spec.n)
    return (x, rng.standard_normal(spec.m_e), rng.uniform(0.1, 2, spec.m_i),
            rng.uniform(1e-3, 1e3, spec.m_i), float(rng.uniform(0.2, 1.0)),
            rng.uniform(0.3, 1.0, spec.m_e), rng.uniform(0.3, 1.0, spec.m_i))


def _close_rows(got, want, scale_rows):
    bad = np.abs(got - want) > ROW_TOL * np.maximum(1.0, scale_rows)
    assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5],
                           want[bad][:5])


#: (case, flow class on every branch or 0, the flat start): every item
#: kind (case14edited: piecewise, capability, angle, fixed and
#: out-of-service rows), the √ rows at S² = I² = 0, a larger grid
WALK_CASES = [("case14edited", 0, False), ("case30test", 2, True),
              ("case30test", 5, False), ("case118", 0, False)]


@pytest.mark.parametrize("case,cls,flat", WALK_CASES, ids=lambda v: str(v))
def test_walk_matches_ref(data_path, case, cls, flat):
    """The tables walked as the kernel walks them give the plain version's
    values, equilibration and blocks."""
    _, ts = _systems(data_path, case, cls)
    spec = acopf._AcSpec(ts, device="cpu")
    lay = AcKktBbd(spec, 3)
    host = k7.kkt_fill_table(lay)
    x, y, z, sigma, sf, ge, gi = _random_iterate(spec, spec.start(ts), 3,
                                                 flat)
    delta = 1e-6
    vals, d, blocks = _walk(host, spec, x, y, z, sigma, delta, sf, ge, gi)
    t = torch.tensor
    ref = k7.kkt_fill_ref(lay.table, spec.arrays, t(x), t(y), t(z),
                          t(sigma), delta, sf, t(ge), t(gi))
    rmax = np.zeros(lay.n_aug)
    np.maximum.at(rmax, lay.rows, np.abs(ref.vals.numpy()))
    _close_rows(vals, ref.vals.numpy(), rmax[lay.rows])
    _close_rows(d, ref.d.numpy(), np.abs(ref.d.numpy()))
    flat_ref = torch.cat([ref.a_ii.reshape(-1), ref.a_ib.reshape(-1),
                          ref.a_bi.reshape(-1), ref.a_bb.reshape(-1)])
    for got, want in zip(k7._blocks(lay.table, torch.tensor(blocks)),
                         (ref.a_ii, ref.a_ib, ref.a_bi, ref.a_bb)):
        want = want.numpy()
        _close_rows(got.numpy(), want,
                    np.abs(want).max(axis=-1, keepdims=True))
    assert flat_ref.numel() == blocks.size


@pytest.mark.parametrize("case,cls", [("case14edited", 0),
                                      ("case30test", 2)])
def test_block_table_fills_one_block(data_path, case, cls):
    """One rank's tables in the mesh mode (``kkt_fill_table(lay,
    block=r)``): the route check holds; the plain version gives the whole
    table's values and d, and in its one-block buffer block r and a_bb of
    the whole table's blocks, bit for bit; the kernel's walk of the rank's
    tables agrees with it to the row tolerance."""
    _, ts = _systems(data_path, case, cls)
    spec = acopf._AcSpec(ts, device="cpu")
    lay = AcKktBbd(spec, 3)
    x, y, z, sigma, sf, ge, gi = _random_iterate(spec, spec.start(ts), 5)
    t = torch.tensor
    args = (spec.arrays, t(x), t(y), t(z), t(sigma), 1e-6, sf, t(ge), t(gi))
    whole = k7.kkt_fill_ref(lay.table, *args)
    for r in range(lay.k):
        host = k7.kkt_fill_table(lay, block=r)
        k7.check_route(host, lay)
        assert host["size"]["k"] == 1 and host["size"]["block"] == r
        tab = k7.kkt_fill_table_tensors(host, lay, "cpu")
        one = k7.kkt_fill_ref(tab, *args)
        assert torch.equal(one.vals, whole.vals)
        assert torch.equal(one.d, whole.d)
        for name in ("a_ii", "a_ib", "a_bi"):
            assert torch.equal(getattr(one, name),
                               getattr(whole, name)[r:r + 1]), name
        assert torch.equal(one.a_bb, whole.a_bb)
        _, _, blocks = _walk(host, spec, x, y, z, sigma, 1e-6, sf, ge, gi)
        for got, want in zip(k7._blocks(tab, torch.tensor(blocks)),
                             (one.a_ii, one.a_ib, one.a_bi, one.a_bb)):
            want = want.numpy()
            _close_rows(got.numpy(), want,
                        np.abs(want).max(axis=-1, keepdims=True))
    with pytest.raises(ValueError, match="not one of"):
        k7.kkt_fill_table(lay, block=lay.k)


def test_check_route_refuses_a_foreign_block_entry(data_path):
    """A rank's tables that list another block's entry, or drop one of
    their own, fail the route check."""
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case30test.m")),
                         device="cpu")
    lay = AcKktBbd(spec, 3)
    good = k7.kkt_fill_table(lay, block=1)
    k7.check_route(good, lay)
    foreign = lay.ii[0][lay.ii[1] == 0][0]
    own = lay.ii[0][lay.ii[1] == 1][0]
    for pos, value in ((foreign, 0), (own, -1)):
        tab = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in good.items()}
        tab["eflat"][pos] = value
        with pytest.raises(ValueError, match="blocks' entries"):
            k7.check_route(tab, lay)


def test_cross_interior_entry_is_zero_and_no_max(data_path):
    """An entry marked cross-interior (erow -1: a structural zero between
    two interiors) comes out 0.0 and takes no part in its row's maximum,
    in the walk as in the plain version."""
    _, ts = _systems(data_path, "case14edited", 0)
    spec = acopf._AcSpec(ts, device="cpu")
    lay = AcKktBbd(spec, 3)
    host = k7.kkt_fill_table(lay)
    pos = host["base"][k7.BASES.index("stencil")] + 2 * spec.rows.size + \
        int(np.flatnonzero(spec.rows != spec.cols)[0])
    host["erow"][pos] = -1
    tab = k7.kkt_fill_table_tensors(host, lay, "cpu")
    x, y, z, sigma, sf, ge, gi = _random_iterate(spec, spec.start(ts), 4)
    vals, d, _ = _walk(host, spec, x, y, z, sigma, 0.0, sf, ge, gi)
    t = torch.tensor
    ref = k7.kkt_fill_ref(tab, spec.arrays, t(x), t(y), t(z), t(sigma),
                          0.0, sf, t(ge), t(gi))
    assert vals[pos] == 0.0 and float(ref.vals[pos]) == 0.0
    np.testing.assert_allclose(d, ref.d.numpy(), rtol=ROW_TOL)


def test_check_route_refuses_two_writers(data_path):
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case30test.m")),
                         device="cpu")
    lay = AcKktBbd(spec, 3)
    good = k7.kkt_fill_table(lay)
    k7.check_route(good, lay)

    def broken(edit):
        tab = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in good.items()}
        edit(tab)
        return tab

    def shifted_base(tab):
        base = list(tab["base"])
        base[k7.BASES.index("delta")] += 1
        tab["base"] = tuple(base)

    def listed_twice(tab):
        tab["dest_ent"][1] = tab["dest_ent"][0]

    def unsorted(tab):
        ptr = tab["dest_ptr"]
        i = int(np.flatnonzero(np.diff(ptr) >= 2)[0])
        a, b_ = ptr[i], ptr[i] + 1
        tab["dest_ent"][[a, b_]] = tab["dest_ent"][[b_, a]]

    def pad_on_a_destination(tab):
        tab["pad_off"][0] = tab["dest_off"][0]

    def one_element_twice(tab):
        tab["dest_off"][1] = tab["dest_off"][0]

    for edit, match in ((shifted_base, "once"),
                        (listed_twice, "one destination"),
                        (unsorted, "ascending"),
                        (pad_on_a_destination, "two writers"),
                        (one_element_twice, "another element|two writers")):
        with pytest.raises(ValueError, match=match):
            k7.check_route(broken(edit), lay)


def test_kkt_fill_checks_its_inputs(data_path):
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case14test.m")),
                         device="cpu")
    lay = AcKktBbd(spec, 3)
    x = torch.tensor(spec.start(jgt.power_system(
        str(data_path / "case14test.m"))))
    y, z = torch.zeros(spec.m_e, dtype=torch.float64), \
        torch.ones(spec.m_i, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        k7.kkt_fill(lay.table, spec.arrays, x[:-1], y, z, z, 0.0, 1.0)
    with pytest.raises(TypeError, match="float64"):
        k7.kkt_fill(lay.table, spec.arrays, x.float(), y, z, z, 0.0, 1.0)
    with pytest.raises(ValueError, match="structure"):
        k7.kkt_fill(lay.table, spec.arrays._replace(
            yg=spec.arrays.yg, fill=spec.arrays.fill._replace(
                ycol=spec.arrays.fill.ycol[:-1])), x, y, z, z, 0.0, 1.0)
    # the CPU path is the plain version, launched nowhere
    before = k7.kkt_fill.launches
    k7.kkt_fill(lay.table, spec.arrays, x, y, z, z, 0.0, 1.0)
    assert k7.kkt_fill.launches == before


def test_library_path_keys_on_headers(tmp_path, monkeypatch):
    """A header a source includes is part of its build's key: editing it
    moves ``library_path``, editing an unrelated file does not."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nint k;\n')
    (tmp_path / "shared.cuh").write_text('#include "deeper.cuh"\n')
    (tmp_path / "deeper.cuh").write_text("int a;\n")
    (tmp_path / "other.cuh").write_text("int b;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "shared.cuh",
                                                     "deeper.cuh"]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("int c;\n")
    assert _build.library_path("k") == first
    (tmp_path / "deeper.cuh").write_text("int a2;\n")
    assert _build.library_path("k") != first


def test_k6_and_k7_share_the_closed_forms():
    assert [p.name for p in _build.sources("opf_fill")] == [
        "opf_fill.cu", "opf_terms.cuh"]
    assert [p.name for p in _build.sources("kkt_fill")] == [
        "kkt_fill.cu", "opf_terms.cuh"]
    assert _build.nvcc_flags("kkt_fill")[-1] == "-fmad=false"


def test_layout_of_the_10k_cell():
    """The 10,000-bus cell's KKT (synthetic_grid(100, 100, opf=True), the
    JAX package's opf_scale record): 19 blocks of 2,674, a border of
    3,075, 1.34M COO entries, and K7's tables hold it."""
    analysis = jgt.ac_optimal_power_flow(synthetic_grid(100, 100, opf=True),
                                         device="cpu")
    spec = analysis._spec
    assert (spec.n_x, spec.m_e, spec.m_i) == (24000, 20001, 28000)
    lay = AcKktBbd(spec, max(8, spec.n // 512))
    assert (lay.k, lay.ni, lay.mb, lay.n_entries) == (19, 2674, 3075,
                                                      1337763)
    assert lay.table.size["n_dest"] < lay.n_entries
    assert lay.route.nb == lay.mb
