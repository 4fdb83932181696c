// K7 kkt_fill: the AC OPF interior point's structured KKT, its values
// computed, equilibrated and filled into the padded BBD blocks.
//
// Replaces the jnp device routines of juliagrid_tpu/opf/kkt_bbd.py:
// AcKktBbd._values (:335-498), about fifty vectorized groups of closed
// forms concatenated into the KKT's COO values (the flow rows' 4x4 blocks
// from vmapped jax.hessian/jax.grad), and AcKktBbd._assemble (:504-556),
// the Jacobi equilibration in COO space, d = 1/sqrt(max(rowmax |val|,
// 1e-12)), and the scatter-adds of val d_r d_c into the padded blocks
// a_ii [k, ni, ni], a_ib [k, ni, mbl], a_bi [k, mbl, ni] and a_bb [mb, mb]
// (1.0 on the padded interior diagonal). The four blocks are one buffer
// here, a_ii | a_ib | a_bi | a_bb, zeroed by the caller (a memset).
//
// Two launches a call:
// 1. values_kernel: a thread per source item, in this order: a cost term,
//    a Y-bus entry, a flow row, a bound row, a capability cut, an angle
//    row, an active and a reactive piecewise cut, a state variable, a bus,
//    a generator, a unit row of J_E (slack, out-of-service, fixed), an
//    equality row. An item computes its closed forms once and writes every
//    COO value it owns at positions the host fixed (group base + item
//    index): a Y-bus entry its 15 balance-Hessian stencil values and its
//    four J_E values and their transposes; a flow row its 16 Hessian values
//    and its 16 J_I^T Sigma J_I values for each limited side; a bus walks
//    its Y row for P and Q and writes its four diagonal J_E values twice.
//    Each COO position has one writer (kkt_fill.py::check_route walks the
//    items on the host). The row maxima of |val| go into rmax[n_aug]
//    through atomicMax on the bits of a non-negative double, whose order
//    as an unsigned integer is its order as a number: the max does not
//    depend on the order the atomics land in. An entry between two
//    different interiors (a structural zero of the Y pattern, erow -1)
//    gets 0.0 and no max, as the JAX package forces it.
// 2. route_kernel: a thread per destination, a distinct element of the
//    padded blocks, sums val_e d_r d_c over its COO entries from 0.0 in
//    ascending COO order (the order of XLA's CPU scatter-add and of the
//    plain version's index_put_) and writes the sum; further threads write
//    1.0 on the padded diagonal and d itself. The host's check gives every
//    element at most one destination or pad.
//
// Rounding: built with -fmad=false (_build.SOURCE_FLAGS), so each product
// and sum rounds on its own as the plain version's op-by-op kernels do; the
// flow rows' closed forms (opf_terms.cuh, shared with K6) and the bus sums'
// order differ from the plain version's autodiff and scatter by a few ulps
// of the terms.
//
// Bound: the padded blocks are written once, and they dominate the bytes
// (at the 10,000-bus KKT, 19 interior blocks of 2,674: a_ii alone is 1.09
// GB, ~0.33 ms at 3.35 TB/s); the values (1.34M), the tables and the
// iterate are tens of MB. The closed forms are tens of operations an entry
// and ~1,000 a flow row, far below the bytes. A memset of the block buffer
// precedes the launches; zeroing inside the launch is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "opf_terms.cuh"

// Group bases (COO positions) and counts: the order of kkt_fill.py's BASES
// and SIZES.
enum Base {
  kStencil, kFlowH, kBound, kCc, kFlowLo, kFlowHi, kAngle, kPwp, kPwq,
  kDelta, kPTheta, kPV, kPThetaD, kPVD, kQTheta, kQV, kQThetaD, kQVD, kPg,
  kQg, kEqDiag, kBases
};
enum Size {
  kN, kG, kNx, kMe, kMi, kNnz, kNfl, kNaug, kNentries, kNdest, kNpad, kNcost,
  kNbound, kNcc, kNan, kNpwp, kNpwq, kNlo, kNhi, kNunit, kCcRow, kFloRow,
  kFhiRow, kAnLoRow, kAnHiRow, kPwpRow, kPwqRow, kSizes
};

// The tables of one KKT layout (kkt_fill.py::_Tables): the spec's arrays,
// which a numeric live edit rebuilds, then the structure. At file scope,
// so that the extern "C" launcher that takes it keeps its external linkage.
struct KktTables {
  const double* yg;         // [nnz] Y-bus entries, by row then column
  const double* yb;
  const double* cc_aq;      // [n_cc] capability cuts
  const double* cc_ap;
  const double* pwp_slope;  // [n_pwp], [n_pwq] piecewise cuts
  const double* pwq_slope;
  const int* row_ptr;       // [n + 1] K6's tables: Y-bus entries by row,
  const int* ycol;          // [nnz] their columns,
  const int* diag;          // [n] each bus's diagonal entry or -1,
  const double* gen_on;     // [g] 1 in service, 0 out,
  const int* fl_idx;        // [6, n_fl] the flow rows,
  const double* fl_y;       // [4, n_fl]
  const int* term_ptr;      // [n_x - 2n + 1] cost terms by variable,
  const int* term;          // [2, n_cost] degree, coefficient offset,
  const double* term_co;    // coefficients, descending powers
  const int* rows;          // [E] COO rows and columns
  const int* cols;
  const int* erow;          // [E] row, or -1 for a cross-interior zero
  const int* yrow;          // [nnz] the row bus of each Y-bus entry
  const int* gbus;          // [g] each generator's bus
  const int* unit_pos;      // [2, n_unit] J_E's unit rows, transposes
  const int64_t* dest_off;  // [D] destination elements of the buffer
  const int* dest_ptr;      // [D + 1] their entries ...
  const int* dest_ent;      // ... ascending
  const int64_t* pad_off;   // [P] the padded interior diagonal
  int base[kBases];
  int size[kSizes];
};

namespace {

constexpr int kThreads = 256;
constexpr double kDeltaC = -1e-10;   // the equality diagonal

using opf_terms::EntryTerms;
using opf_terms::entry_terms;

// One interior-point iterate: the point, the scaled duals, Sigma, the row
// and objective scales, the regularization.
struct Iterate {
  const double* x;
  const double* y;
  const double* z;
  const double* sigma;
  const double* ge;
  const double* gi;
  double sf;
  double delta;
};

struct Out {
  double* vals;
  unsigned long long* rmax;
};

__device__ __forceinline__ void put(const KktTables& t, const Out& o,
                                    int64_t pos, double v) {
  const int r = t.erow[pos];
  if (r < 0) {
    o.vals[pos] = 0.0;
    return;
  }
  o.vals[pos] = v;
  atomicMax(o.rmax + r,
            static_cast<unsigned long long>(__double_as_longlong(fabs(v))));
}

// A value written at `pos` and, `count` further, its transpose (J_E).
__device__ __forceinline__ void put_both(const KktTables& t, const Out& o,
                                         int64_t pos, int64_t count,
                                         double v) {
  put(t, o, pos, v);
  put(t, o, pos + count, v);
}

// Sigma, the raw duals: sigma gi^2, ge y / sf, gi z / sf
__device__ __forceinline__ double sig(const Iterate& it, int r) {
  return it.sigma[r] * it.gi[r] * it.gi[r];
}
__device__ __forceinline__ double zraw(const Iterate& it, int r) {
  return it.gi[r] * it.z[r] / it.sf;
}
__device__ __forceinline__ double yraw(const Iterate& it, int r) {
  return it.ge[r] * it.y[r] / it.sf;
}

__device__ void cost_item(const KktTables& t, const Iterate& it,
                          const Out& o, int p) {
  const int col = t.rows[p];
  const int v = col - 2 * t.size[kN];
  const double pq = it.x[col];
  const int count = t.size[kNcost];
  double total = 0.0;
  for (int s = t.term_ptr[v]; s < t.term_ptr[v + 1]; ++s) {
    const int deg = t.term[s];
    const double* co = t.term_co + t.term[count + s];
    double acc = 0.0;
    for (int j = 0; j < deg - 1; ++j) {  // descending coefficients of p''
      const int kk = deg - j;
      acc = acc * pq + co[j] * static_cast<double>(kk) *
                           static_cast<double>(kk - 1);
    }
    total = s == t.term_ptr[v] ? acc : total + acc;
  }
  put(t, o, p, it.sf * total);
}

__device__ void entry_item(const KktTables& t, const Iterate& it,
                           const Out& o, int e) {
  const int n = t.size[kN];
  const int nnz = t.size[kNnz];
  const double* x = it.x;
  const int i = t.yrow[e];
  const int j = t.ycol[e];
  const double vi = x[n + i];
  const double vj = x[n + j];
  const double off = i != j ? 1.0 : 0.0;
  const double dsel = i == j ? 1.0 : 0.0;
  const double yrp = yraw(it, i);
  const double yrq = yraw(it, n + i);
  const double gy = t.yg[e];
  const double by = t.yb[e];
  const EntryTerms c =
      entry_terms(gy, by, vi, vj, x[i] - x[j], yrp * off, yrq * off);
  const double dd = (yrp * 2.0 * gy - yrq * 2.0 * by) * dsel;
  const double stencil[15] = {c.tt,   c.tt,   -c.tt,  -c.tt,  c.tivi,
                              c.tivi, c.tivj, c.tivj, c.tjvi, c.tjvi,
                              c.tjvj, c.tjvj, c.vv,   c.vv,   dd};
  const int64_t b = t.base[kStencil];
  for (int s = 0; s < 15; ++s) {
    put(t, o, b + static_cast<int64_t>(s) * nnz + e, it.sf * stencil[s]);
  }
  const double ep = it.ge[i];
  const double eq = it.ge[n + i];
  put_both(t, o, t.base[kPTheta] + e, nnz, ep * (-c.t2 * off));
  put_both(t, o, t.base[kPV] + e, nnz, ep * (-vi * c.gc * off));
  put_both(t, o, t.base[kQTheta] + e, nnz, eq * (c.t1 * off));
  put_both(t, o, t.base[kQV] + e, nnz, eq * (-vi * c.gs * off));
}

__device__ void flow_item(const KktTables& t, const Iterate& it,
                          const Out& o, int f) {
  const int nf = t.size[kNfl];
  double gz[4];
  double hz[16];
  opf_terms::flow_derivs(opf_terms::FlowRows{t.fl_idx, t.fl_y, nf,
                                             t.size[kN]},
                         it.x, f, gz, hz);
  const int lo = t.fl_idx[4 * nf + f];
  const int hi = t.fl_idx[5 * nf + f];
  double w = 0.0;
  if (lo >= 0) w = w + -zraw(it, lo);
  if (hi >= 0) w = w + zraw(it, hi);
  const double sw = it.sf * w;
  const int64_t bh = t.base[kFlowH];
  for (int ab = 0; ab < 16; ++ab) {
    put(t, o, bh + static_cast<int64_t>(ab) * nf + f, sw * hz[ab]);
  }
  // J_I^T Sigma J_I of each limited side: the gradient's outer product
  const int rows[2] = {lo, hi};
  const int first[2] = {t.size[kFloRow], t.size[kFhiRow]};
  const int count[2] = {t.size[kNlo], t.size[kNhi]};
  const int64_t base[2] = {t.base[kFlowLo], t.base[kFlowHi]};
  for (int side = 0; side < 2; ++side) {
    if (rows[side] < 0) continue;
    const double sr = sig(it, rows[side]);
    const int64_t pos = base[side] + (rows[side] - first[side]);
    for (int a = 0; a < 4; ++a) {
      for (int b = 0; b < 4; ++b) {
        put(t, o, pos + static_cast<int64_t>(4 * a + b) * count[side],
            sr * gz[a] * gz[b]);
      }
    }
  }
}

// A capability cut, an angle row or a piecewise cut: four values.
__device__ void four(const KktTables& t, const Out& o, int base, int count,
                     int i, double v0, double v1, double v2, double v3) {
  const int64_t b = base;
  put(t, o, b + i, v0);
  put(t, o, b + count + i, v1);
  put(t, o, b + 2 * static_cast<int64_t>(count) + i, v2);
  put(t, o, b + 3 * static_cast<int64_t>(count) + i, v3);
}

__device__ void bus_item(const KktTables& t, const Iterate& it,
                         const Out& o, int k) {
  const int n = t.size[kN];
  const double* x = it.x;
  const double vk = x[n + k];
  const double tk = x[k];
  double p = 0.0;
  double q = 0.0;
  for (int e = t.row_ptr[k]; e < t.row_ptr[k + 1]; ++e) {
    const int j = t.ycol[e];
    double st, ct;
    sincos(tk - x[j], &st, &ct);
    const double gc = t.yg[e] * ct + t.yb[e] * st;
    const double gs = t.yg[e] * st - t.yb[e] * ct;
    p = p + vk * x[n + j] * gc;
    q = q + vk * x[n + j] * gs;
  }
  const int d = t.diag[k];
  const double gii = d >= 0 ? t.yg[d] : 0.0;
  const double bii = d >= 0 ? t.yb[d] : 0.0;
  const double ep = it.ge[k];
  const double eq = it.ge[n + k];
  put_both(t, o, t.base[kPThetaD] + k, n, ep * (q + bii * vk * vk));
  put_both(t, o, t.base[kPVD] + k, n, ep * -(p / vk + gii * vk));
  put_both(t, o, t.base[kQThetaD] + k, n, eq * -(p - gii * vk * vk));
  put_both(t, o, t.base[kQVD] + k, n, eq * -(q / vk - bii * vk));
}

__global__ void __launch_bounds__(kThreads)
values_kernel(KktTables t, Iterate it, Out o) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int* s = t.size;
  const int n = s[kN];
  const int g = s[kG];
  if (i < s[kNcost]) return cost_item(t, it, o, static_cast<int>(i));
  i -= s[kNcost];
  if (i < s[kNnz]) return entry_item(t, it, o, static_cast<int>(i));
  i -= s[kNnz];
  if (i < s[kNfl]) return flow_item(t, it, o, static_cast<int>(i));
  i -= s[kNfl];
  if (i < s[kNbound]) {
    return put(t, o, t.base[kBound] + i, sig(it, static_cast<int>(i)));
  }
  i -= s[kNbound];
  if (i < s[kNcc]) {
    const int c = static_cast<int>(i);
    const double sc = sig(it, s[kCcRow] + c);
    const double aq = t.cc_aq[c];
    const double ap = t.cc_ap[c];
    return four(t, o, t.base[kCc], s[kNcc], c, sc * aq * aq, sc * aq * ap,
                sc * ap * aq, sc * ap * ap);
  }
  i -= s[kNcc];
  if (i < s[kNan]) {
    const int a = static_cast<int>(i);
    const double sl = sig(it, s[kAnLoRow] + a) + sig(it, s[kAnHiRow] + a);
    return four(t, o, t.base[kAngle], s[kNan], a, sl, -sl, -sl, sl);
  }
  i -= s[kNan];
  for (int kind = 0; kind < 2; ++kind) {
    const int count = s[kind ? kNpwq : kNpwp];
    if (i < count) {
      const int c = static_cast<int>(i);
      const double sr = sig(it, s[kind ? kPwqRow : kPwpRow] + c);
      const double sl = (kind ? t.pwq_slope : t.pwp_slope)[c];
      return four(t, o, t.base[kind ? kPwq : kPwp], count, c, sr * sl * sl,
                  -sr * sl, -sr * sl, sr);
    }
    i -= count;
  }
  if (i < s[kNx]) return put(t, o, t.base[kDelta] + i, it.delta);
  i -= s[kNx];
  if (i < n) return bus_item(t, it, o, static_cast<int>(i));
  i -= n;
  if (i < g) {
    const int gi = static_cast<int>(i);
    const int b = t.gbus[gi];
    const double on = t.gen_on[gi];
    put_both(t, o, t.base[kPg] + gi, g, it.ge[b] * on);
    put_both(t, o, t.base[kQg] + gi, g, it.ge[n + b] * on);
    return;
  }
  i -= g;
  if (i < s[kNunit]) {
    const int u = static_cast<int>(i);
    const double v = it.ge[2 * n + u] * 1.0;
    put(t, o, t.unit_pos[u], v);
    put(t, o, t.unit_pos[s[kNunit] + u], v);
    return;
  }
  i -= s[kNunit];
  if (i < s[kMe]) put(t, o, t.base[kEqDiag] + i, kDeltaC);
}

// 1/sqrt(max(m, 1e-12)), NaN kept (as jnp.maximum and torch.clamp keep it)
__device__ __forceinline__ double scale_of(const unsigned long long* rmax,
                                           int r) {
  const double m = __longlong_as_double(static_cast<long long>(rmax[r]));
  return 1.0 / sqrt(m != m ? m : (m > 1e-12 ? m : 1e-12));
}

__global__ void __launch_bounds__(kThreads)
route_kernel(KktTables t, const double* __restrict__ vals,
             const unsigned long long* __restrict__ rmax,
             double* __restrict__ d, double* __restrict__ blocks) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int* s = t.size;
  if (i < s[kNdest]) {
    double sum = 0.0;
    for (int q = t.dest_ptr[i]; q < t.dest_ptr[i + 1]; ++q) {
      const int e = t.dest_ent[q];
      sum = sum + vals[e] * scale_of(rmax, t.rows[e]) *
                      scale_of(rmax, t.cols[e]);
    }
    blocks[t.dest_off[i]] = sum;
    return;
  }
  i -= s[kNdest];
  if (i < s[kNpad]) {
    blocks[t.pad_off[i]] = 1.0;
    return;
  }
  i -= s[kNpad];
  if (i < s[kNaug]) d[i] = scale_of(rmax, static_cast<int>(i));
}

unsigned grid_of(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Launch K7 on `stream`: the values, then the routing. `t` holds the
// layout's tables (device pointers, see KktTables). x[n_x] is the point,
// y[m_E] and z[m_I] the scaled duals, sigma[m_I] Sigma, ge[m_E] and gi[m_I]
// the row scales, sf the objective scale, delta the regularization (z,
// sigma and gi may be null without inequality rows). The launch writes
// vals[E] and d[n_aug] and fills `blocks`, the a_ii | a_ib | a_bi | a_bb
// buffer; rmax[n_aug] and `blocks` must be zero on entry (the caller's
// memsets). Returns a cudaError_t code.
extern "C" int kkt_fill_launch(const KktTables* t, const double* x,
                               const double* y, const double* z,
                               const double* sigma, const double* ge,
                               const double* gi, double sf, double delta,
                               double* vals, double* rmax, double* d,
                               double* blocks, void* stream) {
  if (t == nullptr || x == nullptr || y == nullptr || ge == nullptr ||
      vals == nullptr || rmax == nullptr || d == nullptr ||
      blocks == nullptr ||
      (t->size[kMi] > 0 && (z == nullptr || sigma == nullptr ||
                            gi == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int* s = t->size;
  const int64_t items = static_cast<int64_t>(s[kNcost]) + s[kNnz] +
                        s[kNfl] + s[kNbound] + s[kNcc] + s[kNan] + s[kNpwp] +
                        s[kNpwq] + s[kNx] + s[kN] + s[kG] + s[kNunit] +
                        s[kMe];
  const int64_t routes = static_cast<int64_t>(s[kNdest]) + s[kNpad] +
                         s[kNaug];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Iterate it{x, y, z, sigma, ge, gi, sf, delta};
  const Out o{vals, reinterpret_cast<unsigned long long*>(rmax)};
  values_kernel<<<grid_of(items), kThreads, 0, st>>>(*t, it, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  route_kernel<<<grid_of(routes), kThreads, 0, st>>>(
      *t, vals, o.rmax, d, blocks);
  return cudaGetLastError();
}

extern "C" const char* kkt_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
