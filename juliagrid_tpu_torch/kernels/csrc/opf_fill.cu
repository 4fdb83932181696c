// K6 opf_fill: the AC optimal power flow's constraint Jacobians and the
// Lagrangian Hessian, dense, at one point.
//
// Replaces the jnp device routines of juliagrid_tpu/opf/acopf.py: jac_eq
// (:693), jac_ineq with _flow_grads (:748-800) and hess with _flow_row_val
// (:802-921). There they are about forty scatter-adds into zeroed dense
// matrices (.at[].add/set), the flow rows' partials from vmapped
// jax.grad/jax.hessian; here one launch fills either [J_E; J_I] (Jacobian
// mode, m_E + m_I rows) or H (Hessian mode, n_x rows), n_x columns each,
// row-major f64, zeros included.
//
// Row layout. The state is x = (theta[n], V[n], Pg[g], Qg[g], helpers).
// In both modes rows k and n + k belong to bus k: its P and Q balance rows
// of J_E, or its theta and V rows of H. Every other row (2n..) has its own
// descriptor: the slack, out-of-service, fixed, bound, capability, flow,
// angle and piecewise rows of [J_E; J_I], each one or two constant entries
// or a flow row's four partials (row_kind, row_col, row_val); or the
// Pg/Qg/helper rows of H, whose one entry is the cost's second derivative
// (term_ptr, term, term_co: each term's degree and its coefficients).
//
// Mapping. A thread block owns 1-8 units of one kind (buses, or single
// rows of the tail), about 16 KB of output: its threads zero the units'
// rows with 16-byte stores (the bus rows as two regions, k.. and n + k..),
// and after a barrier one warp fills each unit into lines still in L2.
// - A bus of J_E: the warp walks the bus's Y-bus row 32 entries at a time.
//   Each lane writes its entry's four off-diagonal partials (dP/dtheta_j,
//   dP/dV_j, dQ/dtheta_j, dQ/dV_j, negated: c_E = supply - injection -
//   demand) and adds t1, t2 to the bus's P and Q; a shuffle sums them, and
//   lane 0 writes the four diagonal partials and the generators' +1s.
// - A bus of H: the warp walks the bus's pair list, the buses j it shares
//   a Y-bus entry (either way) or a flow row with, itself included. Lane
//   (k, j) sums what lands on H[theta_k | V_k, theta_j | V_j]: the entry
//   (k, j) weighted by the duals y of bus k, the entry (j, k) weighted by
//   those of bus j, and every flow row between k and j (parallel branches
//   too) weighted by w = z_upper - z_lower; it writes its four off-diagonal
//   elements and adds its part of the four diagonal ones, which a shuffle
//   sums for lane 0. The diagonal Y-bus entry (pair (k, k)) gives the V_k^2
//   term.
// - A tail row: lane 0 writes its one to four entries.
// The host check (opf_fill.py::check_fill_table) makes every Y-bus row and
// pair list name a column once and lists every entry and flow row once at
// each end, so every element has one writer after the zeroing: no atomics,
// and sums in a fixed order (lane order, then the shuffle tree), so the
// result does not depend on scheduling.
//
// Flow rows. The value of a flow row is, by class, P (1), sqrt(S^2) (2),
// S^2 (3), sqrt(I^2) (4) or I^2 (5) of one end, from the rectangular
// voltages u = (Vf cos thf, Vf sin thf, Vt cos tht, Vt sin tht): the
// current I = (ire, iim) is linear in u, P and Q are quadratic. flow_derivs
// (in opf_terms.cuh, shared with K7's kkt_fill.cu, as is entry_terms)
// writes the value's derivatives over u in closed form and takes them to
// z = (thf, tht, Vf, Vt) by the chain rule: g_z = J^T g_u and H_z = J^T H_u
// J + sum_u g_u d^2u/dz^2, J = du/dz. The sqrt rows clamp S^2 or I^2 at
// 1e-24 as the plain version's maximum does: below the clamp the
// derivatives are 0, at a tie they carry the weight 1/2 (first order) and
// 1/4 (the outer-product term of the second), as JAX's and PyTorch's
// maximum give them.
//
// Rounding: built with -fmad=false (_build.SOURCE_FLAGS), so each product
// and sum rounds on its own as the plain version's op-by-op kernels do;
// the sums' order and the flow rows' closed forms differ from the plain
// version's scatter order and autodiff, by a few ulps of the terms.
//
// Bound: the output is written once, (m_E + m_I) n_x or n_x^2 doubles:
// at case1354pegase (n_x = 3,228) 240.6 MB for the Jacobians, 83.4 MB for
// H, about 0.072 and 0.025 ms at 3.35 TB/s; the values are a few per Y-bus
// entry and flow row inside that. Offsets into the output are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "opf_terms.cuh"

// The tables of one AC OPF spec, built once on the host (opf_fill.py::
// _Tables). At file scope, so that the extern "C" launcher that takes it
// keeps its external linkage. [k, N] tables are row-major: field k of item
// i at k N + i.
struct OpfTables {
  const int* row_ptr;     // [n + 1] Y-bus entries by row
  const int* ycol;        // [nnz]
  const double* yg;       // [nnz]
  const double* yb;       // [nnz]
  const int* diag;        // [n] diagonal entry, or -1
  const int* gen_ptr;     // [n + 1] generators by bus
  const int* gen_idx;     // [g]
  const double* gen_on;   // [g] 1 or 0
  const int* row_kind;    // [n_rows] rows 2n.. of [J_E; J_I]
  const int* row_col;     // [2, n_rows]
  const double* row_val;  // [2, n_rows]
  const int* fl_idx;      // [6, n_fl] fb, tb, class, is_from, lower, upper
  const double* fl_y;     // [4, n_fl] gf, bf, gt, bt
  const int* pair_ptr;    // [n + 1]
  const int* pair;        // [3, n_pair] j, entry (k, j), entry (j, k)
  const int* pair_fptr;   // [n_pair + 1]
  const int* pair_flow;   // flow rows of each pair
  const int* term_ptr;    // [n_x - 2n + 1] cost terms of rows 2n..
  const int* term;        // [2, n_term] degree, coefficient offset
  const double* term_co;
  int n;
  int g;
  int n_x;
  int m_e;
  int m_i;
  int nnz;
  int n_rows;
  int n_fl;
  int n_pair;
  int n_term;
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kUnitsPerBlock = kThreads / kWarp;
// the output a thread block zeroes before its warps fill it: small enough
// that the lines its values land in are still in L2 when they come
constexpr int64_t kRegion = 16 * 1024;
constexpr int kLinear = 0;

using opf_terms::EntryTerms;
using opf_terms::entry_terms;

// The flow rows' tables of `t`, as the shared closed forms read them.
__device__ __forceinline__ opf_terms::FlowRows flow_rows(
    const OpfTables& t) {
  return opf_terms::FlowRows{t.fl_idx, t.fl_y, t.n_fl, t.n};
}

// Units of `doubles` output elements a thread block owns.
int units_per_block(int64_t doubles) {
  const int64_t units = kRegion / (8 * doubles);
  return static_cast<int>(units < 1 ? 1
                          : units > kUnitsPerBlock ? kUnitsPerBlock
                                                   : units);
}

// Zero `len` doubles at `base` (8-byte aligned) with the threads of the
// block: 16-byte stores, neighbouring threads on neighbouring addresses,
// one scalar store at an unaligned head or an odd tail.
__device__ __forceinline__ void zero_span(double* base, int64_t len) {
  if (len <= 0) return;
  const int64_t head = (reinterpret_cast<uintptr_t>(base) & 15) ? 1 : 0;
  if (head && threadIdx.x == 0) base[0] = 0.0;
  const int64_t pairs = (len - head) / 2;
  double2* p = reinterpret_cast<double2*>(base + head);
  const double2 z = make_double2(0.0, 0.0);
  for (int64_t c = threadIdx.x; c < pairs; c += kThreads) p[c] = z;
  if (((len - head) & 1) && threadIdx.x == 0) base[len - 1] = 0.0;
}

// Sum over the warp; every lane gets the same bits (a fixed butterfly).
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// J_E's balance rows of bus k: P (row k) and Q (row n + k).
__device__ void jac_bus(const OpfTables& t, const double* __restrict__ x,
                        double* __restrict__ out, int k, int lane) {
  const int n = t.n;
  const int64_t nx = t.n_x;
  double* prow = out + static_cast<int64_t>(k) * nx;
  double* qrow = out + static_cast<int64_t>(n + k) * nx;
  const double vk = x[n + k];
  const double tk = x[k];
  double p = 0.0;
  double q = 0.0;
  for (int e = t.row_ptr[k] + lane; e < t.row_ptr[k + 1]; e += kWarp) {
    const int j = t.ycol[e];
    const double vj = x[n + j];
    double st, ct;
    sincos(tk - x[j], &st, &ct);
    const double gc = t.yg[e] * ct + t.yb[e] * st;
    const double gs = t.yg[e] * st - t.yb[e] * ct;
    const double t1 = vk * vj * gc;
    const double t2 = vk * vj * gs;
    p += t1;
    q += t2;
    if (j != k) {
      prow[j] = -t2;
      prow[n + j] = -vk * gc;
      qrow[j] = t1;
      qrow[n + j] = -vk * gs;
    }
  }
  p = warp_sum(p);
  q = warp_sum(q);
  for (int s = t.gen_ptr[k] + lane; s < t.gen_ptr[k + 1]; s += kWarp) {
    const int gi = t.gen_idx[s];
    prow[2 * n + gi] = t.gen_on[gi];
    qrow[2 * n + t.g + gi] = t.gen_on[gi];
  }
  if (lane != 0) return;
  const int d = t.diag[k];
  const double gii = d >= 0 ? t.yg[d] : 0.0;
  const double bii = d >= 0 ? t.yb[d] : 0.0;
  prow[k] = q + bii * vk * vk;
  prow[n + k] = -(p / vk + gii * vk);
  qrow[k] = -(p - gii * vk * vk);
  qrow[n + k] = -(q / vk - bii * vk);
}

// H's rows theta_k (row k) and V_k (row n + k).
__device__ void hess_bus(const OpfTables& t, const double* __restrict__ x,
                         const double* __restrict__ y,
                         const double* __restrict__ z,
                         double* __restrict__ out, int k, int lane) {
  const int n = t.n;
  const int np = t.n_pair;
  const int nf = t.n_fl;
  const int64_t nx = t.n_x;
  double* trow = out + static_cast<int64_t>(k) * nx;
  double* vrow = out + static_cast<int64_t>(n + k) * nx;
  const double vk = x[n + k];
  const double tk = x[k];
  const double ypk = y[k];
  const double yqk = y[n + k];
  double dtt = 0.0, dtv = 0.0, dvt = 0.0, dvv = 0.0;
  for (int s = t.pair_ptr[k] + lane; s < t.pair_ptr[k + 1]; s += kWarp) {
    const int j = t.pair[s];
    const int ekj = t.pair[np + s];
    const int ejk = t.pair[2 * np + s];
    double ott = 0.0, otv = 0.0, ovt = 0.0, ovv = 0.0;
    if (j != k) {
      const double vj = x[n + j];
      const double tj = x[j];
      if (ekj >= 0) {  // entry (k, j): k is its row
        const EntryTerms c =
            entry_terms(t.yg[ekj], t.yb[ekj], vk, vj, tk - tj, ypk, yqk);
        dtt += c.tt;
        ott += -c.tt;
        dtv += c.tivi;
        dvt += c.tivi;
        otv += c.tivj;
        ovt += c.tjvi;
        ovv += c.vv;
      }
      if (ejk >= 0) {  // entry (j, k): k is its column
        const EntryTerms c = entry_terms(t.yg[ejk], t.yb[ejk], vj, vk,
                                         tj - tk, y[j], y[n + j]);
        dtt += c.tt;
        ott += -c.tt;
        otv += c.tjvi;
        dtv += c.tjvj;
        ovt += c.tivj;
        dvt += c.tjvj;
        ovv += c.vv;
      }
    } else if (ekj >= 0) {  // the diagonal entry: V_k^2 terms
      dvv += ypk * 2.0 * t.yg[ekj] - yqk * 2.0 * t.yb[ekj];
    }
    for (int q = t.pair_fptr[s]; q < t.pair_fptr[s + 1]; ++q) {
      const int f = t.pair_flow[q];
      const int lo = t.fl_idx[4 * nf + f];
      const int hi = t.fl_idx[5 * nf + f];
      double w = 0.0;
      if (lo >= 0) w = w + -z[lo];
      if (hi >= 0) w = w + z[hi];
      double gz[4];
      double hz[16];
      opf_terms::flow_derivs(flow_rows(t), x, f, gz, hz);
      const int ends[2] = {t.fl_idx[f], t.fl_idx[nf + f]};
      for (int a = 0; a < 2; ++a) {
        if (ends[a] != k) continue;
        for (int c = 0; c < 4; ++c) {
          const double th = w * hz[4 * a + c];        // row theta_k
          const double vv = w * hz[4 * (2 + a) + c];  // row V_k
          const bool at_k = ends[c & 1] == k;
          if (c < 2) {
            if (at_k) { dtt += th; dvt += vv; } else { ott += th; ovt += vv; }
          } else {
            if (at_k) { dtv += th; dvv += vv; } else { otv += th; ovv += vv; }
          }
        }
      }
    }
    if (j != k) {
      trow[j] = ott;
      trow[n + j] = otv;
      vrow[j] = ovt;
      vrow[n + j] = ovv;
    }
  }
  dtt = warp_sum(dtt);
  dtv = warp_sum(dtv);
  dvt = warp_sum(dvt);
  dvv = warp_sum(dvv);
  if (lane != 0) return;
  trow[k] = dtt;
  trow[n + k] = dtv;
  vrow[k] = dvt;
  vrow[n + k] = dvv;
}

// Row `row` (>= 2n) of [J_E; J_I]: one thread.
__device__ void jac_row(const OpfTables& t, const double* __restrict__ x,
                        double* __restrict__ out, int row) {
  const int d = row - 2 * t.n;
  const int nr = t.n_rows;
  double* hrow = out + static_cast<int64_t>(row) * t.n_x;
  const int c1 = t.row_col[d];
  const int c2 = t.row_col[nr + d];
  const double v1 = t.row_val[d];
  const double v2 = t.row_val[nr + d];
  if (t.row_kind[d] == kLinear) {
    if (c2 == c1) {
      hrow[c1] = v1 + v2;
      return;
    }
    hrow[c1] = v1;
    if (c2 >= 0) hrow[c2] = v2;
    return;
  }
  // a flow row: its sign times the four partials; one bus at both ends
  // (a loop branch) adds the two partials of each kind
  const int n = t.n;
  const int fb = t.fl_idx[c1];
  const int tb = t.fl_idx[t.n_fl + c1];
  double gz[4];
  opf_terms::flow_derivs(flow_rows(t), x, c1, gz, nullptr);
  if (fb == tb) {
    hrow[fb] = v1 * gz[0] + v1 * gz[1];
    hrow[n + fb] = v1 * gz[2] + v1 * gz[3];
    return;
  }
  hrow[fb] = v1 * gz[0];
  hrow[tb] = v1 * gz[1];
  hrow[n + fb] = v1 * gz[2];
  hrow[n + tb] = v1 * gz[3];
}

// Row `row` (>= 2n) of H: the cost's second derivative on the diagonal.
__device__ void hess_row(const OpfTables& t, const double* __restrict__ x,
                         double* __restrict__ out, int row) {
  const int v = row - 2 * t.n;
  const int beg = t.term_ptr[v];
  const int end = t.term_ptr[v + 1];
  if (beg == end) return;
  const double pq = x[row];
  double sum = 0.0;
  for (int s = beg; s < end; ++s) {
    const int deg = t.term[s];
    const double* co = t.term_co + t.term[t.n_term + s];
    double acc = 0.0;
    for (int j = 0; j < deg - 1; ++j) {  // descending coefficients of p''
      const int kk = deg - j;
      acc = acc * pq + co[j] * static_cast<double>(kk) *
                           static_cast<double>(kk - 1);
    }
    sum = sum + acc;
  }
  out[static_cast<int64_t>(row) * t.n_x + row] = sum;
}

// Blocks [0, bus_blocks) own `bus_units` buses each, the rest `row_units`
// rows of 2n..rows. `zero` is 0 when the caller has zeroed the output.
__global__ void __launch_bounds__(kThreads)
opf_fill_kernel(OpfTables t, const double* __restrict__ x,
                const double* __restrict__ y, const double* __restrict__ z,
                double* __restrict__ out, int hessian, int zero, int rows,
                int bus_blocks, int bus_units, int row_units) {
  const int n = t.n;
  const int64_t nx = t.n_x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (static_cast<int>(blockIdx.x) < bus_blocks) {
    const int first = blockIdx.x * bus_units;
    const int count = min(bus_units, n - first);
    if (zero) {
      zero_span(out + first * nx, count * nx);
      zero_span(out + (n + first) * nx, count * nx);
    }
    __syncthreads();
    // blockDim.x is a multiple of 32, so a warp leaves here as a whole and
    // the full-mask shuffles see all 32 lanes
    if (w >= count) return;
    if (hessian) {
      hess_bus(t, x, y, z, out, first + w, lane);
    } else {
      jac_bus(t, x, out, first + w, lane);
    }
    return;
  }
  const int first =
      2 * n + (static_cast<int>(blockIdx.x) - bus_blocks) * row_units;
  const int count = min(row_units, rows - first);
  if (zero) zero_span(out + first * nx, count * nx);
  __syncthreads();
  if (w >= count || lane != 0) return;
  if (hessian) {
    hess_row(t, x, out, first + w);
  } else {
    jac_row(t, x, out, first + w);
  }
}

}  // namespace

// Launch K6 on `stream`. `t` holds the spec's tables (device pointers, see
// OpfTables). x[n_x] is the point; with `hessian` 0 the launch fills `out`,
// a [m_E + m_I, n_x] buffer, with J_E over J_I; with `hessian` 1 it fills
// the [n_x, n_x] buffer `out` with the Lagrangian Hessian for the raw duals
// y[m_E] and z[m_I] (z may be null without flow rows). `zero` 0 leaves
// the zeros to the caller (a memset before the launch). Returns a
// cudaError_t code.
extern "C" int opf_fill_launch(const OpfTables* t, const double* x,
                               const double* y, const double* z,
                               double* out, int hessian, int zero,
                               void* stream) {
  if (t == nullptr || t->n <= 0 || t->n_x < 2 * t->n || x == nullptr ||
      (hessian && (y == nullptr || (t->n_fl > 0 && z == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  const int64_t rows =
      hessian ? t->n_x : static_cast<int64_t>(t->m_e) + t->m_i;
  if (rows * static_cast<int64_t>(t->n_x) == 0) return cudaSuccess;
  if (out == nullptr || rows > INT32_MAX) return cudaErrorInvalidValue;
  const int bus_units = units_per_block(2 * static_cast<int64_t>(t->n_x));
  const int row_units = units_per_block(t->n_x);
  const int64_t bus_blocks = (t->n + bus_units - 1) / bus_units;
  const int64_t blocks =
      bus_blocks + (rows - 2 * t->n + row_units - 1) / row_units;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  opf_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      *t, x, y, z, out, hessian, zero, static_cast<int>(rows),
      static_cast<int>(bus_blocks), bus_units, row_units);
  return cudaGetLastError();
}

extern "C" const char* opf_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
