// K3 se_fill: AC state-estimation measurement functions, residuals and the
// dense masked measurement Jacobian.
//
// Replaces the jnp device routines of juliagrid_tpu/estimation/acse.py:
// h_entries (:463), the dense scatter of build_h (:549) and the status and
// slack-column entry masks of gn_increment (:639-642). There they are one
// gather-evaluate-scatter per row group (voltmeter and PMU bus rows, 14
// branch groups, P and Q injections over the Y-bus entries) and a
// scatter-add into a zeroed H; here one launch does all 21 row types for
// B >= 1 scenarios of one measurement set.
//
// Mapping, with the Jacobian: one warp per (scenario, measurement row),
// driven by a per-row descriptor table (structure of arrays, built once on
// the host): idx[0][row] the row's type code, idx[1][row] its bus or
// from-bus, idx[2][row] its to-bus, and coef[0..4][row] the PiModel
// coefficients a, b, c, d and the shift angle phi. Voltmeter, PMU and
// branch rows are closed-form: lane 0 evaluates h and writes the row's 1-4
// Jacobian entries. An injection row (types 6, 9) walks its bus's CSR
// segment of the Y-bus entry list 32 entries at a time: each lane
// accumulates its part of P and Q and writes the off-diagonal pair
// (dP/dtheta_j, dP/dV_j, or the Q pair) at cols[k] and n + cols[k]; a warp
// shuffle sums P and Q, and lane 0 writes h and the diagonal pair. The
// entry list is unique per (row, col) and a branch row's two buses differ
// (both checked on the host), so every element of H has one writer after
// the zeroing: no atomics, and the result does not depend on scheduling.
//
// H crosses device memory once, with no separate memset. A thread block
// owns 1-8 consecutive rows of H (about 16 KB), which lie one after another
// in memory: all its threads first zero them as one region with 16-byte
// stores, neighbouring threads on neighbouring addresses, and after a
// barrier each warp writes its row's values into lines still in L2. The
// zeroing stores of a block are contiguous, as a memset's are;
// scripts/k3_k5_pair.py times each call beside a PyTorch zero_() of H.
//
// Without the Jacobian there is nothing to zero, and a warp per closed-form
// row would idle 31 lanes: the host sorts the rows by class once
// (order[]: closed-form rows, then injection rows), and one launch gives a
// thread to each (scenario, closed-form row) and a warp to each (scenario,
// injection row). Every row still writes h and r at its own index, with
// the same lane grouping and so the same bits as with the Jacobian.
//
// Masks: every value is multiplied by the row's status (build_h's
// H * status), and the slack column (the slack bus's angle) is left at
// zero unless `slack` is -1, which build_h's unmasked H asks for.
//
// Rounding: the branch-row expressions are differences of large, nearly
// equal terms (|I_ij| of a low-impedance branch: a Vi^2 + b Vj^2 - 2 Vi Vj
// cd with a, b ~ 1/x^2), so a changed rounding shows up magnified. The
// source associates every product as the plain version does (x**2 as
// x * x, then left to right), and _build.py compiles it with -fmad=false,
// so each product and sum rounds on its own as the plain version's
// op-by-op kernels do; only the injection rows' summation order differs.
//
// Routed mode (se_fill_routed_launch) replaces the per-block H of the BBD
// estimator, juliagrid_tpu/estimation/acse_bbd.py:256-302 (h_entries routed
// into H_int and H_bdr by _gains_block, with its status and slack masks):
// the same row evaluation (fill_row), one scenario, each row written into
// its block's [mr, 2ni + 2lb] matrix, its columns mapped per block
// (interior slots, then local border slots), each value times the row's
// status and the square root of its weight. A warp owns one (block, slot)
// row of the per-block matrices: slot_row[block mr + slot], the host-built
// inverse of the row -> (block, slot) map, names its measurement row, or
// -1 for a pad slot. Inside the launched block range the thread block
// zeroes its rows as one region and each warp then fills its row; outside
// it the warp only computes h and r (every measurement row lies on one
// slot). The host partition gives every
// row's variables to one block, and the column map is one-to-one inside a
// block, so every element still has one writer.
//
// Entry mode (se_fill_entries_launch) replaces the entry list of the JAX
// package's gn_increment (h_entries with the status and slack-column masks
// applied in entry space, acse.py:639-642): instead of a dense H, the
// values [B, E] in h_entry_pattern's order, each times its row's status and
// zero in the slack column, for K8 (gain_fill.cu) to form the gain from.
// It takes the mapping without the Jacobian (a thread per closed-form row,
// a warp per injection row) and writes each value at a host-built position
// (epos[4][m], se_fill.py::entry_positions): a closed-form row's 1-4 values
// at epos[0..3][row]; an injection row's values at Y entry k at epos[0][row]
// + k (angle) and epos[1][row] + k (magnitude), the zero of its own bus's
// Y entry included, and its diagonal pair at epos[2][row], epos[3][row].
// Every entry of the pattern has one writer, so there is nothing to zero.
//
// Bound: with the Jacobian, writing B m 2n doubles once at full memory
// bandwidth: 2.2 GB for case118 x1024, 10.9 GB for 32 scenarios of a
// 1,369-bus grid, about 0.7 and 3.3 ms at 3.35 TB/s; the values are 1-4
// doubles a row (2 + 2 deg(bus) for an injection row) inside that. Without
// the Jacobian the launch reads the state and the entry list once and is
// bound by launch latency. Offsets into H are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

// The tables of one measurement set on one network (and, for the routed
// mode, one partition), built once on the host (se_fill.py::_Tables). At
// file scope, so that the extern "C" launchers that take it keep their
// external linkage.
struct SeTables {
  const int* idx;       // [3, m] type code, bus or from-bus, to-bus
  const double* coef;   // [5, m] a, b, c, d, phi
  const int* order;     // [m] closed-form rows, then injection rows
  const int* row_ptr;   // [n + 1] Y-bus CSR
  const int* cols;      // [nnz]
  const double* yg;     // [nnz]
  const double* yb;     // [nnz]
  const int* diag;      // [n]
  const int* slot_row;  // [k mr] routed: measurement row of a slot, or -1
  const int* colmap;    // [k, n] routed: angle column of bus j in block b
  const int* epos;      // [4, m] entry mode: positions of a row's values
  int n;
  int m;
  int closed;           // closed-form rows, at the head of order
  int ni;               // routed layout: interior slots,
  int lb;               // local border slots,
  int mr;               // row slots of a block,
  int k;                // blocks
  int entries;          // entry mode: values a scenario
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

struct Entries {
  double h, dti, dtj, dvi, dvj;
};

// ops/equations.py eval_* for one branch row, by type code; the angles
// already carry the phase shift.
__device__ Entries eval_branch(int code, double a, double b, double c,
                               double d, double vi, double vj, double ti,
                               double tj) {
  Entries e{};
  double st, ct;
  sincos(ti - tj, &st, &ct);
  switch (code) {
    case 7: {  // P_ij
      const double bc = b * ct + c * st;
      e.h = a * (vi * vi) - bc * vi * vj;
      e.dti = (b * st - c * ct) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = 2 * a * vi - bc * vj;
      e.dvj = -bc * vi;
      return e;
    }
    case 8: {  // P_ji
      const double bc = b * ct - c * st;
      e.h = a * (vj * vj) - bc * vi * vj;
      e.dti = (b * st + c * ct) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = -bc * vj;
      e.dvj = 2 * a * vj - bc * vi;
      return e;
    }
    case 10: {  // Q_ij
      const double sc = b * st - c * ct;
      e.h = -a * (vi * vi) - sc * vi * vj;
      e.dti = -(b * ct + c * st) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = -2 * a * vi - sc * vj;
      e.dvj = -sc * vi;
      return e;
    }
    case 11: {  // Q_ji
      const double sc = b * st + c * ct;
      e.h = -a * (vj * vj) + sc * vi * vj;
      e.dti = (b * ct - c * st) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = sc * vj;
      e.dvj = -2 * a * vj + sc * vi;
      return e;
    }
    case 2:    // |I_ij|
    case 3: {  // |I_ji|
      const double cd = code == 2 ? c * ct - d * st : c * ct + d * st;
      const double mag2 = a * (vi * vi) + b * (vj * vj) - 2 * vi * vj * cd;
      const double h = sqrt(mag2);
      const double inv = 1.0 / h;
      e.h = h;
      e.dti = inv * (code == 2 ? c * st + d * ct : c * st - d * ct) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = inv * (a * vi - cd * vj);
      e.dvj = inv * (b * vj - cd * vi);
      return e;
    }
    case 4:    // |I_ij|^2
    case 5: {  // |I_ji|^2
      const double cd = code == 4 ? c * ct - d * st : c * ct + d * st;
      e.h = a * (vi * vi) + b * (vj * vj) - 2 * vi * vj * cd;
      e.dti = 2 * (code == 4 ? c * st + d * ct : c * st - d * ct) * vi * vj;
      e.dtj = -e.dti;
      e.dvi = 2 * (a * vi - cd * vj);
      e.dvj = 2 * (b * vj - cd * vi);
      return e;
    }
    default:
      break;
  }
  double sti, cti, stj, ctj;
  sincos(ti, &sti, &cti);
  sincos(tj, &stj, &ctj);
  switch (code) {
    case 14: {  // current angle psi_ij
      const double re = (a * cti - b * sti) * vi - (c * ctj - d * stj) * vj;
      const double im = (a * sti + b * cti) * vi - (c * stj + d * ctj) * vj;
      const double inv2 = 1.0 / (re * re + im * im);
      const double a_sq = a * a + b * b;
      const double b_sq = c * c + d * d;
      const double c_sq = a * c + b * d;
      const double d_sq = b * c - a * d;
      const double cd = c_sq * ct - d_sq * st;
      const double sd = c_sq * st + d_sq * ct;
      e.h = atan2(im, re);
      e.dti = inv2 * (a_sq * (vi * vi) - cd * vi * vj);
      e.dtj = inv2 * (b_sq * (vj * vj) - cd * vi * vj);
      e.dvi = -inv2 * sd * vj;
      e.dvj = inv2 * sd * vi;
      return e;
    }
    case 15: {  // current angle psi_ji
      const double re = (a * ctj - b * stj) * vj - (c * cti - d * sti) * vi;
      const double im = (a * stj + b * ctj) * vj - (c * sti + d * cti) * vi;
      const double inv2 = 1.0 / (re * re + im * im);
      const double a_sq = c * c + d * d;
      const double b_sq = a * a + b * b;
      const double c_sq = a * c + b * d;
      const double d_sq = b * c - a * d;
      const double cd = c_sq * ct + d_sq * st;
      const double sd = c_sq * st - d_sq * ct;
      e.h = atan2(im, re);
      e.dti = inv2 * (a_sq * (vi * vi) - cd * vi * vj);
      e.dtj = inv2 * (b_sq * (vj * vj) - cd * vi * vj);
      e.dvi = -inv2 * sd * vj;
      e.dvj = inv2 * sd * vi;
      return e;
    }
    case 18:  // Re I_ij
      e.h = (a * cti - b * sti) * vi - (c * ctj - d * stj) * vj;
      e.dti = -(a * sti + b * cti) * vi;
      e.dtj = (c * stj + d * ctj) * vj;
      e.dvi = a * cti - b * sti;
      e.dvj = -c * ctj + d * stj;
      return e;
    case 19:  // Re I_ji
      e.h = (a * ctj - b * stj) * vj - (c * cti - d * sti) * vi;
      e.dti = (c * sti + d * cti) * vi;
      e.dtj = -(a * stj + b * ctj) * vj;
      e.dvi = -c * cti + d * sti;
      e.dvj = a * ctj - b * stj;
      return e;
    case 20:  // Im I_ij
      e.h = (a * sti + b * cti) * vi - (c * stj + d * ctj) * vj;
      e.dti = (a * cti - b * sti) * vi;
      e.dtj = (-c * ctj + d * stj) * vj;
      e.dvi = a * sti + b * cti;
      e.dvj = -c * stj - d * ctj;
      return e;
    case 21:  // Im I_ji
      e.h = (a * stj + b * ctj) * vj - (c * sti + d * cti) * vi;
      e.dti = (-c * cti + d * sti) * vi;
      e.dtj = (a * ctj - b * stj) * vj;
      e.dvi = -c * sti - d * cti;
      e.dvj = a * stj + b * ctj;
      return e;
    default:
      e.h = nan("");
      return e;
  }
}

// One measurement row of one scenario, evaluated by a warp: `put(col, v,
// slot, k)` receives every Jacobian value with its column in the 2n state
// vector (theta then V), its slot (0-3: the value's order in a closed-form
// row; an injection row's angle 0 and magnitude 1 at Y entry k, its
// diagonal pair 2 and 3) and stores it where the mode wants it; lane 0
// writes h and the residual. kEveryEntry also puts the zero values of an
// injection row at its own bus's Y entry (the entry mode writes every entry
// of the pattern).
template <bool kEveryEntry, class Put>
__device__ __forceinline__ void fill_row(
    int row, int m, int lane, const int* __restrict__ idx,
    const double* __restrict__ coef, double st,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const double* __restrict__ yg, const double* __restrict__ yb,
    const int* __restrict__ diag, const double* __restrict__ vmb,
    const double* __restrict__ vab, int n, const double* __restrict__ mean,
    double* __restrict__ h, double* __restrict__ r, int64_t out, Put put) {
  const int code = idx[row];
  const int f = idx[m + row];
  double hv;
  if (code == 6 || code == 9) {  // P or Q injection at bus f
    const double vi = vmb[f];
    const double ti = vab[f];
    double sp = 0.0;
    double sq = 0.0;
    const int end = row_ptr[f + 1];
    for (int k = row_ptr[f] + lane; k < end; k += kWarp) {
      const int c = cols[k];
      double s, co;
      sincos(ti - vab[c], &s, &co);
      const double g = yg[k];
      const double bk = yb[k];
      const double gc_bs = g * co + bk * s;  // G cos + B sin
      const double gs_bc = g * s - bk * co;  // G sin - B cos
      const double vv = vi * vmb[c];
      sp += vv * gc_bs;
      sq += vv * gs_bc;
      if (c != f) {
        if (code == 6) {
          put(c, vv * gs_bc, 0, k);      // dP/dtheta_j
          put(n + c, vi * gc_bs, 1, k);  // dP/dV_j
        } else {
          put(c, -vv * gc_bs, 0, k);     // dQ/dtheta_j
          put(n + c, vi * gs_bc, 1, k);  // dQ/dV_j
        }
      } else if (kEveryEntry) {  // acse.py's off-diagonal mask, times 0
        if (code == 6) {
          put(c, (vv * gs_bc) * 0.0, 0, k);
          put(n + c, (vi * gc_bs) * 0.0, 1, k);
        } else {
          put(c, (-vv * gc_bs) * 0.0, 0, k);
          put(n + c, (vi * gs_bc) * 0.0, 1, k);
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      sp += __shfl_down_sync(0xffffffffu, sp, off);
      sq += __shfl_down_sync(0xffffffffu, sq, off);
    }
    if (lane != 0) return;
    const double gii = yg[diag[f]];
    const double bii = yb[diag[f]];
    if (code == 6) {
      hv = sp;
      put(f, -sq - bii * (vi * vi), 2, 0);
      put(n + f, sp / vi + gii * vi, 3, 0);
    } else {
      hv = sq;
      put(f, sp - gii * (vi * vi), 2, 0);
      put(n + f, sq / vi - bii * vi, 3, 0);
    }
  } else {
    if (lane != 0) return;
    if (code == 1) {  // bus voltage magnitude (voltmeter, polar PMU)
      hv = vmb[f];
      put(n + f, 1.0, 0, 0);
    } else if (code == 13) {  // bus voltage angle (polar PMU)
      hv = vab[f];
      put(f, 1.0, 0, 0);
    } else if (code == 16 || code == 17) {  // Re V, Im V (rectangular PMU)
      double s, c;
      sincos(vab[f], &s, &c);
      const double v = vmb[f];
      if (code == 16) {
        hv = v * c;
        put(f, -v * s, 0, 0);
        put(n + f, c, 1, 0);
      } else {
        hv = v * s;
        put(f, v * c, 0, 0);
        put(n + f, s, 1, 0);
      }
    } else {  // branch rows: from-side rows shift theta_j by +phi, to-side
              // phasor rows (15, 19, 21) theta_i by -phi (acse.py:497-503)
      const int t = idx[2 * m + row];
      const double phi = coef[4 * m + row];
      double ti = vab[f];
      double tj = vab[t];
      if (code == 15 || code == 19 || code == 21) {
        ti -= phi;
      } else {
        tj += phi;
      }
      const Entries e = eval_branch(code, coef[row], coef[m + row],
                                    coef[2 * m + row], coef[3 * m + row],
                                    vmb[f], vmb[t], ti, tj);
      hv = e.h;
      put(f, e.dti, 0, 0);
      put(t, e.dtj, 1, 0);
      put(n + f, e.dvi, 2, 0);
      put(n + t, e.dvj, 3, 0);
    }
  }
  const double hs = hv * st;
  h[out] = hs;
  r[out] = mean[out] - hs;
}

// A thread block owns `rows` (1-8) consecutive rows of H, one a warp,
// which lie one after another in memory: the whole block first zeroes them
// as one region with 16-byte stores, neighbouring threads on neighbouring
// addresses; after a barrier each warp writes its row's values. The
// launcher sizes the region to about kRegion bytes, so that the lines the
// values land in are still in L2 when they come.
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int64_t kRegion = 16 * 1024;

// Rows of `len` doubles a thread block owns.
int rows_per_block(int64_t len) {
  const int64_t rows = kRegion / (8 * len);
  return static_cast<int>(rows < 1 ? 1 : rows > kRowsPerBlock
                                            ? kRowsPerBlock : rows);
}

// Zero `len` doubles at `base` (16-byte aligned, `len` even) with the
// threads of the block, then wait for the block. Every thread calls it.
__device__ __forceinline__ void zero_region(double* base, int64_t len) {
  double2* p = reinterpret_cast<double2*>(base);
  const double2 z = make_double2(0.0, 0.0);
  for (int64_t c = threadIdx.x; c < len / 2; c += kThreads) p[c] = z;
  __syncthreads();
}

// The jacobian-free put: values are not stored.
struct NoPut {
  __device__ void operator()(int, double, int, int) const {}
};

// The entry mode's put: the value times the row's status, times 0 in the
// slack column (acse.py:642's order), at the row's position for the slot.
struct EntryPut {
  double* vals;       // this scenario's [E] values
  const int* epos;    // [4, m]
  int m;
  int row;
  int slack;
  double st;
  __device__ void operator()(int col, double v, int slot, int k) const {
    vals[epos[slot * m + row] + k] = (v * st) * (col == slack ? 0.0 : 1.0);
  }
};

__global__ void __launch_bounds__(kThreads)
se_fill_kernel(SeTables t, const double* __restrict__ status, int slack,
               const double* __restrict__ vm, const double* __restrict__ va,
               const double* __restrict__ mean, double* __restrict__ h,
               double* __restrict__ r, double* __restrict__ jac, int batch,
               int rows) {
  const int m = t.m;
  const int n = t.n;
  const int64_t units = static_cast<int64_t>(m) * batch;
  const int64_t len = 2 * static_cast<int64_t>(n);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows;
  const int w = threadIdx.x / kWarp;
  const int64_t unit = first + w;  // b m + row
  const int lane = threadIdx.x % kWarp;
  zero_region(jac + first * len,
              min(static_cast<int64_t>(rows), units - first) * len);
  // blockDim.x is a multiple of 32, so a warp leaves here as a whole and
  // the full-mask shuffles below see all 32 lanes.
  if (w >= rows || unit >= units) return;
  const int b = static_cast<int>(unit / m);
  const int row = static_cast<int>(unit % m);
  const double st = status[row];
  double* hrow = jac + unit * len;
  auto put = [&](int col, double v, int, int) {
    if (col != slack) hrow[col] = v * st;
  };
  fill_row<false>(row, m, lane, t.idx, t.coef, st, t.row_ptr, t.cols, t.yg,
                  t.yb, t.diag, vm + static_cast<int64_t>(b) * n,
                  va + static_cast<int64_t>(b) * n, n, mean, h, r, unit, put);
}

// h and r alone, or (kEntries) with the entry values `vals` [B, E]. Blocks
// [0, closed_blocks) give a thread to each (scenario, closed-form row), the
// rest a warp to each (scenario, injection row); the rows come from order[]
// (closed-form rows first).
template <bool kEntries>
__global__ void __launch_bounds__(kThreads)
se_values_kernel(SeTables t, const double* __restrict__ status, int slack,
                 const double* __restrict__ vm, const double* __restrict__ va,
                 const double* __restrict__ mean, double* __restrict__ h,
                 double* __restrict__ r, double* __restrict__ vals, int batch,
                 int closed_blocks) {
  const int m = t.m;
  const int n = t.n;
  const int closed = t.closed;
  int64_t unit;
  int lane;
  int rows;
  int first;
  if (static_cast<int>(blockIdx.x) < closed_blocks) {
    unit = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    lane = 0;
    rows = closed;
    first = 0;
  } else {
    unit = (static_cast<int64_t>(blockIdx.x - closed_blocks) * blockDim.x
            + threadIdx.x) / kWarp;
    lane = threadIdx.x % kWarp;
    rows = m - closed;
    first = closed;
  }
  // a closed-form block's threads leave one by one (that path has no
  // shuffle); an injection block's warps leave whole
  if (rows == 0 || unit >= static_cast<int64_t>(rows) * batch) return;
  const int b = static_cast<int>(unit / rows);
  const int row = t.order[first + static_cast<int>(unit % rows)];
  const int64_t out = static_cast<int64_t>(b) * m + row;
  const double st = status[row];
  if constexpr (kEntries) {
    const EntryPut put{vals + static_cast<int64_t>(b) * t.entries, t.epos, m,
                       row, slack, st};
    fill_row<true>(row, m, lane, t.idx, t.coef, st, t.row_ptr, t.cols, t.yg,
                   t.yb, t.diag, vm + static_cast<int64_t>(b) * n,
                   va + static_cast<int64_t>(b) * n, n, mean, h, r, out, put);
  } else {
    fill_row<false>(row, m, lane, t.idx, t.coef, st, t.row_ptr, t.cols, t.yg,
                    t.yb, t.diag, vm + static_cast<int64_t>(b) * n,
                    va + static_cast<int64_t>(b) * n, n, mean, h, r, out,
                    NoPut{});
  }
}

// Routed mode, one scenario: warp w owns row w % mr of block w / mr, and a
// thread block kRowsPerBlock such rows; those of the launched block range
// lie one after another in `hblk`, and the thread block zeroes them as one
// region. The warp's measurement row is slot_row[w] (-1: a pad slot).
// Column of bus j in block b: a = colmap[b n + j], the angle's local column
// (an interior slot, or 2ni + a local border slot); the magnitude's is
// a + ni for an interior bus, a + lb for a border bus. Values are scaled
// by the row's status and by scale[row] (the square root of its weight).
__global__ void __launch_bounds__(kThreads)
se_fill_routed_kernel(SeTables t, const double* __restrict__ status,
                      int slack, const double* __restrict__ vm,
                      const double* __restrict__ va,
                      const double* __restrict__ mean,
                      double* __restrict__ h, double* __restrict__ r,
                      const double* __restrict__ scale,
                      double* __restrict__ hblk, int block_lo,
                      int block_hi, int rows) {
  const int n = t.n;
  const int ni = t.ni;
  const int lb = t.lb;
  const int mr = t.mr;
  const int64_t units = static_cast<int64_t>(t.k) * mr;
  const int64_t width = 2 * static_cast<int64_t>(ni) + 2 * lb;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows;
  const int w = threadIdx.x / kWarp;
  const int64_t unit = first + w;
  const int lane = threadIdx.x % kWarp;
  // this thread block's units inside the launched block range
  const int64_t lo = static_cast<int64_t>(block_lo) * mr;
  int64_t in_lo = 0;
  int64_t in_hi = 0;
  if (hblk != nullptr) {
    in_lo = max(first, lo);
    in_hi = max(in_lo, min(min(first + rows, units),
                           static_cast<int64_t>(block_hi) * mr));
  }
  zero_region(hblk == nullptr ? nullptr : hblk + (in_lo - lo) * width,
              (in_hi - in_lo) * width);
  if (w >= rows || unit >= units) return;
  const int row = t.slot_row[unit];
  if (row < 0) return;  // a pad slot (warp-uniform)
  double* hrow =
      unit >= in_lo && unit < in_hi ? hblk + (unit - lo) * width : nullptr;
  const int* cmap = t.colmap + (unit / mr) * n;
  const double st = status[row];
  const double rs = scale[row];
  auto put = [&](int col, double v, int, int) {
    if (hrow == nullptr || col == slack) return;
    const bool mag = col >= n;
    const int a = cmap[mag ? col - n : col];
    if (a < 0) return;  // not a variable of this block (host-checked)
    hrow[mag ? a + (a < ni ? ni : lb) : a] = v * st * rs;
  };
  fill_row<false>(row, t.m, lane, t.idx, t.coef, st, t.row_ptr, t.cols, t.yg,
                  t.yb, t.diag, vm, va, n, mean, h, r, row, put);
}

int64_t blocks_of(int64_t threads) {
  return (threads + kThreads - 1) / kThreads;
}

// Blocks of the mapping without the Jacobian: (closed-form blocks, all).
void values_blocks(const SeTables* t, int batch, int64_t* closed,
                   int64_t* blocks) {
  *closed = blocks_of(static_cast<int64_t>(t->closed) * batch);
  *blocks = *closed + blocks_of(static_cast<int64_t>(t->m - t->closed) *
                                batch * kWarp);
}

}  // namespace

// Launch K3 on `stream`. `t` holds the measurement set's and the network's
// tables (device pointers): the descriptor table idx[3][m] (int) and
// coef[5][m], the class order[m], the Y-bus entry list (row_ptr[n + 1],
// cols/yg/yb[nnz], diag[n]). status[m], the row-major [batch, n] state and
// the [batch, m] means are inputs; h and r ([batch, m]) outputs, and `jac`
// a [batch, m, 2n] buffer that the launch fills whole, or null to skip the
// Jacobian. `slack` is the column to leave at zero, or -1. Returns a
// cudaError_t code.
extern "C" int se_fill_launch(const SeTables* t, const double* status,
                              int slack, const double* vm, const double* va,
                              const double* mean, double* h, double* r,
                              double* jac, int batch, void* stream) {
  if (t == nullptr || t->n <= 0 || t->m <= 0 || batch <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks;
  if (jac != nullptr) {
    const int rows = rows_per_block(2 * static_cast<int64_t>(t->n));
    const int64_t units = static_cast<int64_t>(t->m) * batch;
    blocks = (units + rows - 1) / rows;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    se_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, status, slack, vm, va, mean, h, r, jac, batch, rows);
  } else {
    int64_t closed;
    values_blocks(t, batch, &closed, &blocks);
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    se_values_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, status, -1, vm, va, mean, h, r, nullptr, batch,
        static_cast<int>(closed));
  }
  return cudaGetLastError();
}

// Launch K3's entry mode on `stream`: h and r ([batch, m]) as above, and the
// [batch, entries] values `vals` in the pattern's order, each times its
// row's status and 0 in the column `slack`, written whole. `t` also holds
// epos[4, m]. Returns a cudaError_t code.
extern "C" int se_fill_entries_launch(const SeTables* t, const double* status,
                                      int slack, const double* vm,
                                      const double* va, const double* mean,
                                      double* h, double* r, double* vals,
                                      int batch, void* stream) {
  if (t == nullptr || t->n <= 0 || t->m <= 0 || t->epos == nullptr ||
      t->entries <= 0 || vals == nullptr || batch <= 0) {
    return cudaErrorInvalidValue;
  }
  int64_t closed, blocks;
  values_blocks(t, batch, &closed, &blocks);
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  se_values_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      *t, status, slack, vm, va, mean, h, r, vals, batch,
      static_cast<int>(closed));
  return cudaGetLastError();
}

// Launch K3's routed mode for one state on `stream`: h and r ([m]) as
// above, and, unless `hblk` is null, the [block_hi - block_lo, mr, 2ni +
// 2lb] per-block matrices `hblk`, filled whole. `t` also holds slot_row[k
// mr] and colmap[k, n]. Returns a cudaError_t code.
extern "C" int se_fill_routed_launch(const SeTables* t, const double* status,
                                     int slack, const double* vm,
                                     const double* va, const double* mean,
                                     double* h, double* r,
                                     const double* scale, double* hblk,
                                     int block_lo, int block_hi,
                                     void* stream) {
  if (t == nullptr || t->n <= 0 || t->m <= 0 || t->ni <= 0 || t->lb <= 0 ||
      t->mr <= 0 || t->k <= 0 || block_lo < 0 || block_hi < block_lo ||
      block_hi > t->k) {
    return cudaErrorInvalidValue;
  }
  const int rows =
      rows_per_block(2 * static_cast<int64_t>(t->ni) + 2 * t->lb);
  const int64_t blocks =
      (static_cast<int64_t>(t->k) * t->mr + rows - 1) / rows;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  se_fill_routed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      *t, status, slack, vm, va, mean, h, r, scale, hblk, block_lo,
      block_hi, rows);
  return cudaGetLastError();
}

extern "C" const char* se_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
