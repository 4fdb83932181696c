// K8 gain_fill: the normal equations of the WLS estimators, formed from the
// fixed entry pattern of the measurement Jacobian H.
//
// Replaces the dense gain of the port's estimators (the f64 GEMM
// (W½H)ᵀ(W½H) over an H that is more than 99% zeros) with what the JAX
// package's juliagrid_tpu/estimation/acse.py::gn_increment (:597) is built
// around: H as its entry list (h_entries values in h_entry_pattern order,
// masked in entry space, :642), never a dense H. For B >= 1 scenarios of
// one pattern it writes
//
//   G   = Hᵀ W H + Hᵀ P H + e_s e_sᵀ     [B, N, N], every element once
//   rhs = Hᵀ (W r + P r)                [B, N]
//
// with W the diagonal weights w[m], P the off-diagonals pair_off[p] of the
// correlated 2x2 blocks (rows pair_r1[p], pair_r2[p]) and e_s the slack
// column (none when slack is -1: the PMU estimator).
//
// Tables (host-built once per pattern, gain_fill.py::gain_fill_table; row
// status, weights and values only multiply, so status edits, variance
// edits and every scenario of a fleet reuse them): the coalesced entries
// (the pattern's duplicates at one (row, column) summed in ascending raw
// position; an entry with one raw position is read directly), G's
// structural nonzeros in CSR by G row with ascending columns, and for each
// nonzero its contributions in a host-fixed order, each two entry
// references and a weight (w[r], or pair_off[p] for a pair term):
// w * (a * b). rhs's column lists name each column's entries in ascending
// row with their rows.
//
// Mapping: one warp per (scenario, G row). The warp streams the row in
// chunks of 32 VEC columns (VEC = 2 when N is even: 16-byte stores, lanes
// on neighbouring addresses); a chunk without structural nonzeros is
// stored as zeros straight away. For a chunk with nonzeros the warp zeroes
// its slice of shared memory, each lane sums the contributions of one
// nonzero (sequentially, from 0.0, in the table's order) into it, and the
// lanes then store the chunk from shared memory. So every element of G is
// written once by one lane, zeros included, with no memset, no atomics and
// no dependence on scheduling. After the G rows come warps of rhs: a warp
// per (scenario, 32 columns), a lane a column summing its entries
// sequentially. _build.py compiles this source with -fmad=false, so every
// product and sum rounds on its own, as the plain version's elementwise
// ops and fixed-order segment sums do: the kernel and gain_fill_ref agree
// bit for bit.
//
// Bound: writing G (B N² doubles) once at the HBM rate, plus the values,
// the residuals and the tables read once: 456 MB at case118 x1024 (N =
// 236), 1.92 GB at 1,369 buses x32 (N = 2,738), 0.8 GB for the 10k-bus DC
// estimator (N = 10,000), 0.14-0.57 ms at 3.35 TB/s. The structural
// nonzeros are a few in a thousand of G; their contributions are read from
// L1/L2 (the tables are shared by the scenarios).

#include <cuda_runtime.h>

#include <cstdint>

// K8's tables (device pointers) and sizes, gain_fill.py::_Tables. At file
// scope, so that the extern "C" launcher that takes it keeps its external
// linkage.
struct GainTables {
  const int* nz_ptr;   // [N + 1] G row i's nonzeros
  const int* nz_col;   // [Z] their columns, ascending within a row
  const int* c_ptr;    // [Z + 1] each nonzero's contributions
  const int* c_a;      // [C] entry reference of a (>= 0: a raw position,
  const int* c_b;      // [C] ... of b           else -(d + 1): duplicate d)
  const int* c_w;      // [C] weight: r < m is w[r], m + p is pair_off[p]
  const int* dup_ptr;  // [D + 1] raw positions of each duplicated entry
  const int* dup_raw;  // [..]
  const int* col_ptr;  // [N + 1] column i's entries, ascending row
  const int* col_ref;  // [..] their references
  const int* col_row;  // [..] their rows
  const int* pair_of;  // [m] the pair of a row, or -1
  const int* partner;  // [m] the other row of that pair
  int n;               // N, the order of G
  int m;               // rows
  int entries;         // raw entries a scenario
  int slack;           // the slack column, or -1
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxChunk = 2 * kWarp;

// The value of an entry reference in one scenario's raw values `v`.
__device__ __forceinline__ double entry(const GainTables& t,
                                        const double* __restrict__ v,
                                        int ref) {
  if (ref >= 0) return v[ref];
  const int d = -ref - 1;
  double s = 0.0;
  for (int q = t.dup_ptr[d]; q < t.dup_ptr[d + 1]; ++q) s += v[t.dup_raw[q]];
  return s;
}

template <int VEC>
__device__ __forceinline__ void store_zeros(double* __restrict__ row, int c) {
  if (VEC == 2) {
    *reinterpret_cast<double2*>(row + c) = make_double2(0.0, 0.0);
  } else {
    row[c] = 0.0;
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(double* __restrict__ row, int c,
                                            const double* buf, int k) {
  if (VEC == 2) {
    *reinterpret_cast<double2*>(row + c) = make_double2(buf[k], buf[k + 1]);
  } else {
    row[c] = buf[k];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gain_fill_kernel(GainTables t, const double* __restrict__ vals,
                 const double* __restrict__ w,
                 const double* __restrict__ off,
                 const double* __restrict__ r, double* __restrict__ g,
                 double* __restrict__ rhs, int batch) {
  constexpr int kChunk = kWarp * VEC;
  __shared__ double chunk[kWarps][kMaxChunk];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n = t.n;
  const int64_t rows = static_cast<int64_t>(batch) * n;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (unit >= rows) {  // rhs[b, c]: column c's entries times (W r + P r)
    const int64_t lanes = (n + kWarp - 1) / kWarp * kWarp;
    const int64_t u = (unit - rows) * kWarp + lane;
    const int b = static_cast<int>(u / lanes);
    const int c = static_cast<int>(u % lanes);
    if (b >= batch || c >= n) return;
    const double* rb = r + static_cast<int64_t>(b) * t.m;
    const double* vb = vals + static_cast<int64_t>(b) * t.entries;
    double s = 0.0;
    for (int q = t.col_ptr[c]; q < t.col_ptr[c + 1]; ++q) {
      const int row = t.col_row[q];
      double wr = w[row] * rb[row];
      const int p = t.pair_of[row];
      if (p >= 0) wr = wr + off[p] * rb[t.partner[row]];
      s += entry(t, vb, t.col_ref[q]) * wr;
    }
    rhs[static_cast<int64_t>(b) * n + c] = s;
    return;
  }
  // a G row's warp: blockDim.x is a multiple of 32 and the G rows' units
  // come before the rhs units, so a warp stays whole here and the
  // full-mask ballots below see all 32 lanes
  const int b = static_cast<int>(unit / n);
  const int i = static_cast<int>(unit % n);
  const double* vb = vals + static_cast<int64_t>(b) * t.entries;
  double* grow = g + unit * n;
  double* buf = chunk[warp];
  int p = t.nz_ptr[i];
  const int end = t.nz_ptr[i + 1];
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int c = c0 + VEC * lane;
    // the nonzeros of this chunk, [p, q): the columns ascend, so those
    // inside the chunk are a prefix of the lanes' candidates
    int q = p;
    for (;;) {
      const int k = q + lane;
      const bool in = k < end && t.nz_col[k] < c0 + kChunk;
      const int count = __popc(__ballot_sync(0xffffffffu, in));
      q += count;
      if (count < kWarp) break;
    }
    if (q == p) {
      if (c < n) store_zeros<VEC>(grow, c);
      continue;
    }
    for (int k = lane; k < kChunk; k += kWarp) buf[k] = 0.0;
    __syncwarp();
    for (int k = p + lane; k < q; k += kWarp) {
      const int j = t.nz_col[k];
      double s = 0.0;
#pragma unroll 4
      for (int e = t.c_ptr[k]; e < t.c_ptr[k + 1]; ++e) {
        const int cw = t.c_w[e];
        const double wt = cw < t.m ? w[cw] : off[cw - t.m];
        s += wt * (entry(t, vb, t.c_a[e]) * entry(t, vb, t.c_b[e]));
      }
      if (i == t.slack && j == t.slack) s += 1.0;  // the slack identity
      buf[j - c0] = s;
    }
    __syncwarp();
    if (c < n) store_chunk<VEC>(grow, c, buf, VEC * lane);
    __syncwarp();
    p = q;
  }
}

}  // namespace

// Launch K8 on `stream`: `vals` [batch, entries] the raw entry values (in
// the pattern's order, masked), `w` [m] and `off` [p] the weights, `r`
// [batch, m] the residuals; `g` [batch, n, n] and `rhs` [batch, n] are
// written whole. Returns a cudaError_t code.
extern "C" int gain_fill_launch(const GainTables* t, const double* vals,
                                const double* w, const double* off,
                                const double* r, double* g, double* rhs,
                                int batch, void* stream) {
  if (t == nullptr || t->n <= 0 || t->m <= 0 || batch <= 0) {
    return cudaErrorInvalidValue;
  }
  // the G rows' warps, then the rhs warps (32 columns each)
  const int64_t warps = static_cast<int64_t>(batch) *
                        (t->n + (t->n + kWarp - 1) / kWarp);
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte stores need every row to start on 16 bytes: N even
  if (t->n % 2 == 0) {
    gain_fill_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, vals, w, off, r, g, rhs, batch);
  } else {
    gain_fill_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, vals, w, off, r, g, rhs, batch);
  }
  return cudaGetLastError();
}

extern "C" const char* gain_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
