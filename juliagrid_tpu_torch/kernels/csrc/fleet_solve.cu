// K2 fleet_solve: a fleet of dense f64 solves A x = b, one scenario a
// thread-block cluster, the matrix in the cluster's shared memory.
//
// Replaces the batched torch.linalg route of the scenario fleets' dense
// solves (cuSOLVER/MAGMA's batched getrf + getrs for the Newton-Raphson
// Jacobians, potrf + potrs for the state estimators' gains). The JAX
// package computes these steps with its own composition, not a Pallas
// kernel: an f32 LU with f64 refinement per scenario
// (juliagrid_tpu/ops/linalg.py:147-162, lu_factor32 + lu_solve_refined
// under jax.vmap in parallel/batch.py:47) and an f32 LU of the SE gain
// (estimation/acse.py:671). f64 is native on this card, so there is no f32
// factor and no refinement here.
//
// Two modes, one kernel template instantiated for each:
// - LU: partial pivoting by the largest |a| in the column, ties going to
//   the lowest row (getrf's rule, so the pivots are LAPACK's and
//   cuSOLVER's; a NaN counts as the largest). A zero pivot does not stop the scenario: it is recorded in
//   info (LAPACK's meaning, the 1-based index of the first zero pivot), the
//   column is left unscaled as getrf leaves it, and x comes out inf or NaN.
//   L is unit lower, U keeps the pivots on its diagonal.
// - Cholesky (a symmetric positive definite A): no pivoting. Step j takes
//   s = sqrt(a_jj) and scales the column below by 1/s (L) and the row to
//   the right by 1/s (Lᵀ), so the factor is L Lᵀ with L in the lower
//   triangle and Lᵀ in the upper one. info is the first pivot a_jj that is
//   not positive. Both triangles are updated, so this does the LU's
//   2/3 N³ operations, not the Cholesky's N³/3; the answer rounds as a
//   Cholesky's does.
// The right-hand side rides along as column N of an N x (N + 1) matrix, so
// the forward elimination (L y = P b) happens with the factorization; a
// back substitution with U (the upper triangle, whose diagonal is the pivot
// or s) ends the launch. The factors (L below the diagonal, U on and above
// it, in the input's row-major layout) and the pivots (1-based, getrf's
// ipiv) are written only where the caller passes buffers for them.
//
// Mapping: a scenario's N + 1 columns are cut into panels of kW = 16
// columns, dealt block-cyclically to the C blocks of its cluster (panel p
// to block p mod C), each block holding its columns column-major in shared
// memory (leading dimension N rounded up to odd, so that a warp that walks
// a row across columns hits distinct banks). C comes from N on the host
// (kernels/fleet_solve.py::fleet_plan): the fewest of 1, 2, 4, 8 blocks
// whose columns, with a copy of one panel and two vectors, fit a block
// (4 at N = 236). Right-looking, a panel at a time:
// 1. The owner of panel p factors it with a thread per row, the panel's 16
//    values of the row in registers, one __syncthreads a column: in the LU
//    each warp finds its largest |a| by a shuffle reduction and its
//    winner publishes its row and its reciprocal (the Cholesky's row j
//    publishes itself scaled by 1 / s); after the barrier every thread
//    scans the warps' winners, takes the pivot row and updates its own. Reciprocals (1 / pivot, 1 / s) replace divisions
//    and are kept for the back substitution.
// 2. A cluster barrier, split into arrive and wait. Every other block
//    copies the panel's L (rows from the panel down, a thread a row) and
//    its pivots out of the owner's shared memory through distributed shared
//    memory, and arrives.
// 3. Every block applies the panel's row swaps to its columns to the right
//    (and to those to the left when the factors are written), solves the
//    panel's rows of those columns with L11 (U12; a lane a column) and
//    updates the rows below with A22 -= L21 U12 (a warp a group of 8
//    columns, a lane 4 rows 32 apart, the sum over the panel's 16 columns
//    in registers). Look-ahead: the owner of panel p + 1 updates that
//    panel's columns first, factors it and arrives before its other
//    updates, so the next panel's factorization overlaps this one's
//    trailing updates.
// The back substitution walks the panels backwards: the owner of a panel
// takes the partly solved vector from the block that held it (one cluster
// barrier a panel), warp 0 solves the panel's triangle (a lane a row, each
// unknown by shuffle) and a thread a row above subtracts the panel's
// columns times its unknowns.
//
// Arithmetic: no atomics, and every value is a fixed sequence of FMAs. An
// element (i, c) is updated by fma(-L[i][t], U[t][c], a) for t = 0, 1, ...
// in order, whichever block, warp or panel does it, so the result does not
// depend on C or on the panel width, and one input gives one bit pattern.
//
// Bound: at case118 x1024 (N = 236) the input is 456 MB, read once
// (0.137 ms at 3.35 TB/s), and the LU 8.97e9 f64 operations (0.134 ms at 67
// TFLOP/s). This version runs on the non-tensor f64 pipes and is set by a
// scenario's chain, not by either: N pivot steps of one block barrier each
// (0.4 µs for the Cholesky, 1-2.6 µs for the LU at N = 236) and ~2 N / 16
// cluster barriers, with only 30 four-block clusters in flight on 132 SMs
// (each block takes 155 KB of shared memory and 242 registers a thread),
// so 1,024 scenarios run in ~34 waves (PERF.md; scripts/k2_timeline.py
// stamps the phases).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxN = kThreads;  // a thread a row while a panel is factored
constexpr int kW = 16;           // panel width
constexpr int kRows = 4;         // rows a lane updates, 32 apart
constexpr int kCols = 8;         // columns of a warp's group
constexpr int kMaxCluster = 8;
constexpr int kSmallBytes = 3328;  // the Small arrays at the front
constexpr int kClusterUnplaceable = -1;
constexpr int64_t kMaxGridY = 65535;

struct Problem {
  const double* a;  // [B, n, n] row-major
  const double* b;  // [B, n]
  double* x;        // [B, n]
  int* info;        // [B]
  double* lu;       // [B, n, n] or null
  int* piv;         // [B, n] (1-based) or null
  int64_t first;    // scenario of blockIdx.y == 0
  int n;
  int ld;       // odd leading dimension of a column, >= n
  int cluster;  // blocks of a scenario's cluster
  int cols;     // columns of the widest block
  int cholesky;
};

// The small arrays of a block. The per-column buffers are double-buffered
// by the column's parity, so that a thread that runs ahead into the next
// column cannot overwrite what a slower one still reads.
struct Small {
  double crow[2][kWarps][kW];  // each warp's pivot candidate's row
  double cval[2][kWarps];      // ... its |a|
  double crcp[2][kWarps];      // ... 1 / its pivot (the Cholesky's: 1 / s)
  double jrow[2][kW];          // LU: row j, on its way to the pivot's row
  double rdiag[kW];    // published: 1/s of each column (Cholesky), else 1
  double rdl[kW];      // the owner's rdiag, copied
  double xpan[kW];     // the back substitution's unknowns of a panel
  int cidx[2][kWarps];  // ... the candidate's row
  int piv[kW];          // published: the panel's pivot rows (0-based)
  int pivl[kW];         // the owner's piv, copied
  int info;             // this block's first bad pivot (1-based), or 0
};
static_assert(sizeof(Small) <= kSmallBytes, "Small outgrew its room");

#ifdef FLEET_SOLVE_TIMELINE
// scripts/k2_timeline.py builds with this defined: thread 0 of each block
// of one scenario stamps %globaltimer at the ends of the launch's phases.
constexpr int kStamps = 192;
__device__ unsigned long long g_stamp[kMaxCluster * kStamps];
__device__ long long g_stamp_scenario;
__device__ __forceinline__ void stamp(int64_t s, int rank, int k) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (threadIdx.x == 0 && s == g_stamp_scenario && k < kStamps) {
    g_stamp[rank * kStamps + k] = now;
  }
}
// ... and, at each column of a panel it factors, %globaltimer and
// %clock64 after the column's barrier and after its update
__device__ unsigned long long g_col[kMaxN * 4];
__device__ __forceinline__ void stamp_col(int64_t s, int j, int k) {
  unsigned long long now, clk;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk));
  if (threadIdx.x == 0 && s == g_stamp_scenario) {
    g_col[j * 4 + 2 * k] = now;
    g_col[j * 4 + 2 * k + 1] = clk;
  }
}
#else
__device__ __forceinline__ void stamp(int64_t, int, int) {}
__device__ __forceinline__ void stamp_col(int64_t, int, int) {}
#endif

struct View {
  Small* s;
  double* col;   // [cols][ld] this block's columns
  double* lscr;  // [kW][ld] a copy of another block's panel (C > 1)
  double* y;     // [ld] the vector of the back substitution
  double* urcp;  // [ld] 1 / U's diagonal, at the rows of this block's panels
};

__device__ View view(double* base, const Problem& pb) {
  View v;
  v.s = reinterpret_cast<Small*>(base);
  v.col = base + kSmallBytes / sizeof(double);
  v.lscr = v.col + static_cast<int64_t>(pb.cols) * pb.ld;
  v.y = v.lscr + (pb.cluster > 1 ? kW * pb.ld : 0);
  v.urcp = v.y + pb.ld;
  return v;
}

__host__ __device__ inline int ld_of(int n) { return n | 1; }

// The cluster barrier in its two halves: arrive releases this thread's
// writes, wait returns when every thread of the cluster has arrived and
// acquires theirs. Every thread calls them, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Columns (of the N + 1) that block `rank` of a cluster of `cluster` holds.
__host__ __device__ inline int block_cols(int n, int cluster, int rank) {
  const int total = n + 1;
  const int panels = (total + kW - 1) / kW;
  int cols = 0;
  for (int p = rank; p < panels; p += cluster) {
    cols += total - p * kW < kW ? total - p * kW : kW;
  }
  return cols;
}

__host__ __device__ inline int64_t shared_bytes(int n, int cluster) {
  int cols = 0;
  for (int r = 0; r < cluster; ++r) {
    const int c = block_cols(n, cluster, r);
    cols = c > cols ? c : cols;
  }
  const int64_t doubles = static_cast<int64_t>(ld_of(n)) *
                          (cols + (cluster > 1 ? kW : 0) + 2);
  return kSmallBytes + doubles * static_cast<int64_t>(sizeof(double));
}

// Local column of global column g in its owner.
__device__ inline int local_col(int g, int cluster) {
  return (g / kW / cluster) * kW + g % kW;
}

__device__ inline int global_col(int lc, int cluster, int rank) {
  return ((lc / kW) * cluster + rank) * kW + lc % kW;
}

// Local columns of block `rank` in the panels before panel p (all full).
__device__ inline int cols_before(int p, int cluster, int rank) {
  return (p <= rank ? 0 : (p - rank + cluster - 1) / cluster) * kW;
}

// First local column of block `rank` in the panels after panel p.
__device__ inline int cols_through(int p, int cluster, int rank) {
  return (p < rank ? 0 : (p - rank) / cluster + 1) * kW;
}

// The owner factors panel p (global columns k0 .. k0 + nf - 1, the panel
// held in its local columns lc0 ..): a thread a row, rows k0 .. n - 1, one
// __syncthreads a column. LU: each warp's best row publishes itself with
// its |a| and its reciprocal, so that after the barrier every thread picks
// the winner and reads its row at once; row j publishes itself too, for the
// pivot's row to take. Cholesky: row j publishes itself scaled and 1 / s.
// The reciprocals (not divisions) are kept in urcp for the back
// substitution.
template <bool kChol>
__device__ void factor_panel(const View& v, const Problem& pb, int k0, int nf,
                             int lc0, int64_t s) {
  const int n = pb.n;
  const int ld = pb.ld;
  const int i = threadIdx.x;
  const int lane = i % kWarp;
  const int warp = i / kWarp;
  const bool row = i >= k0 && i < n;
  const int wp = n + 1 - k0 < kW ? n + 1 - k0 : kW;  // columns incl. b
  constexpr bool chol = kChol;
  Small& sm = *v.s;
  int first_bad = 0;  // thread 0's
  double a[kW];
#pragma unroll
  for (int t = 0; t < kW; ++t) {
    a[t] = (row && t < wp) ? v.col[(lc0 + t) * ld + i] : 0.0;
  }
  // fully unrolled (jj a constant in each copy, so that a[jj] is a
  // register); the guard is uniform over the block
#pragma unroll
  for (int jj = 0; jj < kW; ++jj) {
    if (jj >= nf) continue;
    const int j = k0 + jj;
    const int par = jj & 1;
    int p = j;
    const double* pr;
    double rcp;  // LU: 1 / pivot; Cholesky: 1 / s
    if constexpr (!chol) {
      // the largest |a| of rows j .. n - 1, the lowest row on a tie; NaN
      // counts as the largest, so that every lane agrees. Only the warps
      // wlo .. whi hold such rows.
      const int wlo = j / kWarp;
      const int whi = (n - 1) / kWarp;
      if (warp >= wlo && warp <= whi) {
        double key = -1.0;
        if (row && i >= j) key = isnan(a[jj]) ? INFINITY : fabs(a[jj]);
        int idx = i;
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2) {
          const double k = __shfl_xor_sync(0xffffffffu, key, off);
          const int q = __shfl_xor_sync(0xffffffffu, idx, off);
          if (k > key || (k == key && q < idx)) {
            key = k;
            idx = q;
          }
        }
        if (i == idx) {
          sm.cval[par][warp] = key;
          sm.cidx[par][warp] = idx;
          sm.crcp[par][warp] = __drcp_rn(a[jj]);
#pragma unroll
          for (int t = 0; t < kW; ++t) sm.crow[par][warp][t] = a[t];
        }
      }
      if (i == j) {
#pragma unroll
        for (int t = 0; t < kW; ++t) sm.jrow[par][t] = a[t];
      }
      __syncthreads();
      double best = sm.cval[par][wlo];
      int win = wlo;
      p = sm.cidx[par][wlo];
      for (int w = wlo + 1; w <= whi; ++w) {
        const double k = sm.cval[par][w];
        const int q = sm.cidx[par][w];
        if (k > best || (k == best && q < p)) {
          best = k;
          p = q;
          win = w;
        }
      }
      pr = sm.crow[par][win];
      rcp = sm.crcp[par][win];
    } else {
      // row j publishes itself already scaled by 1 / s right of the
      // diagonal (Lᵀ), with 1 / s
      if (i == j) {
        const double r = rsqrt(a[jj]);
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          sm.crow[par][0][t] = t > jj ? a[t] * r : a[t];
        }
        sm.crcp[par][0] = r;
      }
      __syncthreads();
      pr = sm.crow[par][0];
      rcp = sm.crcp[par][0];
    }
    stamp_col(s, j, 0);
    const double pivot = pr[jj];
    const double root = chol ? pivot * rcp : pivot;  // s = pivot / s
    if (i == 0) {
      sm.piv[jj] = p;
      sm.rdiag[jj] = chol ? rcp : 1.0;
      v.urcp[j] = rcp;
      const bool bad = chol ? !(pivot > 0.0) : pivot == 0.0;
      if (bad && first_bad == 0) first_bad = j + 1;
      if (pb.piv != nullptr) pb.piv[s * n + j] = p + 1;
    }
    if (row && i >= j) {
      if (i == j) {
        // row j becomes the pivot row: U (Lᵀ for the Cholesky)
#pragma unroll
        for (int t = 0; t < kW; ++t) a[t] = pr[t];
        if constexpr (chol) a[jj] = root;
      } else {
        if (i == p) {
#pragma unroll
          for (int t = 0; t < kW; ++t) a[t] = sm.jrow[par][t];
        }
        // getrf leaves a column with a zero pivot unscaled
        const double l = (chol || pivot != 0.0) ? a[jj] * rcp : a[jj];
        a[jj] = l;
#pragma unroll
        for (int t = jj + 1; t < kW; ++t) a[t] = fma(-l, pr[t], a[t]);
      }
    }
    stamp_col(s, j, 1);
  }
  if (row) {
#pragma unroll
    for (int t = 0; t < kW; ++t) {
      if (t < wp) v.col[(lc0 + t) * ld + i] = a[t];
    }
  }
  if (i == 0 && first_bad != 0 && sm.info == 0) sm.info = first_bad;
  __syncthreads();
}

// Panel p's row swaps (pv, global rows) on this block's columns from
// `right` on, and on those before `before` when the factors are written.
__device__ void apply_swaps(const View& v, const Problem& pb, int k0, int nf,
                            const int* pv, int before, int right, int ncols,
                            bool left) {
  const int ld = pb.ld;
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    if (c < right && !(left && c < before)) continue;
    double* cp = v.col + c * ld;
    for (int t = 0; t < nf; ++t) {
      const int q = pv[t];
      const int j = k0 + t;
      if (q != j) {
        const double x = cp[j];
        cp[j] = cp[q];
        cp[q] = x;
      }
    }
  }
}

// U12 and A22 -= L21 U12 on this block's columns [c_begin, c_end), with the
// panel's L (column t at L + t * ld, global rows) and, for the Cholesky,
// its 1/s (rd).
template <bool kChol>
__device__ void update_right(const View& v, const Problem& pb, int k0, int nf,
                             int c_begin, int c_end, const double* L,
                             const double* rd) {
  const int n = pb.n;
  const int ld = pb.ld;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  constexpr bool chol = kChol;
  const int groups = (c_end - c_begin + kCols - 1) / kCols;
  for (int g = warp; g < groups; g += kWarps) {
    const int c0 = c_begin + g * kCols;
    const int cn = c_end - c0 < kCols ? c_end - c0 : kCols;
    if (lane < cn) {
      // U12 = L11⁻¹ A12 for one column (scaled by 1/s for the Cholesky)
      double* cp = v.col + (c0 + lane) * ld + k0;
      double u[kW];
#pragma unroll
      for (int t = 0; t < kW; ++t) u[t] = t < nf ? cp[t] : 0.0;
#pragma unroll
      for (int t = 0; t < kW; ++t) {
        if (t < nf) {
          if constexpr (chol) u[t] *= rd[t];
#pragma unroll
          for (int q = t + 1; q < kW; ++q) {
            if (q < nf) u[q] = fma(-L[t * ld + k0 + q], u[t], u[q]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kW; ++t) {
        if (t < nf) cp[t] = u[t];
      }
    }
    __syncwarp();
    for (int rb = k0 + nf; rb < n; rb += kWarp * kRows) {
      int rows[kRows];
      bool ok[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int r = rb + lane + kWarp * m;
        ok[m] = r < n;
        rows[m] = ok[m] ? r : n - 1;
      }
      double acc[kRows][kCols];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          acc[m][q] = q < cn ? v.col[(c0 + q) * ld + rows[m]] : 0.0;
        }
      }
      for (int t = 0; t < nf; ++t) {
        double l[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m) l[m] = L[t * ld + rows[m]];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int c = c0 + (q < cn ? q : cn - 1);
          const double u = v.col[c * ld + k0 + t];
#pragma unroll
          for (int m = 0; m < kRows; ++m) acc[m][q] = fma(-l[m], u, acc[m][q]);
        }
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (ok[m] && q < cn) v.col[(c0 + q) * ld + rows[m]] = acc[m][q];
        }
      }
    }
  }
}

template <bool kChol>
__global__ void __launch_bounds__(kThreads)
    fleet_solve_kernel(Problem pb) {
  extern __shared__ __align__(16) double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = pb.cluster;
  const int n = pb.n;
  const int ld = pb.ld;
  const int64_t s = pb.first + blockIdx.y;
  const View v = view(smem, pb);
  const int ncols = block_cols(n, C, rank);

  int event = 0;
  stamp(s, rank, event++);
  // this block's columns of [A | b]
  const double* a = pb.a + s * n * n;
  for (int idx = threadIdx.x; idx < ncols * n; idx += kThreads) {
    const int lc = idx % ncols;
    const int i = idx / ncols;
    const int g = global_col(lc, C, rank);
    v.col[lc * ld + i] =
        g < n ? a[static_cast<int64_t>(i) * n + g] : pb.b[s * n + i];
  }
  if (threadIdx.x == 0) v.s->info = 0;
  __syncthreads();
  stamp(s, rank, event++);

  // Right-looking with look-ahead: the owner of panel p + 1 updates that
  // panel's columns with panel p first, factors it and arrives at the
  // cluster barrier, and only then updates its other columns, while the
  // other blocks arrive as soon as they have copied panel p. Barrier phase
  // p + 1 thus completes when panel p + 1 is factored and every block is
  // done reading panel p (whose owner may then swap its rows for the
  // factors, and reuses its pivot arrays only at panel p + C).
  const int panels = (n + kW - 1) / kW;  // panels with columns of A
  const bool left = pb.lu != nullptr && !kChol;
  if (rank == 0) factor_panel<kChol>(v, pb, 0, n < kW ? n : kW, 0, s);
  stamp(s, rank, event++);
  cluster_arrive();
  for (int p = 0; p < panels; ++p) {
    const int k0 = p * kW;
    const int nf = n - k0 < kW ? n - k0 : kW;
    const int owner = p % C;
    const bool mine = owner == rank;
    const int before = cols_before(p, C, rank);
    const int through = cols_through(p, C, rank);
    const int right = through < ncols ? through : ncols;
    stamp(s, rank, event++);
    cluster_wait();
    stamp(s, rank, event++);
    // the panel's pivots and 1/s, copied: with one block, factoring the
    // next panel overwrites the published ones while this panel's
    // updates still need them
    if (threadIdx.x < nf) {
      v.s->pivl[threadIdx.x] =
          cluster.map_shared_rank(v.s->piv, owner)[threadIdx.x];
      v.s->rdl[threadIdx.x] =
          cluster.map_shared_rank(v.s->rdiag, owner)[threadIdx.x];
    }
    const int* pv = v.s->pivl;
    const double* rd = v.s->rdl;
    const double* L;
    if (mine) {
      L = v.col + before * ld;
    } else {
      const double* src =
          cluster.map_shared_rank(v.col + local_col(k0, C) * ld, owner);
      const int i = k0 + threadIdx.x;  // a thread a row, its loads in flight
      if (i < n) {
        double row[kW];
#pragma unroll
        for (int t = 0; t < kW; ++t) row[t] = t < nf ? src[t * ld + i] : 0.0;
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          if (t < nf) v.lscr[t * ld + i] = row[t];
        }
      }
      L = v.lscr;
    }
    __syncthreads();
    stamp(s, rank, event++);
    if constexpr (!kChol) {
      apply_swaps(v, pb, k0, nf, pv, before, right, ncols, left);
      __syncthreads();
    }
    stamp(s, rank, event++);
    const int next = p + 1;
    int rest = right;  // this block's columns still to update with panel p
    if (next < panels && next % C == rank) {
      // this block's next panel is panel p + 1: its columns first
      rest = right + kW < ncols ? right + kW : ncols;
      update_right<kChol>(v, pb, k0, nf, right, rest, L, rd);
      __syncthreads();
      const int k1 = next * kW;
      factor_panel<kChol>(v, pb, k1, n - k1 < kW ? n - k1 : kW, right, s);
    }
    stamp(s, rank, event++);
    cluster_arrive();
    update_right<kChol>(v, pb, k0, nf, rest, ncols, L, rd);
    __syncthreads();
    stamp(s, rank, event++);
  }
  cluster_wait();

  if (pb.lu != nullptr) {
    double* out = pb.lu + s * n * n;
    for (int idx = threadIdx.x; idx < ncols * n; idx += kThreads) {
      const int lc = idx % ncols;
      const int i = idx / ncols;
      const int g = global_col(lc, C, rank);
      if (g < n) out[static_cast<int64_t>(i) * n + g] = v.col[lc * ld + i];
    }
  }

  // back substitution U x = y, a panel at a time from the last: warp 0
  // solves the panel's triangle (a lane a row, x_j by shuffle), then a
  // thread a row above the panel subtracts the panel's columns times x
  int holder = (n / kW) % C;  // the block that holds b's column
  if (rank == holder) {
    const double* yc = v.col + local_col(n, C) * ld;
    for (int i = threadIdx.x; i < n; i += kThreads) v.y[i] = yc[i];
  }
  for (int p = panels - 1; p >= 0; --p) {
    cluster.sync();
    stamp(s, rank, event++);
    const int owner = p % C;
    if (owner == rank) {
      const int k0 = p * kW;
      const int nf = n - k0 < kW ? n - k0 : kW;
      if (holder != rank && threadIdx.x < k0 + nf) {
        v.y[threadIdx.x] =
            cluster.map_shared_rank(v.y, holder)[threadIdx.x];
      }
      __syncthreads();
      const double* u = v.col + local_col(k0, C) * ld;  // column jj: + jj ld
      if (threadIdx.x < kWarp) {
        const int lane = threadIdx.x;
        double yl = lane < nf ? v.y[k0 + lane] : 0.0;
        double xl = 0.0;
        for (int jj = nf - 1; jj >= 0; --jj) {
          const double xj =
              __shfl_sync(0xffffffffu, yl, jj) * v.urcp[k0 + jj];
          if (lane == jj) xl = xj;
          if (lane < jj) yl = fma(-u[jj * ld + k0 + lane], xj, yl);
        }
        if (lane < nf) {
          v.s->xpan[lane] = xl;
          pb.x[s * n + k0 + lane] = xl;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < k0; i += kThreads) {
        double yi = v.y[i];
        for (int jj = nf - 1; jj >= 0; --jj) {
          yi = fma(-u[jj * ld + i], v.s->xpan[jj], yi);
        }
        v.y[i] = yi;
      }
    }
    holder = owner;
    stamp(s, rank, event++);
  }
  if (rank == 0 && threadIdx.x == 0) {
    int first = 0;
    for (int q = 0; q < C; ++q) {
      const int f = cluster.map_shared_rank(&v.s->info, q)[0];
      if (f != 0 && (first == 0 || f < first)) first = f;
    }
    pb.info[s] = first;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
  stamp(s, rank, event);
}

using Kernel = void (*)(Problem);

// The kernel of a mode: 0 LU, 1 Cholesky.
Kernel kernel_of(int cholesky) {
  return cholesky ? fleet_solve_kernel<true> : fleet_solve_kernel<false>;
}

// What a device was found to take: the dynamic shared memory a block can
// take (0 until known), whether each mode's kernel is set up for it, and
// for each mode and cluster size the most shared memory a block was found
// to place with.
constexpr int kMaxDevices = 64;
struct DeviceCache {
  int64_t room;
  bool ready[2];
  int64_t placed[2][kMaxCluster + 1];
};
DeviceCache cache[kMaxDevices];

int64_t room(int device) {
  if (device < 0 || device >= kMaxDevices) return -cudaErrorInvalidDevice;
  if (cache[device].room > 0) return cache[device].room;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  int64_t most = optin;
  for (int mode = 0; mode < 2; ++mode) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel_of(mode));
    if (err != cudaSuccess) return -static_cast<int64_t>(err);
    const int64_t left = optin - static_cast<int64_t>(attr.sharedSizeBytes);
    most = left < most ? left : most;
  }
  cache[device].room = most;
  return most;
}

cudaLaunchConfig_t config(int cluster, int64_t bytes, int64_t scenarios,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, static_cast<unsigned>(scenarios), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets a mode's kernel up on `device` and returns the shared bytes of an
// (n, cluster) launch, or a negative error code.
int64_t prepare(int n, int cluster, int cholesky, int device) {
  if (n < 1 || n > kMaxN || cluster < 1 || cluster > kMaxCluster) {
    return -static_cast<int64_t>(cudaErrorInvalidValue);
  }
  const int64_t avail = room(device);
  if (avail < 0) return avail;
  const int64_t bytes = shared_bytes(n, cluster);
  if (bytes > avail) return -static_cast<int64_t>(cudaErrorInvalidValue);
  DeviceCache& dev = cache[device];
  if (!dev.ready[cholesky]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(cholesky), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(avail));
    if (err != cudaSuccess) return -static_cast<int64_t>(err);
    dev.ready[cholesky] = true;
  }
  return bytes;
}

cudaError_t active_clusters(int cluster, int cholesky, int64_t bytes,
                            cudaStream_t stream, int* clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, bytes, 1, stream, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel_of(cholesky), &cfg);
}

// Makes `device` the calling thread's current device for its scope, and
// puts the caller's back.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&previous_);
    if (err_ == cudaSuccess && previous_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(previous_);
  }
  cudaError_t error() const { return err_; }

 private:
  int previous_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

}  // namespace

// Dynamic shared memory a block of K2 can take on `device`, in bytes, or 0
// if the device cannot be queried.
extern "C" int64_t fleet_solve_room(int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return 0;
  const int64_t bytes = room(device);
  return bytes > 0 ? bytes : 0;
}

// Clusters of an (n, cluster) launch of a mode the device can hold at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t code.
extern "C" int fleet_solve_active_clusters(int n, int cluster, int cholesky,
                                           int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -scope.error();
  const int mode = cholesky != 0;
  const int64_t bytes = prepare(n, cluster, mode, device);
  if (bytes < 0) return static_cast<int>(bytes);
  int clusters = 0;
  const cudaError_t err =
      active_clusters(cluster, mode, bytes, nullptr, &clusters);
  if (err != cudaSuccess) return -err;
  return clusters;
}

// Solve A x = b for `batch` scenarios on `stream` of `device`, a cluster of
// `cluster` blocks each: a [batch, n, n] and b [batch, n] f64 row-major,
// x [batch, n] f64 and info [batch] int32 out; lu [batch, n, n] f64 and
// piv [batch, n] int32 out when not null (the LU mode's factors and
// 1-based pivots). cholesky != 0 takes the Cholesky mode. Returns a
// cudaError_t code, or -1 when the cluster cannot be placed on the device.
extern "C" int fleet_solve_launch(const double* a, const double* b, double* x,
                                  int* info, double* lu, int* piv, int batch,
                                  int n, int cluster, int cholesky, int device,
                                  void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const int mode = cholesky != 0;
  const int64_t bytes = prepare(n, cluster, mode, device);
  if (bytes < 0) return static_cast<int>(-bytes);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t& placed = cache[device].placed[mode][cluster];
  if (bytes > placed) {
    int clusters = 0;
    const cudaError_t err =
        active_clusters(cluster, mode, bytes, st, &clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return kClusterUnplaceable;
    placed = bytes;
  }
  Problem pb{a, b, x, info, lu, piv, 0, n, ld_of(n), cluster, 0, mode};
  for (int r = 0; r < cluster; ++r) {
    const int c = block_cols(n, cluster, r);
    pb.cols = c > pb.cols ? c : pb.cols;
  }
  for (int64_t first = 0; first < batch; first += kMaxGridY) {
    const int64_t count =
        batch - first < kMaxGridY ? batch - first : kMaxGridY;
    pb.first = first;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(cluster, bytes, count, st, attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel_of(mode), pb);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

#ifdef FLEET_SOLVE_TIMELINE
// The stamps of scenario `scenario` in the next launches: out receives
// kMaxCluster x kStamps values of the last launch (0 where none), cols the
// kMaxN x 4 column stamps.
extern "C" int fleet_solve_timeline(long long scenario,
                                    unsigned long long* out,
                                    unsigned long long* cols) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (err != cudaSuccess) return err;
  err = cudaMemcpyFromSymbol(cols, g_col, sizeof(g_col));
  if (err != cudaSuccess) return err;
  static const unsigned long long zeros[kMaxCluster * kStamps] = {};
  err = cudaMemcpyToSymbol(g_stamp, zeros, sizeof(zeros));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(g_stamp_scenario, &scenario, sizeof(scenario));
}
#endif

extern "C" const char* fleet_solve_error_string(int code) {
  if (code == kClusterUnplaceable) {
    return "the thread-block cluster cannot be placed on this device";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
