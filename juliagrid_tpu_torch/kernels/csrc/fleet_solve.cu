// K2 fleet_solve: a fleet of dense f64 solves A x = b, one scenario a
// thread block, built for the fleet's throughput: many scenarios in flight,
// the working matrix in device memory, one panel of columns in shared
// memory.
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
//   cuSOLVER's; a NaN counts as the largest). A zero pivot does not stop
//   the scenario: it is recorded in info (LAPACK's meaning, the 1-based
//   index of the first zero pivot), the column is left unscaled as getrf
//   leaves it, and x comes out inf or NaN. L is unit lower, U keeps the
//   pivots on its diagonal. The factors (L below the diagonal, U on and
//   above it, row-major) and the 1-based pivots are written only where the
//   caller passes buffers for them.
// - Cholesky (a symmetric positive definite A): no pivoting, and only the
//   lower triangle is read, stored and updated, N³/3 operations. Step j
//   takes s = a_jj · rsqrt(a_jj) onto the diagonal and scales the column
//   below by rsqrt(a_jj); info is the first a_jj that is not positive. The
//   solves run with L (forward) and Lᵀ (backward, L read by columns).
//
// Mapping, at N = 236 with the defaults (kThreads = 128, kW = 32):
// - One block a scenario, 4 warps. The working matrix lives in device
//   memory: the caller's factor buffer, or a scratch [B, N, N] the wrapper
//   allocates (none when N <= kW and no factors are asked for: one panel
//   holds the whole matrix). Shared memory holds one panel of kW columns
//   (rows k0 .. N - 1, column-major, leading dimension N | 1 so that the
//   warps' row-wise and column-wise walks hit distinct banks), the
//   right-hand side, 1 / U's diagonal, the panel's row permutation, and a
//   region that is first the pivot step's candidates and then each warp's
//   kW x 8 block of U12: 73.7 KB, so three blocks (396 scenarios) fit on
//   an SM at 168 registers a thread (kMinBlocks), in 2.6 waves over 1,024
//   scenarios. The LU above 128 is built for two (kWideLuMinBlocks), at up
//   to 255 registers: at 168 it spilled in its column steps and ran 4%
//   slower at N = 236. As built (cudaFuncGetAttributes and the occupancy
//   query in chip_smoke.py's k2_times; ptxas -v in scripts/k2_sweep.py):
//   the LU above 128 250 registers, no spills, 2 blocks an SM at N = 236;
//   the LU to 128 168 registers, 64 local bytes a thread (68 bytes of
//   spill stores); the Cholesky 168 registers, 112 local bytes a thread
//   (116 bytes of spill stores to 128, 136 above), 3 blocks an SM at N =
//   236.
//   One block's barriers and loads hide behind the other blocks' work: the
//   design is for the fleet's throughput, not one scenario's latency.
// - Right-looking, a panel at a time. The panel is staged from device
//   memory (panel 0 straight from A) and factored with a thread a row (two
//   rows a thread; orders up to 128 have a kernel of their own with one,
//   half the registers), one __syncthreads a column, or a __syncwarp where the
//   panel's rows all lie in one warp (N <= 32, the last panel). A row's
//   values and its right-hand side stay in registers for the whole panel,
//   shifted down every 2 (LU) or 4 (Cholesky) columns, so that the column
//   step is a compact loop (fully unrolled, a panel is thousands of
//   instructions) and the forward substitution rides along. LU: each warp
//   finds its largest |a| by a shuffle reduction and that row publishes
//   itself and its reciprocal, row j publishes itself too, and after the
//   barrier every thread picks the winner among the warps and updates its
//   own rows (row j becomes the pivot row, the pivot's row takes row j's).
//   The per-column buffers are double-buffered by the column's parity, so
//   that a thread that runs ahead into the next column cannot overwrite
//   what a slower one still reads. Cholesky: the diagonal block's rows
//   publish their value in column j, row j 1 / s and its right-hand side.
//   Each column, final after its step, goes to the panel at its row's
//   panel-start position; the swaps compose into the panel's row
//   permutation (src), and the LU's rows are put in pivot order through it
//   at the end.
// - Then, without a block barrier, each warp takes groups of 8 trailing
//   columns in turn: it gathers the panel's kW rows of its columns through
//   src into its U12 block, solves them with L11 (4 lanes a column, each
//   unknown by shuffle, in a loop of 4-step blocks; the Cholesky's U12 is
//   L21ᵀ, already in the panel), gathers the rows below into registers
//   (two lanes a row, each 4 of the 8 columns in two 16-byte loads that
//   fill whole 32-byte sectors, rows 16 apart), and only then, after a
//   __syncwarp, updates them with A22 -= L21 U12 (L21 from the panel, U12
//   broadcast) and stores them and U12 in place. Every element a warp
//   reads or writes lies in its own columns, so the gather before the
//   store needs no block barrier. With factors, the swaps are applied to
//   the columns left of the panel too.
// - The back substitution walks the panels backwards: the panel's
//   triangle of U (Lᵀ) is staged in shared memory (the last panel's is
//   still there), warp 0 solves it (a lane a row, each unknown by
//   shuffle), and a thread a row above subtracts the panel's columns times
//   its unknowns.
//
// Arithmetic: no atomics, and every value is a fixed sequence of FMAs. An
// element (i, c) is updated by fma(-L[i][t], U[t][c], a) for t = 0, 1, ...
// in order, whichever phase, warp or panel does it; the right-hand side by
// fma(-L[i][t], y[t], y[i]) in the same order, and the back substitution
// subtracts the columns from the last down. So the result does not depend
// on the panel width or the block size, one input gives one bit pattern,
// and the arithmetic is that of the cluster kernel this one replaced.
//
// Bound: at case118 x1024 (N = 236) the input is 456 MB, read once
// (0.137 ms at 3.35 TB/s), and the LU 8.97e9 f64 operations (0.134 ms at 67
// TFLOP/s; 0.27 ms on the FMA pipes this kernel uses). The right-looking
// update reads and writes the trailing matrix once a panel, about
// N³ / (3 kW) x 16 bytes = 2.2 MB a scenario at kW = 32 (0.67 ms over the
// fleet at the HBM rate). What sets the time (PERF.md; scripts/
// k2_timeline.py stamps the phases of every block on one SM and each
// trailing group of block 0, scripts/k2_sweep.py sweeps the build's
// options): the trailing groups wait on device memory, ~15 µs a group
// whatever its size, with 12 warps an SM and 28 KB of L1 beside the 221 KB
// of shared memory; then the column steps' chain. The arithmetic is far
// from the FMA pipes' rate, so the tensor cores' f64 mma would not move
// it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// the layout's two choices, which scripts/k2_sweep.py varies
#ifndef FLEET_SOLVE_THREADS
#define FLEET_SOLVE_THREADS 128
#endif
#ifndef FLEET_SOLVE_PANEL
#define FLEET_SOLVE_PANEL 32
#endif

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = FLEET_SOLVE_THREADS;
constexpr int kWarps = kThreads / kWarp;
// blocks an SM the kernels are built for (__launch_bounds__): 12 warps an
// SM, at most 168 registers a thread at 128 threads; the LU above
// kThreads (two rows a thread), which spills at 168, 8 warps at up to 255
constexpr int kMinBlocks = 12 * kWarp / kThreads;
constexpr int kWideLuMinBlocks = 8 * kWarp / kThreads;
// column steps between two shifts of a row's registers
constexpr int kLuStep = 2;
constexpr int kCholStep = 4;
constexpr int kW = FLEET_SOLVE_PANEL;  // panel width
constexpr int kMaxN = 256;             // the largest order K2 takes
// rows a thread owns in a panel: orders up to kThreads take one, which
// halves the panel's registers, larger ones kMaxN / kThreads
constexpr int kWideSlots = kMaxN / kThreads;
constexpr int kCols = 8;               // columns of a warp's group
constexpr int kHalf = kCols / 2;       // ... a lane's, two lanes a row
constexpr int kRowLanes = kWarp / 2;   // rows of a warp's row slot
constexpr int kRows = kMaxN / kRowLanes;  // row slots a lane updates
constexpr int kLanesPerCol = kWarp / kCols;  // lanes of a column's solve
constexpr int kPer = kW / kLanesPerCol;      // ... rows of each
static_assert(kW == 16 || kW == 32, "the panel is 16 or 32 columns");
static_assert(kThreads % kWarp == 0 && kMaxN % kThreads == 0,
              "a block of 64, 128 or 256 threads");

struct Problem {
  const double* a;  // [B, n, n] row-major
  const double* b;  // [B, n]
  double* x;        // [B, n]
  int* info;        // [B]
  double* w;        // [B, n, n] the working matrix (the factors), or null
  int* piv;         // [B, n] (1-based) or null
  int n;
  int ld;       // leading dimension of the panel in shared memory, n | 1
  int factors;  // write getrf's L: the swaps applied left of each panel
  int aligned;  // a and w start on 16 bytes (the trailing tiles' loads)
};

// The pivot step's per-column buffers, double-buffered by the column's
// parity. They share their room with the warps' U12 blocks, which only the
// trailing update uses.
struct PanelSmall {
  // rows from column j on, the right-hand side at [kW]
  double crow[2][kWarps][kW + 1];  // LU: each warp's candidate's row
  double cval[2][kWarps];          // ... its |a|
  double crcp[2][kWarps];  // ... 1 / its pivot (Cholesky [0]: 1 / s)
  double jrow[2][kW + 1];  // LU: row j; Cholesky: column j from row j down
  int cidx[2][kWarps];         // ... the candidate's row
  int corg[2][kWarps];         // ... its panel-start row
  int jorg[2];                 // LU: row j's panel-start row
};

// Doubles of the shared region that is first PanelSmall, then the warps'
// U12 blocks, then (back substitution) the panel's unknowns.
constexpr int kUs = kWarps * kW * kCols;
constexpr int kSmallDoubles =
    static_cast<int>((sizeof(PanelSmall) + sizeof(double) - 1) /
                     sizeof(double));
constexpr int kRegion = kUs > kSmallDoubles ? kUs : kSmallDoubles;

__host__ __device__ inline int ld_of(int n) { return n | 1; }

// Dynamic shared memory of an order-n block: the panel, the region, the
// right-hand side and 1 / U's diagonal (doubles), then the row permutation,
// the panel's pivots and info (ints).
__host__ __device__ inline int64_t shared_bytes(int n) {
  const int64_t doubles = static_cast<int64_t>(kW) * ld_of(n) + kRegion +
                          2 * static_cast<int64_t>(n);
  return 8 * doubles + 4 * (static_cast<int64_t>(n) + kW + 1);
}

struct View {
  double* L;       // [kW][ld] the panel, column t of row r at L[t * ld + r]
  PanelSmall* ps;  // the pivot step's buffers
  double* us;      // [kWarps][kW][kCols] the warps' U12 blocks
  double* xpan;    // [kW] the back substitution's unknowns of a panel
  double* y;       // [n] the right-hand side, then the forward solution
  double* urcp;    // [n] 1 / U's diagonal (Cholesky: 1 / s)
  int* src;        // [n] the panel's row permutation: new row r = old src[r]
  int* piv;        // [kW] the panel's pivot rows (0-based)
  int* info;       // this scenario's first bad pivot (1-based), or 0
};

__device__ View view(double* base, int n) {
  View v;
  v.L = base;
  double* region = base + static_cast<int64_t>(kW) * ld_of(n);
  v.ps = reinterpret_cast<PanelSmall*>(region);
  v.us = region;
  v.xpan = region;
  v.y = region + kRegion;
  v.urcp = v.y + n;
  v.src = reinterpret_cast<int*>(v.urcp + n);
  v.piv = v.src + n;
  v.info = v.piv + kW;
  return v;
}

#ifdef FLEET_SOLVE_TIMELINE
// scripts/k2_timeline.py builds with this defined: thread 0 of every block
// stamps %globaltimer at the ends of the launch's phases, and its SM.
constexpr int kStamps = 96;
constexpr int kStampBlocks = 4096;
__device__ unsigned long long g_stamp[kStampBlocks * kStamps];
__device__ int g_smid[kStampBlocks];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks && k < kStamps) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    g_stamp[blockIdx.x * kStamps + k] = now;
    if (k == 0) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      g_smid[blockIdx.x] = static_cast<int>(smid);
    }
  }
}
// ... and lane 0 of warp 0 of block 0 at the phases of each of its
// trailing column groups (panel, group, phase)
constexpr int kGroupPanels = 16;
constexpr int kGroupSlots = 16;
constexpr int kGroupStamps = 4;
__device__ unsigned long long g_group[kGroupPanels * kGroupSlots *
                                      kGroupStamps];
__device__ __forceinline__ void stamp_group(int p, int g, int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && p < kGroupPanels &&
      g < kGroupSlots) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    g_group[(p * kGroupSlots + g) * kGroupStamps + k] = now;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void stamp_group(int, int, int) {}
#endif

// Factors the staged panel (global columns k0 .. k0 + nf - 1, rows k0 ..
// n - 1) and carries the right-hand side through it: a thread a row (rows
// tid, tid + kThreads, ...), one __syncthreads a column. A row's values
// and its right-hand side stay in registers for the whole panel, shifted
// down kStep columns every kStep steps (kLuStep, kCholStep; a[h][s] is
// column j at step s), so that the step is one compact loop body: a fully
// unrolled panel is thousands of instructions. Column j of a row, final after step j,
// goes to the panel at the row's panel-start position (org); the LU's rows
// are put in pivot order at the end.
template <bool kChol, int kSlots>
__device__ void factor_panel(const View& v, const Problem& pb, int k0, int nf,
                             int64_t s) {
  constexpr int kStep = kChol ? kCholStep : kLuStep;
  static_assert(kW % kStep == 0, "the panel is a whole number of steps");
  const int n = pb.n;
  const int ld = pb.ld;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  PanelSmall& sm = *v.ps;
  double a[kSlots][kW];
  double yv[kSlots];  // the row's right-hand side
  int org[kSlots];
  bool own[kSlots];
#pragma unroll
  for (int h = 0; h < kSlots; ++h) {
    const int r = tid + kThreads * h;
    own[h] = r >= k0 && r < n;
    org[h] = r;
    yv[h] = own[h] ? v.y[r] : 0.0;
#pragma unroll
    for (int t = 0; t < kW; ++t) {
      a[h][t] = own[h] && t < nf ? v.L[t * ld + r] : 0.0;
    }
  }
  // the panel's rows all in one warp (an order up to 32, the last panel of
  // a larger one): that warp factors alone, a __syncwarp a column
  const bool solo = n - k0 <= kWarp && k0 % kWarp == 0;
  const int ow = (k0 % kThreads) / kWarp;
  const int w0 = solo ? ow : 0;
  const int w1 = solo ? ow + 1 : kWarps;
  const int boss = w0 * kWarp;  // the thread that keeps the pivots
#pragma unroll 1
  for (int j4 = 0; j4 < nf && (!solo || warp == ow); j4 += kStep) {
#pragma unroll
    for (int st = 0; st < kStep; ++st) {
      const int jj = j4 + st;
      if (jj < nf) {
        const int j = k0 + jj;
        const int par = jj & 1;
        // LU: the pivot row; Cholesky: column j, unscaled, from row j
        // down; both from column j on, the right-hand side at [kW]
        const double* pr;
        double rcp;  // LU: 1 / pivot; Cholesky: 1 / s
        int p = j;
        int porg = 0;  // LU: the pivot row's panel-start row
        int jorg = 0;  // ... and row j's
        if constexpr (!kChol) {
          // the largest |a| of this thread's rows j .. n - 1, the lowest
          // row on a tie; NaN counts as the largest, so that every lane
          // agrees
          double key = -1.0;
          int idx = tid;
#pragma unroll
          for (int h = 0; h < kSlots; ++h) {
            const int r = tid + kThreads * h;
            if (own[h] && r >= j) {
              const double k = isnan(a[h][st]) ? INFINITY : fabs(a[h][st]);
              if (k > key) {
                key = k;
                idx = r;
              }
            }
          }
#pragma unroll
          for (int off = kWarp / 2; off > 0; off /= 2) {
            const double k = __shfl_xor_sync(kFull, key, off);
            const int q = __shfl_xor_sync(kFull, idx, off);
            if (k > key || (k == key && q < idx)) {
              key = k;
              idx = q;
            }
          }
          // the warp's candidate row publishes itself, its panel-start
          // row and its reciprocal; row j publishes itself, for the
          // pivot's row to take
#pragma unroll
          for (int h = 0; h < kSlots; ++h) {
            const int r = tid + kThreads * h;
            if (key >= 0.0 && r == idx) {
#pragma unroll
              for (int t = st; t < kW; ++t) {
                sm.crow[par][warp][t - st] = a[h][t];
              }
              sm.crow[par][warp][kW] = yv[h];
              sm.crcp[par][warp] = __drcp_rn(a[h][st]);
              sm.corg[par][warp] = org[h];
            }
            if (r == j) {
#pragma unroll
              for (int t = st; t < kW; ++t) sm.jrow[par][t - st] = a[h][t];
              sm.jrow[par][kW] = yv[h];
              sm.jorg[par] = org[h];
            }
          }
          if (lane == 0) {
            sm.cval[par][warp] = key;
            sm.cidx[par][warp] = idx;
          }
          if (solo) {
            __syncwarp();
          } else {
            __syncthreads();
          }
          double best = sm.cval[par][w0];
          int win = w0;
          p = sm.cidx[par][w0];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) {
            if (w <= w0 || w >= w1) continue;
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
          porg = sm.corg[par][win];
          jorg = sm.jorg[par];
        } else {
          // the diagonal block's rows from j on publish their value in
          // column j, row j its 1 / s and its right-hand side
#pragma unroll
          for (int h = 0; h < kSlots; ++h) {
            const int r = tid + kThreads * h;
            if (own[h] && r >= j && r < k0 + nf) {
              sm.jrow[par][r - j] = a[h][st];
              if (r == j) {
                sm.crcp[par][0] = rsqrt(a[h][st]);
                sm.jrow[par][kW] = yv[h];
              }
            }
          }
          if (solo) {
            __syncwarp();
          } else {
            __syncthreads();
          }
          pr = sm.jrow[par];
          rcp = sm.crcp[par][0];
        }
        const double pivot = pr[0];
        // the step's multipliers: l[h] for the rows below row j
        double l[kSlots];
        bool below[kSlots];
#pragma unroll
        for (int h = 0; h < kSlots; ++h) {
          const int r = tid + kThreads * h;
          below[h] = own[h] && r > j;
          if constexpr (!kChol) {
            if (own[h] && r == j) {
              // row j becomes the pivot row: U
#pragma unroll
              for (int t = st; t < kW; ++t) a[h][t] = pr[t - st];
              yv[h] = pr[kW];
              org[h] = porg;
            } else if (below[h] && r == p) {
#pragma unroll
              for (int t = st; t < kW; ++t) a[h][t] = sm.jrow[par][t - st];
              yv[h] = sm.jrow[par][kW];
              org[h] = jorg;
            }
            // getrf leaves a column with a zero pivot unscaled
            l[h] = pivot != 0.0 ? a[h][st] * rcp : a[h][st];
          } else {
            if (own[h] && r == j) {
              a[h][st] = pivot * rcp;  // s
              yv[h] *= rcp;
            }
            l[h] = a[h][st] * rcp;
          }
          if (below[h]) a[h][st] = l[h];
        }
        // the update, a column at a time for both rows; the Cholesky's
        // values above the diagonal of the diagonal block, and beyond the
        // panel, are never read
#pragma unroll
        for (int t = st + 1; t < kW; ++t) {
          const double u = kChol ? pr[t - st] * rcp : pr[t - st];
#pragma unroll
          for (int h = 0; h < kSlots; ++h) {
            if (below[h]) a[h][t] = fma(-l[h], u, a[h][t]);
          }
        }
        // the right-hand side: y_j (Cholesky: scaled) from the pivot row
        const double yj = kChol ? pr[kW] * rcp : pr[kW];
#pragma unroll
        for (int h = 0; h < kSlots; ++h) {
          if (below[h]) yv[h] = fma(-l[h], yj, yv[h]);
          // column j of this row is final
          if (own[h]) v.L[jj * ld + org[h]] = a[h][st];
        }
        if (tid == boss) {
          v.piv[jj] = p;
          v.urcp[j] = rcp;
          const bool bad = kChol ? !(pivot > 0.0) : pivot == 0.0;
          if (bad && *v.info == 0) *v.info = j + 1;
          if (pb.piv != nullptr) pb.piv[s * n + j] = p + 1;
          if (p != j) {
            const int q = v.src[j];
            v.src[j] = v.src[p];
            v.src[p] = q;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
#pragma unroll
      for (int t = 0; t < kW; ++t) {
        a[h][t] = t + kStep < kW ? a[h][t + kStep] : 0.0;
      }
    }
  }
  // the rows' right-hand sides, in pivot order already (a row's registers
  // moved with it)
#pragma unroll
  for (int h = 0; h < kSlots; ++h) {
    if (own[h]) v.y[tid + kThreads * h] = yv[h];
  }
  __syncthreads();
  if constexpr (!kChol) {
    // the rows in pivot order: new row r is panel-start row src[r]
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int r = tid + kThreads * h;
      if (own[h]) {
        const int o = v.src[r];
#pragma unroll
        for (int t = 0; t < kW; ++t) a[h][t] = t < nf ? v.L[t * ld + o] : 0.0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int r = tid + kThreads * h;
      if (own[h]) {
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          if (t < nf) v.L[t * ld + r] = a[h][t];
        }
      }
    }
    __syncthreads();
  }
}

// A warp's group of trailing columns c0 .. c0 + cn - 1 of panel k0 (kW
// columns): read from `from` (A for panel 0, else the working matrix w),
// written to w.
template <bool kChol>
__device__ void update_group(const View& v, const Problem& pb, int k0, int c0,
                             int cn, const double* from, double* w,
                             int gslot) {
  const int n = pb.n;
  const int ld = pb.ld;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const double* L = v.L;
  double* us = v.us + warp * kW * kCols;  // [kW][kCols]
  const int pnl = k0 / kW;
  stamp_group(pnl, gslot, 0);
  // the rows below: LU rows k0 + kW .. n - 1 gathered through src;
  // Cholesky rows c0 .. n - 1 (the lower triangle and the diagonal tile).
  // Two lanes a row, each 4 of the 8 columns, rows 16 apart, so that a
  // warp's load or store of a row slot touches 16 rows' whole 64 bytes
  const int rb = kChol ? c0 : k0 + kW;
  const int mcnt = (n - rb + kRowLanes - 1) / kRowLanes;
  const int rr = lane / 2;
  // a lane's columns: 2 par, 2 par + 1, 4 + 2 par, 4 + 2 par + 1, so that
  // each 16-byte load of the warp fills whole 32-byte sectors
  const int par = lane % 2;
  const bool vec = cn == kCols && n % 2 == 0 && pb.aligned;  // 16-byte rows
  double acc[kRows][kHalf];
  const auto load_tile = [&]() {
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int r = rb + rr + kRowLanes * m;
      const bool ok = m < mcnt && r < n;
      const int64_t row = ok ? (kChol ? r : v.src[r]) : 0;
      const double* sp = from + row * n + c0 + 2 * par;
      if (ok && vec) {
        const double2 x0 = *reinterpret_cast<const double2*>(sp);
        const double2 x1 = *reinterpret_cast<const double2*>(sp + 4);
        acc[m][0] = x0.x;
        acc[m][1] = x0.y;
        acc[m][2] = x1.x;
        acc[m][3] = x1.y;
      } else {
#pragma unroll
        for (int e = 0; e < kHalf; ++e) {
          const int q = 4 * (e / 2) + 2 * par + e % 2;
          acc[m][e] = ok && q < cn ? sp[q - 2 * par] : 0.0;
        }
      }
    }
  };
  if constexpr (!kChol) {
    // U12: the panel's rows of these columns, gathered through src; the
    // warp's lanes are done with its previous group's U12 first
    __syncwarp();
    for (int e = lane; e < kW * kCols; e += kWarp) {
      const int t = e / kCols;
      const int q = e % kCols;
      us[e] = q < cn ? from[static_cast<int64_t>(v.src[k0 + t]) * n + c0 + q]
                     : 0.0;
    }
  }
  if constexpr (!kChol) {
    // ... solved with L11: lane (q, g) holds rows g + 4 i of column q,
    // shifted down by one after each 4 steps, so that the step's row is
    // always u[0] of lane (q, t % 4): a compact loop instead of kW
    // unrolled steps
    __syncwarp();
    const int q = lane % kCols;
    const int g = lane / kCols;
    double u[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      u[i] = us[(g + kLanesPerCol * i) * kCols + q];
    }
#pragma unroll 1
    for (int t4 = 0; t4 < kPer; ++t4) {
#pragma unroll
      for (int gs = 0; gs < kLanesPerCol; ++gs) {
        const int t = kLanesPerCol * t4 + gs;
        const double ut = __shfl_sync(kFull, u[0], q + kCols * gs);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = g + kLanesPerCol * (i + t4);
          if (i + t4 < kPer && r > t) {
            u[i] = fma(-L[t * ld + k0 + r], ut, u[i]);
          }
        }
      }
      us[(g + kLanesPerCol * t4) * kCols + q] = u[0];
#pragma unroll
      for (int i = 0; i + 1 < kPer; ++i) u[i] = u[i + 1];
    }
  }
  load_tile();
  stamp_group(pnl, gslot, 1);
  // every read of these columns is done before any of them is written
  __syncwarp();
  for (int t = 0; t < kW; ++t) {
    double u[kHalf];
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      const int q = 4 * (e / 2) + 2 * par + e % 2;
      // Cholesky: U12 = L21ᵀ, row c of the panel
      u[e] = kChol ? (q < cn ? L[t * ld + c0 + q] : 0.0) : us[t * kCols + q];
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < mcnt) {
        const int r = rb + rr + kRowLanes * m;
        const double l = L[t * ld + (r < n ? r : n - 1)];
#pragma unroll
        for (int e = 0; e < kHalf; ++e) acc[m][e] = fma(-l, u[e], acc[m][e]);
      }
    }
  }
  stamp_group(pnl, gslot, 2);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = rb + rr + kRowLanes * m;
    if (m < mcnt && r < n) {
      double* dp = w + static_cast<int64_t>(r) * n + c0 + 2 * par;
      if (vec) {
        *reinterpret_cast<double2*>(dp) = make_double2(acc[m][0], acc[m][1]);
        *reinterpret_cast<double2*>(dp + 4) =
            make_double2(acc[m][2], acc[m][3]);
      } else {
#pragma unroll
        for (int e = 0; e < kHalf; ++e) {
          const int q = 4 * (e / 2) + 2 * par + e % 2;
          if (q < cn) dp[q - 2 * par] = acc[m][e];
        }
      }
    }
  }
  if constexpr (!kChol) {
    for (int e = lane; e < kW * kCols; e += kWarp) {
      const int t = e / kCols;
      const int q = e % kCols;
      if (q < cn) w[static_cast<int64_t>(k0 + t) * n + c0 + q] = us[e];
    }
  }
  stamp_group(pnl, gslot, 3);
}

template <bool kChol, int kSlots>
__global__ void __launch_bounds__(kThreads, kChol || kSlots == 1
                                                ? kMinBlocks
                                                : kWideLuMinBlocks)
    fleet_solve_kernel(Problem pb) {
  extern __shared__ __align__(16) double smem[];
  const int n = pb.n;
  const int ld = pb.ld;
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const View v = view(smem, n);
  const double* a = pb.a + s * n * n;
  double* w = pb.w == nullptr ? nullptr : pb.w + s * n * n;
  int event = 0;
  stamp(event++);
  for (int i = tid; i < n; i += kThreads) v.y[i] = pb.b[s * n + i];
  if (tid == 0) *v.info = 0;

  const int panels = (n + kW - 1) / kW;
  for (int p = 0; p < panels; ++p) {
    const int k0 = p * kW;
    const int nf = n - k0 < kW ? n - k0 : kW;
    const double* from = p == 0 ? a : w;
    // stage the panel: rows k0 .. n - 1, a row's kW columns a warp
    for (int e = tid; e < (n - k0) * kW; e += kThreads) {
      const int r = k0 + e / kW;
      const int t = e % kW;
      if (t < nf) v.L[t * ld + r] = from[static_cast<int64_t>(r) * n + k0 + t];
    }
    for (int r = k0 + tid; r < n; r += kThreads) v.src[r] = r;
    __syncthreads();
    stamp(event++);
    factor_panel<kChol, kSlots>(v, pb, k0, nf, s);
    stamp(event++);
    if (w != nullptr) {
      // the panel into the working matrix: its U rows (the LU's L21 only
      // for the factors; the Cholesky's L21 for the backward solve)
      const int rend = (kChol || pb.factors) ? n : k0 + nf;
      for (int e = tid; e < (rend - k0) * kW; e += kThreads) {
        const int r = k0 + e / kW;
        const int t = e % kW;
        if (t < nf) w[static_cast<int64_t>(r) * n + k0 + t] = v.L[t * ld + r];
      }
    }
    const int c1 = k0 + nf;
    const int groups = (n - c1 + kCols - 1) / kCols;
    for (int g = warp; g < groups; g += kWarps) {
      const int c0 = c1 + g * kCols;
      update_group<kChol>(v, pb, k0, c0, n - c0 < kCols ? n - c0 : kCols,
                          from, w, g / kWarps);
    }
    if (!kChol && pb.factors && k0 > 0) {
      // getrf's L: the panel's swaps on the columns left of it
      for (int c = tid; c < k0; c += kThreads) {
        for (int t = 0; t < nf; ++t) {
          const int q = v.piv[t];
          if (q != k0 + t) {
            double* x0 = w + static_cast<int64_t>(k0 + t) * n + c;
            double* x1 = w + static_cast<int64_t>(q) * n + c;
            const double tmp = *x0;
            *x0 = *x1;
            *x1 = tmp;
          }
        }
      }
    }
    stamp(event++);
    __syncthreads();
    stamp(event++);
  }

  // back substitution U x = y (Cholesky: Lᵀ x = y), a panel at a time from
  // the last. The panel's triangle: U(q, t) = U[k0 + q][k0 + t], q <= t,
  // at tri[t * tld + q] (LU) or tri[q * tld + t] (Cholesky, L by rows)
  for (int p = panels - 1; p >= 0; --p) {
    const int k0 = p * kW;
    const int nf = n - k0 < kW ? n - k0 : kW;
    const double* tri = v.L + k0;
    int tld = ld;
    if (p != panels - 1) {
      // the last panel's triangle is still staged; stage this one
      tld = kW + 1;
      for (int e = tid; e < kW * kW; e += kThreads) {
        const int hi = e / kW;
        const int lo = e % kW;
        v.L[lo * tld + hi] = w[static_cast<int64_t>(k0 + hi) * n + k0 + lo];
      }
      tri = v.L;
      __syncthreads();
    }
    if (warp == 0) {
      const int lane = tid;
      double yl = lane < nf ? v.y[k0 + lane] : 0.0;
      double xl = 0.0;
      for (int jj = nf - 1; jj >= 0; --jj) {
        const double xj = __shfl_sync(kFull, yl, jj) * v.urcp[k0 + jj];
        if (lane == jj) xl = xj;
        if (lane < jj) {
          const double u = kChol ? tri[lane * tld + jj] : tri[jj * tld + lane];
          yl = fma(-u, xj, yl);
        }
      }
      if (lane < nf) {
        v.xpan[lane] = xl;
        pb.x[s * n + k0 + lane] = xl;
      }
    }
    __syncthreads();
    for (int i = tid; i < k0; i += kThreads) {
      double yi = v.y[i];
      for (int jj = nf - 1; jj >= 0; --jj) {
        const double u = kChol ? w[static_cast<int64_t>(k0 + jj) * n + i]
                               : w[static_cast<int64_t>(i) * n + k0 + jj];
        yi = fma(-u, v.xpan[jj], yi);
      }
      v.y[i] = yi;
    }
    __syncthreads();
    stamp(event++);
  }
  if (tid == 0) pb.info[s] = *v.info;
  stamp(event);
}

using Kernel = void (*)(Problem);

// The kernels: 0 LU, 1 Cholesky; then the same for orders above kThreads.
constexpr int kKernels = 4;
Kernel kernel_at(int k) {
  switch (k) {
    case 0:
      return fleet_solve_kernel<false, 1>;
    case 1:
      return fleet_solve_kernel<true, 1>;
    case 2:
      return fleet_solve_kernel<false, kWideSlots>;
    default:
      return fleet_solve_kernel<true, kWideSlots>;
  }
}

// The kernel of a mode (0 LU, 1 Cholesky) at order n.
int kernel_index(int n, int cholesky) {
  return (cholesky != 0) + (n > kThreads ? 2 : 0);
}

// What a device was found to take: the dynamic shared memory a block can
// take (0 until known), and whether each mode's kernel is set up for it.
constexpr int kMaxDevices = 64;
struct DeviceCache {
  int64_t room;
  bool ready[kKernels];
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
  for (int k = 0; k < kKernels; ++k) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel_at(k));
    if (err != cudaSuccess) return -static_cast<int64_t>(err);
    const int64_t left = optin - static_cast<int64_t>(attr.sharedSizeBytes);
    most = left < most ? left : most;
  }
  cache[device].room = most;
  return most;
}

// Sets the kernel of a mode at order n up on `device` and returns the
// shared bytes of its launch, or a negative error code.
int64_t prepare(int n, int cholesky, int device) {
  if (n < 1 || n > kMaxN) return -static_cast<int64_t>(cudaErrorInvalidValue);
  const int64_t avail = room(device);
  if (avail < 0) return avail;
  const int64_t bytes = shared_bytes(n);
  if (bytes > avail) return -static_cast<int64_t>(cudaErrorInvalidValue);
  DeviceCache& dev = cache[device];
  const int k = kernel_index(n, cholesky);
  if (!dev.ready[k]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_at(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(avail));
    if (err != cudaSuccess) return -static_cast<int64_t>(err);
    dev.ready[k] = true;
  }
  return bytes;
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

// The build's layout: out[0] threads a block, out[1] the panel width,
// out[2] the order cap.
extern "C" void fleet_solve_config(int* out) {
  out[0] = kThreads;
  out[1] = kW;
  out[2] = kMaxN;
}

// Dynamic shared memory of an order-n block, in bytes.
extern "C" int64_t fleet_solve_shared_bytes(int n) { return shared_bytes(n); }

// Dynamic shared memory a block of K2 can take on `device`, in bytes, or 0
// if the device cannot be queried.
extern "C" int64_t fleet_solve_room(int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return 0;
  const int64_t bytes = room(device);
  return bytes > 0 ? bytes : 0;
}

// Blocks of an order-n launch of a mode one multiprocessor holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// cudaError_t code.
extern "C" int fleet_solve_blocks_per_sm(int n, int cholesky, int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -scope.error();
  const int mode = cholesky != 0;
  const int64_t bytes = prepare(n, mode, device);
  if (bytes < 0) return static_cast<int>(bytes);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_at(kernel_index(n, mode)), kThreads,
      static_cast<size_t>(bytes));
  if (err != cudaSuccess) return -err;
  return blocks;
}

// The kernel of a mode at order n as built: out[0] registers a thread,
// out[1] local (spilled) bytes a thread, out[2] static shared bytes.
// Returns a cudaError_t code.
extern "C" int fleet_solve_attributes(int n, int cholesky, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, kernel_at(kernel_index(n, cholesky)));
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// Solve A x = b for `batch` scenarios on `stream` of `device`, a block
// each: a [batch, n, n] and b [batch, n] f64 row-major, x [batch, n] f64
// and info [batch] int32 out. w [batch, n, n] f64 is the working matrix
// (null only when n <= the panel width and factors == 0); with factors != 0
// it ends holding getrf's factors, and piv [batch, n] int32 (when not null)
// the 1-based pivots. cholesky != 0 takes the Cholesky mode (factors must
// be 0). Returns a cudaError_t code.
extern "C" int fleet_solve_launch(const double* a, const double* b, double* x,
                                  int* info, double* w, int* piv, int batch,
                                  int n, int factors, int cholesky, int device,
                                  void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  if (w == nullptr && (n > kW || factors != 0)) return cudaErrorInvalidValue;
  if (cholesky != 0 && factors != 0) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const int mode = cholesky != 0;
  const int64_t bytes = prepare(n, mode, device);
  if (bytes < 0) return static_cast<int>(-bytes);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w)) % 16 ==
      0;
  Problem pb{a, b, x, info, w, piv, n, ld_of(n), factors != 0, aligned};
  void* args[] = {&pb};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel_at(kernel_index(n, mode))),
      dim3(static_cast<unsigned>(batch)), dim3(kThreads), args,
      static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FLEET_SOLVE_TIMELINE
// The stamps of the last launch: out receives kStampBlocks x kStamps
// %globaltimer values (0 where none), smid each block's SM; both are
// zeroed for the next launch.
extern "C" int fleet_solve_timeline(unsigned long long* out, int* smid) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (err != cudaSuccess) return err;
  err = cudaMemcpyFromSymbol(smid, g_smid, sizeof(g_smid));
  if (err != cudaSuccess) return err;
  static const unsigned long long zeros[kStampBlocks * kStamps] = {};
  err = cudaMemcpyToSymbol(g_stamp, zeros, sizeof(zeros));
  if (err != cudaSuccess) return err;
  static const int none[kStampBlocks] = {};
  return cudaMemcpyToSymbol(g_smid, none, sizeof(none));
}

// Block 0's group stamps of the last launch: out receives kGroupPanels x
// kGroupSlots x kGroupStamps values (0 where none).
extern "C" int fleet_solve_group_timeline(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_group, sizeof(g_group));
}
#endif

extern "C" const char* fleet_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
