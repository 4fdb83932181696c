// K2 fleet_solve: a fleet of dense f64 solves A x = b, one scenario a
// thread block, built for the fleet's throughput. The Cholesky and the LU
// up to order 128 keep the working matrix in device memory and one panel of
// columns in shared memory; the LU above 128 keeps the trailing matrix in
// shared memory once it fits there, one block an SM.
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
// Mapping of the Cholesky and the LU up to 128 (the panel layout), at N =
// 236 with the defaults (kThreads = 128, kW = 32):
// - One block a scenario, 4 warps. The working matrix lives in device
//   memory: a scratch [B, N, N] the wrapper allocates (none when N <= kW:
//   one panel holds the whole matrix). Shared memory holds one panel of kW
//   columns (rows k0 .. N - 1, column-major, leading dimension N | 1 so
//   that the warps' row-wise and column-wise walks hit distinct banks), the
//   right-hand side, 1 / U's diagonal, the panel's row permutation, and a
//   region that is first the pivot step's candidates and then each warp's
//   kW x 8 block of U12: 73.7 KB, so three blocks (396 scenarios) fit on
//   an SM at 168 registers a thread (kMinBlocks). As built
//   (cudaFuncGetAttributes in chip_smoke.py's k2_times; ptxas -v): the LU
//   to 128 168 registers, 64 local bytes a thread (68 bytes of spill
//   stores); the Cholesky 168 registers, 112 local bytes a thread (116
//   bytes of spill stores to 128, 136 above), 3 blocks an SM at N = 236.
//   One block's barriers and loads hide behind the other blocks' work.
// - Right-looking, a panel at a time. The panel is staged from device
//   memory (panel 0 straight from A) and factored with a thread a row (the
//   Cholesky above 128 two rows a thread; orders up to 128 have kernels of
//   their own with one, half the registers), one __syncthreads a column,
//   or a __syncwarp where the panel's rows all lie in one warp (N <= 32,
//   the last panel). A row's
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
// The LU above 128 (the wide LU; the kernel fleet_solve_kernel<false,
// kWideSlots>, 256 threads, a row a thread in the column steps):
// - It keeps the trailing matrix in shared memory from panel p* on, the
//   first panel at which that matrix (rows and columns 32 p* .. N - 1,
//   column-major at leading dimension (N - 32 p*) | 1) fits beside the
//   region (2,048 doubles: each of 8 warps' U12 block), the right-hand
//   side, 1 / U's diagonal and the ints (first_on_chip, from the card's
//   room): on an H100 p* = 0 up to N = 161 (A read once into it), 1 at
//   case118's 181 (149 x 149, 219 KB a block), 3 at 236, 4 at 256. One
//   block an SM.
// - The panels before p* are staged and streamed as above (their trailing
//   updates, device memory to device memory, a lane a row); the last of
//   them (the handover) writes the rows below it into the on-chip matrix
//   and its U rows into the scratch, which the back substitution reads.
//   Its staging lies over the on-chip matrix's last columns, which its
//   last round of 64 columns writes only after a block barrier. Its U12 is
//   solved a thread a column of the round (gathered through src from A or
//   w, solved in registers, into the region), then each warp updates 8
//   columns, a lane a row, and writes their U12 to w after its gathers.
// - From p* on a panel is factored in place (the column steps as above,
//   only the warps that hold rows k0 .. N - 1 taking part, on a named
//   barrier), then a thread a trailing column applies the panel's row swaps
//   to it and solves its U12 in registers, and the warps update groups of
//   8 columns, a lane a row with a compile-time count of row slots
//   (tile_update), A22 -= L21 U12 in place.
// - The back substitution reads an on-chip panel's triangle and the rows
//   above it from the on-chip matrix (above 32 p*: from the scratch). With
//   factors, the on-chip part is written out at the end, in getrf's
//   layout, the left swaps applied.
// - As built (ptxas -v): 255 registers, 24 bytes of stack, 2 barriers.
//   What sets its time at N = 181 (scripts/k2_timeline.py, per panel of
//   block 0): the column steps' chain, ~1.3 us a step, ~40 us a panel, ~220
//   of a block's ~320 us; the handover ~45 us; the on-chip updates 7-20 us a
//   panel. One block an SM no longer hides one block's chain behind
//   another's memory waits.
//
// Arithmetic: no atomics, and every value is a fixed sequence of FMAs. An
// element (i, c) is updated by fma(-L[i][t], U[t][c], a) for t = 0, 1, ...
// in order, whichever phase, warp or panel does it; the right-hand side by
// fma(-L[i][t], y[t], y[i]) in the same order, and the back substitution
// subtracts the columns from the last down. So the result does not depend
// on the panel width or the block size, one input gives one bit pattern,
// and the arithmetic is that of the cluster kernel this one replaced.
//
// Bound: at case118 x1024 (N = 181) the input is 268 MB, read once
// (0.081 ms at 3.35 TB/s), and the LU 4.05e9 f64 operations (0.060 ms at 67
// TFLOP/s; 0.12 ms on the FMA pipes this kernel uses). The panel layout's
// right-looking update reads and writes the trailing matrix once a panel
// (~N³ / (3 kW) x 16 bytes a scenario); the wide LU reads A once and
// writes and reads the handover's U rows (38 KB a scenario at 181).

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
// kThreads (two rows a thread), which spills at 168, one block an SM (its
// working matrix fills the SM's shared memory) at up to 255
constexpr int kMinBlocks = 12 * kWarp / kThreads;
constexpr int kWideLuMinBlocks = 1;
// column steps between two shifts of a row's registers
constexpr int kLuStep = 2;
constexpr int kCholStep = 4;
constexpr int kW = FLEET_SOLVE_PANEL;  // panel width
constexpr int kMaxN = 256;             // the largest order K2 takes
// the LU above kThreads: a thread a row of the largest order
constexpr int kWideThreads = kMaxN;
constexpr int kWideWarps = kWideThreads / kWarp;
// rows below a panel a lane of the wide LU's trailing update holds
constexpr int kWideRows = (kMaxN - kW + kWarp - 1) / kWarp;
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
  int chip;     // the wide LU: the first panel factored in shared memory
};

// The pivot step's per-column buffers, double-buffered by the column's
// parity. They share their room with the warps' U12 blocks, which only the
// trailing update uses.
template <int kNW>  // warps of the block
struct PanelSmallT {
  // rows from column j on, the right-hand side at [kW]
  double crow[2][kNW][kW + 1];  // LU: each warp's candidate's row
  double cval[2][kNW];          // ... its |a|
  double crcp[2][kNW];  // ... 1 / its pivot (Cholesky [0]: 1 / s)
  double jrow[2][kW + 1];  // LU: row j; Cholesky: column j from row j down
  int cidx[2][kNW];         // ... the candidate's row
  int corg[2][kNW];         // ... its panel-start row
  int jorg[2];              // LU: row j's panel-start row
};
using PanelSmall = PanelSmallT<kWarps>;

// Doubles of the shared region that is first PanelSmall, then the warps'
// U12 blocks, then (back substitution) the panel's unknowns.
constexpr int kUs = kWarps * kW * kCols;
constexpr int kSmallDoubles =
    static_cast<int>((sizeof(PanelSmall) + sizeof(double) - 1) /
                     sizeof(double));
constexpr int kRegion = kUs > kSmallDoubles ? kUs : kSmallDoubles;
// ... and the wide LU's, for its warps
constexpr int kWideUs = kWideWarps * kW * kCols;
constexpr int kWideSmall = static_cast<int>(
    (sizeof(PanelSmallT<kWideWarps>) + sizeof(double) - 1) / sizeof(double));
constexpr int kWideRegion = kWideUs > kWideSmall ? kWideUs : kWideSmall;

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

// The LU above kThreads (the wide LU) keeps the working matrix in shared
// memory from panel `chip` on: rows and columns ks = kW chip .. n - 1,
// column-major at leading dimension (n - ks) | 1. The panels before it are
// staged and streamed as the panel layout streams them.
__host__ __device__ inline int chip_rows(int n, int chip) {
  return n > kW * chip ? n - kW * chip : 0;
}

// Where streamed panel p is staged, in doubles from the matrix area's
// start, at leading dimension stage_ld. The last one (chip - 1), whose
// trailing update writes the on-chip matrix, lies above the columns that
// the update's rounds before its last write (a round: a group of kCols
// columns a warp); the last round holds its stores until every warp is
// done with the panel.
__host__ __device__ inline int stage_ld(int n, int p) {
  return (n - kW * p) | 1;
}
__host__ __device__ inline int64_t stage_at(int n, int chip, int p) {
  if (p != chip - 1) return 0;
  const int m = chip_rows(n, chip);
  const int groups = (m + kCols - 1) / kCols;
  const int rounds = (groups + kWideWarps - 1) / kWideWarps;
  return rounds > 0
             ? static_cast<int64_t>(m | 1) * kCols * kWideWarps * (rounds - 1)
             : 0;
}

// Doubles of the matrix area: the on-chip matrix and the staged panels.
__host__ __device__ inline int64_t area_doubles(int n, int chip) {
  const int m = chip_rows(n, chip);
  int64_t area = static_cast<int64_t>(m) * (m | 1);
  for (int p = 0; p < chip; ++p) {
    const int64_t end =
        stage_at(n, chip, p) + static_cast<int64_t>(kW) * stage_ld(n, p);
    area = end > area ? end : area;
  }
  return area;
}

// Dynamic shared memory of a wide LU block: the region, the right-hand
// side and 1 / U's diagonal, the matrix area (doubles), then the row
// permutation, the panel's pivots and info (ints).
__host__ __device__ inline int64_t wide_bytes(int n, int chip) {
  const int64_t doubles =
      kWideRegion + 2 * static_cast<int64_t>(n) + area_doubles(n, chip);
  return 8 * doubles + 4 * (static_cast<int64_t>(n) + kW + 1);
}

// The first panel from which a wide LU block fits in `room` bytes (the
// panel count: none), or -1 where no layout fits.
inline int first_on_chip(int n, int64_t room) {
  const int panels = (n + kW - 1) / kW;
  for (int chip = 0; chip <= panels; ++chip) {
    if (wide_bytes(n, chip) <= room) return chip;
  }
  return -1;
}

__device__ View wide_view(double* base, int n, int chip) {
  View v;
  v.ps = reinterpret_cast<PanelSmall*>(base);
  v.us = base;
  v.xpan = base;
  v.y = base + kWideRegion;
  v.urcp = v.y + n;
  v.L = v.urcp + n;  // the matrix area; each panel sets its own view
  v.src = reinterpret_cast<int*>(v.L + area_doubles(n, chip));
  v.piv = v.src + n;
  v.info = v.piv + kW;
  return v;
}

// The wide LU's on-chip matrix: element (r, c), r, c >= ks, of a
// scenario's working matrix at a[(c - ks) * ld + r - ks].
struct Chip {
  double* a;
  int ld;
  int ks;
  __device__ double& at(int r, int c) const {
    return a[(c - ks) * ld + r - ks];
  }
};

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

// A barrier of the threads that factor a panel: the block, or (kPart)
// `warps` warps through named barrier 1.
template <bool kPart>
__device__ __forceinline__ void panel_sync(int warps) {
  if constexpr (kPart) {
    asm volatile("bar.sync 1, %0;" : : "r"(warps * kWarp) : "memory");
  } else {
    __syncthreads();
  }
}

// Factors the staged panel (global columns k0 .. k0 + nf - 1, rows k0 ..
// n - 1) and carries the right-hand side through it, with kT threads: a
// thread a row (rows tid, tid + kT, ...), one __syncthreads a column (kPart,
// a row a thread: only the warps that hold rows k0 .. n - 1 take part, the
// others return at once, and a named barrier of theirs replaces it). A
// row's values and its right-hand side stay in registers for the whole
// panel, shifted down kStep columns every kStep steps (kLuStep, kCholStep;
// a[h][s] is column j at step s), so that the step is one compact loop
// body: a fully unrolled panel is thousands of instructions. Column j of a
// row, final after step j, goes to the panel at the row's panel-start
// position (org); the LU's rows are put in pivot order at the end.
template <bool kChol, int kSlots, int kT = kThreads, bool kPart = false>
__device__ void factor_panel(const View& v, const Problem& pb, int k0, int nf,
                             int64_t s) {
  constexpr int kStep = kChol ? kCholStep : kLuStep;
  static_assert(kW % kStep == 0, "the panel is a whole number of steps");
  const int n = pb.n;
  const int ld = pb.ld;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  constexpr int kNW = kT / kWarp;  // warps
  PanelSmallT<kNW>& sm = *reinterpret_cast<PanelSmallT<kNW>*>(v.ps);
  double a[kSlots][kW];
  double yv[kSlots];  // the row's right-hand side
  int org[kSlots];
  bool own[kSlots];
#pragma unroll
  for (int h = 0; h < kSlots; ++h) {
    const int r = tid + kT * h;
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
  const int ow = (k0 % kT) / kWarp;
  const int w0 = kPart ? k0 / kWarp : solo ? ow : 0;
  const int w1 = kPart ? (n + kWarp - 1) / kWarp : solo ? ow + 1 : kNW;
  const int boss = w0 * kWarp;  // the thread that keeps the pivots
  static_assert(!kPart || kSlots == 1, "a row a thread");
  if (kPart && (warp < w0 || warp >= w1)) return;
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
            const int r = tid + kT * h;
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
            const int r = tid + kT * h;
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
            panel_sync<kPart>(w1 - w0);
          }
          double best = sm.cval[par][w0];
          int win = w0;
          p = sm.cidx[par][w0];
#pragma unroll
          for (int w = 1; w < kNW; ++w) {
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
            const int r = tid + kT * h;
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
            panel_sync<kPart>(w1 - w0);
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
          const int r = tid + kT * h;
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
    if (own[h]) v.y[tid + kT * h] = yv[h];
  }
  panel_sync<kPart>(w1 - w0);
  if constexpr (!kChol) {
    // the rows in pivot order: new row r is panel-start row src[r]
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int r = tid + kT * h;
      if (own[h]) {
        const int o = v.src[r];
#pragma unroll
        for (int t = 0; t < kW; ++t) a[h][t] = t < nf ? v.L[t * ld + o] : 0.0;
      }
    }
    panel_sync<kPart>(w1 - w0);
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int r = tid + kT * h;
      if (own[h]) {
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          if (t < nf) v.L[t * ld + r] = a[h][t];
        }
      }
    }
    panel_sync<kPart>(w1 - w0);
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

// A lane's M rows r, r + 32, ... of a group of cn <= kCols columns (row
// slots, all in use: a count known at compile time, so that no slot waits
// behind another's branch) updated with A22 -= L21 U12 over the panel's kW
// columns, t = 0, 1, ... in order: L21's row of panel column t at L[t * ld
// + row], U12's row t of the group's column q at U[t * ut + q * uq] (the
// columns past cn read column cn - 1: their sums are never stored, and the
// on-chip matrix may end at the group's last column).
template <int M>
__device__ __forceinline__ void tile_fma(double (&acc)[kWideRows][kCols],
                                         const double* L, int ld, int r,
                                         int n, const double* U, int ut,
                                         int uq, int cn) {
  static_assert(M >= 1 && M <= kWideRows, "row slots of a lane");
#pragma unroll 2
  for (int t = 0; t < kW; ++t) {
    double u[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      u[q] = U[t * ut + (q < cn ? q : cn - 1) * uq];
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int row = r + kWarp * m;
      const double l = L[t * ld + (row < n ? row : n - 1)];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[m][q] = fma(-l, u[q], acc[m][q]);
    }
  }
}

// ... for the mcnt row slots in use (1 .. kWideRows).
__device__ __forceinline__ void tile_update(double (&acc)[kWideRows][kCols],
                                            const double* L, int ld, int r,
                                            int n, const double* U, int ut,
                                            int uq, int cn, int mcnt) {
  switch (mcnt) {
    case 1: tile_fma<1>(acc, L, ld, r, n, U, ut, uq, cn); break;
    case 2: tile_fma<2>(acc, L, ld, r, n, U, ut, uq, cn); break;
    case 3: tile_fma<3>(acc, L, ld, r, n, U, ut, uq, cn); break;
    case 4: tile_fma<4>(acc, L, ld, r, n, U, ut, uq, cn); break;
    case 5: tile_fma<5>(acc, L, ld, r, n, U, ut, uq, cn); break;
    case 6: tile_fma<6>(acc, L, ld, r, n, U, ut, uq, cn); break;
    default: tile_fma<kWideRows>(acc, L, ld, r, n, U, ut, uq, cn); break;
  }
}

// The wide LU's phases. Each rebuilds its view of shared memory from the
// layout, the panel's view at loff doubles from the matrix area at leading
// dimension ld, so that little state lives across them (inlined, the
// kernel builds at 255 registers with 24 bytes of stack; as separate calls
// it spilled and saved registers around each).
__device__ __forceinline__ void wide_factor(int n, int chip, int ld,
                                            int loff, int* piv, int k0) {
  extern __shared__ __align__(16) double smem[];
  View v = wide_view(smem, n, chip);
  v.L += loff;
  Problem q{};
  q.n = n;
  q.ld = ld;
  q.piv = piv;
  factor_panel<false, 1, kWideThreads, true>(v, q, k0,
                                             n - k0 < kW ? n - k0 : kW, 0);
}

// A streamed panel's trailing update before the handover, device memory
// to device memory (`from`: A or w), a warp a group of kCols columns in
// turn: U12, the panel's rows of these columns gathered through src,
// solved with L11 into the warp's block (update_group's lanes and
// arithmetic); the rows below gathered through src, a lane a row with all
// its columns (kWideRows rows a lane, 32 apart; 16-byte loads and stores
// where `vec`), updated (tile_update) and stored in place, and U12 too.
__device__ __forceinline__ void wide_stream_panel(int n, int chip, int ld,
                                                  int loff, int k0,
                                                  const double* from,
                                                  double* w, bool vec) {
  extern __shared__ __align__(16) double smem[];
  const View v = wide_view(smem, n, chip);
  const double* L = v.L + loff;  // row r of panel column t at L[t * ld + r]
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  double* us = v.us + warp * kW * kCols;  // [kW][kCols]
  const int pnl = k0 / kW;
  const int rb = k0 + kW;
  const int mcnt = (n - rb + kWarp - 1) / kWarp;
  const int groups = (n - rb + kCols - 1) / kCols;
  for (int g = warp; g < groups; g += kWideWarps) {
    const int c0 = rb + g * kCols;
    const int cn = n - c0 < kCols ? n - c0 : kCols;
    const bool whole = vec && cn == kCols;
    const int gslot = g / kWideWarps;
    stamp_group(pnl, gslot, 0);
    // the warp's lanes are done with its previous group's U12 first
    __syncwarp();
#pragma unroll
    for (int e = lane; e < kW * kCols; e += kWarp) {
      const int t = e / kCols;
      const int q = e % kCols;
      us[e] = q < cn ? from[static_cast<int64_t>(v.src[k0 + t]) * n + c0 + q]
                     : 0.0;
    }
    __syncwarp();
    {
      const int q = lane % kCols;
      const int gl = lane / kCols;
      double u[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        u[i] = us[(gl + kLanesPerCol * i) * kCols + q];
      }
#pragma unroll 1
      for (int t4 = 0; t4 < kPer; ++t4) {
#pragma unroll
        for (int gs = 0; gs < kLanesPerCol; ++gs) {
          const int t = kLanesPerCol * t4 + gs;
          const double ut = __shfl_sync(kFull, u[0], q + kCols * gs);
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int r = gl + kLanesPerCol * (i + t4);
            if (i + t4 < kPer && r > t) {
              u[i] = fma(-L[t * ld + k0 + r], ut, u[i]);
            }
          }
        }
        us[(gl + kLanesPerCol * t4) * kCols + q] = u[0];
#pragma unroll
        for (int i = 0; i + 1 < kPer; ++i) u[i] = u[i + 1];
      }
    }
    double acc[kWideRows][kCols];
#pragma unroll
    for (int m = 0; m < kWideRows; ++m) {
      const int r = rb + lane + kWarp * m;
      const bool ok = m < mcnt && r < n;
      const int64_t row = ok ? v.src[r] : 0;
      if (ok && whole) {
        const double2* sp =
            reinterpret_cast<const double2*>(from + row * n + c0);
#pragma unroll
        for (int h = 0; h < kCols / 2; ++h) {
          const double2 x = sp[h];
          acc[m][2 * h] = x.x;
          acc[m][2 * h + 1] = x.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          acc[m][q] = ok && q < cn ? from[row * n + c0 + q] : 0.0;
        }
      }
    }
    stamp_group(pnl, gslot, 1);
    // every read of these columns is done before any of them is written
    __syncwarp();
    tile_update(acc, L, ld, rb + lane, n, us, kCols, 1, cn, mcnt);
    stamp_group(pnl, gslot, 2);
#pragma unroll
    for (int m = 0; m < kWideRows; ++m) {
      const int r = rb + lane + kWarp * m;
      if (m < mcnt && r < n) {
        double* dp = w + static_cast<int64_t>(r) * n + c0;
        if (whole) {
#pragma unroll
          for (int h = 0; h < kCols / 2; ++h) {
            reinterpret_cast<double2*>(dp)[h] =
                make_double2(acc[m][2 * h], acc[m][2 * h + 1]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            if (q < cn) dp[q] = acc[m][q];
          }
        }
      }
    }
    for (int e = lane; e < kW * kCols; e += kWarp) {
      const int t = e / kCols;
      const int q = e % kCols;
      if (q < cn) w[static_cast<int64_t>(k0 + t) * n + c0 + q] = us[e];
    }
    stamp_group(pnl, gslot, 3);
  }
}

// The on-chip panel k0's trailing update, in place in the on-chip matrix.
// First a thread a trailing column applies the panel's row swaps to it
// (the rows end in pivot order: new row r is old row src[r]) and solves
// its U12 (the panel's rows) with L11 in registers, each row r by t = 0 ..
// r - 1 in order; then the warps take groups of kCols columns, a lane a
// row below the panel (tile_fma), with U12 read from the panel's rows.
__device__ __forceinline__ void wide_chip_panel(int n, int chip, int k0) {
  extern __shared__ __align__(16) double smem[];
  const View v = wide_view(smem, n, chip);
  const Chip cm{v.L, chip_rows(n, chip) | 1, kW * chip};
  const int c1 = k0 + kW;
  const int tid = threadIdx.x;
  stamp_group(k0 / kW, 0, 0);
  if (tid < n - c1) {
    const int c = c1 + tid;
    for (int t = 0; t < kW; ++t) {
      const int r = v.piv[t];
      if (r != k0 + t) {
        const double x = cm.at(k0 + t, c);
        cm.at(k0 + t, c) = cm.at(r, c);
        cm.at(r, c) = x;
      }
    }
    double u[kW];
#pragma unroll
    for (int t = 0; t < kW; ++t) u[t] = cm.at(k0 + t, c);
#pragma unroll
    for (int t = 0; t < kW; ++t) {
#pragma unroll
      for (int r = t + 1; r < kW; ++r) {
        u[r] = fma(-cm.at(k0 + r, k0 + t), u[t], u[r]);
      }
    }
#pragma unroll
    for (int t = 0; t < kW; ++t) cm.at(k0 + t, c) = u[t];
  }
  stamp_group(k0 / kW, 0, 1);
  __syncthreads();
  stamp_group(k0 / kW, 0, 2);
  const int lane = tid % kWarp;
  const int rb = c1;
  const int mcnt = (n - rb + kWarp - 1) / kWarp;
  // row r of panel column t at L[t * ld + r]
  const double* L = v.L + (k0 - cm.ks) * cm.ld - cm.ks;
  const int groups = (n - c1 + kCols - 1) / kCols;
  for (int g = tid / kWarp; g < groups; g += kWideWarps) {
    const int c0 = c1 + g * kCols;
    const int cn = n - c0 < kCols ? n - c0 : kCols;
    double acc[kWideRows][kCols];
#pragma unroll
    for (int m = 0; m < kWideRows; ++m) {
      const int r = rb + lane + kWarp * m;
      const bool ok = m < mcnt && r < n;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        acc[m][q] = ok && q < cn ? cm.at(r, c0 + q) : 0.0;
      }
    }
    // U12 of these columns: row t of column c0 + q at U[t + q * ld]
    tile_update(acc, L, cm.ld, rb + lane, n, &cm.at(k0, c0), 1, cm.ld, cn,
                mcnt);
#pragma unroll
    for (int m = 0; m < kWideRows; ++m) {
      const int r = rb + lane + kWarp * m;
      if (m < mcnt && r < n) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (q < cn) cm.at(r, c0 + q) = acc[m][q];
        }
      }
    }
  }
  stamp_group(k0 / kW, 0, 3);
}

// The handover's trailing update (panel k0, staged at loff doubles from the
// matrix area at leading dimension ld, its rows in device memory `from`):
// the rows below it into the on-chip matrix. A round of kCols columns a
// warp at a time: a thread a column of the round gathers its U12 through
// src and solves it with L11 in registers into the region; then each warp
// gathers the rows below of its kCols columns through src, a lane a row,
// updates them (tile_update) and stores them into the on-chip matrix, and
// their U12 into w (after its gathers: a pivot row may be one of them).
// The staging lies over the columns of the last round, whose stores wait
// at a block barrier until every warp is done with the panel.
__device__ __forceinline__ void wide_handover_panel(int n, int chip, int ld,
                                                    int loff, int k0,
                                                    const double* from,
                                                    double* w, bool vec) {
  extern __shared__ __align__(16) double smem[];
  const View v = wide_view(smem, n, chip);
  const Chip cm{v.L, chip_rows(n, chip) | 1, kW * chip};
  const double* L = v.L + loff;  // row r of panel column t at L[t * ld + r]
  constexpr int kRound = kWideWarps * kCols;
  double* us = v.us;  // [kW][kRound] the round's U12
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int c1 = k0 + kW;
  const int rb = c1;
  const int mcnt = (n - rb + kWarp - 1) / kWarp;
  const int rounds = (n - c1 + kRound - 1) / kRound;
  for (int rd = 0; rd < rounds; ++rd) {
    const int cb = c1 + rd * kRound;
    stamp_group(k0 / kW, rd, 0);
    if (tid < kRound && cb + tid < n) {
      const int c = cb + tid;
      double u[kW];
#pragma unroll
      for (int t = 0; t < kW; ++t) {
        u[t] = from[static_cast<int64_t>(v.src[k0 + t]) * n + c];
      }
#pragma unroll
      for (int t = 0; t < kW; ++t) {
#pragma unroll
        for (int r = t + 1; r < kW; ++r) {
          u[r] = fma(-L[t * ld + k0 + r], u[t], u[r]);
        }
      }
#pragma unroll
      for (int t = 0; t < kW; ++t) us[t * kRound + tid] = u[t];
    }
    __syncthreads();
    stamp_group(k0 / kW, rd, 1);
    const int c0 = cb + warp * kCols;
    const int cn = n - c0 < kCols ? n - c0 : kCols;
    double acc[kWideRows][kCols];
    if (cn > 0) {
      const bool whole = vec && cn == kCols;
#pragma unroll
      for (int m = 0; m < kWideRows; ++m) {
        const int r = rb + lane + kWarp * m;
        const bool ok = m < mcnt && r < n;
        const int64_t row = ok ? v.src[r] : 0;
        if (ok && whole) {
          const double2* sp =
              reinterpret_cast<const double2*>(from + row * n + c0);
#pragma unroll
          for (int h = 0; h < kCols / 2; ++h) {
            const double2 x = sp[h];
            acc[m][2 * h] = x.x;
            acc[m][2 * h + 1] = x.y;
          }
        } else {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            acc[m][q] = ok && q < cn ? from[row * n + c0 + q] : 0.0;
          }
        }
      }
      // every gather of these columns is done before w's are written
      __syncwarp();
      for (int e = lane; e < kW * kCols; e += kWarp) {
        const int t = e / kCols;
        const int q = e % kCols;
        if (q < cn) {
          w[static_cast<int64_t>(k0 + t) * n + c0 + q] =
              us[t * kRound + warp * kCols + q];
        }
      }
      tile_update(acc, L, ld, rb + lane, n, us + warp * kCols, kRound, 1, cn,
                  mcnt);
    }
    stamp_group(k0 / kW, rd, 2);
    if (rd == rounds - 1) __syncthreads();
    if (cn > 0) {
#pragma unroll
      for (int m = 0; m < kWideRows; ++m) {
        const int r = rb + lane + kWarp * m;
        if (m < mcnt && r < n) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            if (q < cn) cm.at(r, c0 + q) = acc[m][q];
          }
        }
      }
    }
    stamp_group(k0 / kW, rd, 3);
    __syncthreads();  // the region is the next round's
  }
}

// The wide LU of one scenario (block). Panels before pb.chip are staged
// and streamed through device memory as the panel layout does it, except
// that the last one (the handover) updates the rows below it into the
// on-chip matrix; from pb.chip on the panels are factored and updated in
// place there, and the back substitution reads their U from it. The
// arithmetic is the panel layout's, operation for operation.
__device__ __forceinline__ void wide_lu(const Problem& pb, double* smem) {
  const int n = pb.n;
  const int chip = pb.chip;
  const int ks = kW * chip;
  const int m = chip_rows(n, chip);
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const View v = wide_view(smem, n, chip);
  double* const area = v.L;
  const Chip cm{area, m | 1, ks};
  const double* a = pb.a + s * n * n;
  double* w = pb.w == nullptr ? nullptr : pb.w + s * n * n;
  const bool vec = n % 2 == 0 && pb.aligned;
  int event = 0;
  stamp(event++);
  for (int i = tid; i < n; i += kWideThreads) v.y[i] = pb.b[s * n + i];
  if (tid == 0) *v.info = 0;
  if (chip == 0) {
    // the whole matrix on chip: A read once, a row at a time
    for (int r = 0; r < n; ++r) {
      for (int c = tid; c < n; c += kWideThreads) {
        cm.at(r, c) = a[static_cast<int64_t>(r) * n + c];
      }
    }
  }

  const int panels = (n + kW - 1) / kW;
  for (int p = 0; p < panels; ++p) {
    const int k0 = p * kW;
    const int nf = n - k0 < kW ? n - k0 : kW;
    const bool on = p >= chip;
    const double* from = p == 0 ? a : w;
    // the panel's view: element (r, k0 + t) at area[loff + t * ld + r]
    int ld = m | 1;
    int loff = (k0 - ks) * ld - ks;
    if (!on) {
      ld = stage_ld(n, p);
      loff = static_cast<int>(stage_at(n, chip, p)) - k0;
      // stage the panel: rows k0 .. n - 1, a row's kW columns a warp
      for (int e = tid; e < (n - k0) * kW; e += kWideThreads) {
        const int r = k0 + e / kW;
        const int t = e % kW;
        if (t < nf) {
          area[loff + t * ld + r] = from[static_cast<int64_t>(r) * n + k0 + t];
        }
      }
    }
    for (int r = k0 + tid; r < n; r += kWideThreads) v.src[r] = r;
    __syncthreads();
    stamp(event++);
    wide_factor(n, chip, ld, loff, pb.piv == nullptr ? nullptr : pb.piv + s * n,
                k0);
    __syncthreads();
    stamp(event++);
    if (!on && w != nullptr) {
      // the streamed panel into the working matrix: its U rows (L21 only
      // for the factors)
      const int rend = pb.factors ? n : k0 + nf;
      for (int e = tid; e < (rend - k0) * kW; e += kWideThreads) {
        const int r = k0 + e / kW;
        const int t = e % kW;
        if (t < nf) {
          w[static_cast<int64_t>(r) * n + k0 + t] = area[loff + t * ld + r];
        }
      }
    }
    // the warps' groups of trailing columns
    if (on) {
      wide_chip_panel(n, chip, k0);
    } else if (p == chip - 1) {
      wide_handover_panel(n, chip, ld, loff, k0, from, w, vec);
    } else {
      wide_stream_panel(n, chip, ld, loff, k0, from, w, vec);
    }
    if (pb.factors && k0 > 0) {
      // getrf's L: the panel's swaps on the columns left of it
      for (int c = tid; c < k0; c += kWideThreads) {
        for (int t = 0; t < nf; ++t) {
          const int r = v.piv[t];
          if (r == k0 + t) continue;
          double& x0 = c < ks ? w[static_cast<int64_t>(k0 + t) * n + c]
                              : cm.at(k0 + t, c);
          double& x1 = c < ks ? w[static_cast<int64_t>(r) * n + c]
                              : cm.at(r, c);
          const double tmp = x0;
          x0 = x1;
          x1 = tmp;
        }
      }
    }
    stamp(event++);
    __syncthreads();
    stamp(event++);
  }
  if (pb.factors) {
    // the on-chip part of the factors
    for (int r = ks; r < n; ++r) {
      for (int c = ks + tid; c < n; c += kWideThreads) {
        w[static_cast<int64_t>(r) * n + c] = cm.at(r, c);
      }
    }
  }

  // back substitution U x = y, a panel at a time from the last: an on-chip
  // panel's triangle read in place, a streamed one's staged from w. U(q, t)
  // = U[k0 + q][k0 + t], q <= t, at tri[t * tld + q]
  for (int p = panels - 1; p >= 0; --p) {
    const int k0 = p * kW;
    const int nf = n - k0 < kW ? n - k0 : kW;
    const double* tri = area;
    int tld = kW + 1;
    if (p >= chip) {
      tri = &cm.at(k0, k0);
      tld = m | 1;
    } else {
      // the on-chip matrix is done with: stage over its start
      for (int e = tid; e < kW * kW; e += kWideThreads) {
        const int hi = e / kW;
        const int lo = e % kW;
        if (hi < nf && lo < nf) {
          area[lo * tld + hi] = w[static_cast<int64_t>(k0 + hi) * n + k0 + lo];
        }
      }
      __syncthreads();
    }
    if (warp == 0) {
      const int lane = tid;
      double yl = lane < nf ? v.y[k0 + lane] : 0.0;
      double xl = 0.0;
      for (int jj = nf - 1; jj >= 0; --jj) {
        const double xj = __shfl_sync(kFull, yl, jj) * v.urcp[k0 + jj];
        if (lane == jj) xl = xj;
        if (lane < jj) yl = fma(-tri[jj * tld + lane], xj, yl);
      }
      if (lane < nf) {
        v.xpan[lane] = xl;
        pb.x[s * n + k0 + lane] = xl;
      }
    }
    __syncthreads();
    for (int i = tid; i < k0; i += kWideThreads) {
      double yi = v.y[i];
      if (i < ks) {
        for (int jj = nf - 1; jj >= 0; --jj) {
          yi = fma(-w[static_cast<int64_t>(i) * n + k0 + jj], v.xpan[jj], yi);
        }
      } else {
        for (int jj = nf - 1; jj >= 0; --jj) {
          yi = fma(-cm.at(i, k0 + jj), v.xpan[jj], yi);
        }
      }
      v.y[i] = yi;
    }
    __syncthreads();
    stamp(event++);
  }
  if (tid == 0) pb.info[s] = *v.info;
  stamp(event);
}

template <bool kChol, int kSlots>
__global__ void __launch_bounds__(kChol || kSlots == 1 ? kThreads
                                                      : kWideThreads,
                                  kChol || kSlots == 1 ? kMinBlocks
                                                      : kWideLuMinBlocks)
    fleet_solve_kernel(Problem pb) {
  extern __shared__ __align__(16) double smem[];
  if constexpr (!kChol && kSlots > 1) {
    // the LU above kThreads keeps its working matrix on chip
    wide_lu(pb, smem);
    return;
  }
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

// Threads of a block of kernel k.
int threads_of(int k) { return k == 2 ? kWideThreads : kThreads; }

// The layout of a mode's order-n block on a device whose blocks take
// `room` bytes of dynamic shared memory: its shared bytes, and in *chip the
// first panel factored in place in shared memory (the panel count where
// none is: the panel layout of every kernel but the wide LU), or -1 where
// no layout fits.
int64_t layout(int n, int cholesky, int64_t room, int* chip) {
  const int panels = (n + kW - 1) / kW;
  if (cholesky != 0 || n <= kThreads) {
    const int64_t bytes = shared_bytes(n);
    *chip = bytes <= room ? panels : -1;
    return bytes;
  }
  *chip = first_on_chip(n, room);
  return wide_bytes(n, *chip < 0 ? panels : *chip);
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
// shared bytes of its launch (and in *chip its first on-chip panel), or a
// negative error code.
int64_t prepare(int n, int cholesky, int device, int* chip) {
  if (n < 1 || n > kMaxN) return -static_cast<int64_t>(cudaErrorInvalidValue);
  const int64_t avail = room(device);
  if (avail < 0) return avail;
  const int64_t bytes = layout(n, cholesky, avail, chip);
  if (*chip < 0) return -static_cast<int64_t>(cudaErrorInvalidValue);
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

// Dynamic shared memory of a mode's order-n block on a device whose blocks
// take `room` bytes, in bytes; *first_on_chip receives the first panel
// factored in place in shared memory (the panel count: none; -1: no layout
// fits).
extern "C" int64_t fleet_solve_shared_bytes(int n, int cholesky, int64_t room,
                                            int* first_on_chip) {
  return layout(n, cholesky, room, first_on_chip);
}

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
  int chip = 0;
  const int64_t bytes = prepare(n, mode, device, &chip);
  if (bytes < 0) return static_cast<int>(bytes);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_at(kernel_index(n, mode)),
      threads_of(kernel_index(n, mode)),
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
// (null only when factors == 0 and one panel, or for the wide LU shared
// memory from its first panel on, holds the whole); with factors != 0
// it ends holding getrf's factors, and piv [batch, n] int32 (when not null)
// the 1-based pivots. cholesky != 0 takes the Cholesky mode (factors must
// be 0). Returns a cudaError_t code.
extern "C" int fleet_solve_launch(const double* a, const double* b, double* x,
                                  int* info, double* w, int* piv, int batch,
                                  int n, int factors, int cholesky, int device,
                                  void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  if (cholesky != 0 && factors != 0) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const int mode = cholesky != 0;
  int chip = 0;
  const int64_t bytes = prepare(n, mode, device, &chip);
  if (bytes < 0) return static_cast<int>(-bytes);
  // a working matrix in device memory unless one panel, or shared memory
  // from the first panel on, holds the whole
  const bool streams = kernel_index(n, mode) == 2 ? chip > 0 : n > kW;
  if (w == nullptr && (streams || factors != 0)) return cudaErrorInvalidValue;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w)) % 16 ==
      0;
  Problem pb{a, b,        x,           info,    w,
             piv, n, ld_of(n), factors != 0, aligned, chip};
  void* args[] = {&pb};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel_at(kernel_index(n, mode))),
      dim3(static_cast<unsigned>(batch)),
      dim3(threads_of(kernel_index(n, mode))), args,
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
