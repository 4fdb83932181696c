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
// (the pattern's duplicates at one (row, column) summed from 0.0 in
// ascending raw position; an entry with one raw position is read
// directly), G's structural nonzeros in CSR by G row with ascending
// columns, and for each nonzero its contributions in a host-fixed order,
// each two entry references and a weight (w[r], or pair_off[p] for a pair
// term): w * (a * b). rhs's column lists name each column's entries in
// ascending row with their rows. For the fleet regime the G rows are cut
// into bands of `band` consecutive rows (about 512 elements of G a
// scenario), and each band lists the duplicated entries its contributions
// read (built at a table's first fleet launch, gain_fill.py::fleet_bands;
// null before).
//
// The values are read through two strides, v[ref * se + b * sb]: row-major
// [B, E] (se 1, sb E) or scenario-minor, an [E, B] buffer (se B, sb 1),
// which K3's entry mode writes for fleets (se_fill.cu).
//
// Fleet regime (the launcher's `fleet`, B >= gain_fill.py::FLEET_MIN): a
// thread block per (band, group of 32 scenarios), a lane per scenario, so
// every table load is the same for the 32 lanes of a warp (one broadcast)
// and a value is one 256-byte load of a scenario-minor buffer. The block
// first sums the band's duplicated entries once for its 32 scenarios into
// shared memory (ascending raw position, as entry() below), then its warps
// take the band's nonzeros in turn, each lane summing its scenario's
// contributions from 0.0 in the table's order into shared memory, and then
// stores the band's G rows whole for the 32 scenarios: a warp per (row,
// chunk of 32 VEC columns, quarter of the scenarios), a lane per VEC
// columns (VEC = 2 when N is even: 16-byte stores, lanes on neighbouring
// addresses), zeros included, each element once. Other blocks form rhs: a
// block per (group, 8 columns), a warp a column, a lane a scenario, staged
// in shared memory and stored a scenario's columns at a time; they come
// first in the grid, so that they run beside the bands.
//
// Small-B regime (B < FLEET_MIN: single estimates, LNR, the DC and PMU
// estimators): a warp per (scenario, G row, span of kSpan chunks). The warp
// streams its span in chunks; a chunk without structural nonzeros is
// stored as zeros straight away; for a chunk with nonzeros the warp zeroes
// its slice of shared memory, its lanes form the products w * (a * b) of
// the chunk's contributions 32 at a time (a duplicate by entry()), so that
// their loads are in flight together, and the lane of each nonzero adds
// its own products sequentially, from 0.0, in the table's order, into the
// slice; the lanes then store the chunk from shared memory. rhs: a warp per
// (scenario, column), its lanes forming the terms 32 at a time and lane 0
// adding them in order; these warps come first in the grid.
//
// In both regimes every element of G is written once by one lane, zeros
// included, with no memset, no atomics and no dependence on scheduling,
// and every nonzero and rhs element is summed by one thread in one order.
// _build.py compiles this source with -fmad=false, so every product and
// sum rounds on its own, as the plain version's elementwise ops and
// fixed-order segment sums do: the kernel and gain_fill_ref agree bit for
// bit at every batch and in either layout.
//
// Bound: writing G (B N² doubles) once at the HBM rate, plus the values,
// the residuals and the tables read once: 456 MB at case118 x1024 (N =
// 236), 1.92 GB at 1,369 buses x32 (N = 2,738), 0.8 GB for the 10k-bus DC
// estimator (N = 10,000), 0.14-0.57 ms at 3.35 TB/s. The structural
// nonzeros are a few in a thousand of G; their contributions are read from
// L1/L2 (the tables are shared by the scenarios).
//
// GAIN_FILL_TIMELINE (scripts/k8_timeline.py) makes thread 0 of each of
// the first kStampBlocks band blocks of the fleet regime stamp %globaltimer
// at the start and at the end of each phase (duplicate sums, nonzeros,
// stores) and record its SM, and lane 0 of each of the first kStampWarps
// warps of the small-B regime keep their span and the time they spent on
// products.

#include <cuda_runtime.h>

#include <cstdint>

// K8's tables (device pointers) and sizes, gain_fill.py::_Tables. At file
// scope, so that the extern "C" launcher that takes it keeps its external
// linkage.
struct GainTables {
  const int* nz_ptr;    // [N + 1] G row i's nonzeros
  const int* nz_col;    // [Z] their columns, ascending within a row
  const int* c_ptr;     // [Z + 1] each nonzero's contributions
  const int* c_a;       // [C] entry reference of a (>= 0: a raw position,
  const int* c_b;       // [C] ... of b           else -(d + 1): duplicate d)
  const int* c_w;       // [C] weight: r < m is w[r], m + p is pair_off[p]
  const int* dup_ptr;   // [D + 1] raw positions of each duplicated entry
  const int* dup_raw;   // [..]
  const int* col_ptr;   // [N + 1] column i's entries, ascending row
  const int* col_ref;   // [..] their references
  const int* col_row;   // [..] their rows
  const int* pair_of;   // [m] the pair of a row, or -1
  const int* partner;   // [m] the other row of that pair
  const int* f_a;       // [C] c_a with a duplicate as -(slot + 1), its slot
  const int* f_b;       // [C]   in its band's list (the fleet regime)
  const int* bdup_ptr;  // [bands + 1] each band's duplicated entries
  const int* bdup;      // [..] their d, ascending
  int n;                // N, the order of G
  int m;                // rows
  int entries;          // raw entries a scenario
  int slack;            // the slack column, or -1
  int slack_nz;         // the nonzero (slack, slack), or -1
  int band;             // G rows a band (the fleet regime, as below)
  int band_dups;        // the most duplicated entries of a band
  int band_nz;          // the most nonzeros of a band
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxChunk = 2 * kWarp;
constexpr int kSpan = 8;       // chunks a small-B warp streams
constexpr int kGroup = 32;     // scenarios a fleet block (a lane each)
constexpr int kParts = 4;      // a fleet store unit's share of them
constexpr int kPad = kGroup + 1;  // a nonzero's row in shared memory

// The value of raw entry `ref` of scenario b: v[ref se + b sb].
struct Values {
  const double* __restrict__ v;
  int64_t se;
  int64_t sb;
  __device__ __forceinline__ double at(int ref, int b) const {
    return v[ref * se + b * sb];
  }
};

// The value of an entry reference in scenario b (a duplicate summed).
__device__ __forceinline__ double entry(const GainTables& t, Values v,
                                        int ref, int b) {
  if (ref >= 0) return v.at(ref, b);
  const int d = -ref - 1;
  double s = 0.0;
  for (int q = t.dup_ptr[d]; q < t.dup_ptr[d + 1]; ++q) {
    s += v.at(t.dup_raw[q], b);
  }
  return s;
}

// The first position in [lo, hi) of the ascending `col` that is >= c.
__device__ __forceinline__ int lower_bound(const int* __restrict__ col,
                                           int lo, int hi, int c) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ double weight(const GainTables& t,
                                         const double* __restrict__ w,
                                         const double* __restrict__ off,
                                         int cw) {
  return cw < t.m ? w[cw] : off[cw - t.m];
}

// rhs[b, c]'s term of one column entry q: its value times (W r + P r)
// at its row, as gain_fill_ref forms them.
__device__ __forceinline__ double wr_of(const GainTables& t,
                                        const double* __restrict__ w,
                                        const double* __restrict__ off,
                                        const double* __restrict__ rb,
                                        int row) {
  double wr = w[row] * rb[row];
  const int p = t.pair_of[row];
  if (p >= 0) wr = wr + off[p] * rb[t.partner[row]];
  return wr;
}

template <int VEC>
__device__ __forceinline__ void store_pair(double* __restrict__ row, int c,
                                           double a, double b) {
  if (VEC == 2) {
    *reinterpret_cast<double2*>(row + c) = make_double2(a, b);
  } else {
    row[c] = a;
  }
}

#ifdef GAIN_FILL_TIMELINE
constexpr int kStampBlocks = 4096;
__device__ unsigned long long gain_fill_stamps[kStampBlocks][5];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// band block u's stamp `slot`
__device__ __forceinline__ void stamp(int u, int slot) {
  if (threadIdx.x == 0 && u < kStampBlocks) {
    gain_fill_stamps[u][slot] = globaltimer();
    if (slot == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      gain_fill_stamps[u][4] = sm;
    }
  }
}

// the small-B regime: lane 0 of each of the first kStampWarps warps keeps
// its start, the ns it spent forming and adding products (the duplicate
// sums inside them), its end, and its SM | kind << 16 (0: a G span, 1:
// rhs)
constexpr int kStampWarps = 32768;
__device__ unsigned long long gain_fill_warp_stamps[kStampWarps][4];

struct WarpClock {
  int64_t unit;
  unsigned long long start = 0;
  unsigned long long inside = 0;
  unsigned long long since = 0;
  __device__ explicit WarpClock(int64_t u) : unit(u) {
    start = globaltimer();
  }
  __device__ void enter() { since = globaltimer(); }
  __device__ void leave() { inside += globaltimer() - since; }
  __device__ void done(int kind) const {
    if (threadIdx.x % kWarp == 0 && unit < kStampWarps) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      gain_fill_warp_stamps[unit][0] = start;
      gain_fill_warp_stamps[unit][1] = inside;
      gain_fill_warp_stamps[unit][2] = globaltimer();
      gain_fill_warp_stamps[unit][3] = sm | (kind << 16);
    }
  }
};
#else
__device__ __forceinline__ void stamp(int, int) {}

struct WarpClock {
  __device__ explicit WarpClock(int64_t) {}
  __device__ void enter() {}
  __device__ void leave() {}
  __device__ void done(int) const {}
};
#endif

// ---- the fleet regime -------------------------------------------------------

constexpr int kBatch = 8;  // rhs terms' loads in flight a lane

// The product w * (a * b) of contribution e for the lane's scenario: a
// duplicate through its band slot in `dsum`.
__device__ __forceinline__ double product(const GainTables& t, Values v,
                                          const double* __restrict__ w,
                                          const double* __restrict__ off,
                                          const double* dsum, int e, int b,
                                          int lane) {
  const int ra = t.f_a[e];
  const int rb = t.f_b[e];
  const double wt = weight(t, w, off, t.c_w[e]);
  const double a = ra >= 0 ? v.at(ra, b) : dsum[(-ra - 1) * kGroup + lane];
  const double c = rb >= 0 ? v.at(rb, b) : dsum[(-rb - 1) * kGroup + lane];
  return wt * (a * c);
}

// Block (group, kWarps columns) of rhs: a warp a column, a lane a scenario,
// kBatch terms' loads at a time, added in order; staged in shared memory
// and stored a scenario's columns at a time.
__device__ __forceinline__ void fleet_rhs(const GainTables& t, Values v,
                                          const double* __restrict__ w,
                                          const double* __restrict__ off,
                                          const double* __restrict__ r,
                                          double* __restrict__ rhs, int batch,
                                          int c0, int b0, double* smem) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = b0 + lane;
  const int n = t.n;
  const int ncol = min(kWarps, n - c0);
  if (b < batch && warp < ncol) {
    const int c = c0 + warp;
    const double* rb = r + static_cast<int64_t>(b) * t.m;
    double s = 0.0;
    const int q1 = t.col_ptr[c + 1];
    for (int q = t.col_ptr[c]; q < q1; q += kBatch) {
      double term[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q + j < q1) {
          term[j] = entry(t, v, t.col_ref[q + j], b) *
                    wr_of(t, w, off, rb, t.col_row[q + j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q + j < q1) s += term[j];
      }
    }
    smem[warp * kPad + lane] = s;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < kGroup * ncol; x += kThreads) {
    const int s = x / ncol;
    const int cl = x % ncol;
    if (b0 + s < batch) {
      rhs[static_cast<int64_t>(b0 + s) * n + c0 + cl] = smem[cl * kPad + s];
    }
  }
}

// Block (band, group): the band's duplicate sums, its nonzeros and its rows
// of G for the group's 32 scenarios; the rhs blocks come first in the grid,
// so that they run beside the bands' blocks and not after them. Shared
// memory: the sums [band_dups][32], then the nonzeros [band_nz][kPad].
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gain_fleet_kernel(GainTables t, Values v, const double* __restrict__ w,
                  const double* __restrict__ off,
                  const double* __restrict__ r, double* __restrict__ g,
                  double* __restrict__ rhs, int batch, int rhs_blocks) {
  constexpr int kChunk = kWarp * VEC;
  extern __shared__ double smem[];
  const int n = t.n;
  if (static_cast<int>(blockIdx.x) < rhs_blocks) {
    const int col_blocks = (n + kWarps - 1) / kWarps;
    fleet_rhs(t, v, w, off, r, rhs, batch,
              (blockIdx.x % col_blocks) * kWarps,
              (blockIdx.x / col_blocks) * kGroup, smem);
    return;
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int bands = (n + t.band - 1) / t.band;
  // bands group-major: a group's values stay in L2
  const int u = blockIdx.x - rhs_blocks;
  const int band = u % bands;
  const int b0 = (u / bands) * kGroup;
  const int b = b0 + lane;
  const bool live = b < batch;
  double* dsum = smem;
  double* nzv = dsum + t.band_dups * kGroup;
  const int i0 = band * t.band;
  const int i1 = min(i0 + t.band, n);
  const int z0 = t.nz_ptr[i0];
  const int z1 = t.nz_ptr[i1];
  stamp(u, 0);
  // 1. the band's duplicated entries, each summed once for the group
  const int d0 = t.bdup_ptr[band];
  const int d1 = t.bdup_ptr[band + 1];
  for (int q = d0 + warp; q < d1; q += kWarps) {
    const int d = t.bdup[q];
    double s = 0.0;
    if (live) {
      for (int x = t.dup_ptr[d]; x < t.dup_ptr[d + 1]; ++x) {
        s += v.at(t.dup_raw[x], b);
      }
    }
    dsum[(q - d0) * kGroup + lane] = s;
  }
  __syncthreads();
  stamp(u, 1);
  // 2. the band's nonzeros, a warp each in turn, a lane a scenario
  for (int k = z0 + warp; k < z1; k += kWarps) {
    double s = 0.0;
    if (live) {
      const int e1 = t.c_ptr[k + 1];
#pragma unroll 4
      for (int e = t.c_ptr[k]; e < e1; ++e) {
        s += product(t, v, w, off, dsum, e, b, lane);
      }
      if (k == t.slack_nz) s += 1.0;  // the slack identity
    }
    nzv[(k - z0) * kPad + lane] = s;
  }
  __syncthreads();
  stamp(u, 2);
  // 3. the band's rows for the group, whole: a warp per (row, chunk,
  // quarter of the scenarios), a lane per VEC columns
  constexpr int kPer = kGroup / kParts;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int units = (i1 - i0) * chunks * kParts;
  for (int x = warp; x < units; x += kWarps) {
    const int part = x % kParts;
    const int rc = x / kParts;
    const int i = i0 + rc / chunks;
    const int c0 = (rc % chunks) * kChunk;
    const int c = c0 + VEC * lane;
    // the row's nonzeros inside the chunk, [p, q): warp-uniform
    const int end = t.nz_ptr[i + 1];
    const int p = lower_bound(t.nz_col, t.nz_ptr[i], end, c0);
    const int q = lower_bound(t.nz_col, p, end, c0 + kChunk);
    int s0 = -1;
    int s1 = -1;
    for (int k = p; k < q; ++k) {
      const int j = t.nz_col[k];
      if (j == c) s0 = (k - z0) * kPad;
      if (VEC == 2 && j == c + 1) s1 = (k - z0) * kPad;
    }
    const int lo = part * kPer;
    const int hi = min(lo + kPer, batch - b0);
    if (c >= n) continue;
    for (int s = lo; s < hi; ++s) {
      double* row = g + (static_cast<int64_t>(b0 + s) * n + i) * n;
      store_pair<VEC>(row, c, s0 >= 0 ? nzv[s0 + s] : 0.0,
                      s1 >= 0 ? nzv[s1 + s] : 0.0);
    }
  }
  stamp(u, 3);
}

// ---- the small-B regime -----------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gain_fill_kernel(GainTables t, Values v, const double* __restrict__ w,
                 const double* __restrict__ off,
                 const double* __restrict__ r, double* __restrict__ g,
                 double* __restrict__ rhs, int batch) {
  constexpr int kChunk = kWarp * VEC;
  __shared__ double chunk[kWarps][kMaxChunk];
  __shared__ double terms[kWarps][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n = t.n;
  double* part = terms[warp];
  // blockDim.x is a multiple of 32, so every unit below is a whole warp
  // and the full-mask ballots see all 32 lanes
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t rhs_units = static_cast<int64_t>(batch) * n;
  WarpClock clock(unit);
  if (unit < rhs_units) {  // rhs[b, c]: column c's entries times (W r + P r)
    const int b = static_cast<int>(unit / n);
    const int c = static_cast<int>(unit % n);
    const double* rb = r + static_cast<int64_t>(b) * t.m;
    double s = 0.0;
    const int q1 = t.col_ptr[c + 1];
    for (int q0 = t.col_ptr[c]; q0 < q1; q0 += kWarp) {
      const int q = q0 + lane;
      if (q < q1) {
        part[lane] = entry(t, v, t.col_ref[q], b) *
                     wr_of(t, w, off, rb, t.col_row[q]);
      }
      __syncwarp();
      if (lane == 0) {
        for (int x = 0; x < min(kWarp, q1 - q0); ++x) s += part[x];
      }
      __syncwarp();
    }
    if (lane == 0) rhs[static_cast<int64_t>(b) * n + c] = s;
    clock.done(1);
    return;
  }
  const int spans = ((n + kChunk - 1) / kChunk + kSpan - 1) / kSpan;
  if (unit - rhs_units >= rhs_units * spans) return;
  // a G row's span
  const int sp = static_cast<int>((unit - rhs_units) % spans);
  const int64_t bi = (unit - rhs_units) / spans;  // b n + i
  const int b = static_cast<int>(bi / n);
  const int i = static_cast<int>(bi % n);
  double* grow = g + bi * n;
  double* buf = chunk[warp];
  const int end = t.nz_ptr[i + 1];
  const int first = sp * kSpan * kChunk;
  const int last = min(n, first + kSpan * kChunk);
  int p = lower_bound(t.nz_col, t.nz_ptr[i], end, first);
  for (int c0 = first; c0 < last; c0 += kChunk) {
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
      if (c < n) store_pair<VEC>(grow, c, 0.0, 0.0);
      continue;
    }
    clock.enter();
    for (int k = lane; k < kChunk; k += kWarp) buf[k] = 0.0;
    __syncwarp();
    // the chunk's contributions [e0, e1) are consecutive: the lanes form
    // 32 of their products at a time, and the lane of each nonzero (at
    // most two a lane: a chunk has at most 64 columns) adds its own in the
    // table's order
    const int k0 = p + lane;
    const int k1 = k0 + kWarp;
    const int a0 = k0 < q ? t.c_ptr[k0] : 0;
    const int z0 = k0 < q ? t.c_ptr[k0 + 1] : 0;
    const int a1 = k1 < q ? t.c_ptr[k1] : 0;
    const int z1 = k1 < q ? t.c_ptr[k1 + 1] : 0;
    double s0 = 0.0;
    double s1 = 0.0;
    const int e1 = t.c_ptr[q];
    for (int e0 = t.c_ptr[p]; e0 < e1; e0 += kWarp) {
      const int e = e0 + lane;
      if (e < e1) {
        const double wt = weight(t, w, off, t.c_w[e]);
        part[lane] = wt * (entry(t, v, t.c_a[e], b) * entry(t, v, t.c_b[e], b));
      }
      __syncwarp();
      for (int x = max(a0, e0); x < min(z0, e0 + kWarp); ++x) {
        s0 += part[x - e0];
      }
      for (int x = max(a1, e0); x < min(z1, e0 + kWarp); ++x) {
        s1 += part[x - e0];
      }
      __syncwarp();
    }
    if (k0 < q) buf[t.nz_col[k0] - c0] = k0 == t.slack_nz ? s0 + 1.0 : s0;
    if (k1 < q) buf[t.nz_col[k1] - c0] = k1 == t.slack_nz ? s1 + 1.0 : s1;
    __syncwarp();
    clock.leave();
    if (c < n) store_pair<VEC>(grow, c, buf[VEC * lane], buf[VEC * lane + 1]);
    __syncwarp();
    p = q;
  }
  clock.done(0);
}

// The fleet regime's dynamic shared memory a block (bytes): a band's
// duplicate sums and nonzeros, or rhs's staging; gain_fill.py::_band_shared.
size_t fleet_shared(const GainTables* t) {
  const size_t band = static_cast<size_t>(t->band_dups) * kGroup +
                      static_cast<size_t>(t->band_nz) * kPad;
  const size_t rhs = static_cast<size_t>(kWarps) * kPad;
  return 8 * (band > rhs ? band : rhs);
}

template <class Kernel>
int set_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Launch K8 on `stream`: `vals` the raw entry values (in the pattern's
// order, masked) of scenario b at vals[ref se + b sb], `w` [m] and `off`
// [p] the weights, `r` [batch, m] the residuals; `g` [batch, n, n] and
// `rhs` [batch, n] are written whole. `fleet` picks the fleet regime.
// Returns a cudaError_t code.
extern "C" int gain_fill_launch(const GainTables* t, const double* vals,
                                long long se, long long sb, const double* w,
                                const double* off, const double* r, double* g,
                                double* rhs, int batch, int fleet,
                                void* stream) {
  if (t == nullptr || t->n <= 0 || t->m <= 0 || batch <= 0 ||
      (fleet && (t->band <= 0 || t->bdup_ptr == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Values v{vals, se, sb};
  const bool even = t->n % 2 == 0;  // 16-byte stores: every row on 16 bytes
  if (fleet) {
    const int64_t groups = (batch + kGroup - 1) / kGroup;
    const int64_t rhs_blocks = groups * ((t->n + kWarps - 1) / kWarps);
    const int64_t blocks =
        rhs_blocks + groups * ((t->n + t->band - 1) / t->band);
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    const size_t shared = fleet_shared(t);
    int err = even ? set_shared(gain_fleet_kernel<2>, shared)
                   : set_shared(gain_fleet_kernel<1>, shared);
    if (err != cudaSuccess) return err;
    if (even) {
      gain_fleet_kernel<2><<<static_cast<unsigned>(blocks), kThreads, shared,
                             s>>>(*t, v, w, off, r, g, rhs, batch,
                                  static_cast<int>(rhs_blocks));
    } else {
      gain_fleet_kernel<1><<<static_cast<unsigned>(blocks), kThreads, shared,
                             s>>>(*t, v, w, off, r, g, rhs, batch,
                                  static_cast<int>(rhs_blocks));
    }
    return cudaGetLastError();
  }
  // the rhs warps (a column each), then the G rows' spans' warps
  const int64_t chunks = (t->n + kWarp * (even ? 2 : 1) - 1) /
                         (kWarp * (even ? 2 : 1));
  const int64_t spans = (chunks + kSpan - 1) / kSpan;
  const int64_t warps = static_cast<int64_t>(batch) * t->n * (1 + spans);
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (even) {
    gain_fill_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, v, w, off, r, g, rhs, batch);
  } else {
    gain_fill_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, v, w, off, r, g, rhs, batch);
  }
  return cudaGetLastError();
}

#ifdef GAIN_FILL_TIMELINE
// Copy the first `blocks` blocks' stamps ([blocks][5]: the start, the ends
// of the three phases, the SM) of the last fleet launch to `out` (host).
extern "C" int gain_fill_timeline(unsigned long long* out, int blocks) {
  return cudaMemcpyFromSymbol(out, gain_fill_stamps,
                              sizeof(unsigned long long) * 5 *
                                  min(blocks, kStampBlocks));
}

// Copy the first `warps` warps' stamps of the last small-B launch
// ([warps][4]: start, ns forming and adding products, end, SM | kind << 16)
// to `out` (host).
extern "C" int gain_fill_warp_timeline(unsigned long long* out, int warps) {
  return cudaMemcpyFromSymbol(out, gain_fill_warp_stamps,
                              sizeof(unsigned long long) * 4 *
                                  min(warps, kStampWarps));
}
#endif

extern "C" const char* gain_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
