// K1 nr_fill: Newton-Raphson injections, mismatch and Jacobian fill.
//
// Replaces the jnp device routines of juliagrid_tpu/powerflow/ac.py:
// _injections (:92), _mismatch (:111) and _nr_jacobian (:125). There they
// are a gather, trig, two segment sums and eight dense scatters over the
// Y-bus entry list; here one launch does all of it for B >= 1 scenarios.
//
// The Jacobian is the Newton system's, at the unknowns' order N = npv +
// 2 npq, not the JAX package's 2n x 2n with the fixed rows and columns
// (the slack angle, non-PQ magnitudes) masked to identity (ac.py:158-161):
// a fixed variable's row and column only pad the system with an identity,
// and K2's LU at 2n did (2n / N)^3 = 2.2x the arithmetic at case118. The
// host builds the map pos[2n] once (powerflow/ac.py::newton_unknowns): the
// row and column of angle k is pos[k], of magnitude k pos[n + k], -1 where
// the variable is fixed; the unknowns keep the masked system's order.
//
// Mapping: one warp per (scenario, bus row). The Y entries are sorted by
// row (CSR, row_ptr), so a row is a contiguous range; its lanes stride over
// it 32 entries at a time. Each lane computes theta = theta_i - theta_j,
// t1 = Vi Vj (G cos + B sin) and t2 = Vi Vj (G sin - B cos) for its
// entries, keeps a partial sum of P and Q, and writes the entries' four
// off-diagonal partials of ac.py:137-148 at (pos[r or n + r], pos[c or n +
// c]), skipping each one whose row or column is -1. A warp shuffle sums P
// and Q; lane 0 writes P, Q, the masked mismatch (ac.py:116-119; its masks
// are k != slack and bus_type[k] == 1, the same fixed variables) and the
// four diagonal partials (ac.py:150-156) through the map the same way.
// (row, col) pairs are unique and the map is one to one, so every
// Jacobian element has one writer and no atomics are needed.
//
// Routed mode (nr_fill_routed_launch) replaces the BBD Jacobian routing of
// juliagrid_tpu/powerflow/newton_bbd.py: _quadrant_values (:253) and the
// four scatters with the family masks of _nr_bbd_step (:296-319). It shares
// the per-entry work and the row sums above (entry_terms, warp_sum2), but
// instead of indexing the dense Jacobian it writes each of an entry's
// four partials H, N, J, L (off[q * nnz + k], q = 0..3; a diagonal entry
// carries the bus's four diagonal terms) to a 64-bit offset into one flat
// buffer that holds a_ii | a_ib | a_bi | a_bb back to back. Offset -1 drops
// the value: a masked variable, or the structural zero of an out-of-service
// branch between two interiors. The host builds the offsets once and checks
// that every non-negative offset, and every position of the identity list
// `ones` (masked variables and padded interior slots), is unique, so again
// every element has one writer.
//
// Bound: with the Jacobian, the launcher zeroes B N^2 doubles first
// (cudaMemsetAsync), which is a write at full memory bandwidth and
// dominates at the main path's sizes (268 MB at case118 x1024, N = 181;
// about 2.6 GB for a 10k-bus grid); the fill itself writes at most 4 nnz
// scattered doubles. Without the Jacobian the launch reads about 24 bytes
// per entry and is bound by launch latency at these sizes. Offsets into
// the Jacobian are 64-bit: B N^2 passes 2^31 at 10k buses with B > 5. The routed mode likewise zero-fills its flat buffer
// (k (2ni)^2 + 2 k 2ni 2mbl + (2mb)^2 doubles, 1.2 GB on the 25k lattice at
// k = 16), which dominates it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

// Per-entry terms of a Y entry (i, j): Vi Vj, G cos + B sin and G sin - B cos
// of theta_i - theta_j.
struct EntryTerms {
  double vv, gc_bs, gs_bc;
};

__device__ __forceinline__ EntryTerms entry_terms(double vi, double ti,
                                                  double vj, double tj,
                                                  double g, double b) {
  double s, co;
  sincos(ti - tj, &s, &co);
  EntryTerms e;
  e.gc_bs = g * co + b * s;  // G cos + B sin
  e.gs_bc = g * s - b * co;  // G sin - B cos
  e.vv = vi * vj;
  return e;
}

// Sum a and b over the 32 lanes of a warp into lane 0.
__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

__global__ void __launch_bounds__(kThreads)
nr_fill_kernel(const int* __restrict__ row_ptr,
               const int* __restrict__ cols,
               const double* __restrict__ yg,
               const double* __restrict__ yb,
               const int* __restrict__ diag,
               const int* __restrict__ bus_type,
               int slack,
               const double* __restrict__ vm,
               const double* __restrict__ va,
               const double* __restrict__ p_sched,
               const double* __restrict__ q_sched,
               double* __restrict__ p,
               double* __restrict__ q,
               double* __restrict__ mp,
               double* __restrict__ mq,
               double* __restrict__ jac,
               const int* __restrict__ pos,
               int order, int n, int batch) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  // blockDim.x is a multiple of 32, so a warp leaves here as a whole and
  // the full-mask shuffles below see all 32 lanes.
  if (warp >= static_cast<int64_t>(n) * batch) return;
  const int b = static_cast<int>(warp / n);
  const int r = static_cast<int>(warp % n);

  const int64_t base = static_cast<int64_t>(b) * n;
  const double* vmb = vm + base;
  const double* vab = va + base;
  const double vi = vmb[r];
  const double ti = vab[r];
  const bool ang_r = r != slack;
  const bool mag_r = bus_type[r] == 1;

  // The rows of scenario b's Jacobian that this bus's equations fill:
  // dP_r at the angle's row, dQ_r at the magnitude's; null where fixed.
  double* jp = nullptr;
  double* jq = nullptr;
  int pa_r = -1;
  int pm_r = -1;
  if (jac != nullptr) {
    const int64_t nn = order;
    double* jb = jac + static_cast<int64_t>(b) * nn * nn;
    pa_r = pos[r];
    pm_r = pos[n + r];
    if (pa_r >= 0) jp = jb + pa_r * nn;
    if (pm_r >= 0) jq = jb + pm_r * nn;
  }
  const bool fill = jp != nullptr || jq != nullptr;

  double sp = 0.0;
  double sq = 0.0;
  const int end = row_ptr[r + 1];
  for (int k = row_ptr[r] + lane; k < end; k += kWarp) {
    const int c = cols[k];
    const double vj = vmb[c];
    const EntryTerms e = entry_terms(vi, ti, vj, vab[c], yg[k], yb[k]);
    sp += e.vv * e.gc_bs;
    sq += e.vv * e.gs_bc;
    if (fill && c != r) {
      const int pa_c = pos[c];
      const int pm_c = pos[n + c];
      if (jp != nullptr) {
        if (pa_c >= 0) jp[pa_c] = e.vv * e.gs_bc;       // dP/dtheta_j
        if (pm_c >= 0) jp[pm_c] = vi * e.gc_bs;         // dP/dV_j
      }
      if (jq != nullptr) {
        if (pa_c >= 0) jq[pa_c] = -e.vv * e.gc_bs;      // dQ/dtheta_j
        if (pm_c >= 0) jq[pm_c] = vi * e.gs_bc;         // dQ/dV_j
      }
    }
  }
  warp_sum2(sp, sq);
  if (lane != 0) return;

  const int64_t i = base + r;
  p[i] = sp;
  q[i] = sq;
  mp[i] = ang_r ? sp - p_sched[i] : 0.0;
  mq[i] = mag_r ? sq - q_sched[i] : 0.0;
  if (fill) {
    const double gii = yg[diag[r]];
    const double bii = yb[diag[r]];
    const double v2 = vi * vi;
    if (jp != nullptr) {
      jp[pa_r] = -sq - bii * v2;
      if (pm_r >= 0) jp[pm_r] = sp / vi + gii * vi;
    }
    if (jq != nullptr) {
      if (pa_r >= 0) jq[pa_r] = sp - gii * v2;
      jq[pm_r] = sq / vi - bii * vi;
    }
  }
}

__device__ __forceinline__ void put_routed(double* buf, int64_t off,
                                           double v) {
  if (off >= 0) buf[off] = v;
}

// Routed mode, one scenario: warp r fills bus row r. `off` is [4][nnz].
__global__ void __launch_bounds__(kThreads)
nr_fill_routed_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ cols,
                      const double* __restrict__ yg,
                      const double* __restrict__ yb,
                      const int* __restrict__ diag,
                      const int* __restrict__ bus_type,
                      int slack,
                      const double* __restrict__ vm,
                      const double* __restrict__ va,
                      const double* __restrict__ p_sched,
                      const double* __restrict__ q_sched,
                      double* __restrict__ p,
                      double* __restrict__ q,
                      double* __restrict__ mp,
                      double* __restrict__ mq,
                      const int64_t* __restrict__ off,
                      int64_t nnz,
                      double* __restrict__ buf,
                      int n) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= n) return;
  const int r = static_cast<int>(warp);
  const double vi = vm[r];
  const double ti = va[r];

  double sp = 0.0;
  double sq = 0.0;
  const int end = row_ptr[r + 1];
  for (int k = row_ptr[r] + lane; k < end; k += kWarp) {
    const int c = cols[k];
    const EntryTerms e = entry_terms(vi, ti, vm[c], va[c], yg[k], yb[k]);
    sp += e.vv * e.gc_bs;
    sq += e.vv * e.gs_bc;
    if (c != r) {
      put_routed(buf, off[k], e.vv * e.gs_bc);             // H
      put_routed(buf, off[nnz + k], vi * e.gc_bs);         // N
      put_routed(buf, off[2 * nnz + k], -e.vv * e.gc_bs);  // J
      put_routed(buf, off[3 * nnz + k], vi * e.gs_bc);     // L
    }
  }
  warp_sum2(sp, sq);
  if (lane != 0) return;

  p[r] = sp;
  q[r] = sq;
  mp[r] = r != slack ? sp - p_sched[r] : 0.0;
  mq[r] = bus_type[r] == 1 ? sq - q_sched[r] : 0.0;
  const int d = diag[r];
  const double gii = yg[d];
  const double bii = yb[d];
  const double v2 = vi * vi;
  put_routed(buf, off[d], -sq - bii * v2);
  put_routed(buf, off[nnz + d], sp / vi + gii * vi);
  put_routed(buf, off[2 * nnz + d], sp - gii * v2);
  put_routed(buf, off[3 * nnz + d], sq / vi - bii * vi);
}

__global__ void set_ones_kernel(const int64_t* __restrict__ pos,
                                int64_t count, double* __restrict__ buf) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t < count) buf[pos[t]] = 1.0;
}

}  // namespace

// Launch K1 on `stream`. All arrays are device pointers: the entry list
// (row_ptr[n + 1], cols/yg/yb[nnz]), diag/bus_type[n], and the row-major
// [batch, n] state, schedules and outputs. `jac` is a [batch, order,
// order] buffer, or null to skip the Jacobian; `pos` ([2n], the unknowns'
// rows, -1 where fixed) is read only with it. Returns a cudaError_t code.
extern "C" int nr_fill_launch(const int* row_ptr, const int* cols,
                              const double* yg, const double* yb,
                              const int* diag, const int* bus_type, int slack,
                              const double* vm, const double* va,
                              const double* p_sched, const double* q_sched,
                              double* p, double* q, double* mp, double* mq,
                              double* jac, const int* pos, int order, int n,
                              int batch, void* stream) {
  if (n <= 0 || batch <= 0 || order < 0) return cudaErrorInvalidValue;
  if (order == 0) jac = nullptr;
  if (jac != nullptr && pos == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac != nullptr) {
    const size_t bytes = static_cast<size_t>(batch) *
                         static_cast<size_t>(order) * order * sizeof(double);
    const cudaError_t err = cudaMemsetAsync(jac, 0, bytes, s);
    if (err != cudaSuccess) return err;
  }
  const int64_t threads = static_cast<int64_t>(n) * batch * kWarp;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  nr_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      row_ptr, cols, yg, yb, diag, bus_type, slack, vm, va, p_sched, q_sched,
      p, q, mp, mq, jac, pos, order, n, batch);
  return cudaGetLastError();
}

// Launch K1's routed mode for one state on `stream`: zero the flat buffer
// `buf` of `size` doubles, write 1.0 at the `n_ones` positions `ones`, then
// fill P, Q, the masked mismatch (each [n]) and the routed partials at the
// offsets `off` ([4][nnz], -1 = drop). Returns a cudaError_t code.
extern "C" int nr_fill_routed_launch(
    const int* row_ptr, const int* cols, const double* yg, const double* yb,
    const int* diag, const int* bus_type, int slack, const double* vm,
    const double* va, const double* p_sched, const double* q_sched,
    double* p, double* q, double* mp, double* mq, const int64_t* off,
    int64_t nnz, const int64_t* ones, int64_t n_ones, double* buf,
    int64_t size, int n, void* stream) {
  if (n <= 0 || nnz <= 0 || size <= 0 || n_ones < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      buf, 0, static_cast<size_t>(size) * sizeof(double), s);
  if (err != cudaSuccess) return err;
  if (n_ones > 0) {
    const int64_t blocks = (n_ones + kThreads - 1) / kThreads;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    set_ones_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        ones, n_ones, buf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t threads = static_cast<int64_t>(n) * kWarp;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  nr_fill_routed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      row_ptr, cols, yg, yb, diag, bus_type, slack, vm, va, p_sched, q_sched,
      p, q, mp, mq, off, nnz, buf, n);
  return cudaGetLastError();
}

extern "C" const char* nr_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
