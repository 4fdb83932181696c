// K4 gs_sweep: one Gauss-Seidel sweep and its mismatch maxima.
//
// Replaces the jnp device routines of juliagrid_tpu/powerflow/
// gauss_seidel.py: _gs_sweep (:97) and _gs_mismatch (:145). There a sweep is
// a lax.fori_loop over every bus with a lax.cond per bus, in plain torch it
// would be O(n) launches; here one launch does the sweep and the mismatch.
//
// What one launch computes, for one state of n buses:
//  - with `sweep` set, the PQ pass in ascending bus order
//    (I = S*/conj(V) - sum_j Y_ij V_j, then V_i += I / Y_ii), the PV pass
//    (the same with Q = Im(conj(V_i) I_i) from the current row current),
//    then the PV magnitudes reprojected to their setpoints vg;
//  - always, at the resulting state, max|dP| over PQ and PV buses and
//    max|dQ| over PQ buses, into a 2-element buffer, so that the host loop
//    reads back one pair per iteration.
//
// Mapping: one thread block. The voltage lives in dynamic shared memory
// (16 n bytes: 160 KB at 10,000 buses, under the 227 KB a block can take).
// Warp 0 walks the PQ list and then the PV list: its lanes split bus i's
// padded Y row (up to kSlots entries a lane), a shuffle sums the row
// current, lane 0 does the two complex divides and writes V_i, and
// __syncwarp() orders that write before the next bus reads it, which is
// the Gauss-Seidel order. The lanes load the next bus's row into registers
// before they work on the current one, so no step of the chain waits on
// device memory. Then every thread reprojects, writes V out, computes P and
// Q over its buses' padded rows and the block reduces the two maxima. Slack
// buses are never written.
//
// Bound: the length of the dependent chain, about n steps of a shared-memory
// gather, a five-step shuffle reduction and two complex divides, on one SM;
// bandwidth and flops are far from any limit, and the other SMs idle. That
// is inherent in Gauss-Seidel.
//
// Rounding: built with -fmad=false (kernels/_build.py), every product is
// rounded before it is added, and the complex divides associate as the
// plain version's _cdiv does, so a sweep differs from gs_sweep_ref only by
// the order in which the row current's terms are summed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSlots = 4;  // row entries per lane: rows of up to 128

struct Net {
  const int* nb;         // [n, width] padded neighbour table
  const double* yre;     // [n, width] Re(Y row), 0-padded
  const double* yim;     // [n, width]
  const double* dre;     // [n] Re(Y_ii)
  const double* dim;     // [n]
  const int* bus_type;   // [n] 1 PQ, 2 PV, 3 slack
  const double* p_sched; // [n]
  const double* q_sched; // [n]
  const double* vg;      // [n] PV magnitude setpoint
  int width;
};

// One lane's share of a bus row and the bus's scalars, loaded ahead of use.
struct Row {
  int bus;
  int nb[kSlots];
  double yr[kSlots];
  double yi[kSlots];
  double p, q, dr, di;
};

__device__ __forceinline__ void load_row(Row& r, const Net& net, int bus,
                                         int lane) {
  r.bus = bus;
  const int64_t base = static_cast<int64_t>(bus) * net.width;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int k = lane + s * kWarp;
    const bool in = k < net.width;
    r.nb[s] = in ? net.nb[base + k] : 0;
    r.yr[s] = in ? net.yre[base + k] : 0.0;
    r.yi[s] = in ? net.yim[base + k] : 0.0;
  }
  r.p = net.p_sched[bus];
  r.q = net.q_sched[bus];
  r.dr = net.dre[bus];
  r.di = net.dim[bus];
}

// (ar + j ai) / (br + j bi), associated as gauss_seidel.py's _cdiv.
__device__ __forceinline__ void cdiv(double ar, double ai, double br,
                                     double bi, double& cr, double& ci) {
  const double d = br * br + bi * bi;
  cr = (ar * br + ai * bi) / d;
  ci = (ai * br - ar * bi) / d;
}

// NaN-propagating maximum, as jnp.max and torch.amax.
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// Warp 0 walks `list` in order; `pv` selects the PV update.
__device__ void pass(const Net& net, const int* list, int count, bool pv,
                     double* vre, double* vim, int lane) {
  if (count == 0) return;
  Row cur, nxt;
  load_row(cur, net, list[0], lane);
  int ahead = count > 1 ? list[1] : list[0];
  for (int k = 0; k < count; ++k) {
    // the next bus's row and the index after it, in flight during this bus
    load_row(nxt, net, ahead, lane);
    ahead = k + 2 < count ? list[k + 2] : ahead;

    double sr = 0.0;
    double si = 0.0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (lane + s * kWarp < net.width) {
        const double vr = vre[cur.nb[s]];
        const double vi = vim[cur.nb[s]];
        sr += cur.yr[s] * vr - cur.yi[s] * vi;
        si += cur.yr[s] * vi + cur.yi[s] * vr;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      sr += __shfl_down_sync(0xffffffffu, sr, off);
      si += __shfl_down_sync(0xffffffffu, si, off);
    }
    if (lane == 0) {
      const int i = cur.bus;
      const double vr = vre[i];
      const double vi = vim[i];
      double cr, ci;
      if (pv) {
        const double q = vr * si - vi * sr;  // Q = Im(conj(V) I)
        cdiv(cur.p, q, vr, -vi, cr, ci);
      } else {
        cdiv(cur.p, -cur.q, vr, -vi, cr, ci);  // S* / conj(V)
      }
      double dr, di;
      cdiv(cr - sr, ci - si, cur.dr, cur.di, dr, di);
      vre[i] = vr + dr;
      vim[i] = vi + di;
    }
    __syncwarp();
    cur = nxt;
  }
}

__global__ void __launch_bounds__(kThreads)
gs_sweep_kernel(Net net, const int* __restrict__ pq, int npq,
                const int* __restrict__ pv, int npv, int n, int sweep,
                const double* __restrict__ vre_in,
                const double* __restrict__ vim_in,
                double* __restrict__ vre_out, double* __restrict__ vim_out,
                double* __restrict__ mismatch) {
  extern __shared__ double smem[];
  double* vre = smem;
  double* vim = smem + n;
  __shared__ double red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  for (int i = tid; i < n; i += kThreads) {
    vre[i] = vre_in[i];
    vim[i] = vim_in[i];
  }
  __syncthreads();

  if (sweep) {
    if (warp == 0) {
      pass(net, pq, npq, false, vre, vim, lane);
      pass(net, pv, npv, true, vre, vim, lane);
    }
    __syncthreads();
    // PV magnitude reprojection to the generator setpoint
    for (int k = tid; k < npv; k += kThreads) {
      const int i = pv[k];
      const double mag = sqrt(vre[i] * vre[i] + vim[i] * vim[i]);
      const double scale = net.vg[i] / mag;
      vre[i] = vre[i] * scale;
      vim[i] = vim[i] * scale;
    }
    __syncthreads();
  }

  double mp = 0.0;
  double mq = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    const double vr = vre[i];
    const double vi = vim[i];
    vre_out[i] = vr;
    vim_out[i] = vi;
    const int64_t base = static_cast<int64_t>(i) * net.width;
    double ir = 0.0;
    double ii = 0.0;
    for (int k = 0; k < net.width; ++k) {
      const int j = net.nb[base + k];
      const double yr = net.yre[base + k];
      const double yi = net.yim[base + k];
      ir += yr * vre[j] - yi * vim[j];
      ii += yr * vim[j] + yi * vre[j];
    }
    const int type = net.bus_type[i];
    if (type == 1 || type == 2) {
      const double p = vr * ir + vi * ii;
      mp = nanmax(fabs(p - net.p_sched[i]), mp);
    }
    if (type == 1) {
      const double q = vi * ir - vr * ii;
      mq = nanmax(fabs(q - net.q_sched[i]), mq);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    mp = nanmax(__shfl_down_sync(0xffffffffu, mp, off), mp);
    mq = nanmax(__shfl_down_sync(0xffffffffu, mq, off), mq);
  }
  if (lane == 0) {
    red[0][warp] = mp;
    red[1][warp] = mq;
  }
  __syncthreads();
  if (warp == 0) {
    mp = lane < kWarps ? red[0][lane] : 0.0;
    mq = lane < kWarps ? red[1][lane] : 0.0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      mp = nanmax(__shfl_down_sync(0xffffffffu, mp, off), mp);
      mq = nanmax(__shfl_down_sync(0xffffffffu, mq, off), mq);
    }
    if (lane == 0) {
      mismatch[0] = mp;
      mismatch[1] = mq;
    }
  }
}

// Shared memory a block of K4 can hold for the voltage on `device`, in
// bytes, or a negative cudaError_t code.
int64_t voltage_bytes(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gs_sweep_kernel);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  return static_cast<int64_t>(optin) -
         static_cast<int64_t>(attr.sharedSizeBytes);
}

}  // namespace

// The most buses K4 takes on `device` (its voltage fills shared memory), or
// 0 if the device cannot be queried.
extern "C" int gs_sweep_max_buses(int device) {
  const int64_t bytes = voltage_bytes(device);
  return bytes > 0 ? static_cast<int>(bytes / (2 * sizeof(double))) : 0;
}

// Launch K4 on `stream`. All arrays are device pointers: the padded table
// nb/yre/yim [n, width], the per-bus dre/dim/bus_type/p_sched/q_sched/vg
// [n], the ascending PQ and PV bus lists, the input state vre_in/vim_in
// [n], the output state [n] and the 2-element mismatch. Returns a
// cudaError_t code.
extern "C" int gs_sweep_launch(
    const int* nb, const double* yre, const double* yim, const double* dre,
    const double* dim, const int* bus_type, const double* p_sched,
    const double* q_sched, const double* vg, const int* pq, const int* pv,
    int n, int width, int npq, int npv, int sweep, const double* vre_in,
    const double* vim_in, double* vre_out, double* vim_out,
    double* mismatch, int device, void* stream) {
  if (n <= 0 || width <= 0 || width > kSlots * kWarp) {
    return cudaErrorInvalidValue;
  }
  const int64_t room = voltage_bytes(device);
  if (room < 0) return static_cast<int>(-room);
  const int64_t bytes = 2 * static_cast<int64_t>(n) * sizeof(double);
  if (bytes > room) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gs_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const Net net{nb, yre, yim, dre, dim, bus_type, p_sched, q_sched, vg,
                width};
  gs_sweep_kernel<<<1, kThreads, static_cast<size_t>(bytes),
                    static_cast<cudaStream_t>(stream)>>>(
      net, pq, npq, pv, npv, n, sweep, vre_in, vim_in, vre_out, vim_out,
      mismatch);
  return cudaGetLastError();
}

extern "C" const char* gs_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
