// K4 gs_sweep: a whole Gauss-Seidel solve, level by level, in one
// thread-block cluster.
//
// Replaces the jnp device routines of juliagrid_tpu/powerflow/
// gauss_seidel.py: _gs_sweep (:97), _gs_mismatch (:145) and the
// lax.while_loop of _gs_solve (:167-187). There a sweep is a lax.fori_loop
// over every bus with a lax.cond per bus; here one launch runs the loop.
//
// What one launch computes, for one state of n buses: the mismatch maxima
// (max|dP| over PQ and PV buses, max|dQ| over PQ buses), then, while not
// (both < tol) and fewer than max_sweeps sweeps are done, a sweep and the
// maxima again. NaN never counts as converged, as in jnp. A sweep is the PQ
// pass (I = S*/conj(V) - sum_j Y_ij V_j, then V_i += I / Y_ii), the PV pass
// (the same with Q = Im(conj(V_i) I_i) from the row current) and the PV
// magnitudes reprojected to their setpoints vg. Outputs: the state, and
// info = [max|dP|, max|dQ|, sweeps done, converged].
//
// Levels: PQ bus i reads the new values of its PQ neighbours j < i only
// (PV buses likewise), so with level(i) = 1 + max level(j) over those
// neighbours in the Y pattern, zero entries of branches out of service
// included (gauss_seidel.level_schedule, on the host), no two buses of a
// level are adjacent and sweeping level by level computes the sequential
// sweep: the PQ levels, then the PV levels, then the reprojection. The
// padding behind a row's entries (a zero admittance pointing at bus 0) is
// read without an order: it adds a zero for any finite V_0, but a V_0 that
// turns inf or NaN in the level a padded row is summed in may reach that
// row one sweep later than in the sequential sweep.
//
// Mapping: one cluster of C <= 16 blocks of 512 threads. The voltage lives
// in the cluster's shared memory as (re, im) pairs, either replicated (every
// block holds all n buses, reads locally, and an update is stored to every
// copy, lane r to block r's) or distributed (block r holds the buses
// [r chunk, (r + 1) chunk) and a read goes to the owner through distributed
// shared memory). Each level's buses go to the cluster's warps, one warp a
// bus, striding when the level is wider. The lanes split the padded Y row,
// lane l summing entries l, l + 32, l + 64, ... (the first four from
// registers, loaded while the warp worked on its previous bus, or inside the
// previous level's barrier), a shuffle tree sums the lanes, and lane 0 does
// the two complex divides and writes V_i. A cluster barrier ends each level;
// the next level's rows load between its arrive and its wait, since a
// release arrive would first wait for loads still in flight.
// The mismatch maxima run over each block's chunk of buses and meet through
// distributed shared memory, so every block reads the same maxima and takes
// the same decision to go on.
//
// Bound: the dependent chain, about (PQ + PV levels) x (a shared-memory
// gather, a five-step shuffle, two complex divides, a cluster barrier) per
// sweep; bytes and flops are far from any limit.
//
// Rounding: built with -fmad=false (kernels/_build.py), every product is
// rounded before it is added, and the complex divides associate as the
// plain version's _cdiv does, so a sweep differs from gs_sweep_ref only by
// the order in which a row current's terms are summed. Which warp or block
// updates a bus changes no bit, so any cluster size, either layout and any
// split of the sweeps into launches give the same state.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSlots = 4;  // row entries per lane held ahead of use
constexpr int kMaxCluster = 16;
// returned when the cluster cannot be placed on the device
constexpr int kClusterUnplaceable = -1;

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
  int n;
  int width;
};

// The level schedule: the PQ buses by (level, index) and their level
// offsets, then the same for the PV buses.
struct Schedule {
  const int* pq_order;  // [npq]
  const int* pq_ptr;    // [lpq + 1]
  const int* pv_order;  // [npv]
  const int* pv_ptr;    // [lpv + 1]
  int npq, npv, lpq, lpv;
};

// The voltage in the cluster's shared memory.
template <bool kReplicated>
struct Voltage {
  double2* v;  // this block's array: n pairs, or its chunk
  int chunk;   // buses a block owns

  __device__ double2 load(const cg::cluster_group& cluster, int j) const {
    if (kReplicated) return v[j];
    const int r = j / chunk;
    return cluster.map_shared_rank(v, r)[j - r * chunk];
  }
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

// The bus of item k of the combined schedule (the PQ order, then the PV
// order).
__device__ __forceinline__ int item_bus(const Schedule& s, int k) {
  return k < s.npq ? s.pq_order[k] : s.pv_order[k - s.npq];
}

// Loads into r the row of this warp's first bus of level l, if it has one.
__device__ __forceinline__ void first_row(Row& r, const Net& net,
                                          const Schedule& s, const int* lev,
                                          int nlev, int l, int gwarp,
                                          int lane) {
  if (l < nlev && lev[l] + gwarp < lev[l + 1]) {
    load_row(r, net, item_bus(s, lev[l] + gwarp), lane);
  }
}

// The two halves of cluster.sync(): this thread's earlier writes are
// visible to the cluster after the release arrive, and the acquire wait
// returns once every thread of the cluster has arrived.
__device__ __forceinline__ void arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The Gauss-Seidel update of the bus of `cur` by one warp.
template <bool kReplicated>
__device__ void update_bus(const Net& net, const Row& cur, bool pv,
                           const Voltage<kReplicated>& volt,
                           const cg::cluster_group& cluster, int csize,
                           int lane) {
  double sr = 0.0;
  double si = 0.0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (lane + s * kWarp < net.width) {
      const double2 v = volt.load(cluster, cur.nb[s]);
      sr += cur.yr[s] * v.x - cur.yi[s] * v.y;
      si += cur.yr[s] * v.y + cur.yi[s] * v.x;
    }
  }
  // rows wider than kSlots chunks: the further chunks of 32 entries
  const int64_t base = static_cast<int64_t>(cur.bus) * net.width;
  for (int k = lane + kSlots * kWarp; k < net.width; k += kWarp) {
    const double2 v = volt.load(cluster, net.nb[base + k]);
    const double yr = net.yre[base + k];
    const double yi = net.yim[base + k];
    sr += yr * v.x - yi * v.y;
    si += yr * v.y + yi * v.x;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    sr += __shfl_down_sync(0xffffffffu, sr, off);
    si += __shfl_down_sync(0xffffffffu, si, off);
  }
  double nr = 0.0;
  double ni = 0.0;
  if (lane == 0) {
    const double2 v = volt.load(cluster, cur.bus);
    double cr, ci;
    if (pv) {
      const double q = v.x * si - v.y * sr;  // Q = Im(conj(V) I)
      cdiv(cur.p, q, v.x, -v.y, cr, ci);
    } else {
      cdiv(cur.p, -cur.q, v.x, -v.y, cr, ci);  // S* / conj(V)
    }
    double dr, di;
    cdiv(cr - sr, ci - si, cur.dr, cur.di, dr, di);
    nr = v.x + dr;
    ni = v.y + di;
  }
  if (kReplicated) {
    nr = __shfl_sync(0xffffffffu, nr, 0);
    ni = __shfl_sync(0xffffffffu, ni, 0);
    if (lane < csize) {
      cluster.map_shared_rank(volt.v, lane)[cur.bus] = make_double2(nr, ni);
    }
  } else if (lane == 0) {
    const int r = cur.bus / volt.chunk;
    cluster.map_shared_rank(volt.v, r)[cur.bus - r * volt.chunk] =
        make_double2(nr, ni);
  }
}

// One sweep's PQ and PV levels. `lev` holds the nlev + 1 level offsets of
// the combined schedule.
template <bool kReplicated>
__device__ void sweep_levels(const Net& net, const Schedule& s,
                             const int* lev, int nlev,
                             const Voltage<kReplicated>& volt,
                             const cg::cluster_group& cluster, int csize,
                             int gwarp, int nwarps, int lane) {
  Row cur;
  first_row(cur, net, s, lev, nlev, 0, gwarp, lane);
  for (int l = 0; l < nlev; ++l) {
    const bool pv = l >= s.lpq;
    const int end = lev[l + 1];
    for (int k = lev[l] + gwarp; k < end; k += nwarps) {
      if (k + nwarps < end) {
        // the warp's next row of this level, in flight during this bus
        Row nxt;
        load_row(nxt, net, item_bus(s, k + nwarps), lane);
        update_bus(net, cur, pv, volt, cluster, csize, lane);
        cur = nxt;
      } else {
        update_bus(net, cur, pv, volt, cluster, csize, lane);
      }
    }
    // cluster.sync() in two halves, the next level's first row loaded
    // between them: a release arrive waits for the loads issued before it
    arrive_release();
    first_row(cur, net, s, lev, nlev, l + 1, gwarp, lane);
    wait_acquire();
  }
}

// The mismatch maxima over the whole grid, the same in every block. Each
// block takes its chunk [lo, hi); `part` (double-buffered by `round`) and
// `red`, `tot` are this block's shared scratch.
template <bool kReplicated>
__device__ void mismatch(const Net& net, const Voltage<kReplicated>& volt,
                         const cg::cluster_group& cluster, int csize, int lo,
                         int hi, int round, double (*part)[2],
                         double (*red)[kWarps], double* tot, double& del_p,
                         double& del_q) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  double mp = 0.0;
  double mq = 0.0;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const double2 v = volt.load(cluster, i);
    const int64_t base = static_cast<int64_t>(i) * net.width;
    double ir = 0.0;
    double ii = 0.0;
    for (int k = 0; k < net.width; ++k) {
      const double2 vj = volt.load(cluster, net.nb[base + k]);
      const double yr = net.yre[base + k];
      const double yi = net.yim[base + k];
      ir += yr * vj.x - yi * vj.y;
      ii += yr * vj.y + yi * vj.x;
    }
    const int type = net.bus_type[i];
    if (type == 1 || type == 2) {
      const double p = v.x * ir + v.y * ii;
      mp = nanmax(fabs(p - net.p_sched[i]), mp);
    }
    if (type == 1) {
      const double q = v.y * ir - v.x * ii;
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
  double* mine = part[round & 1];
  if (warp == 0) {
    mp = lane < kWarps ? red[0][lane] : 0.0;
    mq = lane < kWarps ? red[1][lane] : 0.0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      mp = nanmax(__shfl_down_sync(0xffffffffu, mp, off), mp);
      mq = nanmax(__shfl_down_sync(0xffffffffu, mq, off), mq);
    }
    if (lane == 0) {
      mine[0] = mp;
      mine[1] = mq;
    }
  }
  cluster.sync();
  if (warp == 0) {
    mp = 0.0;
    mq = 0.0;
    if (lane < csize) {
      const double* theirs = cluster.map_shared_rank(mine, lane);
      mp = theirs[0];
      mq = theirs[1];
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      mp = nanmax(__shfl_down_sync(0xffffffffu, mp, off), mp);
      mq = nanmax(__shfl_down_sync(0xffffffffu, mq, off), mq);
    }
    if (lane == 0) {
      tot[0] = mp;
      tot[1] = mq;
    }
  }
  __syncthreads();
  del_p = tot[0];
  del_q = tot[1];
}

template <bool kReplicated>
__global__ void __launch_bounds__(kThreads, 1)
gs_solve_kernel(Net net, Schedule s, int chunk, int max_sweeps, double tol,
                const double* __restrict__ vre_in,
                const double* __restrict__ vim_in,
                double* __restrict__ vre_out, double* __restrict__ vim_out,
                double* __restrict__ info) {
  extern __shared__ double2 smem[];
  __shared__ double part[2][2];
  __shared__ double red[2][kWarps];
  __shared__ double tot[2];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int gwarp = rank * kWarps + tid / kWarp;
  const int nwarps = csize * kWarps;
  const int n = net.n;
  const int lo = rank * chunk;
  const int hi = min(n, lo + chunk);

  const Voltage<kReplicated> volt{smem, chunk};
  int* lev = reinterpret_cast<int*>(smem + (kReplicated ? n : chunk));
  const int nlev = s.lpq + s.lpv;
  for (int l = tid; l <= nlev; l += kThreads) {
    lev[l] = l <= s.lpq ? s.pq_ptr[l] : s.npq + s.pv_ptr[l - s.lpq];
  }
  if (kReplicated) {
    for (int i = tid; i < n; i += kThreads) {
      smem[i] = make_double2(vre_in[i], vim_in[i]);
    }
  } else {
    for (int i = lo + tid; i < hi; i += kThreads) {
      smem[i - lo] = make_double2(vre_in[i], vim_in[i]);
    }
  }
  // every copy is loaded before any block stores into another's
  cluster.sync();

  int round = 0;
  double del_p, del_q;
  mismatch(net, volt, cluster, csize, lo, hi, round++, part, red, tot, del_p,
           del_q);
  int it = 0;
  while (!(del_p < tol && del_q < tol) && it < max_sweeps) {
    sweep_levels(net, s, lev, nlev, volt, cluster, csize, gwarp, nwarps,
                 lane);
    // PV magnitude reprojection to the generator setpoint: on every copy by
    // its own block, or by the owner
    for (int k = tid; k < s.npv; k += kThreads) {
      const int i = s.pv_order[k];
      const int r = kReplicated ? 0 : i / chunk;
      if (!kReplicated && r != rank) continue;
      double2& v = smem[i - r * chunk];
      const double mag = sqrt(v.x * v.x + v.y * v.y);
      const double scale = net.vg[i] / mag;
      v = make_double2(v.x * scale, v.y * scale);
    }
    if (kReplicated) {
      __syncthreads();
    } else {
      cluster.sync();
    }
    mismatch(net, volt, cluster, csize, lo, hi, round++, part, red, tot,
             del_p, del_q);
    ++it;
  }

  for (int i = lo + tid; i < hi; i += kThreads) {
    const double2 v = smem[kReplicated ? i : i - lo];
    vre_out[i] = v.x;
    vim_out[i] = v.y;
  }
  if (rank == 0 && tid == 0) {
    info[0] = del_p;
    info[1] = del_q;
    info[2] = it;
    info[3] = (del_p < tol && del_q < tol) ? 1.0 : 0.0;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

using Kernel = void (*)(Net, Schedule, int, int, double, const double*,
                        const double*, double*, double*, double*);

// What a device was found to take, so that a launch queries and sets it
// once: the dynamic shared memory a block can take (0 until known), whether
// each layout's kernel is set up for it, and for each layout and cluster
// size the most shared memory a block was found to place with.
constexpr int kMaxDevices = 64;
struct DeviceCache {
  int64_t room;
  bool ready[2];
  int64_t placed[2][kMaxCluster + 1];
};
DeviceCache cache[kMaxDevices];

// Dynamic shared memory a block of K4 can take on `device`, in bytes, or a
// negative cudaError_t code.
int64_t room(int device) {
  if (device < 0 || device >= kMaxDevices) return -cudaErrorInvalidDevice;
  if (cache[device].room > 0) return cache[device].room;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  const Kernel kernels[] = {gs_solve_kernel<true>, gs_solve_kernel<false>};
  int64_t most = optin;
  for (const Kernel fn : kernels) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return -static_cast<int64_t>(err);
    most = std::min<int64_t>(most, optin - attr.sharedSizeBytes);
  }
  cache[device].room = most;
  return most;
}

template <bool kReplicated>
int launch(const Net& net, const Schedule& s, int cluster, int chunk,
           int64_t bytes, int max_sweeps, double tol, const double* vre_in,
           const double* vim_in, double* vre_out, double* vim_out,
           double* info, int device, cudaStream_t stream) {
  const Kernel kernel = gs_solve_kernel<kReplicated>;
  DeviceCache& dev = cache[device];
  if (!dev.ready[kReplicated]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dev.room));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    dev.ready[kReplicated] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int64_t& placed = dev.placed[kReplicated][cluster];
  if (bytes > placed) {
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return kClusterUnplaceable;
    placed = bytes;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, net, s, chunk, max_sweeps, tol,
                         vre_in, vim_in, vre_out, vim_out, info);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// Dynamic shared memory a block of K4 can take on `device`, in bytes (the
// voltage and the level offsets must fit it), or 0 if the device cannot be
// queried.
extern "C" int64_t gs_sweep_room(int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return 0;
  const int64_t bytes = room(device);
  return bytes > 0 ? bytes : 0;
}

// Launch K4 on `stream` of `device` as one cluster of `cluster` blocks, the
// voltage replicated in every block or (distributed != 0) split into chunks
// of ceil(n / cluster) buses. All arrays are device pointers: the padded table
// nb/yre/yim [n, width], the per-bus dre/dim/bus_type/p_sched/q_sched/vg
// [n], the schedule pq_order [npq], pq_ptr [lpq + 1], pv_order [npv],
// pv_ptr [lpv + 1], the input state vre_in/vim_in [n], the output state [n]
// and the 4-element info. Returns a cudaError_t code, or -1 when the
// cluster cannot be placed on the device.
extern "C" int gs_sweep_launch(
    const int* nb, const double* yre, const double* yim, const double* dre,
    const double* dim, const int* bus_type, const double* p_sched,
    const double* q_sched, const double* vg, const int* pq_order,
    const int* pq_ptr, const int* pv_order, const int* pv_ptr, int n,
    int width, int npq, int npv, int lpq, int lpv, int cluster,
    int distributed, int max_sweeps, double tol, const double* vre_in,
    const double* vim_in, double* vre_out, double* vim_out, double* info,
    int device, void* stream) {
  if (n <= 0 || width <= 0 || cluster < 1 || cluster > kMaxCluster ||
      max_sweeps < 0) {
    return cudaErrorInvalidValue;
  }
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const int64_t avail = room(device);
  if (avail < 0) return static_cast<int>(-avail);
  const int chunk = (n + cluster - 1) / cluster;
  const int64_t held = distributed ? chunk : n;
  const int64_t bytes = held * static_cast<int64_t>(sizeof(double2)) +
                        static_cast<int64_t>(lpq + lpv + 1) * sizeof(int);
  if (bytes > avail) return cudaErrorInvalidValue;
  const Net net{nb, yre, yim, dre, dim, bus_type, p_sched, q_sched, vg, n,
                width};
  const Schedule s{pq_order, pq_ptr, pv_order, pv_ptr, npq, npv, lpq, lpv};
  auto st = static_cast<cudaStream_t>(stream);
  if (distributed) {
    return launch<false>(net, s, cluster, chunk, bytes, max_sweeps, tol,
                         vre_in, vim_in, vre_out, vim_out, info, device, st);
  }
  return launch<true>(net, s, cluster, chunk, bytes, max_sweeps, tol, vre_in,
                      vim_in, vre_out, vim_out, info, device, st);
}

extern "C" const char* gs_sweep_error_string(int code) {
  if (code == kClusterUnplaceable) {
    return "the thread-block cluster cannot be placed on this device";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
