// K6 opf_fill: the AC optimal power flow's constraint Jacobians and the
// Lagrangian Hessian, dense, at one point.
//
// Replaces the jnp device routines of juliagrid_tpu/opf/acopf.py: jac_eq
// (:693), jac_ineq with _flow_grads (:748-800) and hess with _flow_row_val
// (:802-921). There they are about forty scatter-adds into zeroed dense
// matrices (.at[].add/set), the flow rows' partials from vmapped
// jax.grad/jax.hessian; here one launch fills either [J_E; J_I] (Jacobian
// mode, m_E + m_I rows) or H (Hessian mode, n_x rows), n_x columns each,
// row-major f64, zeros included. The two modes are two kernels.
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
// Jacobian mode (opf_jac_kernel). A thread block owns 1-8 units of one
// kind (buses, or single rows of the tail), about 16 KB of output: its
// threads zero the units' rows with 16-byte stores, and after a barrier one
// warp fills each unit into lines still in L2. A bus: the warp walks the
// bus's Y-bus row 32 entries at a time; each lane writes its entry's four
// off-diagonal partials (dP/dtheta_j, dP/dV_j, dQ/dtheta_j, dQ/dV_j,
// negated: c_E = supply - injection - demand) and adds t1, t2 to the bus's
// P and Q; a shuffle sums them, and lane 0 writes the four diagonal
// partials and the generators' +1s. A tail row: lane 0 writes its one to
// four entries.
//
// Hessian mode (opf_hess_kernel). Every output element is written once,
// and no block waits on another: the blocks of the first wave that store
// rows only hold back kHoldNs, while the value groups' loads meet an idle
// memory system. The host's plan (opf_fill.py::hess_units, hess_groups,
// hess_blocks) gives three kinds of blocks, in this order:
// - value groups, few enough to start in the first wave with the tail
//   units: runs of consecutive bus units (hess_group) whose values the
//   block computes and stores where item_at says (the elements (theta_k |
//   V_k, theta_j | V_j) of each pair slot and the four diagonal ones of
//   each bus), with the tail units spread evenly among them: `row_units`
//   rows of 2n.., each with one value, the cost's second derivative, which
//   the block stores with its rows' zeros;
// - bus units: `bus_units` buses, whose rows k.. and n + k.. the block
//   stores, zeros only, around the elements the value groups store.
// A value group, all threads of its block taking part, in shared memory
// (the scratch past the rooms below):
// 1. a thread per flow entry (the flow rows of the buses' pair lists, a
//    contiguous range of pair_flow, each with its own copy of its row's
//    descriptor) forms the row's point (flow_point), its ends and its
//    weight w = z_upper - z_lower; beside them a thread per pair slot (the
//    buses j bus k shares a Y-bus entry, either way, or a flow row with,
//    itself included) sums the terms of the entry (k, j) weighted by the
//    duals y of bus k and of the entry (j, k) by those of bus j into the
//    slot's four off-diagonal elements and its share of bus k's four
//    diagonal ones; the diagonal Y-bus entry (slot (k, k)) gives the V_k^2
//    term;
// 2. a thread per (entry, k, l) the second derivative over (u_k, u_l);
// 3. a thread per (entry, a, b) the weighted element w H_z[a, b] of the
//    rows at the slot's bus;
// 4. a thread per slot adds its flow entries' elements in order and
//    stores its four;
// 5. a thread per (bus, diagonal element) adds the bus's slots' shares one
//    after another in slot order and stores the sum.
// A block that stores rows does so window by window (at most `window`
// doubles, cut at multiples of it): a bitmap in shared memory marks the
// elements the value groups store, and each thread stores its chunks of
// two elements with a 16-byte store of zeros, or an 8-byte one beside a
// marked element.
// The host check (opf_fill.py::check_fill_table) makes every Y-bus row and
// pair list name a column once, lists every entry and flow row once at
// each end, puts every item at its own element and holds the plan's
// windows to covering every element once: one writer per element, no
// atomics in a sum, and every sum in a fixed order, so the result does
// not depend on scheduling.
//
// Flow rows. The value of a flow row is, by class, P (1), sqrt(S^2) (2),
// S^2 (3), sqrt(I^2) (4) or I^2 (5) of one end, from the rectangular
// voltages u = (Vf cos thf, Vf sin thf, Vt cos tht, Vt sin tht): the
// current I = (ire, iim) is linear in u, P and Q are quadratic. The closed
// forms (in opf_terms.cuh, shared with K7's kkt_fill.cu, as is entry_terms)
// give the value's derivatives over u and take them to z = (thf, tht, Vf,
// Vt) by the chain rule: g_z = J^T g_u and H_z = J^T H_u J + sum_u g_u
// d^2u/dz^2, J = du/dz. The sqrt rows clamp S^2 or I^2 at 1e-24 as the
// plain version's maximum does: below the clamp the derivatives are 0, at
// a tie they carry the weight 1/2 (first order) and 1/4 (the outer-product
// term of the second), as JAX's and PyTorch's maximum give them.
//
// Rounding: built with -fmad=false (_build.SOURCE_FLAGS), so each product
// and sum rounds on its own as the plain version's op-by-op kernels do;
// the sums' order and the flow rows' closed forms differ from the plain
// version's scatter order and autodiff, by a few ulps of the terms.
//
// Bound: the output is written once, (m_E + m_I) n_x or n_x^2 doubles:
// at case1354pegase (n_x = 3,228) 240.6 MB for the Jacobians, 83.4 MB for
// H, about 0.072 and 0.025 ms at 3.35 TB/s; the values are a few per Y-bus
// entry and flow row inside that. Offsets into the output are 64-bit. The
// Hessian kernel is bounded to 64 registers a thread and about 30 KB of
// shared memory a block: seven 128-thread blocks an SM, 924 on an H100.

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
  const int* pair_flow;   // [n_pf] flow rows of each pair
  const int* pf_idx;      // [6, n_pf] fl_idx of each pair_flow entry
  const double* pf_y;     // [4, n_pf] fl_y of each pair_flow entry
  const int* hess_group;  // [6, groups] k0, k1, s0, s1, q0, q1 of each
  //                         value group of the Hessian mode
  const int* unit_group;  // [bus units] the value group of each bus unit
  const long long* item_at;  // [4 n_pair + 4 n] the element of H of each
  //                            slot's and bus's items (-1: none)
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
  int n_pf;
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kUnitsPerBlock = kThreads / kWarp;
// the output a Jacobian-mode thread block zeroes before its warps fill it:
// small enough that the lines its values land in are still in L2 when they
// come
constexpr int64_t kRegion = 16 * 1024;
constexpr int kLinear = 0;
// The Hessian mode: 128-thread blocks, eight an SM by registers (64 a
// thread). A value group keeps its flow entries and pair slots in shared
// memory when they fit the rooms below, else in the scratch in device
// memory; a bus unit takes its items' elements into shared memory when
// they fit kItemRoom; every block that stores rows does so in windows of
// at most kWindow doubles, each with a bitmap of its marked elements. A
// tail unit is at most kTailRoom rows.
constexpr int kHessThreads = 128;
constexpr int kHessBlocksPerSm = 8;
constexpr int kWindow = 8192;
constexpr int kWords = kWindow / 32;
constexpr int kFlowRoom = 48;
constexpr int kSlotRoom = 40;
constexpr int kBusRoom = 32;
constexpr int kItemRoom = 96;
constexpr int kTailRoom = 64;
// how long a block of the first wave that stores rows holds its stores
// back, so that the value groups' chains of loads meet an idle memory
// system (every load of such a chain waits behind the stores otherwise)
constexpr unsigned long long kHoldNs = 2500;

// Fields of a flow entry (as doubles): its point, weight, admittances,
// class, end and buses, the bus of its slot, its gradient over u, its
// second derivatives over u, and w H_z (the rows of the slot's bus).
constexpr int kFU = 0;      // u[4]
constexpr int kFTrig = 4;   // cf, sf, ct, st
constexpr int kFCur = 8;    // ire, iim, pp, qq
constexpr int kFInv = 12;   // inv, inv3
constexpr int kFW = 14;     // w = z_upper - z_lower
constexpr int kFY = 15;     // gf, bf, gt, bt
constexpr int kFCls = 19;
constexpr int kFR = 20;
constexpr int kFFb = 21;
constexpr int kFTb = 22;
constexpr int kFBus = 23;
constexpr int kFGu = 24;    // gu[4]
constexpr int kFHu = 28;    // d^2 value/du^2 [16]
constexpr int kFWhz = 44;   // w H_z [16]
constexpr int kFlowFields = 60;
// Fields of a pair slot: j, its bus k, its flow entries [qa, qb), its four
// off-diagonal elements and its four shares of the diagonal.
constexpr int kSJ = 0;
constexpr int kSBus = 1;
constexpr int kSQa = 2;
constexpr int kSQb = 3;
constexpr int kSOff = 4;
constexpr int kSDiag = 8;
constexpr int kSlotFields = 12;

using opf_terms::EntryTerms;
using opf_terms::entry_terms;
using opf_terms::FlowPoint;

// The flow rows' tables of `t`, as the shared closed forms read them.
__device__ __forceinline__ opf_terms::FlowRows flow_rows(
    const OpfTables& t) {
  return opf_terms::FlowRows{t.fl_idx, t.fl_y, t.n_fl, t.n};
}

// Units of `doubles` output elements a Jacobian-mode thread block owns.
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

// ---- Jacobian mode --------------------------------------------------------

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

// Blocks [0, bus_blocks) own `bus_units` buses each, the rest `row_units`
// rows of 2n..rows. `zero` is 0 when the caller has zeroed the output.
__global__ void __launch_bounds__(kThreads)
opf_jac_kernel(OpfTables t, const double* __restrict__ x,
               double* __restrict__ out, int zero, int rows,
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
    jac_bus(t, x, out, first + w, lane);
    return;
  }
  const int first =
      2 * n + (static_cast<int>(blockIdx.x) - bus_blocks) * row_units;
  const int count = min(row_units, rows - first);
  if (zero) zero_span(out + first * nx, count * nx);
  __syncthreads();
  if (w >= count || lane != 0) return;
  jac_row(t, x, out, first + w);
}

// ---- Hessian mode ---------------------------------------------------------

// Where a value block keeps its flow entries and slots: shared memory, or
// the scratch (field f of item i at base[f * stride + i - offset]).
struct View {
  double* fl;
  int64_t fstr;
  int foff;
  double* sl;
  int64_t sstr;
  int soff;
};

__device__ __forceinline__ double& fld(const View& v, int f, int q) {
  return v.fl[f * v.fstr + (q - v.foff)];
}
__device__ __forceinline__ double& sfld(const View& v, int f, int s) {
  return v.sl[f * v.sstr + (s - v.soff)];
}

// The point of flow entry q, as pass 1 left it (all of it, or only u and
// the angles' cosines and sines, which H_z's chain rule reads).
__device__ __forceinline__ FlowPoint load_point(const View& v, int q,
                                                bool full) {
  FlowPoint p;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.u[k] = fld(v, kFU + k, q);
  p.cf = fld(v, kFTrig, q);
  p.sf = fld(v, kFTrig + 1, q);
  p.ct = fld(v, kFTrig + 2, q);
  p.st = fld(v, kFTrig + 3, q);
  if (!full) return p;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.y[k] = fld(v, kFY + k, q);
  p.ire = fld(v, kFCur, q);
  p.iim = fld(v, kFCur + 1, q);
  p.pp = fld(v, kFCur + 2, q);
  p.qq = fld(v, kFCur + 3, q);
  p.inv = fld(v, kFInv, q);
  p.inv3 = fld(v, kFInv + 1, q);
  p.cls = static_cast<int>(fld(v, kFCls, q));
  p.r = static_cast<int>(fld(v, kFR, q));
  return p;
}

// Pass 1 of a flow entry: its point, ends and weight (from the entry's
// own copy of its flow row's descriptor, pf_idx and pf_y).
__device__ void flow_entry_point(const OpfTables& t,
                                 const double* __restrict__ x,
                                 const double* __restrict__ z, const View& v,
                                 int q) {
  const opf_terms::FlowRows rows{t.pf_idx, t.pf_y, t.n_pf, t.n};
  FlowPoint p;
  opf_terms::flow_point(rows, x, q, p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fld(v, kFU + k, q) = p.u[k];
    fld(v, kFY + k, q) = p.y[k];
  }
  fld(v, kFTrig, q) = p.cf;
  fld(v, kFTrig + 1, q) = p.sf;
  fld(v, kFTrig + 2, q) = p.ct;
  fld(v, kFTrig + 3, q) = p.st;
  fld(v, kFCur, q) = p.ire;
  fld(v, kFCur + 1, q) = p.iim;
  fld(v, kFCur + 2, q) = p.pp;
  fld(v, kFCur + 3, q) = p.qq;
  fld(v, kFInv, q) = p.inv;
  fld(v, kFInv + 1, q) = p.inv3;
  fld(v, kFCls, q) = p.cls;
  fld(v, kFR, q) = p.r;
  const int nf = t.n_pf;
  fld(v, kFFb, q) = t.pf_idx[q];
  fld(v, kFTb, q) = t.pf_idx[nf + q];
  const int lo = t.pf_idx[4 * nf + q];
  const int hi = t.pf_idx[5 * nf + q];
  double w = 0.0;
  if (lo >= 0) w = w + -z[lo];
  if (hi >= 0) w = w + z[hi];
  fld(v, kFW, q) = w;
}

// Pass 2: the second derivative over (u_k, u_l), kl = 4 k + l, and for l
// = 0 the gradient's component k.
__device__ void flow_entry_hu(const View& v, int q, int kl) {
  const FlowPoint p = load_point(v, q, true);
  const int k = kl >> 2;
  const int l = kl & 3;
  double dpk, dqk, dpl, dql;
  opf_terms::flow_pq_du(p, k, dpk, dqk);
  opf_terms::flow_pq_du(p, l, dpl, dql);
  const double gmk = opf_terms::flow_gm(p, k, dpk, dqk);
  fld(v, kFHu + kl, q) = opf_terms::flow_hu(
      p, k, l, dpk, dqk, dpl, dql, gmk, opf_terms::flow_gm(p, l, dpl, dql));
  if (l == 0) fld(v, kFGu + k, q) = opf_terms::flow_gu(p, gmk);
}

// Pass 3: the weighted element w H_z[a, b], ab = 4 a + b, of a row a at
// the bus of the entry's slot (theta_k, V_k: the rows that slot reads).
__device__ void flow_entry_hz(const View& v, int q, int ab) {
  const int a = ab >> 2;
  const int k = static_cast<int>(fld(v, kFBus, q));
  if (static_cast<int>(fld(v, (a & 1) ? kFTb : kFFb, q)) != k) return;
  const FlowPoint p = load_point(v, q, false);
  const double h = opf_terms::flow_hz(
      p, a, ab & 3,
      [&](int kk, int l) { return fld(v, kFHu + 4 * kk + l, q); },
      [&](int kk) { return fld(v, kFGu + kk, q); });
  fld(v, kFWhz + ab, q) = fld(v, kFW, q) * h;
}

// The bus k among [lo, hi) whose pair list holds slot s (ptr[lo] <= s <
// ptr[hi]).
__device__ __forceinline__ int slot_bus(const int* ptr, int lo, int hi,
                                        int s) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (ptr[mid] <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Pass 1 of slot s (bus k among [k0, k1)): its Y-bus entries' terms, the
// first parts of its four off-diagonal elements (theta_k/theta_j,
// theta_k/V_j, V_k/theta_j, V_k/V_j) and of its share of bus k's four
// diagonal ones (theta/theta, theta/V, V/theta, V/V).
__device__ void slot_entries(const OpfTables& t, const double* __restrict__ x,
                             const double* __restrict__ y, const View& v,
                             int s, int k0, int k1) {
  const int n = t.n;
  const int np = t.n_pair;
  const int k = slot_bus(t.pair_ptr, k0, k1, s);
  const int j = t.pair[s];
  const int ekj = t.pair[np + s];
  const int ejk = t.pair[2 * np + s];
  const int qa = t.pair_fptr[s];
  const int qb = t.pair_fptr[s + 1];
  for (int q = qa; q < qb; ++q) fld(v, kFBus, q) = k;
  sfld(v, kSJ, s) = j;
  sfld(v, kSBus, s) = k;
  sfld(v, kSQa, s) = qa;
  sfld(v, kSQb, s) = qb;
  // the eight sums, kept in the slot's fields: theta/theta, theta/V,
  // V/theta, V/V off the diagonal, then their shares of the diagonal
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    sfld(v, kSOff + c, s) = 0.0;
    sfld(v, kSDiag + c, s) = 0.0;
  }
  const double vk = x[n + k];
  const double tk = x[k];
  if (j != k) {
    const double vj = x[n + j];
    const double tj = x[j];
    if (ekj >= 0) {  // entry (k, j): k is its row
      const EntryTerms c =
          entry_terms(t.yg[ekj], t.yb[ekj], vk, vj, tk - tj, y[k], y[n + k]);
      sfld(v, kSDiag, s) += c.tt;
      sfld(v, kSOff, s) += -c.tt;
      sfld(v, kSDiag + 1, s) += c.tivi;
      sfld(v, kSDiag + 2, s) += c.tivi;
      sfld(v, kSOff + 1, s) += c.tivj;
      sfld(v, kSOff + 2, s) += c.tjvi;
      sfld(v, kSOff + 3, s) += c.vv;
    }
    if (ejk >= 0) {  // entry (j, k): k is its column
      const EntryTerms c = entry_terms(t.yg[ejk], t.yb[ejk], vj, vk,
                                       tj - tk, y[j], y[n + j]);
      sfld(v, kSDiag, s) += c.tt;
      sfld(v, kSOff, s) += -c.tt;
      sfld(v, kSOff + 1, s) += c.tjvi;
      sfld(v, kSDiag + 1, s) += c.tjvj;
      sfld(v, kSOff + 2, s) += c.tivj;
      sfld(v, kSDiag + 2, s) += c.tjvj;
      sfld(v, kSOff + 3, s) += c.vv;
    }
  } else if (ekj >= 0) {  // the diagonal entry: V_k^2 terms
    sfld(v, kSDiag + 3, s) += y[k] * 2.0 * t.yg[ekj] - y[n + k] * 2.0 *
                                                          t.yb[ekj];
  }
}

// Pass 4 of slot s: its flow entries' weighted blocks added in order; its
// off-diagonal elements go to H where item_at says (none for slot (k, k)).
__device__ void slot_flows(const View& v, const long long* __restrict__ at,
                           double* __restrict__ out, int s) {
  const int k = static_cast<int>(sfld(v, kSBus, s));
  const int qa = static_cast<int>(sfld(v, kSQa, s));
  const int qb = static_cast<int>(sfld(v, kSQb, s));
  double ott = sfld(v, kSOff, s), otv = sfld(v, kSOff + 1, s);
  double ovt = sfld(v, kSOff + 2, s), ovv = sfld(v, kSOff + 3, s);
  double dtt = sfld(v, kSDiag, s), dtv = sfld(v, kSDiag + 1, s);
  double dvt = sfld(v, kSDiag + 2, s), dvv = sfld(v, kSDiag + 3, s);
  for (int q = qa; q < qb; ++q) {
    const int fb = static_cast<int>(fld(v, kFFb, q));
    const int tb = static_cast<int>(fld(v, kFTb, q));
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if ((a == 0 ? fb : tb) != k) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const double th = fld(v, kFWhz + 4 * a + c, q);        // row theta_k
        const double vv = fld(v, kFWhz + 4 * (2 + a) + c, q);  // row V_k
        const bool at_k = ((c & 1) == 0 ? fb : tb) == k;
        if (c < 2) {
          if (at_k) { dtt += th; dvt += vv; } else { ott += th; ovt += vv; }
        } else {
          if (at_k) { dtv += th; dvv += vv; } else { otv += th; ovv += vv; }
        }
      }
    }
  }
  sfld(v, kSDiag, s) = dtt;
  sfld(v, kSDiag + 1, s) = dtv;
  sfld(v, kSDiag + 2, s) = dvt;
  sfld(v, kSDiag + 3, s) = dvv;
  const long long* a = at + 4 * static_cast<int64_t>(s);
  if (a[0] < 0) return;
  out[a[0]] = ott;
  out[a[1]] = otv;
  out[a[2]] = ovt;
  out[a[3]] = ovv;
}

// The values of buses [k0, k1), stored to H where item_at says: passes 1-4
// over the block's flow entries and slots, then a thread per (bus,
// diagonal element) adds the bus's slots' shares one after another in slot
// order.
__device__ void bus_values(const OpfTables& t, const double* __restrict__ x,
                           const double* __restrict__ y,
                           const double* __restrict__ z,
                           double* __restrict__ out, const View& v,
                           int* bus_ptr, int k0, int k1, int s0, int s1,
                           int q0, int q1) {
  const int tid = threadIdx.x;
  const int nb = k1 - k0;
  const int nq = q1 - q0;
  const int ns = s1 - s0;
  // the buses' slot ranges, for pass 5, beside pass 1
  const int nbp = nb < kBusRoom ? nb + 1 : 0;
  for (int e = tid; e < nq + ns + nbp; e += kHessThreads) {
    if (e < nq) {
      flow_entry_point(t, x, z, v, q0 + e);
    } else if (e < nq + ns) {
      slot_entries(t, x, y, v, s0 + e - nq, k0, k1);
    } else {
      bus_ptr[e - nq - ns] = t.pair_ptr[k0 + e - nq - ns];
    }
  }
  __syncthreads();
  for (int e = tid; e < 16 * nq; e += kHessThreads) {
    flow_entry_hu(v, q0 + e % nq, e / nq);
  }
  __syncthreads();
  for (int e = tid; e < 16 * nq; e += kHessThreads) {
    flow_entry_hz(v, q0 + e % nq, e / nq);
  }
  __syncthreads();
  for (int s = s0 + tid; s < s1; s += kHessThreads) {
    slot_flows(v, t.item_at, out, s);
  }
  __syncthreads();
  const int* ptr = nbp ? bus_ptr - k0 : t.pair_ptr;
  for (int e = tid; e < 4 * nb; e += kHessThreads) {
    const int k = k0 + e % nb;
    const int c = e / nb;
    double d = 0.0;
    for (int s = ptr[k]; s < ptr[k + 1]; ++s) {
      d = d + sfld(v, kSDiag + c, s);
    }
    out[t.item_at[4 * static_cast<int64_t>(t.n_pair) + 4 * k + c]] = d;
  }
}

// The cost's second derivative on the diagonal of row `row` (>= 2n):
// false where the row has no term of degree 2 or more.
__device__ __forceinline__ bool tail_value(const OpfTables& t,
                                           const double* __restrict__ x,
                                           int row, double& sum) {
  const int v = row - 2 * t.n;
  const int beg = t.term_ptr[v];
  const int end = t.term_ptr[v + 1];
  if (beg == end) return false;
  const double pq = x[row];
  sum = 0.0;
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
  return true;
}

// Store the zeros of the output elements [first, last) (absolute,
// row-major) around the `count` items at pos(e) (their elements of H, -1
// for none), window by window, cut at multiples of `window` doubles: a
// bitmap in shared memory marks the items' elements (bits set by atomicOr,
// whose result does not depend on the order), then each thread stores its
// chunks of two elements, a 16-byte store of zeros where neither is an
// item, else an 8-byte one for the element that is not. The items' own
// elements are stored by store_items. `out` is 16-byte aligned, so the
// pairs from the even `base` below are.
template <class Pos>
__device__ void stream_zeros(double* __restrict__ out, unsigned* bits,
                             int64_t first, int64_t last, int window,
                             int count, Pos pos) {
  for (int64_t a = first; a < last;) {
    const int64_t cut = (a / window + 1) * window;
    const int64_t b = cut < last ? cut : last;
    const int64_t base = a & ~static_cast<int64_t>(1);
    const int span = static_cast<int>(b - base);
    for (int i = threadIdx.x; i < (span + 31) >> 5; i += kHessThreads) {
      bits[i] = 0u;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < count; e += kHessThreads) {
      const int64_t p = pos(e);
      if (p >= a && p < b) {
        const int c = static_cast<int>(p - base);
        atomicOr(&bits[c >> 5], 1u << (c & 31));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (span + 1) >> 1; i += kHessThreads) {
      const int64_t lo = base + 2 * i;
      const unsigned word = bits[i >> 4] >> ((2 * i) & 31);
      const bool zero0 = lo >= a && !(word & 1u);
      const bool zero1 = lo + 1 < b && !(word & 2u);
      if (zero0 && zero1) {
        reinterpret_cast<double2*>(out)[lo >> 1] = make_double2(0.0, 0.0);
      } else {
        if (zero0) out[lo] = 0.0;
        if (zero1) out[lo + 1] = 0.0;
      }
    }
    __syncthreads();
    a = b;
  }
}

// The items' own elements: out[pos(e)] = val(e).
template <class Pos, class Val>
__device__ void store_items(double* __restrict__ out, int count, Pos pos,
                            Val val) {
  for (int e = threadIdx.x; e < count; e += kHessThreads) {
    const int64_t p = pos(e);
    if (p >= 0) out[p] = val(e);
  }
}

__device__ __forceinline__ unsigned long long globaltime() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Before a block that stores rows stores them: if it is one of the first
// `first_wave` blocks (those the card holds at once), kHoldNs from now.
__device__ __forceinline__ void hold(int64_t b, int first_wave) {
  if (b < first_wave && threadIdx.x == 0) {
    const unsigned long long until = globaltime() + kHoldNs;
    while (globaltime() < until) __nanosleep(500);
  }
  __syncthreads();
}

// The Hessian: G + T' + U blocks for G value groups (hess_group: runs of
// consecutive bus units, built on the host to fit the rooms and even out
// the work), T' tail units (`row_units` rows of 2n.. each) and U bus
// units (`bus_units` buses each), in that order, with the tail units
// spread evenly among the value groups (block b < G + T' is tail unit
// floor(b T' / (G + T')) when that count steps at b). A value group stores
// its buses' values to H; a tail unit its rows, values included; a bus
// unit the zeros of its rows k.. and n + k.., around the elements the
// value group stores (item_at). No block waits on another (the blocks of
// the first wave that store rows hold back a few microseconds, see
// kHoldNs), and each element has one writer. `zero` is 0 when the caller
// has zeroed the output: the blocks then store the values alone.
__global__ void __launch_bounds__(kHessThreads, kHessBlocksPerSm)
opf_hess_kernel(OpfTables t, const double* __restrict__ x,
                const double* __restrict__ y, const double* __restrict__ z,
                double* __restrict__ out, double* scr, int zero,
                int bus_units, int row_units, int window, int groups,
                int first_wave) {
  __shared__ unsigned bits[kWords];
  __shared__ double room_fl[kFlowFields * kFlowRoom];
  __shared__ double room_sl[kSlotFields * kSlotRoom];
  __shared__ double room_it[kItemRoom];
  __shared__ long long room_at[kItemRoom];
  __shared__ int room_bp[kBusRoom];
  __shared__ View view;
  const int n = t.n;
  const int64_t nx = t.n_x;
  const int np = t.n_pair;
  const int tid = threadIdx.x;
  const int tails = (t.n_x - 2 * n + row_units - 1) / row_units;
  const int64_t b = blockIdx.x;
  const int64_t first = groups + tails;
  const int64_t before = b < first ? b * tails / first : 0;
  if (b < first && (b + 1) * tails / first > before) {
    // a tail unit: its rows' one value each, its rows' zeros, its values
    const int r0 = 2 * n + static_cast<int>(before) * row_units;
    const int r1 = min(t.n_x, r0 + row_units);
    for (int row = r0 + tid; row < r1; row += kHessThreads) {
      double v = 0.0;
      const bool has = tail_value(t, x, row, v);
      room_at[row - r0] = has ? row * nx + row : -1;
      room_it[row - r0] = v;
    }
    __syncthreads();
    const auto pos = [&](int e) { return room_at[e]; };
    if (zero) {
      hold(b, first_wave);
      stream_zeros(out, bits, r0 * nx, r1 * nx, window, r1 - r0, pos);
    }
    store_items(out, r1 - r0, pos, [&](int e) { return room_it[e]; });
  } else if (b < first) {
    // a value group
    const int g = static_cast<int>(b - before);
    const int* grp = t.hess_group;
    const int k0 = grp[g], k1 = grp[groups + g];
    const int s0 = grp[2 * groups + g], s1 = grp[3 * groups + g];
    const int q0 = grp[4 * groups + g], q1 = grp[5 * groups + g];
    if (tid == 0) {
      view = q1 - q0 <= kFlowRoom && s1 - s0 <= kSlotRoom
                 ? View{room_fl, kFlowRoom, q0, room_sl, kSlotRoom, s0}
                 : View{scr, t.n_pf, 0, scr + kFlowFields * t.n_pf, np, 0};
    }
    __syncthreads();
    bus_values(t, x, y, z, out, view, room_bp, k0, k1, s0, s1, q0, q1);
  } else if (zero) {
    // a bus unit's rows: their zeros around the value group's elements
    const int u = static_cast<int>(b - first);
    const int k0 = u * bus_units;
    const int k1 = min(n, k0 + bus_units);
    const int s0 = t.pair_ptr[k0];
    const int s1 = t.pair_ptr[k1];
    const int ns = 4 * (s1 - s0);
    const int count = ns + 4 * (k1 - k0);
    const long long* slot_at = t.item_at + 4 * static_cast<int64_t>(s0);
    const long long* bus_at = t.item_at + 4 * static_cast<int64_t>(np) +
                              4 * static_cast<int64_t>(k0);
    const bool room = count <= kItemRoom;
    if (room) {
      for (int e = tid; e < count; e += kHessThreads) {
        room_at[e] = e < ns ? slot_at[e] : bus_at[e - ns];
      }
      __syncthreads();
    }
    const auto pos = [&](int e) -> int64_t {
      return room ? room_at[e] : e < ns ? slot_at[e] : bus_at[e - ns];
    };
    hold(b, first_wave);
    stream_zeros(out, bits, k0 * nx, k1 * nx, window, count, pos);
    stream_zeros(out, bits, (n + k0) * nx, (n + k1) * nx, window, count, pos);
  }
}

// The Hessian kernel's blocks the current device holds at once, worked out
// at the first launch on each device.
cudaError_t first_wave(int* wave) {
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device < 0 || device >= 64) return err;
  if (known[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, opf_hess_kernel, kHessThreads, 0);
    }
    if (err != cudaSuccess) return err;
    known[device] = sms * per_sm;
  }
  *wave = known[device];
  return cudaSuccess;
}

}  // namespace

// Launch K6 on `stream`. `t` holds the spec's tables (device pointers, see
// OpfTables). x[n_x] is the point; with `hessian` 0 the launch fills `out`,
// a [m_E + m_I, n_x] buffer, with J_E over J_I; with `hessian` 1 it fills
// the [n_x, n_x] buffer `out` (16-byte aligned) with the Lagrangian
// Hessian for the raw duals y[m_E] and z[m_I] (z may be null without flow
// rows), by the host's plan (bus_units, row_units, window, groups), with
// `scratch` (opf_fill.py::scratch_doubles doubles) for the value groups
// that outgrow shared memory (null when none does). `zero` 0 leaves the
// zeros to the caller (a memset before the launch). Returns a cudaError_t
// code.
extern "C" int opf_fill_launch(const OpfTables* t, const double* x,
                               const double* y, const double* z,
                               double* out, double* scratch, int hessian,
                               int zero, int bus_units, int row_units,
                               int window, int groups, void* stream) {
  if (t == nullptr || t->n <= 0 || t->n_x < 2 * t->n || x == nullptr ||
      (hessian && (y == nullptr || (t->n_fl > 0 && z == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  const int64_t rows =
      hessian ? t->n_x : static_cast<int64_t>(t->m_e) + t->m_i;
  if (rows * static_cast<int64_t>(t->n_x) == 0) return cudaSuccess;
  if (out == nullptr || rows > INT32_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!hessian) {
    const int bus = units_per_block(2 * static_cast<int64_t>(t->n_x));
    const int row = units_per_block(t->n_x);
    const int64_t bus_blocks = (t->n + bus - 1) / bus;
    const int64_t blocks = bus_blocks + (rows - 2 * t->n + row - 1) / row;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    opf_jac_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *t, x, out, zero, static_cast<int>(rows),
        static_cast<int>(bus_blocks), bus, row);
    return cudaGetLastError();
  }
  if (bus_units < 1 || row_units < 1 ||
      row_units > kTailRoom || groups < 1 || window < 2 ||
      (window & 1) || window > kWindow ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return cudaErrorInvalidValue;
  }
  const int64_t tails = (rows - 2 * t->n + row_units - 1) / row_units;
  const int64_t units = (t->n + bus_units - 1) / bus_units;
  const int64_t blocks = units + groups + tails;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  int wave = 0;
  const cudaError_t err = first_wave(&wave);
  if (err != cudaSuccess) return err;
  opf_hess_kernel<<<static_cast<unsigned>(blocks), kHessThreads, 0, s>>>(
      *t, x, y, z, out, scratch, zero, bus_units, row_units, window, groups,
      wave);
  return cudaGetLastError();
}

// What the build gave each mode's kernel: out[0] registers a thread,
// out[1] local memory a thread (bytes: spills and local arrays), out[2]
// static shared memory a block (bytes), out[3] resident blocks an SM (of
// 256 threads for the Jacobian mode, 128 for the Hessian mode). Returns a
// cudaError_t code.
namespace {

template <class Kernel>
int kernel_attributes(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int opf_fill_attributes(int hessian, int* out) {
  return hessian ? kernel_attributes(opf_hess_kernel, kHessThreads, out)
                 : kernel_attributes(opf_jac_kernel, kThreads, out);
}

extern "C" const char* opf_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
