// Closed forms of the AC OPF's constraint derivatives, shared by K6
// (opf_fill.cu: the dense Jacobians and Lagrangian Hessian) and K7
// (kkt_fill.cu: the structured KKT's COO values).
//
// entry_terms: one Y-bus entry's injection terms and their y-weighted
// second derivatives (juliagrid_tpu/opf/acopf.py:831-867).
// flow_derivs: a flow row's gradient and Hessian over (theta_f, theta_t,
// V_f, V_t) by the chain rule over the rectangular voltages, with the sqrt
// rows' clamp (see opf_fill.cu's head). It is built from pieces that K6's
// Hessian mode calls one element at a time on many threads (flow_point,
// flow_pq_du, flow_gm, flow_hu, flow_hz), each with the same operations in
// the same order, so both kernels get the same bits from one flow row.
//
// Both sources are built with -fmad=false (_build.SOURCE_FLAGS), so every
// product and sum here rounds on its own, as the plain versions' op-by-op
// kernels do.

#pragma once

#include <cuda_runtime.h>

namespace opf_terms {

constexpr double kFloor = 1e-24;

// The injection terms of the entry from bus i (row) to bus j (column) and
// their second derivatives weighted by the duals yp, yq of bus i.
struct EntryTerms {
  double gc, gs, t1, t2;
  double tt, tivi, tivj, tjvi, tjvj, vv;
};

__device__ __forceinline__ EntryTerms entry_terms(double gy, double by,
                                                  double vi, double vj,
                                                  double th, double yp,
                                                  double yq) {
  double st, ct;
  sincos(th, &st, &ct);
  EntryTerms c;
  c.gc = gy * ct + by * st;
  c.gs = gy * st - by * ct;
  c.t1 = vi * vj * c.gc;
  c.t2 = vi * vj * c.gs;
  c.tt = -(yp * c.t1 + yq * c.t2);
  c.tivi = -yp * vj * c.gs + yq * vj * c.gc;
  c.tivj = -yp * vi * c.gs + yq * vi * c.gc;
  c.tjvi = yp * vj * c.gs - yq * vj * c.gc;
  c.tjvj = yp * vi * c.gs - yq * vi * c.gc;
  c.vv = yp * c.gc + yq * c.gs;
  return c;
}

// The flow rows' tables: fl_idx [6, n_fl] (from bus, to bus, class,
// is-from, lower and upper row of J_I) and fl_y [4, n_fl] (gf, bf, gt, bt
// of the row's end), row-major.
struct FlowRows {
  const int* fl_idx;
  const double* fl_y;
  int n_fl;
  int n;
};

// One flow row at a point: its rectangular voltages u = (Vf cos thf,
// Vf sin thf, Vt cos tht, Vt sin tht) and the angles' cosines and sines, its
// end's admittances y = (gf, bf, gt, bt), its end's current (ire, iim) and
// power (pp, qq), and, for the sqrt classes (2, 4), the clamp's scales: the
// value's derivatives are inv times those of S^2 or I^2, plus inv3 times
// the outer product of their gradient in the second.
struct FlowPoint {
  double u[4];
  double cf, sf, ct, st;
  double y[4];
  double ire, iim, pp, qq;
  double inv, inv3;
  int cls;
  int r;  // u[r], u[r + 1]: the real and imaginary voltage of the end
};

// d ire / du_k and d iim / du_k: a = (gf, -bf, gt, -bt), b = (bf, gf, bt,
// gt).
__device__ __forceinline__ double adm_a(const FlowPoint& p, int k) {
  return k == 0 ? p.y[0] : k == 1 ? -p.y[1] : k == 2 ? p.y[2] : -p.y[3];
}
__device__ __forceinline__ double adm_b(const FlowPoint& p, int k) {
  return k == 0 ? p.y[1] : k == 1 ? p.y[0] : k == 2 ? p.y[3] : p.y[2];
}

__device__ __forceinline__ void flow_point(const FlowRows& t,
                                           const double* __restrict__ x,
                                           int f, FlowPoint& p) {
  const int nf = t.n_fl;
  const int n = t.n;
  const int fb = t.fl_idx[f];
  const int tb = t.fl_idx[nf + f];
  p.cls = t.fl_idx[2 * nf + f];
  const bool from = t.fl_idx[3 * nf + f] != 0;
  const double gf = t.fl_y[f];
  const double bf = t.fl_y[nf + f];
  const double gt = t.fl_y[2 * nf + f];
  const double bt = t.fl_y[3 * nf + f];
  p.y[0] = gf;
  p.y[1] = bf;
  p.y[2] = gt;
  p.y[3] = bt;
  sincos(x[fb], &p.sf, &p.cf);
  sincos(x[tb], &p.st, &p.ct);
  const double vf = x[n + fb];
  const double vt = x[n + tb];
  p.u[0] = vf * p.cf;
  p.u[1] = vf * p.sf;
  p.u[2] = vt * p.ct;
  p.u[3] = vt * p.st;
  p.ire = gf * p.u[0] - bf * p.u[1] + gt * p.u[2] - bt * p.u[3];
  p.iim = gf * p.u[1] + bf * p.u[0] + gt * p.u[3] + bt * p.u[2];
  p.r = from ? 0 : 2;
  const double vr = from ? p.u[0] : p.u[2];
  const double vi = from ? p.u[1] : p.u[3];
  p.pp = vr * p.ire + vi * p.iim;
  p.qq = vi * p.ire - vr * p.iim;
  p.inv = 1.0;
  p.inv3 = 0.0;
  if (p.cls == 2 || p.cls == 4) {
    // sqrt(max(m, floor)), m = S^2 or I^2: the clamp's weight w on m's
    // derivatives
    const double m = p.cls == 2 ? p.pp * p.pp + p.qq * p.qq
                                : p.ire * p.ire + p.iim * p.iim;
    const double w = m > kFloor ? 1.0 : m == kFloor ? 0.5 : 0.0;
    const double mm = m > kFloor ? m : kFloor;
    const double root = sqrt(mm);
    p.inv = w / (2.0 * root);
    p.inv3 = w * w / (4.0 * mm * root);
  }
}

// dP/du_k and dQ/du_k.
__device__ __forceinline__ void flow_pq_du(const FlowPoint& p, int k,
                                           double& dp, double& dq) {
  const double a = adm_a(p, k);
  const double b = adm_b(p, k);
  const double vr = p.r == 0 ? p.u[0] : p.u[2];
  const double vi = p.r == 0 ? p.u[1] : p.u[3];
  dp = vr * a + vi * b;
  dq = vi * a - vr * b;
  if (k == p.r) {
    dp += p.ire;
    dq -= p.iim;
  }
  if (k == p.r + 1) {
    dp += p.iim;
    dq += p.ire;
  }
}

// d value / du_k before the sqrt classes' scale (P, S^2 or I^2), from
// dP/du_k and dQ/du_k; the gradient over u is gm * inv for classes 2 and
// 4, gm for the others (flow_gu).
__device__ __forceinline__ double flow_gm(const FlowPoint& p, int k,
                                          double dp, double dq) {
  if (p.cls == 1) return dp;
  if (p.cls == 2 || p.cls == 3) return 2.0 * p.pp * dp + 2.0 * p.qq * dq;
  return 2.0 * p.ire * adm_a(p, k) + 2.0 * p.iim * adm_b(p, k);
}
__device__ __forceinline__ double flow_gu(const FlowPoint& p, double gm) {
  return p.cls == 2 || p.cls == 4 ? gm * p.inv : gm;
}

// d^2 value / du_k du_l, from the two components' dP, dQ and gm.
__device__ __forceinline__ double flow_hu(const FlowPoint& p, int k, int l,
                                          double dpk, double dqk,
                                          double dpl, double dql,
                                          double gmk, double gml) {
  const int r = p.r;
  const int i = r + 1;
  const double ak = adm_a(p, k);
  const double al = adm_a(p, l);
  const double bk = adm_b(p, k);
  const double bl = adm_b(p, l);
  // the constant second derivatives of P and Q over u
  const double hpp = (k == r ? al : 0.0) + (l == r ? ak : 0.0) +
                     (k == i ? bl : 0.0) + (l == i ? bk : 0.0);
  if (p.cls == 1) return hpp;
  double h;
  if (p.cls == 2 || p.cls == 3) {
    const double hqq = (k == i ? al : 0.0) + (l == i ? ak : 0.0) -
                       (k == r ? bl : 0.0) - (l == r ? bk : 0.0);
    h = 2.0 * (dpk * dpl + p.pp * hpp + dqk * dql + p.qq * hqq);
  } else {
    h = 2.0 * (ak * al + bk * bl);
  }
  if (p.cls == 2 || p.cls == 4) h = h * p.inv - gmk * gml * p.inv3;
  return h;
}

// du_k/dz_c: u0, u1 hang on (theta_f, V_f) = z0, z2; u2, u3 on z1, z3:
// J = {{-u1, 0, cf, 0}, {u0, 0, sf, 0}, {0, -u3, 0, ct}, {0, u2, 0, st}}
// by selects on c (k is a constant where it is called: loops unrolled).
__device__ __forceinline__ double du_dz(const FlowPoint& p, int k, int c) {
  const int end = k >> 1;
  if ((c & 1) != end) return 0.0;
  if (c < 2) return (k & 1) ? p.u[k - 1] : -p.u[k + 1];
  return end == 0 ? ((k & 1) ? p.sf : p.cf) : ((k & 1) ? p.st : p.ct);
}

// Element (a, b) of the Hessian over z: J^T H_u J + sum_u g_u d^2u/dz^2,
// J = du/dz. hu(k, l) gives d^2 value / du_k du_l and gu(k) the gradient
// over u.
template <class Hu, class Gu>
__device__ __forceinline__ double flow_hz(const FlowPoint& p, int a, int b,
                                          Hu hu, Gu gu) {
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      s += du_dz(p, k, a) * hu(k, l) * du_dz(p, l, b);
    }
  }
  const int e = 4 * a + b;
  if (e == 0) {
    s += gu(0) * -p.u[0] + gu(1) * -p.u[1];
  } else if (e == 5) {
    s += gu(2) * -p.u[2] + gu(3) * -p.u[3];
  } else if (e == 2 || e == 8) {
    s += gu(0) * -p.sf + gu(1) * p.cf;
  } else if (e == 7 || e == 13) {
    s += gu(2) * -p.st + gu(3) * p.ct;
  }
  return s;
}

// Gradient g[4] and, unless h is null, Hessian h[16] (row-major) of flow
// row f's value over z = (theta_f, theta_t, V_f, V_t).
__device__ inline void flow_derivs(const FlowRows& t,
                                   const double* __restrict__ x, int f,
                                   double* g, double* h) {
  FlowPoint p;
  flow_point(t, x, f, p);
  double dp[4], dq[4], gm[4], gu[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    flow_pq_du(p, k, dp[k], dq[k]);
    gm[k] = flow_gm(p, k, dp[k], dq[k]);
    gu[k] = flow_gu(p, gm[k]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += gu[k] * du_dz(p, k, c);
    g[c] = s;
  }
  if (h == nullptr) return;
  double hu[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      hu[4 * k + l] = flow_hu(p, k, l, dp[k], dq[k], dp[l], dq[l], gm[k],
                              gm[l]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      h[4 * a + b] = flow_hz(
          p, a, b, [&](int k, int l) { return hu[4 * k + l]; },
          [&](int k) { return gu[k]; });
    }
  }
}

}  // namespace opf_terms
