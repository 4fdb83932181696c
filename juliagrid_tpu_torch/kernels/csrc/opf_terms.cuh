// Closed forms of the AC OPF's constraint derivatives, shared by K6
// (opf_fill.cu: the dense Jacobians and Lagrangian Hessian) and K7
// (kkt_fill.cu: the structured KKT's COO values).
//
// entry_terms: one Y-bus entry's injection terms and their y-weighted
// second derivatives (juliagrid_tpu/opf/acopf.py:831-867).
// flow_derivs: a flow row's gradient and Hessian over (theta_f, theta_t,
// V_f, V_t) by the chain rule over the rectangular voltages, with the sqrt
// rows' clamp (see opf_fill.cu's head).
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

// Gradient g[4] and, unless h is null, Hessian h[16] (row-major) of flow
// row f's value over z = (theta_f, theta_t, V_f, V_t).
__device__ inline void flow_derivs(const FlowRows& t,
                                   const double* __restrict__ x, int f,
                                   double* g, double* h) {
  const int nf = t.n_fl;
  const int n = t.n;
  const int fb = t.fl_idx[f];
  const int tb = t.fl_idx[nf + f];
  const int cls = t.fl_idx[2 * nf + f];
  const bool from = t.fl_idx[3 * nf + f] != 0;
  const double gf = t.fl_y[f];
  const double bf = t.fl_y[nf + f];
  const double gt = t.fl_y[2 * nf + f];
  const double bt = t.fl_y[3 * nf + f];
  double sf, cf, st, ct;
  sincos(x[fb], &sf, &cf);
  sincos(x[tb], &st, &ct);
  const double vf = x[n + fb];
  const double vt = x[n + tb];
  const double u[4] = {vf * cf, vf * sf, vt * ct, vt * st};
  const double a[4] = {gf, -bf, gt, -bt};   // d ire / du
  const double b[4] = {bf, gf, bt, gt};     // d iim / du
  const double ire = gf * u[0] - bf * u[1] + gt * u[2] - bt * u[3];
  const double iim = gf * u[1] + bf * u[0] + gt * u[3] + bt * u[2];
  const int r = from ? 0 : 2;  // the end's real and imaginary voltage
  const int i = r + 1;
  const double vr = u[r];
  const double vi = u[i];
  const double pp = vr * ire + vi * iim;
  const double qq = vi * ire - vr * iim;

  // derivatives over u of the class's value: gu, hu
  double gu[4];
  double hu[16];
  double dp[4], dq[4];
  for (int k = 0; k < 4; ++k) {
    dp[k] = vr * a[k] + vi * b[k];
    dq[k] = vi * a[k] - vr * b[k];
  }
  dp[r] += ire;
  dp[i] += iim;
  dq[i] += ire;
  dq[r] -= iim;
  // the constant second derivatives of P and Q over u
  auto hpp = [&](int k, int l) {
    return (k == r ? a[l] : 0.0) + (l == r ? a[k] : 0.0) +
           (k == i ? b[l] : 0.0) + (l == i ? b[k] : 0.0);
  };
  auto hqq = [&](int k, int l) {
    return (k == i ? a[l] : 0.0) + (l == i ? a[k] : 0.0) -
           (k == r ? b[l] : 0.0) - (l == r ? b[k] : 0.0);
  };
  if (cls == 1) {
    for (int k = 0; k < 4; ++k) {
      gu[k] = dp[k];
      for (int l = 0; l < 4; ++l) hu[4 * k + l] = hpp(k, l);
    }
  } else {
    double m;  // S^2 or I^2
    if (cls == 2 || cls == 3) {
      m = pp * pp + qq * qq;
      for (int k = 0; k < 4; ++k) {
        gu[k] = 2.0 * pp * dp[k] + 2.0 * qq * dq[k];
        for (int l = 0; l < 4; ++l) {
          hu[4 * k + l] = 2.0 * (dp[k] * dp[l] + pp * hpp(k, l) +
                                 dq[k] * dq[l] + qq * hqq(k, l));
        }
      }
    } else {
      m = ire * ire + iim * iim;
      for (int k = 0; k < 4; ++k) {
        gu[k] = 2.0 * ire * a[k] + 2.0 * iim * b[k];
        for (int l = 0; l < 4; ++l) {
          hu[4 * k + l] = 2.0 * (a[k] * a[l] + b[k] * b[l]);
        }
      }
    }
    if (cls == 2 || cls == 4) {
      // sqrt(max(m, floor)): the clamp's weight w on m's derivatives
      const double w = m > kFloor ? 1.0 : m == kFloor ? 0.5 : 0.0;
      const double mm = m > kFloor ? m : kFloor;
      const double root = sqrt(mm);
      const double inv = w / (2.0 * root);
      const double inv3 = w * w / (4.0 * mm * root);
      for (int k = 0; k < 4; ++k) {
        for (int l = 0; l < 4; ++l) {
          hu[4 * k + l] = hu[4 * k + l] * inv - gu[k] * gu[l] * inv3;
        }
      }
      for (int k = 0; k < 4; ++k) gu[k] *= inv;
    }
  }

  // du/dz: u0, u1 hang on (theta_f, V_f) = z0, z2; u2, u3 on z1, z3
  const double jac[4][4] = {{-u[1], 0.0, cf, 0.0},
                            {u[0], 0.0, sf, 0.0},
                            {0.0, -u[3], 0.0, ct},
                            {0.0, u[2], 0.0, st}};
  for (int c = 0; c < 4; ++c) {
    double s = 0.0;
    for (int k = 0; k < 4; ++k) s += gu[k] * jac[k][c];
    g[c] = s;
  }
  if (h == nullptr) return;
  for (int p = 0; p < 4; ++p) {
    for (int q = 0; q < 4; ++q) {
      double s = 0.0;
      for (int k = 0; k < 4; ++k) {
        for (int l = 0; l < 4; ++l) {
          s += jac[k][p] * hu[4 * k + l] * jac[l][q];
        }
      }
      h[4 * p + q] = s;
    }
  }
  // sum_u g_u d^2u/dz^2
  h[0] += gu[0] * -u[0] + gu[1] * -u[1];
  h[5] += gu[2] * -u[2] + gu[3] * -u[3];
  const double fv = gu[0] * -sf + gu[1] * cf;
  const double tv = gu[2] * -st + gu[3] * ct;
  h[2] += fv;
  h[8] += fv;
  h[7] += tv;
  h[13] += tv;
}

}  // namespace opf_terms
