// Native float64 solver for the pseudo-GT blendshape QP.
//
// Problem: min Σ_t ½ w_tᵀ G w_t + q_tᵀ w_t   s.t. 0 ≤ w ≤ 1,
//          |w_t − w_{t+1}| ≤ δ  (per coefficient)
//
// The structured ADMM of said_tpu_torch/optimize/qp.py in double
// precision, its w-update solved in the eigenbasis of the shared Gram
// matrix by per-channel tridiagonal Thomas solves in time: the exact path of the host-side pseudo-GT pipeline,
// standing in for the cvxopt/GLPK solver the reference depends on
// (said/optimize/blendshape_coeffs.py). The same source and C ABI as the
// JAX package's said_tpu/optimize/csrc/qp_solver.cpp.
//
// Build:  g++ -O3 -shared -fPIC -o libsaidqp.so qp_solver.cpp
//         (optimize/native.py does so at first use, into build/)
// ABI:    said_solve_sequence_qp(...): plain C, loaded through ctypes;
//         returns the iterations run, or -1 for an empty problem.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Cyclic Jacobi eigendecomposition of a symmetric N×N matrix.
// A is destroyed; eigenvalues land in evals, eigenvectors in columns of V.
void jacobi_eigh(std::vector<double>& a, int n, std::vector<double>& evals,
                 std::vector<double>& v) {
  v.assign(n * n, 0.0);
  for (int i = 0; i < n; ++i) v[i * n + i] = 1.0;

  for (int sweep = 0; sweep < 100; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) off += a[p * n + q] * a[p * n + q];
    if (off < 1e-24) break;

    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double apq = a[p * n + q];
        if (std::fabs(apq) < 1e-300) continue;
        double app = a[p * n + p], aqq = a[q * n + q];
        double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        double c = 1.0 / std::sqrt(1.0 + t * t);
        double s = t * c;
        for (int k = 0; k < n; ++k) {
          double akp = a[k * n + p], akq = a[k * n + q];
          a[k * n + p] = c * akp - s * akq;
          a[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          double apk = a[p * n + k], aqk = a[q * n + k];
          a[p * n + k] = c * apk - s * aqk;
          a[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          double vkp = v[k * n + p], vkq = v[k * n + q];
          v[k * n + p] = c * vkp - s * vkq;
          v[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  evals.resize(n);
  for (int i = 0; i < n; ++i) evals[i] = a[i * n + i];
}

// w (T,N) row-major throughout.
inline void matmul_tn(const double* x, const double* m, double* out, int t,
                      int n, bool transpose_m) {
  // out = x @ M (or x @ Mᵀ), M is (n,n)
  for (int r = 0; r < t; ++r) {
    for (int c = 0; c < n; ++c) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k)
        acc += x[r * n + k] * (transpose_m ? m[c * n + k] : m[k * n + c]);
      out[r * n + c] = acc;
    }
  }
}

}  // namespace

extern "C" int said_solve_sequence_qp(
    const double* gram,  // (N, N)
    const double* q,     // (T, N)
    int t, int n,
    double delta,
    double tol,
    int max_iters,
    const double* w_init,  // (T, N) or nullptr
    double* out_w          // (T, N)
) {
  if (t < 1 || n < 1) return -1;

  // Eigendecompose G.
  std::vector<double> a(gram, gram + n * n), evals, evecs;
  jacobi_eigh(a, n, evals, evecs);

  double trace = 0.0;
  for (int i = 0; i < n; ++i) trace += gram[i * n + i];
  double rho = std::max(trace / n, 1e-3);
  const double rho1 = rho, rho2 = rho, alpha = 1.6;

  // Pre-factor the per-eigenchannel tridiagonal systems
  // (λ_i + ρ1) I_T + ρ2 L_T, off-diagonal −ρ2.
  std::vector<double> cp(n * t), invden(n * t);
  for (int i = 0; i < n; ++i) {
    double cprev = 0.0;
    for (int tt = 0; tt < t; ++tt) {
      double lap = (t == 1) ? 0.0 : ((tt == 0 || tt == t - 1) ? 1.0 : 2.0);
      double diag = evals[i] + rho1 + rho2 * lap;
      double den = diag - (-rho2) * cprev;
      cp[i * t + tt] = (-rho2) / den;
      invden[i * t + tt] = 1.0 / den;
      cprev = cp[i * t + tt];
    }
  }

  const int tn = t * n, dn = (t - 1) * n;
  std::vector<double> w(tn, 0.0), z1(tn, 0.0), u1(tn, 0.0);
  std::vector<double> z2(std::max(dn, 1), 0.0), u2(std::max(dn, 1), 0.0);
  std::vector<double> rhs(tn), rt(tn), wt(tn), d(tn), scratch(tn);

  if (w_init) {
    for (int i = 0; i < tn; ++i)
      z1[i] = std::min(1.0, std::max(0.0, w_init[i]));
    for (int i = 0; i < dn; ++i) z2[i] = z1[i + n] - z1[i];
  }

  int it = 0;
  for (; it < max_iters; ++it) {
    // rhs = -q + ρ1(z1-u1) + ρ2 Dᵀ(z2-u2)
    for (int i = 0; i < tn; ++i) rhs[i] = -q[i] + rho1 * (z1[i] - u1[i]);
    for (int i = 0; i < dn; ++i) {
      double v = rho2 * (z2[i] - u2[i]);
      rhs[i] -= v;
      rhs[i + n] += v;
    }

    // Solve in the eigenbasis: rt = rhs @ V, Thomas per channel, w = wt @ Vᵀ.
    matmul_tn(rhs.data(), evecs.data(), rt.data(), t, n, false);
    for (int i = 0; i < n; ++i) {
      double dprev = 0.0;
      for (int tt = 0; tt < t; ++tt) {
        double val = (rt[tt * n + i] - (-rho2) * dprev) * invden[i * t + tt];
        d[tt * n + i] = val;
        dprev = val;
      }
      double xnext = 0.0;
      for (int tt = t - 1; tt >= 0; --tt) {
        double x = d[tt * n + i] - cp[i * t + tt] * xnext;
        wt[tt * n + i] = x;
        xnext = x;
      }
    }
    matmul_tn(wt.data(), evecs.data(), w.data(), t, n, true);

    // Projections + dual updates (with over-relaxation).
    double res = 0.0;
    for (int i = 0; i < tn; ++i) {
      double wr = alpha * w[i] + (1.0 - alpha) * z1[i];
      double wu = wr + u1[i];
      double z1n = std::min(1.0, std::max(0.0, wu));
      res = std::max(res, std::fabs(w[i] - z1n));
      res = std::max(res, std::fabs(z1n - z1[i]));
      u1[i] = wu - z1n;
      z1[i] = z1n;
    }
    for (int i = 0; i < dn; ++i) {
      double dw = w[i + n] - w[i];
      double dwr = alpha * dw + (1.0 - alpha) * z2[i];
      double du = dwr + u2[i];
      double z2n = std::min(delta, std::max(-delta, du));
      res = std::max(res, std::fabs(dw - z2n));
      res = std::max(res, std::fabs(z2n - z2[i]));
      u2[i] = du - z2n;
      z2[i] = z2n;
    }

    if (res <= tol) { ++it; break; }
  }

  std::memcpy(out_w, z1.data(), tn * sizeof(double));
  return it;
}
