"""Box- and smoothness-constrained QP for the pseudo-GT coefficients.

The problem (reference ``said/optimize/blendshape_coeffs.py``): given a
neutral vertex vector n and a blendshape matrix B, find per-frame weights
w_t ∈ [0, 1]^N minimising Σ_t ‖B_Δ w_t − (v_t − n)‖² subject to
|w_t − w_{t+1}| ≤ δ. The reference hands a dense (T·N)² QP to cvxopt;
here the structure is used instead. The objective separates over frames
through the shared N×N Gram matrix G = B_ΔᵀB_Δ, and smoothness couples
neighbours through the path graph's Laplacian L_T in time.

Two solvers (``solve_sequence_qp``'s ``backend``):

- ``"native"``: the C++ ADMM in float64 on the host (``native.py``);
- ``"torch"``: the same ADMM in float32 with torch on ``device`` (the card
  by default), ``said_tpu``'s ``_admm_sequence_qp``: w = z₁ projected on
  the box, Dw = z₂ on the δ-ball, over-relaxation α = 1.6,
  ρ₁ = ρ₂ = max(trace G / N, 1e-3), and the same stop rule (primal and
  dual residuals ≤ ``tol``, or ``max_iters``).

Each w-update solves ((G + ρ₁I) ⊗ I_T + ρ₂ I_N ⊗ L_T) w = rhs. G = V Λ Vᵀ
(``torch.linalg.eigh``) splits it into N tridiagonal systems in time,
A_j = (λ_j + ρ₁) I + ρ₂ L_T, which the JAX package solves by T-step Thomas
scans. Here each A_j is pre-inverted once, as a band: A_j is diagonally
dominant with a ratio of at least 3, so |A_j⁻¹[s, s ± d]| falls as
0.382^d, and the entries past ``BAND`` = 32 off the diagonal are below
2e-14 of it, far under float32 rounding. The band, (T, N, 65) float32 (30
MB at T = 3600, where the N dense (T, T) inverses would take 1.66 GB),
comes from the Thomas recurrences in float64 on the host; an iteration
applies it as one product and one sum over a padded (T + 64, N) buffer:
W = (R V ⊛ band) Vᵀ. (A DCT diagonalises L_T too, but its dense T-term
sums in f32 kept the residuals above 1e-6 already at T = 240.)

Every iteration issues the same torch ops, whatever T is (43 launches on
an H100). The rotations by V are products and sums, not GEMMs: cuBLAS
picks a split-K GEMM, one launch more, at some T and not at others. They
multiply in f32 and accumulate in f64: the 32 terms cancel, and f32
accumulation left a residual floor of ~1.3e-6 at T = 3600 on a
FLAME-sized problem, so that the ADMM ran to ``max_iters`` where the JAX
package's stops in under 100 iterations. Nothing runs in TF32
(``Precision.HIGHEST`` in JAX: TF32 moves the fixed point by ~1e-3).

The stop test stays on the device: the state of the first iteration
that met it is kept with ``torch.where``, and the host reads the flag
every ``check_every`` iterations, so the result and the iteration count
equal stopping at that iteration for any ``check_every``.

``"auto"`` keeps the JAX package's order: native, then (if ``g++``
fails) the ADMM with a warning that carries the build error. Every
solution says which solver ran.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

ALPHA = 1.6  # over-relaxation, the standard ADMM acceleration
BAND = 32  # half-width of the pre-inverted tridiagonal systems (module docstring)


@dataclasses.dataclass
class QPSolution:
    """(T, N) weights; the solver that ran ("native" or "torch:<device>")
    and its iterations."""

    w: np.ndarray
    solver: str
    iterations: int


def band_inverse(evals: np.ndarray, rho1: float, rho2: float, t: int, band: int = BAND) -> np.ndarray:
    """Rows of A_j⁻¹ = ((λ_j + ρ₁) I + ρ₂ L_T)⁻¹ within ``band`` of the
    diagonal, float64: (T, N, 2·band + 1), entry [i, j, band + s] =
    A_j⁻¹[i, i + s] (0 past either end).

    Column k of A⁻¹ solves A x = e_k: above row k, x_i = −f_i x_{i+1}, with
    f the Thomas forward coefficients f_i = −ρ₂ / (a_i + ρ₂ f_{i−1}); below
    it x_i = −g_i x_{i−1}, with g the same from the bottom; row k gives
    x_k = 1 / (a_k + ρ₂ f_{k−1} + ρ₂ g_{k+1}). A⁻¹ is symmetric, so row i
    is column i.
    """
    n = len(evals)
    lap = np.full(t, 2.0)
    lap[[0, -1]] = 1.0
    if t == 1:
        lap[:] = 0.0
    a = np.asarray(evals, np.float64)[None, :] + rho1 + rho2 * lap[:, None]  # (T, N) diagonals
    f, g = np.zeros((t + 1, n)), np.zeros((t + 1, n))  # row -1 / row T: 0
    for i in range(t):
        f[i] = -rho2 / (a[i] + rho2 * f[i - 1])
    for i in range(t - 1, -1, -1):
        g[i] = -rho2 / (a[i] + rho2 * g[i + 1])
    out = np.zeros((t, n, 2 * band + 1))
    diag = 1.0 / (a + rho2 * f[np.arange(t) - 1] + rho2 * g[1:])
    out[:, :, band] = diag
    up, down = diag.copy(), diag.copy()  # A⁻¹[i, i - s] and A⁻¹[i, i + s]
    idx = np.arange(t)
    for s in range(1, min(band, t - 1) + 1):
        up = up * -f[np.maximum(idx - s, -1)]  # x_{i-s} = -f_{i-s} x_{i-s+1} (f[-1] = 0 past the top)
        down = down * -g[np.minimum(idx + s, t)]  # g[T] = 0 past the bottom
        out[:, :, band - s] = up
        out[:, :, band + s] = down
    return out


def admm_sequence_qp(
    gram: np.ndarray,
    q: np.ndarray,
    delta: float,
    max_iters: int = 4000,
    tol: float = 1e-6,
    init_vals: Optional[np.ndarray] = None,
    device="cuda",
    check_every: int = 16,
) -> QPSolution:
    """The structured ADMM in float32 on ``device`` (module docstring)."""
    device = torch.device(device)
    gram32 = np.asarray(gram, np.float32)
    q = np.asarray(q, np.float32)
    t, n = q.shape
    rho = max(float(np.trace(gram32)) / n, 1e-3)
    rho1 = rho2 = rho
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        evals, evecs = torch.linalg.eigh(torch.from_numpy(gram32).to(device))
        vt = evecs.T.contiguous()
        band = torch.from_numpy(band_inverse(evals.cpu().double().numpy(), rho1, rho2, t)).float().to(device)
        padded = torch.zeros((t + 2 * BAND, n), device=device)  # rows BAND..BAND+T: R V; the rest stays 0
        windows = padded.unfold(0, 2 * BAND + 1, 1)  # (T, N, 2·BAND + 1) view
        neg_q = torch.from_numpy(-q).to(device)

        z1 = torch.zeros((t, n), device=device)
        if init_vals is not None:
            z1 = torch.from_numpy(np.asarray(init_vals, np.float32).reshape(t, n)).to(device).clamp(0.0, 1.0)
        u1 = torch.zeros_like(z1)
        z2 = z1[1:] - z1[:-1]
        u2 = torch.zeros_like(z2)
        out = z1.clone()
        done = torch.zeros((), dtype=torch.bool, device=device)
        iters = torch.zeros((), dtype=torch.int64, device=device)

        def step(z1, u1, z2, u2):
            rhs = torch.add(neg_q, z1 - u1, alpha=rho1)
            if t > 1:
                e = z2 - u2
                rhs[:-1].sub_(e, alpha=rho2)
                rhs[1:].add_(e, alpha=rho2)
            padded[BAND:BAND + t] = (rhs[:, None, :] * vt).sum(-1, dtype=torch.float64)  # R V
            w = ((windows * band).sum(-1)[:, None, :] * evecs).sum(-1, dtype=torch.float64).float()  # (..) Vᵀ
            wu1 = torch.lerp(z1, w, ALPHA).add_(u1)
            z1n = wu1.clamp(0.0, 1.0)
            res = [(w - z1n).abs().amax(), (z1n - z1).abs().amax()]
            if t > 1:
                dw = w[1:] - w[:-1]
                du = torch.lerp(z2, dw, ALPHA).add_(u2)
                z2n = du.clamp(-delta, delta)
                res += [(dw - z2n).abs().amax(), (z2n - z2).abs().amax()]
                z2, u2 = z2n, du.sub_(z2n)
            return z1n, wu1.sub_(z1n), z2, u2, torch.stack(res).amax()

        for it in range(max_iters):
            z1n, u1, z2, u2, res = step(z1, u1, z2, u2)
            out = torch.where(done, out, z1n)
            iters += torch.logical_not(done)
            done = done | (res <= tol)
            z1 = z1n
            if (it + 1) % check_every == 0 and bool(done):
                break
        # z1 is the feasible (box-projected) iterate, as the reference clips
        # its solution to the bounds (blendshape_coeffs.py:159)
        return QPSolution(out.cpu().numpy(), f"torch:{device.type}", int(iters))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def solve_sequence_qp(
    gram: np.ndarray,
    q: np.ndarray,
    delta: float = 0.1,
    init_vals: Optional[np.ndarray] = None,
    max_iters: int = 4000,
    tol: float = 1e-6,
    backend: str = "auto",
    device="cuda",
) -> QPSolution:
    """min Σ_t ½ w_tᵀ G w_t + q_tᵀ w_t, 0 ≤ w ≤ 1, |w_t − w_{t+1}| ≤ δ.

    ``backend``: "native" (float64, its own tolerance 1e-9 and 20000
    iterations), "torch" (the float32 ADMM on ``device``, ``max_iters``,
    ``tol``), or "auto" (native; the ADMM if the native build fails).
    """
    if backend not in ("auto", "native", "torch"):
        raise ValueError(f"unknown QP backend {backend!r}")
    if backend in ("auto", "native"):
        from said_tpu_torch.optimize.native import solve_sequence_qp_native

        try:
            w, iters = solve_sequence_qp_native(gram, q, delta, init_vals)
            return QPSolution(w, "native", iters)
        except RuntimeError as err:
            if backend == "native":
                raise
            warnings.warn(f"native QP solver unavailable, running the float32 ADMM on {device}: {err}")
    return admm_sequence_qp(gram, q, delta, max_iters, tol, init_vals, device)


class OptimizationProblemSingle:
    """Single-frame box QP (reference ``OptimizationProblemSingle``)."""

    def __init__(self, neutral_vector: np.ndarray, blendshapes_matrix: np.ndarray, backend: str = "auto",
                 device="cuda"):
        self.neutral_vector = np.asarray(neutral_vector, np.float64)
        self.blendshapes_matrix_delta = np.asarray(blendshapes_matrix, np.float64) - self.neutral_vector
        self.num_blendshapes = blendshapes_matrix.shape[1]
        self.gram = self.blendshapes_matrix_delta.T @ self.blendshapes_matrix_delta
        self.backend, self.device = backend, device

    def optimize(self, vertices_vector: np.ndarray, init_vals: Optional[np.ndarray] = None) -> np.ndarray:
        q = (self.blendshapes_matrix_delta.T
             @ (self.neutral_vector - np.asarray(vertices_vector, np.float64))).reshape(1, -1)
        return solve_sequence_qp(
            self.gram, q,
            delta=2.0,  # inert for a single frame (no difference constraints)
            init_vals=None if init_vals is None else init_vals.reshape(1, -1),
            backend=self.backend, device=self.device,
        ).w[0]


class OptimizationProblemFull:
    """Whole-sequence QP with temporal smoothness (reference
    ``OptimizationProblemFull``)."""

    def __init__(self, neutral_vector: np.ndarray, blendshapes_matrix: np.ndarray, backend: str = "auto",
                 device="cuda"):
        self.neutral_vector = np.asarray(neutral_vector, np.float64)
        self.blendshapes_matrix_delta = np.asarray(blendshapes_matrix, np.float64) - self.neutral_vector
        self.num_blendshapes = blendshapes_matrix.shape[1]
        self.btb = self.blendshapes_matrix_delta.T @ self.blendshapes_matrix_delta
        self.backend, self.device = backend, device

    def solve(self, vertices_vector_list: List[np.ndarray], init_vals: Optional[np.ndarray] = None,
              delta: float = 0.1) -> QPSolution:
        """The QP over the sequence, with the solver that ran."""
        verts = np.stack([np.asarray(v, np.float64).reshape(-1) for v in vertices_vector_list])  # (T, 3|V|)
        q = (self.neutral_vector.reshape(1, -1) - verts) @ self.blendshapes_matrix_delta
        return solve_sequence_qp(self.btb, q, delta=delta, init_vals=init_vals, backend=self.backend,
                                 device=self.device)

    def optimize(self, vertices_vector_list: List[np.ndarray], init_vals: Optional[np.ndarray] = None,
                 delta: float = 0.1) -> np.ndarray:
        return self.solve(vertices_vector_list, init_vals, delta).w
