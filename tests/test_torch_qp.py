"""The port's pseudo-GT QP against the JAX package's and scipy, on the CPU.

- the native float64 solver (the port's build of its own copy of
  ``qp_solver.cpp``) against ``said_tpu.optimize.native``: ≤ 1e-12;
- the port's float32 ADMM (``backend="torch"``, ``device="cpu"``) against
  the JAX package's ``backend="jax"`` ADMM: ≤ 1e-4 (the two ADMMs read
  ~4e-6 from the native solution here);
- both against the scipy oracles of ``tests/test_qp.py`` (L-BFGS-B for one
  frame, SLSQP for a sequence);
- the stop test read every 16 iterations gives the same bits and
  iteration count as every iteration; T = 1; a warm start;
- the band of the pre-inverted tridiagonal systems against a dense
  inverse; "auto" falling back with a warning; the library's place.
"""

import warnings

import numpy as np
import pytest
from scipy import optimize as sopt

from said_tpu.optimize import native as j_native
from said_tpu.optimize import qp as j_qp
from said_tpu_torch._build import BUILD_ROOT
from said_tpu_torch.optimize import native, qp


def problem(seed, coords, n, t, noise=1e-3, span=(0.05, 0.95)):
    """(gram, q, w_true): targets from smooth weights in ``span`` plus noise."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((coords, n)) * 0.1
    w = np.clip(0.5 + np.cumsum(rng.standard_normal((t, n)) * 0.05, axis=0), *span)
    verts = w @ basis.T + noise * rng.standard_normal((t, coords))
    return basis.T @ basis, -(verts @ basis), w


def objective(gram, q, w):
    return 0.5 * np.einsum("ti,ij,tj->", w, gram, w) + np.sum(q * w)


CASES = {"n8_t20": (0, 60, 8, 20), "n32_t16": (1, 150, 32, 16), "t1": (2, 40, 6, 1), "n5_t12_loud": (3, 30, 5, 12)}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_native_matches_the_jax_packages_native(case, warm):
    seed, coords, n, t = CASES[case]
    gram, q, w_true = problem(seed, coords, n, t, noise=0.3 if "loud" in case else 1e-3)
    init = w_true + 0.1 if warm else None
    got, iters = native.solve_sequence_qp_native(gram, q, 0.07, init)
    want = j_native.solve_sequence_qp_native(gram, q, 0.07, init)
    assert got.dtype == np.float64 and got.shape == (t, n) and iters > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_torch_admm_matches_the_jax_admm(case, warm):
    seed, coords, n, t = CASES[case]
    gram, q, w_true = problem(seed, coords, n, t, noise=0.3 if "loud" in case else 1e-3)
    init = w_true + 0.1 if warm else None
    got = qp.solve_sequence_qp(gram, q, 0.07, init, backend="torch", device="cpu")
    want = j_qp.solve_sequence_qp(gram, q, 0.07, init, backend="jax")
    assert got.solver == "torch:cpu" and 0 < got.iterations < 4000
    assert got.w.dtype == np.float32 and got.w.shape == (t, n)
    np.testing.assert_allclose(got.w, want, rtol=0, atol=1e-4)
    assert got.w.min() >= 0.0 and got.w.max() <= 1.0
    if t > 1:
        assert np.abs(np.diff(got.w, axis=0)).max() <= 0.07 + 1e-5


def test_stop_test_every_k_iterations_is_exact():
    gram, q, _ = problem(4, 120, 16, 40, noise=0.05)
    every = qp.admm_sequence_qp(gram, q, 0.05, device="cpu", check_every=1)
    sparse = qp.admm_sequence_qp(gram, q, 0.05, device="cpu", check_every=16)
    assert every.iterations % 16 != 0  # the sparse run went past the stopping iteration
    assert sparse.iterations == every.iterations
    np.testing.assert_array_equal(sparse.w, every.w)
    capped = qp.admm_sequence_qp(gram, q, 0.05, max_iters=every.iterations - 3, device="cpu", check_every=16)
    assert capped.iterations == every.iterations - 3


@pytest.mark.parametrize("t", [1, 2, 5, 70, 150])
def test_band_inverse_equals_the_dense_inverse(t):
    rng = np.random.default_rng(t)
    evals = np.concatenate([[0.0], rng.uniform(0, 5, 5)])
    rho = 0.7
    band = qp.band_inverse(evals, rho, rho, t)
    b = qp.BAND
    lap = np.diag(np.r_[1.0, np.full(t - 2, 2.0), 1.0]) if t > 1 else np.zeros((1, 1))
    if t > 1:
        lap -= np.eye(t, k=1) + np.eye(t, k=-1)
    for j, lam in enumerate(evals):
        dense = np.linalg.inv((lam + rho) * np.eye(t) + rho * lap)
        want = np.zeros((t, 2 * b + 1))
        for i in range(t):
            for s in range(-b, b + 1):
                if 0 <= i + s < t:
                    want[i, b + s] = dense[i, i + s]
        np.testing.assert_allclose(band[:, j], want, rtol=0, atol=1e-14)
        outside = np.abs(np.triu(dense, b + 1)).max() if t > b + 1 else 0.0
        assert outside < 1e-13 * dense.max()


def test_single_frame_matches_lbfgsb():
    gram, q, _ = problem(5, 50, 6, 1, noise=0.5)
    res = sopt.minimize(lambda x: 0.5 * x @ gram @ x + q[0] @ x, np.full(6, 0.5), jac=lambda x: gram @ x + q[0],
                        bounds=[(0, 1)] * 6, method="L-BFGS-B", options={"ftol": 1e-14, "gtol": 1e-12})
    for backend in ("native", "torch"):
        w = qp.solve_sequence_qp(gram, q, 2.0, backend=backend, device="cpu").w[0]
        np.testing.assert_allclose(w, res.x, atol=2e-3)
        assert 0.5 * w @ gram @ w + q[0] @ w <= res.fun + 1e-4 * (1 + abs(res.fun))


def test_sequence_matches_slsqp():
    n, t, delta = 4, 6, 0.05
    gram, q, _ = problem(6, 40, n, t, noise=0.5)

    def c(i1, i2, sign):
        return {"type": "ineq", "fun": lambda x: delta - sign * (x[i1] - x[i2])}

    cons = [c(s * n + j, (s + 1) * n + j, sign) for s in range(t - 1) for j in range(n) for sign in (1, -1)]
    res = sopt.minimize(lambda x: objective(gram, q, x.reshape(t, n)), np.full(t * n, 0.5),
                        jac=lambda x: (x.reshape(t, n) @ gram + q).reshape(-1), bounds=[(0, 1)] * (t * n),
                        constraints=cons, method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
    for backend in ("native", "torch"):
        w = qp.solve_sequence_qp(gram, q, delta, backend=backend, device="cpu").w
        assert w.min() >= -1e-6 and w.max() <= 1 + 1e-6
        assert np.abs(np.diff(w, axis=0)).max() <= delta + 1e-5
        assert objective(gram, q, w) <= res.fun + 1e-3 * (1 + abs(res.fun))


@pytest.mark.parametrize("backend", ["native", "torch"])
def test_optimization_problems_match_the_jax_package(backend):
    rng = np.random.default_rng(7)
    neutral = rng.standard_normal((90, 1))
    blendshapes = neutral + 0.3 * rng.standard_normal((90, 5))
    w_true = np.clip(0.5 + np.cumsum(rng.standard_normal((9, 5)) * 0.03, axis=0), 0.1, 0.9)
    verts = [neutral + (blendshapes - neutral) @ w[:, None] for w in w_true]
    tol = 1e-12 if backend == "native" else 1e-4
    full = qp.OptimizationProblemFull(neutral, blendshapes, backend=backend, device="cpu")
    np.testing.assert_allclose(full.optimize(verts, delta=0.1),
                               j_qp.OptimizationProblemFull(neutral, blendshapes).optimize(verts, delta=0.1),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(full.optimize(verts, delta=0.1), w_true, atol=5e-3)
    single = qp.OptimizationProblemSingle(neutral, blendshapes, backend=backend, device="cpu")
    np.testing.assert_allclose(single.optimize(verts[3]),
                               j_qp.OptimizationProblemSingle(neutral, blendshapes).optimize(verts[3]),
                               rtol=0, atol=tol)


def test_auto_falls_back_to_the_admm_with_the_build_error(monkeypatch):
    def broken():
        raise RuntimeError("native QP solver: g++ failed (1): <compiler output>")

    monkeypatch.setattr(native, "load", broken)
    gram, q, _ = problem(8, 30, 4, 5)
    with pytest.warns(UserWarning, match="compiler output"):
        got = qp.solve_sequence_qp(gram, q, 0.1, device="cpu")
    assert got.solver == "torch:cpu"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        qp.solve_sequence_qp(gram, q, 0.1, backend="native")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert qp.solve_sequence_qp(gram, q, 0.1, backend="torch", device="cpu").solver == "torch:cpu"


def test_native_library_lands_in_the_build_directory():
    native.load()
    path = native.library_path()
    assert path.is_file() and path.parent.parent == BUILD_ROOT and path.parent.name.startswith("qp-")
    assert not list((native._SRC.parent).glob("*.so"))
