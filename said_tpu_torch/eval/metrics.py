"""Quality metrics over BCVAE latents (reference ``said/metric/``).

The port's copy of ``said_tpu.eval.metrics``:

- Fréchet distance: ||μ1 − μ2||² + Tr(Σ1 + Σ2 − 2(Σ1Σ2)^½), scipy's
  ``sqrtm`` with pytorch-fid's eps-regularised fallback;
- WInD: a Gaussian mixture (K components) fit to each latent set, the
  pairwise FD between components, then the optimal-transport LP over the
  component weights (scipy's ``linprog``, HiGHS; the reference uses
  GLPK);
- multimodality: the mean L2 distance between paired generations' latents;
- beat consistency: audio onsets against kinematic beats, the minima of
  the mean-normalised |Δcoeffs|.

The one difference: the JAX package fits the mixture with sklearn, which
the machine with the card lacks. ``get_statistic_gmm`` fits it in torch,
in float64 on the caller's device, with sklearn's ``GaussianMixture``
defaults (full covariances, ``reg_covar`` 1e-6, ``tol`` 1e-3 on the
per-sample lower bound, ``max_iter`` 100, one init from k-means: k-means++
seeding, then Lloyd iterations to sklearn's ``KMeans`` tolerance), its
random draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy import linalg

from said_tpu_torch.utils.audio import compute_audio_beat_time


@dataclasses.dataclass
class Statistic:
    mean: np.ndarray
    cov: np.ndarray


@dataclasses.dataclass
class StatisticGMM:
    mean: np.ndarray
    cov: np.ndarray
    weight: float


def get_statistic(data: Sequence[np.ndarray]) -> Statistic:
    arr = np.asarray(data)
    return Statistic(mean=arr.mean(axis=0), cov=np.cov(arr, rowvar=False))


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (pytorch-fid numerics)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):  # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if isinstance(covmean, tuple):
            covmean = covmean[0]

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances between rows of x (n, d) and c (k, d)."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ c.T + (c * c).sum(1)).clamp(min=0.0)


def _kmeans_labels(x: torch.Tensor, k: int, generator: Optional[torch.Generator], max_iter: int = 300,
                   tol: float = 1e-4) -> torch.Tensor:
    """sklearn ``KMeans(k, n_init=1)``'s labels: greedy k-means++ seeding
    (2 + ⌊ln k⌋ candidates a center), then Lloyd iterations until the
    labels repeat or the centers move by at most ``tol`` times the data's
    mean variance (summed squared shift); an emptied cluster keeps its
    center."""
    n = x.shape[0]
    tol = tol * float(x.var(dim=0, unbiased=False).mean())
    trials = 2 + int(math.log(k))
    first = int(torch.randint(n, (1,), generator=generator, device=x.device))
    centers = [x[first]]
    closest = _sq_dist(x, x[first : first + 1])[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        r = torch.rand(trials, generator=generator, dtype=x.dtype, device=x.device) * pot
        cand = torch.searchsorted(torch.cumsum(closest, 0), r).clamp(max=n - 1)
        dist = torch.minimum(closest[None], _sq_dist(x[cand], x))
        pots = dist.sum(1)
        best = int(pots.argmin())
        pot, closest = pots[best], dist[best]
        centers.append(x[cand[best]])
    centers = torch.stack(centers)
    labels = None
    for _ in range(max_iter):
        new_labels = _sq_dist(x, centers).argmin(1)
        one_hot = torch.nn.functional.one_hot(new_labels, k).to(x.dtype)
        counts = one_hot.sum(0)[:, None]
        new_centers = torch.where(counts > 0, one_hot.T @ x / counts.clamp(min=1.0), centers)
        shift = float(((new_centers - centers) ** 2).sum())
        centers = new_centers
        if labels is not None and torch.equal(new_labels, labels):
            break
        labels = new_labels
        if shift <= tol:
            break
    return _sq_dist(x, centers).argmin(1)


def _gaussian_parameters(x: torch.Tensor, resp: torch.Tensor, reg_covar: float):
    """sklearn's ``_estimate_gaussian_parameters`` (full covariances):
    (Σ resp + 10 eps, means, covariances + reg_covar·I)."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = resp.T @ x / nk[:, None]
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    covs = torch.stack([((resp[:, j : j + 1] * (x - means[j])).T @ (x - means[j])) / nk[j] + reg_covar * eye
                        for j in range(resp.shape[1])])
    return nk, means, covs


def _log_resp(x: torch.Tensor, weights: torch.Tensor, means: torch.Tensor, covs: torch.Tensor):
    """The E-step: the mean per-sample log-likelihood and log responsibilities."""
    chol = torch.linalg.cholesky(covs)
    d = x.shape[1]
    log_prob = torch.stack([
        -0.5 * (d * math.log(2 * math.pi)
                + (torch.linalg.solve_triangular(chol[j], (x - means[j]).T, upper=False) ** 2).sum(0))
        - torch.log(torch.diagonal(chol[j])).sum()
        for j in range(means.shape[0])], dim=1) + torch.log(weights)
    norm = torch.logsumexp(log_prob, dim=1)
    return norm.mean(), log_prob - norm[:, None]


def get_statistic_gmm(data: Sequence[np.ndarray], num_clusters: int, generator: Optional[torch.Generator] = None,
                      device: Optional[torch.device] = None, reg_covar: float = 1e-6, tol: float = 1e-3,
                      max_iter: int = 100) -> List[StatisticGMM]:
    """A ``num_clusters``-component full-covariance Gaussian mixture fit to
    ``data`` by EM (sklearn ``GaussianMixture``'s defaults), in float64 on
    ``device``; ``generator`` (on that device) seeds k-means."""
    x = torch.as_tensor(np.asarray(data), dtype=torch.float64, device=device)
    resp = torch.nn.functional.one_hot(_kmeans_labels(x, num_clusters, generator), num_clusters).to(x.dtype)
    nk, means, covs = _gaussian_parameters(x, resp, reg_covar)
    weights = nk / x.shape[0]
    lower = -math.inf
    for _ in range(max_iter):
        prev = lower
        lower_t, log_resp = _log_resp(x, weights, means, covs)
        nk, means, covs = _gaussian_parameters(x, torch.exp(log_resp), reg_covar)
        weights = nk / nk.sum()
        lower = float(lower_t)
        if abs(lower - prev) < tol:
            break
    means, covs, weights = means.cpu().numpy(), covs.cpu().numpy(), weights.cpu().numpy()
    return [StatisticGMM(mean=means[c], cov=covs[c], weight=weights[c]) for c in range(num_clusters)]


def wind(stats1: List[StatisticGMM], stats2: List[StatisticGMM]) -> float:
    """Wasserstein Inception Distance between two GMMs.

    Transport LP: min Σ_jk d_jk x_jk s.t. Σ_k x_jk ≤ w1_j, Σ_j x_jk ≤ w2_k,
    Σ x = 1, x ≥ 0, d_jk the components' Fréchet distance.
    """
    from scipy.optimize import linprog

    k1, k2 = len(stats1), len(stats2)
    d = np.zeros((k1, k2))
    for j in range(k1):
        for k in range(k2):
            d[j, k] = frechet_distance(stats1[j].mean, stats1[j].cov, stats2[k].mean, stats2[k].cov)

    a_ub = np.zeros((k1 + k2, k1 * k2))
    for j in range(k1):
        a_ub[j, j * k2 : (j + 1) * k2] = 1.0
    for k in range(k2):
        a_ub[k1 + k, k::k2] = 1.0
    b_ub = np.array([s.weight for s in stats1] + [s.weight for s in stats2])
    res = linprog(d.reshape(-1), A_ub=a_ub, b_ub=b_ub, A_eq=np.ones((1, k1 * k2)), b_eq=np.ones(1),
                  bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"WInD transport LP failed: {res.message}")
    return float(res.fun)


def multimodality(latents_subset1: Sequence[np.ndarray], latents_subset2: Sequence[np.ndarray]) -> float:
    """Mean L2 distance between paired generations' latents."""
    if len(latents_subset1) == 0 or len(latents_subset2) == 0:
        return 0.0
    return float(np.mean(np.linalg.norm(np.asarray(latents_subset1) - np.asarray(latents_subset2), axis=1)))


def beat_consistency_score(list_waveform: Sequence[np.ndarray], list_blendshape_coeffs: Sequence[np.ndarray],
                           sampling_rate: int, fps: int, threshold: float, sigma: float = 0.1) -> float:
    """exp(−min-dist²/2σ²) agreement between audio and kinematic beats.

    Kinematic beats: local minima of the mean-normalised coefficient
    change rate whose left or right prominence exceeds ``threshold``
    (reference ``said/metric/beat_consistency.py:39-79``).
    """
    from scipy.signal import find_peaks

    list_audio_beats = [compute_audio_beat_time(w, sampling_rate) for w in list_waveform]
    list_diff = [np.abs(c[1:] - c[:-1]) for c in list_blendshape_coeffs]
    mac = np.mean([d.mean(0) for d in list_diff], axis=0, keepdims=True)
    list_rate = [np.mean(d / mac, axis=1) for d in list_diff]

    list_kinematic_beats = []
    for rate in list_rate:
        idx, heights = find_peaks(-rate, threshold=0)
        mask = np.logical_or(heights["left_thresholds"] > threshold, heights["right_thresholds"] > threshold)
        list_kinematic_beats.append(idx[mask] / fps)

    scores = []
    for audio_beats, kin_beats in zip(list_audio_beats, list_kinematic_beats):
        s = 0.0
        if len(kin_beats) > 0 and len(audio_beats) > 0:
            dist2 = np.power(audio_beats[:, None] - kin_beats[None, :], 2).min(axis=1)
            s = float(np.mean(np.exp(-dist2 / (2 * sigma**2))))
        scores.append(s)
    return float(np.mean(scores))
