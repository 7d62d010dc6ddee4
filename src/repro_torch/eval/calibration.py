"""Calibration metrics for the served posterior (NLL / ECE / coverage);
counterpart of ``repro.eval.calibration``, in numpy.

Serving K draws instead of one should give better predictive
distributions; these metrics score that. Every function takes plain
arrays (numpy, or host tensors numpy can read), computes in float64 and
returns a python float. Classification metrics take per-draw
probabilities ``probs_k`` of shape (K, N, C) (K = 1 for a point model);
the predictive distribution is the draw mean.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nll_categorical", "nll_gaussian_mixture", "ece_from_probs",
           "ece_binary", "interval_coverage"]


def _ndim(name: str, a: np.ndarray, n: int, shape: str) -> np.ndarray:
    if a.ndim != n:
        raise ValueError(f"{name} must be {shape}, got {a.shape}")
    return a


def _predictive(probs_k) -> np.ndarray:
    p = _ndim("probs_k", np.asarray(probs_k, np.float64), 3, "(K, N, C)")
    return p.mean(0)  # (N, C) Bayesian model average


def nll_categorical(probs_k, labels, *, eps: float = 1e-12) -> float:
    """Mean negative log-likelihood of ``labels`` (N,) under the ensemble
    predictive mean (log p_bar >= mean_k log p_k by Jensen)."""
    pred = _predictive(probs_k)
    labels = np.asarray(labels).astype(np.int64)
    p_true = pred[np.arange(pred.shape[0]), labels]
    return float(-np.mean(np.log(np.clip(p_true, eps, None))))


def ece_from_probs(probs_k, labels, *, n_bins: int = 15) -> float:
    """Expected calibration error of the predictive mean: confidence =
    max-prob, ``n_bins`` equal-width right-closed bins on [0, 1]
    (confidence 0 in the first), the bins' |accuracy - confidence|
    weighted by their counts (Guo et al.'s estimator)."""
    pred = _predictive(probs_k)
    labels = np.asarray(labels).astype(np.int64)
    conf = pred.max(-1)
    correct = (pred.argmax(-1) == labels).astype(np.float64)
    idx = np.clip(np.ceil(conf * n_bins).astype(np.int64) - 1, 0,
                  n_bins - 1)
    ece, n = 0.0, conf.shape[0]
    for b in range(n_bins):
        m = idx == b
        if m.any():
            ece += (m.sum() / n) * abs(correct[m].mean() - conf[m].mean())
    return float(ece)


def ece_binary(p1_k, labels, *, n_bins: int = 15) -> float:
    """``p1_k`` (K, N) per-draw P(y = 1) -> the two-column
    ``ece_from_probs``."""
    p1 = _ndim("p1_k", np.asarray(p1_k, np.float64), 2, "(K, N)")
    return ece_from_probs(np.stack([1.0 - p1, p1], -1), labels,
                          n_bins=n_bins)


def nll_gaussian_mixture(means_k, scales_k, targets) -> float:
    """Regression NLL under the K-component predictive mixture
    (1/K) sum_k N(y | mu_k, sigma_k^2); ``means_k``/``scales_k`` are
    (K, N). K = 1 is the plain Gaussian NLL."""
    mu = _ndim("means_k", np.asarray(means_k, np.float64), 2, "(K, N)")
    sig = np.asarray(scales_k, np.float64)
    if sig.shape != mu.shape:
        raise ValueError(f"scales_k {sig.shape} != means_k {mu.shape}")
    y = np.asarray(targets, np.float64)[None]
    logp_k = (-0.5 * ((y - mu) / sig) ** 2 - np.log(sig)
              - 0.5 * np.log(2 * np.pi))  # (K, N)
    m = logp_k.max(0)  # logsumexp over draws
    logp = m + np.log(np.exp(logp_k - m).mean(0))
    return float(-logp.mean())


def interval_coverage(samples, targets, *, level: float = 0.9) -> float:
    """Fraction of ``targets`` (N,) inside the central ``level``
    predictive interval of ``samples`` (K, N): about ``level`` for a
    calibrated posterior, less when overconfident, more when diffuse."""
    s = _ndim("samples", np.asarray(samples, np.float64), 2, "(K, N)")
    alpha = (1.0 - level) / 2
    lo = np.quantile(s, alpha, axis=0)
    hi = np.quantile(s, 1.0 - alpha, axis=0)
    y = np.asarray(targets, np.float64)
    return float(np.mean((y >= lo) & (y <= hi)))
