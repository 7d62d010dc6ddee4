"""MCMC convergence diagnostics: split-R-hat and effective sample size;
counterpart of ``repro.core.diagnostics``.

Chains are (C, N, ...) with C >= 1; statistics are per scalar dimension.
A non-finite trace would make every moment NaN, and a NaN R-hat reads like
a converged one in a ``< 1.01`` check, so ``rhat``/``ess``/``summarize``
refuse non-finite traces. ``mask`` (per-chain bool) excludes chains before
that check.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _select(chains: torch.Tensor, mask, who: str) -> torch.Tensor:
    """Apply the per-chain mask, then refuse non-finite traces."""
    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.shape != (chains.shape[0],):
            raise ValueError(
                f"health mask shape {mask.shape} != (n_chains,) = "
                f"({chains.shape[0]},)")
        if not mask.any():
            raise ValueError(
                f"{who}: health mask excludes every chain — no healthy "
                "chains to diagnose")
        chains = chains[torch.as_tensor(np.flatnonzero(mask),
                                        device=chains.device)]
    if not bool(torch.isfinite(chains).all()):
        raise ValueError(
            f"{who}: trace contains non-finite values — a NaN here would "
            "silently poison the statistic; pass mask= to exclude "
            "diverged chains.")
    return chains


def _split_chains(x: torch.Tensor) -> torch.Tensor:
    """(C, N, ...) -> (2C, N//2, ...); odd N drops the FIRST sample."""
    N = x.shape[1]
    if N % 2:
        x = x[:, 1:]
        N -= 1
    n = N // 2
    return torch.cat([x[:, :n], x[:, n:]], dim=0)


def rhat(chains: torch.Tensor, *, mask=None) -> torch.Tensor:
    """Split-R-hat per dimension. chains: (C, N, ...) -> (...); needs
    N >= 4."""
    chains = _select(chains, mask, "rhat")
    if chains.shape[1] < 4:
        raise ValueError(
            f"rhat needs >= 4 samples per chain (got N={chains.shape[1]}): "
            "split halves must each hold >= 2 samples")
    x = _split_chains(chains.to(torch.float32))
    N = x.shape[1]
    mean_c = x.mean(dim=1)
    var_c = x.var(dim=1, unbiased=True)
    W = var_c.mean(dim=0)
    B = N * mean_c.var(dim=0, unbiased=True)
    var_hat = (N - 1) / N * W + B / N
    return torch.sqrt(var_hat / torch.clamp(W, min=1e-30))


def ess(chains: torch.Tensor, max_lag: int = 200, *,
        mask=None) -> torch.Tensor:
    """Bulk effective sample size per dimension (initial-positive
    autocorrelation sum). ``max_lag`` is clamped to N//2 - 1 (floor 1)."""
    chains = _select(chains, mask, "ess")
    x = chains.to(torch.float32)
    C, N = x.shape[:2]
    xc = x - x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False).mean(dim=0)
    max_lag = min(max_lag, max(N // 2 - 1, 1))
    nfft = 2 * N
    f = torch.fft.rfft(xc, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :N] / N
    rhos = acov[:, 1:max_lag + 1].mean(dim=0) / torch.clamp(var, min=1e-30)
    positive = torch.cumprod((rhos > 0).to(rhos.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rhos * positive, dim=0)
    return C * N / torch.clamp(tau, min=1.0)


def summarize(chains: torch.Tensor, *,
              mask: Optional[np.ndarray] = None) -> dict:
    """Headline diagnostics for a (C, N, D) trace; with ``mask`` the
    statistics cover the masked-in chains and report the exclusions."""
    r = rhat(chains, mask=mask)
    e = ess(chains, mask=mask)
    out = {"max_rhat": float(r.max()), "min_ess": float(e.min()),
           "mean_ess": float(e.mean())}
    if mask is not None:
        m = np.asarray(mask, bool)
        out["n_healthy"] = int(m.sum())
        out["n_excluded"] = int((~m).sum())
    return out
