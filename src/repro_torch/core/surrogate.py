"""Exponential-family surrogates q_s(theta) ~= p(x_s | theta) (paper Sec
3.1); counterpart of ``repro.core.surrogate``.

Four structures:

  'full'   — mean (P,), precision (P, P).     paper-scale models.
  'diag'   — mean (P,), precision (P,).       flat-vector parameters.
  'scalar' — pytree means + ONE precision scalar per tensor.
  'linear' — log q(theta) = b . theta, b stored as the mean (a pytree),
             zero precision: a control-variate surrogate.

Gaussians are closed under products, so the global surrogate
q = prod_s q_s has precision sum(Lambda_s) and natural parameter
sum(Lambda_s mu_s); the product of linear members is b_g = sum_s b_s. A
``SurrogateBank`` stacks the S shard surrogates along a leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tu

PyTree = Any
KINDS = ("diag", "scalar", "linear", "full")


def _kind_check(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown surrogate kind {kind!r}; pick from "
                         f"{KINDS}")


@dataclasses.dataclass
class Gaussian:
    """One surrogate: flat ``mean``/``prec`` vectors ('diag'), a flat mean
    and a (P, P) precision ('full'), a pytree of means with a scalar
    precision per leaf ('scalar'), or the pytree b of log q = b . theta in
    ``mean`` ('linear')."""
    mean: PyTree
    prec: PyTree
    kind: str = "diag"

    def grad_log(self, theta: PyTree) -> PyTree:
        """grad log q(theta) = -Lambda (theta - mu); 'linear': b."""
        _kind_check(self.kind)
        if self.kind == "linear":
            return self.mean
        if self.kind == "full":
            return -(self.prec @ (theta - self.mean))
        if self.kind == "diag":
            return -self.prec * (theta - self.mean)
        return tu.tree_map(lambda th, mu, lam: -lam * (th - mu.to(th.dtype)),
                           theta, self.mean, self.prec)

    def log_density(self, theta: PyTree) -> torch.Tensor:
        """Unnormalised log q(theta) (for diagnostics)."""
        _kind_check(self.kind)
        if self.kind == "linear":
            return sum(tu.leaves(tu.tree_map(lambda b, t: torch.sum(b * t),
                                             self.mean, theta)))
        if self.kind == "full":
            d = theta - self.mean
            return -0.5 * d @ (self.prec @ d)
        if self.kind == "diag":
            d = theta - self.mean
            return -0.5 * torch.sum(self.prec * d * d)
        return sum(tu.leaves(tu.tree_map(
            lambda th, mu, lam:
            -0.5 * lam * torch.sum((th - mu.to(th.dtype)) ** 2),
            theta, self.mean, self.prec)))


@dataclasses.dataclass
class SurrogateBank:
    """S stacked shard surrogates + the precomputed global product.
    means/precs carry a leading shard axis."""
    means: PyTree
    precs: PyTree
    global_: Gaussian
    kind: str = "diag"

    @property
    def num_shards(self) -> int:
        return tu.leaves(self.means)[0].shape[0]

    def shard(self, s) -> Gaussian:
        return Gaussian(tu.tree_map(lambda a: a[s], self.means),
                        tu.tree_map(lambda a: a[s], self.precs), self.kind)

    def astype(self, dtype) -> "SurrogateBank":
        """Bank with means STORED at ``dtype`` (e.g. bf16); precisions stay
        float32, and every gradient path upcasts means at use."""
        cast = lambda t: tu.tree_map(lambda l: l.to(dtype), t)  # noqa: E731
        return SurrogateBank(cast(self.means), self.precs,
                             Gaussian(cast(self.global_.mean),
                                      self.global_.prec, self.kind),
                             self.kind)

    def to(self, device, means_device=None) -> "SurrogateBank":
        """The bank on ``device``, its means (per-client and global) on
        ``means_device`` if given (e.g. the host); a leaf already there
        is kept, not copied."""
        mv = lambda t, d=device: tu.tree_map(  # noqa: E731
            lambda l: l.to(d), t)
        md = device if means_device is None else means_device
        return SurrogateBank(mv(self.means, md), mv(self.precs),
                             Gaussian(mv(self.global_.mean, md),
                                      mv(self.global_.prec), self.kind),
                             self.kind)


def make_bank(means: PyTree, precs: PyTree, kind: str,
              store_dtype=None) -> SurrogateBank:
    """Bank from stacked per-shard means/precisions, with the product-
    Gaussian global surrogate computed in the input dtype before any
    ``store_dtype`` cast of the means."""
    _kind_check(kind)
    if kind == "linear":
        # the product of linear members: b_g = sum_s b_s
        mean_g = tu.tree_map(lambda b: b.sum(0), means)
        prec_g = tu.tree_map(lambda b: torch.zeros(b.shape[1:],
                                                   dtype=b.dtype,
                                                   device=b.device), means)
    elif kind == "full":
        prec_g = precs.sum(0)                              # (P, P)
        nat = torch.einsum("spq,sq->p", precs, means)
        mean_g = torch.linalg.solve(prec_g, nat)
    elif kind == "diag":
        prec_g = precs.sum(0)
        mean_g = (precs * means).sum(0) / torch.clamp(prec_g, min=1e-12)
    else:
        prec_g = tu.tree_map(lambda lam: lam.sum(0), precs)
        mean_g = tu.tree_map(
            lambda mu, lam, lg: (
                (lam.reshape((-1,) + (1,) * (mu.ndim - 1)) * mu).sum(0)
                / torch.clamp(lg, min=1e-12)).to(mu.dtype),
            means, precs, prec_g)
    bank = SurrogateBank(means, precs, Gaussian(mean_g, prec_g, kind), kind)
    return bank if store_dtype is None else bank.astype(store_dtype)


# ---------------------------------------------------------------------------
# fitting surrogates from local samples (paper Sec 3.1 / Sec 5)
# ---------------------------------------------------------------------------

def fit_gaussian(samples: torch.Tensor, kind: str, jitter: float = 1e-6,
                 likelihood_only: bool = True, prior_prec: float = 0.0):
    """Fit one Gaussian, 'full' (the unbiased sample covariance + jitter,
    inverted) or 'diag' (the population variance + jitter), to
    (n_samples, P) draws. With ``likelihood_only=False`` and
    ``prior_prec > 0`` the zero-mean prior's precision is subtracted in
    natural parameters (the draws targeted prior * likelihood). Returns
    (mean, precision)."""
    mu = samples.mean(0)
    if kind == "full":
        eye = torch.eye(samples.shape[1], dtype=samples.dtype,
                        device=samples.device)
        cov = torch.atleast_2d(torch.cov(samples.T)) + jitter * eye
        prec = torch.linalg.inv(cov)
        if not likelihood_only and prior_prec > 0:
            prec_l = prec - prior_prec * eye
            nat = prec @ mu
            mu = torch.linalg.solve(prec_l + jitter * eye, nat)
            prec = prec_l
        return mu, prec
    if kind == "diag":
        prec = 1.0 / (samples.var(0, unbiased=False) + jitter)
        if not likelihood_only and prior_prec > 0:
            prec_l = torch.clamp(prec - prior_prec, min=jitter)
            mu = (prec * mu) / prec_l
            prec = prec_l
        return mu, prec
    raise ValueError(kind)


def fit_scalar_tree(sample_tree: PyTree, jitter: float = 1e-6):
    """Per-tensor isotropic Gaussians: leaves are (n_samples, *shape).
    Returns (means pytree, scalar precisions pytree)."""
    means = tu.tree_map(lambda s: s.mean(0), sample_tree)
    precs = tu.tree_map(
        lambda s: 1.0 / (s.var(0, unbiased=False).mean() + jitter),
        sample_tree)
    return means, precs


class RunningMoments:
    """Streaming form of ``fit_scalar_tree`` ('scalar') and of
    ``fit_gaussian(..., 'diag')`` ('diag') over a trace seen one sample
    at a time, so no trace is held. Welford's update runs on the
    deviations from ``shift`` (a pytree like the samples; default: a copy
    of the first sample), which keeps the variance exact to float32
    rounding when it is far smaller than the mean: per element the mean
    deviation, in the samples' dtype, on buffers this object owns; the
    sum of squared deviations M2 per element for 'diag', and summed over
    each leaf in float64 for 'scalar' (whose estimator needs only the
    leaf's mean variance)."""

    def __init__(self, kind: str, shift: PyTree = None):
        if kind not in ("diag", "scalar"):
            raise ValueError(f"running moments fit 'diag' or 'scalar', "
                             f"not {kind!r}")
        self.kind = kind
        self.shift = shift
        self.n = 0
        self.mean = None
        self.m2 = None

    def update(self, sample: PyTree) -> None:
        if self.shift is None:
            self.shift = tu.tree_map(lambda x: x.detach().clone(), sample)
        leaves, treedef = tu.flatten(sample)
        shifts = tu.leaves(self.shift)
        if self.mean is None:
            self.mean = tu.unflatten(treedef, [torch.zeros_like(x)
                                               for x in leaves])
            self.m2 = tu.unflatten(treedef, [
                torch.zeros_like(x) if self.kind == "diag" else
                torch.zeros((), dtype=torch.float64, device=x.device)
                for x in leaves])
        self.n += 1
        new_m2 = []
        for x, c, mu, m2 in zip(leaves, shifts, tu.leaves(self.mean),
                                tu.leaves(self.m2)):
            d = x - c
            delta = d - mu
            mu.add_(delta / self.n)
            dev = d.sub_(mu).mul_(delta)
            new_m2.append(m2.add_(dev) if self.kind == "diag"
                          else m2 + dev.sum(dtype=torch.float64))
        self.m2 = tu.unflatten(treedef, new_m2)

    def finish(self, jitter: float = 1e-6):
        """(means, precisions): 'scalar' 1 / (mean over the leaf of the
        per-element population variance + jitter), a float32 scalar per
        leaf; 'diag' 1 / (variance + jitter) per element. The means are
        this object's buffers (shift added in place)."""
        means = tu.tree_map(lambda mu, c: mu.add_(c), self.mean, self.shift)
        if self.kind == "diag":
            precs = tu.tree_map(lambda m2: 1.0 / (m2 / self.n + jitter),
                                self.m2)
        else:
            precs = tu.tree_map(
                lambda m2, mu: (1.0 / (m2 / (self.n * mu.numel()) + jitter)
                                ).to(torch.float32), self.m2, means)
        return means, precs


def analytic_gaussian_likelihood_surrogate(xs: torch.Tensor,
                                           obs_var: float = 1.0):
    """Exact likelihood surrogate for the Sec 5.1 model N(x | mu, I):
    mean xbar_s, precision (N_s / obs_var) I (diag)."""
    n = xs.shape[0]
    mu = xs.mean(0)
    return mu, torch.full_like(mu, n / obs_var)
