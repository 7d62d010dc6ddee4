"""Client-side surrogate fitting (paper Sec 3.1, App. F.2); counterpart of
the fitting half of ``repro.core.federated``.

``sample_local_likelihood`` and the Fisher fits are batched over the
client axis S with ``torch.func.vmap`` and, for per-example gradients,
over a chunk of examples as well, so one call runs all clients at once on
the device. ``local_sgld_moments`` runs ONE client and keeps only running
moments, for parameter trees too large to hold S chains and their traces
(the transformer posteriors).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.func import grad, vmap

from repro_torch import tree as tu
from repro_torch.core.sampler import LogLikFn
from repro_torch.core.surrogate import (RunningMoments, SurrogateBank,
                                        make_bank)

PyTree = Any


def sample_local_likelihood(log_lik_fn: LogLikFn, shard_data: PyTree,
                            theta0: PyTree, generator: torch.Generator, *,
                            minibatch: int, step_size: float, num_steps: int,
                            burn_in: int, thin: int = 10,
                            prior_precision: float = 0.0) -> PyTree:
    """SGLD run independently per shard against p_s ∝ p(x_s|theta)
    (optionally tempered by a weak prior), all shards in one batch.
    Returns samples with leaves (S, n_kept, ...): steps burn_in,
    burn_in + thin, ..."""
    leaf = tu.leaves(shard_data)[0]
    S, n_s = leaf.shape[0], leaf.shape[1]
    dev = leaf.device
    rows = torch.arange(S, device=dev)[:, None]
    thetas = tu.tree_map(
        lambda t: torch.broadcast_to(t, (S,) + t.shape).clone(), theta0)
    grad_v = vmap(grad(log_lik_fn))
    sig = math.sqrt(step_size)
    kept = []
    for t in range(num_steps):
        idx = torch.randint(0, n_s, (S, minibatch), generator=generator,
                            device=dev)
        batch = tu.tree_map(lambda d: d[rows, idx], shard_data)
        g = grad_v(thetas, batch)
        thetas = tu.tree_map(
            lambda th, gg: th + (step_size / 2) * (
                -prior_precision * th + (n_s / minibatch) * gg.to(th.dtype))
            + sig * torch.randn(th.shape, generator=generator, device=dev,
                                dtype=th.dtype),
            thetas, g)
        if t >= burn_in and (t - burn_in) % thin == 0:
            kept.append(thetas)
    return tu.tree_map(lambda *xs: torch.stack(xs, 1), *kept)


def local_sgld_moments(log_lik_fn: LogLikFn, client_data: PyTree,
                       theta0: PyTree, generator: torch.Generator, *,
                       minibatch: int, step_size: float, num_steps: int,
                       burn_in: int, kind: str = "scalar") -> RunningMoments:
    """SGLD of ONE client against its local likelihood (no prior), from
    ``theta0``: ``num_steps`` steps theta <- theta + (h/2) (n/m) grad +
    sqrt(h) xi (the reference's local step, ``repro/api.py``
    ``fit_bank_local_sgld``), updating one chain in place; the running
    moments of steps burn_in, burn_in + 1, ... (deviations from theta0).
    ``client_data``: leaves (n, ...) on the generator's device. Draws per
    step, in order: the m minibatch rows in [0, n), then the normals of
    every leaf in the tree's (sorted-key) order."""
    leaf = tu.leaves(client_data)[0]
    n, dev = leaf.shape[0], leaf.device
    theta = tu.tree_map(lambda t: t.detach().clone(), theta0)
    coef, sig = (step_size / 2) * (n / minibatch), math.sqrt(step_size)
    grad_fn = grad(log_lik_fn)
    moments = RunningMoments(kind, shift=theta0)
    for t in range(num_steps):
        idx = torch.randint(0, n, (minibatch,), generator=generator,
                            device=dev)
        g = grad_fn(theta, tu.tree_map(lambda d: d[idx], client_data))
        for th, gg in zip(tu.leaves(theta), tu.leaves(g)):
            th.add_(gg.to(th.dtype), alpha=coef)
            th.add_(torch.randn(th.shape, generator=generator, device=dev,
                                dtype=th.dtype), alpha=sig)
        del g
        if t >= burn_in:
            moments.update(theta)
    return moments


def _per_example_grads(log_lik_fn, shard_data, thetas, batch, shared):
    """Yields (S, b, ...) per-example gradient chunks: example i of shard
    s at ``thetas[s]`` (or the one shared ``thetas``), each example given
    to ``log_lik_fn`` as a batch of one."""
    n_s = tu.leaves(shard_data)[0].shape[1]

    def one(theta, item):
        return grad(log_lik_fn)(theta, tu.tree_map(lambda a: a[None], item))

    per_shard = vmap(one, in_dims=(None, 0))
    fn = vmap(per_shard, in_dims=(None if shared else 0, 0))
    for start in range(0, n_s, batch):
        chunk = tu.tree_map(lambda d: d[:, start:start + batch], shard_data)
        yield fn(thetas, chunk)


def fit_bank_fisher(log_lik_fn: LogLikFn, shard_data: PyTree,
                    means: torch.Tensor, jitter: float = 1e-3,
                    batch: int = 256,
                    tie_precisions: bool = False) -> SurrogateBank:
    """Laplace-style surrogates: q_s = N(mu_s, Lambda_s^-1) with Lambda_s
    the DIAGONAL EMPIRICAL FISHER of the local likelihood at mu_s,
    sum_i grad log p(x_i|mu_s)^2 + jitter. ``means``: (S, P) flat.
    ``batch`` examples per shard go through one vmapped gradient pass.
    ``tie_precisions`` shares the per-dimension mean Fisher across
    shards."""
    precs = torch.zeros_like(means)
    for g in _per_example_grads(log_lik_fn, shard_data, means, batch,
                                shared=False):
        precs = precs + (g * g).sum(1)
    precs = precs + jitter
    if tie_precisions:
        precs = torch.broadcast_to(precs.mean(0, keepdim=True),
                                   precs.shape).clone()
    return make_bank(means, precs, "diag")


def refresh_bank(log_lik_fn: LogLikFn, shard_data: PyTree,
                 theta: torch.Tensor, jitter: float = 1e-3,
                 batch: int = 256) -> SurrogateBank:
    """Surrogates re-fitted at the chain position theta (flat):
    Lambda_s = CENTERED diag empirical Fisher sum_i (g_i - g_bar)^2 and
    mu_s = theta + Lambda_s^{-1} grad log p(x_s | theta), so that
    grad log q_s(theta) == grad log p(x_s|theta) at theta."""
    n_s = tu.leaves(shard_data)[0].shape[1]
    S = tu.leaves(shard_data)[0].shape[0]
    gsum = torch.zeros((S,) + theta.shape, dtype=theta.dtype,
                       device=theta.device)
    g2 = torch.zeros_like(gsum)
    for g in _per_example_grads(log_lik_fn, shard_data, theta, batch,
                                shared=True):
        gsum = gsum + g.sum(1)
        g2 = g2 + (g * g).sum(1)
    centered = g2 - gsum * gsum / n_s
    precs = torch.clamp(centered, min=0.0) + jitter
    mus = theta[None] + gsum / precs
    return make_bank(mus, precs, "diag")
