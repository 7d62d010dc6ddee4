"""SGLD / DSGLD / FSGLD update rules (paper Eqs. 1-5, Algorithm 1);
counterpart of ``repro.core.sampler``. A step is

    theta' = theta + (h/2) * drift(theta, minibatch, s) + sqrt(h*tau) * xi

with drift:
    SGLD   : grad log p(theta) + (N/m)          grad log p(x^(m)|theta)
    DSGLD  : grad log p(theta) + (N_s/(f_s m))  grad log p(x_s^(m)|theta)
    FSGLD  : DSGLD + alpha * g_s(theta)                       [conducive]

Randomness comes from explicit ``torch.Generator``s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.conducive import conducive_gradient
from repro_torch.core.surrogate import SurrogateBank

PyTree = Any
LogLikFn = Callable[[PyTree, PyTree], torch.Tensor]  # (theta, batch) -> scalar


def tree_randn_like(generator: torch.Generator, tree: PyTree) -> PyTree:
    """Standard normals shaped like ``tree``, drawn leaf by leaf."""
    return tu.tree_map(
        lambda l: torch.randn(l.shape, generator=generator, device=l.device,
                              dtype=l.dtype), tree)


def langevin_update(theta: PyTree, drift: PyTree, h, generator,
                    temperature: float = 1.0, noise=None) -> PyTree:
    """theta + h/2 drift + N(0, h*tau I), the noise drawn from
    ``generator`` (or the standard normals ``noise``, drawn by the caller).
    Plain reference path; the fused kernel (``repro_torch.kernels.ops``)
    implements the same contract in one pass with hashed noise."""
    if noise is None:
        noise = tree_randn_like(generator, theta)
    sig = math.sqrt(h * temperature)
    return tu.tree_map(
        lambda t, d, n: t + (h / 2) * d.to(t.dtype) + (sig * n).to(t.dtype),
        theta, drift, noise)


def prior_grad(theta: PyTree, prior_precision: float) -> PyTree:
    """grad log N(theta | 0, lambda^-1 I) = -lambda * theta."""
    return tu.tree_map(lambda t: -prior_precision * t, theta)


@dataclasses.dataclass(frozen=True)
class ShardScheme:
    """Static shard metadata: sizes N_s and selection probs f_s (None =>
    uniform 1/S). Sizes may be non-uniform: stacked shard data is padded
    to the longest client and minibatch indices are drawn from each
    shard's live prefix only."""
    sizes: Any            # tuple | np.ndarray of int
    probs: Any            # tuple | np.ndarray | None
    # device tables, built once per device (10^6 clients: 8 MB each)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    @property
    def num_shards(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        if "total" not in self._cache:
            self._cache["total"] = int(np.asarray(self.sizes, np.int64).sum())
        return self._cache["total"]

    def probs_array(self) -> np.ndarray:
        """(S,) float32 selection probs on the host."""
        if self.probs is None:
            return np.full((self.num_shards,), 1.0 / self.num_shards,
                           np.float32)
        return np.asarray(self.probs, np.float32)

    def as_arrays(self, device=None):
        """((S,) float32 sizes, (S,) float32 probs) on ``device`` (built
        once per device; read-only)."""
        key = ("f32", None if device is None else torch.device(device))
        if key not in self._cache:
            self._cache[key] = (
                torch.as_tensor(np.asarray(self.sizes, np.float32),
                                device=device),
                torch.as_tensor(self.probs_array(), device=device))
        return self._cache[key]

    def sizes_array(self, device=None) -> torch.Tensor:
        """(S,) int64 true shard sizes (pre-padding; built once per
        device; read-only)."""
        key = ("i64", None if device is None else torch.device(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                np.asarray(self.sizes, np.int64), device=device)
        return self._cache[key]

    def starts_array(self, device=None) -> torch.Tensor:
        """(S,) exclusive prefix sum of sizes: each shard's offset in the
        virtual ragged concatenation (pooled SGLD sampling)."""
        sizes = self.sizes_array(device)
        return torch.cumsum(sizes, 0) - sizes


def _device_arrays(scheme: ShardScheme):
    """Returns arrays(device) -> (sizes_f32, probs_f32), built once per
    device so steps do not copy them from the host."""
    cache = {}

    def arrays(device):
        device = torch.device(device)
        if device not in cache:
            cache[device] = scheme.as_arrays(device)
        return cache[device]

    return arrays


def chain_scales(cfg: SamplerConfig, scheme: ShardScheme,
                 sids: torch.Tensor, minibatch: int):
    """Per-chain estimator factors for chains resident at clients
    ``sids``: (scale, f_s), each (C,) float32. DSGLD/FSGLD unbias by
    N_s/(f_s m) (paper Eq. 4); centralized SGLD scales by N/m."""
    C = sids.shape[0]
    if cfg.method == "sgld":
        return (torch.full((C,), scheme.total / minibatch,
                           dtype=torch.float32, device=sids.device),
                torch.ones((C,), dtype=torch.float32, device=sids.device))
    sizes_f, probs_f = scheme.as_arrays(sids.device)
    f_s = probs_f[sids]
    return sizes_f[sids] / (f_s * minibatch), f_s


def make_drift_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                  scheme: ShardScheme,
                  bank: Optional[SurrogateBank] = None) -> Callable:
    """Returns drift(theta, batch, shard_id, m, bank_rt=None, bank_id=None)
    -> pytree for ONE chain; ``shard_id`` is an integer tensor, so the
    function maps over a chain axis under ``torch.func.vmap``. ``bank_id``
    (default ``shard_id``) is the client's row in the bank (a streamed
    window's bank holds only the resident clients' rows)."""
    if cfg.method == "fsgld" and bank is None:
        raise ValueError("FSGLD needs a SurrogateBank")
    arrays = _device_arrays(scheme)

    def drift(theta, batch, shard_id, m, bank_rt=None, bank_id=None):
        b = bank_rt if bank_rt is not None else bank
        gll = grad(log_lik_fn)(theta, batch)
        if cfg.method == "sgld":
            scale, f_s = scheme.total / m, 1.0
        else:
            sz, pr = arrays(shard_id.device)
            f_s = pr[shard_id]
            scale = sz[shard_id] / (f_s * m)
        d = tu.tree_map(lambda p, g: p + scale * g.to(p.dtype),
                        prior_grad(theta, cfg.prior_precision), gll)
        if cfg.method == "fsgld":
            g_s = conducive_gradient(
                theta, b.global_,
                b.shard(shard_id if bank_id is None else bank_id), f_s,
                cfg.alpha)
            d = tu.tree_map(lambda a, c: a + c.to(a.dtype), d, g_s)
        return d

    return drift


def kernel_step_operands(cfg: SamplerConfig, scheme: ShardScheme,
                         bank: Optional[SurrogateBank]) -> Callable:
    """Per-step operand resolution for the fused-kernel step: returns
    resolve(shard_id, m, bank_rt=None) -> (scale, f_s, q_global, q_shard),
    the surrogates None for SGLD/DSGLD."""
    arrays = _device_arrays(scheme)

    def resolve(shard_id, m, bank_rt=None):
        b = bank_rt if bank_rt is not None else bank
        if cfg.method == "sgld":
            scale = torch.tensor(scheme.total / m, dtype=torch.float32)
            f_s = torch.tensor(1.0, dtype=torch.float32)
        else:
            sz, pr = arrays(shard_id.device)
            f_s = pr[shard_id]
            scale = sz[shard_id] / (f_s * m)
        if cfg.method == "fsgld":
            return scale, f_s, b.global_, b.shard(shard_id)
        return scale, f_s, None, None

    return resolve


def make_step_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                 scheme: ShardScheme, bank: Optional[SurrogateBank] = None,
                 use_kernel: bool = False) -> Callable:
    """Returns step(theta, generator, batch, shard_id, m, step_size=None,
    bank_rt=None) -> theta' for one chain.

    ``use_kernel=True`` routes the update through the fused kernel
    (``fused_update_tree``): one integer seed per leaf is drawn from the
    generator and the kernel hashes the noise from it. Otherwise the noise
    is drawn from the generator directly (``langevin_update``)."""
    drift_fn = make_drift_fn(log_lik_fn, cfg, scheme, bank)
    if not use_kernel:
        def step(theta, generator, batch, shard_id, m, step_size=None,
                 bank_rt=None):
            h = cfg.step_size if step_size is None else step_size
            d = drift_fn(theta, batch, shard_id, m, bank_rt)
            return langevin_update(theta, d, h, generator, cfg.temperature)
        return step

    from repro_torch.kernels import ops as kops
    resolve = kernel_step_operands(cfg, scheme, bank)

    def step(theta, generator, batch, shard_id, m, step_size=None,
             bank_rt=None):
        h = cfg.step_size if step_size is None else step_size
        gll = grad(log_lik_fn)(theta, batch)
        scale, f_s, q_g, q_s = resolve(shard_id, m, bank_rt)
        seeds = kops.chain_leaf_seeds(generator, len(tu.leaves(theta)))
        return kops.fused_update_tree(
            theta, gll, seeds, h=h, scale=scale, f_s=f_s,
            prior_prec=cfg.prior_precision, alpha=cfg.alpha,
            temperature=cfg.temperature, q_global=q_g, q_shard=q_s,
            surrogate_kind=(bank.kind if bank is not None else None))

    return step
