"""Federated stochastic-gradient Hamiltonian Monte Carlo with conducive
gradients (counterpart of ``repro.core.sghmc``).

Naive-Euler SGHMC with friction C = alpha_f / h:

    r'     = (1 - alpha_f) r + h * drift(theta) + sqrt(2 alpha_f T) sqrt(h) xi
    theta' = theta + r'

``drift`` is the FSGLD estimator stack itself (prior + scaled minibatch
gradient + conducive term), so its unbiasedness carries over unchanged.
The plain path draws xi from a ``torch.Generator``; the kernel path
(``use_kernel=True``) runs the fused kernel's SGHMC variant, which hashes
xi from one integer seed per leaf as the Langevin kernel path does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.sampler import (LogLikFn, ShardScheme,
                                      kernel_step_operands, make_drift_fn,
                                      tree_randn_like)
from repro_torch.core.surrogate import SurrogateBank

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SGHMCConfig:
    friction: float = 0.1   # alpha_f = C * h
    temperature: float = 1.0


def sghmc_update(theta: PyTree, r: PyTree, drift: PyTree, h,
                 generator: torch.Generator, hmc: SGHMCConfig, noise=None):
    """(theta', r') of one SGHMC step, xi drawn from ``generator`` leaf by
    leaf, or the caller's standard normals ``noise`` (the plain path; the
    fused kernel implements the same contract)."""
    a = hmc.friction
    noise_sig = math.sqrt(2.0 * a * hmc.temperature) * math.sqrt(h)
    xi = tree_randn_like(generator, theta) if noise is None else noise
    r = tu.tree_map(
        lambda rr, dd, nn: ((1.0 - a) * rr + h * dd.to(rr.dtype)
                            + noise_sig * nn.to(rr.dtype)),
        r, drift, xi)
    return tu.tree_map(lambda t, rr: t + rr, theta, r), r


def make_sghmc_step(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                    scheme: ShardScheme,
                    bank: Optional[SurrogateBank] = None,
                    hmc: SGHMCConfig = SGHMCConfig(),
                    use_kernel: bool = False):
    """Returns step((theta, r), generator, batch, shard_id, m,
    step_size=None, bank_rt=None) -> (theta', r') for one chain.

    cfg.method selects the drift ('sgld'/'dsgld' plain, 'fsgld' + the
    conducive term). ``use_kernel=True`` routes the update through the
    fused kernel's SGHMC variant: one integer seed per leaf is drawn from
    the generator and the kernel hashes the noise from it."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        resolve = kernel_step_operands(cfg, scheme, bank)

        def step(state, generator, batch, shard_id, m, step_size=None,
                 bank_rt=None):
            theta, r = state
            h = cfg.step_size if step_size is None else step_size
            gll = torch.func.grad(log_lik_fn)(theta, batch)
            scale, f_s, q_g, q_s = resolve(shard_id, m, bank_rt)
            seeds = kops.chain_leaf_seeds(generator, len(tu.leaves(theta)))
            return kops.fused_update_tree(
                theta, gll, seeds, h=h, scale=scale, f_s=f_s,
                prior_prec=cfg.prior_precision, alpha=cfg.alpha,
                temperature=hmc.temperature, q_global=q_g, q_shard=q_s,
                surrogate_kind=(bank.kind if bank is not None else None),
                momentum=r, friction=hmc.friction, dynamics="sghmc")

        return step

    drift_fn = make_drift_fn(log_lik_fn, cfg, scheme, bank)

    def step(state, generator, batch, shard_id, m, step_size=None,
             bank_rt=None):
        theta, r = state
        h = cfg.step_size if step_size is None else step_size
        d = drift_fn(theta, batch, shard_id, m, bank_rt)
        return sghmc_update(theta, r, d, h, generator, hmc)

    return step


def init_momentum(theta: PyTree) -> PyTree:
    return tu.tree_map(torch.zeros_like, theta)


@dataclasses.dataclass
class FederatedSGHMC:
    """Algorithm-1-style runtime for one federated SGHMC chain: T local
    steps per round on one client, i.i.d. categorical reassignment, the
    momenta carried with the chain (they are part of the chain state the
    paper would mail). Per round it draws, from ONE generator, the client,
    then per step the minibatch rows and the noise."""
    log_lik_fn: LogLikFn
    cfg: SamplerConfig
    shard_data: PyTree
    minibatch: int
    bank: Optional[SurrogateBank] = None
    hmc: SGHMCConfig = dataclasses.field(default_factory=SGHMCConfig)

    def __post_init__(self):
        leaf = tu.leaves(self.shard_data)[0]
        s, n = leaf.shape[0], leaf.shape[1]
        if s != self.cfg.num_shards:
            raise ValueError(f"shard_data holds {s} shards, the config "
                             f"{self.cfg.num_shards}")
        self.scheme = ShardScheme(sizes=(n,) * s, probs=self.cfg.probs())
        self.step_fn = make_sghmc_step(self.log_lik_fn, self.cfg,
                                       self.scheme, self.bank, self.hmc)

    def run(self, generator: torch.Generator, theta0: PyTree,
            num_rounds: int, collect_every: int = 1) -> PyTree:
        """The trace of theta, leaves (num_rounds * ceil(T /
        collect_every), ...)."""
        dev = generator.device
        probs = torch.as_tensor(self.scheme.probs_array(), device=dev)
        n_s = self.scheme.sizes[0]
        state = (theta0, init_momentum(theta0))
        out = []
        for _ in range(num_rounds):
            s = torch.multinomial(probs, 1, generator=generator)[0]
            data_s = tu.tree_map(lambda d: d[s], self.shard_data)
            for t in range(self.cfg.local_updates):
                idx = torch.randint(0, n_s, (self.minibatch,),
                                    generator=generator, device=dev)
                batch = tu.tree_map(lambda d: d[idx], data_s)
                state = self.step_fn(state, generator, batch, s,
                                     self.minibatch)
                if t % collect_every == 0:
                    out.append(state[0])
        return tu.tree_map(lambda *xs: torch.stack(xs), *out)
