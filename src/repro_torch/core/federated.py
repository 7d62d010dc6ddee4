"""Client-side surrogate fitting (paper Sec 3.1, App. F.2) and the
host-loop oracle ``FederatedSampler``; counterpart of
``repro.core.federated``.

``sample_local_likelihood`` and the Fisher fits are batched over the
client axis S with ``torch.func.vmap`` and, for per-example gradients,
over a chunk of examples as well, so one call runs all clients at once on
the device. ``local_sgld_moments`` runs ONE client and keeps only running
moments, for parameter trees too large to hold S chains and their traces
(the transformer posteriors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.func import grad, vmap

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.engine import draw_round
from repro_torch.core.sampler import (LogLikFn, ShardScheme,
                                      kernel_step_operands, langevin_update,
                                      make_drift_fn)
from repro_torch.core.sghmc import SGHMCConfig, init_momentum, sghmc_update
from repro_torch.core.surrogate import (RunningMoments, SurrogateBank,
                                        fit_gaussian, make_bank)

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


def _client_score_stats(log_lik_fn: LogLikFn, data_s: PyTree,
                        theta: torch.Tensor, n_s: int, batch: int):
    """One client's (sum_i g_i, sum_i (g_i - g_bar)^2) over its live prefix
    [0, n_s) of per-example scores at theta (flat), ``batch`` examples per
    vmapped gradient pass, the chunks summed in order. Pad rows (NaN by
    ``pad_shards``) are masked with a where, never multiplied away."""
    max_n = tu.leaves(data_s)[0].shape[0]

    def one(item):
        return grad(log_lik_fn)(theta, tu.tree_map(lambda a: a[None], item))

    per_example = vmap(one)
    gsum = torch.zeros_like(theta)
    g2 = torch.zeros_like(theta)
    for start in range(0, min(n_s, max_n), batch):
        stop = min(start + batch, n_s)
        g = per_example(tu.tree_map(lambda d: d[start:stop], data_s))
        gsum = gsum + g.sum(0)
        g2 = g2 + (g * g).sum(0)
    return gsum, g2 - gsum * gsum / n_s


def refresh_stats(log_lik_fn: LogLikFn, shard_data: PyTree,
                  theta: torch.Tensor, clients, sizes, batch: int = 256):
    """(S', P) score sums and centered Fishers of the clients ``clients``
    (an iterable of indices into the (S, max_n, ...) stack), one client at
    a time: a client's statistics do not depend on which others are
    computed with it, so a refresh split over ranks is bitwise the serial
    one."""
    out = [_client_score_stats(log_lik_fn,
                               tu.tree_map(lambda d: d[s], shard_data),
                               theta, int(sizes[s]), batch)
           for s in clients]
    return (torch.stack([g for g, _ in out]),
            torch.stack([c for _, c in out]))


def bank_from_stats(theta: torch.Tensor, gsum: torch.Tensor,
                    centered: torch.Tensor,
                    jitter: float = 1e-3) -> SurrogateBank:
    """The refreshed 'diag' bank: Lambda_s = max(centered Fisher, 0) +
    jitter, mu_s = theta + Lambda_s^{-1} sum_i g_i."""
    precs = torch.clamp(centered, min=0.0) + jitter
    return make_bank(theta[None] + gsum / precs, precs, "diag")


def refresh_bank(log_lik_fn: LogLikFn, shard_data: PyTree,
                 theta: torch.Tensor, jitter: float = 1e-3,
                 batch: int = 256, sizes=None) -> SurrogateBank:
    """Surrogates re-fitted at the chain position theta (flat):
    Lambda_s = CENTERED diag empirical Fisher sum_i (g_i - g_bar)^2 and
    mu_s = theta + Lambda_s^{-1} grad log p(x_s | theta), so that
    grad log q_s(theta) == grad log p(x_s|theta) at theta. ``sizes``: each
    client's live prefix (None: every row of the padded stack)."""
    S, max_n = tu.leaves(shard_data)[0].shape[:2]
    sizes = (max_n,) * S if sizes is None else tuple(sizes)
    gsum, centered = refresh_stats(log_lik_fn, shard_data, theta, range(S),
                                   sizes, batch)
    return bank_from_stats(theta, gsum, centered, jitter)


def fit_bank_linear(log_lik_fn: LogLikFn, shard_data: PyTree,
                    theta_ref: PyTree, batch: int = 256) -> SurrogateBank:
    """Linear (control-variate) surrogates, log q_s(theta) = b_s . theta
    with b_s = grad log p(x_s | theta_ref): the conducive gradient becomes
    the CONSTANT sum_s' b_s' - b_s / f_s, zero-mean and bounded. One
    full-shard gradient pass per client, all clients at once: the
    gradients of the chunks of ``batch`` rows summed in chunk order, then
    the tail's added (the reference's order)."""
    n_s = tu.leaves(shard_data)[0].shape[1]
    grad_v = vmap(grad(log_lik_fn), in_dims=(None, 0))
    nb = n_s // batch
    chunks = [grad_v(theta_ref, tu.tree_map(
        lambda d: d[:, i * batch:(i + 1) * batch], shard_data))
        for i in range(nb)]
    total = (tu.tree_map(lambda *gs: torch.stack(gs).sum(0), *chunks)
             if chunks else None)
    if n_s - nb * batch:
        tail = grad_v(theta_ref, tu.tree_map(lambda d: d[:, nb * batch:],
                                             shard_data))
        total = tail if total is None else tu.tree_map(torch.add, total,
                                                       tail)
    return make_bank(total, tu.tree_map(torch.zeros_like, total), "linear")


def fit_bank_from_samples(samples_flat: torch.Tensor, kind: str,
                          jitter: float = 1e-6,
                          max_prec: Optional[float] = None) -> SurrogateBank:
    """(S, n, P) flat-vector samples -> a 'diag' or 'full' bank, one
    ``fit_gaussian`` per client. ``max_prec`` clips the precisions
    elementwise: under-mixed local chains overestimate them, and a too
    sharp q_s pushes h * Lambda_s / f_s past the Langevin stability limit
    (a safe choice is ~0.5 * f_min / h); Lemma 1 holds for any q."""
    fits = [fit_gaussian(s, kind, jitter) for s in samples_flat]
    mus = torch.stack([m for m, _ in fits])
    precs = torch.stack([p for _, p in fits])
    if max_prec is not None:
        precs = torch.clamp(precs, max=max_prec)
    return make_bank(mus, precs, kind)


# ---------------------------------------------------------------------------
# the host-loop oracle
# ---------------------------------------------------------------------------

def _minibatch(shard_data: PyTree, shard_id: int, idx: torch.Tensor
               ) -> PyTree:
    """Rows ``idx`` of client ``shard_id``."""
    return tu.tree_map(lambda d: d[shard_id][idx], shard_data)


@dataclasses.dataclass
class FederatedSampler:
    """The ``run_vmap`` ORACLE the chain engine is held against: a host
    loop over rounds, steps and chains, a test fixture (production code
    goes through ``repro_torch.api.FSGLD``).

    shard_data: pytree with leaves (S, N_s, ...), equally sized shards.
    Each round takes its randomness from ``core.engine.draw_round`` on the
    run's generator (client ids, minibatch rows, noise seeds), gathers
    each chain's minibatch from its client (centralized 'sgld': from the
    pooled data), and takes the gradients of the chain block under
    ``torch.func.vmap``. The plain update (``use_kernel=False``) draws its
    noise from the generator after the round's draws, so the oracle equals
    the engine's ``vmap`` executor bitwise; ``use_kernel=True`` launches
    the fused kernel once per chain and leaf with the round's seeds, which
    equals the ``per_leaf`` executor bitwise (a 'linear' or 'full' bank,
    which no kernel variant takes, raises ``ValueError`` from the kernel's
    operands there). ``dynamics='sghmc'`` carries
    (theta, momentum) chain state (``sghmc`` its config); the trace holds
    theta only."""
    log_lik_fn: LogLikFn
    cfg: SamplerConfig
    shard_data: PyTree
    minibatch: int
    bank: Optional[SurrogateBank] = None
    use_kernel: bool = False
    dynamics: str = "langevin"
    sghmc: Optional[SGHMCConfig] = None

    def __post_init__(self):
        leaf = tu.leaves(self.shard_data)[0]
        s, n = leaf.shape[0], leaf.shape[1]
        if s != self.cfg.num_shards:
            raise ValueError(f"shard_data holds {s} shards, the config "
                             f"{self.cfg.num_shards}")
        if self.dynamics not in ("langevin", "sghmc"):
            raise ValueError(f"unknown dynamics {self.dynamics!r}")
        if self.dynamics == "sghmc" and self.sghmc is None:
            self.sghmc = SGHMCConfig()
        self.scheme = ShardScheme(sizes=(n,) * s, probs=self.cfg.probs())
        self._use_bank(self.bank)

    def _use_bank(self, bank: Optional[SurrogateBank]) -> None:
        """Build the drift and the kernel's operands on ``bank`` (FSGLD
        only); a refresh installs its re-fitted bank here."""
        self.fsgld_bank = bank if self.cfg.method == "fsgld" else None
        self._drift = make_drift_fn(self.log_lik_fn, self.cfg, self.scheme,
                                    self.fsgld_bank)
        self._operands = kernel_step_operands(self.cfg, self.scheme,
                                              self.fsgld_bank)

    def _batch(self, idx: torch.Tensor, sids: torch.Tensor) -> PyTree:
        """One step's (C, m, ...) minibatch: (C, m) rows of each chain's
        client, or of the pooled data for centralized SGLD."""
        if self.cfg.method == "sgld":
            pooled = tu.tree_map(
                lambda d: d.reshape((-1,) + tuple(d.shape[2:])),
                self.shard_data)
            rows = [tu.tree_map(lambda d: d[i], pooled) for i in idx]
        else:
            rows = [_minibatch(self.shard_data, int(s), i)
                    for s, i in zip(sids.tolist(), idx)]
        return tu.tree_map(lambda *xs: torch.stack(xs), *rows)

    def _kernel_step(self, thetas, r, g, seeds, sids):
        """The fused update, one chain at a time."""
        from repro_torch.kernels import ops as kops
        hmc = self.sghmc if self.dynamics == "sghmc" else None
        outs = []
        for c in range(seeds.shape[0]):
            one = lambda t: tu.tree_map(lambda a: a[c], t)  # noqa: E731
            scale, f_s, q_g, q_s = self._operands(sids[c], self.minibatch)
            outs.append(kops.fused_update_tree(
                one(thetas), one(g), seeds[c], h=self.cfg.step_size,
                scale=scale, f_s=f_s, prior_prec=self.cfg.prior_precision,
                alpha=self.cfg.alpha,
                temperature=(hmc.temperature if hmc
                             else self.cfg.temperature),
                q_global=q_g, q_shard=q_s,
                surrogate_kind=(self.fsgld_bank.kind
                                if self.fsgld_bank is not None else None),
                momentum=one(r) if hmc else None,
                friction=hmc.friction if hmc else 0.0,
                dynamics=self.dynamics))
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        if hmc:
            return (tu.tree_map(stack, *[o[0] for o in outs]),
                    tu.tree_map(stack, *[o[1] for o in outs]))
        return tu.tree_map(stack, *outs), None

    def _round(self, thetas, r, draws, generator, collect_every):
        """Client-side Update: T local steps of every chain; returns the
        new state and the kept thetas."""
        m, sids = self.minibatch, draws.sids
        kept = []
        for t in range(self.cfg.local_updates):
            batch = self._batch(draws.idx[t], sids)
            if self.use_kernel:
                g = vmap(grad(self.log_lik_fn))(thetas, batch)
                thetas, r = self._kernel_step(thetas, r, g, draws.seeds[t],
                                              sids)
            else:
                d = vmap(lambda th, b, s: self._drift(th, b, s, m))(
                    thetas, batch, sids)
                if self.dynamics == "sghmc":
                    thetas, r = sghmc_update(thetas, r, d,
                                             self.cfg.step_size, generator,
                                             self.sghmc)
                else:
                    thetas = langevin_update(thetas, d, self.cfg.step_size,
                                             generator,
                                             self.cfg.temperature)
            if t % collect_every == 0:
                kept.append(thetas)
        return thetas, r, tu.tree_map(lambda *xs: torch.stack(xs, 1), *kept)

    def run_vmap(self, generator: torch.Generator, theta0: PyTree,
                 num_rounds: int, *, n_chains: int = 1,
                 reassign: str = "categorical", collect_every: int = 1,
                 refresh_every: Optional[int] = None) -> PyTree:
        """Server-side loop: ``num_rounds`` rounds of ``n_chains`` chains
        from ``theta0``. Returns the trace, leaves (n_chains, num_rounds *
        ceil(T / collect_every), ...). ``refresh_every`` (FSGLD, flat
        'diag' banks): at every round r > 0 with r % refresh_every == 0
        the bank is re-fitted at the chain mean (``refresh_bank``) and the
        rounds from there on use it; the constructor's bank is back in
        place when the call returns."""
        if refresh_every and self.dynamics == "sghmc":
            raise NotImplementedError(
                "adaptive refresh is not wired for sghmc dynamics")
        try:
            return self._run(generator, theta0, num_rounds, n_chains,
                             reassign, collect_every, refresh_every)
        finally:
            self._use_bank(self.bank)

    def _run(self, generator, theta0, num_rounds, n_chains, reassign,
             collect_every, refresh_every):
        C = n_chains
        thetas = tu.tree_map(
            lambda t: torch.broadcast_to(t, (C,) + t.shape).clone(), theta0)
        r = init_momentum(thetas) if self.dynamics == "sghmc" else None
        num_leaves = len(tu.leaves(thetas))
        out = []
        for rnd in range(num_rounds):
            if (refresh_every and self.cfg.method == "fsgld" and rnd > 0
                    and rnd % refresh_every == 0):
                # adaptive refresh: the surrogates re-fitted at the chain
                # mean (the fit draws nothing from the generator)
                self._use_bank(refresh_bank(
                    self.log_lik_fn, self.shard_data,
                    tu.tree_map(lambda t: t.mean(0), thetas)))
            draws = draw_round(generator, self.cfg, self.scheme, n_chains=C,
                               minibatch=self.minibatch,
                               num_leaves=num_leaves, reassign=reassign)
            thetas, r, trace = self._round(thetas, r, draws, generator,
                                           collect_every)
            out.append(trace)
        return tu.tree_map(lambda *xs: torch.cat(xs, 1), *out)
