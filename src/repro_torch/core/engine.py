"""Multi-chain FSGLD runtime on one device (counterpart of
``repro.core.engine``).

A run is a host loop over communication rounds. Each round is split in
two so that the randomness can be handed in from outside:

  * ``draw_round(generator, ...) -> RoundDraws`` draws, from ONE
    ``torch.Generator`` and in this order, the chains' client ids (C,),
    the minibatch indices (T, C, m) — uniform over each chain's live
    prefix [0, N_s), never into the pad — and the per-(step, chain, leaf)
    noise seeds (T, C, L) in [0, 2^31 - 1);
  * a round function ``round_fn(state, draws, shard_data, bank)`` runs the
    T local steps of every chain on those draws.

Three executors share the draws:

  * ``packed``   — the chain block's whole parameter pytree lives in one
    chain-major (C * rows_total, 128) buffer and every step makes exactly
    ONE launch of the fused update kernel (``kernels.ops.packed_step``);
  * ``per_leaf`` — one launch of the per-leaf entry per leaf per step;
  * ``vmap``     — the plain reference: the drift vmapped over chains and
    Gaussian noise drawn from the generator (``langevin_update``).

``packed`` and ``per_leaf`` consume the same seeds for the same elements,
so with the same generator they give the same result, bitwise.

Chain->client reassignment is ``categorical`` (paper Algorithm 1: i.i.d.
s ~ Categorical(f) per chain) or ``permutation`` (collision-free; block-
cyclic ``perm[c % S]`` when C > S).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.func import grad, vmap

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.sampler import (LogLikFn, ShardScheme, chain_scales,
                                      langevin_update, make_drift_fn)
from repro_torch.core.surrogate import SurrogateBank
from repro_torch.kernels import ops as kops

PyTree = Any


# ---------------------------------------------------------------------------
# padding non-uniform clients
# ---------------------------------------------------------------------------

def pad_shards(per_shard: list, fill: float = float("nan")):
    """Stack per-client pytrees (leading axis N_s) into padded
    (S, max_n, ...) leaves + the true sizes tuple. Float leaves pad with
    NaN, so an estimator that touches a pad row poisons the chain at once;
    integer leaves pad with the dtype's minimum (0 would be a valid id)."""
    sizes = tuple(int(tu.leaves(t)[0].shape[0]) for t in per_shard)
    max_n = max(sizes)

    def pad_one(leaf):
        value = (fill if leaf.dtype.is_floating_point
                 else torch.iinfo(leaf.dtype).min)
        out = torch.full((max_n,) + tuple(leaf.shape[1:]), value,
                         dtype=leaf.dtype, device=leaf.device)
        out[:leaf.shape[0]] = leaf
        return out

    stacked = tu.tree_map(lambda *ls: torch.stack([pad_one(l) for l in ls]),
                          *per_shard)
    return stacked, sizes


# ---------------------------------------------------------------------------
# the round's randomness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundDraws:
    """Everything random in one round (see the module docstring)."""
    sids: torch.Tensor   # (C,) int64 client of each chain
    idx: torch.Tensor    # (T, C, m) int64 rows; pooled indices for SGLD
    seeds: torch.Tensor  # (T, C, L) int32 noise seeds


def draw_round(generator: torch.Generator, cfg: SamplerConfig,
               scheme: ShardScheme, *, n_chains: int, minibatch: int,
               num_leaves: int, reassign: str = "categorical"
               ) -> RoundDraws:
    """One round's draws, on the generator's device, in the fixed order
    client ids, minibatch indices, seeds. Centralized SGLD draws no client
    ids and indexes the virtual concatenation of all shards."""
    dev = generator.device
    C, T, S = n_chains, cfg.local_updates, cfg.num_shards
    sizes = scheme.sizes_array(dev)
    if cfg.method == "sgld":
        sids = torch.zeros(C, dtype=torch.int64, device=dev)
        bound = torch.tensor(scheme.total, device=dev)
    else:
        if reassign == "categorical":
            probs = torch.as_tensor(scheme.probs_array(), device=dev)
            sids = torch.multinomial(probs, C, replacement=True,
                                     generator=generator)
        elif reassign == "permutation":
            perm = torch.randperm(S, generator=generator, device=dev)
            sids = perm.repeat(-(-C // S))[:C]
        else:
            raise ValueError(f"unknown reassign {reassign!r}; pick "
                             "'categorical' or 'permutation'")
        bound = sizes[sids][None, :, None]
    u = torch.rand((T, C, minibatch), generator=generator, device=dev,
                   dtype=torch.float64)
    idx = torch.minimum((u * bound).floor().to(torch.int64), bound - 1)
    seeds = kops.chain_leaf_seeds(generator, T, C, num_leaves)
    return RoundDraws(sids=sids, idx=idx, seeds=seeds)


def _make_batch_sampler(cfg: SamplerConfig, scheme: ShardScheme):
    """Returns sample(idx, sids, shard_data) -> minibatch pytree (C, m, ...)
    for one step's (C, m) indices. DSGLD/FSGLD index each chain's resident
    shard; centralized SGLD maps a pooled index u in [0, N) to (shard,
    offset) through the size prefix sums."""
    tables = {}

    def sample(idx, sids, shard_data):
        if cfg.method == "sgld":
            dev = idx.device
            if dev not in tables:
                sizes = scheme.sizes_array(dev)
                tables[dev] = (torch.cumsum(sizes, 0), scheme.starts_array(
                    dev))
            ends, starts = tables[dev]
            sh = torch.searchsorted(ends, idx, right=True)
            off = idx - starts[sh]
            return tu.tree_map(lambda d: d[sh, off], shard_data)
        return tu.tree_map(lambda d: d[sids[:, None], idx], shard_data)

    return sample


# ---------------------------------------------------------------------------
# round functions (one per executor)
# ---------------------------------------------------------------------------

def make_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                  scheme: ShardScheme, minibatch: int,
                  bank: Optional[SurrogateBank] = None):
    """The plain reference executor ('vmap'): returns
    round_fn(thetas, draws, shard_data, bank_rt=None, *, generator,
    on_step=None) over a (C, ...) chain block. The drift is vmapped over
    chains; the Langevin noise is drawn from ``generator`` (after the
    round's draws). ``on_step(t, thetas)`` sees each step's states."""
    sample = _make_batch_sampler(cfg, scheme)
    drift_fn = make_drift_fn(log_lik_fn, cfg, scheme, bank)

    def round_fn(thetas, draws, shard_data, bank_rt=None, *, generator,
                 on_step=None):
        drift_v = vmap(lambda th, b, s: drift_fn(th, b, s, minibatch,
                                                 bank_rt))
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], draws.sids, shard_data)
            d = drift_v(thetas, batches, draws.sids)
            thetas = langevin_update(thetas, d, cfg.step_size, generator,
                                     cfg.temperature)
            if on_step is not None:
                on_step(t, thetas)
        return thetas

    return round_fn


def make_chain_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                        scheme: ShardScheme, minibatch: int,
                        bank_kind: Optional[str]):
    """The 'per_leaf' executor: gradients vmapped over the chain block,
    then one chain-batched kernel launch per leaf per step. Returns
    round_fn(thetas, draws, shard_data, bank=None, *, on_step=None)."""
    sample = _make_batch_sampler(cfg, scheme)
    grad_v = vmap(grad(log_lik_fn))
    # only FSGLD carries the conducive correction
    use_surrogate = cfg.method == "fsgld"
    bank_kind = bank_kind if use_surrogate else None

    def round_fn(thetas, draws, shard_data, bank=None, *, on_step=None):
        scale, f_s = chain_scales(cfg, scheme, draws.sids, minibatch)
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], draws.sids, shard_data)
            glls = grad_v(thetas, batches)
            thetas = kops.fused_update_chains_tree(
                thetas, glls, draws.seeds[t], h=cfg.step_size, scale=scale,
                f_s=f_s, prior_prec=cfg.prior_precision, alpha=cfg.alpha,
                temperature=cfg.temperature,
                bank=bank if use_surrogate else None, sids=draws.sids,
                surrogate_kind=bank_kind)
            if on_step is not None:
                on_step(t, thetas)
        return thetas

    return round_fn


def pack_bank(layout: kops.PackedChains, bank: Optional[SurrogateBank]):
    """SurrogateBank -> packed operands for the packed round. The shared
    global surrogate is packed ONCE here; per-shard stacks keep a leading
    S axis, (S, rows_total, 128), gathered at the chains' clients once per
    round."""
    if bank is None:
        return None
    stack = lambda t: layout.pack(t).reshape(  # noqa: E731
        -1, layout.rows_total, kops.LANE)
    if bank.kind == "diag":
        return {"mu_g": layout.pack_shared(bank.global_.mean),
                "lam_g": layout.pack_shared(bank.global_.prec),
                "means": stack(bank.means), "precs": stack(bank.precs)}
    if bank.kind == "scalar":
        # per-leaf scalar precisions ride in the (C, L, 9) scalar rows
        return {"mu_g": layout.pack_shared(bank.global_.mean),
                "means": stack(bank.means),
                "lam_g_leaf": torch.stack([
                    torch.as_tensor(p, dtype=torch.float32)
                    for p in tu.leaves(bank.global_.prec)]),
                "lam_s_leaf": torch.stack([
                    torch.as_tensor(p, dtype=torch.float32)
                    for p in tu.leaves(bank.precs)], dim=1)}
    raise ValueError(bank.kind)


def make_packed_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                         scheme: ShardScheme, minibatch: int,
                         bank_kind: Optional[str],
                         layout: kops.PackedChains):
    """The 'packed' executor: ONE kernel launch per step for the whole
    chain block. Returns round_fn(state, draws, shard_data, pbank=None, *,
    on_step=None) with state = (packed buffer, unpacked pytree).

    The packed buffer is authoritative; the pytree (views into it for fp32
    leaves) feeds the gradient pass and the trace. Per step the leaf
    gradients are copied IN PLACE into one gradient buffer allocated per
    round (its pad stays zero), the kernel writes a fresh output buffer,
    and non-fp32 leaves are quantized back in place on that output. Per
    round: the clients' surrogate rows are gathered and the scalar rows
    built once."""
    sample = _make_batch_sampler(cfg, scheme)
    grad_v = vmap(grad(log_lik_fn))
    use_surrogate = cfg.method == "fsgld"
    bank_kind = bank_kind if use_surrogate else None

    def round_fn(state, draws, shard_data, pbank=None, *, on_step=None):
        th_p, thetas = state
        sids = draws.sids
        scale, f_s = chain_scales(cfg, scheme, sids, minibatch)
        ops = {}
        lam_g_leaf = lam_s_leaf = None
        if bank_kind is None:
            variant = "plain"
        elif bank_kind == "diag":
            variant = "diag"
            ops = {"mu_g": pbank["mu_g"], "lam_g": pbank["lam_g"],
                   "mu_s": pbank["means"][sids].reshape(-1, kops.LANE),
                   "lam_s": pbank["precs"][sids].reshape(-1, kops.LANE)}
        elif bank_kind == "scalar":
            variant = "scalar"
            ops = {"mu_g": pbank["mu_g"],
                   "mu_s": pbank["means"][sids].reshape(-1, kops.LANE)}
            lam_g_leaf = pbank["lam_g_leaf"]
            lam_s_leaf = pbank["lam_s_leaf"][sids]
        else:
            raise ValueError(bank_kind)
        scalars = kops.packed_scalar_rows(
            layout, h=cfg.step_size, scale=scale, f_s=f_s,
            prior_prec=cfg.prior_precision, alpha=cfg.alpha,
            temperature=cfg.temperature, lam_g_leaf=lam_g_leaf,
            lam_s_leaf=lam_s_leaf)
        g_p = torch.zeros_like(th_p)
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], sids, shard_data)
            layout.pack(grad_v(thetas, batches), out=g_p)
            th_p = layout.quantize(kops.packed_step(
                layout, th_p, g_p, draws.seeds[t], scalars, variant=variant,
                **ops))
            thetas = layout.unpack(th_p)
            if on_step is not None:
                on_step(t, thetas)
        return th_p, thetas

    return round_fn


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md open item "
        f"{item})")


@dataclasses.dataclass
class MeshChainEngine:
    """Multi-chain FSGLD runtime on ONE device.

    shard_data: pytree with leaves (S, max_n, ...) on the run's device —
    shards padded to the longest client; ``sizes`` carries the true
    per-client counts (None => uniform). ``use_kernel`` selects the fused
    kernel executors: ``packed`` True/None (None: per-leaf for non-float
    leaves) or False (per-leaf); ``use_kernel=False`` is the plain vmap
    executor. Langevin dynamics only in this port so far.
    """
    log_lik_fn: LogLikFn
    cfg: SamplerConfig
    shard_data: PyTree
    minibatch: int
    bank: Optional[SurrogateBank] = None
    use_kernel: bool = False
    sizes: Optional[tuple] = None
    packed: Optional[bool] = None
    dynamics: str = "langevin"
    aggregation: str = "none"

    def __post_init__(self):
        if self.dynamics == "sghmc":
            raise _not_ported("dynamics='sghmc'", 7)
        if self.dynamics != "langevin":
            raise ValueError(self.dynamics)
        if self.aggregation == "fald":
            raise _not_ported("aggregation='fald'", 10)
        if self.aggregation != "none":
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        leaf = tu.leaves(self.shard_data)[0]
        s, max_n = leaf.shape[0], leaf.shape[1]
        if s != self.cfg.num_shards:
            raise ValueError(f"shard_data holds {s} shards, the config "
                             f"{self.cfg.num_shards}")
        sizes = ((max_n,) * s if self.sizes is None
                 else tuple(int(n) for n in self.sizes))
        if len(sizes) != s or max(sizes) != max_n:
            raise ValueError(f"sizes {sizes} do not fit shards padded to "
                             f"{max_n}")
        self.device = leaf.device
        self.scheme = ShardScheme(sizes=sizes, probs=self.cfg.probs())

    def _layout_for(self, theta0: PyTree) -> Optional[kops.PackedChains]:
        """The packed layout for this run, or None for the other paths.
        Non-float leaves cannot ride the fp32 buffer: auto falls back to
        per-leaf, explicit packed=True refuses."""
        if not self.use_kernel:
            if self.packed:
                raise ValueError("packed=True requires use_kernel=True")
            return None
        if self.packed is False:
            return None
        if not all(l.dtype.is_floating_point for l in tu.leaves(theta0)):
            if self.packed is None:
                return None
            raise ValueError("packed executor requires floating-point "
                             "parameter leaves")
        return kops.make_packed_layout(theta0)

    def run(self, generator: torch.Generator, theta0: PyTree,
            num_rounds: int, *, n_chains: int = 1,
            reassign: str = "categorical", collect_every: int = 1,
            refresh_every: Optional[int] = None, collect: bool = True,
            stacked: bool = False, federation=None, recovery=None,
            chaos=None, snapshot_every: Optional[int] = None,
            snapshot_path: Optional[str] = None, resume: bool = False,
            stream=None, telemetry=None):
        """Run ``num_rounds`` communication rounds of ``n_chains`` chains.
        Returns the trace, leaves (n_chains, num_rounds *
        ceil(T / collect_every), ...) keeping local steps 0, collect_every,
        ... of each round — or the final chain states when
        ``collect=False``. ``stacked=True`` takes ``theta0`` as per-chain
        states with a leading (n_chains, ...) axis."""
        if refresh_every:
            raise _not_ported("refresh_every (adaptive refresh)", 8)
        if federation is not None:
            raise _not_ported("federation scenarios", 9)
        if recovery is not None or chaos is not None:
            raise _not_ported("recovery / chaos", 11)
        if snapshot_every or snapshot_path or resume:
            raise _not_ported("snapshots / resume", 11)
        if telemetry is not None:
            raise _not_ported("telemetry", 12)
        if stream is not None:
            raise _not_ported("the streamed client axis (stream=)", 13)
        if reassign not in ("categorical", "permutation"):
            raise ValueError(reassign)
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"run on {self.device}")
        C, T = n_chains, self.cfg.local_updates
        if stacked:
            if tu.leaves(theta0)[0].shape[0] != C:
                raise ValueError("stacked theta0 needs a leading "
                                 f"(n_chains={C}, ...) axis")
            chains = tu.tree_map(lambda t: t.clone(), theta0)
            example = tu.tree_map(lambda t: t[0], theta0)
        else:
            chains = tu.tree_map(
                lambda t: torch.broadcast_to(t, (C,) + t.shape).clone(),
                theta0)
            example = theta0
        layout = self._layout_for(example)
        num_leaves = len(tu.leaves(chains))
        fsgld_bank = self.bank if self.cfg.method == "fsgld" else None
        bank_kind = fsgld_bank.kind if fsgld_bank is not None else None
        kw = {}
        if layout is not None:
            round_fn = make_packed_round_fn(
                self.log_lik_fn, self.cfg, self.scheme, self.minibatch,
                bank_kind, layout)
            state = (layout.pack(chains), chains)
            bank_arg = pack_bank(layout, fsgld_bank)
        elif self.use_kernel:
            round_fn = make_chain_round_fn(
                self.log_lik_fn, self.cfg, self.scheme, self.minibatch,
                bank_kind)
            state, bank_arg = chains, fsgld_bank
        else:
            round_fn = make_round_fn(self.log_lik_fn, self.cfg, self.scheme,
                                     self.minibatch, fsgld_bank)
            state, bank_arg = chains, None
            kw["generator"] = generator

        per_round = -(-T // collect_every)
        trace = None
        if collect:
            trace = tu.tree_map(
                lambda t: torch.empty((C, num_rounds * per_round)
                                      + tuple(t.shape[1:]), dtype=t.dtype,
                                      device=t.device), chains)
        for r in range(num_rounds):
            draws = draw_round(generator, self.cfg, self.scheme,
                               n_chains=C, minibatch=self.minibatch,
                               num_leaves=num_leaves, reassign=reassign)

            def keep(t, thetas, r=r):
                if t % collect_every == 0:
                    k = r * per_round + t // collect_every
                    tu.tree_map(lambda dst, src: dst[:, k].copy_(src),
                                trace, thetas)

            state = round_fn(state, draws, self.shard_data, bank_arg,
                             on_step=keep if collect else None, **kw)
        if collect:
            return trace
        return state[1] if layout is not None else state
