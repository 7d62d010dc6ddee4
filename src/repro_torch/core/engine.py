"""Multi-chain FSGLD runtime on one device or a mesh of ranks (counterpart of
``repro.core.engine``).

A run is a host loop over communication rounds. Each round is split in
two so that the randomness can be handed in from outside:

  * ``draw_round(generator, ...) -> RoundDraws`` draws, from ONE
    ``torch.Generator`` and in this order, the chains' proposed client
    ids (C,), the minibatch indices (T, C, m) — uniform over the live
    prefix [0, N_s) of the client each chain HOLDS this round, never into
    the pad — and the per-(step, chain, leaf) noise seeds (T, C, L) in
    [0, 2^31 - 1). A federated run (a non-identity ``Federation``, or
    FA-LD) then draws, each only where its scenario uses it: the
    participation uniforms (C,), the straggler uniforms (C,), and, on
    communication rounds only (a function of r alone), the primal and
    then the dual compression uniforms (C, P). A run without a
    federation draws exactly the first three;
  * a round function ``round_fn(state, draws, shard_data, bank)`` runs the
    T local steps of every chain on those draws.

Three executors share the draws:

  * ``packed``   — the chain block's whole parameter pytree lives in one
    chain-major (C * rows_total, 128) buffer (SGHMC: the momenta in a
    second one over the same segment table) and every step makes exactly
    ONE launch of the fused update kernel (``kernels.ops.packed_step``);
  * ``per_leaf`` — one launch of the per-leaf entry per leaf per step;
  * ``vmap``     — the plain reference: the drift vmapped over chains and
    Gaussian noise drawn from the generator (``langevin_update`` /
    ``core.sghmc.sghmc_update``).

``packed`` and ``per_leaf`` consume the same seeds for the same elements,
so with the same generator they give the same result, bitwise.

Chain->client reassignment is ``categorical`` (paper Algorithm 1: i.i.d.
s ~ Categorical(f) per chain) or ``permutation`` (collision-free; block-
cyclic ``perm[c % S]`` when C > S). A federated round (``repro_torch.fed``)
carries the client ids: a chain takes its proposed client only when it
exchanges (a communication round it takes part in). On communication
rounds the exchanging chains' states go through the exchange (primal
compression -> FA-LD average -> dual compression) before the local steps;
the others are never written. Straggling chains get their pre-round state
back and their trace repeats it.

The same round loop carries per-round telemetry (``run(telemetry=)``:
metric rows on the device, a probe generator of its own), the streamed
client axis (``run(stream=)``: the held clients' rows looked up in a
resident window, planned by replaying the run's draws on a clone of its
generator, ``replay_sids``) and adaptive refresh (``run(refresh_every=)``:
the 'diag' bank re-fitted at the chain mean between segments, drawing
nothing from the generator).

On a mesh (``MeshChainEngine(mesh=)``, a ``launch.mesh`` DeviceMesh) the
chains ride the 'data' axis: each rank holds a ``ChainBlock`` of
ceil(C / |data|) chains, the pad chains at the global tail. Every rank
draws the WHOLE round from the same generator and takes its rows, so a
rank's chains are bitwise those of the one-device run; only the real
chains take a gradient, FA-LD's average is taken over the chains
gathered from the data group (the same (C, P) sum as one device), and
the refresh splits the clients over 'model'. Results are gathered, so
every rank returns what the one-device run returns.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch import tree as tu
from repro_torch.checkpoint.snapshot import latest_snapshot, save_snapshot
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.conducive import conducive_gradient
from repro_torch.core.health import HEALTH_PROBE_SALT, RunHealth
from repro_torch.core.sampler import (LogLikFn, ShardScheme, chain_scales,
                                      langevin_update, make_drift_fn,
                                      tree_randn_like)
from repro_torch.core.sghmc import SGHMCConfig, init_momentum, sghmc_update
from repro_torch.core.surrogate import Gaussian, SurrogateBank
from repro_torch.fed import schedule as fsched
from repro_torch.fed.compress import (Compression, make_compressor,
                                      make_flattener)
from repro_torch.fed.partition import is_client_source
from repro_torch.fed.registry import get_scenario
from repro_torch.fed.spec import Federation
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as lmesh
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.telemetry import (TELEMETRY_PROBE_SALT, MetricsFrame,
                                       Telemetry)

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
    sids: torch.Tensor   # (C,) int64 proposed client of each chain
    idx: torch.Tensor    # (T, C, m) int64 rows; pooled indices for SGLD
    seeds: torch.Tensor  # (T, C, L) int32 noise seeds
    # federated runs only, each None where the scenario does not use it
    part_u: Optional[torch.Tensor] = None    # (C,) participation
    strag_u: Optional[torch.Tensor] = None   # (C,) stragglers
    primal_u: Optional[torch.Tensor] = None  # (C, P) primal compression
    dual_u: Optional[torch.Tensor] = None    # (C, P) dual compression


def exchanging(sched: fsched.CommSchedule, r: int,
               part_u: Optional[torch.Tensor],
               like: torch.Tensor) -> torch.Tensor:
    """(C,) bool: the chains that exchange at round ``r`` — a
    communication round they take part in (``like``: any (C,) tensor on
    the run's device)."""
    comm = fsched.comm_mask(sched, r)
    if part_u is None:
        return torch.full(like.shape, comm, dtype=torch.bool,
                          device=like.device)
    return fsched.participation_mask(sched, part_u, r) & comm


def draw_round(generator: torch.Generator, cfg: SamplerConfig,
               scheme: ShardScheme, *, n_chains: int, minibatch: int,
               num_leaves: int, reassign: str = "categorical",
               federation: Optional[Federation] = None, r: int = 0,
               held: Optional[torch.Tensor] = None,
               dim: int = 0,
               live: Optional[torch.Tensor] = None) -> RoundDraws:
    """One round's draws, on the generator's device, in the fixed order
    of the module docstring. Centralized SGLD draws no client ids and
    indexes the virtual concatenation of all shards.

    With a ``federation`` (round ``r``, the chains' ``held`` client ids,
    ``dim`` the flat parameter count P) the scenario's uniforms follow the
    seeds, and the minibatch rows are drawn for the client each chain
    holds this round: its proposed one where it exchanges, else
    ``held``. ``live`` (C,) bool masks chains out of the exchange (the
    quarantined ones): they hold their client, and nothing drawn
    changes."""
    dev = generator.device
    C, T, S = n_chains, cfg.local_updates, cfg.num_shards
    sizes = scheme.sizes_array(dev)
    if cfg.method == "sgld":
        sids = torch.zeros(C, dtype=torch.int64, device=dev)
    elif reassign == "categorical":
        probs = torch.as_tensor(scheme.probs_array(), device=dev)
        sids = torch.multinomial(probs, C, replacement=True,
                                 generator=generator)
    elif reassign == "permutation":
        perm = torch.randperm(S, generator=generator, device=dev)
        sids = perm.repeat(-(-C // S))[:C]
    else:
        raise ValueError(f"unknown reassign {reassign!r}; pick "
                         "'categorical' or 'permutation'")
    u = torch.rand((T, C, minibatch), generator=generator, device=dev,
                   dtype=torch.float64)
    seeds = kops.chain_leaf_seeds(generator, T, C, num_leaves)
    draws = RoundDraws(sids=sids, idx=None, seeds=seeds)
    hold = sids
    if federation is not None:
        sched, comp = federation.schedule, federation.compression

        def unif(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        if sched.participation < 1.0:
            draws.part_u = unif(C)
        if sched.straggler_prob > 0.0:
            draws.strag_u = unif(C)
        if fsched.comm_mask(sched, r) and comp.stochastic:
            if comp.use_primal:
                draws.primal_u = unif(C, dim)
            if comp.use_dual:
                draws.dual_u = unif(C, dim)
        exch = exchanging(sched, r, draws.part_u, sids)
        if live is not None:
            exch = exch & live
        hold = torch.where(exch, sids, held)
    if cfg.method == "sgld":
        bound = torch.tensor(scheme.total, device=dev)
    else:
        bound = sizes[hold][None, :, None]
    draws.idx = torch.minimum((u * bound).floor().to(torch.int64), bound - 1)
    return draws


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
# the chains one rank holds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainBlock:
    """The rows of a run's ``n_chains`` chains that this rank holds: on a
    mesh ``per`` = ceil(n_chains / |data|) chains from ``lo``, of which
    ``real`` are chains of the run and the rest pad chains (the global
    tail), which repeat chain 0's row wherever a row is taken. Without a
    mesh the block is the whole run and every method is the identity."""
    n_chains: int
    per: int
    lo: int = 0
    mesh: Any = None

    @classmethod
    def of(cls, n_chains: int, mesh=None) -> "ChainBlock":
        if mesh is None:
            return cls(n_chains, n_chains)
        per = -(-n_chains // lmesh.axis_size(mesh, "data"))
        return cls(n_chains, per, lmesh.axis_rank(mesh, "data") * per, mesh)

    @property
    def real(self) -> int:
        return max(0, min(self.n_chains - self.lo, self.per))

    def take(self, t, dim: int = 0):
        """This block's rows of a global (..., n_chains, ...) tensor along
        ``dim`` (None passes through)."""
        if self.mesh is None or t is None:
            return t
        rows = t.narrow(dim, self.lo, self.real) if self.real else \
            t.narrow(dim, 0, 0)
        pad = self.per - self.real
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            rows = torch.cat([rows, t.narrow(dim, 0, 1).expand(shape)], dim)
        return rows.contiguous()   # kernel operands (a step's seeds)

    def take_tree(self, tree):
        return tu.tree_map(self.take, tree)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The real rows of every rank's (per, ...) block, in chain order:
        the global (n_chains, ...) tensor."""
        if self.mesh is None:
            return t
        return lmesh.all_gather_rows(t, self.mesh, "data")[:self.n_chains]

    def gather_tree(self, tree):
        return tu.tree_map(self.gather, tree)

    def row(self, t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Chain ``i``'s row (a device scalar index into the run's
        chains) of the blocks' (per, ...) rows, as (1, ...) on every rank:
        each rank sends one row and the owner's is kept."""
        if self.mesh is None:
            return t[i][None]
        mine = (i - self.lo).clamp(0, self.per - 1).reshape(1)
        rows = lmesh.all_gather_rows(t.index_select(0, mine), self.mesh,
                                     "data")
        return rows.index_select(0, (i // self.per).reshape(1))

    def draws(self, d: "RoundDraws") -> "RoundDraws":
        """This block's rows of a round's global draws."""
        if self.mesh is None:
            return d
        return RoundDraws(
            sids=self.take(d.sids), idx=self.take(d.idx, 1),
            seeds=self.take(d.seeds, 1), part_u=self.take(d.part_u),
            strag_u=self.take(d.strag_u), primal_u=self.take(d.primal_u),
            dual_u=self.take(d.dual_u))


def masked_vmap(fn, block: Optional[ChainBlock] = None):
    """``vmap(fn)`` over a chain block whose first argument is the chains'
    states, taken over the block's REAL chains only (the reference's
    ``make_masked_grad_vmap``): the pad chains' rows of the result are
    zeros, and their gradient work is skipped, not discarded."""
    v = vmap(fn)
    if block is None or block.real == block.per:
        return v

    def masked(*args):
        real, pad = block.real, block.per - block.real
        if real == 0:
            return tu.tree_map(torch.zeros_like, args[0])
        out = v(*(tu.tree_map(lambda t: t[:real], a) for a in args))
        return tu.tree_map(lambda g: torch.cat(
            [g, g.new_zeros((pad,) + tuple(g.shape[1:]))]), out)

    return masked


def _noise(generator: torch.Generator, thetas: PyTree,
           block: Optional[ChainBlock]) -> Optional[PyTree]:
    """A plain step's normals for a mesh block: drawn for every chain of
    the run, as one device draws them, and this block's rows taken (None
    without a mesh: the update draws its own)."""
    if block is None or block.mesh is None:
        return None
    glob = tu.tree_map(lambda l: torch.randn(
        (block.n_chains,) + tuple(l.shape[1:]), generator=generator,
        device=l.device, dtype=l.dtype), thetas)
    return block.take_tree(glob)


# ---------------------------------------------------------------------------
# round functions (one per executor)
# ---------------------------------------------------------------------------

def check_kernel_kind(bank_kind: Optional[str]) -> None:
    """The fused kernel's operands are 'diag' or 'scalar' banks (or none):
    'linear' and 'full' banks run on the plain 'vmap' executor only."""
    if bank_kind not in (None, "diag", "scalar"):
        raise ValueError(f"surrogate kind {bank_kind!r} has no fused-kernel "
                         "variant (the kernel takes 'diag' or 'scalar' "
                         "banks); run it on the 'vmap' executor")


def make_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                  scheme: ShardScheme, minibatch: int,
                  bank: Optional[SurrogateBank] = None,
                  hmc: Optional[SGHMCConfig] = None,
                  block: Optional[ChainBlock] = None):
    """The plain reference executor ('vmap'): returns
    round_fn(state, draws, shard_data, bank_rt=None, *, generator,
    on_step=None, rows=None) over a (C, ...) chain block; state is the
    parameter pytree, or the (thetas, momenta) pair for SGHMC (``hmc``).
    The drift is vmapped over chains; the noise is drawn from
    ``generator`` (after the round's draws). ``on_step(t, thetas)`` sees
    each step's states. ``rows`` (C,) are the held clients' rows in
    ``shard_data`` and in the bank (default ``draws.sids``; a streamed
    window holds only its resident clients), while sizes and
    probabilities stay indexed by the global ids ``draws.sids``. A mesh
    ``block`` takes the drift of its real chains only and the noise drawn
    for every chain of the run."""
    sample = _make_batch_sampler(cfg, scheme)
    drift_fn = make_drift_fn(log_lik_fn, cfg, scheme, bank)

    def round_fn(state, draws, shard_data, bank_rt=None, *, generator,
                 on_step=None, rows=None):
        thetas, r = state if hmc else (state, None)
        rows = draws.sids if rows is None else rows
        drift_v = masked_vmap(lambda th, b, s, q: drift_fn(
            th, b, s, minibatch, bank_rt, bank_id=q), block)
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], rows, shard_data)
            d = drift_v(thetas, batches, draws.sids, rows)
            noise = _noise(generator, thetas, block)
            if hmc is None:
                thetas = langevin_update(thetas, d, cfg.step_size,
                                         generator, cfg.temperature,
                                         noise=noise)
            else:
                thetas, r = sghmc_update(thetas, r, d, cfg.step_size,
                                         generator, hmc, noise=noise)
            if on_step is not None:
                on_step(t, thetas)
        return (thetas, r) if hmc else thetas

    return round_fn


def make_chain_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                        scheme: ShardScheme, minibatch: int,
                        bank_kind: Optional[str],
                        hmc: Optional[SGHMCConfig] = None,
                        block: Optional[ChainBlock] = None):
    """The 'per_leaf' executor: gradients vmapped over the chain block
    (a mesh ``block``'s real chains), then one chain-batched kernel launch
    per leaf per step. Returns round_fn(state, draws, shard_data,
    bank=None, *, on_step=None, rows=None); state and ``rows`` as in
    ``make_round_fn``."""
    sample = _make_batch_sampler(cfg, scheme)
    grad_v = masked_vmap(grad(log_lik_fn), block)
    # only FSGLD carries the conducive correction
    use_surrogate = cfg.method == "fsgld"
    bank_kind = bank_kind if use_surrogate else None
    check_kernel_kind(bank_kind)
    dyn = (dict(dynamics="sghmc", friction=hmc.friction,
                temperature=hmc.temperature) if hmc
           else dict(temperature=cfg.temperature))

    def round_fn(state, draws, shard_data, bank=None, *, on_step=None,
                 rows=None):
        thetas, r = state if hmc else (state, None)
        rows = draws.sids if rows is None else rows
        scale, f_s = chain_scales(cfg, scheme, draws.sids, minibatch)
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], rows, shard_data)
            glls = grad_v(thetas, batches)
            out = kops.fused_update_chains_tree(
                thetas, glls, draws.seeds[t], h=cfg.step_size, scale=scale,
                f_s=f_s, prior_prec=cfg.prior_precision, alpha=cfg.alpha,
                bank=bank if use_surrogate else None, sids=rows,
                surrogate_kind=bank_kind, momentum=r, **dyn)
            thetas, r = out if hmc else (out, None)
            if on_step is not None:
                on_step(t, thetas)
        return (thetas, r) if hmc else thetas

    return round_fn


def _stack(layout: kops.PackedChains, tree: PyTree) -> torch.Tensor:
    """Per-shard (S, ...) leaves -> (S, rows_total, 128) at the leaves' own
    (storage) dtype: the buffer they are already views of
    (``PackedChains.views``, as ``fit_bank_local_sgld`` lays out its
    means), else a packed copy."""
    base = layout.base_of(tree)
    if base is None:
        base = layout.pack(tree, dtype=tu.leaves(tree)[0].dtype)
    return base.view(-1, layout.rows_total, kops.LANE)


def pack_bank(layout: kops.PackedChains, bank: Optional[SurrogateBank],
              device=None):
    """SurrogateBank -> packed operands for the packed round. The shared
    global surrogate is packed ONCE here, in fp32; per-shard stacks keep a
    leading S axis, (S, rows_total, 128), at the bank's storage dtype
    (bf16 at billion-parameter scale, sharing the bank's buffer where its
    means are views of one), gathered at the chains' clients once per
    round and widened to fp32 there (exact, so results do not depend on
    where the widening happens). The stacks stay where the bank's means
    lie (the host, say); the global operands go to ``device`` (default:
    the bank's)."""
    if bank is None:
        return None
    stack = lambda t: _stack(layout, t)  # noqa: E731
    if bank.kind == "diag":
        return {"mu_g": layout.pack_shared(bank.global_.mean, device),
                "lam_g": layout.pack_shared(bank.global_.prec, device),
                "means": stack(bank.means), "precs": stack(bank.precs)}
    if bank.kind == "scalar":
        # per-leaf scalar precisions ride in the (C, L, 9) scalar rows
        return {"mu_g": layout.pack_shared(bank.global_.mean, device),
                "means": stack(bank.means),
                "lam_g_leaf": torch.stack([
                    torch.as_tensor(p, dtype=torch.float32)
                    for p in tu.leaves(bank.global_.prec)]),
                "lam_s_leaf": torch.stack([
                    torch.as_tensor(p, dtype=torch.float32)
                    for p in tu.leaves(bank.precs)], dim=1)}
    raise ValueError(bank.kind)


def _gather(stack, sids: torch.Tensor, device) -> torch.Tensor:
    """The chains' clients' rows of a (S, rows_total, 128) stack, on
    ``device`` widened to a chain-major (C * rows_total, 128) fp32 buffer.
    A stack on another device (the host) is read row block by row block,
    each client's block copied straight from its (pinned) storage. A
    streamed window passes such a stack whole with its resident ids, as
    ``(stack, ids)``: row ``s`` of the window is row ``ids[s]`` of the
    stack (the host's copy is never gathered per window)."""
    if isinstance(stack, tuple):
        stack, ids = stack
        sids = ids.to(sids.device)[sids]
    if stack.device == torch.device(device):
        return stack[sids].to(torch.float32).reshape(-1, kops.LANE)
    out = torch.empty((sids.shape[0],) + tuple(stack.shape[1:]),
                      dtype=torch.float32, device=device)
    for c, s in enumerate(sids.tolist()):
        out[c].copy_(stack[s].to(device))  # copy, then widen there
    return out.reshape(-1, kops.LANE)


def make_packed_round_fn(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                         scheme: ShardScheme, minibatch: int,
                         bank_kind: Optional[str],
                         layout: kops.PackedChains,
                         hmc: Optional[SGHMCConfig] = None,
                         block: Optional[ChainBlock] = None):
    """The 'packed' executor: ONE kernel launch per step for the whole
    chain block. Returns round_fn(state, draws, shard_data, pbank=None, *,
    on_step=None, rows=None, opnds=None) with state = (packed buffer,
    unpacked pytree), or (packed buffer, packed momenta, unpacked pytree)
    for SGHMC (``hmc``): the momenta ride a second chain-major buffer over
    the same segment table. ``rows`` as in ``make_round_fn``;
    ``round_fn.operands(rows, pbank, device)`` gathers the round's bank
    operands (variant, operand dict, lam_g_leaf, lam_s_leaf), which a
    caller that reads them after the round (telemetry's conducive norm)
    passes in as ``opnds`` instead of letting the round gather them.

    The packed buffers are authoritative; the pytree (views into the
    buffer for fp32 leaves) feeds the gradient pass and the trace. Per
    step the leaf gradients are copied IN PLACE into one gradient buffer
    allocated per round (its pad stays zero) and freed, the kernel
    updates the state buffers IN PLACE (so the views stay valid; a caller
    that needs the pre-round state copies it), and non-fp32 leaves are
    quantized back in place on them. Per round: the clients' surrogate
    rows are gathered (widened to fp32) and the scalar rows built once.
    At qwen3-1.7b's width a step then holds, per chain, the state, the
    gradient buffer and the gathered client mean (8.1 GB each in fp32),
    plus the shared global mean and the per-client stack. On a mesh the
    layout is the ``block``'s (one launch per step on each rank) and only
    its real chains take a gradient."""
    sample = _make_batch_sampler(cfg, scheme)
    grad_v = masked_vmap(grad(log_lik_fn), block)
    use_surrogate = cfg.method == "fsgld"
    bank_kind = bank_kind if use_surrogate else None
    check_kernel_kind(bank_kind)
    dynamics = "sghmc" if hmc else "langevin"

    def operands(rows, pbank, device):
        if bank_kind is None:
            return "plain", {}, None, None
        if bank_kind == "diag":
            return "diag", {
                "mu_g": pbank["mu_g"], "lam_g": pbank["lam_g"],
                "mu_s": _gather(pbank["means"], rows, device),
                "lam_s": _gather(pbank["precs"], rows, device)}, None, None
        if bank_kind == "scalar":
            return "scalar", {
                "mu_g": pbank["mu_g"],
                "mu_s": _gather(pbank["means"], rows, device)}, \
                pbank["lam_g_leaf"], pbank["lam_s_leaf"][rows]
        raise ValueError(bank_kind)

    def round_fn(state, draws, shard_data, pbank=None, *, on_step=None,
                 rows=None, opnds=None):
        if hmc:
            th_p, r_p, thetas = state
        else:
            (th_p, thetas), r_p = state, None
        sids = draws.sids
        rows = sids if rows is None else rows
        scale, f_s = chain_scales(cfg, scheme, sids, minibatch)
        variant, ops, lam_g_leaf, lam_s_leaf = (
            opnds if opnds is not None
            else operands(rows, pbank, th_p.device))
        scalars = kops.packed_scalar_rows(
            layout, h=cfg.step_size, scale=scale, f_s=f_s,
            prior_prec=cfg.prior_precision, alpha=cfg.alpha,
            temperature=hmc.temperature if hmc else cfg.temperature,
            lam_g_leaf=lam_g_leaf, lam_s_leaf=lam_s_leaf,
            friction=hmc.friction if hmc else 0.0)
        g_p = torch.zeros_like(th_p)
        for t in range(cfg.local_updates):
            batches = sample(draws.idx[t], rows, shard_data)
            layout.pack(grad_v(thetas, batches), out=g_p)
            kops.packed_step(
                layout, th_p, g_p, draws.seeds[t], scalars, variant=variant,
                r_p=r_p, dynamics=dynamics, **ops)
            layout.quantize(th_p)
            if hmc:
                layout.quantize(r_p)
            thetas = layout.unpack(th_p)
            if on_step is not None:
                on_step(t, thetas)
        return (th_p, r_p, thetas) if hmc else (th_p, thetas)

    round_fn.operands = operands
    return round_fn


# ---------------------------------------------------------------------------
# the federated exchange
# ---------------------------------------------------------------------------

def _keep(mask: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """Per chain: ``old`` where ``mask``, else ``new``; leaves with a
    leading chain axis, or chain-major packed buffers."""
    c = mask.shape[0]
    return torch.where(mask[:, None], old.reshape(c, -1),
                       new.reshape(c, -1)).reshape(new.shape)


def make_exchange(comp: Compression, agg: bool, thetas: PyTree,
                  gather=None):
    """The exchange of a communication round over (C, ...) chain leaves
    shaped like ``thetas``. Returns (exchange, carry0):

      exchange(th, cst, exch, draws, poison=None) -> (th', cst')
      carry0(th) -> the initial error-feedback carry (ref, err[, derr]),
                    None without compression

    The pipeline: flatten -> primal leg ref + C(th - ref + err) -> FA-LD
    average over the exchanging chains (``agg``) -> dual leg ref +
    C(m - ref + derr) -> the exchanging chains take the result, cast back
    to their storage dtypes; the other chains' leaves are returned as
    they came, and their carry rows are not written. Masks, counts and
    averages stay on the device. ``poison`` (C,) bool NaNs those chains'
    payload (the compressed delta, or the model itself without primal
    compression) before the server applies it: a corrupted upload.
    ``gather`` (a mesh ``ChainBlock.gather``) brings every rank's rows
    for the FA-LD average, which is then the one device's (C, P) sum;
    the carry stays per rank, with its chains."""
    flatten, unflatten, dim = make_flattener(thetas)
    compress = None if comp.identity else make_compressor(comp, dim)

    def carry0(th):
        if compress is None:
            return None
        ref = flatten(th).clone()
        cst = (ref, torch.zeros_like(ref))
        return cst + (torch.zeros_like(ref),) if comp.use_dual else cst

    def exchange(th, cst, exch, draws, poison=None):
        flat = flatten(th)
        ref = cst[0] if cst is not None else None
        if comp.use_primal:
            upd = flat - ref + cst[1]
            dhat = compress(upd, draws.primal_u)
            if poison is not None:
                dhat = torch.where(poison[:, None], float("nan"), dhat)
            m_flat = ref + dhat
            err_new = (upd - dhat if comp.error_feedback
                       else torch.zeros_like(upd))
        else:
            m_flat = flat
            if poison is not None:
                m_flat = torch.where(poison[:, None], float("nan"), m_flat)
        if agg:
            w = exch[:, None]
            m_all, e_all = ((m_flat, exch) if gather is None
                            else (gather(m_flat), gather(exch)))
            cnt = e_all.to(torch.float32).sum()
            avg = torch.where(e_all[:, None], m_all, 0.0).sum(0) \
                / cnt.clamp_min(1.0)
            m_flat = torch.where(w, avg[None], m_flat)
        if comp.use_dual:
            dupd = m_flat - ref + cst[2]
            dd = compress(dupd, draws.dual_u)
            v_new = ref + dd
            derr_new = (dupd - dd if comp.error_feedback
                        else torch.zeros_like(dupd))
        else:
            # the server model itself, not ref + (m - ref)
            v_new = m_flat
        if cst is not None:
            mm = exch[:, None]
            out = [torch.where(mm, v_new, ref),
                   torch.where(mm, err_new, cst[1]) if comp.use_primal
                   else cst[1]]
            if comp.use_dual:
                out.append(torch.where(mm, derr_new, cst[2]))
            cst = tuple(out)
        th = tu.tree_map(lambda srv, old: _keep(~exch, srv, old),
                         unflatten(v_new), th)
        return th, cst

    return exchange, carry0


# ---------------------------------------------------------------------------
# chain health (core.health) and chaos, applied once per round
# ---------------------------------------------------------------------------

def probe_generator(generator: torch.Generator, r: int,
                    salt: int = HEALTH_PROBE_SALT) -> torch.Generator:
    """A probe's generator for round ``r``, on the run's device, seeded
    from a hash of the run generator's state bytes, ``salt`` (the
    divergence probe's ``HEALTH_PROBE_SALT``, telemetry's
    ``TELEMETRY_PROBE_SALT``) and ``r``. ``get_state`` reads the state
    without advancing it, so the probe consumes nothing of the sampling
    stream, and a resumed run (its generator state restored) gets the
    same probes with no extra snapshot field."""
    h = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                        digest_size=8)
    h.update(int(salt).to_bytes(4, "little"))
    h.update(int(r).to_bytes(8, "little"))
    probe = torch.Generator(device=generator.device)
    probe.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return probe


def _finite_rows(tensors, c: int) -> torch.Tensor:
    """(c,) bool: every element of each chain's rows is finite."""
    ok = None
    for t in tensors:
        f = torch.isfinite(t.reshape(c, -1)).all(1)
        ok = f if ok is None else ok & f
    return ok


def _respawn(mask: torch.Tensor, donor: torch.Tensor, any_h: torch.Tensor,
             new: torch.Tensor, old: torch.Tensor,
             block: Optional[ChainBlock] = None) -> torch.Tensor:
    """Per chain where ``mask`` (this block's rows): the donor chain's
    row of ``new`` (or its own ``old`` row when no chain is healthy), else
    its ``new`` row. ``donor`` indexes the run's chains; on a mesh its
    row comes from the rank that holds it."""
    c = mask.shape[0]
    n2, o2 = new.reshape(c, -1), old.reshape(c, -1)
    row = n2[donor][None] if block is None else block.row(n2, donor)
    cand = torch.where(any_h, row, o2)
    return torch.where(mask[:, None], cand, n2).reshape(new.shape)


def _chain_mask(chains: tuple, c: int, device) -> torch.Tensor:
    return torch.isin(torch.arange(c, device=device),
                      torch.tensor(chains, dtype=torch.int64, device=device))


class _Health:
    """One run's chain health (a ``core.health.Recovery``) on the device:
    the health word (C,) int32 and the probe ring (C, window) fp32,
    -inf padded. ``check`` is the reference's per-round update."""

    def __init__(self, rec, c: int, device, probe_fn):
        self.rec = rec
        self.word = torch.zeros(c, dtype=torch.int32, device=device)
        self.lp_win = torch.full((c, rec.window), float("-inf"),
                                 dtype=torch.float32, device=device)
        # nearest-rank quantile, not torch.quantile: a lerp between -inf
        # (warm-up padding) and a finite probe would be NaN
        self.q_idx = min(rec.window - 1,
                         int(rec.quantile * (rec.window - 1)))
        self.probe_fn = probe_fn

    def lp_ref(self) -> torch.Tensor:
        return torch.sort(self.lp_win, dim=1).values[:, self.q_idx]

    def check(self, r: int, bad_new: torch.Tensor, probe_args):
        """Update the word (and ring) from round ``r``'s finite check
        ``bad_new`` and, with the detector, the probe; returns (chains to
        replace, donor, any healthy) — donor and any_h for respawn."""
        rec, word = self.rec, self.word
        lp = None
        if rec.use_detector:
            lp = self.probe_fn(*probe_args)
            bad_new = bad_new | ~torch.isfinite(lp) | \
                (lp < self.lp_ref() - rec.divergence_threshold)
            pushed = torch.cat([self.lp_win[:, 1:], lp[:, None]], dim=1)
        if rec.policy == "quarantine":
            bad = (word != 0) | bad_new
            self.word = torch.where((word == 0) & bad_new, r + 1, word)
            if lp is not None:
                # quarantined chains' windows freeze with them
                self.lp_win = torch.where(
                    (bad | ~torch.isfinite(lp))[:, None], self.lp_win,
                    pushed)
            return bad, None, None
        self.word = word + bad_new.to(word.dtype)
        healthy = ~bad_new
        donor = torch.argmax(healthy.to(torch.int32))
        if lp is not None:
            # respawned chains restart an empty window (their donor's
            # plateau is not theirs)
            self.lp_win = torch.where(
                (healthy & torch.isfinite(lp))[:, None], pushed,
                self.lp_win)
            self.lp_win = torch.where(bad_new[:, None], float("-inf"),
                                      self.lp_win)
        return bad_new, donor, healthy.any()

    def report(self) -> RunHealth:
        return RunHealth(
            word=self.word.cpu().numpy(), policy=self.rec.policy,
            lp_ref=(self.lp_ref().cpu().numpy() if self.rec.use_detector
                    else None))


# ---------------------------------------------------------------------------
# per-round telemetry (obs.telemetry)
# ---------------------------------------------------------------------------

def _sq(tree, c: int) -> torch.Tensor:
    """(c,) fp32 per-chain sum of squares over every leaf."""
    acc = None
    for leaf in tu.leaves(tree):
        v = leaf.to(torch.float32).reshape(c, -1).square().sum(1)
        acc = v if acc is None else acc + v
    return acc


def _drift_sq(thetas, pre, c: int) -> torch.Tensor:
    """(c,) fp32 ||theta - pre||^2, leaf by leaf."""
    acc = None
    for a, b in zip(tu.leaves(thetas), tu.leaves(pre)):
        v = (a.to(torch.float32) - b.to(torch.float32)).reshape(c, -1) \
            .square().sum(1)
        acc = v if acc is None else acc + v
    return acc


def _packed_conducive_sq(layout: kops.PackedChains, thetas, opnds, f_s,
                         alpha: float) -> torch.Tensor:
    """(C,) fp32 ||g_s(theta)||^2 from the packed round's own gathered
    operands (no second gather of the client means), leaf by leaf:
    g_s = alpha (lam_g (mu_g - theta) - lam_s (mu_s - theta) / f_s)."""
    variant, ops, lam_g_leaf, lam_s_leaf = opnds
    c = f_s.shape[0]
    mu_g, mu_s = layout.views(ops["mu_g"]), layout.views(ops["mu_s"])
    if variant == "diag":
        lam_g, lam_s = layout.views(ops["lam_g"]), layout.views(ops["lam_s"])
    acc = torch.zeros(c, dtype=torch.float32, device=f_s.device)
    f = f_s[:, None]
    for i, (th, mg, ms) in enumerate(zip(tu.leaves(thetas),
                                         tu.leaves(mu_g), tu.leaves(mu_s))):
        t = th.to(torch.float32).reshape(c, -1)
        if variant == "diag":
            lg = tu.leaves(lam_g)[i].reshape(1, -1)
            ls = tu.leaves(lam_s)[i].reshape(c, -1)
        else:
            lg, ls = lam_g_leaf[i], lam_s_leaf[:, i:i + 1]
        g = alpha * (lg * (mg.reshape(1, -1) - t)
                     - ls * (ms.reshape(c, -1) - t) / f)
        acc += g.square().sum(1)
    return acc


def _bank_conducive_sq(bank: SurrogateBank, glob: Gaussian, thetas, rows,
                       f_s, alpha: float, device) -> torch.Tensor:
    """(C,) fp32 ||g_s(theta)||^2 against a SurrogateBank (the vmap and
    per-leaf executors): the held clients' rows gathered where the bank
    lies, the conducive gradient vmapped over chains
    (``core.conducive.conducive_gradient``)."""
    def rows_of(tree):
        return tu.tree_map(lambda a: a[rows.to(a.device)].to(device), tree)

    g = vmap(lambda t, mu, lam, f: conducive_gradient(
        t, glob, Gaussian(mu, lam, bank.kind), f, alpha))(
        thetas, rows_of(bank.means), rows_of(bank.precs), f_s)
    return _sq(g, f_s.shape[0])


class _Metrics:
    """One run's telemetry rows, kept on the device between syncs: each
    round appends a (C,) fp32 tensor per metric; ``flush`` brings the
    segment's rows to the host in ONE transfer and returns their means
    for the progress event."""

    def __init__(self, tel: Telemetry, c: int):
        self.tel, self.c = tel, c
        self.pending = []        # per round: [(C,)] in tel.names order
        self.rows = []           # flushed (seg, M, C) host arrays

    def add(self, m: dict) -> None:
        self.pending.append(torch.stack([m[n] for n in self.tel.names]))

    def flush(self) -> dict:
        seg = torch.stack(self.pending).cpu().numpy()   # (seg, M, C)
        self.pending = []
        self.rows.append(seg)
        return {n: float(seg[:, i].mean())
                for i, n in enumerate(self.tel.names)}

    def frame(self) -> MetricsFrame:
        if self.pending:
            self.flush()
        if not self.rows:
            return MetricsFrame({n: np.zeros((0, self.c), np.float32)
                                 for n in self.tel.names})
        allr = np.concatenate(self.rows).astype(np.float32)
        return MetricsFrame({n: np.ascontiguousarray(allr[:, i])
                             for i, n in enumerate(self.tel.names)})


# ---------------------------------------------------------------------------
# the streamed client axis
# ---------------------------------------------------------------------------

def replay_sids(generator: torch.Generator, engine: "MeshChainEngine", *,
                num_rounds: int, n_chains: int,
                reassign: str = "permutation", federation=None,
                dim: int = 0, num_leaves: int = 1,
                noise_like: Optional[PyTree] = None) -> np.ndarray:
    """(num_rounds, n_chains) int32 — the client each chain HOLDS at every
    round of ``engine.run(generator, ...)``, replayed on a CLONE of the
    generator (a new generator on its device with its state), so
    ``generator`` itself is untouched. Every round is drawn by the
    engine's own ``draw_round`` with the federation, the round and the
    held ids threaded through as the run threads them, so the replay
    consumes exactly what the run consumes (``draw_round`` draws the same
    amount whatever clients it draws; the compression uniforms, drawn on
    communication rounds only, need the run's flat parameter count
    ``dim``). ``federation``: the resolved scenario the run uses (None
    for the path without one; FA-LD's run passes its identity
    ``Federation()``). ``noise_like``: the (C, ...) chain states of a run
    on the plain 'vmap' executor, whose steps draw their Gaussian noise
    from the run's generator after the round's draws (one draw shaped
    like the states per local step, Langevin or SGHMC): the replay draws
    (and drops) the same."""
    clone = torch.Generator(device=generator.device)
    clone.set_state(generator.get_state())
    held = (torch.zeros(n_chains, dtype=torch.int64, device=clone.device)
            if federation is not None else None)
    out = []
    for r in range(num_rounds):
        d = draw_round(clone, engine.cfg, engine.scheme, n_chains=n_chains,
                       minibatch=engine.minibatch, num_leaves=num_leaves,
                       reassign=reassign, federation=federation, r=r,
                       held=held, dim=dim)
        if federation is not None:
            exch = exchanging(federation.schedule, r, d.part_u, d.sids)
            held = torch.where(exch, d.sids, held)
            out.append(held)
        else:
            out.append(d.sids)
        if noise_like is not None:
            for _ in range(engine.cfg.local_updates):
                tree_randn_like(clone, noise_like)
    return torch.stack(out).cpu().numpy().astype(np.int32)


class _Streamer:
    """The resident window of a streamed run: stages window ``w``'s
    client rows, bank rows, resident ids and per-round resident-local
    rows. On a card the host builds the rows into pinned buffers (double
    buffered: window w + 2 reuses window w's only after its copy landed)
    and copies them with ``non_blocking=True`` on a side stream; the
    window's first round waits on the copy's event, and the staged
    tensors are recorded on the main stream so the caching allocator
    never hands their memory out while a round still reads them."""

    def __init__(self, engine, windows, holds, bank_rows, device,
                 prefetch: bool):
        self.engine, self.windows, self.holds = engine, windows, holds
        self.bank_rows, self.device = bank_rows, device
        self.prefetch = prefetch
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.pinned = [None, None]
        self.landed = [None, None]

    def _host(self, w: int):
        win = self.windows[w]
        ids = np.asarray(win.resident_ids, np.int64)
        blk = self.holds[win.r0:win.r0 + win.length]
        local = np.searchsorted(ids, blk).astype(np.int64)
        return ids, local

    def stage(self, w: int):
        """(client rows, bank rows, ids, local rows (L, C), ready event)
        of window ``w`` on the device."""
        ids, local = self._host(w)
        eng = self.engine
        if not self.cuda or not self.prefetch:
            # the CPU, or the serial A/B reference: copies on the main
            # stream, the host waiting for them
            ids_d = torch.as_tensor(ids, device=self.device)
            return (tu.tree_map(lambda t: t.to(self.device),
                                eng._client_rows(ids)),
                    self.bank_rows(ids_d), ids_d,
                    torch.as_tensor(local, device=self.device), None)
        b = w % 2
        if self.landed[b] is not None:
            self.landed[b].synchronize()  # window w - 2's copy has landed
        host = {"ids": torch.from_numpy(ids),
                "local": torch.from_numpy(local)}
        if eng._source is not None:
            host["rows"] = eng._client_rows(ids)   # built on the host
        buf = self.pinned[b]
        if buf is None or tu.flatten(buf)[1] != tu.flatten(host)[1] or \
                not all(x.shape == y.shape and x.dtype == y.dtype
                        for x, y in zip(tu.leaves(buf), tu.leaves(host))):
            buf = self.pinned[b] = tu.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True), host)
        tu.tree_map(lambda dst, src: dst.copy_(src), buf, host)
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.side):
            dev = tu.tree_map(lambda t: t.to(self.device, non_blocking=True),
                              buf)
            ids_d = dev["ids"]
            data = dev["rows"] if eng._source is not None else \
                tu.tree_map(lambda d: d[ids_d], eng.shard_data)
            bank = self.bank_rows(ids_d)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.landed[b] = ev
        for t in tu.leaves((data, _bank_tensors(bank), ids_d, dev["local"])):
            if t.device == self.device:
                t.record_stream(main)
        return data, bank, ids_d, dev["local"], ev


def _bank_tensors(bank) -> list:
    """The tensors of a window's bank rows (a packed operand dict or a
    SurrogateBank)."""
    if bank is None:
        return []
    if isinstance(bank, dict):
        return list(bank.values())
    return tu.leaves((bank.means, bank.precs))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshChainEngine:
    """Multi-chain FSGLD runtime on one device, or on a mesh of ranks.

    shard_data: pytree with leaves (S, max_n, ...) on the run's device —
    shards padded to the longest client; ``sizes`` carries the true
    per-client counts (None => uniform). Or a lazy client source
    (``fed.partition.is_client_source``: ``SyntheticClientSource``,
    ``PartitionedSource``) with its own sizes, on ``device``: a resident
    run materialises every client once (``_data``), a streamed run only
    each window's (``_client_rows``). ``use_kernel`` selects the fused
    kernel executors: ``packed`` True/None (None: per-leaf for non-float
    leaves) or False (per-leaf); ``use_kernel=False`` is the plain vmap
    executor.

    ``dynamics='sghmc'`` runs federated SGHMC (``core.sghmc``; ``sghmc``
    its config, None for the defaults) over (theta, momentum) chain state
    on every executor; the trace carries theta only.
    ``aggregation='fald'`` is FA-LD: on every communication round the
    exchanging chains are replaced by their mean, and every chain samples
    at temperature x n_chains so that the average has the configured
    temperature; its rounds always take the federated path (even without
    a federation), so it shares that path's draws. Langevin only.
    ``stream_hook(window_idx, StreamWindow)`` fires after each streamed
    window's rounds are dispatched.

    ``mesh`` (a ``launch.mesh`` DeviceMesh with 'data' and 'model' axes;
    None: this one device) puts the chains on 'data' (each rank a
    ``ChainBlock``, odd counts padded) and the refresh's clients on
    'model'; every rank holds the whole shard stack and bank, as the
    reference replicates them, and ``device`` is the rank's own.
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
    sghmc: Optional[SGHMCConfig] = None
    aggregation: str = "none"
    device: Any = None
    stream_hook: Any = None
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None and "data" not in self.mesh.mesh_dim_names:
            raise ValueError("the engine's mesh needs a 'data' axis, got "
                             f"{self.mesh.mesh_dim_names}")
        if self.dynamics not in ("langevin", "sghmc"):
            raise ValueError(f"unknown dynamics {self.dynamics!r}")
        if self.aggregation not in ("none", "fald"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             "available: none, fald")
        if self.aggregation == "fald" and self.dynamics != "langevin":
            raise NotImplementedError(
                "aggregation='fald' is a Langevin-dynamics algorithm "
                "(FA-LD averages overdamped clients); it does not "
                f"compose with dynamics={self.dynamics!r}")
        if self.dynamics == "sghmc" and self.sghmc is None:
            self.sghmc = SGHMCConfig()
        self._source = (self.shard_data
                        if is_client_source(self.shard_data) else None)
        self._resident_cache = None
        if self._source is not None:
            s = int(self._source.num_clients)
            if self.device is None:
                raise ValueError("an engine on a client source needs its "
                                 "device")
            if self.sizes is not None:
                raise ValueError("a client source carries its own sizes")
            sizes = np.asarray(self._source.sizes, np.int64)
            if sizes.shape != (s,) or \
                    int(sizes.max()) != int(self._source.max_size):
                raise ValueError(f"client source sizes {sizes.shape} do not "
                                 f"fit its {s} clients / max_size")
            self.device = torch.device(self.device)
        else:
            leaf = tu.leaves(self.shard_data)[0]
            s, max_n = leaf.shape[0], leaf.shape[1]
            sizes = ((max_n,) * s if self.sizes is None
                     else tuple(int(n) for n in self.sizes))
            if len(sizes) != s or max(sizes) != max_n:
                raise ValueError(f"sizes {sizes} do not fit shards padded "
                                 f"to {max_n}")
            self.device = leaf.device
        if s != self.cfg.num_shards:
            raise ValueError(f"shard_data holds {s} shards, the config "
                             f"{self.cfg.num_shards}")
        self.scheme = ShardScheme(sizes=sizes, probs=self.cfg.probs())

    # -- client-axis materialisation ---------------------------------------

    def _data(self) -> PyTree:
        """The FULL (S, max_n, ...) shard stack for resident runs, built
        (once) from a client source on first use; the streamed path never
        calls this."""
        if self._source is None:
            return self.shard_data
        if self._resident_cache is None:
            self._resident_cache = tu.tree_map(
                lambda a: torch.as_tensor(a).to(self.device),
                self._source.rows(np.arange(self.cfg.num_shards)))
        return self._resident_cache

    def _client_rows(self, ids) -> PyTree:
        """(K, max_n, ...) rows of the clients ``ids`` for one resident
        window: built on the host from a client source (ONLY those
        clients), else gathered from the stack where it lies. Either way
        the bytes a streamed round reads are the resident path's."""
        if self._source is not None:
            return tu.tree_map(torch.as_tensor, self._source.rows(ids))
        idx = torch.as_tensor(np.asarray(ids, np.int64),
                              device=tu.leaves(self.shard_data)[0].device)
        return tu.tree_map(lambda d: d[idx], self.shard_data)

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

    def _check_stream(self, stream, *, reassign, refresh_every,
                      snapshot_every, resume, recovery, chaos, telemetry):
        """The streamed client axis composes only with the replayable,
        window-local features; the rest is refused (the reference's
        words)."""
        if self.cfg.method == "sgld":
            raise NotImplementedError(
                "stream= does not compose with method='sgld': pooled "
                "sampling draws from the virtual concatenation of ALL "
                "clients and needs them resident")
        if reassign != "permutation":
            raise NotImplementedError(
                f"stream= requires reassign='permutation' (got "
                f"{reassign!r}): the resident-set planner replays the "
                "collision-free permutation stream; categorical "
                "draws are not plannable ahead of the scan")
        if refresh_every:
            raise NotImplementedError(
                "stream= does not compose with refresh_every: the "
                "surrogate re-fit is a pass over ALL clients' data")
        if snapshot_every or resume:
            raise NotImplementedError(
                "stream= does not compose with snapshots/resume yet: "
                "the window plan is not part of the snapshot payload")
        if recovery is not None or chaos is not None:
            raise NotImplementedError(
                "stream= does not compose with recovery/chaos yet")
        if telemetry is not None:
            raise NotImplementedError(
                "stream= does not compose with telemetry= yet: the "
                "metric rows are not part of the window plan (the "
                "host-side prefetch/overlap SPANS still fire — see "
                "repro_torch.obs.trace)")
        if stream.resident > self.cfg.num_shards:
            raise ValueError(
                f"Stream(resident={stream.resident}) exceeds the "
                f"client count ({self.cfg.num_shards}); resident is "
                "the ON-DEVICE subset size and must be <= the number "
                "of clients — lower resident, or raise the client "
                "count")

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
        ``collect=False`` ((theta, momentum) pairs for SGHMC).
        ``stacked=True`` takes ``theta0`` as per-chain states with a
        leading (n_chains, ...) axis; SGHMC pairs them with zero momenta.
        ``theta0`` may lie on another device than the run (the host, say):
        the packed executor copies it leaf by leaf into its state buffer,
        the others into a device copy, and the run never writes it.

        ``federation`` (a ``repro_torch.fed.Federation`` or a registry
        name) applies the scenario's schedule and compression to the
        rounds; its partition is the facade's job. An engine-identity
        spec runs the path without a federation, bitwise.

        Fault tolerance. ``recovery`` (a ``core.health.Recovery``) checks
        every chain once per round, after the local steps, the straggler
        restore and any chaos: a non-finite theta (or momentum, SGHMC
        with ``check_momentum``) or, with the detector, a probed
        log-posterior below its window quantile by more than the
        threshold, quarantines the chain (frozen at its pre-round state,
        out of the exchange, its round's trace columns repeating the
        frozen state) or respawns it from the first healthy chain; the
        call then returns ``(result, RunHealth)``. A fault-free run with
        recovery on is bitwise the run with it off (the probe draws from
        ``probe_generator``). ``chaos`` (a ``testing.ChaosSpec``,
        duck-typed) NaNs the chosen chains' post-round theta, or their
        compressed payload, at the chosen absolute rounds.

        ``snapshot_every=k, snapshot_path=dir`` saves the whole carry
        (chains, the generator's state, the federation carry, the health
        state, the trace so far) after every k rounds and at the end;
        ``resume=True`` continues from the newest valid snapshot in
        ``snapshot_path`` at its absolute round (a fresh run when there is
        none), bitwise the uninterrupted run.

        ``telemetry`` (an ``obs.Telemetry``) computes per-round per-chain
        metric rows after each round's straggler restore and health check
        and APPENDS an ``obs.MetricsFrame`` of this call's rounds to the
        return value, built in order (result[, health][, frame]). The
        rows stay on the device and come to the host once per
        ``telemetry.log_every`` rounds (and at the end), where an
        ``engine.progress`` event is emitted; the probe rows draw their
        minibatch from ``probe_generator(generator, r,
        TELEMETRY_PROBE_SALT)``, so a telemetry-on run is bitwise the run
        without it.

        ``stream`` (a ``fed.Stream``) keeps only ``stream.resident``
        clients on the device: the window plan comes from replaying the
        run's own draws (``replay_sids``), every round asserts on the
        device that each chain's held client is in its window, and the
        next window's rows are staged (``Stream.prefetch``: on a side
        stream) after the current window's rounds are dispatched.
        Streamed runs are bitwise the resident runs.

        ``refresh_every`` (FSGLD, a flat-vector 'diag' bank): at every
        round r > 0 with r % refresh_every == 0 the bank is re-fitted at
        the mean of the real chains (``refresh``; an ``engine.refresh``
        span) and the rounds from there on use it. The fit draws nothing,
        so the run draws exactly what the run without refresh draws.

        On a mesh every rank runs its ``ChainBlock`` and returns the
        gathered result, the one-device run's. A snapshot is the gathered
        carry (the real chains, the generator, the run's client ids, the
        compression carry's real rows, the trace), written by global rank
        0 while the others wait; a resume reads it on every rank and each
        takes its block's rows again, the pad chains repeating chain 0.
        Recovery and telemetry gather what each rank computes for its
        block (the finite checks, the probes, the metric rows) across
        'data': every rank keeps the whole run's health words and makes
        the same quarantine, respawn and donor choice, and a respawned
        chain takes its donor's row from the rank that holds it, so both
        are bitwise the one-device run's."""
        hmc = self.sghmc if self.dynamics == "sghmc" else None
        chaos = chaos if chaos is not None and chaos.active else None
        if stream is not None:
            self._check_stream(stream, reassign=reassign,
                               refresh_every=refresh_every,
                               snapshot_every=snapshot_every, resume=resume,
                               recovery=recovery, chaos=chaos,
                               telemetry=telemetry)
        if (snapshot_every or resume) and not snapshot_path:
            raise ValueError(
                "snapshot_every/resume need a snapshot_path directory")
        if telemetry is not None and telemetry.log_every and \
                (snapshot_every or refresh_every):
            raise NotImplementedError(
                "Telemetry.log_every does not compose with "
                "snapshot_every/refresh_every: pick ONE segmentation "
                "driver (progress events already fire at snapshot/"
                "refresh segment boundaries)")
        if snapshot_path and refresh_every:
            raise NotImplementedError(
                "snapshots do not compose with adaptive refresh yet: the "
                "refreshed surrogate bank is not part of the snapshot "
                "payload")
        if hmc is not None and refresh_every:
            raise NotImplementedError(
                "adaptive refresh is not wired for sghmc dynamics")
        if reassign not in ("categorical", "permutation"):
            raise ValueError(reassign)
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"run on {self.device}")
        agg = self.aggregation == "fald"
        fed = get_scenario(federation) if federation is not None else None
        if fed is not None and fed.engine_identity:
            fed = None
        if fed is not None and refresh_every and self.cfg.method == "fsgld":
            raise NotImplementedError(
                "adaptive refresh does not compose with a non-identity "
                "communication schedule/compression yet: the carried "
                "sids / error-feedback state would reset at every "
                "refresh segment boundary")
        if agg and fed is None:
            fed = Federation()  # FA-LD: every round exchanges, exactly
        C, T = n_chains, self.cfg.local_updates
        # this rank's chains (the whole run without a mesh); C counts the
        # run's chains, Cl the rows held here
        block = ChainBlock.of(C, self.mesh)
        Cl = block.per
        gather = None if self.mesh is None else block.gather
        if stacked:
            if tu.leaves(theta0)[0].shape[0] != C:
                raise ValueError("stacked theta0 needs a leading "
                                 f"(n_chains={C}, ...) axis")
            example = tu.tree_map(lambda t: t[0], theta0)
        else:
            example = theta0
        layout = self._layout_for(example)
        dev = self.device
        if stacked:
            theta0 = block.take_tree(theta0)
        if layout is not None:
            # (Cl, ...) views of theta0, wherever it lies: packing copies
            chains = theta0 if stacked else tu.tree_map(
                lambda t: torch.broadcast_to(t, (Cl,) + t.shape), theta0)
        elif stacked:
            chains = tu.tree_map(lambda t: t.to(dev).clone(), theta0)
        else:
            chains = tu.tree_map(lambda t: torch.broadcast_to(
                t.to(dev), (Cl,) + t.shape).clone(), theta0)
        num_leaves = len(tu.leaves(chains))
        fsgld_bank = self.bank if self.cfg.method == "fsgld" else None
        bank_kind = fsgld_bank.kind if fsgld_bank is not None else None
        refreshing = bool(refresh_every) and self.cfg.method == "fsgld"
        # FA-LD noise calibration: averaging C clients shrinks the noise
        # variance by C, so each client samples at temperature * C
        cfg = (dataclasses.replace(
            self.cfg, temperature=self.cfg.temperature * C) if agg
            else self.cfg)
        kw = {}
        if layout is not None:
            round_fn = make_packed_round_fn(
                self.log_lik_fn, cfg, self.scheme, self.minibatch,
                bank_kind, layout, hmc, block)
            bank_arg = pack_bank(layout, fsgld_bank, dev)

            def install(bank):
                nonlocal bank_arg
                bank_arg = pack_bank(layout, bank, dev)

            def bank_rows(ids):
                # a window's client rows (a stack on the host stays whole,
                # read by the window's ids); the global operands untouched
                if bank_arg is None:
                    return None
                out = dict(bank_arg)
                for k in ("means", "precs", "lam_s_leaf"):
                    if k not in out:
                        continue
                    st = out[k]
                    out[k] = (st[ids] if st.device == ids.device
                              else (st, ids))
                return out

            def from_chains(th, mom=None):
                # SGHMC momenta: zero unless given
                th_p = layout.pack(th, device=dev)
                r_p = (torch.zeros_like(th_p) if mom is None
                       else layout.pack(mom, device=dev))
                return ((th_p, r_p, layout.unpack(th_p)) if hmc
                        else (th_p, layout.unpack(th_p)))

            def snapshot(st):
                # the round updates the buffers in place: copy them
                bufs = tuple(b.clone() for b in st[:-1])
                return bufs + (layout.unpack(bufs[0]),)

            def thetas_of(st):
                return st[-1]

            def with_thetas(st, th):
                th_p = layout.pack(th)
                return (th_p,) + st[1:-1] + (layout.unpack(th_p),)

            def mapstate(fn, st, pre):
                bufs = tuple(fn(a, b) for a, b in zip(st[:-1], pre[:-1]))
                return bufs + (layout.unpack(bufs[0]),)

            def finite(st, momentum):
                return _finite_rows(st[:2] if momentum else st[:1], Cl)

            def final(st):
                return (st[-1], layout.unpack(st[1])) if hmc else st[-1]
        else:
            if self.use_kernel:
                round_fn = make_chain_round_fn(
                    self.log_lik_fn, cfg, self.scheme, self.minibatch,
                    bank_kind, hmc, block)
                bank_arg = fsgld_bank
            else:
                bank_arg = None
                kw["generator"] = generator

            def install(bank):
                nonlocal round_fn, bank_arg
                if self.use_kernel:
                    bank_arg = bank
                    return
                # the plain drift indexes the bank under vmap: on the device
                round_fn = make_round_fn(
                    self.log_lik_fn, cfg, self.scheme, self.minibatch,
                    bank.to(dev) if bank is not None else None, hmc, block)

            if not self.use_kernel:
                install(fsgld_bank)

            def bank_rows(ids):
                if fsgld_bank is None:
                    return None
                b = fsgld_bank if self.use_kernel else fsgld_bank.to(dev)

                def rows(t):
                    return tu.tree_map(lambda a: a[ids.to(a.device)], t)

                return SurrogateBank(rows(b.means), rows(b.precs),
                                     b.global_, b.kind)

            def from_chains(th, mom=None):
                if hmc:
                    return (th, init_momentum(th) if mom is None else mom)
                return th

            def thetas_of(st):
                return st[0] if hmc else st

            def with_thetas(st, th):
                return (th, st[1]) if hmc else th

            def mapstate(fn, st, pre):
                return tu.tree_map(fn, st, pre)

            def finite(st, momentum):
                return _finite_rows(tu.leaves(st if momentum
                                              else thetas_of(st)), Cl)

            def final(st):
                return st

            def snapshot(st):
                return st

        def restore(st, pre, m):
            return mapstate(lambda a, b: _keep(m, a, b), st, pre)

        state = from_chains(chains)
        chains = thetas_of(state)
        per_round = -(-T // collect_every)
        trace = None
        if collect:
            trace = tu.tree_map(
                lambda t: torch.empty((Cl, num_rounds * per_round)
                                      + tuple(t.shape[1:]), dtype=t.dtype,
                                      device=t.device), chains)
        # sids: the client every chain of the run holds (global on every
        # rank: the next round's draws read it); cst: this block's rows
        sids, cst, dim = None, None, 0
        if fed is not None:
            sched = fed.schedule
            exchange, carry0 = make_exchange(fed.compression, agg, chains,
                                             gather)
            exchanges = agg or not fed.compression.identity
            cst = carry0(chains)
            sids = torch.zeros(C, dtype=torch.int64, device=self.device)
            dim = sum(l[0].numel() for l in tu.leaves(chains))
        sample = _make_batch_sampler(self.cfg, self.scheme)

        def probe_batch(pgen, run_sids):
            """One probe minibatch's rows per chain from ``pgen`` (uniform
            over each held client's live prefix; pooled for SGLD), drawn
            for the run's chains (``run_sids`` global) and this block's
            rows taken."""
            u = torch.rand((C, self.minibatch), generator=pgen, device=dev,
                           dtype=torch.float64)
            bound = (torch.tensor(self.scheme.total, device=dev)
                     if self.cfg.method == "sgld" else
                     self.scheme.sizes_array(dev)[run_sids][:, None])
            idx = torch.minimum((u * bound).floor().to(torch.int64),
                                bound - 1)
            return block.take(idx)

        health = None
        if recovery is not None:
            lp_v = vmap(self.log_lik_fn)

            def probe(pgen, th, run_sids, rows, data):
                """log p(x | th) on one probe minibatch per chain minus
                the prior's 1/2 prec |th|^2, fp32, for the run's chains."""
                idx = probe_batch(pgen, run_sids)
                with torch.no_grad():
                    lp = lp_v(th, sample(idx, rows, data))
                    sq = sum(l.to(torch.float32).square().reshape(Cl, -1)
                             .sum(1) for l in tu.leaves(th))
                return block.gather(lp.to(torch.float32)
                                    - 0.5 * self.cfg.prior_precision * sq)

            health = _Health(recovery, C, dev, probe)
        check_mom = hmc is not None and recovery is not None \
            and recovery.check_momentum

        metrics = None
        if telemetry is not None:
            metrics = _Metrics(telemetry, C)
            if hmc is not None:
                # SGHMC's noise term sqrt(2 a tau) sqrt(h) xi
                noise = math.sqrt(2.0 * hmc.friction * hmc.temperature
                                  * cfg.step_size)
            else:
                noise = math.sqrt(cfg.step_size * cfg.temperature)
            tel_dim = sum(l[0].numel() for l in tu.leaves(chains))
            wire = (float(fed.compression.bytes_per_round(tel_dim))
                    if fed is not None else 8.0 * tel_dim)
            vg = vmap(grad_and_value(self.log_lik_fn)) \
                if telemetry.probe else None

            def tel_rows(st, pre_th, run_sids, rows, exch, opnds):
                """One round's closed-form metric rows, each (C,) fp32,
                after the round's masking: frozen chains show zero drift
                and quarantined ones their word. Each is computed for
                this block's chains and gathered."""
                th = thetas_of(st)
                m = {"theta_norm": _sq(th, Cl).sqrt(),
                     "drift_norm": _drift_sq(th, pre_th, Cl).sqrt()}
                if fsgld_bank is not None:
                    _, f_s = chain_scales(self.cfg, self.scheme, run_sids,
                                          self.minibatch)
                    if layout is not None:
                        sq = _packed_conducive_sq(layout, th, opnds, f_s,
                                                  self.cfg.alpha)
                    else:
                        # the bank in use (a refresh replaces it)
                        glob = Gaussian(*(tu.tree_map(
                            lambda a: a.to(dev), g) for g in (
                            fsgld_bank.global_.mean,
                            fsgld_bank.global_.prec)), fsgld_bank.kind)
                        sq = _bank_conducive_sq(fsgld_bank, glob, th, rows,
                                                f_s, self.cfg.alpha, dev)
                    m["conducive_norm"] = sq.sqrt()
                else:
                    m["conducive_norm"] = torch.zeros(
                        Cl, dtype=torch.float32, device=dev)
                part = (exch.to(torch.float32) if exch is not None else
                        torch.ones(Cl, dtype=torch.float32, device=dev))
                m["participation"] = part
                m["bytes_per_round"] = part * wire
                m = {k: block.gather(v) for k, v in m.items()}
                m["noise_scale"] = torch.full((C,), noise,
                                              dtype=torch.float32,
                                              device=dev)
                m["health_word"] = (
                    health.word.to(torch.float32) if health is not None
                    else torch.zeros(C, dtype=torch.float32, device=dev))
                return m

            def probe_rows(st, run_sids, rows, tgen, data):
                """grad_norm and log_post at the round-end state on one
                probe minibatch from ``tgen``."""
                th = thetas_of(st)
                idx = probe_batch(tgen, run_sids)
                g, lp = vg(th, sample(idx, rows, data))
                gn = _sq(g, Cl).sqrt()
                del g
                return {"grad_norm": block.gather(gn),
                        "log_post": block.gather(
                            lp.to(torch.float32)
                            - 0.5 * self.cfg.prior_precision * _sq(th, Cl))}

        def payload(st, rounds_done):
            """The whole carry after ``rounds_done`` rounds, gathered from
            the mesh's ranks: everything a resumed run needs to be bitwise
            the uninterrupted one."""
            p = {"chains": block.gather_tree(final(st)),
                 "key": generator.get_state()}
            if fed is not None:
                p["sids"] = sids.to(torch.int32)
                if cst is not None:
                    p["ref"], p["err"] = (block.gather(cst[0]),
                                          block.gather(cst[1]))
                    if len(cst) == 3:
                        p["derr"] = block.gather(cst[2])
            if health is not None:
                p["word"], p["lp_ref"] = health.word, health.lp_win
            if collect:
                p["trace"] = block.gather_tree(tu.tree_map(
                    lambda t: t[:, :rounds_done * per_round], trace))
            return p

        r_start = 0
        if resume:
            snap, r_start = latest_snapshot(snapshot_path,
                                            payload(state, 0))
            if snap is None:
                r_start = 0       # nothing to resume: a fresh run
            else:
                # each rank takes its block's rows of the gathered carry
                ch = tu.tree_map(lambda t: block.take(t.to(dev)),
                                 snap["chains"])
                state = from_chains(*ch) if hmc else from_chains(ch)
                generator.set_state(snap["key"])
                if fed is not None:
                    sids = snap["sids"].to(dev, torch.int64)
                    if cst is not None:
                        cst = tuple(block.take(snap[k].to(dev)) for k in
                                    ("ref", "err", "derr")[:len(cst)])
                if health is not None:
                    health.word = snap["word"].to(dev)
                    health.lp_win = snap["lp_ref"].to(dev)
                if collect:
                    tu.tree_map(
                        lambda dst, src: dst[:, :src.shape[1]].copy_(
                            block.take(src)), trace, snap["trace"])
        quarantine = recovery is not None and recovery.policy == "quarantine"

        def one_round(r, data, bank_r, rows=None, window_ids=None):
            """Round ``r`` on ``data`` / ``bank_r`` (the resident stacks,
            or a streamed window's, whose rows of the held clients are
            ``rows``)."""
            nonlocal state, sids, cst

            def keep(t, thetas):
                if t % collect_every == 0:
                    k = r * per_round + t // collect_every
                    tu.tree_map(lambda dst, src: dst[:, k].copy_(src),
                                trace, thetas)

            on_step = keep if collect else None
            pgen = (probe_generator(generator, r) if health is not None
                    and recovery.use_detector else None)
            tgen = (probe_generator(generator, r, TELEMETRY_PROBE_SALT)
                    if metrics is not None and telemetry.probe else None)
            live = health.word == 0 if quarantine else None
            # the whole round's draws, then this block's rows of them
            draws = draw_round(generator, self.cfg, self.scheme, n_chains=C,
                               minibatch=self.minibatch,
                               num_leaves=num_leaves, reassign=reassign,
                               federation=fed, r=r, held=sids, dim=dim,
                               live=live)
            strag = pre = exch = None
            if fed is not None:
                exch = exchanging(sched, r, draws.part_u, sids)
                if live is not None:
                    # quarantined chains neither reassign nor exchange
                    exch = exch & live
                sids = torch.where(exch, draws.sids, sids)
                draws.sids = sids
                run_sids = sids
                draws, exch = block.draws(draws), block.take(exch)
                if exchanges and fsched.comm_mask(sched, r):
                    poison = None
                    if chaos is not None and chaos.poisons_payload \
                            and r in chaos.payload_nan_rounds:
                        poison = block.take(_chain_mask(
                            chaos.payload_nan_chains, C, dev))
                    th, cst = exchange(thetas_of(state), cst, exch, draws,
                                       poison)
                    state = with_thetas(state, th)
                if draws.strag_u is not None:
                    # dropped updates: the state goes back to its
                    # pre-round value and the trace repeats it
                    strag = fsched.straggler_mask(sched, draws.strag_u)
            else:
                run_sids = draws.sids
                draws = block.draws(draws)
            if window_ids is not None:
                # the replayed plan put every held client in this window
                torch._assert_async((window_ids[rows] == draws.sids).all())
            held_rows = draws.sids if rows is None else rows
            if strag is not None or health is not None or \
                    metrics is not None:
                pre = snapshot(state)
            if strag is not None and on_step is not None:
                def on_step(t, thetas, frozen=thetas_of(pre)):
                    keep(t, tu.tree_map(lambda a, b: _keep(strag, a, b),
                                        thetas, frozen))
            extra = dict(kw)
            if rows is not None:
                extra["rows"] = rows
            opnds = None
            if metrics is not None and layout is not None and \
                    fsgld_bank is not None:
                opnds = round_fn.operands(held_rows, bank_r, dev)
                extra["opnds"] = opnds
            state = round_fn(state, draws, data, bank_r, on_step=on_step,
                             **extra)
            if strag is not None:
                state = restore(state, pre, strag)
            if chaos is not None and chaos.poisons_state \
                    and r in chaos.nan_rounds:
                m = block.take(_chain_mask(chaos.nan_chains, C, dev))
                state = with_thetas(state, tu.tree_map(
                    lambda l: _keep(m, l, torch.full_like(l, float("nan")))
                    if l.dtype.is_floating_point else l, thetas_of(state)))
            if health is not None:
                # the whole run's checks on every rank, this block's rows
                # of what they replace
                repl, donor, any_h = health.check(
                    r, ~block.gather(finite(state, check_mom)),
                    (pgen, thetas_of(state), run_sids, held_rows, data))
                repl = block.take(repl)
                if donor is None:
                    state = restore(state, pre, repl)
                else:
                    on_mesh = None if self.mesh is None else block
                    state = mapstate(
                        lambda a, b: _respawn(repl, donor, any_h, a, b,
                                              on_mesh),
                        state, pre)
                if collect:
                    k0 = r * per_round
                    tu.tree_map(
                        lambda dst, f: dst[:, k0:k0 + per_round].copy_(
                            torch.where(
                                repl.view((Cl, 1) + (1,) * (f.ndim - 1)),
                                f[:, None], dst[:, k0:k0 + per_round])),
                        trace, thetas_of(state))
            m = None
            if metrics is not None:
                m = tel_rows(state, thetas_of(pre), draws.sids, held_rows,
                             exch, opnds)
            # the pre-round copy and the gathered means go before the
            # probe's gradient pass
            del pre, opnds, extra, on_step
            if tgen is not None:
                m.update(probe_rows(state, run_sids, held_rows, tgen,
                                    data))
            if m is not None:
                metrics.add(m)
            if snapshot_every and ((r + 1 - r_start) % snapshot_every == 0
                                   or r + 1 == num_rounds):
                p = payload(state, r + 1)
                if lmesh.is_writer(self.mesh):
                    save_snapshot(snapshot_path, p, rounds_done=r + 1)
                lmesh.barrier(self.mesh)

        if stream is None:
            seg_len = (telemetry.log_every if telemetry is not None
                       and telemetry.log_every else
                       refresh_every if refreshing else num_rounds)
            data = self._data()
            r0 = r_start
            while r0 < num_rounds:
                if refreshing and r0 > 0:
                    # a refresh boundary (r0 is a refresh_every multiple)
                    if fsgld_bank is None or fsgld_bank.kind != "diag":
                        raise NotImplementedError(
                            "adaptive refresh supports flat-parameter "
                            "'diag' banks only (got "
                            f"{getattr(fsgld_bank, 'kind', None)!r})")
                    center = tu.tree_map(lambda t: block.gather(t).mean(0),
                                         thetas_of(state))
                    with obs_trace.span("engine.refresh", round=int(r0)):
                        fsgld_bank = self.refresh(center)
                        install(fsgld_bank)
                seg = min(seg_len, num_rounds - r0)
                t_seg = time.monotonic()
                with obs_trace.span("engine.segment", r0=int(r0),
                                    rounds=int(seg)):
                    for r in range(r0, r0 + seg):
                        one_round(r, data, bank_arg)
                r0 += seg
                if metrics is not None and (telemetry.log_every
                                            or r0 >= num_rounds):
                    means = metrics.flush()  # the segment's one sync
                    if obs_trace.enabled():
                        dt = time.monotonic() - t_seg
                        steps = seg * T * C
                        obs_trace.event(
                            "engine.progress", round=int(r0),
                            rounds=int(num_rounds), seconds=round(dt, 6),
                            steps_per_s=round(steps / max(dt, 1e-9), 3),
                            **{k: round(v, 6) for k, v in means.items()})
        else:
            holds = replay_sids(generator, self, num_rounds=num_rounds,
                                n_chains=C, reassign=reassign,
                                federation=fed, dim=dim,
                                num_leaves=num_leaves,
                                noise_like=(None if self.use_kernel else
                                            tu.tree_map(lambda t: t.new_empty(
                                                (C,) + t.shape[1:]),
                                                thetas_of(state))))
            windows = fsched.plan_stream(holds, resident=stream.resident,
                                         window=stream.window)
            streamer = _Streamer(self, windows, holds, bank_rows, dev,
                                 stream.prefetch)
            t_run = time.monotonic()

            def timed_stage(w):
                t0 = time.monotonic()
                with obs_trace.span("stream.stage", window=w):
                    staged = streamer.stage(w)
                return staged, time.monotonic() - t0

            staged, first_s = timed_stage(0)
            stage_s = first_s
            for w, win in enumerate(windows):
                data_k, bank_k, ids_k, local_k, ready = staged
                if ready is not None:
                    torch.cuda.current_stream(dev).wait_event(ready)
                with obs_trace.span("stream.dispatch", window=w,
                                    r0=int(win.r0), rounds=int(win.length)):
                    for j in range(win.length):
                        one_round(win.r0 + j, data_k, bank_k,
                                  block.take(local_k[j]), ids_k)
                del data_k, bank_k, ids_k, local_k
                if w + 1 < len(windows):
                    if not stream.prefetch and dev.type == "cuda":
                        torch.cuda.synchronize(dev)  # no overlap: A/B
                    staged, ds = timed_stage(w + 1)
                    stage_s += ds
                if self.stream_hook is not None:
                    self.stream_hook(w, win)
            if obs_trace.enabled():
                wall = time.monotonic() - t_run
                hidden = stage_s - first_s  # post-dispatch stages only
                obs_trace.event(
                    "stream.prefetch_overlap", windows=len(windows),
                    prefetch=bool(stream.prefetch),
                    stage_s=round(stage_s, 6), wall_s=round(wall, 6),
                    overlap_frac=round(
                        (hidden / max(wall, 1e-9))
                        if stream.prefetch else 0.0, 6))
        res = block.gather_tree(trace if collect else final(state))
        out = (res,) if health is None else (res, health.report())
        if metrics is not None:
            out = out + (metrics.frame(),)
        return out[0] if len(out) == 1 else out

    def refresh(self, theta: torch.Tensor) -> SurrogateBank:
        """Adaptive surrogate refresh at ``theta`` (flat), the clients split
        over the mesh's 'model' axis (``refresh_bank_mesh``); the same math
        as ``core.federated.refresh_bank``."""
        return refresh_bank_mesh(self.log_lik_fn, self._data(), theta,
                                 self.mesh, sizes=self.scheme.sizes)


def refresh_bank_mesh(log_lik_fn: LogLikFn, shard_data: PyTree,
                      theta: torch.Tensor, mesh=None, *, sizes=None,
                      jitter: float = 1e-3, batch: int = 256
                      ) -> SurrogateBank:
    """``core.federated.refresh_bank`` with the client axis S split over
    the mesh's 'model' axis (S % |model| == 0): each model rank computes
    its clients' score sums and centered Fishers over their live prefixes
    (``sizes``), and the (S, P) statistics are all-gathered, so every rank
    builds the same bank. A client's statistics do not depend on the
    split, so the bank is bitwise the serial one (no mesh: the serial
    pass)."""
    from repro_torch.core.federated import bank_from_stats, refresh_stats
    S, max_n = tu.leaves(shard_data)[0].shape[:2]
    sizes = (max_n,) * S if sizes is None else tuple(sizes)
    m, i = lmesh.axis_size(mesh, "model"), lmesh.axis_rank(mesh, "model")
    if S % m:
        raise ValueError(f"refresh_bank_mesh splits {S} clients over a "
                         f"'model' axis of {m}: S % |model| must be 0")
    per = S // m
    gsum, centered = refresh_stats(log_lik_fn, shard_data, theta,
                                   range(i * per, (i + 1) * per), sizes,
                                   batch)
    gsum = lmesh.all_gather_rows(gsum, mesh, "model")
    centered = lmesh.all_gather_rows(centered, mesh, "model")
    return bank_from_stats(theta, gsum, centered, jitter)
