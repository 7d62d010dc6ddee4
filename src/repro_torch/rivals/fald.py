"""FA-LD oracle in plain host code: the reference the engine's
``aggregation='fald'`` is held against (counterpart of
``repro.rivals.fald``).

FA-LD (Deng et al., arXiv:2112.05120) runs C Langevin clients for T local
steps between communication rounds; at each communication round the
server averages the participating clients' iterates and broadcasts the
average back. Each client injects noise at ``temperature * C``, so the
AVERAGED iterate, whose injected-noise variance is the per-client one over
C, targets the configured temperature.

:func:`fald_run_vmap` is a host loop over rounds that takes the SAME
draws as the engine (``core.engine.draw_round`` on the same generator),
the engine's chain-block round for the local steps (the plain one, or the
per-leaf kernel round with ``use_kernel``), and the ``repro_torch.fed``
schedule masks and compressors; the exchange (primal leg, average, dual
leg, masked writes) is written out here on its own. On one device engine
and oracle agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.engine import (draw_round, make_chain_round_fn,
                                     make_round_fn)
from repro_torch.core.sampler import LogLikFn, ShardScheme
from repro_torch.fed import schedule as fsched
from repro_torch.fed.compress import make_compressor, make_flattener
from repro_torch.fed.registry import get_scenario
from repro_torch.fed.spec import Federation

PyTree = Any


def fald_run_vmap(log_lik_fn: LogLikFn, cfg: SamplerConfig,
                  shard_data: PyTree, minibatch: int,
                  generator: torch.Generator, theta0: PyTree,
                  num_rounds: int, *, n_chains: int, bank=None,
                  reassign: str = "categorical", collect_every: int = 1,
                  federation=None, sizes: Optional[tuple] = None,
                  use_kernel: bool = False) -> PyTree:
    """Host-loop FA-LD reference run; returns the trace with leading axes
    (n_chains, num_rounds * ceil(T / collect_every), ...).

    ``federation`` (None, a registry name or a Federation) supplies the
    schedule and compression as the engine takes them; None is exact
    averaging every round. ``use_kernel`` selects the fused-kernel local
    steps (what the per_leaf and packed executors run)."""
    leaf = tu.leaves(shard_data)[0]
    S, max_n = leaf.shape[0], leaf.shape[1]
    if S != cfg.num_shards:
        raise ValueError(f"shard_data holds {S} shards, the config "
                         f"{cfg.num_shards}")
    sizes = (max_n,) * S if sizes is None else tuple(sizes)
    scheme = ShardScheme(sizes=sizes, probs=cfg.probs())
    fed = get_scenario(federation) if federation is not None \
        else Federation()
    sched, comp = fed.schedule, fed.compression
    C, T = n_chains, cfg.local_updates
    # the FA-LD noise calibration: per-client temperature * C
    cfg_dyn = dataclasses.replace(cfg, temperature=cfg.temperature * C)
    kw = {}
    if use_kernel:
        round_fn = make_chain_round_fn(log_lik_fn, cfg_dyn, scheme,
                                       minibatch,
                                       bank.kind if bank is not None
                                       else None)
    else:
        round_fn = make_round_fn(log_lik_fn, cfg_dyn, scheme, minibatch,
                                 bank)
        kw["generator"] = generator
    rbank = bank if cfg.method == "fsgld" else None

    chains = tu.tree_map(
        lambda t: torch.broadcast_to(t, (C,) + t.shape).clone(), theta0)
    flatten, unflatten, dim = make_flattener(chains)
    compress = make_compressor(comp, dim)
    num_leaves = len(tu.leaves(chains))
    sids = torch.zeros(C, dtype=torch.int64, device=generator.device)
    if not comp.identity:
        ref = flatten(chains).clone()
        err = torch.zeros_like(ref)
        derr = torch.zeros_like(ref) if comp.use_dual else None

    def bcast(mask, t):
        return mask.reshape((C,) + (1,) * (t.ndim - 1))

    out = []
    for r in range(num_rounds):
        d = draw_round(generator, cfg, scheme, n_chains=C,
                       minibatch=minibatch, num_leaves=num_leaves,
                       reassign=reassign, federation=fed, r=r, held=sids,
                       dim=dim)
        comm = fsched.comm_mask(sched, r)
        exch = torch.full((C,), comm, dtype=torch.bool, device=sids.device)
        if d.part_u is not None:
            exch = exch & fsched.participation_mask(sched, d.part_u, r)
        sids = torch.where(exch, d.sids, sids)
        d.sids = sids
        if comm:
            flat = flatten(chains)
            if comp.use_primal:
                upd = flat - ref + err
                dhat = compress(upd, d.primal_u)
                m_flat = ref + dhat
                err_new = (upd - dhat if comp.error_feedback
                           else torch.zeros_like(upd))
            else:
                m_flat = flat
            w = exch[:, None]
            cnt = torch.sum(exch.to(torch.float32))
            tot = torch.sum(torch.where(w, m_flat, 0.0), dim=0)
            avg = tot / torch.clamp_min(cnt, 1.0)
            m_flat = torch.where(w, avg[None], m_flat)
            if comp.use_dual:
                dupd = m_flat - ref + derr
                dd = compress(dupd, d.dual_u)
                v_new = ref + dd
                derr_new = (dupd - dd if comp.error_feedback
                            else torch.zeros_like(dupd))
            else:
                v_new = m_flat
            if not comp.identity:
                ref = torch.where(w, v_new, ref)
                if comp.use_primal:
                    err = torch.where(w, err_new, err)
                if comp.use_dual:
                    derr = torch.where(w, derr_new, derr)
            chains = tu.tree_map(
                lambda srv, old: torch.where(bcast(exch, old), srv, old),
                unflatten(v_new), chains)
        pre = chains
        steps = []
        chains = round_fn(chains, d, shard_data, rbank,
                          on_step=lambda t, th: steps.append(th), **kw)
        trace = tu.tree_map(lambda *xs: torch.stack(xs, 1), *steps)
        if d.strag_u is not None:
            strag = fsched.straggler_mask(sched, d.strag_u)
            chains = tu.tree_map(
                lambda new, old: torch.where(bcast(strag, new), old, new),
                chains, pre)
            trace = tu.tree_map(
                lambda t, p: torch.where(bcast(strag, t), p[:, None], t),
                trace, pre)
        out.append(tu.tree_map(lambda t: t[:, ::collect_every], trace))
    return tu.tree_map(lambda *xs: torch.cat(xs, 1), *out)
