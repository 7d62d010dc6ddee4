"""A federated round loop built from the JAX package's own pieces, and
the injected draws that drive it and the port alike (shared by
``test_torch_fed.py`` and ``test_torch_rivals.py``).

The problem: a Gaussian mean in D = 200 dimensions on S = 4 ragged,
NaN-padded clients. Each round's client proposals, minibatch rows (drawn
below the smallest client, so they are valid whichever client a chain
holds) and noise seeds are made with numpy; the schedule and compression
uniforms are ``jax.random.uniform`` of the keys ``fold_in(k_fed, i)`` that
the JAX engine's round uses (i = 0 participation, 1 primal, 2 straggler,
3 dual). The JAX loop reaches ``repro.fed.schedule``'s masks and
``make_compressor`` with those keys; the port gets the uniforms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import SamplerConfig as JCfg
from repro.core import engine as jeng
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.fed import get_scenario as jget_scenario
from repro.fed import schedule as jsched
from repro.fed.compress import make_compressor as jmake_compressor
from repro.fed.compress import make_flattener as jmake_flattener
from repro.kernels import ops as jops
from repro_torch.core import engine as teng

S, D, C, T, M, H = 4, 200, 4, 2, 4, 1e-4
SIZES = (12, 9, 16, 10)
PROBS = (0.3, 0.2, 0.3, 0.2)


def problem(seed=0):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(-3, 3, (S, D)).astype(np.float32)
    x = (mus[:, None] + rng.standard_normal((S, max(SIZES), D))
         ).astype(np.float32)
    for s, n in enumerate(SIZES):
        x[s, n:] = np.nan
    means = np.stack([x[s, :n].mean(0) for s, n in enumerate(SIZES)])
    precs = np.stack([np.full(D, float(n), np.float32) for n in SIZES])
    theta0 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return {"x": x}, means.astype(np.float32), precs, theta0


def cfg_kw(method):
    return dict(method=method, step_size=H, num_shards=S, shard_probs=PROBS,
                local_updates=T, prior_precision=1.0, alpha=1.0)


def jax_log_lik(theta, batch):
    return -0.5 * jnp.sum((batch["x"] - theta) ** 2)


def torch_log_lik(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def make_draws(rounds, federation, seed=1):
    """Per round: (numpy proposals, rows, seeds, k_fed) and the port's
    RoundDraws carrying the same values and the uniforms of k_fed."""
    fed = jget_scenario(federation)
    sched, comp = fed.schedule, fed.compression
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        sids = rng.integers(0, S, C)
        idx = rng.integers(0, min(SIZES), (T, C, M))
        seeds = rng.integers(0, 2**31 - 1, (T, C, 1))
        k_fed = jax.random.fold_in(jax.random.PRNGKey(99), r)

        def unif(i, *shape):
            return torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(k_fed, i), shape)))

        d = teng.RoundDraws(sids=torch.from_numpy(sids),
                            idx=torch.from_numpy(idx),
                            seeds=torch.from_numpy(seeds).to(torch.int32))
        comm = r % sched.delay == 0
        if sched.participation < 1.0:
            d.part_u = unif(0, C)
        if sched.straggler_prob > 0.0:
            d.strag_u = unif(2, C)
        if comm and comp.kind in ("randk", "qsgd"):
            if comp.use_primal:
                d.primal_u = unif(1, C, D)
            if comp.use_dual:
                d.dual_u = unif(3, C, D)
        out.append(((sids, idx, seeds, k_fed), d))
    return out


def injected(draws):
    """A stand-in for ``core.engine.draw_round`` that hands out ``draws``
    round by round."""
    it = iter(draws)

    def draw_round(*args, **kw):
        return next(it)[1]

    return draw_round


def jax_loop(data, means, precs, theta0, draws, federation, *,
             method="fsgld", agg=False):
    """The rounds of the JAX engine's federated round body, one device:
    exchange (primal leg -> FA-LD average -> dual leg) on communication
    rounds, T packed kernel steps (interpret mode), stragglers frozen.
    Returns the (C, rounds * T, D) trace."""
    fed = jget_scenario(federation)
    sched, comp = fed.schedule, fed.compression
    cfg = JCfg(**cfg_kw(method))
    if agg:
        cfg = JCfg(**dict(cfg_kw(method), temperature=float(C)))
    scheme = jsam.ShardScheme(SIZES, PROBS)
    layout = jops.make_packed_layout(jnp.asarray(theta0))
    use_bank = method == "fsgld"
    pb = jeng.pack_bank(layout, jsur.make_bank(
        jnp.asarray(means), jnp.asarray(precs), "diag")) if use_bank \
        else None
    gv = jax.vmap(jax.grad(jax_log_lik))
    jdata = jax.tree.map(jnp.asarray, data)

    @jax.jit
    def step(thetas, sids, idx_t, seeds_t):
        scale, f_s = jsam.chain_scales(cfg, scheme, sids, M)
        scalars = jops.packed_scalar_rows(
            layout, h=H, scale=scale, f_s=f_s, prior_prec=1.0, alpha=1.0,
            temperature=cfg.temperature)
        batch = {"x": jdata["x"][sids[:, None], idx_t]}
        kw = dict(variant="plain")
        if use_bank:
            kw = dict(variant="diag", mu_g=pb["mu_g"], lam_g=pb["lam_g"],
                      mu_s=pb["means"][sids].reshape(-1, 128),
                      lam_s=pb["precs"][sids].reshape(-1, 128))
        th_p = jops.packed_step(layout, layout.pack(thetas),
                                layout.pack(gv(thetas, batch)), seeds_t,
                                scalars, interpret=True, **kw)
        return layout.unpack(th_p)

    thetas = jnp.broadcast_to(jnp.asarray(theta0), (C, D))
    flatten, unflatten, dim = jmake_flattener(thetas)
    compress = jmake_compressor(comp, dim)
    ref = flatten(thetas)
    err = jnp.zeros_like(ref)
    derr = jnp.zeros_like(ref)
    sids = jnp.zeros(C, jnp.int32)
    trace = []
    for r, ((new, idx, seeds, k_fed), _) in enumerate(draws):
        comm = bool(jsched.comm_mask(sched, r))
        exch = jnp.full((C,), comm)
        if sched.participation < 1.0:
            exch = exch & jsched.participation_mask(
                sched, jax.random.fold_in(k_fed, 0), r, C)
        sids = jnp.where(exch, jnp.asarray(new, jnp.int32), sids)
        if comm and (agg or not comp.identity):
            flat = flatten(thetas)
            m_flat = flat
            if comp.use_primal:
                upd = flat - ref + err
                dhat = compress(upd, jax.random.fold_in(k_fed, 1))
                m_flat = ref + dhat
                err = jnp.where(exch[:, None], upd - dhat, err)
            if agg:
                cnt = jnp.sum(exch.astype(jnp.float32))
                tot = jnp.sum(jnp.where(exch[:, None], m_flat, 0.0), 0)
                m_flat = jnp.where(exch[:, None],
                                   (tot / jnp.maximum(cnt, 1.0))[None],
                                   m_flat)
            v_new = m_flat
            if comp.use_dual:
                dupd = m_flat - ref + derr
                dd = compress(dupd, jax.random.fold_in(k_fed, 3))
                v_new = ref + dd
                derr = jnp.where(exch[:, None], dupd - dd, derr)
            ref = jnp.where(exch[:, None], v_new, ref)
            thetas = jnp.where(exch[:, None], unflatten(v_new), thetas)
        pre = thetas
        steps = []
        for t in range(T):
            thetas = step(thetas, sids, jnp.asarray(idx[t]),
                          jnp.asarray(seeds[t], jnp.uint32))
            steps.append(thetas)
        if sched.straggler_prob > 0.0:
            strag = jsched.straggler_mask(
                sched, jax.random.fold_in(k_fed, 2), C)[:, None]
            thetas = jnp.where(strag, pre, thetas)
            steps = [jnp.where(strag, pre, s) for s in steps]
        trace += steps
    return np.stack([np.asarray(s) for s in trace], 1)
