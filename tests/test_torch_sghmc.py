"""The port's SGHMC dynamics (``repro_torch.core.sghmc`` and the engine's
``dynamics='sghmc'``) against the JAX package.

* Rounds, step by step: the same numpy-made client ids, minibatch rows
  and noise seeds go through the port's packed SGHMC round and through a
  JAX loop built from the JAX package's own pieces
  (``jax.vmap(jax.grad(log_lik))``, ``PackedChains.pack``/``quantize``,
  ``kops.packed_step(dynamics='sghmc', interpret=True)``). Tolerance
  1e-5 + 1e-5|x| for float32 leaves (gradient summation order, normals
  within 1e-6); a bf16 leaf within one bf16 ulp (2^-7 |x|), since a 1e-7
  shift can cross a rounding edge.
* The randomness contract: packed == per_leaf bitwise on one generator,
  fp32 and a bf16 leaf; the single-chain kernel step == the packed round.
* Statistics: the plain vmap executor and ``FederatedSGHMC`` land on the
  analytic Gaussian posterior.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JCfg
from repro.core import engine as jeng
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.convert import bank_from_numpy, tree_from_numpy
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.core.sghmc import (FederatedSGHMC, SGHMCConfig,
                                    init_momentum, make_sghmc_step)
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.kernels import ops as tops
from repro_torch.workloads import (TABLE1_OFFS, TABLE1_P, TABLE1_SIZES,
                                   gaussian_log_lik, mlp_log_lik,
                                   mlp_problem, table1_log_lik)
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

FRICTION, TEMP = 0.1, 1.0
BF16_REL = 2.0 ** -7


def table1_log_lik_jax(theta, batch):
    h = batch["x"]
    for i, (a, b) in enumerate(TABLE1_SIZES):
        w0, b0, b1 = TABLE1_OFFS[i]
        h = h @ theta[w0:b0].reshape(a, b) + theta[b0:b1]
        if i + 1 < len(TABLE1_SIZES):
            h = jax.nn.relu(h)
    lp = jax.nn.log_softmax(h)
    y = batch["y"].astype(jnp.int32)
    return jnp.sum(jnp.take_along_axis(lp, y[:, None], 1))


def linear_log_lik_jax(theta, batch):
    pred = batch["x"] @ theta["w"] + theta["b"].astype(jnp.float32)
    return -0.5 * jnp.sum((batch["y"] - pred) ** 2)


def linear_log_lik(theta, batch):
    pred = batch["x"] @ theta["w"] + theta["b"].to(torch.float32)
    return -0.5 * torch.sum((batch["y"] - pred) ** 2)


def _table1_cell(rng, S, n, sizes):
    x = rng.standard_normal((S, n, 18)).astype(np.float32)
    y = (rng.uniform(size=(S, n)) < 0.5).astype(np.float32)
    for s, ns in enumerate(sizes):
        x[s, ns:] = np.nan
        y[s, ns:] = np.nan
    theta0 = (0.1 * rng.standard_normal(TABLE1_P)).astype(np.float32)
    means = (theta0 + 0.05 * rng.standard_normal((S, TABLE1_P))
             ).astype(np.float32)
    precs = rng.uniform(1.0, 50.0, (S, TABLE1_P)).astype(np.float32)
    return ({"x": x, "y": y}, theta0, means, precs, "diag",
            table1_log_lik_jax, table1_log_lik)


def _linear_cell(rng, S, n, sizes):
    """The parity matrix's multi-leaf linear model with its bias in bf16
    (a mixed-dtype tree) and a 'scalar' bank."""
    din, dout = 2, 300
    x = rng.standard_normal((S, n, din)).astype(np.float32)
    w_true = rng.standard_normal((din, dout)).astype(np.float32)
    y = (x @ w_true + 0.1 * rng.standard_normal((S, n, dout))
         ).astype(np.float32)
    for s, ns in enumerate(sizes):
        x[s, ns:] = np.nan
        y[s, ns:] = np.nan
    theta0 = {"b": (0.1 * rng.standard_normal(dout)).astype(np.float32),
              "w": (0.1 * rng.standard_normal((din, dout))
                    ).astype(np.float32)}
    means = {"b": (0.1 * rng.standard_normal((S, dout))).astype(np.float32),
             "w": (w_true + 0.1 * rng.standard_normal((S, din, dout))
                   ).astype(np.float32)}
    precs = {"b": np.linspace(1.0, 2.0, S).astype(np.float32),
             "w": np.linspace(3.0, 5.0, S).astype(np.float32)}
    return ({"x": x, "y": y}, theta0, means, precs, "scalar",
            linear_log_lik_jax, linear_log_lik)


@pytest.mark.parametrize("cell", ["table1", "linear_bf16"])
def test_packed_sghmc_round_matches_jax_loop_step_by_step(cell):
    """A packed SGHMC round (reduced S and n, ragged NaN-padded shards,
    C = 4, T = 10, FSGLD): the Table-1 MLP (P = 854, diag bank) and a
    mixed-dtype tree (fp32 w, bf16 b, scalar bank), both buffers through
    quantize after every step."""
    rng = np.random.default_rng(0)
    S, n, m, C, T, h = 3, 60, 10, 4, 10, 1e-4
    sizes = (60, 45, 52)
    make = _table1_cell if cell == "table1" else _linear_cell
    data, theta0, means, precs, kind, jll, tll = make(rng, S, n, sizes)
    if cell == "linear_bf16":
        h = 1e-5
    jtheta0 = jax.tree.map(jnp.asarray, theta0)
    ttheta0 = tree_from_numpy(theta0)
    if cell == "linear_bf16":
        jtheta0["b"] = jtheta0["b"].astype(jnp.bfloat16)
        ttheta0["b"] = ttheta0["b"].to(torch.bfloat16)
    L = len(jax.tree.leaves(jtheta0))
    sids = np.array([2, 0, 2, 1])
    idx = np.stack([rng.integers(0, np.array(sizes)[sids][:, None],
                                 (C, m)) for _ in range(T)])
    seeds = rng.integers(0, 2**31 - 1, (T, C, L)).astype(np.uint32)
    probs = (0.2, 0.5, 0.3)
    kw = dict(method="fsgld", step_size=h, num_shards=S, shard_probs=probs,
              local_updates=T, prior_precision=1.0, alpha=1.0)

    # the JAX loop, from the JAX package's own pieces
    jcfg, jscheme = JCfg(**kw), jsam.ShardScheme(sizes, probs)
    jbank = jsur.make_bank(jax.tree.map(jnp.asarray, means),
                           jax.tree.map(jnp.asarray, precs), kind)
    jl = jops.make_packed_layout(jtheta0)
    pb = jeng.pack_bank(jl, jbank)
    scale, f_s = jsam.chain_scales(jcfg, jscheme, jnp.asarray(sids), m)
    ops = dict(mu_g=pb["mu_g"], mu_s=pb["means"][sids].reshape(-1, 128))
    lam = {}
    if kind == "diag":
        ops.update(lam_g=pb["lam_g"],
                   lam_s=pb["precs"][sids].reshape(-1, 128))
    else:
        lam = dict(lam_g_leaf=pb["lam_g_leaf"],
                   lam_s_leaf=pb["lam_s_leaf"][sids])
    scalars = jops.packed_scalar_rows(jl, h=h, scale=scale, f_s=f_s,
                                      prior_prec=1.0, alpha=1.0,
                                      temperature=TEMP, friction=FRICTION,
                                      **lam)
    gv = jax.vmap(jax.grad(jll))

    @jax.jit
    def jax_step(th_p, r_p, thetas, batch, seeds_t):
        th_p, r_p = jops.packed_step(
            jl, th_p, jl.pack(gv(thetas, batch)), seeds_t, scalars,
            variant=kind, r_p=r_p, dynamics="sghmc", interpret=True, **ops)
        th_p, r_p = jl.quantize(th_p), jl.quantize(r_p)
        return th_p, r_p, jl.unpack(th_p)

    thetas = jax.tree.map(lambda t: jnp.broadcast_to(t, (C,) + t.shape),
                          jtheta0)
    th_p, r_p = jl.pack(thetas), jl.pack(jax.tree.map(jnp.zeros_like,
                                                      thetas))
    jdata = jax.tree.map(jnp.asarray, data)
    for t in range(T):
        batch = jax.tree.map(lambda d: d[sids[:, None], idx[t]], jdata)
        th_p, r_p, thetas = jax_step(th_p, r_p, thetas, batch,
                                     jnp.asarray(seeds[t]))

    # the port's packed round on the same draws
    tl = tops.make_packed_layout(ttheta0)
    hmc = SGHMCConfig(friction=FRICTION, temperature=TEMP)
    round_fn = teng.make_packed_round_fn(
        tll, TCfg(**kw), ShardScheme(sizes, probs), m, kind, tl, hmc)
    draws = teng.RoundDraws(sids=torch.from_numpy(sids),
                            idx=torch.from_numpy(idx),
                            seeds=torch.from_numpy(seeds.astype(np.int64)))
    chains = tu.tree_map(lambda t: t.expand((C,) + t.shape).clone(),
                         ttheta0)
    state = (tl.pack(chains), tl.pack(init_momentum(chains)), chains)
    out_p, mom_p, out = round_fn(state, draws, tree_from_numpy(data),
                                 teng.pack_bank(tl, bank_from_numpy(
                                     means, precs, kind)))
    got, want = tu.flatten(out)[0], jax.tree.leaves(thetas)
    for g, w, t0 in zip(got, want, jax.tree.leaves(jtheta0)):
        w = np.asarray(w.astype(jnp.float32))
        g = g.to(torch.float32).numpy()
        assert np.isfinite(w).all()
        bound = 1e-5 + 1e-5 * np.abs(w)
        if t0.dtype == jnp.bfloat16:
            bound = np.maximum(bound, BF16_REL * np.abs(w))
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()
    assert np.abs(np.asarray(jax.tree.leaves(thetas)[-1], np.float32)
                  - jax.tree.leaves(jtheta0)[-1]).max() > 1e-4  # moved
    np.testing.assert_allclose(mom_p.numpy(), np.asarray(r_p),
                               atol=1e-5 if cell == "table1" else 1e-3,
                               rtol=1e-5)


def _mlp(executor, rounds=2, steps=3, n_chains=5, bf16=False, **kw):
    g = torch.Generator().manual_seed(3)
    data, bank, theta0 = mlp_problem(g, S=3, n=40, din=5, hid=7, dout=2)
    ll = mlp_log_lik
    if bf16:
        theta0["b1"] = theta0["b1"].to(torch.bfloat16)

        def ll(theta, batch):
            th = dict(theta, b1=theta["b1"].to(torch.float32))
            return mlp_log_lik(th, batch)
    s = api.FSGLD(
        api.Posterior(ll, prior_precision=1.0), data, minibatch=8,
        step_size=1e-3, kernel="sghmc", friction=FRICTION,
        surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
        schedule=api.Schedule(rounds=rounds, local_steps=steps,
                              n_chains=n_chains, **kw),
        execution=api.Execution(device="cpu", executor=executor))
    return s, theta0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("reassign", ["categorical", "permutation"])
def test_sghmc_packed_equals_per_leaf_bitwise(reassign, bf16):
    out = {}
    for ex in ("packed", "per_leaf"):
        s, theta0 = _mlp(ex, reassign=reassign, bf16=bf16)
        assert s.engine.dynamics == "sghmc"
        out[ex] = s.sample(torch.Generator().manual_seed(11), theta0)
    assert out["packed"]["b1"].dtype == (torch.bfloat16 if bf16
                                         else torch.float32)
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert a.shape[:2] == (5, 6) and torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_sghmc_final_states_carry_momenta():
    out = {}
    for ex in ("packed", "per_leaf", "vmap"):
        s, theta0 = _mlp(ex)
        s = api.FSGLD(s.posterior, s.data, minibatch=8, step_size=1e-3,
                      kernel="sghmc", surrogate=s.surrogate,
                      schedule=s.schedule,
                      execution=api.Execution(device="cpu", executor=ex,
                                              collect=False))
        out[ex] = s.sample(torch.Generator().manual_seed(2), theta0)
        th, r = out[ex]
        assert th["w1"].shape == r["w1"].shape == (5, 5, 7)
        assert float(r["w1"].abs().max()) > 0
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="sghmc"):
        s.engine.run(torch.Generator(), theta0, 1, refresh_every=2)


def test_kernel_step_equals_the_packed_round():
    """``make_sghmc_step(use_kernel=True)`` on one chain draws one seed per
    leaf and takes the same kernel path as a one-chain packed round: the
    same noise, equal up to the gradient's float32 summation order (one
    chain against vmapped), held to 1e-7 + 1e-6|x|."""
    s, theta0 = _mlp("packed", n_chains=1)
    cfg, scheme = s.cfg, s.engine.scheme
    hmc = SGHMCConfig(friction=FRICTION)
    step = make_sghmc_step(mlp_log_lik, cfg, scheme, s.bank, hmc,
                           use_kernel=True)
    g = torch.Generator().manual_seed(0)
    seeds = tops.chain_leaf_seeds(torch.Generator().manual_seed(0), 1, 1, 4)
    idx = torch.arange(8)
    sid = torch.tensor(1)
    batch = tu.tree_map(lambda d: d[sid, idx], s.data)
    r0 = tu.tree_map(lambda t: 0.01 * torch.ones_like(t), theta0)
    th1, r1 = step((theta0, r0), g, batch, sid, 8)
    tl = tops.make_packed_layout(theta0)
    cfg1 = TCfg(**{**cfg.__dict__, "local_updates": 1})
    round_fn = teng.make_packed_round_fn(mlp_log_lik, cfg1, scheme, 8,
                                         "scalar", tl, hmc)
    chains = tu.tree_map(lambda t: t[None].clone(), theta0)
    mom = tu.tree_map(lambda t: t[None].clone(), r0)
    draws = teng.RoundDraws(sids=sid[None], idx=idx[None, None],
                            seeds=seeds)
    _, rp, out = round_fn((tl.pack(chains), tl.pack(mom), chains), draws,
                          s.data, teng.pack_bank(tl, s.bank))
    for a, b in zip(tu.leaves(th1) + tu.leaves(r1),
                    tu.leaves(out) + tu.leaves(tl.unpack(rp))):
        torch.testing.assert_close(a, b[0], atol=1e-7, rtol=1e-6)
    assert not torch.equal(th1["w1"], theta0["w1"])


def _gauss(S=8, n=50, d=2):
    rng = np.random.default_rng(0)
    mus = rng.uniform(-4, 4, (S, d)).astype(np.float32)
    x = torch.from_numpy(
        (mus[:, None, :] + rng.standard_normal((S, n, d))).astype(np.float32))
    post = x.reshape(-1, d).sum(0) / (1.0 + S * n)
    mu, prec = torch.vmap(analytic_gaussian_likelihood_surrogate)(x)
    return x, post, make_bank(mu, prec, "diag")


def test_sghmc_vmap_lands_on_the_analytic_gaussian_posterior():
    """README quickstart posterior (S = 8, n = 50, d = 2, prior N(0, I):
    mean sum(x) / (1 + N), sd 1/sqrt(401) = 0.05). SGHMC with friction 0.1
    and h = 2e-4 (theta relaxes in ~20 steps): the second half of 4
    chains x 600 steps on the plain vmap executor must land within 0.05
    (one posterior sd) of the mean. (Its spread is not the posterior's:
    naive SGHMC adds the minibatch noise, here ~16x the injected one.)"""
    x, post, bank = _gauss()
    s = api.FSGLD(api.Posterior(gaussian_log_lik), {"x": x}, minibatch=10,
                  step_size=2e-4, kernel="sghmc", friction=0.1,
                  surrogate=api.SurrogateSpec(kind="diag", bank=bank),
                  schedule=api.Schedule(rounds=60, local_steps=10,
                                        n_chains=4),
                  execution=api.Execution(device="cpu", executor="vmap"))
    tr = s.sample(torch.Generator().manual_seed(1), torch.zeros(2))
    half = tr[:, tr.shape[1] // 2:]
    assert (half.mean((0, 1)) - post).abs().max() < 0.05


def test_federated_sghmc_single_chain_lands_on_the_posterior():
    x, post, bank = _gauss()
    cfg = TCfg(method="fsgld", step_size=2e-4, num_shards=8,
               local_updates=10)
    runner = FederatedSGHMC(gaussian_log_lik, cfg, {"x": x}, 10, bank,
                            SGHMCConfig(friction=0.1))
    tr = runner.run(torch.Generator().manual_seed(2), torch.zeros(2), 200,
                    collect_every=2)
    assert tr.shape == (1000, 2) and torch.isfinite(tr).all()
    assert (tr[500:].mean(0) - post).abs().max() < 0.05
