"""The port's engine and facade against the JAX package.

* One packed round, step by step: the same numpy-made client ids,
  minibatch indices and noise seeds go through the port's packed round
  and through a JAX loop built from the JAX package's own pieces
  (``jax.vmap(jax.grad(log_lik))``, ``PackedChains.pack``,
  ``kops.packed_step(interpret=True)``).
* A whole run, statistically: both facades sample the README quickstart's
  Gaussian posterior and must land near its analytic mean.
* The facade's contract: shapes, executors, refusals, the randomness
  contract (packed == per_leaf bitwise on one generator).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jeng
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.configs.base import SamplerConfig as JCfg
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.convert import bank_from_numpy, tree_from_numpy
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.data import gaussian_shards, susy_shards, susy_test_set
from repro_torch.kernels import fsgld_update as tk
from repro_torch.kernels import ops as tops
from repro_torch.workloads import (TABLE1_OFFS, TABLE1_P, TABLE1_SIZES,
                                   avg_loglik, mlp_log_lik, mlp_problem,
                                   table1_log_lik)
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

CPU = api.Execution(device="cpu")


def table1_log_lik_jax(theta, batch):
    """benchmarks/table1_bnn.py's log-likelihood."""
    h = batch["x"]
    for i, (a, b) in enumerate(TABLE1_SIZES):
        w0, b0, b1 = TABLE1_OFFS[i]
        h = h @ theta[w0:b0].reshape(a, b) + theta[b0:b1]
        if i + 1 < len(TABLE1_SIZES):
            h = jax.nn.relu(h)
    lp = jax.nn.log_softmax(h)
    y = batch["y"].astype(jnp.int32)
    return jnp.sum(jnp.take_along_axis(lp, y[:, None], 1))


def test_packed_round_matches_jax_loop_step_by_step():
    """Table-1 MLP (P = 854) at reduced S and n, ragged shards with a NaN
    pad, C = 4, T = 10, FSGLD with a diag bank. Tolerance 1e-5: the
    gradients differ in float32 summation order and the normals by
    <= 1e-6; ten steps of h = 1e-4 keep that at the 1e-6 level."""
    rng = np.random.default_rng(0)
    S, n, m, C, T, h = 3, 60, 10, 4, 10, 1e-4
    sizes = (60, 45, 52)
    x = rng.standard_normal((S, n, 18)).astype(np.float32)
    y = (rng.uniform(size=(S, n)) < 0.5).astype(np.float32)
    for s, ns in enumerate(sizes):
        x[s, ns:] = np.nan
        y[s, ns:] = np.nan
    data = {"x": x, "y": y}
    theta0 = (0.1 * rng.standard_normal(TABLE1_P)).astype(np.float32)
    means = (theta0 + 0.05 * rng.standard_normal((S, TABLE1_P))
             ).astype(np.float32)
    precs = rng.uniform(1.0, 50.0, (S, TABLE1_P)).astype(np.float32)
    sids = np.array([2, 0, 2, 1])
    idx = np.stack([rng.integers(0, np.array(sizes)[sids][:, None],
                                 (C, m)) for _ in range(T)])
    seeds = rng.integers(0, 2**31 - 1, (T, C, 1)).astype(np.uint32)
    probs = (0.2, 0.5, 0.3)
    kw = dict(method="fsgld", step_size=h, num_shards=S, shard_probs=probs,
              local_updates=T, prior_precision=1.0, alpha=1.0)

    # the JAX loop, from the JAX package's own pieces
    jcfg, jscheme = JCfg(**kw), jsam.ShardScheme(sizes, probs)
    jbank = jsur.make_bank(jnp.asarray(means), jnp.asarray(precs), "diag")
    jl = jops.make_packed_layout(jnp.asarray(theta0))
    pb = jeng.pack_bank(jl, jbank)
    scale, f_s = jsam.chain_scales(jcfg, jscheme, jnp.asarray(sids), m)
    scalars = jops.packed_scalar_rows(jl, h=h, scale=scale, f_s=f_s,
                                      prior_prec=1.0, alpha=1.0,
                                      temperature=1.0)
    gv = jax.vmap(jax.grad(table1_log_lik_jax))
    mu_s = pb["means"][sids].reshape(-1, 128)
    lam_s = pb["precs"][sids].reshape(-1, 128)

    @jax.jit
    def jax_step(th_p, thetas, batch, seeds_t):
        th_p = jops.packed_step(
            jl, th_p, jl.pack(gv(thetas, batch)), seeds_t, scalars,
            variant="diag", mu_g=pb["mu_g"], lam_g=pb["lam_g"], mu_s=mu_s,
            lam_s=lam_s, interpret=True)
        return th_p, jl.unpack(th_p)

    thetas = jnp.broadcast_to(jnp.asarray(theta0), (C, TABLE1_P))
    th_p = jl.pack(thetas)
    jdata = jax.tree.map(jnp.asarray, data)
    for t in range(T):
        batch = jax.tree.map(lambda d: d[sids[:, None], idx[t]], jdata)
        th_p, thetas = jax_step(th_p, thetas, batch, jnp.asarray(seeds[t]))

    # the port's packed round on the same draws
    tl = tops.make_packed_layout(torch.from_numpy(theta0))
    round_fn = teng.make_packed_round_fn(
        table1_log_lik, TCfg(**kw), ShardScheme(sizes, probs), m, "diag",
        tl)
    draws = teng.RoundDraws(sids=torch.from_numpy(sids),
                            idx=torch.from_numpy(idx),
                            seeds=torch.from_numpy(seeds.astype(np.int64)))
    chains = torch.from_numpy(theta0).expand(C, TABLE1_P).clone()
    _, out = round_fn((tl.pack(chains), chains), draws,
                      tree_from_numpy(data),
                      teng.pack_bank(tl, bank_from_numpy(means, precs,
                                                         "diag")))
    ref = np.asarray(thetas)
    assert np.isfinite(ref).all()
    assert np.abs(ref - theta0).max() > 1e-3  # the chains moved
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _gauss_problem(S=8, n=50, d=2):
    rng = np.random.default_rng(0)
    mus = rng.uniform(-4, 4, (S, d)).astype(np.float32)
    x = (mus[:, None, :] + rng.standard_normal((S, n, d))).astype(np.float32)
    post = x.reshape(-1, d).sum(0) / (1.0 + S * n)
    return x, post


def test_sample_statistics_match_jax_and_analytic_posterior():
    """README quickstart posterior (S = 8, n = 50, d = 2, prior N(0, I)):
    the analytic posterior mean is sum(x) / (1 + N) with sd 1/sqrt(401) =
    0.05. JAX (vmap executor) and the port (packed, CPU) each keep the
    second half of 4 chains x 400 steps of h = 2e-4 (autocorrelation time
    ~25 steps, burn-in decayed by e^-8); their Monte Carlo error is about
    0.01, so both must land within 0.05 (one posterior sd) of it."""
    x, post = _gauss_problem()
    d = x.shape[-1]
    h = 2e-4
    sched = dict(rounds=40, local_steps=10, n_chains=4, thin=5)

    def jll(theta, batch):
        return -0.5 * jnp.sum((batch["x"] - theta) ** 2)

    mu_s, prec_s = jax.vmap(
        jsur.analytic_gaussian_likelihood_surrogate)(jnp.asarray(x))
    js = japi.FSGLD(
        japi.Posterior(jll, prior_precision=1.0), {"x": jnp.asarray(x)},
        minibatch=10, step_size=h,
        surrogate=japi.SurrogateSpec(kind="diag", bank=jsur.make_bank(
            mu_s, prec_s, "diag")),
        schedule=japi.Schedule(**sched))
    a = np.asarray(js.sample(jax.random.PRNGKey(1), jnp.zeros(d)))

    def tll(theta, batch):
        return -0.5 * torch.sum((batch["x"] - theta) ** 2)

    xt = torch.from_numpy(x)
    tmu, tprec = torch.vmap(analytic_gaussian_likelihood_surrogate)(xt)
    ts = api.FSGLD(
        api.Posterior(tll, prior_precision=1.0), {"x": xt}, minibatch=10,
        step_size=h,
        surrogate=api.SurrogateSpec(kind="diag", bank=make_bank(
            tmu, tprec, "diag")),
        schedule=api.Schedule(**sched),
        execution=api.Execution(device="cpu", executor="packed"))
    b = ts.sample(torch.Generator().manual_seed(1), torch.zeros(d)).numpy()
    assert a.shape == b.shape == (4, 80, d)
    half = a.shape[1] // 2
    for tr in (a, b):
        assert np.abs(tr[:, half:].mean((0, 1)) - post).max() < 0.05


def _mlp_sampler(executor, rounds=2, steps=3, n_chains=3, **kw):
    g = torch.Generator().manual_seed(3)
    data, bank, theta0 = mlp_problem(g, S=3, n=40, din=5, hid=7, dout=2)
    s = api.FSGLD(
        api.Posterior(mlp_log_lik, prior_precision=1.0), data, minibatch=8,
        step_size=1e-3, surrogate=api.SurrogateSpec(kind="scalar",
                                                     bank=bank),
        schedule=api.Schedule(rounds=rounds, local_steps=steps,
                              n_chains=n_chains, **kw),
        execution=api.Execution(device="cpu", executor=executor))
    return s, theta0


@pytest.mark.parametrize("reassign", ["categorical", "permutation"])
def test_packed_equals_per_leaf_bitwise_on_one_generator(reassign):
    out = {}
    for ex in ("packed", "per_leaf"):
        s, theta0 = _mlp_sampler(ex, n_chains=5, reassign=reassign)
        out[ex] = s.sample(torch.Generator().manual_seed(11), theta0)
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert a.shape[:2] == (5, 6)
        assert torch.equal(a, b)


def test_facade_shapes_and_executors():
    for ex in ("auto", "vmap", "packed"):
        s, theta0 = _mlp_sampler(ex, thin=2)
        tr = s.sample(torch.Generator().manual_seed(0), theta0)
        assert tr["w1"].shape == (3, 2 * 2, 5, 7)  # (chains, kept, ...)
        assert all(torch.isfinite(v).all() for v in tu.leaves(tr))
    s, theta0 = _mlp_sampler("packed")
    s = api.FSGLD(s.posterior, s.data, minibatch=8, step_size=1e-3,
                  surrogate=s.surrogate, schedule=s.schedule,
                  execution=api.Execution(device="cpu", executor="packed",
                                          collect=False))
    final = s.sample(torch.Generator().manual_seed(0), theta0, n_chains=2)
    assert final["w2"].shape == (2, 7, 2)
    assert tk.LAUNCHES == {"fsgld_update_packed": 0, "fsgld_update_2d": 0}


def test_execution_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Execution()
    assert api.Execution(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="executor"):
        api.Execution(device="cpu", executor="fast")


def test_refusals_name_the_roadmap_item():
    """Adaptive refresh and the mesh are ported (item 8; their runs:
    tests/test_torch_refresh.py and tests/test_torch_mesh.py); what is
    left are the reference's own refusals: a refresh of a bank other
    than a flat-vector 'diag' one (this MLP's pytree bank, at the first
    refresh boundary), and a mesh that is not a DeviceMesh with a 'data'
    axis."""
    s, theta0 = _mlp_sampler("packed")
    g = torch.Generator()
    with pytest.raises(NotImplementedError, match="'diag' banks only"):
        s.engine.run(g, theta0, 3, refresh_every=2)
    with pytest.raises(ValueError, match="'data' axis"):
        api.Serving(mesh=object(), device="cpu")


def _plain_only_bank(kind, S=3, P=4):
    g = torch.Generator().manual_seed(0)
    means = torch.randn((S, P), generator=g)
    if kind == "linear":
        return make_bank(means, torch.zeros(S, P), "linear")
    a = torch.randn((S, P, P), generator=g)
    return make_bank(means, a @ a.transpose(1, 2) + P * torch.eye(P),
                     "full")


def _gauss_sampler(kind, executor):
    """A Gaussian mean on 3 clients of 10 points in 4 dimensions."""
    x = torch.randn((3, 10, 4), generator=torch.Generator().manual_seed(1))
    return api.FSGLD(
        api.Posterior(lambda th, b: -0.5 * torch.sum((b["x"] - th) ** 2)),
        {"x": x}, minibatch=4, step_size=1e-4,
        surrogate=api.SurrogateSpec(kind=kind, bank=_plain_only_bank(kind)),
        schedule=api.Schedule(rounds=2, local_steps=3, n_chains=2),
        execution=api.Execution(device="cpu", executor=executor))


@pytest.mark.parametrize("kind", ["full", "linear"])
def test_linear_and_full_kinds_build_and_run_on_vmap(kind):
    """The 'linear' and 'full' kinds build, 'auto' runs them on the plain
    vmap executor (the only one the reference runs them on), bitwise as
    an explicit 'vmap'."""
    assert api.SurrogateSpec(kind=kind).kind == kind
    out = {}
    for ex in ("auto", "vmap"):
        s = _gauss_sampler(kind, ex)
        assert s._resolve_executor() == (False, None)
        out[ex] = s.sample(torch.Generator().manual_seed(2), torch.zeros(4))
        assert out[ex].shape == (2, 6, 4)
        assert bool(torch.isfinite(out[ex]).all())
    assert torch.equal(out["auto"], out["vmap"])


@pytest.mark.parametrize("kind", ["full", "linear"])
@pytest.mark.parametrize("executor", ["packed", "per_leaf"])
def test_linear_and_full_kinds_refuse_the_kernel_executors(kind, executor):
    """No kernel variant takes them: an explicit kernel executor raises
    ValueError naming the kind at construction, as does the engine's
    round, and the facade cannot fit them (a prefit bank is needed)."""
    with pytest.raises(ValueError, match=kind):
        _gauss_sampler(kind, executor)
    cfg = TCfg(method="fsgld", num_shards=3, local_updates=1)
    eng = teng.MeshChainEngine(
        lambda th, b: -0.5 * torch.sum((b["x"] - th) ** 2), cfg,
        {"x": torch.zeros(3, 10, 4)}, 4, bank=_plain_only_bank(kind),
        use_kernel=True, packed=executor == "packed")
    with pytest.raises(ValueError, match=kind):
        eng.run(torch.Generator(), torch.zeros(4), 1)
    s = _gauss_sampler(kind, "vmap")
    s.surrogate = api.SurrogateSpec(kind=kind)
    with pytest.raises(ValueError, match="prefit bank"):
        s.fit(torch.Generator(), torch.zeros(4))


def test_auto_on_cuda_resolves_by_the_bank_kind():
    """'auto' on a CUDA execution is packed for a 'diag' bank and vmap for
    'linear' / 'full' (resolved in the facade, not deep in pack_bank)."""
    for kind, want in (("linear", (False, None)), ("full", (False, None)),
                       ("diag", (True, None))):
        s = _gauss_sampler("full" if kind == "diag" else kind, "vmap")
        if kind == "diag":
            s.bank = make_bank(torch.zeros(3, 4), torch.ones(3, 4), "diag")
        s.execution = api.Execution(device="cuda", executor="auto")
        assert s._resolve_executor() == want


def test_draws_stay_in_the_live_prefix_and_follow_reassign():
    sizes = (7, 30, 12)
    cfg = TCfg(method="fsgld", num_shards=3, local_updates=20)
    scheme = ShardScheme(sizes, cfg.probs())
    g = torch.Generator().manual_seed(0)
    d = teng.draw_round(g, cfg, scheme, n_chains=50, minibatch=16,
                        num_leaves=2, reassign="categorical")
    assert d.idx.shape == (20, 50, 16) and d.seeds.shape == (20, 50, 2)
    bound = torch.tensor(sizes)[d.sids]
    assert (d.idx >= 0).all() and (d.idx < bound[None, :, None]).all()
    assert d.seeds.dtype == torch.int32 and (d.seeds >= 0).all()
    assert set(d.sids.tolist()) == {0, 1, 2}
    p = teng.draw_round(g, cfg, scheme, n_chains=7, minibatch=4,
                        num_leaves=1, reassign="permutation")
    counts = torch.bincount(p.sids, minlength=3)
    assert sorted(counts.tolist()) == [2, 2, 3]  # block-cyclic, C > S
    assert torch.equal(p.sids[:3].sort().values, torch.arange(3))
    again = teng.draw_round(torch.Generator().manual_seed(0), cfg, scheme,
                            n_chains=50, minibatch=16, num_leaves=2)
    assert torch.equal(again.idx, d.idx) and torch.equal(again.seeds,
                                                         d.seeds)
    sg = teng.draw_round(g, TCfg(method="sgld", num_shards=3,
                                 local_updates=4), scheme, n_chains=3,
                         minibatch=64, num_leaves=1)
    assert (sg.sids == 0).all() and int(sg.idx.max()) < sum(sizes)


@pytest.mark.parametrize("method", ["sgld", "dsgld", "fsgld"])
def test_ragged_nan_padded_clients_never_poison_chains(method):
    """Clients given as a list of ragged shards are NaN-padded; every
    method samples them without touching the pad."""
    g = torch.Generator().manual_seed(0)
    shards = [{"x": torch.randn(n, 2, generator=g) + i}
              for i, n in enumerate((20, 9, 33))]

    def ll(theta, batch):
        return -0.5 * torch.sum((batch["x"] - theta) ** 2)

    spec = None
    if method == "fsgld":  # fitted on the live rows of each client
        fits = [analytic_gaussian_likelihood_surrogate(c["x"])
                for c in shards]
        spec = api.SurrogateSpec(kind="diag", bank=make_bank(
            torch.stack([f[0] for f in fits]),
            torch.stack([f[1] for f in fits]), "diag"))
    s = api.FSGLD(api.Posterior(ll), shards, minibatch=5, step_size=1e-3,
                  method=method, surrogate=spec,
                  schedule=api.Schedule(rounds=4, local_steps=5, n_chains=3),
                  execution=api.Execution(device="cpu", executor="packed"))
    assert s.sizes == (20, 9, 33)
    tr = s.sample(torch.Generator().manual_seed(1), torch.zeros(2))
    assert tr.shape == (3, 20, 2) and torch.isfinite(tr).all()


@pytest.mark.parametrize("kind,fit", [("diag", "auto"), ("diag", "fisher"),
                                      ("scalar", "auto")])
def test_fit_paths_install_a_bank(kind, fit):
    g = torch.Generator().manual_seed(0)
    if kind == "diag":
        data = {"x": torch.randn(3, 30, 2, generator=g)}
        ll = lambda t, b: -0.5 * torch.sum((b["x"] - t) ** 2)  # noqa: E731
        theta0 = torch.zeros(2)
    else:
        data, _, theta0 = mlp_problem(g, S=3, n=30, din=3, hid=4, dout=2)
        ll = mlp_log_lik
    s = api.FSGLD(api.Posterior(ll), data, minibatch=5, step_size=1e-3,
                  surrogate=api.SurrogateSpec(kind=kind, fit=fit,
                                              fit_steps=20,
                                              fit_minibatch=5),
                  schedule=api.Schedule(rounds=2, local_steps=3, n_chains=2),
                  execution=CPU)
    tr = s.sample(torch.Generator().manual_seed(1), theta0)
    assert s.bank is not None and s.bank.kind == kind
    assert all(torch.isfinite(v).all() for v in tu.leaves(tr))


def test_synthetic_data_and_heldout_loglik():
    g = torch.Generator().manual_seed(0)
    data, pi = susy_shards(g, num_shards=6, shard_size=400, beta_a=0.5)
    assert data["x"].shape == (6, 400, 18) and data["y"].shape == (6, 400)
    assert ((pi > 0) & (pi < 1)).all()
    # per-shard label proportions follow pi
    torch.testing.assert_close(data["y"].mean(1), pi, atol=0.1, rtol=0)
    test = susy_test_set(torch.Generator().manual_seed(1), size=2000)
    assert abs(float(test["y"].mean()) - 0.5) < 0.05  # Beta(1e6, 1e6)
    x, mus = gaussian_shards(g, num_shards=4, shard_size=50, dim=3)
    assert x["x"].shape == (4, 50, 3) and mus.abs().max() <= 6.0
    ll = avg_loglik(torch.zeros(5, TABLE1_P), test)
    assert abs(ll - np.log(0.5)) < 1e-5  # zero weights: uniform softmax


def test_stacked_initial_states_continue_a_run():
    """``stacked=True`` takes per-chain states: a 2-round run equals a
    1-round run continued from its final states on the same generator."""
    s, theta0 = _mlp_sampler("packed", rounds=2)
    eng = s.engine
    whole = eng.run(torch.Generator().manual_seed(4), theta0, 2, n_chains=3,
                    collect=False)
    g = torch.Generator().manual_seed(4)
    first = eng.run(g, theta0, 1, n_chains=3, collect=False)
    second = eng.run(g, first, 1, n_chains=3, collect=False, stacked=True)
    for a, b in zip(tu.leaves(whole), tu.leaves(second)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leading"):
        eng.run(g, first, 1, n_chains=2, stacked=True)
