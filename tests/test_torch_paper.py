"""The paper's own workloads in the port against the JAX package.

* Data: ``split_shards`` bitwise on the same arrays; the generators
  (another generator than JAX's keys) on their structure: specs, class-
  disjoint shards, half similar / half dissimilar pairs, moments.
* Surrogates: the 'linear' and 'full' kinds (gradients, densities, the
  bank's global product), ``fit_gaussian('full')``,
  ``conducive_gradient_from_bank``, ``fit_bank_linear`` and
  ``fit_bank_from_samples`` on the same numpy inputs as ``repro``.
* ``FederatedSampler.run_vmap``, the host-loop oracle, equals the
  engine's vmap executor bitwise (Langevin and SGHMC, both reassign
  modes, pooled SGLD) and, with the kernel, the per_leaf executor.
* The vmap executor with 'linear' and 'full' banks against a JAX loop
  built from ``repro``'s drift on injected draws (``_fed_jax_loop``).
* The calibration copy against ``repro.eval.calibration``; the f1 and
  Fig. 5 log-likelihoods, gradients and features against the benchmark
  modules' JAX functions; f1 through both facades on one data set.

Tolerances: float32 results that differ only in summation order are held
to 1e-5 relative (1e-6 absolute); matrix solves and inverses to 1e-5
relative of the largest entry (see each test).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _fed_jax_loop as L
from repro import api as japi
from repro.configs.base import SamplerConfig as JCfg
from repro.core import conducive as jcon
from repro.core import federated as jfed
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.data import synthetic as jsyn
from repro.eval import calibration as jcal
from repro_torch import api
from repro_torch import tree as tu
from repro_torch import workloads as W
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.core import surrogate as tsur
from repro_torch.core.conducive import conducive_gradient_from_bank
from repro_torch.core.federated import (FederatedSampler,
                                        fit_bank_from_samples,
                                        fit_bank_linear)
from repro_torch.core.sghmc import SGHMCConfig
from repro_torch.data import (LINREG_SPECS, linreg_datasets, metric_pairs,
                              metric_test_pairs, split_shards)
from repro_torch.eval import calibration as tcal
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import fig5_metric_learning as jfig5  # noqa: E402

CPU = api.Execution(device="cpu")


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_split_shards_bitwise_equals_the_reference():
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((103, 5)).astype(np.float32),
            "y": rng.standard_normal(103).astype(np.float32)}
    want = jsyn.split_shards(jax.tree.map(jnp.asarray, data), 10)
    got = split_shards({k: t(v) for k, v in data.items()}, 10)
    for k in data:
        assert got[k].shape == want[k].shape == (10, 10) + data[k].shape[1:]
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_linreg_datasets_match_the_specs_and_moments():
    """The reference's (n, d) from its shapes (``jax.eval_shape``) and
    its noise levels 0.3 / 0.8 / 0.5; the port's draws on their
    moments."""
    sets = linreg_datasets(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(jsyn.linreg_datasets, jax.random.PRNGKey(0))
    assert list(sets) == [n for n, *_ in LINREG_SPECS]
    assert set(ref) == set(sets)
    assert [sig for *_, sig in LINREG_SPECS] == [0.3, 0.8, 0.5]
    for name, n, d, sig in LINREG_SPECS:
        ds = sets[name]
        assert ds["x"].shape == ref[name]["x"].shape == (n, d)
        assert ds["y"].shape == ref[name]["y"].shape == (n,)
        assert ds["beta"].shape == (d,) and ds["sigma"] == sig
        resid = ds["y"] - ds["x"] @ ds["beta"]
        # n >= 1030 residuals: their std within 8% of sigma, the x
        # moments within 5 standard errors of N(0, 1)'s
        assert abs(float(resid.std()) / sig - 1) < 0.08
        n_x = ds["x"].numel()
        assert abs(float(ds["x"].mean())) < 5 / np.sqrt(n_x)
        assert abs(float(ds["x"].var()) - 1) < 5 * np.sqrt(2 / n_x)


def _nearest(points, centers):
    return torch.cdist(points, centers).argmin(-1)


def test_metric_pairs_are_class_disjoint_and_half_similar():
    S, C, pairs = 5, 10, 200
    data, centers = metric_pairs(torch.Generator().manual_seed(0),
                                 num_classes=C, dim=16, num_shards=S,
                                 pairs_per_shard=pairs, class_sep=8.0)
    jdata, jcenters = jax.eval_shape(
        lambda k: jsyn.metric_pairs(k, num_classes=C, dim=16, num_shards=S,
                                    pairs_per_shard=pairs, class_sep=8.0),
        jax.random.PRNGKey(0))
    for k in ("xi", "xj", "y"):
        assert data[k].shape == jdata[k].shape
    assert centers.shape == jcenters.shape == (C, 16)
    half = pairs // 2
    for s in range(S):
        ci = _nearest(data["xi"][s], centers)
        cj = _nearest(data["xj"][s], centers)
        # class-disjoint: shard s holds classes [2s, 2s + 2) only
        assert set(ci.tolist()) | set(cj.tolist()) == {2 * s, 2 * s + 1}
        assert torch.equal(data["y"][s], torch.cat([torch.ones(half),
                                                    torch.zeros(half)]))
        assert torch.equal(ci[:half], cj[:half])      # similar pairs
        assert not (ci[half:] == cj[half:]).any()     # dissimilar pairs
        noise = data["xi"][s] - centers[ci]
        assert abs(float(noise.mean())) < 5 / np.sqrt(noise.numel())
        assert abs(float(noise.var()) - 1) < 0.1
    assert abs(float(centers.std()) / 8.0 - 1) < 0.15


def test_metric_test_pairs_span_all_classes_half_similar():
    C = 8
    _, centers = metric_pairs(torch.Generator().manual_seed(1),
                              num_classes=C, dim=16, num_shards=4,
                              pairs_per_shard=8, class_sep=8.0)
    test = metric_test_pairs(torch.Generator().manual_seed(2), centers,
                             num_pairs=400)
    ci, cj = _nearest(test["xi"], centers), _nearest(test["xj"], centers)
    assert test["xi"].shape == (400, 16)
    assert set(ci.tolist()) == set(range(C))
    assert torch.equal(ci[:200], cj[:200]) and not (ci[200:] ==
                                                     cj[200:]).any()
    assert float(test["y"].sum()) == 200.0


# ---------------------------------------------------------------------------
# surrogates
# ---------------------------------------------------------------------------

def _spd(rng, S, P):
    a = rng.standard_normal((S, P, P)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + P * np.eye(P, dtype=np.float32)
            ).astype(np.float32)


def _bank_inputs(kind, rng, S=4, P=6):
    means = rng.standard_normal((S, P)).astype(np.float32)
    if kind == "full":
        precs = _spd(rng, S, P)
    elif kind == "diag":
        precs = rng.uniform(1.0, 5.0, (S, P)).astype(np.float32)
    elif kind == "linear":
        precs = np.zeros((S, P), np.float32)
    else:  # scalar: a two-leaf tree, one precision per leaf
        means = {"a": means, "b": rng.standard_normal((S, 3, 2)
                                                      ).astype(np.float32)}
        precs = {"a": rng.uniform(1, 5, S).astype(np.float32),
                 "b": rng.uniform(1, 5, S).astype(np.float32)}
    return means, precs


@pytest.mark.parametrize("kind", ["linear", "full", "diag", "scalar"])
def test_bank_product_grad_and_density_match_the_reference(kind):
    """The global product (a float32 solve for 'full'), grad log q and
    log q of the global and of each client, within 1e-5 relative."""
    rng = np.random.default_rng(1)
    means, precs = _bank_inputs(kind, rng)
    jb = jsur.make_bank(jax.tree.map(jnp.asarray, means),
                        jax.tree.map(jnp.asarray, precs), kind)
    tb = tsur.make_bank(tu.tree_map(t, means), tu.tree_map(t, precs), kind)
    for a, b in zip(tu.leaves(tb.global_.mean), jax.tree.leaves(
            jb.global_.mean)):
        close(a, b)
    for a, b in zip(tu.leaves(tb.global_.prec), jax.tree.leaves(
            jb.global_.prec)):
        close(a, b)
    theta = jax.tree.map(lambda m: m[0] + 0.5, means)
    for s in (None, 0, 3):
        jq = jb.global_ if s is None else jb.shard(s)
        tq = tb.global_ if s is None else tb.shard(s)
        got = tq.grad_log(tu.tree_map(t, theta))
        want = jq.grad_log(jax.tree.map(jnp.asarray, theta))
        for a, b in zip(tu.leaves(got), jax.tree.leaves(want)):
            close(a, b)
        close(tq.log_density(tu.tree_map(t, theta)),
              jq.log_density(jax.tree.map(jnp.asarray, theta)))


@pytest.mark.parametrize("likelihood_only", [True, False])
@pytest.mark.parametrize("kind", ["full", "diag"])
def test_fit_gaussian_matches_the_reference(kind, likelihood_only):
    """The moment fit, and with likelihood_only=False the prior's natural
    parameters subtracted: within 1e-5 of the largest entry (an inverse
    and a solve of a float32 covariance)."""
    rng = np.random.default_rng(2)
    samples = (rng.standard_normal((400, 5)) @ rng.standard_normal((5, 5))
               * 0.1 + 1.0).astype(np.float32)
    kw = dict(likelihood_only=likelihood_only, prior_prec=0.5)
    mu, prec = tsur.fit_gaussian(t(samples), kind, **kw)
    jmu, jprec = jsur.fit_gaussian(jnp.asarray(samples), kind, **kw)
    close(mu, jmu, atol=1e-5 * float(np.abs(jmu).max()))
    close(prec, jprec, atol=1e-5 * float(np.abs(jprec).max()))


@pytest.mark.parametrize("kind", ["linear", "full", "diag"])
def test_conducive_gradient_from_bank_matches_the_reference(kind):
    rng = np.random.default_rng(3)
    means, precs = _bank_inputs(kind, rng)
    jb = jsur.make_bank(jnp.asarray(means), jnp.asarray(precs), kind)
    tb = tsur.make_bank(t(means), t(precs), kind)
    theta = rng.standard_normal(6).astype(np.float32)
    for s in range(4):
        close(conducive_gradient_from_bank(t(theta), tb, s, 0.25, 0.7),
              jcon.conducive_gradient_from_bank(jnp.asarray(theta), jb, s,
                                                0.25, 0.7))


def test_fit_bank_linear_matches_the_reference_at_conductivity_size():
    """conductivity's training split (10 x 1,391 rows, d = 81): five
    chunks of 256 rows and a tail of 111 per client, summed in the
    reference's order; within 1e-5 relative of the largest gradient."""
    rng = np.random.default_rng(4)
    S, n, d, sig = 10, 1391, 81, 0.5
    x = rng.standard_normal((S, n, d)).astype(np.float32)
    y = (x @ rng.standard_normal(d) + sig * rng.standard_normal((S, n))
         ).astype(np.float32)
    theta = (0.3 * rng.standard_normal(d)).astype(np.float32)

    def jll(th, b):
        r = b["y"] - b["x"] @ th
        return -0.5 * jnp.sum(r * r) / sig ** 2

    jb = jfed.fit_bank_linear(jll, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                              jnp.asarray(theta), batch=256)
    tb = fit_bank_linear(W.linreg_log_lik(sig), {"x": t(x), "y": t(y)},
                         t(theta), batch=256)
    assert tb.kind == "linear"
    scale = float(np.abs(np.asarray(jb.means)).max())
    close(tb.means, jb.means, rtol=0, atol=1e-5 * scale)
    close(tb.global_.mean, jb.global_.mean, rtol=0, atol=1e-5 * 10 * scale)
    assert not tb.precs.any() and not tb.global_.prec.any()


@pytest.mark.parametrize("kind,max_prec", [("diag", None), ("diag", 40.0),
                                           ("full", None), ("full", 40.0)])
def test_fit_bank_from_samples_matches_the_reference(kind, max_prec):
    rng = np.random.default_rng(5)
    samples = (0.2 * rng.standard_normal((3, 300, 4))
               + rng.standard_normal((3, 1, 4))).astype(np.float32)
    jb = jfed.fit_bank_from_samples(jnp.asarray(samples), kind,
                                    max_prec=max_prec)
    tb = fit_bank_from_samples(t(samples), kind, max_prec=max_prec)
    for got, want in ((tb.means, jb.means), (tb.precs, jb.precs),
                      (tb.global_.mean, jb.global_.mean),
                      (tb.global_.prec, jb.global_.prec)):
        close(got, want, rtol=0,
              atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    if max_prec is not None:
        assert float(tb.precs.max()) <= max_prec


def test_running_moments_refuse_the_new_kinds():
    with pytest.raises(ValueError, match="linear"):
        tsur.RunningMoments("linear")


# ---------------------------------------------------------------------------
# the host-loop oracle
# ---------------------------------------------------------------------------

def _oracle_problem(method="fsgld", kind="diag"):
    """Table-1-like: the multi-leaf MLP posterior of bench_chains on three
    equally sized clients, its 'scalar' bank; or the Gaussian mean with a
    'diag' bank when ``kind`` is 'diag'."""
    rng = np.random.default_rng(6)
    S, n, D = 3, 24, 5
    x = (rng.uniform(-2, 2, (S, 1, D)) + rng.standard_normal((S, n, D))
         ).astype(np.float32)
    data = {"x": t(x)}
    bank = tsur.make_bank(t(x.mean(1)), t(np.full((S, D), float(n),
                                                  np.float32)), "diag")
    cfg = TCfg(method=method, step_size=1e-3, num_shards=S, local_updates=3,
               prior_precision=1.0, shard_probs=(0.5, 0.2, 0.3))
    return data, bank, cfg, t((0.1 * rng.standard_normal(D)
                               ).astype(np.float32))


@pytest.mark.parametrize("dynamics", ["langevin", "sghmc"])
@pytest.mark.parametrize("reassign", ["categorical", "permutation"])
def test_run_vmap_equals_the_engine_vmap_executor_bitwise(dynamics,
                                                          reassign):
    data, bank, cfg, theta0 = _oracle_problem()
    hmc = SGHMCConfig(friction=0.2) if dynamics == "sghmc" else None
    oracle = FederatedSampler(W.gaussian_log_lik, cfg, data, 4, bank=bank,
                              dynamics=dynamics, sghmc=hmc)
    engine = teng.MeshChainEngine(W.gaussian_log_lik, cfg, data, 4,
                                  bank=bank, dynamics=dynamics, sghmc=hmc)
    kw = dict(n_chains=5, reassign=reassign, collect_every=2)
    want = engine.run(torch.Generator().manual_seed(7), theta0, 4, **kw)
    got = oracle.run_vmap(torch.Generator().manual_seed(7), theta0, 4, **kw)
    assert got.shape == want.shape == (5, 4 * 2, 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["sgld", "dsgld"])
def test_run_vmap_pooled_sgld_and_dsgld_equal_the_engine(method):
    data, bank, cfg, theta0 = _oracle_problem(method=method)
    oracle = FederatedSampler(W.gaussian_log_lik, cfg, data, 4, bank=bank)
    engine = teng.MeshChainEngine(W.gaussian_log_lik, cfg, data, 4)
    want = engine.run(torch.Generator().manual_seed(8), theta0, 3,
                      n_chains=4)
    got = oracle.run_vmap(torch.Generator().manual_seed(8), theta0, 3,
                          n_chains=4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dynamics", ["langevin", "sghmc"])
def test_run_vmap_with_the_kernel_equals_per_leaf_bitwise(dynamics):
    """One kernel call per chain (the plain version on the CPU) against
    the per_leaf executor's chain-batched calls on the same seeds; the
    multi-leaf 'scalar' MLP posterior."""
    gen = torch.Generator().manual_seed(0)
    data, bank, theta0 = W.mlp_problem(gen, S=3, n=16, din=4, hid=8, dout=2)
    cfg = TCfg(method="fsgld", step_size=1e-4, num_shards=3,
               local_updates=2, prior_precision=1.0)
    hmc = SGHMCConfig(friction=0.3) if dynamics == "sghmc" else None
    oracle = FederatedSampler(W.mlp_log_lik, cfg, data, 4, bank=bank,
                              use_kernel=True, dynamics=dynamics, sghmc=hmc)
    engine = teng.MeshChainEngine(W.mlp_log_lik, cfg, data, 4, bank=bank,
                                  use_kernel=True, packed=False,
                                  dynamics=dynamics, sghmc=hmc)
    want = engine.run(torch.Generator().manual_seed(9), theta0, 3,
                      n_chains=3)
    got = oracle.run_vmap(torch.Generator().manual_seed(9), theta0, 3,
                          n_chains=3)
    for a, b in zip(tu.leaves(got), tu.leaves(want)):
        assert torch.equal(a, b)


def test_run_vmap_refusals():
    data, bank, cfg, theta0 = _oracle_problem()
    oracle = FederatedSampler(W.gaussian_log_lik, cfg, data, 4, bank=bank)
    with pytest.raises(NotImplementedError, match="sghmc"):
        FederatedSampler(W.gaussian_log_lik, cfg, data, 4, bank=bank,
                         dynamics="sghmc").run_vmap(
            torch.Generator(), theta0, 1, refresh_every=2)
    lin = tsur.make_bank(torch.ones(3, 5), torch.zeros(3, 5), "linear")
    with pytest.raises(ValueError, match="linear"):
        FederatedSampler(W.gaussian_log_lik, cfg, data, 4, bank=lin,
                         use_kernel=True).run_vmap(torch.Generator(),
                                                   theta0, 1)


# ---------------------------------------------------------------------------
# the vmap executor with 'linear' and 'full' banks against a JAX loop
# ---------------------------------------------------------------------------

def _jax_vmap_loop(data, jbank, theta0, draws, noise):
    """T plain steps per round from ``repro``'s drift, vmapped over the
    chains, with the injected draws and noise: (C, rounds * T, D)."""
    cfg = JCfg(**L.cfg_kw("fsgld"))
    drift = jsam.make_drift_fn(L.jax_log_lik, cfg,
                               jsam.ShardScheme(L.SIZES, L.PROBS), jbank)
    dv = jax.jit(jax.vmap(lambda th, b, s: drift(th, b, s, L.M)))
    x = jnp.asarray(data["x"])
    thetas = jnp.broadcast_to(jnp.asarray(theta0), (L.C, L.D))
    trace, k = [], 0
    for (sids, idx, _, _), _ in draws:
        for step in range(L.T):
            d = dv(thetas, {"x": x[sids[:, None], idx[step]]},
                   jnp.asarray(sids))
            thetas = thetas + (L.H / 2) * d + np.sqrt(L.H) * noise[k]
            trace.append(np.asarray(thetas))
            k += 1
    return np.stack(trace, 1)


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_vmap_executor_with_new_kinds_matches_jax_loop(kind, monkeypatch):
    """The ragged D = 200 Gaussian of ``_fed_jax_loop`` with a 'linear'
    bank (the per-client full gradients at theta0) or a 'full' one (the
    exact precisions n_s I plus a random SPD coupling), 3 rounds of the
    injected draws; the port's noise is the generator's normals, handed to
    the JAX loop. Within 1e-5: float32 summation order of the drift."""
    data, means, precs, theta0 = L.problem()
    rng = np.random.default_rng(10)
    if kind == "linear":
        live = [data["x"][s, :n] for s, n in enumerate(L.SIZES)]
        means = np.stack([(x - theta0).sum(0) for x in live]
                         ).astype(np.float32)
        precs = np.zeros_like(means)
    else:
        a = 0.1 * rng.standard_normal((L.S, L.D, L.D)).astype(np.float32)
        precs = (np.stack([np.diag(p) for p in precs])
                 + a @ a.transpose(0, 2, 1)).astype(np.float32)
    draws = L.make_draws(3, "identity")
    monkeypatch.setattr(teng, "draw_round", L.injected(draws))
    tb = tsur.make_bank(t(means), t(precs), kind)
    s = api.FSGLD(api.Posterior(L.torch_log_lik, prior_precision=1.0),
                  {"x": t(data["x"])}, minibatch=L.M, step_size=L.H,
                  sizes=L.SIZES, shard_probs=L.PROBS,
                  surrogate=api.SurrogateSpec(kind=kind, bank=tb),
                  schedule=api.Schedule(rounds=3, local_steps=L.T,
                                        n_chains=L.C),
                  execution=CPU)
    assert s._resolve_executor() == (False, None)
    got = s.sample(torch.Generator().manual_seed(11), t(theta0))
    g = torch.Generator().manual_seed(11)
    noise = [torch.randn((L.C, L.D), generator=g).numpy()
             for _ in range(3 * L.T)]
    jb = jsur.make_bank(jnp.asarray(means), jnp.asarray(precs), kind)
    want = _jax_vmap_loop(data, jb, theta0, draws, noise)
    close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _calib_inputs():
    rng = np.random.default_rng(12)
    p = rng.dirichlet(np.ones(3), (5, 40))
    p1 = rng.uniform(0.01, 0.99, (5, 40))
    labels = rng.integers(0, 3, 40)
    y01 = rng.integers(0, 2, 40)
    mus = rng.standard_normal((7, 40))
    sig = rng.uniform(0.2, 1.5, (7, 40))
    targets = rng.standard_normal(40)
    return {"nll_categorical": ((p, labels), {}),
            "ece_from_probs": ((p, labels), {"n_bins": 10}),
            "ece_binary": ((p1, y01), {}),
            "nll_gaussian_mixture": ((mus, sig, targets), {}),
            "interval_coverage": ((mus, targets), {"level": 0.8})}


@pytest.mark.parametrize("name", sorted(_calib_inputs()))
def test_calibration_copy_equals_the_reference(name):
    args, kw = _calib_inputs()[name]
    assert getattr(tcal, name)(*args, **kw) == \
        getattr(jcal, name)(*args, **kw)


def test_calibration_refuses_misshapen_inputs():
    with pytest.raises(ValueError, match="K, N, C"):
        tcal.nll_categorical(np.ones((3, 2)), np.zeros(3))


# ---------------------------------------------------------------------------
# the benchmarks' problems
# ---------------------------------------------------------------------------

def test_f1_log_lik_and_gradient_match_the_benchmark():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((30, 9)).astype(np.float32)
    y = rng.standard_normal(30).astype(np.float32)
    theta = rng.standard_normal(9).astype(np.float32)
    sig2 = 0.3 ** 2

    def jll(th, b):  # f1_linreg.py's log_lik
        r = b["y"] - b["x"] @ th
        return -0.5 * jnp.sum(r * r) / sig2

    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": t(x), "y": t(y)}
    ll = W.linreg_log_lik(0.3)
    close(ll(t(theta), tb), jll(jnp.asarray(theta), jb))
    close(torch.func.grad(ll)(t(theta), tb),
          jax.grad(jll)(jnp.asarray(theta), jb), atol=1e-3)


def test_f1_problem_matches_the_benchmark_split_and_bank():
    """linreg_problem's split and exact per-shard surrogates against
    f1_linreg.py's, on concrete's numpy-made stand-in."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1030, 9)).astype(np.float32)
    y = (x @ rng.standard_normal(9) + 0.3 * rng.standard_normal(1030)
         ).astype(np.float32)
    shards, test, mus, prec = W.linreg_problem({"x": t(x), "y": t(y),
                                                "sigma": 0.3})
    n_train = 820
    assert shards["x"].shape == (10, 82, 9) and test["x"].shape == (210, 9)
    sig2 = 0.09
    js = jsyn.split_shards({"x": jnp.asarray(x[:n_train]),
                            "y": jnp.asarray(y[:n_train])}, 10)

    def fit_shard(xs, ys):  # f1_linreg.py's analytic surrogates
        pf = xs.T @ xs / sig2
        return (jnp.linalg.solve(pf + 1e-6 * jnp.eye(9), xs.T @ ys / sig2),
                jnp.diag(pf))

    jmu, jprec = jax.vmap(fit_shard)(js["x"], js["y"])
    close(mus, jmu, rtol=0, atol=1e-5 * float(np.abs(jmu).max()))
    close(W.linreg_diag_bank(mus, prec).precs, jprec)


def test_fig5_features_log_lik_and_gradient_match_the_benchmark():
    """metric_features against fig5's _features, each package taking its
    own eigenvectors of the same covariance: the squares make their signs
    irrelevant (features within 1e-4 relative: the eigenvectors of a
    float32 covariance). Then the log-likelihood and its gradient."""
    rng = np.random.default_rng(15)
    centers = 1.5 * rng.standard_normal((20, 32))
    cls = rng.integers(0, 20, (2, 10, 40))
    data = {k: (centers[c] + rng.standard_normal(c.shape + (32,))
                ).astype(np.float32) for k, c in zip(("xi", "xj"), cls)}
    data["y"] = (cls[0] == cls[1]).astype(np.float32)
    xall = np.concatenate([data["xi"].reshape(-1, 32),
                           data["xj"].reshape(-1, 32)])
    _, jvecs = jnp.linalg.eigh(jnp.cov(jnp.asarray(xall), rowvar=False))
    jz, _ = jfig5._features(jax.tree.map(jnp.asarray, data),
                            jvecs[:, -W.FIG5_K:])
    _, tvecs = torch.linalg.eigh(torch.cov(t(xall).T))
    tz, _ = W.metric_features({k: t(v) for k, v in data.items()},
                              tvecs[:, -W.FIG5_K:])
    close(tz["z"], jz["z"], rtol=1e-4, atol=1e-4)
    assert np.array_equal(tz["y"].numpy(), np.asarray(jz["y"]))
    batch = {"z": np.asarray(jz["z"][0]), "y": np.asarray(jz["y"][0])}
    theta = rng.standard_normal(W.FIG5_K + 1).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: t(v) for k, v in batch.items()}
    close(W.metric_log_lik(t(theta), tb), jfig5.log_lik(jnp.asarray(theta),
                                                        jb))
    close(torch.func.grad(W.metric_log_lik)(t(theta), tb),
          jax.grad(jfig5.log_lik)(jnp.asarray(theta), jb), atol=1e-5)


def test_f1_through_both_facades_on_one_data_set():
    """The slice end to end: concrete's numpy-made stand-in through
    ``repro.api`` (3 seeds) and ``repro_torch.api`` (3 chains), FSGLD with
    the analytic 'diag' bank, 30 rounds x 40 steps: the test MSEs agree
    within 5 standard errors of the difference of the means."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((1030, 9)).astype(np.float32)
    y = (x @ rng.standard_normal(9) + 0.3 * rng.standard_normal(1030)
         ).astype(np.float32)
    shards, test, mus, prec = W.linreg_problem({"x": t(x), "y": t(y),
                                                "sigma": 0.3})
    bank = W.linreg_diag_bank(mus, prec)
    sched = dict(rounds=30, local_steps=40, thin=20)
    ours = api.FSGLD(api.Posterior(W.linreg_log_lik(0.3),
                                   prior_precision=1.0), shards,
                     minibatch=W.F1_M, step_size=W.F1_H,
                     surrogate=api.SurrogateSpec(kind="diag", bank=bank),
                     schedule=api.Schedule(n_chains=3, **sched),
                     execution=CPU).sample(torch.Generator().manual_seed(0),
                                           torch.zeros(9))
    mse = W.linreg_test_mse(ours, test)
    jbank = jsur.make_bank(jnp.asarray(mus.numpy()),
                           jnp.asarray(torch.diagonal(prec, dim1=1,
                                                      dim2=2).numpy()),
                           "diag")
    jsamp = japi.FSGLD(
        japi.Posterior(lambda th, b: -0.5 * jnp.sum(
            (b["y"] - b["x"] @ th) ** 2) / 0.09, prior_precision=1.0),
        jax.tree.map(lambda v: jnp.asarray(v.numpy()), shards),
        minibatch=W.F1_M, step_size=W.F1_H,
        surrogate=japi.SurrogateSpec(kind="diag", bank=jbank),
        schedule=japi.Schedule(**sched))
    jmse = []
    for rep in range(3):
        tr = jsamp.sample(jax.random.PRNGKey(30 + rep), jnp.zeros(9))
        jmse += W.linreg_test_mse(t(np.asarray(tr)), test)
    se = np.sqrt((np.var(mse, ddof=1) + np.var(jmse, ddof=1)) / 3)
    assert abs(np.mean(mse) - np.mean(jmse)) < max(5 * se, 1e-3), \
        (mse, jmse)


def test_linear_surrogates_zero_mean_and_stable_on_the_cpu():
    """tests/test_extensions.py's linear-surrogate run through the port's
    facade, cut from 100 to 30 rounds of 100 steps (the chain relaxes in
    ~10 steps; chip_smoke.py's [kinds] runs 50): the conducive terms
    sum to 0 within 1e-2 and the posterior-mean MSE is under 5e-3."""
    data, post, bank, total = W.linear_surrogate_problem(
        torch.Generator().manual_seed(0))
    assert float(total.abs().max()) < W.LINEAR_SUM_ATOL
    s = api.FSGLD(api.Posterior(W.gaussian_log_lik, prior_precision=1.0),
                  data, minibatch=10, step_size=1e-4,
                  surrogate=api.SurrogateSpec(kind=bank.kind, bank=bank),
                  schedule=api.Schedule(rounds=30, local_steps=W.LINEAR_T,
                                        thin=W.LINEAR_THIN),
                  execution=CPU)
    tr = s.sample(torch.Generator().manual_seed(3), torch.zeros(2))[0]
    assert bool(torch.isfinite(tr).all())
    mse = float(((tr[tr.shape[0] // 2:].mean(0) - post) ** 2).sum())
    assert mse < W.LINEAR_MSE_CEILING, mse


def test_calibration_problems_hold_their_bounds_on_the_cpu():
    """bench_calibration.py's two problems through the port's facade at
    their full length (600 rounds x 5 steps, one chain), scored by the
    port's calibration copy against the benchmark's absolute bounds."""
    gen = torch.Generator().manual_seed(0)
    c = W.CALIB_LOG
    shards, test = W.calib_logreg_problem(gen)
    tr = api.FSGLD(api.Posterior(W.logreg_log_lik, prior_precision=1.0),
                   shards, minibatch=c["m"], step_size=c["h"],
                   surrogate=api.SurrogateSpec(kind="diag", fit="fisher"),
                   schedule=api.Schedule(rounds=c["rounds"],
                                         local_steps=c["T"],
                                         thin=c["thin"]),
                   execution=CPU).sample(gen, torch.zeros(c["d"]))[0]
    log_scores = W.calib_logreg_scores(tr, test)
    c = W.CALIB_LIN
    shards, test, bank = W.calib_linreg_problem(gen)
    tr = api.FSGLD(api.Posterior(W.linreg_log_lik(c["sigma"]),
                                 prior_precision=1.0),
                   shards, minibatch=c["m"], step_size=c["h"],
                   surrogate=api.SurrogateSpec(kind="diag", bank=bank),
                   schedule=api.Schedule(rounds=c["rounds"],
                                         local_steps=c["T"],
                                         thin=c["thin"]),
                   execution=CPU).sample(gen, torch.zeros(c["d"]))[0]
    lin_scores = W.calib_linreg_scores(tr, test, gen)
    assert W.calib_failures(log_scores, lin_scores) == [], \
        (log_scores, lin_scores)


@pytest.mark.parametrize("problem,scale,caught", [
    ("logreg", 1.0, False), ("logreg", 0.6, True), ("logreg", 2.0, True),
    ("linreg", 1.0, False), ("linreg", 0.9, True)])
def test_calibration_holds_the_ensemble_near_the_true_weights(problem, scale,
                                                              caught):
    """Draws fixed at a multiple of the true weights, the other problem's
    at the true weights: the benchmark's absolute bounds pass weights
    0.6x / 2x (logistic) and 0.9x (linear) off; the margin to the true
    weights' NLL catches them."""
    gen = torch.Generator().manual_seed(0)
    _, test = W.calib_logreg_problem(gen)
    w = torch.tensor(W.CALIB_LOG_W)
    w = w * scale if problem == "logreg" else w
    log_scores = W.calib_logreg_scores(w.expand(W.CALIB_K_DRAWS, -1), test)
    _, test, _ = W.calib_linreg_problem(gen)
    w = torch.tensor(W.CALIB_LIN_W)
    w = w * scale if problem == "linreg" else w
    lin_scores = W.calib_linreg_scores(w.expand(W.CALIB_LIN["keep"], -1),
                                       test, gen)
    bad = W.calib_failures(log_scores, lin_scores)
    assert [b for b in bad if "true weights" not in b] == [], bad
    assert len(bad) == int(caught), bad


def _paper_runs():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "tools" / "paper_runs.py"
    spec = importlib.util.spec_from_file_location("paper_runs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shift,diverged", [(0.0, (1, 0)), (0.8, (0, 2)),
                                            (2.0, (3, 3))])
def test_paper_runs_statistics_match_scipy(shift, diverged):
    """tools/paper_runs.py's Mann-Whitney U (diverged chains ranked last)
    and one-sided Fisher exact tests against scipy's, to 1e-12."""
    from scipy import stats
    P = _paper_runs()
    rng = np.random.default_rng(int(shift * 10))
    a = list(rng.normal(0.0, 1.0, 12))
    b = list(rng.normal(shift, 1.0, 12))
    a[:diverged[0]] = [float("nan")] * diverged[0]
    b[:diverged[1]] = [None] * diverged[1]
    ra, rb = P.ranked(a), P.ranked(b)
    want = stats.mannwhitneyu(ra, rb, alternative="two-sided",
                              method="asymptotic",
                              use_continuity=True).pvalue
    assert abs(P.mann_whitney(ra, rb) - want) < 1e-12
    k1, k2 = diverged
    want = stats.fisher_exact([[k1, 12 - k1], [k2, 12 - k2]],
                              alternative="greater").pvalue
    assert abs(P.fisher_greater(k1, 12, k2, 12) - want) < 1e-12


def test_run_f1_scores_each_chain_of_each_method():
    """The f1 runner builds f1_linreg.py's samplers and scores each chain:
    a stub trace at the exact posterior mean scores the exact MSE."""
    ds = linreg_datasets(torch.Generator().manual_seed(0))["concrete"]
    seen = []

    def run(label, sampler, generator, theta0):
        s = sampler.schedule
        seen.append((label, sampler.cfg.method, s.rounds, s.local_steps,
                     s.n_chains, float(theta0.abs().sum())))
        x = res_shards["x"].reshape(-1, theta0.shape[0])
        y = res_shards["y"].reshape(-1)
        sig2 = ds["sigma"] ** 2
        lam = torch.eye(x.shape[1]) + x.T @ x / sig2
        mean = torch.linalg.solve(lam, x.T @ y / sig2)
        return mean.expand(s.n_chains, 4, -1)

    res_shards = W.linreg_problem(ds)[0]
    res = W.run_f1(ds, n_chains=2, execution=CPU, run=run)
    assert seen == [(m, m, W.F1_ROUNDS, W.F1_T, 2, 0.0)
                    for m in ("dsgld", "fsgld")]
    for m in ("dsgld", "fsgld"):
        close(res[m], [res["exact"]] * 2)


def test_run_fig5_scores_each_chain_on_train_and_test():
    """The Fig. 5 runner: a stub trace at theta = 0 scores log(1/2) per
    pair on the pooled shards and the test pairs."""
    shards, test = W.metric_problem(torch.Generator().manual_seed(0))
    bank = tsur.make_bank(torch.zeros(W.FIG5_S, W.FIG5_K + 1),
                          torch.ones(W.FIG5_S, W.FIG5_K + 1), "diag")

    def run(label, sampler, generator, theta0):
        s = sampler.schedule
        assert (sampler.cfg.method, s.rounds, s.local_steps) == \
            (label, W.FIG5_ROUNDS, W.FIG5_T)
        return torch.zeros(s.n_chains, 6, W.FIG5_K + 1)

    res = W.run_fig5(shards, test, bank, n_chains=3, execution=CPU, run=run)
    assert sorted(res) == ["dsgld", "fsgld"]
    for ll in res.values():
        close(ll["train"] + ll["test"], [-np.log(2.0)] * 6)
