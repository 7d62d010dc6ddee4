"""The port's sampler math against the JAX package's, on the same numpy
inputs: surrogates, conducive gradients, chain scales, drifts, surrogate
fitting, the kernel step path, diagnostics, and a JAX bank carried across
through ``repro_torch.convert``.

Tolerances are float32 rounding: 1e-5 relative (1e-4 for sums over many
per-example gradients, whose order differs between XLA and torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JCfg
from repro.core import conducive as jcond
from repro.core import diagnostics as jdiag
from repro.core import federated as jfed
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.convert import bank_from_numpy, tree_from_numpy
from repro_torch.core import conducive as tcond
from repro_torch.core import diagnostics as tdiag
from repro_torch.core import federated as tfed
from repro_torch.core import sampler as tsam
from repro_torch.core import surrogate as tsur
from repro_torch.core.engine import pad_shards
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

S = 4


def _close(a, b, tol=1e-5):
    for x, y in zip(jax.tree.leaves(a), tu.leaves(b)):
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(x),
                                   atol=tol, rtol=tol)


def _diag_bank_np(rng, P):
    return (rng.standard_normal((S, P)).astype(np.float32),
            rng.uniform(0.5, 3.0, (S, P)).astype(np.float32))


def _scalar_bank_np(rng, tree):
    means = jax.tree.map(lambda a: rng.standard_normal(
        (S,) + a.shape).astype(np.float32), tree)
    precs = jax.tree.map(lambda a: rng.uniform(0.5, 3.0, S).astype(
        np.float32), tree)
    return means, precs


MLP = {"w1": np.zeros((3, 5), np.float32), "b1": np.zeros(5, np.float32),
       "w2": np.zeros((5, 2), np.float32), "b2": np.zeros(2, np.float32)}


def mlp_ll_j(theta, batch):
    h = jnp.tanh(batch["x"] @ theta["w1"] + theta["b1"])
    return -0.5 * jnp.sum((batch["y"] - (h @ theta["w2"] + theta["b2"])) ** 2)


def mlp_ll_t(theta, batch):
    h = torch.tanh(batch["x"] @ theta["w1"] + theta["b1"])
    return -0.5 * torch.sum((batch["y"] - (h @ theta["w2"] + theta["b2"]))
                            ** 2)


def gauss_ll_j(theta, batch):
    return -0.5 * jnp.sum((batch["x"] - theta) ** 2)


def gauss_ll_t(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def test_make_bank_matches_jax_and_converts():
    rng = np.random.default_rng(0)
    m, p = _diag_bank_np(rng, 37)
    jb = jsur.make_bank(jnp.asarray(m), jnp.asarray(p), "diag")
    tb = bank_from_numpy(m, p, "diag")
    _close(jb.global_.mean, tb.global_.mean)
    _close(jb.global_.prec, tb.global_.prec)
    ms, ps = _scalar_bank_np(rng, MLP)
    jb = jsur.make_bank(jax.tree.map(jnp.asarray, ms),
                        jax.tree.map(jnp.asarray, ps), "scalar")
    tb = bank_from_numpy(ms, ps, "scalar")
    _close(jb.global_.mean, tb.global_.mean)
    _close(jb.global_.prec, tb.global_.prec)
    assert tb.num_shards == S
    half = tb.astype(torch.bfloat16)
    assert tu.leaves(half.means)[0].dtype == torch.bfloat16
    assert tu.leaves(half.precs)[0].dtype == torch.float32


def test_tree_from_numpy_keeps_structure_and_bf16():
    t = tree_from_numpy({"a": np.ones(3, np.float32),
                         "b": [np.zeros((2, 2), np.float32)],
                         "h": np.asarray(jnp.ones(4, jnp.bfloat16))})
    assert t["a"].dtype == torch.float32 and t["b"][0].shape == (2, 2)
    assert t["h"].dtype == torch.bfloat16 and float(t["h"].sum()) == 4.0


@pytest.mark.parametrize("kind", ["diag", "scalar"])
def test_conducive_gradient_matches_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "diag":
        m, p = _diag_bank_np(rng, 29)
        theta = rng.standard_normal(29).astype(np.float32)
    else:
        m, p = _scalar_bank_np(rng, MLP)
        theta = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), MLP)
    jb = jsur.make_bank(jax.tree.map(jnp.asarray, m),
                        jax.tree.map(jnp.asarray, p), kind)
    tb = bank_from_numpy(m, p, kind)
    a = jcond.conducive_gradient(jax.tree.map(jnp.asarray, theta),
                                 jb.global_, jb.shard(2), 0.25, 0.7)
    b = tcond.conducive_gradient(tree_from_numpy(theta), tb.global_,
                                 tb.shard(2), 0.25, 0.7)
    _close(a, b)


@pytest.mark.parametrize("method", ["sgld", "dsgld", "fsgld"])
def test_chain_scales_match_jax(method):
    sizes, probs = (50, 70, 20, 60), (0.1, 0.4, 0.3, 0.2)
    jc = JCfg(method=method, num_shards=S, shard_probs=probs)
    tc = TCfg(method=method, num_shards=S, shard_probs=probs)
    sids = np.array([3, 0, 1, 1, 2])
    a = jsam.chain_scales(jc, jsam.ShardScheme(sizes, probs),
                          jnp.asarray(sids), 10)
    b = tsam.chain_scales(tc, tsam.ShardScheme(sizes, probs),
                          torch.from_numpy(sids), 10)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("method", ["sgld", "dsgld", "fsgld"])
@pytest.mark.parametrize("kind", ["diag", "scalar"])
def test_drift_matches_jax(method, kind):
    """make_drift_fn on both sides, the port's bank carried over from the
    JAX bank's arrays."""
    rng = np.random.default_rng(2)
    sizes, probs = (50, 70, 20, 60), (0.1, 0.4, 0.3, 0.2)
    cfg_kw = dict(method=method, num_shards=S, shard_probs=probs,
                  alpha=0.8, prior_precision=1.5, surrogate=kind)
    if kind == "diag":
        d = 6
        theta = rng.standard_normal(d).astype(np.float32)
        batch = {"x": rng.standard_normal((10, d)).astype(np.float32)}
        m, p = _diag_bank_np(rng, d)
        ll_j, ll_t = gauss_ll_j, gauss_ll_t
    else:
        theta = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), MLP)
        batch = {"x": rng.standard_normal((10, 3)).astype(np.float32),
                 "y": rng.standard_normal((10, 2)).astype(np.float32)}
        m, p = _scalar_bank_np(rng, MLP)
        ll_j, ll_t = mlp_ll_j, mlp_ll_t
    jb = jsur.make_bank(jax.tree.map(jnp.asarray, m),
                        jax.tree.map(jnp.asarray, p), kind)
    tb = bank_from_numpy(m, p, kind)
    jd = jsam.make_drift_fn(ll_j, JCfg(**cfg_kw),
                            jsam.ShardScheme(sizes, probs), jb)
    td = tsam.make_drift_fn(ll_t, TCfg(**cfg_kw),
                            tsam.ShardScheme(sizes, probs), tb)
    a = jd(jax.tree.map(jnp.asarray, theta), jax.tree.map(jnp.asarray, batch),
           jnp.int32(1), 10)
    b = td(tree_from_numpy(theta), tree_from_numpy(batch), torch.tensor(1),
           10)
    _close(a, b, tol=2e-5)


def test_kernel_step_matches_plain_step_at_zero_temperature():
    """make_step_fn: the fused-kernel branch equals the plain branch when
    the noise is off (their noise streams differ by construction)."""
    tree = {"a": torch.randn(130, generator=torch.Generator().manual_seed(0)),
            "b": {"c": torch.randn(7, 11,
                                   generator=torch.Generator().manual_seed(1))}}

    def log_lik(theta, batch):
        return -0.5 * torch.sum((batch["x"] - theta["a"][0]) ** 2) \
            - 0.5 * torch.sum(theta["b"]["c"] ** 2)

    cfg = TCfg(method="fsgld", step_size=1e-3, num_shards=4,
               temperature=0.0, surrogate="scalar")
    scheme = tsam.ShardScheme(sizes=(50,) * 4, probs=(0.25,) * 4)
    means = tu.tree_map(lambda t: torch.stack([t * 0.9, t * 1.1, t * 0.8,
                                               t * 1.2]), tree)
    precs = tu.tree_map(lambda t: torch.tensor([0.5, 0.6, 0.7, 0.8]), tree)
    bank = tsur.make_bank(means, precs, "scalar")
    batch = {"x": torch.ones(8)}
    plain = tsam.make_step_fn(log_lik, cfg, scheme, bank, use_kernel=False)
    fused = tsam.make_step_fn(log_lik, cfg, scheme, bank, use_kernel=True)
    a = plain(tree, torch.Generator().manual_seed(5), batch,
              torch.tensor(2), 8)
    b = fused(tree, torch.Generator().manual_seed(5), batch,
              torch.tensor(2), 8)
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


def _bnn_shards(rng, n=40):
    x = rng.standard_normal((S, n, 3)).astype(np.float32)
    y = rng.standard_normal((S, n, 2)).astype(np.float32)
    return {"x": x, "y": y}


def flat_ll_j(theta, batch):
    w = theta[:6].reshape(3, 2)
    return -0.5 * jnp.sum((batch["y"] - jnp.tanh(batch["x"] @ w)
                           - theta[6:]) ** 2)


def flat_ll_t(theta, batch):
    w = theta[:6].reshape(3, 2)
    return -0.5 * torch.sum((batch["y"] - torch.tanh(batch["x"] @ w)
                             - theta[6:]) ** 2)


def test_fit_bank_fisher_matches_jax():
    rng = np.random.default_rng(3)
    data = _bnn_shards(rng)
    means = rng.standard_normal((S, 8)).astype(np.float32) * 0.5
    jb = jfed.fit_bank_fisher(flat_ll_j, jax.tree.map(jnp.asarray, data),
                              jnp.asarray(means), batch=16)
    tb = tfed.fit_bank_fisher(flat_ll_t, tree_from_numpy(data),
                              torch.from_numpy(means), batch=16)
    _close(jb.precs, tb.precs, tol=1e-4)
    _close(jb.global_.mean, tb.global_.mean, tol=1e-4)


def test_refresh_bank_matches_jax():
    rng = np.random.default_rng(4)
    data = _bnn_shards(rng)
    theta = rng.standard_normal(8).astype(np.float32) * 0.5
    jb = jfed.refresh_bank(flat_ll_j, jax.tree.map(jnp.asarray, data),
                           jnp.asarray(theta), batch=16)
    tb = tfed.refresh_bank(flat_ll_t, tree_from_numpy(data),
                           torch.from_numpy(theta), batch=16)
    _close(jb.precs, tb.precs, tol=1e-4)
    _close(jb.means, tb.means, tol=1e-4)


def test_sample_local_likelihood_shapes_and_pull():
    """Per-shard SGLD lands near each shard's own mean (a statistical
    check: the port's noise comes from its generator)."""
    g = torch.Generator().manual_seed(0)
    mus = torch.tensor([[-2.0, 1.0], [3.0, 0.0], [0.0, -3.0], [1.0, 1.0]])
    x = mus[:, None, :] + torch.randn((S, 200, 2), generator=g)
    out = tfed.sample_local_likelihood(
        gauss_ll_t, {"x": x}, torch.zeros(2), g, minibatch=20,
        step_size=1e-3, num_steps=300, burn_in=100, thin=10)
    assert out.shape == (S, 20, 2)
    torch.testing.assert_close(out.mean(1), x.mean(1), atol=0.15, rtol=0)


def test_fits_match_jax():
    rng = np.random.default_rng(5)
    smp = rng.standard_normal((50, 6)).astype(np.float32)
    for kw in ({}, dict(likelihood_only=False, prior_prec=0.5)):
        _close(jsur.fit_gaussian(jnp.asarray(smp), "diag", **kw),
               tsur.fit_gaussian(torch.from_numpy(smp), "diag", **kw))
    tree = {"a": smp, "b": smp[:, :2] * 3}
    _close(jsur.fit_scalar_tree(jax.tree.map(jnp.asarray, tree)),
           tsur.fit_scalar_tree(tree_from_numpy(tree)))
    _close(jsur.analytic_gaussian_likelihood_surrogate(jnp.asarray(smp)),
           tsur.analytic_gaussian_likelihood_surrogate(
               torch.from_numpy(smp)))


def test_diagnostics_match_jax():
    rng = np.random.default_rng(6)
    x = np.cumsum(rng.standard_normal((3, 101, 4)), axis=1).astype(
        np.float32) * 0.1 + rng.standard_normal((3, 101, 4)).astype(
            np.float32)
    mask = np.array([True, False, True])
    kept = jnp.asarray(x[mask])
    xt = torch.from_numpy(x)
    _close(jdiag.rhat(kept), tdiag.rhat(xt, mask=mask), tol=1e-4)
    _close(jdiag.ess(kept), tdiag.ess(xt, mask=mask), tol=1e-3)
    b = tdiag.summarize(xt, mask=mask)
    assert set(b) == {"max_rhat", "min_ess", "mean_ess", "n_healthy",
                      "n_excluded"} and b["n_excluded"] == 1
    np.testing.assert_allclose(b["max_rhat"],
                               float(jnp.max(jdiag.rhat(kept))), rtol=1e-4)
    bad = xt.clone()
    bad[1, 5, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        tdiag.rhat(bad)
    assert torch.isfinite(tdiag.ess(bad, mask=mask)).all()
    with pytest.raises(ValueError, match="excludes every chain"):
        tdiag.rhat(bad, mask=np.zeros(3, bool))
    with pytest.raises(ValueError, match=">= 4 samples"):
        tdiag.rhat(bad[:, :3], mask=mask)


def test_pad_shards_pads_nan_and_int_min():
    a = {"x": torch.ones(3, 2), "i": torch.ones(3, dtype=torch.int32)}
    b = {"x": torch.ones(5, 2), "i": torch.ones(5, dtype=torch.int32)}
    st, sizes = pad_shards([a, b])
    assert sizes == (3, 5) and st["x"].shape == (2, 5, 2)
    assert torch.isnan(st["x"][0, 3:]).all()
    assert (st["i"][0, 3:] == torch.iinfo(torch.int32).min).all()
