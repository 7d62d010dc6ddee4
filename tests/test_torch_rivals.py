"""The port's rival samplers (``repro_torch.rivals`` and the engine's
``aggregation='fald'``) against the JAX package.

* The method table equals the JAX package's, field by field.
* FA-LD through the engine is BITWISE the port's host-loop oracle
  ``fald_run_vmap`` on the same generator, on every executor and under
  exact, delayed, partial, straggling and compressed scenarios.
* Both hold step by step, within 1e-5, against a JAX loop built from the
  JAX package's pieces (``_fed_jax_loop.py``: the FA-LD average between
  the compression legs, clients at temperature x C) on injected draws.
* FA-LD refuses SGHMC, as the reference does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _fed_jax_loop as L
from repro.rivals import METHODS as JMETHODS
from repro_torch import api
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.rivals import METHODS, fald_run_vmap, get_method
from repro_torch.rivals import fald as tfald
from repro_torch.rivals.methods import method_names
from repro_torch.workloads import gaussian_log_lik
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

S, N, D = 5, 24, 3


@pytest.fixture(scope="module")
def problem():
    g = torch.Generator().manual_seed(0)
    mus = (torch.rand((S, D), generator=g) * 2 - 1) * 4
    return {"x": mus[:, None] + torch.randn((S, N, D), generator=g)}


def test_method_table_matches_jax():
    assert method_names() == tuple(JMETHODS)
    for name in METHODS:
        assert dataclasses.asdict(METHODS[name]) == \
            dataclasses.asdict(JMETHODS[name])
        assert get_method(name) is METHODS[name]
    with pytest.raises(ValueError, match="did you mean 'fald'"):
        get_method("fal")


@pytest.mark.parametrize("executor", ["vmap", "per_leaf", "packed"])
@pytest.mark.parametrize("scenario", [None, "delayed-5x", "partial-50%",
                                      "straggler-10%", "elf-bidir-topk-1%",
                                      "elf-bidir-randk-10%"])
def test_engine_fald_is_bitwise_the_oracle(problem, executor, scenario):
    f = api.FSGLD(
        api.Posterior(gaussian_log_lik, prior_precision=1.0), problem,
        minibatch=6, step_size=1e-4, method="fald",
        schedule=api.Schedule(rounds=6, local_steps=3, n_chains=4),
        execution=api.Execution(device="cpu", executor=executor),
        federation=scenario)
    assert f.engine.aggregation == "fald" and f.cfg.method == "dsgld"
    got = f.sample(torch.Generator().manual_seed(3), torch.zeros(D))
    ref = fald_run_vmap(gaussian_log_lik, f.cfg, f.data, 6,
                        torch.Generator().manual_seed(3), torch.zeros(D), 6,
                        n_chains=4, federation=scenario,
                        use_kernel=(executor != "vmap"))
    assert got.shape == ref.shape == (4, 18, D)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("scenario", ["identity", "partial-50%",
                                      "elf-bidir-qsgd-8bit"])
def test_fald_rounds_match_jax_loop(scenario, monkeypatch):
    """Six FA-LD rounds (DSGLD clients, C = 4, T = 2) on injected draws:
    the engine's packed executor and the port's oracle against the JAX
    loop, within 1e-5."""
    data, means, precs, theta0 = L.problem()
    draws = L.make_draws(6, scenario)
    want = L.jax_loop(data, means, precs, theta0, draws, scenario,
                      method="dsgld", agg=True)
    cfg = TCfg(**L.cfg_kw("dsgld"))
    tdata = {"x": torch.from_numpy(data["x"])}
    monkeypatch.setattr(teng, "draw_round", L.injected(draws))
    eng = teng.MeshChainEngine(L.torch_log_lik, cfg, tdata, L.M,
                               use_kernel=True, sizes=L.SIZES, packed=True,
                               aggregation="fald")
    got = eng.run(torch.Generator(), torch.from_numpy(theta0), 6,
                  n_chains=L.C, federation=scenario).numpy()
    monkeypatch.setattr(tfald, "draw_round", L.injected(draws))
    orc = fald_run_vmap(L.torch_log_lik, cfg, tdata, L.M, torch.Generator(),
                        torch.from_numpy(theta0), 6, n_chains=L.C,
                        federation=scenario, sizes=L.SIZES,
                        use_kernel=True).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, orc)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fald_averages_and_refuses_sghmc(problem):
    """An exchange leaves every chain on the server average: with one
    local step per round the chains' spread right after the steps is the
    per-step noise alone, far below DSGLD's (same draws)."""
    kw = dict(minibatch=6, step_size=1e-4,
              schedule=api.Schedule(rounds=30, local_steps=1, n_chains=4),
              execution=api.Execution(device="cpu"))
    post = api.Posterior(gaussian_log_lik, prior_precision=1.0)
    a = api.FSGLD(post, problem, method="fald", **kw).sample(
        torch.Generator().manual_seed(1), torch.zeros(D))
    b = api.FSGLD(post, problem, method="dsgld", **kw).sample(
        torch.Generator().manual_seed(1), torch.zeros(D))
    assert not torch.equal(a, b)
    spread_a = a[:, 10:].std(0).mean()
    spread_b = b[:, 10:].std(0).mean()
    assert spread_a < 0.5 * spread_b, (spread_a, spread_b)
    with pytest.raises(ValueError, match="does not compose"):
        api.FSGLD(post, problem, method="fald", kernel="sghmc", **kw)
    with pytest.raises(NotImplementedError, match="Langevin"):
        teng.MeshChainEngine(gaussian_log_lik, TCfg(num_shards=S), problem,
                             6, aggregation="fald", dynamics="sghmc")
    with pytest.raises(ValueError, match="unknown aggregation"):
        teng.MeshChainEngine(gaussian_log_lik, TCfg(num_shards=S), problem,
                             6, aggregation="mean")
