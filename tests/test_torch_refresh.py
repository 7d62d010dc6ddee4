"""Adaptive surrogate refresh (``refresh_every``) in the port.

The reference re-fits its 'diag' bank at the chain mean every
``refresh_every`` rounds, on the host loop (``run_vmap``) and between the
engine's segments. Held here:

* the engine with ``refresh_every`` equals ``FederatedSampler.run_vmap``
  bitwise on every executor (vmap against the plain oracle, packed and
  per_leaf against its kernel path), and differs from the run without
  refresh; a refresh draws nothing, so the run's generator ends where
  the run without refresh leaves it;
* the port's ``refresh_bank`` against the reference's, and a packed run
  with injected draws, step by step, against a JAX loop built from the
  reference's ``refresh_bank``, ``pack_bank`` and ``packed_step``
  (interpret mode), to 1e-5 of the largest state;
* the bound of the reference's ``test_adaptive_refresh_run`` (posterior
  mean MSE < 1e-3 over 100 rounds x 100 steps, refreshing every 25),
  through the port's facade: that reference test itself fails on this
  toolchain (ROADMAP queue 3), so the port is not held against it;
* the refresh's ``engine.refresh`` trace span and ``MeshChainEngine
  .refresh``;
* each of the reference's refusals, by its words.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JCfg
from repro.core import engine as jeng
from repro.core import federated as jfed
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.core import federated as tfed
from repro_torch.core import surrogate as tsur
from repro_torch.fed import Federation, Stream
from repro_torch.fed.schedule import CommSchedule
from repro_torch.obs import trace as obs_trace
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

S, N, D, C, T, M, H = 3, 24, 5, 3, 3, 4, 1e-3
PROBS = (0.5, 0.2, 0.3)


def jax_ll(theta, batch):
    return -0.5 * jnp.sum((batch["x"] - theta) ** 2)


def torch_ll(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def _problem(seed=6):
    """A Gaussian mean on three equal clients, the analytic 'diag' bank
    (numpy)."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-2, 2, (S, 1, D)) + rng.standard_normal((S, N, D))
         ).astype(np.float32)
    means = x.mean(1)
    precs = np.full((S, D), float(N), np.float32)
    theta0 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, means, precs, theta0


def _cfg(**kw):
    return TCfg(**dict(dict(method="fsgld", step_size=H, num_shards=S,
                            local_updates=T, prior_precision=1.0,
                            shard_probs=PROBS), **kw))


def _torch(x, means, precs):
    return ({"x": torch.from_numpy(x)},
            tsur.make_bank(torch.from_numpy(means), torch.from_numpy(precs),
                           "diag"))


def _engine(executor, **kw):
    x, means, precs, theta0 = _problem()
    data, bank = _torch(x, means, precs)
    eng = teng.MeshChainEngine(
        torch_ll, _cfg(), data, M, bank=bank,
        use_kernel=executor != "vmap",
        packed={"packed": True, "per_leaf": False}.get(executor), **kw)
    return eng, torch.from_numpy(theta0)


@pytest.mark.parametrize("executor", ["vmap", "per_leaf", "packed"])
def test_engine_refresh_equals_run_vmap_bitwise(executor):
    """5 rounds, a refresh every 2, 3 chains, categorical reassignment:
    the engine's trace is the oracle's bitwise, not the run without
    refresh's, and the two runs leave their generators in one state."""
    eng, theta0 = _engine(executor)
    oracle = tfed.FederatedSampler(torch_ll, eng.cfg, eng.shard_data, M,
                                   bank=eng.bank,
                                   use_kernel=executor != "vmap")
    gens = [torch.Generator().manual_seed(4) for _ in range(3)]
    got = eng.run(gens[0], theta0, 5, n_chains=C, refresh_every=2)
    want = oracle.run_vmap(gens[1], theta0, 5, n_chains=C, refresh_every=2)
    plain = eng.run(gens[2], theta0, 5, n_chains=C)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :2 * T], plain[:, :2 * T])
    assert not torch.equal(got[:, 2 * T:], plain[:, 2 * T:])
    assert torch.equal(gens[0].get_state(), gens[2].get_state())
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # the oracle's own bank is back in place after the call
    again = oracle.run_vmap(torch.Generator().manual_seed(4), theta0, 5,
                            n_chains=C, refresh_every=2)
    assert torch.equal(again, want)


def test_refresh_bank_matches_the_reference():
    """The re-fitted means and precisions at a point away from the local
    modes, and the product-Gaussian global, within 1e-5 relative."""
    x, _, _, _ = _problem()
    theta = np.array([0.7, -1.3, 0.2, 0.0, 2.0], np.float32)
    jb = jfed.refresh_bank(jax_ll, {"x": jnp.asarray(x)}, jnp.asarray(theta),
                           batch=10)
    tb = tfed.refresh_bank(torch_ll, {"x": torch.from_numpy(x)},
                           torch.from_numpy(theta), batch=10)
    for a, b in ((tb.means, jb.means), (tb.precs, jb.precs),
                 (tb.global_.mean, jb.global_.mean),
                 (tb.global_.prec, jb.global_.prec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=0)


def _draws(rounds, seed=1):
    """Numpy-made client ids, rows and seeds per round, as the port's
    RoundDraws and as the JAX loop's arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        sids = rng.integers(0, S, C)
        idx = rng.integers(0, N, (T, C, M))
        seeds = rng.integers(0, 2**31 - 1, (T, C, 1))
        out.append(((sids, idx, seeds), teng.RoundDraws(
            sids=torch.from_numpy(sids), idx=torch.from_numpy(idx),
            seeds=torch.from_numpy(seeds).to(torch.int32))))
    return out


def _jax_refresh_loop(x, means, precs, theta0, draws, every):
    """The reference's pieces, one device: a packed kernel step per local
    step (interpret mode) on the packed 'diag' bank, and at every round
    r > 0 with r % every == 0 the bank re-fitted at the chain mean by the
    reference's ``refresh_bank``. Returns the (C, rounds * T, D) trace."""
    cfg = JCfg(method="fsgld", step_size=H, num_shards=S, local_updates=T,
               prior_precision=1.0, shard_probs=PROBS)
    scheme = jsam.ShardScheme((N,) * S, PROBS)
    layout = jops.make_packed_layout(jnp.asarray(theta0))
    data = {"x": jnp.asarray(x)}
    gv = jax.vmap(jax.grad(jax_ll))
    bank = jsur.make_bank(jnp.asarray(means), jnp.asarray(precs), "diag")

    @jax.jit
    def step(thetas, sids, idx_t, seeds_t, pb):
        scale, f_s = jsam.chain_scales(cfg, scheme, sids, M)
        scalars = jops.packed_scalar_rows(
            layout, h=H, scale=scale, f_s=f_s, prior_prec=1.0, alpha=1.0,
            temperature=1.0)
        batch = {"x": data["x"][sids[:, None], idx_t]}
        th_p = jops.packed_step(
            layout, layout.pack(thetas), layout.pack(gv(thetas, batch)),
            seeds_t, scalars, interpret=True, variant="diag",
            mu_g=pb["mu_g"], lam_g=pb["lam_g"],
            mu_s=pb["means"][sids].reshape(-1, 128),
            lam_s=pb["precs"][sids].reshape(-1, 128))
        return layout.unpack(th_p)

    thetas = jnp.broadcast_to(jnp.asarray(theta0), (C, D))
    trace = []
    for r, ((sids, idx, seeds), _) in enumerate(draws):
        if r > 0 and r % every == 0:
            bank = jfed.refresh_bank(jax_ll, data, thetas.mean(0))
        pb = jeng.pack_bank(layout, bank)
        for t in range(T):
            thetas = step(thetas, jnp.asarray(sids, jnp.int32),
                          jnp.asarray(idx[t]),
                          jnp.asarray(seeds[t], jnp.uint32), pb)
            trace.append(np.asarray(thetas))
    return np.stack(trace, 1)


@pytest.mark.parametrize("executor", ["packed", "per_leaf"])
def test_refresh_run_matches_the_jax_loop(executor, monkeypatch):
    """4 rounds, a refresh every 2, injected draws: every step of the
    port's run and of the oracle's ``run_vmap`` (its kernel path) within
    1e-5 of the largest state of the JAX loop's."""
    x, means, precs, theta0 = _problem()
    draws = _draws(4)
    want = _jax_refresh_loop(x, means, precs, theta0, draws, 2)
    for mod in (teng, tfed):
        it = iter(draws)
        monkeypatch.setattr(mod, "draw_round", lambda *a, it=it, **k:
                            next(it)[1])
    eng, th0 = _engine(executor)
    got = eng.run(torch.Generator(), th0, 4, n_chains=C, refresh_every=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    it = iter(draws)
    monkeypatch.setattr(tfed, "draw_round", lambda *a, **k: next(it)[1])
    oracle = tfed.FederatedSampler(torch_ll, eng.cfg, eng.shard_data, M,
                                   bank=eng.bank, use_kernel=True)
    assert torch.equal(oracle.run_vmap(torch.Generator(), th0, 4,
                                       n_chains=C, refresh_every=2), got)


def test_adaptive_refresh_run_mse():
    """The reference's ``test_adaptive_refresh_run`` bound through the
    port's facade: 10 clients of 200 points N(mu_s, I) in 2 dimensions
    (mu_s uniform in [-6, 6], numpy-made), the analytic bank, h 1e-4, 100
    rounds x 100 steps of one chain thinned by 10, a refresh every 25
    rounds; the second half's mean within MSE 1e-3 of the exact
    posterior mean."""
    rng = np.random.default_rng(0)
    Sx, n, d = 10, 200, 2
    mus = rng.uniform(-6, 6, (Sx, d))
    x = torch.from_numpy((mus[:, None] + rng.standard_normal((Sx, n, d))
                          ).astype(np.float32))
    mu_s, prec_s = torch.vmap(tsur.analytic_gaussian_likelihood_surrogate)(x)
    bank = tsur.make_bank(mu_s, prec_s, "diag")
    post_mean = x.reshape(-1, d).sum(0) / (1 + Sx * n)
    samp = api.FSGLD(
        api.Posterior(torch_ll, prior_precision=1.0), {"x": x},
        minibatch=10, step_size=1e-4,
        surrogate=api.SurrogateSpec(kind="diag", bank=bank,
                                    refresh_every=25),
        schedule=api.Schedule(rounds=100, local_steps=100, n_chains=1,
                              thin=10),
        execution=api.Execution(device="cpu"))
    tr = samp.sample(torch.Generator().manual_seed(2), torch.zeros(d))[0]
    assert torch.isfinite(tr).all()
    tr = tr[tr.shape[0] // 2:]
    mse = float(((tr.mean(0) - post_mean) ** 2).sum())
    assert mse < 1e-3, mse


def test_refresh_emits_its_span_and_refits_at_the_chain_mean(tmp_path):
    """Rounds 2 and 4 of 5 refresh (an ``engine.refresh`` span each, with
    its round), and ``engine.refresh(theta)`` is ``refresh_bank`` at
    theta."""
    eng, theta0 = _engine("packed")
    path = tmp_path / "trace.jsonl"
    obs_trace.configure(str(path))
    try:
        eng.run(torch.Generator().manual_seed(1), theta0, 5, n_chains=C,
                refresh_every=2)
    finally:
        obs_trace.configure()
    spans = [e for e in obs_trace.read_jsonl(str(path))
             if e.get("name") == "engine.refresh"]
    assert [e["round"] for e in spans] == [2, 4]
    theta = torch.tensor([0.3, -0.2, 0.1, 0.0, 1.0])
    a = eng.refresh(theta)
    b = tfed.refresh_bank(torch_ll, eng.shard_data, theta)
    for u, v in zip(tu.leaves((a.means, a.precs)), tu.leaves((b.means,
                                                              b.precs))):
        assert torch.equal(u, v)


def _refused(eng, theta0, match, **kw):
    with pytest.raises(NotImplementedError, match=match):
        eng.run(torch.Generator(), theta0, 3, n_chains=2, refresh_every=2,
                **kw)


def test_refresh_refusals_keep_the_reference_words(tmp_path):
    eng, theta0 = _engine("packed")
    _refused(eng, theta0, "non-identity communication schedule",
             federation=Federation(schedule=CommSchedule(delay=2)))
    _refused(eng, theta0, "snapshots do not compose with adaptive refresh",
             snapshot_every=1, snapshot_path=str(tmp_path))
    _refused(eng, theta0, "Telemetry.log_every does not compose",
             telemetry=api.Telemetry(log_every=1))
    _refused(eng, theta0, "stream= does not compose with refresh_every",
             reassign="permutation", stream=Stream(resident=2))
    hmc = dataclasses.replace(eng, dynamics="sghmc", sghmc=None)
    hmc.__post_init__()
    _refused(hmc, theta0, "not wired for sghmc")
    # no bank to re-fit (a 'scalar' bank: tests/test_torch_engine.py)
    _refused(dataclasses.replace(eng, bank=None), theta0,
             "flat-parameter 'diag' banks only")
