"""The port's federation scenarios (``repro_torch.fed`` and the engine's
federated rounds) against the JAX package's.

* Pieces, one by one: the schedule masks and the compressors are BITWISE
  equal to the JAX package's on the same uniforms (``jax.random.uniform``
  of the key the JAX function takes: ``bernoulli(key, p, shape)`` is
  ``uniform(key, shape) < p``); top-k needs none. The flattener round
  trip with a bf16 leaf, ``bytes_per_round`` of every registry scenario,
  the scenario names and their order, the partitions' invariants.
* Rounds, step by step: the engine's packed executor on injected draws
  against a JAX loop built from ``repro.fed.schedule`` and
  ``make_compressor`` (``_fed_jax_loop.py``), within 1e-5: the float32
  gradients differ in summation order and the hashed normals by <= 1e-6.
* Whole runs: the identity scenario is bitwise the run without one;
  packed == per_leaf bitwise under every engine-side scenario; the
  facade partitions pooled data and refuses a re-partition.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _fed_jax_loop as L
from repro.fed import SCENARIOS as JSCENARIOS
from repro.fed import schedule as jsched
from repro.fed.compress import Compression as JCompression
from repro.fed.compress import make_compressor as jmake_compressor
from repro.fed.compress import make_flattener as jmake_flattener
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.core.surrogate import make_bank
from repro_torch.fed import (SCENARIOS, CommSchedule, Compression,
                             Federation, PartitionSpec, get_scenario,
                             make_compressor, make_flattener, partition,
                             scenario_names)
from repro_torch.fed import schedule as fsched
from repro_torch.workloads import mlp_log_lik, mlp_problem
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

CPU = api.Execution(device="cpu")
ENGINE_SCENARIOS = [n for n in scenario_names()
                    if SCENARIOS[n].partition is None]


def _unif(key, *shape):
    return np.array(jax.random.uniform(key, shape))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 3])
@pytest.mark.parametrize("p", [0.5, 0.1, 1.0])
def test_participation_mask_bitwise_on_shared_uniforms(p, r):
    sched = jsched.CommSchedule(participation=p)
    key = jax.random.PRNGKey(int(100 * p) + r)
    want = np.asarray(jsched.participation_mask(sched, key, r, 64))
    got = fsched.participation_mask(CommSchedule(participation=p),
                                    torch.from_numpy(_unif(key, 64)), r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and (p == 1.0 or (r == 0) == bool(want.all()))


@pytest.mark.parametrize("q", [0.1, 0.5])
def test_straggler_and_comm_masks_bitwise(q):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsched.straggler_mask(
        jsched.CommSchedule(straggler_prob=q), key, 64))
    got = fsched.straggler_mask(CommSchedule(straggler_prob=q),
                                torch.from_numpy(_unif(key, 64)))
    np.testing.assert_array_equal(got.numpy(), want)
    for delay in (1, 5, 100):
        js, ts = jsched.CommSchedule(delay=delay), CommSchedule(delay=delay)
        assert [bool(jsched.comm_mask(js, r)) for r in range(12)] == \
            [fsched.comm_mask(ts, r) for r in range(12)]


@pytest.mark.parametrize("kw", [dict(kind="topk", frac=0.01),
                                dict(kind="topk", frac=0.3),
                                dict(kind="randk", frac=0.1),
                                dict(kind="qsgd", bits=8),
                                dict(kind="qsgd", bits=2),
                                dict(kind="none")])
def test_compressors_bitwise_on_shared_uniforms(kw):
    """The payloads are bitwise the JAX package's; the rows include an
    all-zero chain (qsgd's scale 0, top-k's all-tied threshold) and
    exact ties."""
    rng = np.random.default_rng(0)
    P = 500
    upd = rng.standard_normal((4, P)).astype(np.float32)
    upd[1] = 0.0
    upd[2, :50] = 3.0
    key = jax.random.PRNGKey(3)
    want = np.asarray(jmake_compressor(JCompression(**kw), P)(
        jnp.asarray(upd), key))
    got = make_compressor(Compression(**kw), P)(
        torch.from_numpy(upd), torch.from_numpy(_unif(key, 4, P)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flattener_roundtrip_with_a_bf16_leaf():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 5, 2)).astype(np.float32),
            "b": rng.standard_normal((3, 7)).astype(np.float32)}
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": torch.from_numpy(tree["b"]).to(torch.bfloat16)}
    jt = {"a": jnp.asarray(tree["a"]),
          "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16)}
    flatten, unflatten, dim = make_flattener(tt)
    jflat, _, jdim = jmake_flattener(jt)
    flat = flatten(tt)
    assert dim == jdim == 17 and flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat(jt)))
    back = unflatten(flat)
    assert back["b"].dtype == torch.bfloat16
    for k in tt:
        assert torch.equal(back[k], tt[k])


@pytest.mark.parametrize("name", scenario_names())
def test_registry_scenarios_match_jax(name):
    """Every registry scenario: the same spec field by field and the same
    wire bytes per round at three widths."""
    ours, theirs = SCENARIOS[name], JSCENARIOS[name]
    for part in ("schedule", "compression", "partition"):
        a, b = getattr(ours, part), getattr(theirs, part)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.identity == theirs.identity
    assert ours.engine_identity == theirs.engine_identity
    for dim in (2, 854, 24_864):
        assert ours.compression.bytes_per_round(dim) == \
            theirs.compression.bytes_per_round(dim)


def test_registry_names_order_and_lookup():
    assert scenario_names() == tuple(JSCENARIOS)
    assert len(scenario_names()) == 18
    spec = Federation(schedule=CommSchedule(delay=3))
    assert get_scenario(spec) is spec
    with pytest.raises(KeyError, match="did you mean 'delayed-5x'"):
        get_scenario("delayed-5")
    with pytest.raises(ValueError):
        CommSchedule(participation=0.0)
    with pytest.raises(ValueError):
        Compression(kind="zip")


def _pooled(N=400, d=4, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, N)
    x = (rng.standard_normal((N, d)) + 2.0 * y[:, None]).astype(np.float32)
    # a unique id per row: every live row is traceable
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
            "id": torch.arange(N, dtype=torch.float32)}


@pytest.mark.parametrize("kind", ["iid", "dirichlet", "quantity",
                                  "covariate"])
def test_partition_uses_every_row_once_and_pads_with_nan(kind):
    data = _pooled()
    spec = PartitionSpec(kind=kind, num_shards=4, alpha=0.3)
    shards, sizes = partition(np.random.default_rng(1), data, spec)
    assert len(sizes) == 4 and min(sizes) >= spec.min_size
    ids = np.concatenate([shards["id"][s, :n].numpy()
                          for s, n in enumerate(sizes)])
    assert len(np.unique(ids)) == len(ids) and set(ids) <= set(range(400))
    if kind == "dirichlet":
        assert len(ids) == 400
    for s, n in enumerate(sizes):
        assert torch.isnan(shards["x"][s, n:]).all()
        assert torch.equal(shards["x"][s, :n],
                           data["x"][shards["id"][s, :n].long()])
    again, sizes2 = partition(np.random.default_rng(1), data, spec)
    assert sizes2 == sizes and torch.equal(again["y"], shards["y"])


def test_partition_skews():
    data = _pooled(N=800, seed=2)

    def max_frac(spec):
        shards, sizes = partition(np.random.default_rng(3), data, spec)
        fr = []
        for s, n in enumerate(sizes):
            _, cnt = np.unique(shards["y"][s, :n].numpy(),
                               return_counts=True)
            fr.append(cnt.max() / n)
        return np.mean(fr)

    low = max_frac(PartitionSpec(kind="dirichlet", num_shards=4,
                                 alpha=0.05))
    high = max_frac(PartitionSpec(kind="dirichlet", num_shards=4,
                                  alpha=100.0))
    assert low > high + 0.15
    _, q = partition(np.random.default_rng(5), data,
                     PartitionSpec(kind="quantity", num_shards=4, alpha=0.3))
    assert max(q) > 2 * min(q)
    _, i = partition(np.random.default_rng(5), data,
                     PartitionSpec(kind="iid", num_shards=4))
    assert len(set(i)) == 1
    shards, sizes = partition(np.random.default_rng(7), data,
                              PartitionSpec(kind="covariate", num_shards=4))
    means = [float(shards["x"][s, :n].mean())
             for s, n in enumerate(sizes)]
    assert means in (sorted(means), sorted(means, reverse=True))


# ---------------------------------------------------------------------------
# rounds, step by step, against the JAX loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["delayed-5x", "partial-50%",
                                      "straggler-10%", "topk-1%",
                                      "qsgd-8bit", "elf-bidir-randk-10%"])
def test_federated_rounds_match_jax_loop(scenario, monkeypatch):
    """Six rounds of C = 4 chains, T = 2 steps, FSGLD with a diag bank on
    ragged clients: the port's packed engine on injected draws against
    the JAX loop on the same values, within 1e-5."""
    data, means, precs, theta0 = L.problem()
    draws = L.make_draws(6, scenario)
    want = L.jax_loop(data, means, precs, theta0, draws, scenario)
    monkeypatch.setattr(teng, "draw_round", L.injected(draws))
    eng = teng.MeshChainEngine(
        L.torch_log_lik, TCfg(**L.cfg_kw("fsgld")),
        {"x": torch.from_numpy(data["x"])}, L.M,
        bank=make_bank(torch.from_numpy(means), torch.from_numpy(precs),
                       "diag"),
        use_kernel=True, sizes=L.SIZES, packed=True)
    got = eng.run(torch.Generator(), torch.from_numpy(theta0), 6,
                  n_chains=L.C, federation=scenario).numpy()
    assert got.shape == want.shape == (L.C, 12, L.D)
    assert np.isfinite(want).all() and np.abs(want - theta0).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_delayed_rounds_hold_clients_and_draw_only_what_they_use():
    """Between communication rounds a chain keeps its client and its rows
    stay in that client's live prefix; compression uniforms are drawn on
    communication rounds only; without a federation the first draws are
    the old contract's."""
    cfg = TCfg(method="fsgld", num_shards=3, local_updates=2)
    scheme = ShardScheme((7, 30, 12), cfg.probs())
    fed = Federation(schedule=CommSchedule(delay=3, participation=0.5),
                     compression=Compression(kind="randk", frac=0.5,
                                             direction="bidir"))
    g = torch.Generator().manual_seed(0)
    held = torch.zeros(6, dtype=torch.int64)
    for r in range(7):
        d = teng.draw_round(g, cfg, scheme, n_chains=6, minibatch=5,
                            num_leaves=1, federation=fed, r=r, held=held,
                            dim=11)
        exch = teng.exchanging(fed.schedule, r, d.part_u, held)
        assert exch.all() if r == 0 else (r % 3 == 0 or not exch.any())
        held = torch.where(exch, d.sids, held)
        bound = torch.tensor(scheme.sizes)[held]
        assert (d.idx < bound[None, :, None]).all()
        comm = r % 3 == 0
        assert (d.primal_u is not None) == comm == (d.dual_u is not None)
        assert d.part_u.shape == (6,) and d.strag_u is None
    a = teng.draw_round(torch.Generator().manual_seed(4), cfg, scheme,
                        n_chains=6, minibatch=5, num_leaves=1)
    b = teng.draw_round(torch.Generator().manual_seed(4), cfg, scheme,
                        n_chains=6, minibatch=5, num_leaves=1,
                        federation=fed, r=0, held=held, dim=11)
    for f in ("sids", "idx", "seeds"):
        assert torch.equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# whole runs through the facade
# ---------------------------------------------------------------------------

def _mlp(executor, federation=None, n_chains=5, **kw):
    g = torch.Generator().manual_seed(3)
    data, bank, theta0 = mlp_problem(g, S=3, n=40, din=5, hid=7, dout=2)
    s = api.FSGLD(
        api.Posterior(mlp_log_lik, prior_precision=1.0), data, minibatch=8,
        step_size=1e-3, surrogate=api.SurrogateSpec(kind="scalar",
                                                     bank=bank),
        schedule=api.Schedule(rounds=6, local_steps=2, n_chains=n_chains),
        execution=api.Execution(device="cpu", executor=executor),
        federation=federation, **kw)
    return s, theta0


@pytest.mark.parametrize("executor", ["packed", "per_leaf", "vmap"])
def test_identity_scenario_is_bitwise_the_run_without_one(executor):
    out = []
    for fed in (None, "identity", Federation(partition=None)):
        s, theta0 = _mlp(executor, fed)
        out.append(s.sample(torch.Generator().manual_seed(5), theta0))
    for tr in out[1:]:
        for a, b in zip(tu.leaves(out[0]), tu.leaves(tr)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("scenario", ENGINE_SCENARIOS)
def test_packed_equals_per_leaf_bitwise_under_every_scenario(scenario):
    out = {}
    for ex in ("packed", "per_leaf"):
        s, theta0 = _mlp(ex)
        out[ex] = s.sample(torch.Generator().manual_seed(8), theta0,
                           federation=scenario)
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert a.shape[:2] == (5, 12) and torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_straggling_chains_freeze_state_and_trace():
    """Every collected step of a straggling chain's round repeats its
    pre-round position; the others move."""
    s, theta0 = _mlp("packed", Federation(
        schedule=CommSchedule(straggler_prob=0.5)), n_chains=8)
    tr = s.sample(torch.Generator().manual_seed(2), theta0)["w1"]
    per_round = tr.reshape(8, 6, 2, -1)
    frozen = (per_round[:, :, 0] == per_round[:, :, 1]).all(-1)
    assert frozen.any() and not frozen.all()
    # a frozen round repeats the end of the round before it
    c, r = [int(v) for v in torch.nonzero(frozen[:, 1:])[0]]
    assert torch.equal(per_round[c, r + 1, 0], per_round[c, r, 1])


def test_facade_partitions_pooled_data_and_refuses_repartition():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 2, generator=g)
    post = api.Posterior(lambda t, b: -0.5 * torch.sum((b["x"] - t) ** 2))
    fed = Federation(partition=PartitionSpec(kind="quantity", num_shards=5,
                                             alpha=0.5),
                     schedule=CommSchedule(delay=2))
    s = api.FSGLD(post, {"x": x}, minibatch=2, method="dsgld",
                  schedule=api.Schedule(rounds=3, local_steps=2,
                                        n_chains=3),
                  execution=CPU, federation=fed)
    assert s.cfg.num_shards == 5 and len(s.sizes) == 5
    assert s.data["x"].shape == (5, max(s.sizes), 2)
    tr = s.sample(torch.Generator().manual_seed(1), torch.zeros(2))
    assert tr.shape == (3, 6, 2) and torch.isfinite(tr).all()
    assert torch.isfinite(s.sample(torch.Generator().manual_seed(1),
                                   torch.zeros(2),
                                   federation="topk-1%")).all()
    with pytest.raises(ValueError, match="re-partition"):
        s.sample(torch.Generator(), torch.zeros(2), federation="iid")
