"""The streamed client axis of the port (``repro_torch.fed`` stream
pieces, ``MeshChainEngine`` with ``stream=``) against the JAX package's,
on the problems of ``tests/test_stream.py`` made with numpy.

* Bitwise against the reference: ``plan_stream`` on the same (R, C) ids,
  ``resolve_shard_probs`` for every preset, the ``fed.hierarchy``
  reductions.
* PEAK-RESIDENT PROPERTY: for any schedule the plan's windows tile the
  run, hold at most ``resident`` clients each, and cover every client a
  chain holds; the replay (a clone of the run's generator through the
  engine's own ``draw_round``) equals the clients the run holds.
* BITWISE PARITY: streamed == resident on every executor and on the
  reference's variants (fald, sghmc, compressed, no_prefetch), on a lazy
  client source with an odd chain count, and the uniform preset ==
  probs=None.
* The device check: a plan that drifts from the run is caught in the
  round, never read silently.
* Refusals, each with the reference's words; the train CLI's flags.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.fed import hierarchy as jhier
from repro.fed import schedule as jsched
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.fed import (CommSchedule, Compression, Federation,
                             PartitionedSource, PartitionSpec, Stream,
                             SyntheticClientSource, hierarchical_mean,
                             hierarchical_sum, normalize_hierarchical,
                             partition, plan_stream, replay_sids,
                             resolve_shard_probs, shard_prob_preset_names)
from repro_torch.fed import hierarchy as thier
from repro_torch.launch import train as ttrain
from repro_torch.obs import trace as obs_trace
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

EXECUTORS = ("vmap", "per_leaf", "packed")
# the module (``repro.fed`` re-exports its ``partition`` function)
jpart = importlib.import_module("repro.fed.partition")


def _tlog_lik(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def _problem(seed=0, S=12, n=24, d=3):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(-4, 4, size=(S, d))
    x = torch.from_numpy(
        (mus[:, None, :] + rng.normal(size=(S, n, d))).astype(np.float32))
    mu_s, prec_s = torch.vmap(analytic_gaussian_likelihood_surrogate)(x)
    return {"x": x}, make_bank(mu_s, prec_s, "diag")


_FED = Federation(schedule=CommSchedule(delay=2, participation=0.6,
                                        straggler_prob=0.2))


def _facade(data, bank, executor, *, stream=None, method="fsgld",
            kernel="sgld", federation=_FED, collect=True, shard_probs=None,
            rounds=6):
    return api.FSGLD(
        api.Posterior(_tlog_lik, prior_precision=1.0), data, minibatch=8,
        step_size=1e-4, method=method, kernel=kernel,
        surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                   if method == "fsgld" else api.SurrogateSpec(kind="none")),
        schedule=api.Schedule(rounds=rounds, local_steps=3, n_chains=4,
                              reassign="permutation", thin=3),
        execution=api.Execution(device="cpu", executor=executor,
                                collect=collect, stream=stream),
        federation=federation, shard_probs=shard_probs)


def gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _bitwise(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# numpy pieces, bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C,S,window", [(10, 4, 16, 1), (10, 4, 16, 3),
                                          (7, 5, 9, 2), (4, 6, 8, 4)])
def test_plan_stream_is_the_reference_plan(R, C, S, window):
    ids = np.random.default_rng(R * C).integers(0, S, (R, C)).astype(
        np.int32)
    K = min(S, C * window)
    t = plan_stream(ids, resident=K, window=window)
    j = jsched.plan_stream(ids, resident=K, window=window)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.r0, a.length) == (b.r0, b.length)
        assert a.resident_ids.dtype == b.resident_ids.dtype == np.int32
        np.testing.assert_array_equal(a.resident_ids, b.resident_ids)


def test_plan_stream_names_minimum_viable_resident():
    ids = np.arange(24, dtype=np.int32).reshape(4, 6) % 8
    for mod in (jsched, None):
        fn = plan_stream if mod is None else mod.plan_stream
        with pytest.raises(ValueError, match=r"raise resident to at least 8"):
            fn(ids, resident=1, window=2)
    with pytest.raises(ValueError, match="window must be >= 1"):
        plan_stream(ids, resident=8, window=0)


@pytest.mark.parametrize("preset", ["uniform", "size-proportional",
                                    "sqrt-size"])
@pytest.mark.parametrize("S", [1, 7, 1000])
def test_presets_are_the_reference_presets(preset, S):
    sizes = np.random.default_rng(S).integers(1, 500, S)
    t = resolve_shard_probs(preset, sizes)
    j = jpart.resolve_shard_probs(preset, sizes)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    assert shard_prob_preset_names() == jpart.shard_prob_preset_names()
    np.testing.assert_array_equal(resolve_shard_probs([0.5, 0.5], sizes[:2]),
                                  np.float32([0.5, 0.5]))


def test_unknown_preset_has_did_you_mean_hint():
    sizes = np.full((4,), 10)
    with pytest.raises(KeyError, match=r"did you mean 'size-proportional'\?"):
        resolve_shard_probs("size-proportionl", sizes)
    with pytest.raises(KeyError, match="available"):
        resolve_shard_probs("not-a-preset", sizes)


@pytest.mark.parametrize("silo", [1, 7, 64, 10_000, thier.SILO])
def test_hierarchy_is_the_reference_hierarchy(silo):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 2.0, size=1000)
    w = rng.uniform(0.1, 1.0, size=1000)
    assert hierarchical_sum(x, silo) == jhier.hierarchical_sum(x, silo)
    assert hierarchical_mean(x, w, silo) == jhier.hierarchical_mean(x, w, silo)
    np.testing.assert_array_equal(normalize_hierarchical(x, silo),
                                  jhier.normalize_hierarchical(x, silo))
    assert list(thier.silo_slices(1000, silo)) == \
        list(jhier.silo_slices(1000, silo))
    assert np.isclose(hierarchical_sum(x, silo), float(np.sum(x)),
                      rtol=1e-12)


def test_hierarchy_rejects_degenerate_inputs():
    with pytest.raises(ValueError, match="zero"):
        hierarchical_mean([1.0, 2.0], [0.0, 0.0])
    with pytest.raises(ValueError, match="total"):
        normalize_hierarchical(np.zeros(4))
    with pytest.raises(ValueError, match="silo"):
        list(thier.silo_slices(10, 0))


# ---------------------------------------------------------------------------
# the plan: peak resident <= K for any schedule; the replay is the run
# ---------------------------------------------------------------------------

def _engine(S=16, executor="packed", method="dsgld"):
    data, bank = _problem(1, S=S, n=16)
    return _facade(data, bank, executor, method=method).engine


@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("participation,delay,straggler",
                         [(1.0, 1, 0.0), (0.6, 1, 0.0), (1.0, 3, 0.0),
                          (0.5, 2, 0.25), (0.8, 3, 0.1)])
def test_peak_resident_bounded_for_any_schedule(window, participation,
                                                delay, straggler):
    R, C, S = 10, 4, 16
    fed = Federation(schedule=CommSchedule(
        delay=delay, participation=participation, straggler_prob=straggler))
    fed = None if fed.engine_identity else fed
    sids = replay_sids(gen(3), _engine(S), num_rounds=R, n_chains=C,
                       federation=fed)
    K = min(C * window, S)
    wins = plan_stream(sids, resident=K, window=window)
    assert sum(w.length for w in wins) == R
    assert [w.r0 for w in wins] == list(range(0, R, window))
    for w in wins:
        ids = w.resident_ids
        assert ids.shape == (K,) and ids.dtype == np.int32
        assert np.all(np.diff(ids) >= 0)
        blk = sids[w.r0:w.r0 + w.length]
        assert np.isin(blk, ids).all()


@pytest.mark.parametrize("executor", ["per_leaf", "packed"])
@pytest.mark.parametrize("federation", [None, _FED, "topk-1%"])
def test_replay_equals_the_clients_the_run_holds(monkeypatch, executor,
                                                 federation):
    """The kernel executors call ``chain_scales`` once per round with the
    held (global) ids: those are what the replay predicts."""
    seen = []
    real = teng.chain_scales
    monkeypatch.setattr(teng, "chain_scales", lambda cfg, sc, sids, m: (
        seen.append(sids.clone()) or real(cfg, sc, sids, m)))
    data, bank = _problem(2)
    f = _facade(data, bank, executor, federation=federation)
    g = gen(21)
    before = g.get_state().clone()
    fed = None if federation is None else api.get_scenario(federation)
    held = replay_sids(g, f.engine, num_rounds=6, n_chains=4,
                       federation=fed, dim=3)
    assert torch.equal(g.get_state(), before)    # the replay used a clone
    f.sample(g, torch.zeros(3))
    np.testing.assert_array_equal(torch.stack(seen).numpy(), held)


def test_a_plan_that_drifts_is_caught_in_the_round(monkeypatch):
    """The engine asserts on the device that every held client is in its
    window: a replay off by one client never reads the wrong rows."""
    data, bank = _problem(3)
    real = teng.replay_sids
    monkeypatch.setattr(teng, "replay_sids",
                        lambda *a, **k: (real(*a, **k) + 1) % 12)
    f = _facade(data, bank, "packed", stream=Stream(resident=8, window=2))
    with pytest.raises(RuntimeError):
        f.sample(gen(), torch.zeros(3))


# ---------------------------------------------------------------------------
# bitwise parity: streamed == resident
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resident_runs():
    """The resident run of ``_problem(0)`` per executor, made once for
    every (resident, window) it is held against."""
    runs = {}

    def run(executor):
        if executor not in runs:
            data, bank = _problem(0)
            runs[executor] = _facade(data, bank, executor).sample(
                gen(), torch.zeros(3))
        return runs[executor]
    return run


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("resident,window", [(6, 2), (4, 1)])
def test_streamed_bitwise_parity_every_executor(executor, resident, window,
                                                resident_runs):
    data, bank = _problem(0)
    ref = resident_runs(executor)
    got = _facade(data, bank, executor,
                  stream=Stream(resident=resident, window=window)).sample(
        gen(), torch.zeros(3))
    _bitwise(ref, got)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("variant", ["fald", "sghmc", "compressed",
                                     "no_prefetch"])
def test_streamed_bitwise_parity_variants(executor, variant):
    data, bank = _problem(1)
    kw = {}
    if variant == "fald":
        kw = dict(method="fald")
    elif variant == "sghmc":
        kw = dict(kernel="sghmc")
    elif variant == "compressed":
        kw = dict(federation=Federation(
            schedule=CommSchedule(delay=2),
            compression=Compression(kind="topk", frac=0.5,
                                    direction="bidir")))
    stream = Stream(resident=6, window=2,
                    prefetch=variant != "no_prefetch")
    ref = _facade(data, bank, executor, **kw).sample(gen(9), torch.zeros(3))
    got = _facade(data, bank, executor, stream=stream, **kw).sample(
        gen(9), torch.zeros(3))
    _bitwise(ref, got)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_streamed_client_source_odd_chain_count(executor):
    """A lazy client source and 5 chains on 24 clients (block-cyclic):
    the streamed final states equal the materialise-all resident path."""
    src = SyntheticClientSource(5, num_clients=24, shard_size=8, seq_len=8,
                                vocab_size=32)
    built = []
    real_rows = src.rows
    src.rows = lambda ids: built.append(len(ids)) or real_rows(ids)

    def tok_ll(theta, batch):
        return torch.sum(torch.log_softmax(theta, -1)[batch["labels"]])

    def build(stream):
        return api.FSGLD(
            api.Posterior(tok_ll), src, minibatch=4, step_size=1e-3,
            method="dsgld", surrogate=api.SurrogateSpec(kind="none"),
            schedule=api.Schedule(rounds=5, local_steps=2, n_chains=5,
                                  reassign="permutation"),
            execution=api.Execution(device="cpu", executor=executor,
                                    collect=False, stream=stream))

    ref = build(None).sample(gen(2), torch.zeros(32))
    assert built == [24]
    built.clear()
    got = build(Stream(resident=10, window=2)).sample(gen(2),
                                                       torch.zeros(32))
    assert built == [10, 10, 10]   # one window of 10 clients at a time
    _bitwise(ref, got)


def test_uniform_preset_bitwise_matches_probs_none():
    sizes = np.full((12,), 24, np.int64)
    np.testing.assert_array_equal(
        resolve_shard_probs("uniform", sizes),
        ShardScheme(sizes=tuple(sizes), probs=None).probs_array())
    data, bank = _problem(3)
    a = _facade(data, bank, "vmap").sample(gen(4), torch.zeros(3))
    b = _facade(data, bank, "vmap", shard_probs="uniform").sample(
        gen(4), torch.zeros(3))
    _bitwise(a, b)
    c = _facade(data, bank, "packed", shard_probs="size-proportional",
                stream=Stream(resident=6, window=2)).sample(gen(4),
                                                            torch.zeros(3))
    d = _facade(data, bank, "packed", shard_probs="size-proportional").sample(
        gen(4), torch.zeros(3))
    _bitwise(c, d)


def test_stream_spans_events_and_hook(tmp_path):
    data, bank = _problem(0)
    path = str(tmp_path / "trace.jsonl")
    windows = []
    f = _facade(data, bank, "packed", stream=Stream(resident=6, window=2))
    f.engine.stream_hook = lambda i, w: windows.append((i, w.r0, w.length))
    obs_trace.configure(path)
    try:
        f.sample(gen(), torch.zeros(3))
    finally:
        obs_trace.configure()
    recs = obs_trace.read_jsonl(path)
    stage = [r for r in recs if r["name"] == "stream.stage"]
    disp = [r for r in recs if r["name"] == "stream.dispatch"]
    ov, = [r for r in recs if r["name"] == "stream.prefetch_overlap"]
    assert [r["window"] for r in stage] == [0, 1, 2]
    assert [(r["window"], r["r0"], r["rounds"]) for r in disp] == \
        [(0, 0, 2), (1, 2, 2), (2, 4, 2)]
    assert windows == [(0, 0, 2), (1, 2, 2), (2, 4, 2)]
    assert ov["windows"] == 3 and ov["prefetch"] is True
    assert 0.0 <= ov["overlap_frac"] <= 1.0


# ---------------------------------------------------------------------------
# client sources
# ---------------------------------------------------------------------------

def test_synthetic_source_is_a_pure_function_of_seed_and_client():
    src = SyntheticClientSource(3, num_clients=10**6, shard_size=4,
                                seq_len=6, vocab_size=50)
    a = src.rows([999_999, 7])
    b = src.rows([7])
    assert a["tokens"].shape == (2, 4, 6) and a["tokens"].dtype == np.int32
    np.testing.assert_array_equal(a["tokens"][1], b["tokens"][0])
    np.testing.assert_array_equal(a["labels"][1, :, :-1],
                                  a["tokens"][1, :, 1:])
    assert not np.array_equal(a["tokens"][0], a["tokens"][1])
    other = SyntheticClientSource(4, num_clients=10, shard_size=4,
                                  seq_len=6, vocab_size=50)
    assert not np.array_equal(other.rows([7])["tokens"], b["tokens"])
    assert src.sizes.shape == (10**6,) and src.max_size == 4
    with pytest.raises(IndexError):
        src.rows([10**6])


def test_partitioned_source_rows_equal_partition():
    rng = np.random.default_rng(0)
    pooled = {"x": rng.normal(size=(203, 3)).astype(np.float32),
              "y": rng.integers(0, 4, 203).astype(np.int64)}
    spec = PartitionSpec(kind="dirichlet", num_shards=5, alpha=0.3, seed=1)
    stacked, sizes = partition(None, pooled, spec)
    src = PartitionedSource(pooled, spec)
    assert tuple(src.sizes) == tuple(sizes)
    rows = src.rows(np.arange(5))
    for k in ("x", "y"):
        torch.testing.assert_close(rows[k], stacked[k], equal_nan=True,
                                   rtol=0, atol=0)
    torch.testing.assert_close(src.rows([3, 1])["x"], stacked["x"][[3, 1]],
                               equal_nan=True, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_streamed_refusals_are_actionable(tmp_path):
    eng = _engine(S=8, method="fsgld")

    def run(**kw):
        base = dict(n_chains=2, stream=Stream(resident=4),
                    reassign="permutation")
        return eng.run(gen(), torch.zeros(3), 2, **{**base, **kw})

    with pytest.raises(NotImplementedError, match="permutation"):
        run(reassign="categorical")
    with pytest.raises(ValueError, match="lower resident"):
        run(stream=Stream(resident=64))
    with pytest.raises(NotImplementedError, match="refresh_every"):
        run(refresh_every=1)
    with pytest.raises(NotImplementedError, match="snapshot"):
        run(snapshot_every=1, snapshot_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="recovery"):
        run(recovery=api.Recovery())
    with pytest.raises(NotImplementedError, match="telemetry"):
        run(telemetry=api.Telemetry())
    sgld = _facade(*_problem(1, S=8), "packed", method="sgld").engine
    with pytest.raises(NotImplementedError, match="method='sgld'"):
        sgld.run(gen(), torch.zeros(3), 2, n_chains=2,
                 stream=Stream(resident=4), reassign="permutation")
    with pytest.raises(ValueError, match="resident must be >= 1"):
        Stream(resident=0)


def test_facade_refuses_client_source_misuse():
    src = SyntheticClientSource(5, num_clients=6, shard_size=8, seq_len=8,
                                vocab_size=32)
    post = api.Posterior(lambda t, b: torch.sum(t))
    with pytest.raises(ValueError, match="PartitionedSource"):
        api.FSGLD(post, src, minibatch=4, method="dsgld",
                  surrogate=api.SurrogateSpec(kind="none"),
                  federation=Federation(partition=PartitionSpec(
                      num_shards=3)),
                  execution=api.Execution(device="cpu"))
    with pytest.raises(ValueError, match="carries its own sizes"):
        api.FSGLD(post, src, minibatch=4, method="dsgld",
                  surrogate=api.SurrogateSpec(kind="none"), sizes=(8,) * 6,
                  execution=api.Execution(device="cpu"))
    with pytest.raises(ValueError, match="prefit bank"):
        api.FSGLD(post, src, minibatch=4,
                  surrogate=api.SurrogateSpec(kind="diag"),
                  execution=api.Execution(device="cpu")).fit(
            gen(), torch.zeros(32))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--smoke", "--rounds", "3", "--local-updates",
         "2", "--fit-steps", "2", "--shard-size", "4", "--batch", "2",
         "--seq", "16", "--step-size", "1e-7"]


def test_train_cli_streams_lazy_clients(capsys):
    assert ttrain.main(SMALL + ["--method", "dsgld", "--clients", "24",
                                "--resident", "4"]) == 0
    out = capsys.readouterr().out
    assert "shards=24" in out and "resident=4" in out
    ll = [float(ln.split("ll/token=")[1]) for ln in out.splitlines()
          if ln.startswith("chain ")]
    assert len(ll) == 1 and np.isfinite(ll[0])


def test_train_cli_resident_is_bitwise_the_resident_run():
    base = SMALL + ["--num-shards", "8", "--chains", "2"]
    a = ttrain.run(ttrain.parse_args(base))
    b = ttrain.run(ttrain.parse_args(base + ["--resident", "2"]))
    _bitwise(a.finals, b.finals)
    assert a.lls == b.lls


@pytest.mark.parametrize("flag,match", [
    (["--resident", "9"], r"did you mean --num-shards 9\?"),
    (["--clients", "6", "--resident", "9", "--method", "dsgld"],
     r"did you mean --clients 9\?"),
    (["--resident", "2", "--snapshot-every", "1", "--snapshot-dir", "s"],
     "drop --resident to snapshot"),
    (["--clients", "6"], "needs materialized shard data"),
    (["--metrics-dir", "m", "--draw-bank", "d"], "pick one"),
    (["--metrics-dir", "m", "--resident", "2"], "do not compose with "
     "--resident"),
    (["--log-every", "1", "--snapshot-every", "1", "--snapshot-dir", "s"],
     "pick ONE segmentation driver")])
def test_train_cli_refuses_the_reference_combinations(flag, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.parse_args(SMALL + ["--num-shards", "4"] + flag)


def test_train_cli_metrics_dir_writes_the_reference_files(tmp_path):
    from repro import obs as jobs
    d = str(tmp_path / "m")
    tr = ttrain.run(ttrain.parse_args(SMALL + ["--num-shards", "2",
                                               "--metrics-dir", d,
                                               "--log-every", "1"]))
    frame = jobs.read_metrics_jsonl(f"{d}/metrics.jsonl")
    assert (frame.rounds, frame.n_chains, len(frame.names)) == (3, 1, 9)
    for n in frame.names:
        np.testing.assert_array_equal(frame.metrics[n], tr.frame.metrics[n])
    prom = jobs.parse_prometheus(f"{d}/metrics.prom")
    assert prom["fsgld_rounds_total"] == 3.0
    names = {r["name"] for r in obs_trace.read_jsonl(f"{d}/trace.jsonl")}
    assert {"engine.segment", "engine.progress"} <= names
    assert not obs_trace.enabled()        # the tracer is reset after


def test_a_window_reads_a_whole_host_stack_by_its_ids():
    """A bank stack that stays on the host rides a window whole, as
    (stack, resident ids): row s of the window is row ids[s] of the
    stack, the bytes a resident gather reads."""
    stack = torch.randn(10, 3, 128, generator=gen(1)).to(torch.bfloat16)
    ids = torch.tensor([1, 4, 7, 9])
    rows = torch.tensor([3, 0, 2])
    got = teng._gather((stack, ids), rows, "cpu")
    assert torch.equal(got, teng._gather(stack, ids[rows], "cpu"))
    assert torch.equal(got.view(3, 3, 128),
                       stack[[9, 1, 7]].to(torch.float32))
