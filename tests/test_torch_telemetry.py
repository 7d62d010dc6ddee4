"""The engine's per-round telemetry (``Execution.telemetry``) against the
JAX package's formulas, on the problems of ``tests/test_telemetry.py``
made with numpy.

* Bitwise non-interference: a telemetry-on run returns the SAME samples
  as a telemetry-off run on every executor, under a federation, under
  recovery and with ``log_every`` segments (the probe draws from a
  generator of its own).
* Each row against the reference's formula on the port's states:
  ``noise_scale`` the closed forms, ``conducive_norm`` within 1e-5
  relative of ``repro.core.conducive_gradient_from_bank``,
  ``bytes_per_round`` / ``participation`` the reference's
  ``Compression.bytes_per_round`` and comm schedule, ``grad_norm`` /
  ``log_post`` within 1e-5 relative of ``jax.value_and_grad`` of the
  reference's log-likelihood on the same probe batch.
* One update per step with telemetry on; the return contracts; the
  refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_bank as jmake_bank
from repro.core.conducive import conducive_gradient_from_bank as jconducive
from repro.fed import SCENARIOS as JSCENARIOS
from repro.fed.schedule import comm_mask as jcomm_mask
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.core import engine as teng
from repro_torch.core.engine import draw_round, probe_generator
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.fed import replay_sids
from repro_torch.obs import TELEMETRY_PROBE_SALT, MetricsFrame, Telemetry
from repro_torch.obs import trace as obs_trace
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

EXECUTORS = ("vmap", "per_leaf", "packed")


def _tlog_lik(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def _jlog_lik(theta, batch):
    return -0.5 * jnp.sum((batch["x"] - theta) ** 2)


def _problem(seed=0, S=5, n=40, d=3):
    """tests/test_telemetry.py's Gaussian clients, made with numpy, and
    their exact diag surrogates."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(-4, 4, size=(S, d))
    x = (mus[:, None, :] + rng.normal(size=(S, n, d))).astype(np.float32)
    xt = torch.from_numpy(x)
    mu_s, prec_s = torch.vmap(analytic_gaussian_likelihood_surrogate)(xt)
    return {"x": xt}, make_bank(mu_s, prec_s, "diag")


def _facade(data, bank, *, executor="vmap", method="fsgld", kernel="sgld",
            telemetry=None, recovery=None, collect=True, rounds=4, local=5,
            n_chains=4, minibatch=8, step=1e-4, thin=1, federation=None):
    return api.FSGLD(
        api.Posterior(_tlog_lik, prior_precision=1.0), data,
        minibatch=minibatch, step_size=step, method=method, kernel=kernel,
        surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                   if method == "fsgld" else api.SurrogateSpec(kind="none")),
        schedule=api.Schedule(rounds=rounds, local_steps=local,
                              n_chains=n_chains, reassign="permutation",
                              thin=thin),
        execution=api.Execution(device="cpu", executor=executor,
                                collect=collect, recovery=recovery,
                                telemetry=telemetry),
        federation=federation)


def gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _bitwise(a, b):
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# bitwise non-interference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("probe", [True, False])
def test_telemetry_on_is_bitwise_off(executor, probe):
    data, bank = _problem()
    ref = _facade(data, bank, executor=executor).sample(gen(), torch.zeros(3))
    got, frame = _facade(data, bank, executor=executor,
                         telemetry=Telemetry(probe=probe)).sample(
        gen(), torch.zeros(3))
    _bitwise(ref, got)
    assert isinstance(frame, MetricsFrame)
    assert (frame.rounds, frame.n_chains) == (4, 4)
    assert frame.names == Telemetry(probe=probe).names
    assert all(np.isfinite(a).all() and a.dtype == np.float32
               for a in frame.metrics.values())


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("federation", ["topk-1%", "partial-50%",
                                        "straggler-10%"])
def test_federated_telemetry_is_bitwise(executor, federation):
    data, bank = _problem()
    ref = _facade(data, bank, executor=executor,
                  federation=federation).sample(gen(3), torch.zeros(3))
    got, _ = _facade(data, bank, executor=executor, federation=federation,
                     telemetry=Telemetry()).sample(gen(3), torch.zeros(3))
    _bitwise(ref, got)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_log_every_segments_are_bitwise_one_run(executor):
    data, bank = _problem()
    one, f_one = _facade(data, bank, executor=executor, rounds=5).sample(
        gen(), torch.zeros(3), telemetry=Telemetry())
    seg, f_seg = _facade(data, bank, executor=executor, rounds=5).sample(
        gen(), torch.zeros(3), telemetry=Telemetry(log_every=2))
    _bitwise(one, seg)
    for n in f_one.names:
        np.testing.assert_array_equal(f_one.metrics[n], f_seg.metrics[n])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_recovery_returns_result_health_frame(executor):
    data, bank = _problem()
    ref, h_ref = _facade(data, bank, executor=executor, kernel="sghmc",
                         recovery=api.Recovery()).sample(gen(),
                                                         torch.zeros(3))
    trace, health, frame = _facade(
        data, bank, executor=executor, kernel="sghmc",
        recovery=api.Recovery()).sample(gen(), torch.zeros(3),
                                        telemetry=Telemetry())
    _bitwise(ref, trace)
    assert isinstance(health, api.RunHealth)
    np.testing.assert_array_equal(health.word, h_ref.word)
    np.testing.assert_array_equal(frame.metrics["health_word"], 0.0)
    np.testing.assert_allclose(frame.metrics["noise_scale"],
                               np.sqrt(2 * 0.1 * 1e-4), rtol=1e-6)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_quarantined_chain_shows_its_word_and_no_drift(executor):
    """A chaos NaN at round 1 on chain 2 under quarantine: the word is
    round 1 + 1 = 2 from that round on, the frozen chain's drift is zero
    after it, the run bitwise the telemetry-off run."""
    from repro_torch.testing import ChaosSpec
    data, bank = _problem()
    chaos = ChaosSpec(nan_chains=(2,), nan_rounds=(1,))
    f = _facade(data, bank, executor=executor, recovery=api.Recovery())
    ref, h_ref = f.engine.run(gen(), torch.zeros(3), 4, n_chains=4,
                              reassign="permutation", recovery=api.Recovery(),
                              chaos=chaos)
    got, health, frame = f.engine.run(
        gen(), torch.zeros(3), 4, n_chains=4, reassign="permutation",
        recovery=api.Recovery(), chaos=chaos, telemetry=Telemetry())
    _bitwise(ref, got)
    np.testing.assert_array_equal(health.word, h_ref.word)
    hw = frame.metrics["health_word"]
    np.testing.assert_array_equal(hw[:, 2], [0, 2, 2, 2])
    np.testing.assert_array_equal(hw[:, [0, 1, 3]], 0)
    np.testing.assert_array_equal(frame.metrics["drift_norm"][1:, 2], 0.0)
    assert (frame.metrics["drift_norm"][:, [0, 1, 3]] > 0).all()


# ---------------------------------------------------------------------------
# the rows against the reference's formulas
# ---------------------------------------------------------------------------

def test_noise_scale_closed_forms():
    data, bank = _problem()
    h = 1e-4
    for kw, want in ((dict(), np.sqrt(h)),
                     (dict(method="fald", n_chains=4), np.sqrt(h * 4)),
                     (dict(kernel="sghmc"), np.sqrt(2 * 0.1 * h))):
        frame = _facade(data, bank, step=h, **kw).sample(
            gen(2), torch.zeros(3), telemetry=Telemetry(probe=False))[-1]
        np.testing.assert_allclose(frame.metrics["noise_scale"], want,
                                   rtol=1e-6)


def _held(f, seed, rounds, C, federation=None):
    """The clients each chain holds per round (the engine's own replay)."""
    return replay_sids(gen(seed), f.engine, num_rounds=rounds, n_chains=C,
                       federation=federation,
                       noise_like=(torch.zeros(C, 3)
                                   if f.execution.executor == "vmap"
                                   else None))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_conducive_norm_matches_the_reference(executor):
    """||g_s(theta)|| at each round-end state against the reference's
    ``conducive_gradient_from_bank`` with the same bank, client and f_s."""
    d, C, R, T, S = 3, 2, 3, 2, 4
    data, bank = _problem(4, S=S, n=12, d=d)
    jbank = jmake_bank(bank.means.numpy(), bank.precs.numpy(), "diag")
    f = _facade(data, bank, executor=executor, rounds=R, local=T,
                n_chains=C, minibatch=4)
    trace, frame = f.sample(gen(11), torch.zeros(d), telemetry=Telemetry())
    held = _held(f, 11, R, C)
    for r in range(R):
        for c in range(C):
            end = trace[c, r * T + T - 1].numpy()
            g = jconducive(jnp.asarray(end), jbank, int(held[r, c]),
                           1.0 / S, f.cfg.alpha)
            np.testing.assert_allclose(
                frame.metrics["conducive_norm"][r, c],
                np.linalg.norm(np.asarray(g)), rtol=1e-5)
            np.testing.assert_allclose(
                frame.metrics["theta_norm"][r, c], np.linalg.norm(end),
                rtol=1e-5)


@pytest.mark.parametrize("executor", ["per_leaf", "packed"])
def test_conducive_norm_scalar_bank_on_a_pytree(executor):
    """A two-leaf parameter tree with a 'scalar' bank: the packed
    executor's norm comes from its own gathered operands, leaf by leaf."""
    rng = np.random.default_rng(9)
    S, C, R, T = 3, 3, 2, 2
    x = rng.normal(size=(S, 10, 5)).astype(np.float32)
    means = {"a": rng.normal(size=(S, 3)).astype(np.float32),
             "b": rng.normal(size=(S, 2)).astype(np.float32)}
    precs = {"a": rng.uniform(1, 3, S).astype(np.float32),
             "b": rng.uniform(1, 3, S).astype(np.float32)}
    tb = make_bank({k: torch.from_numpy(v) for k, v in means.items()},
                   {k: torch.from_numpy(v) for k, v in precs.items()},
                   "scalar")
    jb = jmake_bank({k: jnp.asarray(v) for k, v in means.items()},
                    {k: jnp.asarray(v) for k, v in precs.items()}, "scalar")

    def ll(th, b):
        return -0.5 * (torch.sum((b["x"][:, :3] - th["a"]) ** 2)
                       + torch.sum((b["x"][:, 3:] - th["b"]) ** 2))

    f = api.FSGLD(api.Posterior(ll), {"x": torch.from_numpy(x)},
                  minibatch=4, step_size=1e-3,
                  surrogate=api.SurrogateSpec(kind="scalar", bank=tb),
                  schedule=api.Schedule(rounds=R, local_steps=T,
                                        n_chains=C, reassign="permutation"),
                  execution=api.Execution(device="cpu", executor=executor))
    theta0 = {"a": torch.zeros(3), "b": torch.zeros(2)}
    trace, frame = f.sample(gen(5), theta0, telemetry=Telemetry())
    held = replay_sids(gen(5), f.engine, num_rounds=R, n_chains=C,
                       num_leaves=2)
    for r in range(R):
        for c in range(C):
            end = {k: jnp.asarray(v[c, r * T + T - 1].numpy())
                   for k, v in trace.items()}
            g = jconducive(end, jb, int(held[r, c]), 1.0 / S, 1.0)
            want = np.sqrt(sum(float(jnp.sum(v ** 2))
                               for v in jax.tree.leaves(g)))
            np.testing.assert_allclose(
                frame.metrics["conducive_norm"][r, c], want, rtol=1e-5)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_probe_rows_match_jax_value_and_grad(executor):
    """grad_norm / log_post at each round-end state: the probe batch made
    from ``probe_generator(state at the round's start, r,
    TELEMETRY_PROBE_SALT)``, the values from ``jax.value_and_grad`` of the
    reference's log-likelihood on that batch."""
    d, n, m, C, R, T, S = 3, 16, 4, 2, 3, 2, 2
    data, _ = _problem(1, S=S, n=n, d=d)
    f = _facade(data, None, executor=executor, method="dsgld", rounds=R,
                local=T, n_chains=C, minibatch=m)
    trace, frame = f.sample(gen(9), torch.zeros(d), telemetry=Telemetry())
    eng, clone = f.engine, gen(9)
    x = data["x"].numpy()
    vg = jax.value_and_grad(_jlog_lik)
    for r in range(R):
        pgen = probe_generator(clone, r, TELEMETRY_PROBE_SALT)
        dr = draw_round(clone, eng.cfg, eng.scheme, n_chains=C, minibatch=m,
                        num_leaves=1, reassign="permutation", r=r)
        if executor == "vmap":
            for _ in range(T):
                torch.randn((C, d), generator=clone)
        u = torch.rand((C, m), generator=pgen, dtype=torch.float64)
        idx = torch.minimum((u * n).floor().to(torch.int64),
                            torch.tensor(n - 1)).numpy()
        for c in range(C):
            th = trace[c, r * T + T - 1].numpy()
            batch = {"x": jnp.asarray(x[int(dr.sids[c])][idx[c]])}
            lp, g = vg(jnp.asarray(th), batch)
            np.testing.assert_allclose(frame.metrics["grad_norm"][r, c],
                                       float(jnp.linalg.norm(g)), rtol=1e-5)
            np.testing.assert_allclose(
                frame.metrics["log_post"][r, c],
                float(lp) - 0.5 * float(np.sum(th.astype(np.float64) ** 2)),
                rtol=1e-5)
        start = trace[:, r * T - 1] if r else torch.zeros(C, d)
        np.testing.assert_allclose(
            frame.metrics["drift_norm"][r],
            torch.linalg.norm(trace[:, r * T + T - 1] - start, dim=1),
            rtol=1e-5)
    np.testing.assert_array_equal(frame.metrics["participation"], 1.0)
    np.testing.assert_array_equal(frame.metrics["bytes_per_round"], 8.0 * d)
    np.testing.assert_array_equal(frame.metrics["health_word"], 0.0)
    np.testing.assert_array_equal(frame.metrics["conducive_norm"], 0.0)


@pytest.mark.parametrize("name", ["topk-1%", "elf-bidir-qsgd-8bit",
                                  "partial-50%"])
def test_bytes_follow_the_reference_compression(name):
    data, bank = _problem()
    _, frame = _facade(data, bank, executor="packed", federation=name,
                       rounds=6).sample(gen(5), torch.zeros(3),
                                        telemetry=Telemetry(probe=False))
    want = float(JSCENARIOS[name].compression.bytes_per_round(3))
    part = frame.metrics["participation"]
    assert set(np.unique(part)) <= {0.0, 1.0}
    np.testing.assert_array_equal(frame.metrics["bytes_per_round"],
                                  part * np.float32(want))
    if name == "partial-50%":
        np.testing.assert_array_equal(part[0], 1.0)   # round 0: everyone
        assert 0 < part.mean() < 1
    else:
        np.testing.assert_array_equal(part, 1.0)


def test_participation_follows_the_delay_schedule():
    data, bank = _problem()
    _, fr = _facade(data, bank, federation="delayed-5x", rounds=10).sample(
        gen(5), torch.zeros(3), telemetry=Telemetry(probe=False))
    sched = JSCENARIOS["delayed-5x"].schedule
    mask = np.array([bool(jcomm_mask(sched, r)) for r in range(10)],
                    np.float32)
    np.testing.assert_array_equal(fr.metrics["participation"],
                                  np.broadcast_to(mask[:, None], (10, 4)))
    np.testing.assert_array_equal(
        fr.metrics["bytes_per_round"],
        np.broadcast_to((mask * 24.0)[:, None], (10, 4)))


# ---------------------------------------------------------------------------
# launches, events, contracts, refusals
# ---------------------------------------------------------------------------

def test_one_update_per_step_with_telemetry_on(monkeypatch):
    calls = []
    real = teng.kops.packed_step
    monkeypatch.setattr(teng.kops, "packed_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    data, bank = _problem()
    _facade(data, bank, executor="packed", rounds=3, local=4).sample(
        gen(), torch.zeros(3), telemetry=Telemetry())
    assert len(calls) == 3 * 4


def test_engine_progress_events_and_segment_spans(tmp_path):
    data, bank = _problem()
    path = str(tmp_path / "trace.jsonl")
    obs_trace.configure(path)
    try:
        _facade(data, bank, rounds=4).sample(
            gen(), torch.zeros(3), telemetry=Telemetry(log_every=2))
    finally:
        obs_trace.configure()
    recs = obs_trace.read_jsonl(path)
    prog = [r for r in recs if r["name"] == "engine.progress"]
    assert [p["round"] for p in prog] == [2, 4]
    assert all(p["rounds"] == 4 and p["steps_per_s"] > 0 for p in prog)
    assert all("grad_norm" in p and "bytes_per_round" in p for p in prog)
    segs = [r for r in recs if r["name"] == "engine.segment"]
    assert len(segs) == 2 and all(s["dur_s"] > 0 for s in segs)


def test_collect_false_returns_finals_and_frame():
    data, bank = _problem()
    finals, frame = _facade(data, bank, collect=False).sample(
        gen(), torch.zeros(3), telemetry=Telemetry())
    assert finals.shape == (4, 3) and frame.rounds == 4


def test_stream_and_double_segmentation_are_refused(tmp_path):
    data, bank = _problem(S=12, n=24)
    f = _facade(data, bank)
    with pytest.raises(NotImplementedError, match="telemetry"):
        f.sample(gen(), torch.zeros(3), telemetry=Telemetry(),
                 stream=api.Stream(resident=8, window=2))
    g = _facade(data, bank)
    g.execution = api.Execution(device="cpu", snapshot_every=2,
                                snapshot_path=str(tmp_path),
                                telemetry=Telemetry(log_every=2))
    with pytest.raises(NotImplementedError, match="segmentation"):
        g.sample(gen(), torch.zeros(3))
