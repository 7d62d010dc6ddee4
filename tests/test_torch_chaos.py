"""The port's chain health and chaos (``repro_torch.core.health``, the
engine's per-round check, ``repro_torch.testing``) against the JAX
package's, on the problems of ``tests/test_chaos.py``.

* Health words: the chaos plans are static (no randomness decides which
  chain faults when), so the port's word must EQUAL the JAX engine's for
  the same plan, on every executor: quarantine, respawn, a chain count
  the JAX mesh pads, a NaN'd compressed payload.
* Containment, bitwise: every other chain's trace is the fault-free
  run's; a quarantined chain repeats its last healthy state; a respawned
  one continues from its donor; recovery on == off on a fault-free run
  (the probe draws from its own generator).
* The divergence detector: warm-up never trips, ``lp_ref`` is -inf
  until the window fills, ``window`` and ``quantile`` are plumbed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JCfg
from repro.core import make_bank as jmake_bank
from repro.core.engine import MeshChainEngine as JEngine
from repro.core.health import Recovery as JRecovery
from repro.fed import CommSchedule as JSched
from repro.fed import Compression as JComp
from repro.fed import Federation as JFed
from repro.testing import ChaosSpec as JChaos
from repro_torch import api
from repro_torch.configs.base import SamplerConfig
from repro_torch.core import ess, rhat, summarize
from repro_torch.core.engine import MeshChainEngine, probe_generator
from repro_torch.core.health import (HEALTH_PROBE_SALT, POLICIES, Recovery,
                                     RunHealth)
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.fed import CommSchedule, Compression, Federation
from repro_torch.testing import ChaosSpec
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

S, N, D = 4, 12, 3
EXECUTORS = {"vmap": dict(use_kernel=False),
             "per_leaf": dict(use_kernel=True, packed=False),
             "packed": dict(use_kernel=True, packed=True)}


def gen(seed=7):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def problem():
    """test_chaos.py's regression problem, made with numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S, N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=(S, N))).astype(np.float32)
    return {"x": x, "y": y}


def _tlog_lik(theta, b):
    return -0.5 * torch.sum((b["y"] - b["x"] @ theta["w"]) ** 2)


def _jlog_lik(theta, b):
    return -0.5 * jnp.sum((b["y"] - b["x"] @ theta["w"]) ** 2)


def _engines(problem, executor, **kw):
    t = MeshChainEngine(
        _tlog_lik, SamplerConfig(method="dsgld", step_size=1e-3,
                                 num_shards=S, local_updates=2,
                                 prior_precision=1.0),
        {k: torch.from_numpy(v) for k, v in problem.items()}, minibatch=4,
        **EXECUTORS[executor], **kw)
    j = JEngine(_jlog_lik, JCfg(method="dsgld", step_size=1e-3,
                                num_shards=S, local_updates=2,
                                prior_precision=1.0),
                {k: jnp.asarray(v) for k, v in problem.items()}, minibatch=4)
    return t, j


T0 = {"w": torch.zeros(D)}
J0 = {"w": jnp.zeros(D)}
JKEY = jax.random.PRNGKey(7)


# ---------------------------------------------------------------------------
# health words equal the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("policy,n_chains,chain,rnd,word", [
    ("quarantine", 4, 2, 1, [0, 0, 2, 0]),
    ("respawn", 4, 2, 1, [0, 0, 1, 0]),
    ("quarantine", 3, 1, 0, [0, 1, 0])])
def test_health_word_equals_the_jax_engines(problem, executor, policy,
                                            n_chains, chain, rnd, word):
    """test_chaos.py's plans (:92-140): NaN chain ``chain`` after round
    ``rnd``; 3 chains is the JAX mesh's padded block. Both words are the
    documented one; the other chains' traces are the fault-free run's,
    bitwise, and every trace stays finite."""
    teng, jeng = _engines(problem, executor)
    base = teng.run(gen(), T0, 5, n_chains=n_chains, reassign="permutation")
    out, h = teng.run(gen(), T0, 5, n_chains=n_chains,
                      reassign="permutation", recovery=Recovery(policy),
                      chaos=ChaosSpec(nan_chains=(chain,),
                                      nan_rounds=(rnd,)))
    _, jh = jeng.run(JKEY, J0, 5, n_chains=n_chains,
                     reassign="permutation", recovery=JRecovery(policy),
                     chaos=JChaos(nan_chains=(chain,), nan_rounds=(rnd,)))
    assert isinstance(h, RunHealth) and h.policy == policy
    np.testing.assert_array_equal(h.word, np.asarray(jh.word))
    np.testing.assert_array_equal(h.word, word)
    assert h.word.dtype == np.int32
    assert h.n_healthy == n_chains - 1 and h.lp_ref is None
    others = [c for c in range(n_chains) if c != chain]
    assert torch.equal(base["w"][others], out["w"][others])
    assert bool(torch.isfinite(out["w"]).all())


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_payload_corruption_word_equals_the_jax_engines(executor):
    """test_chaos.py:263-294: a NaN'd compressed payload (delay 2, top-k
    0.5 with error feedback) quarantines only its chain, with the same
    word as the JAX engine's; the others are the fault-free run's,
    bitwise."""
    rng = np.random.default_rng(1)
    mus = rng.uniform(-4, 4, size=(S, D)).astype(np.float32)
    x = (mus[:, None, :] + rng.normal(size=(S, 40, D))).astype(np.float32)
    fits = [analytic_gaussian_likelihood_surrogate(torch.from_numpy(xs))
            for xs in x]
    mu_s = torch.stack([m for m, _ in fits])
    prec_s = torch.stack([p for _, p in fits])
    cfg = dict(method="fsgld", step_size=1e-4, num_shards=S,
               local_updates=3, prior_precision=1.0)
    teng = MeshChainEngine(
        lambda t, b: -0.5 * torch.sum((b["x"] - t) ** 2),
        SamplerConfig(**cfg), {"x": torch.from_numpy(x)}, minibatch=8,
        bank=make_bank(mu_s, prec_s, "diag"), **EXECUTORS[executor])
    jeng = JEngine(lambda t, b: -0.5 * jnp.sum((b["x"] - t) ** 2),
                   JCfg(**cfg), {"x": jnp.asarray(x)}, minibatch=8,
                   bank=jmake_bank(jnp.asarray(mu_s.numpy()),
                                   jnp.asarray(prec_s.numpy()), "diag"))
    fed = Federation(schedule=CommSchedule(delay=2),
                     compression=Compression(kind="topk", frac=0.5,
                                             error_feedback=True))
    jfed = JFed(schedule=JSched(delay=2),
                compression=JComp(kind="topk", frac=0.5,
                                  error_feedback=True))
    base = teng.run(gen(), torch.zeros(D), 6, n_chains=4, federation=fed)
    out, h = teng.run(gen(), torch.zeros(D), 6, n_chains=4, federation=fed,
                      recovery=Recovery("quarantine"),
                      chaos=ChaosSpec(payload_nan_chains=(1,),
                                      payload_nan_rounds=(2,)))
    _, jh = jeng.run(JKEY, jnp.zeros(D), 6, n_chains=4, federation=jfed,
                     recovery=JRecovery("quarantine"),
                     chaos=JChaos(payload_nan_chains=(1,),
                                  payload_nan_rounds=(2,)))
    np.testing.assert_array_equal(h.word, np.asarray(jh.word))
    assert h.word[1] == 3 and np.all(h.word[[0, 2, 3]] == 0), h.word
    assert torch.equal(base[[0, 2, 3]], out[[0, 2, 3]])
    # as in the reference, the chain freezes at its state after the
    # exchange, which the corrupted payload already made NaN
    assert not bool(torch.isfinite(out[1, 6:]).any())


# ---------------------------------------------------------------------------
# containment and neutrality, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("policy", POLICIES)
def test_recovery_on_is_bitwise_recovery_off(problem, executor, policy):
    """A fault-free run with health tracking (the detector too) is
    bitwise the run without it: the probe consumes nothing of the
    sampling generator, which ends in the same state."""
    teng, _ = _engines(problem, executor)
    g0, g1 = gen(), gen()
    base = teng.run(g0, T0, 5, n_chains=4, reassign="permutation")
    out, h = teng.run(g1, T0, 5, n_chains=4, reassign="permutation",
                      recovery=Recovery(policy, divergence_threshold=50.0))
    assert h.n_healthy == h.n_chains == 4 and bool(h.healthy.all())
    assert torch.equal(base["w"], out["w"])
    assert torch.equal(g0.get_state(), g1.get_state())


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_quarantined_chain_repeats_its_last_healthy_state(problem,
                                                          executor):
    """Chain 2 NaN'd after round 1 (T = 2, every step kept): from round 1
    on its trace repeats its state after round 0, its last step."""
    teng, _ = _engines(problem, executor)
    out, h = teng.run(gen(), T0, 5, n_chains=4, reassign="permutation",
                      recovery=Recovery("quarantine"),
                      chaos=ChaosSpec(nan_chains=(2,), nan_rounds=(1,)))
    frozen = out["w"][2, 1]
    assert torch.equal(out["w"][2, 2:], frozen.expand(8, D))
    assert not torch.equal(out["w"][2, 0], frozen)


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_respawn_continues_from_the_donor_and_is_deterministic(problem,
                                                               executor):
    """The respawned chain's round is its donor's final state (chain 0,
    the first healthy chain), repeated; two runs agree bitwise."""
    teng, _ = _engines(problem, executor)
    chaos = ChaosSpec(nan_chains=(2,), nan_rounds=(1,))
    runs = [teng.run(gen(), T0, 5, n_chains=4, reassign="permutation",
                     recovery=Recovery("respawn"), chaos=chaos)
            for _ in range(2)]
    (a, ha), (b, hb) = runs
    np.testing.assert_array_equal(ha.word, hb.word)
    assert torch.equal(a["w"], b["w"])
    assert torch.equal(a["w"][2, 2:4], a["w"][0, 3].expand(2, D))
    assert bool(torch.isfinite(a["w"]).all())


@pytest.mark.parametrize("executor", ["vmap", "packed"])
def test_sghmc_quarantine_contains_the_chain(problem, executor):
    """SGHMC, (theta, momentum) chain state: the word is the Langevin
    plan's, and the other chains are the fault-free SGHMC run's,
    bitwise."""
    teng, _ = _engines(problem, executor, dynamics="sghmc")
    base = teng.run(gen(), T0, 4, n_chains=4, reassign="permutation")
    out, h = teng.run(gen(), T0, 4, n_chains=4, reassign="permutation",
                      recovery=Recovery("quarantine"),
                      chaos=ChaosSpec(nan_chains=(2,), nan_rounds=(1,)))
    np.testing.assert_array_equal(h.word, [0, 0, 2, 0])
    assert torch.equal(base["w"][[0, 1, 3]], out["w"][[0, 1, 3]])
    assert bool(torch.isfinite(out["w"]).all())


def test_diagnostics_refuse_nonfinite_and_accept_the_mask(problem):
    teng, _ = _engines(problem, "packed")
    out, h = teng.run(gen(), T0, 8, n_chains=4, reassign="permutation",
                      recovery=Recovery("quarantine"),
                      chaos=ChaosSpec(nan_chains=(2,), nan_rounds=(1,)))
    trace = torch.cat([out["w"], out["w"]], dim=1)
    poisoned = trace.clone()
    poisoned[2, 0] = float("nan")
    for fn in (rhat, ess):
        with pytest.raises(ValueError, match="non-finite"):
            fn(poisoned)
        assert bool(torch.isfinite(fn(poisoned, mask=h.healthy)).all())
    s = summarize(trace, mask=h.healthy)
    assert s["n_healthy"] == 3 and s["n_excluded"] == 1


def test_facade_returns_run_health(problem):
    """``Execution(recovery=...)`` reaches the engine through ``sample``,
    which then returns (trace, RunHealth)."""
    data = {k: torch.from_numpy(v) for k, v in problem.items()}
    s = api.FSGLD(api.Posterior(_tlog_lik), data, minibatch=4,
                  step_size=1e-3, method="dsgld",
                  schedule=api.Schedule(rounds=3, local_steps=2, n_chains=4),
                  execution=api.Execution(
                      device="cpu", executor="packed",
                      recovery=api.Recovery("quarantine")))
    out, h = s.sample(gen(), T0)
    assert isinstance(h, api.RunHealth) and h.n_healthy == 4
    assert out["w"].shape == (4, 6, D)


# ---------------------------------------------------------------------------
# the divergence detector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["vmap", "packed"])
def test_detector_warmup_never_false_trips(problem, executor):
    """test_chaos.py:144-164: while the 8-probe window is mostly -inf
    (4 rounds) the median reference is -inf and nothing trips, even at a
    threshold inside the probe noise; by 12 rounds it is finite and the
    same threshold trips chains."""
    teng, _ = _engines(problem, executor)
    rec = Recovery("quarantine", divergence_threshold=1e-6)
    _, h4 = teng.run(gen(), T0, 4, n_chains=4, reassign="permutation",
                     recovery=rec)
    assert h4.n_healthy == 4, h4.word
    assert np.all(np.isneginf(h4.lp_ref)), h4.lp_ref
    _, h12 = teng.run(gen(), T0, 12, n_chains=4, reassign="permutation",
                      recovery=rec)
    assert h12.n_healthy < 4, h12.word
    # a chain trips only once its reference is finite, and keeps it
    assert np.all(np.isfinite(h12.lp_ref)), h12.lp_ref


@pytest.mark.parametrize("executor", ["vmap", "packed"])
def test_detector_window_and_quantile_are_plumbed(problem, executor):
    """test_chaos.py:167-185: quantile 1.0 over a 2-probe window warms up
    after one probe, so the tight threshold trips in 3 rounds; a sane
    one leaves the run bitwise clean with a finite reference."""
    teng, _ = _engines(problem, executor)
    _, h = teng.run(gen(), T0, 3, n_chains=4, reassign="permutation",
                    recovery=Recovery("quarantine",
                                      divergence_threshold=1e-6, window=2,
                                      quantile=1.0))
    assert h.n_healthy < 4, h.word
    base = teng.run(gen(), T0, 3, n_chains=4, reassign="permutation")
    out, h2 = teng.run(gen(), T0, 3, n_chains=4, reassign="permutation",
                       recovery=Recovery("quarantine",
                                         divergence_threshold=200.0,
                                         window=2, quantile=1.0))
    assert h2.n_healthy == 4
    assert torch.equal(base["w"], out["w"])
    assert np.all(np.isfinite(h2.lp_ref))


def test_probe_generator_consumes_nothing_and_depends_on_state_and_round():
    g = gen(3)
    before = g.get_state()
    a = torch.rand(4, generator=probe_generator(g, 5))
    assert torch.equal(g.get_state(), before)
    assert torch.equal(a, torch.rand(4, generator=probe_generator(g, 5)))
    assert not torch.equal(a, torch.rand(4, generator=probe_generator(g, 6)))
    torch.rand(1, generator=g)
    assert not torch.equal(a, torch.rand(4, generator=probe_generator(g, 5)))
    assert HEALTH_PROBE_SALT == 0x48EA17


def test_recovery_and_chaos_spec_validate_like_the_reference():
    with pytest.raises(AssertionError):
        Recovery(window=0)
    with pytest.raises(AssertionError):
        Recovery(quantile=1.5)
    with pytest.raises(AssertionError):
        Recovery(policy="ignore")
    spec = ChaosSpec(nan_chains=[2], nan_rounds=[1])
    assert spec.nan_chains == (2,) and spec.active
    assert hash(spec) == hash(ChaosSpec(nan_chains=(2,), nan_rounds=(1,)))
    assert not ChaosSpec().active
    assert ChaosSpec(payload_nan_chains=(0,),
                     payload_nan_rounds=(0,)).poisons_payload
