"""The port's run snapshots and resume (``MeshChainEngine.run(
snapshot_every=, snapshot_path=, resume=)``, ``repro_torch.checkpoint``)
on the problem of ``tests/test_resume.py``, and the train driver's
``--snapshot-*`` / ``--resume`` / ``--draw-bank`` / ``--ckpt``.

The contract: a run that snapshots every k rounds, and a run killed
after any snapshot and resumed, give the uninterrupted run's trace (or
final states), BITWISE, on every executor, without a federation and
under ``test_resume.py``'s hard federation (delay, partial
participation, stragglers, top-k with error feedback: every piece of the
carry must be in the snapshot), with health state and chaos, and with
SGHMC momenta. A snapshot the port writes is read by the JAX package's
``restore`` under the same fingerprint.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import api, checkpoint
from repro_torch import tree as tu
from repro_torch.checkpoint import (latest_snapshot, list_snapshots,
                                    save_snapshot)
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.engine import MeshChainEngine
from repro_torch.core.health import Recovery
from repro_torch.core.surrogate import (analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.fed import CommSchedule, Compression, Federation
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as ttrain
from repro_torch.testing import ChaosSpec, corrupt_draw
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

S, n, d = 5, 40, 3
EXECUTORS = {"vmap": dict(use_kernel=False),
             "per_leaf": dict(use_kernel=True, packed=False),
             "packed": dict(use_kernel=True, packed=True)}
HARD_FED = Federation(
    schedule=CommSchedule(delay=2, participation=0.6, straggler_prob=0.2),
    compression=Compression(kind="topk", frac=0.5, error_feedback=True))


def gen():
    return torch.Generator().manual_seed(7)


def log_lik(theta, batch):
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    mus = rng.uniform(-4, 4, size=(S, d)).astype(np.float32)
    x = torch.from_numpy(
        (mus[:, None, :] + rng.normal(size=(S, n, d))).astype(np.float32))
    fits = [analytic_gaussian_likelihood_surrogate(xs) for xs in x]
    return {"x": x}, make_bank(torch.stack([m for m, _ in fits]),
                               torch.stack([p for _, p in fits]), "diag")


def _engine(problem, executor="vmap", **kw):
    data, bank = problem
    cfg = SamplerConfig(method="fsgld", step_size=1e-4, num_shards=S,
                        local_updates=3, prior_precision=1.0)
    return MeshChainEngine(log_lik, cfg, data, minibatch=8, bank=bank,
                           **EXECUTORS[executor], **kw)


def _equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# resume parity: executors x scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("fed", [None, HARD_FED],
                         ids=["identity", "hard-fed"])
def test_snapshot_and_resume_bitwise_parity(tmp_path, problem, executor,
                                            fed):
    """Snapshotted run == uninterrupted, and a run killed after round 3
    (its newest snapshot deleted, the torn tail) and resumed ==
    uninterrupted, bitwise (test_resume.py:66-87)."""
    eng = _engine(problem, executor)
    snaps = str(tmp_path / "snaps")
    ref = eng.run(gen(), torch.zeros(d), 7, n_chains=4, federation=fed)
    a = eng.run(gen(), torch.zeros(d), 7, n_chains=4, federation=fed,
                snapshot_every=3, snapshot_path=snaps)
    assert torch.equal(ref, a)
    assert [r for r, _ in list_snapshots(snaps)] == [6, 7]  # keep=2
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b = eng.run(gen(), torch.zeros(d), 7, n_chains=4, federation=fed,
                snapshot_every=3, snapshot_path=snaps, resume=True)
    assert torch.equal(ref, b)


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_resume_with_padding_health_and_chaos(tmp_path, problem, executor):
    """test_resume.py:90-114: 3 chains, quarantine with the detector on,
    and a chaos fault in the SECOND segment, replayed at the same
    absolute round after the resume; the word is the reference's."""
    eng = _engine(problem, executor)
    rec = Recovery(policy="quarantine", divergence_threshold=100.0)
    chaos = ChaosSpec(nan_chains=(1,), nan_rounds=(4,))
    snaps = str(tmp_path / "snaps")
    ref, href = eng.run(gen(), torch.zeros(d), 6, n_chains=3, recovery=rec,
                        chaos=chaos)
    a, ha = eng.run(gen(), torch.zeros(d), 6, n_chains=3, recovery=rec,
                    chaos=chaos, snapshot_every=2, snapshot_path=snaps)
    assert torch.equal(ref, a)
    np.testing.assert_array_equal(href.word, ha.word)
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b, hb = eng.run(gen(), torch.zeros(d), 6, n_chains=3, recovery=rec,
                    chaos=chaos, snapshot_every=2, snapshot_path=snaps,
                    resume=True)
    assert torch.equal(ref, b)
    np.testing.assert_array_equal(href.word, hb.word)
    np.testing.assert_array_equal(href.lp_ref, hb.lp_ref)
    assert href.word[1] == 5  # chaos at round 4 -> word 5


@pytest.mark.parametrize("executor", ["vmap", "packed"])
@pytest.mark.parametrize("fed", [None, HARD_FED],
                         ids=["identity", "hard-fed"])
def test_sghmc_resume_carries_the_momenta(tmp_path, problem, executor, fed):
    """SGHMC chain state is (theta, momentum); the snapshot holds both,
    so the resumed final states are the uninterrupted run's."""
    eng = _engine(problem, executor, dynamics="sghmc")
    snaps = str(tmp_path / "snaps")
    ref = eng.run(gen(), torch.zeros(d), 5, n_chains=4, collect=False,
                  federation=fed)
    eng.run(gen(), torch.zeros(d), 5, n_chains=4, collect=False,
            federation=fed, snapshot_every=2, snapshot_path=snaps)
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b = eng.run(gen(), torch.zeros(d), 5, n_chains=4, collect=False,
                federation=fed, snapshot_every=2, snapshot_path=snaps,
                resume=True)
    assert isinstance(b, tuple) and _equal(ref, b)
    assert not torch.equal(b[1], torch.zeros_like(b[1]))


def test_resume_at_end_returns_the_stored_trace(tmp_path, problem):
    eng = _engine(problem)
    snaps = str(tmp_path / "snaps")
    ref = eng.run(gen(), torch.zeros(d), 6, n_chains=4, snapshot_every=3,
                  snapshot_path=snaps)
    again = eng.run(gen(), torch.zeros(d), 6, n_chains=4, snapshot_every=3,
                    snapshot_path=snaps, resume=True)
    assert torch.equal(ref, again)


def test_resume_without_snapshots_is_a_fresh_run(tmp_path, problem):
    eng = _engine(problem)
    ref = eng.run(gen(), torch.zeros(d), 4, n_chains=4)
    a = eng.run(gen(), torch.zeros(d), 4, n_chains=4,
                snapshot_path=str(tmp_path / "empty"), resume=True)
    assert torch.equal(ref, a)


@pytest.mark.parametrize("executor", ["vmap", "packed"])
def test_resume_collect_false_final_states(tmp_path, problem, executor):
    eng = _engine(problem, executor)
    snaps = str(tmp_path / "snaps")
    ref = eng.run(gen(), torch.zeros(d), 6, n_chains=4, collect=False)
    a = eng.run(gen(), torch.zeros(d), 6, n_chains=4, collect=False,
                snapshot_every=2, snapshot_path=snaps)
    assert torch.equal(ref, a)
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b = eng.run(gen(), torch.zeros(d), 6, n_chains=4, collect=False,
                snapshot_every=2, snapshot_path=snaps, resume=True)
    assert torch.equal(ref, b)


def test_resume_skips_a_torn_snapshot(tmp_path, problem):
    """The newest snapshot torn (truncated arrays): resume warns, falls
    back to the one before, and still ends bitwise."""
    eng = _engine(problem, "packed")
    snaps = str(tmp_path / "snaps")
    ref = eng.run(gen(), torch.zeros(d), 6, n_chains=4, federation=HARD_FED,
                  snapshot_every=2, snapshot_path=snaps)
    corrupt_draw(list_snapshots(snaps)[-1][1], mode="truncate")
    with pytest.warns(UserWarning, match="skipping corrupt snapshot"):
        b = eng.run(gen(), torch.zeros(d), 6, n_chains=4,
                    federation=HARD_FED, snapshot_every=2,
                    snapshot_path=snaps, resume=True)
    assert torch.equal(ref, b)


def test_run_and_execution_validate_snapshot_args(problem):
    eng = _engine(problem)
    with pytest.raises(ValueError, match="snapshot_path"):
        eng.run(gen(), torch.zeros(d), 2, snapshot_every=1)
    with pytest.raises(ValueError, match="snapshot_path"):
        eng.run(gen(), torch.zeros(d), 2, resume=True)
    with pytest.raises(NotImplementedError,
                       match="snapshots do not compose with adaptive "
                             "refresh"):
        eng.run(gen(), torch.zeros(d), 2, snapshot_every=1,
                snapshot_path="x", refresh_every=1)
    with pytest.raises(ValueError, match="snapshot_path"):
        api.Execution(device="cpu", snapshot_every=2)
    with pytest.raises(ValueError, match="snapshot_path"):
        api.Execution(device="cpu", resume=True)


def test_facade_snapshots_and_resumes(tmp_path, problem):
    data, bank = problem
    snaps = str(tmp_path / "snaps")

    def sampler(**kw):
        return api.FSGLD(
            api.Posterior(log_lik), data, minibatch=8, step_size=1e-4,
            surrogate=api.SurrogateSpec(kind="diag", bank=bank),
            schedule=api.Schedule(rounds=5, local_steps=3, n_chains=4),
            execution=api.Execution(device="cpu", executor="packed", **kw))

    ref = sampler().sample(gen(), torch.zeros(d))
    sampler(snapshot_every=2, snapshot_path=snaps).sample(gen(),
                                                          torch.zeros(d))
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b = sampler(snapshot_every=2, snapshot_path=snaps,
                resume=True).sample(gen(), torch.zeros(d))
    assert torch.equal(ref, b)


# ---------------------------------------------------------------------------
# the snapshot substrate, and its files through the JAX package
# ---------------------------------------------------------------------------

def _payload(v=0.0):
    return {"chains": torch.full((2, 3), v),
            "key": torch.zeros(16, dtype=torch.uint8)}


def test_torn_snapshot_falls_back_to_the_previous(tmp_path):
    snaps = str(tmp_path / "snaps")
    save_snapshot(snaps, _payload(1.0), rounds_done=2)
    save_snapshot(snaps, _payload(2.0), rounds_done=4)
    corrupt_draw(list_snapshots(snaps)[-1][1], mode="truncate")
    with pytest.warns(UserWarning, match="skipping"):
        payload, r = latest_snapshot(snaps, _payload())
    assert r == 2 and torch.equal(payload["chains"], torch.full((2, 3), 1.0))


def test_all_snapshots_torn_means_a_fresh_start(tmp_path):
    snaps = str(tmp_path / "snaps")
    save_snapshot(snaps, _payload(1.0), rounds_done=2)
    corrupt_draw(list_snapshots(snaps)[0][1], mode="garbage")
    with pytest.warns(UserWarning, match="skipping"):
        payload, r = latest_snapshot(snaps, _payload())
    assert payload is None and r == 0


def test_snapshot_pruning_keeps_the_newest(tmp_path):
    snaps = str(tmp_path / "snaps")
    for r in (1, 2, 3, 4):
        save_snapshot(snaps, _payload(float(r)), rounds_done=r, keep=2)
    assert [r for r, _ in list_snapshots(snaps)] == [3, 4]
    save_snapshot(snaps, _payload(9.0), rounds_done=4, keep=2)
    assert [r for r, _ in list_snapshots(snaps)] == [3, 4]
    payload, r = latest_snapshot(snaps, _payload())
    assert r == 4 and torch.equal(payload["chains"], torch.full((2, 3), 9.0))


@pytest.mark.parametrize("executor", ["vmap", "packed"])
def test_port_snapshot_reads_through_the_jax_restore(tmp_path, problem,
                                                     executor):
    """A snapshot of a HARD_FED run with health state, as the port writes
    it, restored by ``repro.checkpoint.restore`` into a numpy skeleton of
    the same key paths: the same arrays, bitwise, and the JAX package's
    fingerprint of them is the one the port wrote."""
    eng = _engine(problem, executor)
    snaps = str(tmp_path / "snaps")
    eng.run(gen(), torch.zeros(d), 4, n_chains=4, federation=HARD_FED,
            recovery=Recovery(divergence_threshold=100.0), snapshot_every=4,
            snapshot_path=snaps)
    (_, path), = list_snapshots(snaps)
    like = {"chains": np.zeros((4, d), np.float32),
            "key": np.zeros(5056, np.uint8), "sids": np.zeros(4, np.int32),
            "ref": np.zeros((4, d), np.float32),
            "err": np.zeros((4, d), np.float32),
            "word": np.zeros(4, np.int32),
            "lp_ref": np.zeros((4, 8), np.float32),
            "trace": np.zeros((4, 12, d), np.float32)}
    got, step, _ = jckpt.restore(path, like)
    assert step == 4
    mine, _ = latest_snapshot(snaps, {k: torch.from_numpy(v)
                                      for k, v in like.items()})
    for k in like:
        np.testing.assert_array_equal(np.asarray(got[k]), mine[k].numpy())
        assert np.asarray(got[k]).dtype == like[k].dtype, k
    with open(os.path.join(path, "manifest.json")) as f:
        import json
        assert json.load(f)["fingerprint"] == jckpt.tree_fingerprint(got) \
            == checkpoint.tree_fingerprint(mine)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--smoke", "--local-updates", "2",
         "--fit-steps", "2", "--num-shards", "2", "--shard-size", "4",
         "--batch", "2", "--seq", "16", "--chains", "2"]


@pytest.fixture(scope="module")
def three_rounds():
    """The uninterrupted 3-round driver run both drivers' tests hold their
    runs against (made once)."""
    return ttrain.run(ttrain.parse_args(SMALL + ["--rounds", "3"]))


def test_train_snapshots_and_resumes_bitwise(tmp_path, three_rounds):
    """``--snapshot-every 1`` for 3 rounds, the newest snapshot deleted,
    ``--resume``: the final chain states are the uninterrupted run's."""
    base = SMALL + ["--rounds", "3"]
    ref = three_rounds
    snaps = str(tmp_path / "snaps")
    ttrain.run(ttrain.parse_args(base + ["--snapshot-every", "1",
                                         "--snapshot-dir", snaps]))
    assert [r for r, _ in list_snapshots(snaps)] == [2, 3]
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    b = ttrain.run(ttrain.parse_args(base + ["--snapshot-every", "1",
                                             "--snapshot-dir", snaps,
                                             "--resume"]))
    assert _equal(ref.finals, b.finals)


def test_draw_bank_segments_end_where_one_run_ends(tmp_path, three_rounds):
    """``--draw-bank --bank-every 1``: one draw per round, each with its
    DrawMeta; the segments continue one generator, so the final states
    are the one-run driver's, bitwise, and the freshest draw is chain 0's
    final state."""
    base = SMALL + ["--rounds", "3"]
    ref = three_rounds
    bank = str(tmp_path / "bank")
    tr = ttrain.run(ttrain.parse_args(base + ["--draw-bank", bank]))
    assert _equal(ref.finals, tr.finals)
    paths = checkpoint.list_draws(bank)
    assert paths == tr.draws and len(paths) == 3
    metas = [checkpoint.read_meta(p) for p in paths]
    assert [m.round for m in metas] == [1, 2, 3]
    assert {m.arch for m in metas} == {tr.cfg.name}
    assert {m.dtype for m in metas} == {"float32"}
    like = tu.tree_map(lambda t: t[0], tr.finals)
    assert {m.config_hash for m in metas} == {
        checkpoint.tree_fingerprint(like)}
    stacked, _ = checkpoint.load_bank(bank, like, k=1)
    assert _equal(tu.tree_map(lambda t: t[0], stacked), like)


def test_sghmc_draw_bank_writes_parameters(tmp_path):
    bank = str(tmp_path / "bank")
    tr = ttrain.run(ttrain.parse_args(
        SMALL + ["--rounds", "2", "--kernel", "sghmc", "--draw-bank", bank,
                 "--bank-every", "2"]))
    assert len(tr.draws) == 1 and checkpoint.read_meta(tr.draws[0]).round == 2
    stacked, _ = checkpoint.load_bank(bank, tu.tree_map(lambda t: t[0],
                                                        tr.finals))
    assert _equal(tu.tree_map(lambda t: t[0], stacked),
                  tu.tree_map(lambda t: t[0], tr.finals))


def test_train_bank_then_serve_watch(tmp_path, capsys, monkeypatch):
    """The reference pipeline on the CPU: ``launch.train --draw-bank D
    --bank-every 1`` then ``launch.serve --bank D --watch 1``; and
    ``--ckpt`` served as a one-draw legacy bank."""
    bank = str(tmp_path / "bank")
    assert ttrain.main(SMALL + ["--rounds", "2", "--draw-bank", bank,
                                "--bank-every", "1"]) == 0
    capsys.readouterr()
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "8", "--gen", "3"]
    assert serve_cli.main(argv + ["--bank", bank, "--draws", "2",
                                  "--watch", "1"]) == 0
    out = capsys.readouterr().out
    assert "serving 2 draw(s) from" in out
    assert "(round 1, method=fsgld, scenario=identity)" in out
    assert out.count("prefilled 2x8 once for 2 draw(s)") == 2
    ckpt = str(tmp_path / "ckpt")
    assert ttrain.main(SMALL + ["--rounds", "1", "--ckpt", ckpt]) == 0
    assert jckpt.read_meta(ckpt) is None
    _, step, extra = checkpoint.restore(ckpt, _skeleton())
    assert step == 1 and extra == {"method": "fsgld",
                                   "arch": "qwen3-1.7b", "chains": 2}
    monkeypatch.setattr(serve_cli, "_ckpt_warned", False)
    with pytest.warns(DeprecationWarning, match="--ckpt is deprecated"):
        assert serve_cli.main(argv + ["--ckpt", ckpt]) == 0
    assert "legacy checkpoint, no DrawMeta" in capsys.readouterr().out


def _skeleton():
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.server import skeleton
    return skeleton(get_smoke_config("qwen3-1.7b"))
