"""Chains over ``torch.distributed`` ranks (the mesh) in the port.

Multi-rank runs go through two gloo ranks in CPU processes
(``tests/_mesh_worker.py``), three process groups in all; each rank
holds its mesh run against the same run without a mesh, bitwise:

* (data, model) = (2, 1): the engine on packed, per_leaf and vmap with 4
  and 3 chains (3: one pad chain at the global tail), FA-LD with top-k
  compression, a streamed run, snapshots and a resume, and
  ``Serving(mesh=)`` at K = 4 with its draws on 'data';
* (1, 2): the six engine runs, ``refresh_bank_mesh`` with the clients
  over 'model', a run with ``refresh_every``, ``Serving(mesh=)``
  replicated, the embedding's vocab-parallel lookup of replicated tokens
  against ``table[tokens]`` in value and gradient, and what the model
  runs on local (batch, head) shards (the attention scan and its
  backward, decode attention, RWKV decode's state read) against the
  plain tensors';
* ``launch/train.py --multi-pod --smoke`` on a (2, 1, 1) mesh against
  the driver's one-device run;
* (2, 1) again: recovery (a respawn whose donor is on the other rank, a
  quarantine) and telemetry with its probe rows.

The reference's own multi-device tests fail on this toolchain (ROADMAP
queue 3), so the port is held against its one-device runs. In one
process: ``sharding.rules`` against ``repro.sharding.rules`` (the
specs of every family at full width on (16, 16) and (2, 16, 16) meshes,
whisper's 20 heads and 51,866 vocab falling back to replication),
placements, ``ChainBlock`` without a mesh, and the meshes' refusals.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.models.model as JM
from repro.configs import get_config as jax_config
from repro.sharding import rules as jrules
from repro_torch import tree as tu
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_config as torch_config
from repro_torch.core.engine import ChainBlock
from repro_torch.launch import mesh as lmesh
from repro_torch.models import model as TM
from repro_torch.sharding import rules as trules
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_mesh_worker.py"
SECONDS = 300   # each group's limit (alone they take 7-9 s each)


def _ranks(case, tmp_path, world=2):
    """Run ``case`` on ``world`` gloo ranks; returns each rank's checks."""
    port = str(lmesh.free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), case, str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.monotonic()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, SECONDS - (time.monotonic() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    checks = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.json") as f:
            checks.append(json.load(f))
    return checks


def _assert_all_ok(checks, names):
    for r, rows in enumerate(checks):
        assert [n for n, _, _ in rows] == names, rows
        bad = [(n, d) for n, ok, d in rows if not ok]
        assert not bad, f"rank {r}: {bad}"


ENGINE = [f"engine {ex} C={n}" for ex in ("packed", "per_leaf", "vmap")
          for n in (4, 3)]


def test_chains_over_the_data_axis_equal_one_device(tmp_path):
    _assert_all_ok(_ranks("data", tmp_path), ENGINE + [
        "FA-LD packed C=3 with top-k compression",
        "streamed packed C=2, 2 resident",
        "snapshots every 2 rounds, then a resume at round 4",
        "Serving(mesh=) K=4 on 'data'",
        "Serving(mesh=) K=3 replicated (3 % 2 != 0)"])


def test_the_refresh_over_the_model_axis_equals_one_device(tmp_path):
    _assert_all_ok(_ranks("model", tmp_path), ENGINE + [
        "refresh_bank_mesh over model=2",
        "engine run with refresh_every=2",
        "Serving(mesh=) K=4 over a data axis of 1",
        "vocab-parallel lookup, D on data: False",
        "vocab-parallel lookup, D on data: True",
        "attention on local shards"])


def test_recovery_and_telemetry_across_data_ranks_equal_one_device(
        tmp_path):
    """(2, 1): the health words, the respawn donor (on the other rank),
    the quarantine masks and every telemetry row are gathered over
    'data', so the mesh run is the one-device run, bitwise."""
    _assert_all_ok(_ranks("health", tmp_path), [
        f"respawn across ranks {ex} C=3" for ex in ("packed", "per_leaf",
                                                    "vmap")] + [
        "quarantine with a federation packed C=4"])


def test_train_driver_multi_pod_equals_one_device(tmp_path):
    """Two pods of one rank each: each pod's chains (the whole data axis,
    replicated over 'pod') are the one-device driver's, bitwise."""
    _assert_all_ok(_ranks("train", tmp_path), ["train --multi-pod --smoke"])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _jax_shapes(arch):
    return jax.eval_shape(lambda: JM.init_params(jax_config(arch),
                                                 jax.random.PRNGKey(0)))


class _JaxMesh:
    """The mesh attributes the reference's rules read."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


def _same_specs(tspecs, jspecs, params):
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, JP))
    names = [n for n, _ in tu.leaves_with_names(params)]
    assert len(names) == len(jleaves)
    for name, j in zip(names, jleaves):
        node = tspecs
        for k in name.split("/"):
            node = node[k]
        t = tuple(node) + (None,) * (len(j) - len(node))
        assert _entries(t) == _entries(tuple(j) + (None,) * (
            len(node) - len(j))), (name, node, j)


@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
@pytest.mark.parametrize("mesh", MESHES, ids=["one-pod", "multi-pod"])
def test_param_and_serving_specs_match_the_reference(arch, mesh):
    shapes = _jax_shapes(arch)
    params = tu.tree_map(lambda l: torch.empty(l.shape, device="meta"),
                         TM.param_layout(torch_config(arch)))
    jm = _JaxMesh(mesh)
    for serve in (False, True):
        _same_specs(trules.param_specs(params, mesh, serve=serve),
                    jrules.param_specs(shapes, jm, serve=serve), params)


def test_whisper_heads_and_vocab_fall_back_to_replication():
    """whisper's 20 heads x 64 (q_dim 1,280 = 16 x 80 divides) but 51,866
    vocab rows do not divide a 16-way model axis: the embedding's vocab
    dim is replicated, its d_model dim sharded over 'data'."""
    params = tu.tree_map(lambda l: torch.empty(l.shape, device="meta"),
                         TM.param_layout(torch_config("whisper-large-v3")))
    specs = trules.param_specs(params, MESHES[0])
    assert tuple(specs["embed"]) == (None, "data")
    assert tuple(specs["head"]) == ("data", None)
    small = {"data": 4, "model": 3}
    wq = trules.param_specs(params, small)["blocks"]["l0"]["attn"]["wq"]
    assert tuple(wq) == (None, "data", None)   # 1,280 % 3 != 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b",
                                  "h2o-danube-1.8b"])
def test_batch_and_cache_specs_match_the_reference(arch):
    tcfg, jcfg = torch_config(arch), jax_config(arch)
    tcfg = dataclasses.replace(tcfg, num_layers=len(tcfg.layer_pattern) + 1)
    jcfg = dataclasses.replace(jcfg, num_layers=len(jcfg.layer_pattern) + 1)
    for mesh in MESHES:
        jm = _JaxMesh(mesh)
        tc = tu.tree_map(lambda t: t.to("meta"),
                         TM.init_cache(tcfg, 32, 64, device="meta"))
        jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 32, 64))
        _same_specs(trules.cache_specs(tc, mesh),
                    jrules.cache_specs(jc, jm), tc)
        batch = {"tokens": torch.empty(32, 8, device="meta"),
                 "one": torch.empty(1, 8, device="meta")}
        got = trules.batch_specs(batch, mesh)
        want = jrules.batch_specs(
            {"tokens": jax.ShapeDtypeStruct((32, 8), np.int32),
             "one": jax.ShapeDtypeStruct((1, 8), np.int32)}, jm)
        for k in batch:
            assert _entries(got[k]) == _entries(want[k]), k


def test_chain_and_ensemble_specs_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"data": 2, "model": 1}
    assert tuple(trules.chain_spec()) == tuple(jrules.chain_spec())
    assert tuple(trules.packed_chain_spec()) == tuple(
        jrules.packed_chain_spec())
    assert tuple(trules.fed_carry_spec()) == tuple(jrules.fed_carry_spec())
    assert tuple(trules.stream_window_spec()) == tuple(
        jrules.stream_window_spec())
    assert tuple(trules.ensemble_spec()) == tuple(jrules.ensemble_spec())
    assert trules.placements(trules.chain_spec(), mesh) == [Shard(0),
                                                            Replicate()]
    assert trules.placements(trules.stream_window_spec(), mesh) == [
        Replicate(), Replicate()]
    tree = {"a": torch.zeros(4, 3), "b": [torch.zeros(4)]}
    assert trules.chain_shardings(tree, mesh)["b"][0] == [Shard(0),
                                                          Replicate()]
    assert tuple(trules.ensemble_specs(tree)["a"]) == ("data",)


def test_chain_block_rows_and_padding():
    """Without a mesh the block is the identity; a block of rank 1 of 2
    over 3 chains holds chain 2 and a pad chain repeating chain 0."""
    t = torch.arange(12.0).reshape(3, 4)
    whole = ChainBlock.of(3)
    assert whole.take(t) is t and whole.gather(t) is t and whole.real == 3
    blk = ChainBlock(3, 2, 2, mesh=object())
    assert blk.real == 1
    assert torch.equal(blk.take(t), torch.stack([t[2], t[0]]))
    seeds = torch.arange(24).reshape(2, 3, 4)
    assert torch.equal(blk.take(seeds, 1), seeds[:, [2, 0]])
    empty = ChainBlock(1, 1, 1, mesh=object())
    assert empty.real == 0 and torch.equal(empty.take(t[:1]), t[:1])


def test_meshes_refuse_what_they_cannot_build(monkeypatch):
    """An odd world is not two pods; a mesh's shape must match the world;
    both refuse before starting a process group."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="even world"):
        lmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not torch.distributed.is_initialized()
    assert lmesh.axis_size(None, "data") == 1
    assert lmesh.axis_rank(None, "model") == 0


# ---------------------------------------------------------------------------
# a sequence's or a cache's slots sharded over 'model' (two gloo ranks)
# ---------------------------------------------------------------------------

SHARDS = ["decode attention over slot shards",
          "RG-LRU over sequence shards, carried: False",
          "RG-LRU over sequence shards, carried: True",
          "RG-LRU's conv and scan over sequence shards",
          "RWKV chunk loop over row shards"]


@pytest.fixture(scope="module")
def shard_checks(tmp_path_factory):
    """The 'shards' case on a (1, 2) mesh, run once: {name: [rank 0's
    (ok, detail), rank 1's]}."""
    checks = _ranks("shards", tmp_path_factory.mktemp("shards"))
    for rows in checks:
        assert [n for n, _, _ in rows] == SHARDS, rows
    return {n: [rows[i][1:] for rows in checks]
            for i, n in enumerate(SHARDS)}


@pytest.mark.parametrize("name", SHARDS)
def test_sharded_slots_and_sequence_equal_the_plain_tensors(shard_checks,
                                                            name):
    """Decode attention over a cache whose slots are sharded (the softmax
    reduced across the shards, not the scores gathered) and the RG-LRU
    block over a sharded sequence (the conv's halo and the scan's
    carries) against the plain tensors, within 1e-6 in fp32 on each rank
    (gradients within 1e-6 (1 + max |ref|)); RWKV's chunk loop over row
    shards, its gradients too."""
    for r, (ok, detail) in enumerate(shard_checks[name]):
        assert ok, f"rank {r}: {detail}"


# ---------------------------------------------------------------------------
# no quiet CPU world
# ---------------------------------------------------------------------------

MESH_ENTRIES = {
    "_device_type": lambda dt: lmesh._device_type(dt),
    "make_host_mesh": lambda dt: lmesh.make_host_mesh(dt),
    "make_sim_mesh": lambda dt: lmesh.make_sim_mesh(1, 1, dt),
    "make_production_mesh": lambda dt: lmesh.make_production_mesh(
        device_type=dt),
}


@pytest.mark.parametrize("entry", sorted(MESH_ENTRIES))
def test_mesh_entry_points_refuse_a_quiet_cpu_world(entry, monkeypatch):
    """Without CUDA and without a device type, each entry point raises
    before starting a process group; with 'cpu' it builds a gloo world
    (a 1 x 1 mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        MESH_ENTRIES[entry](None)
    assert not torch.distributed.is_initialized()
    try:
        out = MESH_ENTRIES[entry]("cpu")
        if entry == "_device_type":
            assert out == "cpu"
        else:
            assert out.device_type == "cpu"
            assert tuple(out.mesh.shape) == (1, 1)
            assert torch.distributed.get_backend() == "gloo"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
