"""The dry run and its roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) on the CPU.

* One subprocess per fake world (a fake world is process-global,
  ``tests/_dryrun_worker.py``): qwen3's smoke config (d 64) traced on a
  fake (2, 2) world at small train, prefill and decode shapes. Each
  rank's ``argument_size_bytes`` is the sum of the local shards the
  reference's ``param_specs`` / ``batch_specs`` / ``cache_specs`` give (the ``_JaxMesh`` stand-in of
  ``test_torch_mesh.py``), the train step's exactly 8 bytes less (the
  reference's PRNG key; the port's seeds come from a generator); the
  long-context shape is a SKIP for full attention.
* The op counter against ``repro.roofline.hlo_analysis.analyze_text``
  on the reference's loop-free grad MLP (``tests/test_system.py``, as a
  value_and_grad: eager autograd computes the forward's value): within
  5 %; a 10-iteration Python loop counts 10 times one iteration.
* ``model_flops`` equal to the reference's for every architecture x
  shape.
* The global-index noise rule: a local shard's update equals that
  shard's slice of the unsharded update, bitwise.
* The reference's batch anchor and what it buys, on a (2, 4) mesh at a
  width where matrix products dominate (d 256; 2 KV heads, which do not
  split 4 ways, as qwen3's 8 do not split 16 ways on the pod): the
  residual stream at every period boundary of the train and prefill
  steps is batch-sharded on 'data' and replicated on 'model'; the train
  step's per-device FLOPs are an eighth of the one-device step's (no
  replicated layer), and within 10 % of the reference's compiled step
  (``tools/ref_dryrun.py`` on a (2, 4) mesh, in a process of its own).
  The MoE prefill on the (2, 2) world and, on a (2, 2, 2) pod-like mesh,
  the RWKV train step trace with status 'ok'.
* ``roofline.compare`` lists the combinations whose status differs.

``repro.launch.dryrun`` is not imported here: it rewrites XLA_FLAGS when
imported, which later subprocesses of the worker would inherit.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.roofline import report as jreport
from repro.roofline.hlo_analysis import analyze_text
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_NAMES, SHAPES
from repro_torch.kernels.ops import fused_update_flat
from repro_torch.launch.steps import shard_runs, update_shard
from repro_torch.roofline import report as treport
from repro_torch.roofline.hlo_analysis import OpCounter, analyze
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ROOT = Path(__file__).resolve().parents[1]


class _JaxMesh:
    """The mesh attributes the reference's rules read."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _local_bytes(tree, specs, mesh, dtype=None):
    """Per-device bytes of ``tree`` (ShapeDtypeStructs) under the
    reference's ``specs``."""
    total = 0
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(jax.tree.leaves(tree), flat):
        shape = list(leaf.shape)
        for d, e in enumerate(tuple(spec)):
            for ax in (e if isinstance(e, tuple) else (e,)):
                if ax is not None:
                    shape[d] //= mesh[ax]
        dt = dtype if dtype is not None and jnp.issubdtype(
            leaf.dtype, jnp.floating) else leaf.dtype
        total += math.prod(shape) * np.dtype(dt).itemsize
    return total


def _worker(tmp_path_factory, world):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_dryrun_worker.py"), str(out),
                        world],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fake_world_run(tmp_path_factory):
    return _worker(tmp_path_factory, "4")


@pytest.fixture(scope="module")
def world_of_8_run(tmp_path_factory):
    return _worker(tmp_path_factory, "8")


def test_argument_bytes_are_the_references_local_shards(fake_world_run):
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    import dataclasses
    import repro.models.model as JM
    from repro.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **w.CFG)
    mesh = {"data": 2, "model": 2}
    jm = _JaxMesh(mesh)
    params = jax.eval_shape(lambda: JM.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    pspecs = jrules.param_specs(params, jm)
    B, S = 4, 32
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    bspec = jrules.batch_specs({"t": tok}, jm)["t"]
    n_leaves = len(jax.tree.leaves(params))
    train = (_local_bytes(params, pspecs, mesh)
             + 2 * _local_bytes(params, pspecs, mesh, jnp.bfloat16)
             + 2 * 4 * n_leaves
             + 2 * _local_bytes([tok], [bspec], mesh)
             + 8)                                   # the PRNG key
    prefill = (_local_bytes(params, pspecs, mesh)
               + _local_bytes([tok], [bspec], mesh))
    sspecs = jrules.param_specs(params, jm, serve=True)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, S))
    one = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)
    ospecs = jrules.batch_specs({"a": one, "b": pos}, jm)
    decode = (_local_bytes(params, sspecs, mesh, jnp.bfloat16)
              + _local_bytes(cache, jrules.cache_specs(cache, jm), mesh)
              + _local_bytes([one, pos], [ospecs["a"], ospecs["b"]], mesh))
    got = fake_world_run
    assert got["train"]["argument_size_bytes"] == train - 8
    assert got["prefill"]["argument_size_bytes"] == prefill
    assert got["decode"]["argument_size_bytes"] == decode
    assert got["long_500k"] == "skip"
    for k in ("train", "prefill", "decode"):
        info = got[k]
        assert info["static_flops"] == info["flops"] > 0
        assert info["peak_bytes"] >= info["argument_size_bytes"]
        assert info["static_hbm_bytes"] > 0
    # the train step's gradient is reduced across the data ranks
    assert got["train"]["static_collective_total"] > 0


def test_op_counter_matches_the_hlo_analyzer_on_a_grad_mlp():
    def f(w1, w2, x):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)

    # value_and_grad: eager autograd computes the forward's value, which
    # XLA would drop from a bare grad as dead code
    g = jax.value_and_grad(f, argnums=(0, 1))
    xs = [jax.ShapeDtypeStruct(s, jnp.float32)
          for s in [(64, 128), (128, 32), (16, 64)]]
    want = analyze_text(jax.jit(g).lower(*xs).compile().as_text())["flops"]
    w1 = torch.randn(64, 128, requires_grad=True)
    w2 = torch.randn(128, 32, requires_grad=True)
    x = torch.randn(16, 64)

    def tg():
        return torch.autograd.grad(torch.tanh(x @ w1).matmul(w2).sum(),
                                   (w1, w2))
    _, got = analyze(tg)
    assert abs(got["flops"] - want) / want < 0.05, (got, want)
    assert got["static_flops"] == got["flops"]
    assert got["static_collective_total"] == 0

    with OpCounter() as one:
        tg()
    with OpCounter() as ten:
        for _ in range(10):
            tg()
    assert ten.flops == 10 * one.flops
    assert ten.hbm_bytes == 10 * one.hbm_bytes
    assert ten.breakdown(3)["flops"][0][2] == "aten.mm"


@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_model_flops_equal_the_references(arch):
    for shape in SHAPES:
        assert treport.model_flops(arch, shape) == \
            jreport.model_flops(arch, shape)
    assert set(SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("shape,local,offset", [
    ((6, 5, 40), (3, 5, 20), (3, 0, 20)),      # rows and columns: runs
    ((8, 300), (4, 300), (4, 0)),              # rows only: one run
    ((10, 7), (10, 7), (0, 0)),                # the whole leaf
])
def test_a_shards_update_is_the_slice_of_the_whole_update(shape, local,
                                                          offset):
    g = torch.Generator().manual_seed(0)
    th, gr = (torch.randn(shape, generator=g) for _ in range(2))
    mg, ms = (torch.randn(shape, generator=g).to(torch.bfloat16)
              for _ in range(2))
    kw = dict(h=0.01, scale=2.0, f_s=0.5, prior_prec=0.3, alpha=0.7,
              temperature=1.0)
    seed = torch.tensor(12345)
    whole = fused_update_flat(th, gr, seed, mu_g=mg, mu_s=ms,
                              lam_g=torch.tensor(0.4),
                              lam_s=torch.tensor(0.2), **kw)
    sl = tuple(slice(o, o + n) for o, n in zip(offset, local))
    part = update_shard(th[sl].contiguous(), gr[sl].contiguous(),
                        seed, global_shape=shape, offset=offset,
                        mu_g=mg[sl].contiguous(), mu_s=ms[sl].contiguous(),
                        lam_g=torch.tensor(0.4), lam_s=torch.tensor(0.2),
                        **kw)
    assert torch.equal(part, whole[sl])
    bases, run = shard_runs(shape, local, offset)
    assert bases.numel() * run == math.prod(local)


def test_report_bounds_memory_by_arguments_and_outputs_and_marks_reshards():
    info = {"static_flops": 2 * treport.PEAK_FLOPS,
            "static_hbm_bytes": 3 * treport.HBM_BW,
            "static_collective_total": 0.0,
            "argument_size_bytes": 0.5 * treport.HBM_BW,
            "output_size_bytes": 0.25 * treport.HBM_BW,
            "peak_bytes": 2 ** 30}
    terms = treport.row_terms(info)
    assert terms["t_compute"] == 2.0
    assert terms["t_memory"] == 0.75         # arguments + outputs
    assert terms["t_opstream"] == 3.0        # shown, not a bound
    assert terms["dominant"] == "compute"
    results = {"qwen3-1.7b|train_4k|pod1": dict(info, status="ok"),
               "qwen3-1.7b|prefill_32k|pod1": dict(info, status="resharded"),
               "qwen3-1.7b|long_500k|pod1": {"status": "skip"}}
    rows = treport.build_table(results)
    assert [r["status"] for r in rows] == ["ok", "resharded", "skip"]
    assert rows[0]["step_time_bound_ms"] == 2000.0
    table = treport.render(rows).splitlines()
    assert "(resharded)" in table[3] and "(resharded)" not in table[2]


def test_the_anchor_places_the_residual_stream_by_batch(world_of_8_run):
    anchored = {"data": "S(0)", "model": "R"}
    for kind in ("train", "prefill"):
        assert world_of_8_run[f"wide_{kind}"]["status"] == "ok"
        seen = world_of_8_run["anchors"][kind]
        # two periods, each entered once (train: again in the recompute)
        assert len(seen) == (4 if kind == "train" else 2)
        assert all(s == anchored for s in seen), (kind, seen)


def test_a_sharded_train_step_replicates_no_layer(world_of_8_run):
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    one = world_of_8_run["wide_train_one_device"]["static_flops"]
    got = world_of_8_run["wide_train"]["static_flops"]
    ranks = math.prod(w.WIDE_MESH)
    assert got <= 1.10 * one / ranks, (got, one / ranks)


def test_the_sharded_step_counts_the_references_flops(world_of_8_run,
                                                     tmp_path):
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    shape = w.WIDE_SHAPES["train"]
    mesh = ",".join(map(str, w.WIDE_MESH))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "ref_dryrun.py"), "--smoke",
         "--cfg-json", json.dumps(w.WIDE), "--arch", "qwen3-1.7b",
         "--shape", "train_4k", "--batch", str(shape.global_batch),
         "--seq-len", str(shape.seq_len), "--mesh-shape", mesh,
         "--json-out", str(tmp_path / "ref.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    with open(tmp_path / "ref.json") as f:
        (ref,) = json.load(f).values()
    got = world_of_8_run["wide_train"]["static_flops"]
    assert abs(got - ref["static_flops"]) / ref["static_flops"] < 0.10, \
        (got, ref["static_flops"])


def test_a_replicated_token_looks_up_its_vocab_shard(fake_world_run):
    """A decode step of a batch of one (its token replicated) on the
    (2, 2) world: the embedding is looked up on each rank's vocab shard
    and the rows reduced over 'model' (``model._VocabLookup``): no
    all-gather brings the whole vocabulary (96 rows, a size no other dim
    of the model has) to a rank. (Its values and gradient:
    ``test_torch_mesh.py``, on two gloo ranks.)"""
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    info = fake_world_run["lookup_decode"]
    assert info["status"] == "ok", info
    seen = fake_world_run["collectives"]
    vocab = w.LOOKUP["vocab_size"]
    whole = [s for name, s in seen
             if name == "all_gather_into_tensor" and vocab in s]
    assert not whole, whole
    assert any(name in ("all_reduce", "reduce_scatter_tensor")
               for name, _ in seen)


def test_decode_over_slot_shards_gathers_no_scores(fake_world_run):
    """A decode step whose cache's slots are sharded over 'model' (one KV
    head on the (2, 2) world): the softmax is reduced across the slot
    shards (its max, its sum and the unnormalised output all-reduced),
    so no all-gather carries the slot count, whole or per rank."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    info = fake_world_run["slot_decode"]
    assert info["status"] == "ok", info
    seen = fake_world_run["slot_collectives"]
    S = w.SLOT_SHAPE.seq_len
    slots = [s for name, s in seen
             if name == "all_gather_into_tensor" and (S in s or S // 2 in s)]
    assert not slots, slots
    assert sum(name == "all_reduce" for name, _ in seen) >= 2


def test_decode_over_slot_shards_moves_the_references_bytes(
        fake_world_run, tmp_path):
    """The slot-sharded decode step's collective bytes within 1.5x of the
    reference's compiled step (``tools/ref_dryrun.py --smoke`` on the same
    (2, 2) mesh and config, in a process of its own)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    shape = w.SLOT_SHAPE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "ref_dryrun.py"), "--smoke",
         "--cfg-json", json.dumps(w.SLOT), "--arch", "qwen3-1.7b",
         "--shape", "decode_32k", "--batch", str(shape.global_batch),
         "--seq-len", str(shape.seq_len), "--mesh-shape", "2,2",
         "--json-out", str(tmp_path / "ref.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    with open(tmp_path / "ref.json") as f:
        (ref,) = json.load(f).values()
    got = fake_world_run["slot_decode"]["static_collective_total"]
    want = ref["static_collective_total"]
    assert got <= 1.5 * want, (got, want)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_the_rglru_block_gathers_no_sequence(kind, fake_world_run):
    """Two RG-LRU layers at one row per data rank on the (2, 2) world,
    where DTensor shards the sequence over 'model': inside
    ``rglru_forward`` (train: the forward and its recompute) no all-gather
    carries the sequence length, whole or per rank. The conv's halo and
    the scan's carries cross the shards (``layers._SeqShards``), not the
    sequence."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _dryrun_worker as w
    info = fake_world_run[f"rg_{kind}"]
    assert info["status"] == "ok", info
    S = w.RG_SHAPES[kind].seq_len
    seen = fake_world_run["rg_collectives"][kind]
    assert seen, "no collective inside rglru_forward: no shard crossed"
    whole = [s for name, s in seen
             if name == "all_gather_into_tensor" and (S in s or S // 2 in s)]
    assert not whole, whole


@pytest.mark.parametrize("case", ["moe_prefill", "rwkv_train"])
def test_the_moe_and_rwkv_steps_trace_ok(case, fake_world_run,
                                         world_of_8_run):
    info = {**fake_world_run, **world_of_8_run}[case]
    assert info["status"] == "ok", info
    assert info["static_flops"] > 0


def test_compare_lists_the_combinations_whose_status_differs(tmp_path,
                                                             capsys):
    from repro_torch.roofline import compare
    num = {"static_flops": 2.0, "static_hbm_bytes": 3.0,
           "static_collective_total": 4.0, "peak_bytes": 5}
    ref = {f"qwen3-1.7b|{s}|pod1": dict(num, status="ok")
           for s in ("train_4k", "prefill_32k", "decode_32k")}
    port = {"qwen3-1.7b|train_4k|pod1": dict(num, status="ok"),
            "qwen3-1.7b|prefill_32k|pod1": dict(
                num, status="resharded",
                fallback_ops={"aten.view.default": 4}),
            "qwen3-1.7b|decode_32k|pod1": {"status": "fail",
                                           "op": "aten.unbind.int"}}
    for name, res in (("ref", ref), ("port", port)):
        (tmp_path / f"{name}.json").write_text(json.dumps(res))
    compare.main([str(tmp_path / "ref.json"), str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    assert "| qwen3-1.7b | prefill_32k (resharded) | 1.00 |" in out
    assert "| qwen3-1.7b | prefill_32k | ok | resharded | " \
        "aten.view.default x4 |" in out
    assert "| qwen3-1.7b | decode_32k | ok | fail | aten.unbind.int |" in out
    assert "status changed: 2; ok: 3 baseline, 1 optimized" in out
