"""Production dry run (counterpart of ``repro.launch.dryrun``): for every
(architecture x input shape) the step function is traced on the
production pod, laid out by ``sharding.rules``, without a device; the
per-device memory proves the layout fits, the op counts feed the
roofline table (``roofline.report``).

Where the reference lowers and compiles with XLA on 512 simulated host
devices, the port starts a FAKE process group (``torch.distributed``'s
"fake" backend: every collective is a no-op with the right shapes) of
256 ranks, or 512 with ``--multi-pod``, builds the reference's fixed pod
mesh on it, (16, 16) ('data', 'model') or (2, 16, 16) ('pod', 'data',
'model') (the launched runs' ``make_production_mesh`` is (W, 1); this
one launches nothing), and runs the step once under ``FakeTensorMode``
on DTensors whose local shards are fake tensors of rank 0's shapes:

  * train (train_4k):  ``launch.steps.make_train_step`` (scale 1e6,
    f_s = 1 / num_shards), parameters and surrogate means by
    ``param_specs``, the batch by ``batch_specs``;
  * prefill:           ``make_prefill_step``;
  * decode:            ``make_serve_step`` with bf16 parameters by
    ``param_specs(serve=True)`` and the cache by ``cache_specs``.

``roofline.hlo_analysis.OpCounter`` counts each rank's local ops (FLOPs,
HBM bytes, the collectives DTensor issues) and
``torch.distributed._tools.mem_tracker.MemTracker`` their memory.
Plain tensors the model code makes (positions, masks) are replicated
(``implicit_replication``). An op DTensor cannot place in the rules'
layout fails the combination with the op's name: the model places its
operands itself on a pod mesh (``models.model``), on torch 2.11 as on
2.13. A fake world is process-global: a process that already holds a
process group runs this in a subprocess.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k [--multi-pod] [--json-out F]

Output keys per combination: the analyzer's (``flops``,
``static_flops``, ``static_hbm_bytes``, ``static_collective_bytes``,
``static_collective_total``), ``argument_size_bytes`` (the local shards
of every argument), ``output_size_bytes``, ``peak_bytes`` (the tracked
high-water mark, arguments included), ``temp_size_bytes`` (peak less
arguments), ``trace_s`` (the reference's ``compile_s``), with
``--breakdown N`` ``breakdown`` (``OpCounter.breakdown(N)``), and
``status`` ('ok', 'skip' or 'fail'). Exit code 1 if any combination
fails.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.configs import (ARCH_NAMES, SHAPES, SamplerConfig,
                                 get_config)
from repro_torch.configs.base import InputShape
from repro_torch.launch.specs import (input_specs, long_context_eligible,
                                      params_shape, train_batch_specs)
from repro_torch.launch.steps import (local_shape_and_offset,
                                      make_prefill_step, make_serve_step,
                                      make_surrogate_state, make_train_step)
from repro_torch.sharding import rules

POD_MESHES = {"pod1": ((16, 16), ("data", "model")),
              "pod2": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """Start a fake process group of ``world`` ranks in this process (this
    process is rank 0); one that exists already must be that one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(
            "the dry run needs a fake process group of its own (a fake "
            "world is process-global): run it in a fresh process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_pod_mesh(shape=(16, 16), names=("data", "model")):
    """A mesh of ``shape`` over a fake world of its size, on device type
    'cpu' (the shards are fake tensors)."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


_PATCHED: list = []


def _patch_dtensor() -> None:
    """Keep DTensor's bookkeeping out of the dry run's modes. DTensor
    computes a shard's shape and offsets with tensor ops (the rank's mesh
    coordinate; a strided shard's arange, split and tolist), which under
    FakeTensorMode would be fake and the scalars read from them
    data-dependent; and it finds each op's output metadata by running
    the op at the GLOBAL shape in the active fake mode, where the op
    counter and the memory tracker would take it for the rank's work.
    Both run outside every dispatch mode here (the metadata pass in a
    fake mode of its own): neither is the step's work."""
    if _PATCHED:
        return
    import importlib

    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def outside_modes(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    def memoized(fn):
        # a strided shard's offsets depend on its arguments alone, and
        # DTensor's redistribution planner asks for the same ones
        # thousands of times on a 3-D mesh (an arange of the dim each)
        memo = {}

        def run(self, *args, **kwargs):
            key = (self, args, tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = fn(self, *args, **kwargs)
            return memo[key]
        return run

    # the cost of a redistribution depends on the two specs alone; the
    # strategy search asks for the same ones over and over
    for mod in ("_collective_utils", "_ops.utils", "_utils"):
        try:
            m = importlib.import_module(f"torch.distributed.tensor.{mod}")
        except ImportError:
            continue
        if hasattr(m, "redistribute_cost"):
            m.redistribute_cost = _memo_cost(m.redistribute_cost)
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if hasattr(_StridedShard, "local_shard_size_and_offset"):  # private
        _StridedShard.local_shard_size_and_offset = memoized(outside_modes(
            _StridedShard.local_shard_size_and_offset))
    if hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        ShardingPropagator._propagate_tensor_meta_non_cached = \
            outside_modes(
                ShardingPropagator._propagate_tensor_meta_non_cached)
    name = "compute_local_shape_and_global_offset"
    for mod in ("_utils", "_api", "_nonlinear_redux", "_sharding_prop",
                "placement_types", "_ops._matrix_ops", "_ops._math_ops",
                "_ops._common_rules"):
        try:
            m = importlib.import_module(f"torch.distributed.tensor.{mod}")
        except ImportError:
            continue
        if hasattr(m, name):
            setattr(m, name, outside_modes(getattr(m, name)))
    # a sharded lookup's mask is checked against the one materialized
    # before it with torch.equal, which fake masks cannot answer; and a
    # gather's mask has its output's shape, which older DTensors apply
    # as an embedding's (one dim fewer)
    for mod in ("_ops._mask_buffer", "_ops._embedding_ops",
                "placement_types"):
        try:
            m = importlib.import_module(f"torch.distributed.tensor.{mod}")
        except ImportError:
            continue
        cls = getattr(m, "MaskBuffer", None)
        if cls is not None and hasattr(cls, "materialize_mask"):
            cls.materialize_mask = _fake_tolerant(cls.materialize_mask)
            cls.apply_mask = _apply_mask
    _PATCHED.append(True)


def _apply_mask(self, tensor):
    """Zero the masked lookups of ``tensor``: the mask covers it element
    for element (a gather's, possibly with the trailing one dropped
    since) or row for row (an embedding's)."""
    mask = self.data
    if mask.numel() == tensor.numel():
        tensor[mask.reshape(tensor.shape)] = 0.0
    else:
        tensor[mask, :] = 0.0


_COSTS: dict = {}


# the estimate of a redistribution into or out of a strided shard (us):
# above any real one, so the strategy search takes such a layout only
# where nothing else places the op
STRIDED_COST = 1e9


def _unstrided(spec):
    """``spec`` with each strided shard as the plain shard of its dim, or
    None where it has none."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard
    pl = tuple(Shard(p.dim) if isinstance(p, _StridedShard) else p
               for p in spec.placements)
    if pl == tuple(spec.placements):
        return None
    return DTensorSpec(spec.mesh, pl, tensor_meta=spec.tensor_meta)


def _memo_cost(cost):
    """The redistribution cost memoized, and a redistribution into or out
    of a strided shard estimated as ``STRIDED_COST`` plus its plain
    counterpart's cost: DTensor costs it exactly by a graph search over
    placements (~0.2-0.5 s per pair on a 3-D mesh, and one strategy
    search asks for hundreds), and its view of a strided shard may take
    the wrong local shape. The redistribution itself, where one is made,
    is planned exactly."""
    def run(current, target):
        try:
            key = (hash(current), hash(target), current, target)
        except TypeError:                 # an unhashable spec: no memo
            return cost(current, target)
        if key not in _COSTS:
            a, b = _unstrided(current), _unstrided(target)
            if (a is None and b is None) or current == target:
                _COSTS[key] = cost(current, target)
            else:
                _COSTS[key] = STRIDED_COST + cost(a or current, b or target)
        return _COSTS[key]
    return run


def _fake_tolerant(materialize):
    from torch._subclasses.fake_tensor import is_fake

    def run(self, mask):
        if getattr(self, "refcount", 0) and is_fake(mask):
            self.refcount += 1      # shapes only: nothing to compare
            return None
        return materialize(self, mask)
    return run


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------

def _spec_of(specs, name: str):
    node = specs
    for k in name.split("/"):
        node = node[k]
    return node


def _contig(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _placed(tree, specs, mesh, dtype=None):
    """Each meta leaf of ``tree`` as a DTensor over a fake local shard,
    placed by its spec in ``specs`` (a tree of ``P``s, or one ``P``); with
    ``mesh`` a mapping (one device), as a plain fake tensor."""
    from torch.distributed.tensor import DTensor
    leaves, treedef = tu.flatten(tree)
    names = [n for n, _ in tu.leaves_with_names(tree)]
    out = []
    for name, t in zip(names, leaves):
        dt = dtype if dtype is not None and t.is_floating_point() \
            else t.dtype
        if isinstance(mesh, dict):
            out.append(torch.empty(tuple(t.shape), dtype=dt))
            continue
        spec = specs if isinstance(specs, rules.P) else _spec_of(specs, name)
        pl = rules.placements(spec, mesh)
        local, _ = local_shape_and_offset(t.shape, mesh, pl)
        out.append(DTensor.from_local(
            torch.empty(tuple(local), dtype=dt), mesh, pl, run_check=False,
            shape=t.shape, stride=_contig(tuple(t.shape))))
    return tu.unflatten(treedef, out)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tu.leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _step_and_args(cfg, shape: InputShape, mesh, sampler: SamplerConfig):
    """(step function, its arguments) of ``shape``'s kind, the arguments
    DTensors over fake shards."""
    pshape = params_shape(cfg)
    if shape.kind == "decode":
        # serving reads bf16 draws (cast once at export)
        pspecs = rules.param_specs(pshape, mesh, serve=True)
        params = _placed(pshape, pspecs, mesh, dtype=torch.bfloat16)
        ins = input_specs(cfg, shape)
        cache = _placed(ins["cache"], rules.cache_specs(ins["cache"], mesh),
                        mesh)
        tok = rules.batch_specs({"token": ins["token"], "pos": ins["pos"]},
                                mesh)
        args = [params, cache,
                _placed(ins["token"], tok["token"], mesh),
                _placed(ins["pos"], tok["pos"], mesh)]
        if "enc_out" in ins:
            args.append(_placed(ins["enc_out"], rules.batch_specs(
                {"e": ins["enc_out"]}, mesh)["e"], mesh))
        return make_serve_step(cfg), args
    pspecs = rules.param_specs(pshape, mesh)
    params = _placed(pshape, pspecs, mesh)
    batch = train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        batch.pop("labels")
        return make_prefill_step(cfg), [
            params, _placed(batch, rules.batch_specs(batch, mesh), mesh)]
    surr_shape = make_surrogate_state(pshape)
    surr = {"mu_g": _placed(surr_shape["mu_g"], pspecs, mesh),
            "mu_s": _placed(surr_shape["mu_s"], pspecs, mesh),
            "lam_g": _placed(surr_shape["lam_g"], rules.P(), mesh),
            "lam_s": _placed(surr_shape["lam_s"], rules.P(), mesh)}
    step = make_train_step(cfg, sampler, scale=1_000_000.0,
                           f_s=1.0 / sampler.num_shards)
    # the seeds come from a generator (no argument bytes; the
    # reference's key is an 8-byte argument)
    return step, [params, surr,
                  _placed(batch, rules.batch_specs(batch, mesh), mesh),
                  torch.Generator().manual_seed(0)]


ONE_DEVICE = {"data": 1, "model": 1}


def lower_one(arch: str, shape, mesh, sampler: SamplerConfig, *,
              cfg=None, breakdown: int = 0):
    """Trace one (arch, shape, mesh) combination on fake shards: its info
    dict, or the string 'skip' for an ineligible pair. ``shape`` is a
    name of ``SHAPES`` or an ``InputShape``; ``cfg`` overrides the
    architecture's config (a cut depth, say). ``mesh`` None traces the
    one-device step on plain fake tensors (no process group needed).
    ``breakdown`` > 0 adds the op counter's top ops (``breakdown``)."""
    mesh = ONE_DEVICE if mesh is None else mesh
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline.hlo_analysis import OpCounter

    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.name == "long_500k" and not long_context_eligible(cfg):
        return "skip"
    _patch_dtensor()
    fa.register_dtensor_rules()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
        step, args = _step_and_args(cfg, shape, mesh, sampler)
        arg_bytes = _local_bytes(args)
        tracker = MemTracker()
        tracker.track_external(*[t.to_local() if hasattr(t, "to_local")
                                 else t for t in tu.leaves(args)
                                 if isinstance(t, torch.Tensor)])
        counter = OpCounter()
        try:
            with tracker, counter:
                out = step(*args)
        except Exception as e:
            e.last_op = counter.last
            raise
        peak = max(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
        out_bytes = _local_bytes(out)
    info = counter.result()
    info.update(argument_size_bytes=arg_bytes, output_size_bytes=out_bytes,
                peak_bytes=peak, temp_size_bytes=max(0, peak - arg_bytes),
                trace_s=round(time.time() - t0, 1))
    if breakdown:
        info["breakdown"] = counter.breakdown(breakdown)
    return info


def _failed_op(e: BaseException) -> str:
    """The op a failure names (DTensor's 'Operator X does not have a
    sharding strategy', a sharding propagation failure, ...), else the op
    dispatched last before it, else the exception's type."""
    import re
    m = re.search(r"(aten\.[\w.]+|repro_torch\.[\w.]+|_c10d_functional"
                  r"\.[\w.]+)", str(e))
    if m:
        return m.group(1)
    last = getattr(e, "last_op", None)
    return str(last) if last is not None else type(e).__name__


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="D,M: a (data, model) mesh of D x M fake ranks "
                         "instead of the pod's (one card: 1,1)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch instead of the shape's")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="the sequence length instead of the shape's")
    ap.add_argument("--breakdown", type=int, default=0, metavar="N",
                    help="print and keep each trace's top N ops by "
                         "FLOPs, collective and HBM bytes")
    args = ap.parse_args(argv)

    pod = "pod2" if args.multi_pod else "pod1"
    if args.mesh_shape:
        shape = tuple(int(n) for n in args.mesh_shape.split(","))
        pod = "x".join(map(str, shape))
        mesh = make_pod_mesh(shape, ("data", "model"))
    else:
        mesh = make_pod_mesh(*POD_MESHES[pod])
    sampler = SamplerConfig(method="fsgld", num_shards=16)
    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    results = {}
    fail = 0
    t_all = time.time()
    for arch in archs:
        for shp in shapes:
            tag = f"{arch}|{shp}|{pod}"
            shape = SHAPES[shp]
            if args.batch or args.seq_len:
                shape = dataclasses.replace(
                    shape, global_batch=args.batch or shape.global_batch,
                    seq_len=args.seq_len or shape.seq_len)
            try:
                info = lower_one(arch, shape, mesh, sampler,
                                 breakdown=args.breakdown)
                if info == "skip":
                    print(f"SKIP  {tag} (full attention at 524k)",
                          flush=True)
                    results[tag] = {"status": "skip"}
                    continue
                info["status"] = "ok"
                results[tag] = info
                print(f"OK    {tag} "
                      f"trace={info['trace_s']}s "
                      f"flops={info['static_flops']:.3e} "
                      f"hbm={info['static_hbm_bytes']:.3e} "
                      f"coll={info['static_collective_total']:.3e} "
                      f"args/dev={info['argument_size_bytes']/2**30:.2f}GiB "
                      f"peak/dev={info['peak_bytes']/2**30:.2f}GiB",
                      flush=True)
                for kind, rows in info.get("breakdown", {}).items():
                    for amount, calls, op in rows:
                        print(f"  {kind:11s} {amount:.3e} {calls:6d} {op}",
                              flush=True)
            except Exception as e:  # noqa: BLE001 -- reported per combination
                fail += 1
                op = _failed_op(e)
                results[tag] = {"status": "fail", "op": op,
                                "error": str(e)[:500]}
                print(f"FAIL  {tag}: {op}: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:300] if str(e) else ''}",
                      flush=True)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    n = collections.Counter(r["status"] for r in results.values())
    print(f"done: {n['ok']} ok, {n['skip']} skip, {fail} fail in "
          f"{time.time() - t_all:.1f} s")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
