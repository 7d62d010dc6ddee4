"""The dry run on a fake world, for ``tests/test_torch_dryrun.py`` (a
fake world is process-global, so each world runs in a process of its
own):

    python tests/_dryrun_worker.py OUT.json [4 | 8]

On a world of 4 ranks, the (2, 2) ('data', 'model') mesh: qwen3's smoke
config (d 64, one layer) at small train, prefill and decode shapes and
the long-context shape's skip, the MoE smoke config's prefill at
``MOE_SHAPE``, and at ``LOOKUP`` (a vocabulary of 96, which no other
dim of the model has) a decode step of a batch of one, whose token is
replicated, with every collective's output shape recorded
(``collectives``); at ``SLOT`` (one KV head, which does not split 2
ways, so the cache's ``SLOT_SHAPE.seq_len`` slots are sharded over
'model') a decode step, its collectives recorded (``slot_collectives``);
and the recurrentgemma smoke config cut to two RG-LRU layers
(``RG_LAYERS``) at ``RG_SHAPES`` (one row per data rank, so that DTensor
shards the sequence over 'model'), the collectives issued inside
``rglru_forward`` recorded (``rg_collectives``). On a world of 8 ranks: qwen3 at ``WIDE`` (d 256, two
layers, where matrix products dominate the count; 2 KV heads, which do
not split 4 ways) on the (2, 4) ('data', 'model') mesh at
``WIDE_SHAPES``, its train step also on one device (no mesh), with the
placement of the residual stream at the entry of every attending layer
recorded (``anchors``); and the RWKV smoke config's train step at
``RWKV_SHAPE`` on the (2, 2, 2) ('pod', 'data', 'model') mesh. Writes
each combination's info (or 'skip', or {'status': 'fail', 'error'}) as
JSON, with a ``status``: 'ok'."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SamplerConfig, get_smoke_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CFG = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
           vocab_size=128, num_layers=1)
SHAPES = {"train": InputShape("train", seq_len=32, global_batch=4,
                              kind="train"),
          "prefill": InputShape("prefill", seq_len=32, global_batch=4,
                                kind="prefill"),
          "decode": InputShape("decode", seq_len=32, global_batch=4,
                               kind="decode"),
          "long_500k": "long_500k"}
# one chunk of the head's 512 and one key block: the reference pads
# neither, so both counters see the same products
WIDE = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
            d_ff=1024, vocab_size=512, num_layers=2)
WIDE_MESH = (2, 4)
WIDE_SHAPES = {kind: InputShape(kind, seq_len=512, global_batch=8, kind=kind)
               for kind in ("train", "prefill")}
# one batch row per data rank, two token groups of 512 per row
MOE_SHAPE = InputShape("prefill", seq_len=1024, global_batch=2,
                       kind="prefill")
# one batch row per (pod, data) rank, eight chunks of 64
RWKV_SHAPE = InputShape("train", seq_len=512, global_batch=4, kind="train")
SAMPLER = SamplerConfig(method="fsgld", num_shards=16)
# a batch of one: its tokens replicated, the embedding looked up by
# ``model._VocabLookup``
LOOKUP = dict(CFG, vocab_size=96)
LOOKUP_SHAPE = InputShape("decode", seq_len=32, global_batch=1,
                          kind="decode")
# one KV head on a model axis of 2: the cache's 4,096 slots (2,048 per
# rank, a size no other dim of the model has) sharded over 'model'
SLOT = dict(CFG, num_kv_heads=1)
SLOT_SHAPE = InputShape("decode", seq_len=4096, global_batch=4,
                        kind="decode")
# two RG-LRU layers; 96 positions (48 per rank), a size no other dim has
RG_LAYERS = dict(layer_pattern=("rglru", "rglru"), num_layers=2)
RG_SHAPES = {kind: InputShape(kind, seq_len=96, global_batch=2, kind=kind)
             for kind in ("prefill", "train")}


def _trace(arch, shape, mesh, cfg):
    try:
        info = dryrun.lower_one(arch, shape, mesh, SAMPLER, cfg=cfg)
    except Exception as e:  # noqa: BLE001 -- recorded per combination
        return {"status": "fail", "op": dryrun._failed_op(e),
                "error": f"{type(e).__name__}: {str(e)[:500]}"}
    if isinstance(info, dict):
        info["status"] = "ok"
    return info


def _recording_anchors(fn):
    """``fn()`` with the placements of every attending layer's input x
    recorded: [{mesh dim name: placement}, ...]."""
    seen = []
    attending = M._attending

    def record(kind, x, *args, **kwargs):
        if hasattr(x, "placements"):
            seen.append({n: str(p) for n, p in zip(
                x.device_mesh.mesh_dim_names, x.placements)})
        return attending(kind, x, *args, **kwargs)
    M._attending = record
    try:
        return fn(), seen
    finally:
        M._attending = attending


def _recording_collectives(fn, inside=None):
    """``fn()`` with every collective the op counter sees recorded:
    [[op name, output shape], ...]; with ``inside`` (a function of
    ``models.layers``, by name) only those issued while it runs."""
    from repro_torch.models import layers as L
    from repro_torch.roofline import hlo_analysis as H
    seen = []
    count = H.OpCounter._count
    depth = [0 if inside else 1]

    def record(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        if depth[0] and func.namespace == "_c10d_functional" \
                and name in H._COLLECTIVES:
            seen.append([name, list(getattr(out, "shape", ()))])
        return count(self, func, args, kwargs, out)
    H.OpCounter._count = record
    if inside:
        block = getattr(L, inside)

        def within(*args, **kwargs):
            depth[0] += 1
            try:
                return block(*args, **kwargs)
            finally:
                depth[0] -= 1
        setattr(L, inside, within)
    try:
        return fn(), seen
    finally:
        H.OpCounter._count = count
        if inside:
            setattr(L, inside, block)


def world_of_8(out: dict) -> None:
    mesh = dryrun.make_pod_mesh(WIDE_MESH, ("data", "model"))
    wide = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **WIDE)
    out["anchors"] = {}
    for kind, shape in WIDE_SHAPES.items():
        out[f"wide_{kind}"], out["anchors"][kind] = _recording_anchors(
            lambda: _trace("qwen3-1.7b", shape, mesh, wide))
    out["wide_train_one_device"] = _trace("qwen3-1.7b", WIDE_SHAPES["train"],
                                          None, wide)
    pod = dryrun.make_pod_mesh((2, 2, 2), ("pod", "data", "model"))
    out["rwkv_train"] = _trace("rwkv6-7b", RWKV_SHAPE, pod,
                               get_smoke_config("rwkv6-7b"))


def world_of_4(out: dict) -> None:
    mesh = dryrun.make_pod_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **CFG)
    for name, shape in SHAPES.items():
        out[name] = dryrun.lower_one("qwen3-1.7b", shape, mesh, SAMPLER,
                                     cfg=cfg)
    out["moe_prefill"] = _trace("phi3.5-moe-42b-a6.6b", MOE_SHAPE, mesh,
                                get_smoke_config("phi3.5-moe-42b-a6.6b"))
    lookup = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **LOOKUP)
    out["lookup_decode"], out["collectives"] = _recording_collectives(
        lambda: _trace("qwen3-1.7b", LOOKUP_SHAPE, mesh, lookup))
    slot = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **SLOT)
    out["slot_decode"], out["slot_collectives"] = _recording_collectives(
        lambda: _trace("qwen3-1.7b", SLOT_SHAPE, mesh, slot))
    rg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                             **RG_LAYERS)
    out["rg_collectives"] = {}
    for kind, shape in RG_SHAPES.items():
        out[f"rg_{kind}"], out["rg_collectives"][kind] = \
            _recording_collectives(
                lambda: _trace("recurrentgemma-2b", shape, mesh, rg),
                inside="rglru_forward")


def main() -> int:
    out = {}
    world = sys.argv[2] if len(sys.argv) > 2 else "4"
    {"4": world_of_4, "8": world_of_8}[world](out)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
