"""The reference's production dry run (``repro.launch.dryrun``), on meshes
with Auto axes, for holding the port's dry run against it.

Under jax 0.9 ``jax.make_mesh`` makes Explicit axes, on which the
reference's activation constraint (``models.model._shard_batch``) raises,
so ``python -m repro.launch.dryrun`` fails every combination. Its
``lower_one(arch, shape, mesh, sampler)`` and ``analyze(lowered,
compiled)`` take the mesh as an argument: this script builds the
reference's pod meshes with ``axis_types=Auto`` and calls the two,
unedited, for each architecture x shape, writing a JSON with the
reference's keys and ``status`` ('ok', 'skip' or 'fail').

    PYTHONPATH=src python tools/ref_dryrun.py [--arch A] [--shape S] \\
        [--multi-pod] [--mesh-shape D,M] [--json-out F]

then ``python -m repro_torch.roofline.compare ref.json port.json`` for
the ratios. ``--mesh-shape D,M`` takes a (data, model) mesh of D x M host
devices instead of the pod's; ``--smoke`` with ``--cfg-json`` (fields of
the architecture's smoke config to replace) and ``--batch`` /
``--seq-len`` trace a small config at a small shape, as the tests do.
The script imports the JAX package; the port never imports it.
"""
from __future__ import annotations

# sets XLA_FLAGS to 512 host devices: before anything imports jax
import repro.launch.dryrun as rd  # noqa: I001  isort: skip

import argparse
import dataclasses
import json
import sys
import time

import jax

from repro.configs import (ARCH_NAMES, SHAPES, SamplerConfig, get_config,
                           get_smoke_config)

POD_MESHES = {"pod1": ((16, 16), ("data", "model")),
              "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def auto_mesh(shape, names):
    """``jax.make_mesh`` with every axis Auto, as jax < 0.5 made them."""
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))


def run_one(arch: str, shape_name: str, mesh, sampler, *, cfg=None,
            shape=None) -> dict:
    """One combination's info (the reference's ``analyze`` keys, a
    ``status`` and ``compile_s``), or {'status': 'skip'}. ``cfg`` and
    ``shape`` replace the architecture's config and the named shape: the
    reference's ``lower_one`` reads both through its module's
    ``get_config`` and ``SHAPES``, which are swapped for the call."""
    saved = rd.get_config, rd.SHAPES
    if cfg is not None:
        rd.get_config = lambda _: cfg
    if shape is not None:
        rd.SHAPES = dict(rd.SHAPES, **{shape_name: shape})
    t0 = time.time()
    try:
        out = rd.lower_one(arch, shape_name, mesh, sampler)
    finally:
        rd.get_config, rd.SHAPES = saved
    if out == "skip":
        return {"status": "skip"}
    info = rd.analyze(*out)
    info["status"] = "ok"
    info["compile_s"] = round(time.time() - t0, 1)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) multi-pod mesh")
    ap.add_argument("--mesh-shape", default=None,
                    help="D,M: a (data, model) mesh of D x M host devices")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke config")
    ap.add_argument("--cfg-json", default=None,
                    help="JSON of config fields to replace")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch instead of the shape's")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="the sequence length instead of the shape's")
    args = ap.parse_args(argv)

    pod = "pod2" if args.multi_pod else "pod1"
    if args.mesh_shape:
        dims = tuple(int(n) for n in args.mesh_shape.split(","))
        pod = "x".join(map(str, dims))
        mesh = auto_mesh(dims, ("data", "model"))
    else:
        mesh = auto_mesh(*POD_MESHES[pod])
    sampler = SamplerConfig(method="fsgld", num_shards=16)
    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    replace = json.loads(args.cfg_json) if args.cfg_json else {}

    results = {}
    fail = 0
    for arch in archs:
        cfg = None
        if args.smoke or replace:
            base = get_smoke_config(arch) if args.smoke else get_config(arch)
            cfg = dataclasses.replace(base, **replace)
        for shp in shapes:
            tag = f"{arch}|{shp}|{pod}"
            shape = None
            if args.batch or args.seq_len:
                s = SHAPES[shp]
                shape = dataclasses.replace(
                    s, global_batch=args.batch or s.global_batch,
                    seq_len=args.seq_len or s.seq_len)
            try:
                info = run_one(arch, shp, mesh, sampler, cfg=cfg,
                               shape=shape)
            except Exception as e:  # noqa: BLE001 -- reported per combination
                fail += 1
                results[tag] = {"status": "fail", "error": str(e)[:500]}
                print(f"FAIL  {tag}: {type(e).__name__}: {str(e)[:300]}",
                      flush=True)
                continue
            results[tag] = info
            if info["status"] == "skip":
                print(f"SKIP  {tag} (full attention at 524k)", flush=True)
                continue
            print(f"OK    {tag} compile={info['compile_s']}s "
                  f"flops={info['static_flops']:.3e} "
                  f"hbm={info['static_hbm_bytes']:.3e} "
                  f"coll={info['static_collective_total']:.3e} "
                  f"args/dev={info['argument_size_bytes'] / 2**30:.2f}GiB "
                  f"peak/dev={info['peak_bytes'] / 2**30:.2f}GiB",
                  flush=True)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    n = {s: sum(r["status"] == s for r in results.values())
         for s in ("ok", "skip")}
    print(f"done: {n['ok']} ok, {n['skip']} skip, {fail} fail")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
