"""Roofline report generator (counterpart of ``repro.roofline.report``).

Reads the dry run's JSON (``python -m repro_torch.launch.dryrun
--json-out F``: per-DEVICE counts of each rank's local ops) and prints
the roofline table: the three terms in seconds, the dominant one,
MODEL_FLOPS = 6 * N_active * D and the useful-compute ratio, per
(architecture x shape).

The terms, per device: compute is the counted matmul-family FLOPs at
the peak rate; memory is the least traffic the step must make, its
arguments read once and its outputs written once, at the HBM rate;
collective is the collectives' bytes at the link rate. The eager op
stream's traffic (operand + result bytes of every op the rank runs, the
reference's HLO approximation) is shown beside them as ``t_opstream``:
what the port's eager step moves, not a bound. A combination the dry run
could place only by resharding (status 'resharded') keeps its terms,
marked, and is left out of the summary lines: its numbers are those of
another layout than ``sharding.rules``'.

Device constants: one NVIDIA H100 SXM5 (80 GB HBM3, 700 W), from
NVIDIA's datasheet:
    989.4e12 FLOP/s dense bf16  |  3.35e12 B/s HBM3
The collective term takes 50e9 B/s per GPU, one 400 Gb/s NDR
InfiniBand link: a 16-wide mesh axis spans two 8-GPU NVLink nodes, so
its rings cross the slowest link between nodes, not NVLink's 900 GB/s.

    PYTHONPATH=src python -m repro_torch.roofline.report --json F
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 50e9
DEVICES = 256  # one pod: a 16 x 16 mesh


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D for training (forward 2ND + backward 4ND); 2*N*D for the
    inference forward; 2*N_active per generated token for decode. MoE
    counts active parameters. Global across the mesh."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch     # decode: ONE token per row


def row_terms(info: dict) -> dict:
    """Per-device seconds of each roofline term, and of the eager op
    stream's traffic (not a bound)."""
    t_c = info["static_flops"] / PEAK_FLOPS
    t_m = (info["argument_size_bytes"] + info["output_size_bytes"]) / HBM_BW
    t_i = info["static_collective_total"] / LINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_i, "collective"))[1]
    return {"t_compute": t_c, "t_memory": t_m, "t_collective": t_i,
            "dominant": dom, "t_opstream": info["static_hbm_bytes"] / HBM_BW}


def build_table(results: dict, mesh_tag: str = "pod1") -> list:
    devices = DEVICES * (2 if mesh_tag == "pod2" else 1)
    rows = []
    for arch in ARCH_NAMES:
        for shp in SHAPES:
            info = results.get(f"{arch}|{shp}|{mesh_tag}")
            if info is None:
                continue
            if info["status"] not in ("ok", "resharded"):
                rows.append({"arch": arch, "shape": shp,
                             "status": info["status"]})
                continue
            terms = row_terms(info)
            mf = model_flops(arch, shp)
            glob = info["static_flops"] * devices
            rows.append({
                "arch": arch, "shape": shp, "status": info["status"],
                **terms,
                "model_flops": mf, "flops_global": glob,
                "useful_ratio": mf / glob if glob else 0.0,
                "peak_gib": info["peak_bytes"] / 2 ** 30,
                "step_time_bound_ms": 1e3 * max(
                    terms["t_compute"], terms["t_memory"],
                    terms["t_collective"])})
    return rows


def render(rows: list) -> str:
    hdr = ("| arch | shape | t_comp(ms) | t_mem(ms) | t_coll(ms) | "
           "bottleneck | t_opstream(ms) | MODEL_FLOPs | useful | "
           "peak GiB |")
    out = [hdr, "|" + "---|" * 10]
    for r in rows:
        if r["status"] not in ("ok", "resharded"):
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                       f"{r['status']} | - | - | - | - |")
            continue
        mark = " (resharded)" if r["status"] == "resharded" else ""
        out.append(
            f"| {r['arch']} | {r['shape']} | {1e3 * r['t_compute']:.2f} | "
            f"{1e3 * r['t_memory']:.2f} | {1e3 * r['t_collective']:.2f} | "
            f"**{r['dominant']}**{mark} | {1e3 * r['t_opstream']:.2f} | "
            f"{r['model_flops']:.2e} | {r['useful_ratio']:.2f} | "
            f"{r['peak_gib']:.2f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/dryrun_pod1.json")
    ap.add_argument("--mesh-tag", default="pod1")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    rows = build_table(results, args.mesh_tag)
    print(render(rows))
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        return
    worst = min(ok, key=lambda r: r["useful_ratio"])
    coll = max(ok, key=lambda r: r["t_collective"]
               / max(r["t_compute"], 1e-12))
    print(f"\nworst useful-ratio: {worst['arch']}|{worst['shape']} "
          f"({worst['useful_ratio']:.2f})")
    print(f"most collective-bound: {coll['arch']}|{coll['shape']} "
          f"(t_coll/t_comp="
          f"{coll['t_collective'] / max(coll['t_compute'], 1e-12):.2f})")


if __name__ == "__main__":
    main()
