"""Before/after roofline comparison (counterpart of
``repro.roofline.compare``): two dry-run JSONs -> a markdown table of
the ratios, the grid totals, and a table of the combinations whose
status differs (with the second file's fallback ops), so a FAIL or a
RESHARD against an OK is listed, not skipped. The first file may be the
reference's grid (``tools/ref_dryrun.py``), the second the port's.

    PYTHONPATH=src python -m repro_torch.roofline.compare \\
        before.json after.json [--mesh-tag pod1]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_NAMES, SHAPES

KEYS = ("static_flops", "static_hbm_bytes", "static_collective_total")
# statuses with numbers to compare ('resharded': placed by the dry run's
# fallbacks, marked in the table)
MEASURED = ("ok", "resharded")


def _ops(info: dict) -> str:
    ops = info.get("fallback_ops") or {}
    if ops:
        return ", ".join(f"{op} x{n}" for op, n in sorted(ops.items()))
    return info.get("op", "")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("optimized")
    ap.add_argument("--mesh-tag", default="pod1")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        base = json.load(f)
    with open(args.optimized) as f:
        opt = json.load(f)

    print("| arch | shape | flops o/b | hbm o/b | coll o/b | peak o/b |")
    print("|---|---|---|---|---|---|")
    tot = {k: [0.0, 0.0] for k in KEYS}
    changed = []
    for arch in ARCH_NAMES:
        for shp in SHAPES:
            tag = f"{arch}|{shp}|{args.mesh_tag}"
            b, o = base.get(tag), opt.get(tag)
            if not (b and o):
                continue
            if b.get("status") != o.get("status"):
                changed.append((arch, shp, b, o))
            if not (b.get("status") in MEASURED
                    and o.get("status") in MEASURED):
                continue

            def ratio(k):
                return o[k] / (b[k] if b[k] else 1.0)
            for k in tot:
                tot[k][0] += b[k]
                tot[k][1] += o[k]
            mark = " (resharded)" if "resharded" in (b["status"],
                                                    o["status"]) else ""
            print(f"| {arch} | {shp}{mark} | {ratio('static_flops'):.2f} | "
                  f"{ratio('static_hbm_bytes'):.2f} | "
                  f"{ratio('static_collective_total'):.2f} | "
                  f"{o['peak_bytes'] / max(b['peak_bytes'], 1):.2f} |")
    print()
    for k, (bsum, osum) in tot.items():
        if osum < bsum:
            print(f"grid total {k}: {bsum:.3e} -> {osum:.3e} "
                  f"({bsum / max(osum, 1e-9):.2f}x better)")
        else:
            print(f"grid total {k}: {bsum:.3e} -> {osum:.3e} "
                  f"({osum / max(bsum, 1e-9):.2f}x worse)")
    print()
    print("| arch | shape | baseline | optimized | optimized's ops |")
    print("|---|---|---|---|---|")
    for arch, shp, b, o in changed:
        print(f"| {arch} | {shp} | {b.get('status')} | {o.get('status')} "
              f"| {_ops(o)} |")
    tags = [t for t in opt if t.endswith(f"|{args.mesh_tag}")]

    def n_ok(res):
        return sum(res[t].get("status") == "ok" for t in tags if t in res)
    print(f"\nstatus changed: {len(changed)}; ok: {n_ok(base)} baseline, "
          f"{n_ok(opt)} optimized")


if __name__ == "__main__":
    main()
