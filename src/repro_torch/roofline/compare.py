"""Before/after roofline comparison (counterpart of
``repro.roofline.compare``): two dry-run JSONs -> a markdown table of
the ratios and the grid totals.

    PYTHONPATH=src python -m repro_torch.roofline.compare \\
        before.json after.json [--mesh-tag pod1]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_NAMES, SHAPES

KEYS = ("static_flops", "static_hbm_bytes", "static_collective_total")


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
    for arch in ARCH_NAMES:
        for shp in SHAPES:
            tag = f"{arch}|{shp}|{args.mesh_tag}"
            b, o = base.get(tag), opt.get(tag)
            if not (b and o and b.get("status") == "ok"
                    and o.get("status") == "ok"):
                continue

            def ratio(k):
                return o[k] / (b[k] if b[k] else 1.0)
            for k in tot:
                tot[k][0] += b[k]
                tot[k][1] += o[k]
            print(f"| {arch} | {shp} | {ratio('static_flops'):.2f} | "
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


if __name__ == "__main__":
    main()
