"""Time the local-SGLD surrogate fit at the Table-1 model's size.

    python3 tools/fit_timing.py [--src DIR] [--label NAME] [--device cuda]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two trees (a change and its parent, unpacked with ``git
archive``) can be timed by one command, in the order A, B, B, A. Fits a
'scalar' bank with ``fit_bank_local_sgld`` for the Table-1 BNN on S = 10
and S = 30 clients of 20,000 SUSY-like rows (minibatch 50, h = 1e-5,
200 fit steps: ``SurrogateSpec``'s defaults for fit='local_sgld') and
prints the median of 5 timed fits after one warm-up (host clock, the
device synchronised), one line each, then one JSON line of them. Where
the tree has a trace budget (``api.FIT_TRACE_BYTES``), the fit is timed
also with the budget set to 0 (one client at a time).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="as_is")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch import api
    from repro_torch.data import susy_shards
    from repro_torch.workloads import TABLE1_P, table1_log_lik
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    default = getattr(api, "FIT_TRACE_BYTES", None)
    budgets = [default] + ([0] if default is not None else [])
    rows = []
    for S in (10, 30):
        g = torch.Generator(device=dev).manual_seed(0)
        shards, _ = susy_shards(g, num_shards=S, shard_size=20_000,
                                beta_a=0.5)
        theta0 = 0.1 * torch.randn(TABLE1_P, generator=g, device=dev)
        for budget in budgets:
            if budget is not None:
                api.FIT_TRACE_BYTES = budget
            times = []
            for rep in range(6):
                sync()
                t0 = time.perf_counter()
                api.fit_bank_local_sgld(
                    table1_log_lik, shards, theta0,
                    torch.Generator(device=dev).manual_seed(rep),
                    fit_steps=200, minibatch=50, step_size=1e-5)
                sync()
                if rep:
                    times.append(time.perf_counter() - t0)
            ms = 1e3 * statistics.median(times)
            how = "default" if budget == default else f"budget {budget}"
            print(f"fit_timing {args.label} S={S} ({how}): {ms:.2f} ms "
                  f"(runs {', '.join(f'{1e3 * t:.2f}' for t in times)})",
                  flush=True)
            rows.append({"label": args.label, "S": S, "budget": budget,
                         "ms": ms})
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
