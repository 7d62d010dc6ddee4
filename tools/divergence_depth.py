"""At which depth does FSGLD on qwen3-1.7b (or ``--arch``) leave theta0
at the train driver's defaults, and what device memory does each depth
take?

    python3 tools/divergence_depth.py [--arch qwen3-1.7b]
                                      [--depths 1 2 4 8 28] [--step-size 1e-5]
                                      [--out chiprun_out/divergence_depth]

Runs ``repro_torch.launch.train`` on the card at the reference driver's
defaults (the model at full width, S = 4 clients x 64 x 128 tokens,
minibatch 8, a 'scalar' bf16 bank from 20 local-SGLD fit steps, C = 1,
5 rounds x 4 packed steps) and step size ``--step-size``, with the model
cut to each of ``--depths`` layers (``dataclasses.replace(cfg,
num_layers=...)``; 28 is qwen3-1.7b's full depth). Each run has ``--metrics-dir
OUT/L<depth> --log-every 1``, so it leaves one telemetry frame
(``metrics.jsonl``) per depth.

Prints per depth ll/token at theta0 and after sampling and, per round,
the frame's drift_norm, conducive_norm, grad_norm, log_post and the
probe's ll/token (log_post plus the prior's 1/2 |theta|^2, over the
probe's tokens). Then names the first depth whose chain ends more than 1
nat per token below theta0, the first round whose probe ll/token falls
more than 1 nat below theta0's, and conducive_norm against grad_norm at
that round. The last line is one JSON object of these numbers (also
written to OUT/divergence_depth.json).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

GUARD = 1.0   # nats per token below theta0


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_depth(arch: str, depth: int, h: float, out: str, device) -> dict:
    from repro_torch.launch import train
    real = train.get_config

    def cut(arch):
        cfg = real(arch)
        return cfg if depth == cfg.num_layers else dataclasses.replace(
            cfg, num_layers=depth)

    argv = ["--arch", arch, "--step-size", repr(h), "--metrics-dir",
            os.path.join(out, f"L{depth}"), "--log-every", "1"]
    if device is not None:
        argv += ["--device", device]
    args = train.parse_args(argv)
    train.get_config = cut
    t0 = time.perf_counter()
    try:
        tr = train.run(args)
    finally:
        train.get_config = real
    seconds = time.perf_counter() - t0
    f = tr.frame.metrics
    tokens = args.batch * args.seq       # the probe's minibatch tokens
    probe_ll = [float((f["log_post"][r, 0] + 0.5 * f["theta_norm"][r, 0]
                       ** 2) / tokens) for r in range(tr.frame.rounds)]
    row = {"depth": depth, "ll0": tr.ll0, "ll": tr.lls[0],
           "seconds": seconds, "peak_gb": tr.peak_gb,
           "probe_ll": probe_ll,
           **{k: [float(v) for v in f[k][:, 0]]
              for k in ("drift_norm", "conducive_norm", "grad_norm",
                        "log_post", "theta_norm")}}
    del tr
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4, 8, 28])
    ap.add_argument("--step-size", type=float, default=1e-5)
    ap.add_argument("--out", default="chiprun_out/divergence_depth")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(card(), flush=True)
    rows = []
    for depth in args.depths:
        print(f"== {args.arch}, {depth} layer(s), h {args.step_size:g}",
              flush=True)
        row = run_depth(args.arch, depth, args.step_size, args.out,
                        args.device)
        rows.append(row)
        print(f"depth {depth}: ll/token theta0 {row['ll0']:.4f} -> "
              f"{row['ll']:.4f} ({row['seconds']:.1f} s, peak "
              f"{row['peak_gb']})", flush=True)
        for r in range(len(row["probe_ll"])):
            print(f"  round {r}: drift {row['drift_norm'][r]:.6g} conducive "
                  f"{row['conducive_norm'][r]:.6g} grad "
                  f"{row['grad_norm'][r]:.6g} log_post "
                  f"{row['log_post'][r]:.6g} probe ll/token "
                  f"{row['probe_ll'][r]:.4f}", flush=True)
    first = next((r for r in rows if r["ll"] < r["ll0"] - GUARD), None)
    result = {"card": card(), "arch": args.arch,
              "step_size": args.step_size, "guard": GUARD,
              "rows": rows, "first_depth": None}
    if first is not None:
        rnd = next((i for i, v in enumerate(first["probe_ll"])
                    if v < first["ll0"] - GUARD), None)
        result.update(first_depth=first["depth"], first_round=rnd)
        if rnd is not None:
            result["conducive_over_grad"] = (first["conducive_norm"][rnd]
                                             / first["grad_norm"][rnd])
        print(f"first depth more than {GUARD} nat/token below theta0: "
              f"{first['depth']} layer(s); its probe first falls below at "
              f"round {rnd}"
              + (f"; conducive_norm / grad_norm there "
                 f"{result['conducive_over_grad']:.6g}"
                 if rnd is not None else ""), flush=True)
    else:
        print(f"no depth ends more than {GUARD} nat/token below theta0",
              flush=True)
    with open(os.path.join(args.out, "divergence_depth.json"), "w") as fh:
        json.dump(result, fh)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
