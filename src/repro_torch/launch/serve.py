"""Thin CLI over the serving facade: K posterior draws, one ensemble
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --draws 4 --batch 4 --prompt-len 32 --gen 16 [--smoke] [--device cpu]

Serves on CUDA unless ``--device cpu`` asks for the CPU. The mechanics
live behind ``repro_torch.api.Serving`` + ``FSGLD.serve`` (shared
prefill, per-token decode fan-out, predictive-mean tokens, per-token
uncertainty); this launcher turns flags into a spec and prints the served
stream. Draw banks (``--bank``, ``--ckpt``, ``--watch``) wait for the
checkpoint package (ROADMAP item 11) and ``--log-jsonl`` for
observability (item 12).
"""
from __future__ import annotations

import argparse

from repro_torch.api import FSGLD, Serving
from repro_torch.core.engine import _not_ported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--draws", type=int, default=1,
                    help="ensemble size K")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--bank", default=None, help="not ported (item 11)")
    ap.add_argument("--watch", type=int, default=0,
                    help="not ported (item 11)")
    ap.add_argument("--ckpt", default=None, help="not ported (item 11)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-jsonl", default=None,
                    help="not ported (item 12)")
    args = ap.parse_args(argv)
    for flag, item in (("bank", 11), ("ckpt", 11), ("watch", 11),
                       ("log_jsonl", 12)):
        if getattr(args, flag):
            raise _not_ported(f"--{flag.replace('_', '-')}", item)

    spec = Serving(draws=args.draws, arch=args.arch, smoke=args.smoke,
                   batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, device=args.device)
    server = FSGLD.serve(spec, seed=args.seed)
    res = server.generate(gen=args.gen, batch=args.batch,
                          prompt_len=args.prompt_len)
    for t in range(res.tokens.shape[1]):
        line = f"step {t}: tokens {res.tokens[:, t].tolist()}"
        if "mean" in spec.collect:
            line += f" logp {res.mean_logprob[:, t].tolist()}"
        if "entropy" in spec.collect:
            line += f" H {res.entropy[:, t].tolist()}"
        if "mutual_info" in spec.collect:
            line += f" MI {res.mutual_info[:, t].tolist()}"
        if "variance" in spec.collect:
            line += f" var {res.token_var[:, t].tolist()}"
        print(line, flush=True)
    B, G = args.batch, args.gen
    print(f"prefilled {B}x{args.prompt_len} once for {res.n_draws} draw(s) "
          f"on {spec.device} in {res.prefill_s:.2f}s; served {B} seqs x {G} "
          f"new tokens in {res.decode_s:.2f}s "
          f"({B * G / max(res.decode_s, 1e-9):.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
