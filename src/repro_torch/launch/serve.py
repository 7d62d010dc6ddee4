"""Thin CLI over the serving facade: K posterior draws, one ensemble
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --draws 4 --batch 4 --prompt-len 32 --gen 16 [--smoke] \\
        [--device cpu] [--bank DIR [--watch N]]

Serves on CUDA unless ``--device cpu`` asks for the CPU. The mechanics
live behind ``repro_torch.api.Serving`` + ``FSGLD.serve`` (shared
prefill, per-token decode fan-out, predictive-mean tokens, per-token
uncertainty, hot-swapped draw banks); this launcher turns flags into a
spec and prints the served stream.

``--bank`` points at a draw-bank directory written by
``repro_torch.launch.train --draw-bank`` (or the JAX package's); ``--watch
N`` re-polls it N extra times, hot-swapping fresh draws in between
requests. The deprecated ``--ckpt`` (warns once) serves one checkpoint
as a one-draw bank. Hot-swaps, refresh retries and each request's
``serve.prefill`` / ``serve.decode`` spans and ``serve.request`` event are
echoed as one-line events and, with ``--log-jsonl PATH``, appended to a
trace JSONL for later inspection (``repro_torch.obs.read_jsonl``).
"""
from __future__ import annotations

import argparse
import warnings

from repro_torch.api import FSGLD, Serving
from repro_torch.obs import trace as obs_trace

_ckpt_warned = False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--draws", type=int, default=1,
                    help="ensemble size K (the freshest K draws of a bank)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--bank", default=None,
                    help="draw-bank directory from "
                         "repro_torch.launch.train --draw-bank")
    ap.add_argument("--watch", type=int, default=0,
                    help="extra bank polls: serve, refresh(), repeat")
    ap.add_argument("--ckpt", default=None,
                    help="DEPRECATED: one checkpoint, served as a one-draw "
                         "legacy bank; use --bank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-jsonl", default=None,
                    help="also append structured trace events/spans "
                         "(refreshes, prefill/decode) to this JSONL file")
    args = ap.parse_args(argv)
    global _ckpt_warned
    bank = args.bank
    if args.ckpt:
        if bank is not None:
            raise SystemExit("pass --bank or --ckpt, not both")
        if not _ckpt_warned:
            warnings.warn(
                "--ckpt is deprecated; point --bank at a draw-bank "
                "directory (repro_torch.launch.train --draw-bank). Serving "
                "the checkpoint as a one-draw legacy bank.",
                DeprecationWarning, stacklevel=2)
            _ckpt_warned = True
        bank = args.ckpt
    # hot-swaps, refresh retries and the request spans are echoed as
    # one-line events (and written to --log-jsonl)
    obs_trace.configure(args.log_jsonl, echo=True)
    try:
        return _serve(args, bank)
    finally:
        obs_trace.configure()  # don't leak the echo tracer to callers


def _serve(args, bank) -> int:
    spec = Serving(draws=args.draws, arch=args.arch, smoke=args.smoke,
                   batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, device=args.device)
    server = FSGLD.serve(spec, bank=bank, seed=args.seed)
    if bank is not None:
        meta = server.metas[0]
        prov = (f"round {meta.round}, method={meta.method}, "
                f"scenario={meta.scenario}" if meta is not None
                else "legacy checkpoint, no DrawMeta")
        print(f"serving {server.n_draws} draw(s) from {bank} ({prov})")
    for req in range(1 + max(0, args.watch)):
        if req > 0:
            # a watching server must outlive a flaky bank: refresh()
            # already degrades to the previous ensemble on read errors,
            # and anything it still raises is logged, not fatal
            try:
                if server.refresh():
                    obs_trace.event("serve.hot_swap", request=req,
                                    n_draws=server.n_draws)
            except Exception as e:  # noqa: BLE001
                obs_trace.event("serve.refresh_error", request=req,
                                error=str(e), n_draws=server.n_draws)
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
        print(f"prefilled {B}x{args.prompt_len} once for {res.n_draws} "
              f"draw(s) on {spec.device} in {res.prefill_s:.2f}s; served "
              f"{B} seqs x {G} new tokens in {res.decode_s:.2f}s "
              f"({B * G / max(res.decode_s, 1e-9):.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
