"""End-to-end FSGLD training driver, large-model mode (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--smoke] [--device cpu] [--rounds 5 --chains 1 --method fsgld]

Phases (paper Algorithm 1 + Sec 3.1), through the ``repro_torch.api``
facade:
  1. local surrogate fitting: short SGLD runs per client shard against the
     local likelihood (at full width one client at a time), fit per-tensor
     scalar-precision Gaussians stored in ``cfg.surrogate_dtype`` (bf16),
     combined into the global product q (computed once, communicated once);
  2. sampling: the chain engine reassigns chains to clients by permutation
     each round, and every chain takes ``--local-updates`` Langevin (or
     SGHMC) steps per round with the conducive correction.

Runs on CUDA unless ``--device cpu`` asks for the CPU. The executor is
``auto`` (the packed single-launch kernel executor on CUDA, the plain vmap
one on the CPU) unless ``--use-kernel`` / ``--no-use-kernel`` /
``--[no-]packed`` pick one. At qwen3-1.7b's full width (2.03e9 parameters
per chain) the initial parameters wait on the host while the chains
sample, so that the device holds them once, in the engine's state, and
the surrogate means stay on the host (``Execution(bank_device='cpu')``):
each round brings the chain's client's means to the device. Prints
ll/token per chain at theta0 and after sampling, and the chain-steps/s.

The flags of the reference that wait for other parts of the port raise
NotImplementedError naming their ROADMAP item: ``--clients`` /
``--resident`` (13), ``--draw-bank`` / ``--bank-every`` other than 1 /
``--ckpt`` / ``--snapshot-*`` / ``--resume`` (11), ``--metrics-dir`` /
``--log-every`` (12) and ``--multi-pod`` (8).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import _not_ported
from repro_torch.data import token_shards
from repro_torch.models import init_params, log_lik_fn

# flag -> the ROADMAP item its port waits for
_REFUSED = (("clients", 13), ("resident", 13), ("draw_bank", 11),
            ("ckpt", 11), ("snapshot_every", 11), ("snapshot_dir", 11),
            ("resume", 11), ("metrics_dir", 12), ("log_every", 12),
            ("multi_pod", 8))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--method", default="fsgld",
                    choices=["sgld", "dsgld", "fsgld", "fald"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--use-kernel", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="the fused update kernel's executors (packed "
                         "unless --no-packed); --no-use-kernel: the plain "
                         "vmap executor; default: auto")
    ap.add_argument("--packed", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="with the kernel: one launch per step for the "
                         "whole chain block; --no-packed: one per leaf")
    ap.add_argument("--kernel", default="sgld", choices=["sgld", "sghmc"],
                    help="transition dynamics: Langevin or federated SGHMC")
    ap.add_argument("--friction", type=float, default=0.1,
                    help="SGHMC friction alpha_f (with --kernel sghmc)")
    ap.add_argument("--federation", default=None,
                    help="named federation scenario (schedule/compression "
                         "only: the token shards are already per-client)")
    ap.add_argument("--local-updates", type=int, default=4)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--shard-size", type=int, default=64)
    ap.add_argument("--step-size", type=float, default=1e-5)
    ap.add_argument("--fit-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=None,
                    help="not ported (item 13)")
    ap.add_argument("--resident", type=int, default=None,
                    help="not ported (item 13)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported (item 8)")
    ap.add_argument("--ckpt", default=None, help="not ported (item 11)")
    ap.add_argument("--draw-bank", default=None, help="not ported (item 11)")
    ap.add_argument("--bank-every", type=int, default=1,
                    help="rounds per draw-bank segment; only 1 (no draw "
                         "bank) is ported (item 11)")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="not ported (item 11)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="not ported (item 11)")
    ap.add_argument("--resume", action="store_true",
                    help="not ported (item 11)")
    ap.add_argument("--metrics-dir", default=None,
                    help="not ported (item 12)")
    ap.add_argument("--log-every", type=int, default=None,
                    help="not ported (item 12)")
    args = ap.parse_args(argv)
    for flag, item in _REFUSED:
        if getattr(args, flag) not in (None, False):
            raise _not_ported(f"--{flag.replace('_', '-')}", item)
    if args.bank_every != 1:
        raise _not_ported(f"--bank-every {args.bank_every}", 11)
    return args


def _executor(args) -> str:
    if args.use_kernel is None and args.packed is None:
        return "auto"
    if args.use_kernel is False:
        if args.packed:
            raise SystemExit("--packed needs the kernel (drop "
                             "--no-use-kernel)")
        return "vmap"
    return "per_leaf" if args.packed is False else "packed"


def _generator(device, seed: int, stream: int) -> torch.Generator:
    """One of the run's independent generators (parameters, data, fit,
    sampling), seeded from (seed, stream)."""
    s = int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


@dataclasses.dataclass
class TrainRun:
    """What one run of the driver produced (``main`` prints it)."""
    cfg: Any
    sampler: api.FSGLD
    theta0: Any            # the initial parameters, on the host
    finals: Any            # (C, ...) final chain states (theta)
    ll0: float             # ll/token at theta0
    lls: list              # ll/token of each chain after sampling
    fit_s: Optional[float]
    sample_s: float
    peak_gb: dict          # CUDA: peak device memory of 'fit', 'sampling'


def ll_per_token(params, cfg, probe) -> float:
    """Log-likelihood per token of ``probe`` at one parameter draw."""
    with torch.no_grad():
        return float(log_lik_fn(params, cfg, probe)) \
            / probe["tokens"].numel()


def run(args: argparse.Namespace) -> TrainRun:
    """Build the data, parameters and sampler of ``args``, fit the
    surrogates (FSGLD) and sample; prints as the reference's driver."""
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    dev = api._device(args.device)
    executor = _executor(args)
    federation = None
    if args.federation:
        federation = api.get_scenario(args.federation)
        if federation.partition is not None:
            raise SystemExit(
                f"--federation {args.federation}: partition scenarios need "
                "pooled data; this driver builds per-client token shards — "
                "pick a schedule/compression scenario")
    print(f"arch={cfg.name} method={args.method} shards={args.num_shards} "
          f"device={dev}", flush=True)
    params = init_params(cfg, _generator(dev, args.seed, 0), device=dev)
    n_params = sum(t.numel() for t in tu.leaves(params))
    print(f"params: {n_params / 1e6:.2f}M", flush=True)
    shards = token_shards(_generator(dev, args.seed, 1),
                          num_shards=args.num_shards,
                          shard_size=args.shard_size, seq_len=args.seq,
                          vocab_size=cfg.vocab_size)
    minibatch = min(args.batch, args.shard_size)
    fsgld = api.FSGLD(
        api.Posterior(lambda p, b: log_lik_fn(p, cfg, b),
                      prior_precision=1.0),
        shards, minibatch=minibatch, step_size=args.step_size,
        method=args.method, kernel=args.kernel, friction=args.friction,
        surrogate=(api.SurrogateSpec(
            kind="scalar", fit="local_sgld", fit_steps=args.fit_steps,
            fit_minibatch=minibatch) if args.method == "fsgld"
            else api.SurrogateSpec(kind="none")),
        schedule=api.Schedule(rounds=args.rounds,
                              local_steps=args.local_updates,
                              n_chains=args.chains, reassign="permutation"),
        execution=api.Execution(device=dev, executor=executor,
                                collect=False,
                                dtype=getattr(torch, cfg.surrogate_dtype),
                                bank_device="cpu"),
        federation=federation)
    probe = tu.tree_map(lambda d: d[0][:args.batch], shards)
    ll0 = ll_per_token(params, cfg, probe)
    print(f"theta0 ll/token={ll0:8.4f}", flush=True)

    # ---- phase 1: surrogates (once, before sampling) ----
    fit_s, peak_gb = None, {}
    if args.method == "fsgld":
        _reset_peak(dev)
        t0 = time.perf_counter()
        fsgld.fit(_generator(dev, args.seed, 2), params)
        _sync(dev)
        fit_s = time.perf_counter() - t0
        _peak(dev, "fit", peak_gb)
        print(f"surrogates fitted in {fit_s:.1f}s (communicated once; "
              f"means stored as {cfg.surrogate_dtype})", flush=True)

    # ---- phase 2: sampling on the chain engine ----
    # theta0 waits on the host: the engine copies it into its own state
    params = tu.tree_map(lambda t: t.to("cpu"), params)
    _reset_peak(dev)
    t0 = time.perf_counter()
    finals = fsgld.sample(_generator(dev, args.seed, 3), params)
    _sync(dev)
    dt = time.perf_counter() - t0
    _peak(dev, "sampling", peak_gb)
    if args.kernel == "sghmc":
        finals = finals[0]  # (theta, momentum) chain states
    lls = [ll_per_token(tu.tree_map(lambda t: t[c], finals), cfg, probe)
           for c in range(args.chains)]
    for c, ll in enumerate(lls):
        print(f"chain {c:3d} ll/token={ll:8.4f}")
    steps = args.rounds * args.local_updates * args.chains
    print(f"{args.chains} chain(s) x {args.rounds} rounds ({steps} "
          f"chain-steps) in {dt:.1f}s = {steps / dt:.1f} steps/s "
          f"[reassign=permutation executor={executor}"
          f"{' federation=' + args.federation if args.federation else ''}]")
    print(f"final ll/token {float(np.mean(lls)):.4f}", flush=True)
    return TrainRun(cfg=cfg, sampler=fsgld, theta0=params, finals=finals,
                    ll0=ll0, lls=lls, fit_s=fit_s, sample_s=dt,
                    peak_gb=peak_gb)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device, phase: str, out: dict) -> None:
    if dev.type == "cuda":
        out[phase] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"peak device memory ({phase}): {out[phase]:.2f} GB",
              flush=True)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
