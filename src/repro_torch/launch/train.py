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

Streaming to a server: ``--draw-bank DIR --bank-every N`` runs the
schedule in segments of N rounds, one generator continuing across them,
and appends chain 0's parameters to the draw bank after each segment
(``repro_torch.launch.serve --bank DIR`` serves them, hot-swapping fresh
ones in between requests). Preemption: ``--snapshot-every N
--snapshot-dir DIR`` saves the run's whole carry every N rounds, and
``--resume`` continues from the newest valid snapshot, bitwise the
uninterrupted run. ``--ckpt PATH`` saves chain 0's final parameters as
one checkpoint (a legacy one-draw bank).

Observability: ``--metrics-dir DIR`` turns on the engine's per-round
telemetry (``obs.Telemetry``) and writes ``metrics.jsonl`` (one record
per round, the reference's ``repro-metrics-v1`` schema),
``metrics.prom`` (Prometheus textfile) and ``trace.jsonl`` (host spans
and events) there; ``--log-every N`` echoes one ``engine.progress`` line
every N rounds (the rows come to the host once per N rounds). The
streamed client axis: ``--clients N`` samples over N lazy synthetic
clients (``fed.SyntheticClientSource``, each client's tokens built on the
host when a window needs it; surrogate-free methods only) and
``--resident K`` keeps only K clients on the device
(``fed.Stream(resident=K)``), the next window staged while the current
one runs.

Runs on CUDA unless ``--device cpu`` asks for the CPU. The executor is
``auto`` (the packed single-launch kernel executor on CUDA, the plain vmap
one on the CPU) unless ``--use-kernel`` / ``--no-use-kernel`` /
``--[no-]packed`` pick one. At qwen3-1.7b's full width (2.03e9 parameters
per chain) the initial parameters wait on the host while the chains
sample, so that the device holds them once, in the engine's state, and
the surrogate means stay on the host (``Execution(bank_device='cpu')``):
each round brings the chain's client's means to the device. Prints
ll/token per chain at theta0 and after sampling, and the chain-steps/s.

Several devices: under ``torchrun`` (RANK / WORLD_SIZE in the
environment) the driver builds the production mesh from the launched
world (``launch.mesh.make_production_mesh``: (W, 1) ('data', 'model'),
or with ``--multi-pod`` (2, W / 2, 1) ('pod', 'data', 'model'), which
needs an even world) and samples the chains over its 'data' axis; every
rank fits the same surrogates, holds the whole shard stack and prints
the gathered result, and global rank 0 alone writes files. Without
``torchrun`` it runs on one device (``--multi-pod`` then refuses: one
rank is not two pods)::

    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch qwen3-1.7b

The vlm and audio
families (llama-3.2-vision, whisper) are refused: their likelihood reads
``enc_embeds`` from every batch, and this driver builds token shards only,
as the reference's does (whose ``log_lik_fn`` then fails on None). The
facade samples them with an ``enc_embeds`` leaf in the shards.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import api, checkpoint
from repro_torch import tree as tu
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import token_shards
from repro_torch.fed import SyntheticClientSource
from repro_torch.launch import mesh as lmesh
from repro_torch.models import init_params, log_lik_fn
from repro_torch.models.model import ENCODER_FAMILIES
from repro_torch.obs import trace as obs_trace
from repro_torch.obs import write_metrics_jsonl, write_prometheus

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
                    help="lazy synthetic clients (SyntheticClientSource): "
                         "each client's tokens are built on the host only "
                         "when a window needs them; overrides "
                         "--num-shards")
    ap.add_argument("--resident", type=int, default=None,
                    help="streamed client axis: keep only this many "
                         "clients on the device, the next window staged "
                         "while the current one runs")
    ap.add_argument("--multi-pod", action="store_true",
                    help="under torchrun: a ('pod', 'data', 'model') mesh "
                         "of two pods (an even world)")
    ap.add_argument("--ckpt", default=None,
                    help="save chain 0's final parameters as one "
                         "checkpoint (served as a one-draw bank)")
    ap.add_argument("--draw-bank", default=None,
                    help="draw-bank DIRECTORY: sample in segments of "
                         "--bank-every rounds and append chain 0's "
                         "parameters as one DrawMeta-enveloped draw per "
                         "segment, for repro_torch.launch.serve --bank")
    ap.add_argument("--bank-every", type=int, default=1,
                    help="rounds per draw-bank segment (one draw every "
                         "this many rounds)")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="save the run's whole carry (chains, generator, "
                         "federation state, trace) every N rounds into "
                         "--snapshot-dir, atomically")
    ap.add_argument("--snapshot-dir", default=None,
                    help="directory for --snapshot-every / --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid snapshot in "
                         "--snapshot-dir (a fresh run when none exists), "
                         "bitwise the uninterrupted run")
    ap.add_argument("--metrics-dir", default=None,
                    help="in-loop telemetry: write metrics.jsonl (per-round "
                         "per-chain metric rows), metrics.prom (Prometheus "
                         "textfile), and trace.jsonl (host spans/events) "
                         "into this directory")
    ap.add_argument("--log-every", type=int, default=None,
                    help="periodic progress: echo one engine.progress "
                         "line (round counter, steps/s, per-metric "
                         "means) every N rounds during the run — "
                         "segmentation is bitwise-lossless")
    args = ap.parse_args(argv)
    family = get_config(args.arch).family
    if family in ENCODER_FAMILIES:
        raise SystemExit(
            f"--arch {args.arch}: the {family} family's likelihood reads "
            "enc_embeds (image patches or audio frames) from every batch, "
            "and this driver builds token shards only, as the reference's "
            "does; sample it through repro_torch.api.FSGLD with an "
            "'enc_embeds' leaf in the shards")
    obs = args.metrics_dir is not None or args.log_every is not None
    if obs and args.draw_bank:
        raise SystemExit(
            "--metrics-dir/--log-every instrument the facade's one "
            "engine run; --draw-bank runs its own segment loop — "
            "pick one")
    if obs and args.resident is not None:
        raise SystemExit(
            "--metrics-dir/--log-every (in-loop telemetry) do not "
            "compose with --resident (streamed clients) yet — drop one")
    if args.log_every is not None and args.snapshot_every:
        raise SystemExit(
            "--log-every and --snapshot-every both segment the run — "
            "pick ONE segmentation driver (snapshots already log a "
            "span per segment)")
    if (args.snapshot_every or args.resume) and not args.snapshot_dir:
        raise SystemExit("--snapshot-every/--resume need --snapshot-dir")
    if (args.snapshot_every or args.resume) and args.draw_bank:
        raise SystemExit(
            "--snapshot-every/--resume run the schedule as one resumable "
            "engine run; --draw-bank runs its own segment loop — pick one")
    n_clients = args.clients if args.clients is not None \
        else args.num_shards
    if args.resident is not None and args.resident > n_clients:
        flag = "--clients" if args.clients is not None else "--num-shards"
        raise SystemExit(
            f"--resident {args.resident} exceeds the client count "
            f"({n_clients}): the resident set is the on-device SUBSET of "
            f"clients — lower --resident to at most {n_clients}, or raise "
            f"{flag} (did you mean {flag} {args.resident}?)")
    if args.resident is not None and (args.snapshot_every or args.resume):
        raise SystemExit(
            "--resident (streamed clients) does not compose with "
            "--snapshot-every/--resume: snapshots capture the full run "
            "carry and the resident window is host-managed — drop "
            "--resident to snapshot")
    if args.clients is not None and args.method == "fsgld":
        raise SystemExit(
            "--clients streams lazy synthetic clients; surrogate fitting "
            "(--method fsgld) needs materialized shard data — pick "
            "--method dsgld or fald, or pass a prefit bank through the "
            "api facade")
    return args


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _mesh(args, dev: torch.device):
    """The production mesh under torchrun (or when --multi-pod asks for
    one), None for a one-device run."""
    if not (_under_torchrun() or args.multi_pod):
        return None
    return lmesh.make_production_mesh(multi_pod=args.multi_pod,
                                      device_type=dev.type)


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


def _sample_into_bank(fsgld, gen, params, cfg, args, federation,
                      mesh=None):
    """Sample in SEGMENTS of ``--bank-every`` rounds, carrying the stacked
    per-chain states across them (``engine.run(stacked=True)``), and
    append chain 0's parameters to the draw bank after every segment:
    one thinned posterior draw per segment, which a server watching the
    directory hot-swaps in. The segments continue ONE generator, so a
    Langevin run without a federation ends where one monolithic run ends,
    bitwise; SGHMC momenta and a federation's carry restart per segment.
    Between segments the states wait on the host. Returns (final stacked
    (C, ...) parameter states, on the run's device; the draws' paths and
    write seconds)."""
    seg = max(1, args.bank_every)
    state, stacked = params, False
    done, paths, write_s = 0, [], []
    while True:
        r = min(seg, args.rounds - done)
        finals = fsgld.engine.run(
            gen, state, r, n_chains=args.chains, reassign="permutation",
            collect=False, stacked=stacked, federation=federation)
        # a draw is parameters, not a chain state: SGHMC's momenta stay
        theta = finals[0] if args.kernel == "sghmc" else finals
        del finals
        done += r
        draw = tu.tree_map(lambda t: t[0], theta)
        meta = checkpoint.DrawMeta(
            method=args.method, round=done,
            scenario=(args.federation or "identity"), seed=args.seed,
            dtype=checkpoint.dtype_name(tu.leaves(draw)[0].dtype),
            arch=cfg.name, chain=0)
        t0 = time.perf_counter()
        if lmesh.is_writer(mesh):
            paths.append(checkpoint.save_draw(args.draw_bank, draw, meta,
                                              step=done))
            write_s.append(time.perf_counter() - t0)
            print(f"draw {len(paths) - 1} (round {done}) -> {paths[-1]} "
                  f"({write_s[-1]:.2f} s)", flush=True)
        lmesh.barrier(mesh)
        del draw
        if done >= args.rounds:
            return theta, paths, write_s
        state = tu.tree_map(lambda t: t.to("cpu"), theta)
        stacked = True
        del theta


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
    draws: list = dataclasses.field(default_factory=list)  # bank paths
    draw_write_s: list = dataclasses.field(default_factory=list)
    frame: Any = None      # obs.MetricsFrame under --metrics-dir/--log-every


def ll_per_token(params, cfg, probe) -> float:
    """Log-likelihood per token of ``probe`` at one parameter draw."""
    with torch.no_grad():
        return float(log_lik_fn(params, cfg, probe)) \
            / probe["tokens"].numel()


def run(args: argparse.Namespace) -> TrainRun:
    """Build the data, parameters and sampler of ``args``, fit the
    surrogates (FSGLD) and sample; prints as the reference's driver.
    Under ``--metrics-dir`` / ``--log-every`` the process-wide tracer
    writes ``trace.jsonl`` / echoes for the run and is reset after it."""
    obs = args.metrics_dir is not None or args.log_every is not None
    # under torchrun only global rank 0 writes files, as with snapshots
    if args.metrics_dir is not None and int(os.environ.get("RANK", 0)) == 0:
        os.makedirs(args.metrics_dir, exist_ok=True)
        obs_trace.configure(os.path.join(args.metrics_dir, "trace.jsonl"),
                            echo=args.log_every is not None)
    elif args.log_every is not None:
        obs_trace.configure(echo=True)
    try:
        return _train(args, api.Telemetry(log_every=args.log_every)
                      if obs else None)
    finally:
        if obs:
            obs_trace.configure()  # don't leak the tracer to callers


def _train(args: argparse.Namespace, telemetry) -> TrainRun:
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
    n_clients = args.clients if args.clients is not None \
        else args.num_shards
    mesh = _mesh(args, dev)
    print(f"arch={cfg.name} method={args.method} shards={n_clients} "
          f"device={dev}"
          + (f" resident={args.resident}" if args.resident else "")
          + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
             if mesh is not None else ""), flush=True)
    params = init_params(cfg, _generator(dev, args.seed, 0), device=dev)
    n_params = sum(t.numel() for t in tu.leaves(params))
    print(f"params: {n_params / 1e6:.2f}M", flush=True)
    if args.clients is not None:
        # lazy per-client source: only the resident window is ever built
        shards = SyntheticClientSource(
            int(np.random.SeedSequence([args.seed, 1]).generate_state(1)[0]),
            num_clients=args.clients, shard_size=args.shard_size,
            seq_len=args.seq, vocab_size=cfg.vocab_size)
    else:
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
                                bank_device="cpu",
                                snapshot_every=args.snapshot_every,
                                snapshot_path=args.snapshot_dir,
                                resume=args.resume,
                                stream=(api.Stream(resident=args.resident)
                                        if args.resident is not None
                                        else None),
                                telemetry=telemetry, mesh=mesh),
        federation=federation)
    probe_rows = (tu.tree_map(lambda a: torch.as_tensor(a).to(dev),
                              shards.rows(np.arange(1)))
                  if args.clients is not None else shards)
    probe = tu.tree_map(lambda d: d[0][:args.batch], probe_rows)
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
    paths, write_s = [], []
    if args.draw_bank:
        finals, paths, write_s = _sample_into_bank(
            fsgld, _generator(dev, args.seed, 3), params, cfg, args,
            federation, mesh)
    frame = None
    if not args.draw_bank:
        finals = fsgld.sample(_generator(dev, args.seed, 3), params)
        if telemetry is not None:
            finals, frame = finals
        if args.kernel == "sghmc":
            finals = finals[0]  # (theta, momentum) chain states
    _sync(dev)
    dt = time.perf_counter() - t0
    _peak(dev, "sampling", peak_gb)
    lls = [ll_per_token(tu.tree_map(lambda t: t[c], finals), cfg, probe)
           for c in range(args.chains)]
    for c, ll in enumerate(lls):
        print(f"chain {c:3d} ll/token={ll:8.4f}")
    steps = args.rounds * args.local_updates * args.chains
    print(f"{args.chains} chain(s) x {args.rounds} rounds ({steps} "
          f"chain-steps) in {dt:.1f}s = {steps / dt:.1f} steps/s "
          f"[reassign=permutation executor={executor}"
          f"{' federation=' + args.federation if args.federation else ''}]")
    if args.ckpt and lmesh.is_writer(mesh):
        checkpoint.save(args.ckpt, tu.tree_map(lambda t: t[0], finals),
                        step=args.rounds,
                        extra={"method": args.method, "arch": cfg.name,
                               "chains": args.chains})
        print(f"checkpoint -> {args.ckpt}")
    if args.metrics_dir is not None and lmesh.is_writer(mesh):
        mj = os.path.join(args.metrics_dir, "metrics.jsonl")
        mp = os.path.join(args.metrics_dir, "metrics.prom")
        write_metrics_jsonl(frame, mj)
        write_prometheus(frame, mp)
        print(f"metrics -> {mj} + {mp} ({frame.rounds} rounds x "
              f"{frame.n_chains} chains x {len(frame.names)} metrics)")
    print(f"final ll/token {float(np.mean(lls)):.4f}", flush=True)
    return TrainRun(cfg=cfg, sampler=fsgld, theta0=params, finals=finals,
                    ll0=ll0, lls=lls, fit_s=fit_s, sample_s=dt,
                    peak_gb=peak_gb, draws=paths, draw_write_s=write_s,
                    frame=frame)


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
