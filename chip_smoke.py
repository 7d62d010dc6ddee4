"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, in parallel) and drives its two paths through the
``repro_torch.api`` facade:

* sampling: holds both entries of the fused FSGLD update kernel against
  their plain PyTorch versions, runs the paper's Table-1 Bayesian MLP at
  full size (10 clients x 20,000 points, P = 854) on the packed and
  per-leaf executors and the multi-leaf MLP of
  ``benchmarks/bench_chains.py``, and checks that each path launched the
  kernel once per step (per leaf, for per-leaf);
* the paper's federated comparisons, each path with its own launch
  counts: the Table-1 BNN with SGHMC dynamics on every executor, under
  five federation scenarios (delay, partial participation, stragglers,
  top-k and bidirectional QSGD compression) and under FA-LD (against the
  port's host-loop oracle); the Gaussian of Figs. 2-3 with the paper's
  delayed-communication claims asserted, and the rival-sampler frontier;
* the paper's own workloads: App. F.1 linear regression on its three
  data sets at full (n, d) (test MSE against the exact posterior mean's),
  Fig. 5 metric learning at full size (the fit on the card, train / test
  log-likelihood, FSGLD against DSGLD), the two calibration problems of
  ``benchmarks/bench_calibration.py`` under its absolute bounds, each
  with one launch per step and packed == per-leaf on a prefix; the
  'linear' and 'full' surrogate kinds through executor 'auto' (the plain
  vmap executor; the kernel executors refuse them); and the host-loop
  oracle ``FederatedSampler.run_vmap`` with the kernel against the
  per-leaf executor on Table 1, bitwise;
* serving: holds the flash-attention kernel against its plain version
  over masks, dtypes, GQA groups, head dims and lengths, serves
  qwen3-1.7b at full width with K = 4 posterior draws (two requests of
  batch 4 x prompt 2,048, 16 new tokens each) and checks one launch per
  layer per request and none in decode, the K = 1 ensemble against a
  plain prefill + decode loop (bitwise) and the kernel's prefill logits
  against the plain attention's; then one request of h2o-danube-1.8b at
  full width and 2 layers through the sliding-window ring cache;
* training: samples qwen3-1.7b's posterior at full width and depth
  (2,031,739,904 parameters per chain) through the train driver
  (``repro_torch.launch.train``) at the reference driver's defaults but the
  step size ``TRAIN_H``: the streaming surrogate fit of 4 clients, 5
  rounds x 4 packed steps; checks one update launch per step and one
  flash launch per layer per gradient pass, finite chains within
  ``TRAIN_GUARD`` nats per token of theta0, per_leaf == packed bitwise,
  and times one step split into gradient pass, packing and update (held
  against the plain version); then 4 of the 28 layers with 2 chains
  (the chain axis folded into the flash kernel's batch, the first update
  against the plain version) and the differentiable flash entry against
  plain autograd at the train shape;
* fault tolerance: the Table-1 BNN under chaos plans (a NaN chain under
  quarantine and respawn, the divergence detector, a NaN compressed
  payload) on packed and per-leaf, each against the fault-free run
  bitwise, and the health check's cost per round; kill and resume,
  bitwise, on Table 1 (without a federation and under a hard one) and at
  [train-c2]'s size (6.59 GB of chain state per snapshot), the snapshot
  I/O timed; the train -> draw bank -> serve pipeline at qwen3-1.7b's full
  width and 2 layers through both drivers (the freshest draw bitwise the
  final chain state; one flash launch per layer per request, none in
  decode; the request's spans through ``launch.serve --log-jsonl``),
  then a refresh hot-swap and a corrupt draw;
* observability: the Table-1 BNN with per-round telemetry on packed and
  per-leaf, bitwise the run without it (no federation, partial
  participation with top-k, quarantine of a NaN chain), its rows against
  the schedule, ``log_every`` progress events, the JSONL / Prometheus
  files, telemetry's cost per round; the ``[train]`` run with
  ``--metrics-dir --log-every 1`` and ``[train-c2]`` with and without
  telemetry, bitwise;
* the streamed client axis: Table 1's clients through resident windows
  of 4 and 6 (DSGLD, FSGLD, a delayed partial schedule; prefetch on and
  off), bitwise the resident runs; qwen3-1.7b at full width and 4 of
  its 28 layers over 10^6 lazy clients with 4 resident (each window's
  rows built on the host and copied on a side stream while the previous
  window runs); the train driver at [train-c2]'s size with
  ``--resident 2``, bitwise the resident run;
* the MoE, hybrid, ssm, audio and vlm families at their published
  widths: phi3.5-moe (8 of 32 layers), recurrentgemma-2b, rwkv6-7b and
  whisper-large-v3 (full depth, its encoder over 1,500 frames per row)
  and llama-3.2-vision-90b (one period, 5 of 100 layers, 6,404 patches
  per row) served through ``FSGLD.serve`` (the flash kernel at each of
  the family's attention shapes against its plain version, one launch
  per self-attention per request, the encoder's included, and none in
  decode, the prefill against the plain attention's, for the vlm once
  more with its gates opened, K = 1 bitwise, the blocks' device time in
  one prefill), then each but the vlm sampled at the depth one card
  holds or less (1, 4 and 3 layers; whisper at 8 of its 32 encoder and 8
  of its 32 decoder layers, through the facade with its frames in the
  shards, which the train driver refuses): one update
  launch per step, flash launches per self-attention per pass, the
  divergence guard with telemetry's conducive and gradient norms, the
  MoE's aux loss finite, packed == per_leaf over one round, bitwise;
* the production dry run (``launch.dryrun``): seven combinations of the
  pods' grids traced on fake worlds of 256 and 512 ranks, each required
  to be OK and its collective bytes printed (qwen3-1.7b's train_4k, the
  long_500k decodes of h2o-danube-1.8b and recurrentgemma-2b, whose
  replicated tokens look the embedding up on each rank's vocab shard,
  gemma-7b's decode_32k and rwkv6-7b's train_4k on the (2, 16, 16) pod,
  qwen3-1.7b's decode_32k, whose softmax is reduced across the cache's
  slot shards, and recurrentgemma-2b's prefill_32k, whose RG-LRU runs on
  sequence shards), and the one-card
  prediction of
  ``launch.steps.make_train_step`` at (4, 2,048), held against that
  step on the card at full width and depth, fed by
  ``data.pipeline.FederatedPipeline``: FLOPs to 0.1 %, the peak memory's
  ratio in [0.8, 1.25], the step time against the roofline bound, 56
  flash and 14 update launches per step; then the prefill step (28
  launches) and serve steps (none); the traces run on the CPU, each a
  process of its own, while the card runs the earlier phases;

and times each kernel beside its bound, its plain version and, where one
PyTorch call computes the same function, that call. Exits non-zero,
printing no result, when anything fails or no CUDA card is present. The
last line is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

# Kernel vs plain version on the card: the same float32 expression, but
# nvcc contracts a*b+c into FMAs (an ulp) and CUDA's logf/cosf and torch's
# log/cos may differ in the last ulp (x sqrt(h*tau) in the update).
ATOL = RTOL = 1e-5
BF16_REL = 2.0 ** -7  # one bf16 ulp: a 1e-6 shift can cross a rounding edge

DEVICE = "cuda"

# Table 1 (benchmarks/table1_bnn.py): S x n clients, minibatch, step size
T1_S, T1_N, T1_M, T1_H, T1_T = 10, 20_000, 50, 1e-5, 40
T1_CHAINS, T1_ROUNDS = 4, 5
# the federated phases on the Table-1 BNN: 200 steps as 20 rounds of 10,
# so delayed-10x communicates twice and the others 20 times
FED_ROUNDS, FED_T = 20, 10
FED_SCENARIOS = ("delayed-10x", "partial-50%", "straggler-10%", "topk-1%",
                 "elf-bidir-qsgd-8bit")
# SGHMC(h, a) moves theta like Langevin with step 2h/a: at Table 1's h
# and friction 0.1 that step is 20x Table 1's and the chains diverge, so
# the SGHMC runs take h = T1_H * a / 2 (the same effective step)
SGHMC_FRICTION = 0.1
SGHMC_H = T1_H * SGHMC_FRICTION / 2
# a diverged chain's held-out log-lik per point (a coin costs -0.69; the
# diverged runs of h = 1e-5 reached -13 to -1.4e16)
SGHMC_DIVERGED = -10.0
# Figs. 2-3 (benchmarks/fig2_3_gaussian.py), cut from 30,000 single-step
# rounds to FIG_ROUNDS (20 communications at the 100x delay; 3,000 until
# the script's time was cut); FIG_CHAINS chains average the single-chain
# MSE (workloads.chain_mse)
FIG_ROUNDS, FIG_CHAINS = 2000, 32
# the frontier (benchmarks/bench_frontier.py: 4,000 rounds, 4 chains,
# d = 64), cut to FRONTIER_ROUNDS (2,000, then 1,000 until the
# script's time was cut again: FSGLD's MSE was 1.2e-3 to 1.9e-3 at
# 2,000); its FSGLD MSE ceiling
FRONTIER_ROUNDS, FRONTIER_CHAINS, FRONTIER_CEILING = 500, 4, 0.1

# The paper's own workloads (src/repro_torch/workloads.py), at their
# benchmarks' full lengths, C = PAPER_CHAINS chains standing for the 3
# repetitions. [linreg]: a chain's test MSE within LINREG_REL of the exact
# posterior mean's (the noise set's slowest chains end 1.035x above it on
# the card); packed == per_leaf on PREFIX_ROUNDS rounds. [metric]:
# FSGLD's test ll at most METRIC_SE standard errors of the difference
# below DSGLD's (the reference's own margin is +0.5 of them: see the
# phase). [kinds]: the linear-surrogate run, KINDS_ROUNDS of its
# benchmark's 100 rounds (cut for the script's time: its MSE was 1.77e-4
# at 100 and 7.9e-5 at 50 against a ceiling of 5e-3), and the 'full' bank
# on concrete.
# [oracle]: ORACLE_ROUNDS Table-1 rounds.
PAPER_CHAINS, LINREG_REL, PREFIX_ROUNDS = 3, 1.05, 2
METRIC_SE, ORACLE_ROUNDS, KINDS_ROUNDS = 3.0, 2, 25

# Flash attention vs its plain version within
# repro_torch.kernels.flash_attention.tolerance (tools/flash_planted_faults.py
# shows faults of the late rows of S = 2,048 failing it), at these hd
FLASH_HDS = (64, 80, 128, 160, 256)
# The serving path: qwen3-1.7b at full width, K draws, two requests of
# batch x prompt, GEN new tokens each; prefill attention shape (B, S, H,
# Hkv, hd) and the long per-sequence shape of PREFILL_32K.
SERVE_K, SERVE_B, SERVE_S, SERVE_GEN = 4, 4, 2048, 16
# layers, d_model, heads, KV heads, head_dim, d_ff, vocab
QWEN3_WIDTH = (28, 2048, 16, 8, 128, 6144, 151_936)
FLASH_PATH = (SERVE_B, SERVE_S, 16, 8, 128)
FLASH_LONG = (1, 32_768, 16, 8, 128)
# whisper's encoder in a served request: 4 rows of 1,500 frames, not causal
FLASH_ENCODER = (4, 1500, 20, 20, 64)
# the anchor prefill through the kernel vs through the plain attention:
# max|diff| / max|logits|, the yardstick of tests/test_prefill_cache.py
PREFILL_REL = 0.05
# The training path: repro_torch.launch.train at the reference driver's
# defaults (qwen3-1.7b at full width, S = 4 clients x 64 x 128 tokens,
# minibatch 8, 20 local-SGLD fit steps, C = 1, 5 rounds x 4 steps) but the
# step size, TRAIN_H; a chain may end at most TRAIN_GUARD nats per token
# below theta0's log-likelihood. At the defaults' h = 1e-5 FSGLD diverged
# on the card (-21.31 against -12.39 at theta0; DSGLD -12.59), at 1e-6 it
# ended 0.99 nats below theta0, at 1e-7 0.10 (PERF.md, H100 80GB HBM3,
# 700 W). The reference diverges there too, with the same fit: the JAX
# package's FSGLD at the defaults, every leaf sampled, 1 layer, on the
# CPU went -12.4250 -> -21.1619 where the port went -12.4249 -> -15.0712
# (tests/_fsgld_witness.py --sample-all, PERF.md): the algorithm's
# behaviour at h = 1e-5, not the port's.
TRAIN_H = 1e-7
# [dryrun]: the production step at one card's shape, its prediction from
# a fake one-rank world, and seven combinations of the pods' grids: two
# replicated-token lookups (long_500k, a batch of one), the two that
# torch 2.11's DTensor once refused (gemma-7b's decode views on the
# (2, 16, 16) pod, RWKV's chunked train step on a 3-D mesh), a decode
# whose cache's slots are sharded (its softmax reduced across the slot
# shards) and recurrentgemma's prefill, whose RG-LRU runs on sequence
# shards (the conv's halo, the scan's carries)
DRY_B, DRY_S, DRY_STEPS, DRY_CLIENTS = 4, 2048, 4, 4
DRY_GRID = (("qwen3-1.7b", "train_4k", "pod1"),
            ("h2o-danube-1.8b", "long_500k", "pod1"),
            ("recurrentgemma-2b", "long_500k", "pod1"),
            ("gemma-7b", "decode_32k", "pod2"),
            ("rwkv6-7b", "train_4k", "pod2"),
            ("qwen3-1.7b", "decode_32k", "pod1"),
            ("recurrentgemma-2b", "prefill_32k", "pod1"))
DRY_FLOPS_REL = 1e-3
DRY_PEAK = (0.8, 1.25)
TRAIN_GUARD = 1.0
TRAIN_S, TRAIN_FIT, TRAIN_R, TRAIN_T = 4, 20, 5, 4
QWEN3_P = 2_031_739_904
# attention at the train shape (B, S, H, Hkv, hd), bf16
TRAIN_ATTN = (8, 128, 16, 8, 128)
# the reduced-depth phase: full width, C2_LAYERS of 28 layers, C2_CHAINS
C2_LAYERS, C2_CHAINS = 4, 2
# the local steps of the one-round packed == per_leaf checks of [train]
# and the [train-*] phases (per_leaf gathers a host bank's client means
# per step and leaf: ~6 s a step at qwen3's full depth)
CHECK_T = 1
# Fault tolerance. [chaos]: the Table-1 run under chaos plans; the
# detector's threshold in nats, far above the spread of the probe (a
# 50-point minibatch log-likelihood), and the timing's repetitions.
# [resume]: Table-1 RESUME_ROUNDS rounds, a snapshot every RESUME_EVERY;
# [train-c2]'s model C2_RESUME_ROUNDS rounds, every C2_RESUME_EVERY.
# [bank]: the train driver at full width and BANK_LAYERS layers with
# FAM_FIT fit steps (the pipeline does not depend on the fit's length),
# BANK_ROUNDS rounds, a draw every BANK_EVERY, then the refresh checks.
CHAOS_THRESHOLD, CHAOS_REPS, CHAOS_TIME_ROUNDS = 1e4, 3, 100
RESUME_ROUNDS, RESUME_EVERY = 7, 3
# (one chain since PR 21, for the script's time: the snapshot I/O scales
# with the chains, and [resume]'s Table-1 run resumes four)
C2_RESUME_ROUNDS, C2_RESUME_EVERY, C2_RESUME_CHAINS = 4, 2, 1
BANK_ROUNDS, BANK_EVERY, BANK_LAYERS = 2, 1, 2
# a serving span closes right after the request's own timer: at most this
# many seconds apart
SPAN_SLACK_S = 0.05
# Observability. [telemetry]: the Table-1 run with Telemetry(probe=True);
# its cost on TEL_TIME_ROUNDS one-step rounds, TEL_REPS times in turns.
# The streamed client axis. [stream]: qwen3-1.7b at full width and
# C2_LAYERS layers over STREAM_CLIENTS lazy clients, 4 resident, DSGLD at
# STREAM_H: the gradient scale S N_s / m is 10^6 x 64 / 8 = 8e6 against
# [train]'s 32, so h S N_s / m equals [train]'s TRAIN_H x 32.
TEL_TIME_ROUNDS, TEL_REPS = 100, 3
STREAM_CLIENTS, STREAM_H = 1_000_000, 4e-13
# [stream] c2's token shards, 2 of them resident
STREAM_C2_SHARDS = 4
# The MoE, hybrid (RG-LRU), ssm (RWKV-6), audio (whisper) and vlm
# (llama-3.2-vision) families at their published widths (d_model, heads,
# KV heads, head_dim, d_ff, vocab); each phase's tag, its serving depth
# (None: full) with K draws and one request of batch x prompt (SERVE_GEN
# new tokens), its sampling depth (None: not sampled on one card), and
# the depth of its profiled prefill where it is cut from the serving
# depth (rwkv6's 32 layers make ~30,000 profiled operations).
# The depths are at most the deepest that one card's machine holds in
# this script (80 GB on the card, 96 GiB on the host): recurrentgemma and
# rwkv6 sample at 4 and 3 of the 9 and 5 layers that fit (PERF.md section
# 4), for the script's time; whisper samples 8 of its 32 encoder and 8 of
# its 32 decoder layers (all 32 + 32 fit; it serves at full depth).
# whisper's request is 30 s of audio (1,500 frames) per row and a prompt
# that stays inside its 448-token decoder context with the new tokens;
# it samples with the driver's minibatches of 8 rows since the recompute
# (cfg.remat): without it one gradient pass alone peaked at ~66 GB (the
# encoder over 8 x 1,500 frames), more than the card holds beside the
# sampler's ~32 GB of packed buffers (PERF.md section 4);
# llama-3.2-vision serves one period of its 100 layers (4 'attn', 1 gated
# 'xattn'): a full-depth bf16 draw is ~175 GB.
FAMILIES = {
    "phi3.5-moe-42b-a6.6b": dict(tag="moe", width=(4096, 32, 8, 128, 6400,
                                                   32_064),
                                 serve=(8, 2, 4, 2048), train=1),
    "recurrentgemma-2b": dict(tag="rg", width=(2560, 10, 1, 256, 7680,
                                               256_000),
                              serve=(None, 4, 2, 3072), train=4),
    "rwkv6-7b": dict(tag="rwkv", width=(4096, 64, 64, 64, 14_336, 65_536),
                     serve=(None, 2, 4, 2048), train=3, profile=4),
    "whisper-large-v3": dict(tag="whisper", width=(1280, 20, 20, 64, 5120,
                                                   51_866),
                             serve=(None, 4, 4, 256), train=8,
                             train_encoder=8, batch=8),
    "llama-3.2-vision-90b": dict(tag="vlm", width=(8192, 64, 8, 128, 28_672,
                                                   128_256),
                                 serve=(5, 2, 2, 2048), train=None),
}
# a vlm gate is 0 in fresh draws (tanh(0) hides the cross-attention): the
# value the anchor's prefill is checked at once more
VLM_GATE = 0.5
# their sampling runs: the train driver's defaults (4 clients x 64 x 128,
# minibatch 8, bf16 'scalar' bank, C = 1, h = TRAIN_H) but FAM_FIT fit
# steps and FAM_R rounds x FAM_T steps (3 rounds until the script's time
# was cut)
FAM_FIT, FAM_R, FAM_T = 4, 2, 2
# Adaptive refresh in [fig2-3]: REFRESH_ROUNDS rounds x REFRESH_T steps,
# the bank re-fitted every REFRESH_EVERY rounds.
REFRESH_ROUNDS, REFRESH_T, REFRESH_EVERY = 20, 50, 5


def log(msg: str) -> None:
    print(msg, flush=True)


_PHASE_START = []


def host_gb() -> float:
    """This process's resident host memory, GB (the card's machine ends a
    command at 96 GiB)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def free_host_cache() -> None:
    """Give the pinned host blocks that PyTorch caches once freed (a train
    phase's bank stack: 16-18 GB at full width) back to the system, so
    that they do not add up over the phases."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def phase(title: str) -> None:
    """A phase's header, with the device memory held when it starts, the
    host's resident memory (after ``free_host_cache``) and the host
    seconds since the previous header."""
    free_host_cache()
    now = time.perf_counter()
    since = (f"; {now - _PHASE_START[-1]:.1f} s since the last header"
             if _PHASE_START else "")
    _PHASE_START.append(now)
    log(f"{title} ({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"host {host_gb():.2f} GB resident{since})")


def cuda_sync() -> None:
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def _first(out):
    return out if isinstance(out, tuple) else (out,)


ERR_CHUNK = 1 << 26  # elements compared at a time (bounded temporaries)


def _err(a, b, bf16_rows=None):
    """Largest |kernel - plain|, checked against the stated tolerance
    (``bf16_rows``: a mask of the rows held to one bf16 ulp), over
    chunks of rows, so that billion-parameter buffers need no full-size
    temporaries."""
    worst = 0.0
    for x, y in zip(_first(a), _first(b)):
        step = max(1, ERR_CHUNK // max(1, x[0].numel()))
        for r0 in range(0, x.shape[0], step):
            xs, ys = x[r0:r0 + step], y[r0:r0 + step]
            d = (xs - ys).abs()
            bound = ATOL + RTOL * ys.abs()
            if bf16_rows is not None:
                wide = bf16_rows[r0:r0 + step]
                bound[wide] = torch.maximum(bound[wide],
                                            BF16_REL * ys[wide].abs())
            if not bool(torch.isfinite(xs).all()) or \
                    bool((d > bound).any()):
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: max |diff| "
                                     f"{float(d.max()):.3e}")
            worst = max(worst, float(d.max()))
    return worst


def _packed_operands(gen, layout, C, variant, dynamics):
    dev = gen.device
    rows, shared = C * layout.rows_total, layout.rows_total
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    ops = {}
    if variant != "plain":
        ops.update(mu_g=rn(shared, 128), mu_s=rn(rows, 128))
    if variant == "diag":
        ops.update(lam_g=rn(shared, 128).abs() + 0.1,
                   lam_s=rn(rows, 128).abs() + 0.1)
    if dynamics == "sghmc":
        ops["r2d"] = rn(rows, 128)
    L = layout.num_leaves
    seeds = torch.randint(0, 2**31 - 1, (C, L), generator=gen, device=dev)
    sc = rn(C, L, 9).abs() * 0.1 + 0.05
    return rn(rows, 128), rn(rows, 128) * 50, seeds, sc, ops


def check_kernels(gen, main_shapes, leaf_shapes):
    """Both entries, all 6 variant x dynamics cells: a ragged 4-leaf layout
    with a bf16 leaf (through quantize) at C = 3, and the main paths' own
    shapes (``main_shapes`` packed, ``leaf_shapes`` (C, rows per chain,
    block rows) per-leaf). Returns the worst |diff| per entry at the main
    paths' shapes (float32 throughout)."""
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch.kernels import ops as kops
    ragged = kops.make_packed_layout({
        "a": torch.zeros(1500), "b": torch.zeros(7, 11),
        "c": torch.zeros(2100, dtype=torch.bfloat16), "d": torch.zeros(3)})
    bf16 = ragged.dtypes.index(torch.bfloat16)
    off, r = ragged.row_offsets[bf16], ragged.rows[bf16]
    worst = {"fsgld_update_packed": 0.0, "fsgld_update_2d": 0.0}
    for variant in fk.VARIANTS:
        for dynamics in fk.DYNAMICS:
            cells = []
            for name, layout, C in [("ragged4", ragged, 3)] + main_shapes:
                th, g, seeds, sc, ops = _packed_operands(
                    gen, layout, C, variant, dynamics)
                sl, sb = layout.tables(th.device)
                kw = dict(variant=variant, dynamics=dynamics, seg_leaf=sl,
                          seg_base=sb, block_rows=layout.block_rows,
                          chains=C, **ops)
                ref = fk.fsgld_update_packed_plain(th, g, seeds, sc, **kw)
                out = fk.fsgld_update_packed(th, g, seeds, sc, **kw)
                rows = None
                if not layout.all_fp32:
                    out = tuple(layout.quantize(o) for o in _first(out))
                    ref = tuple(layout.quantize(o) for o in _first(ref))
                    rows = torch.zeros(C, layout.rows_total,
                                       dtype=torch.bool, device=th.device)
                    rows[:, off:off + r] = True
                    rows = rows.reshape(-1)
                cuda_sync()
                e = _err(out, ref, rows)
                if rows is None:
                    worst["fsgld_update_packed"] = max(
                        worst["fsgld_update_packed"], e)
                cells.append(f"packed/{name} {e:.3e}")
            # the per-leaf entry, chain-batched: 2 blocks of 256 rows at
            # C = 3, then the per-leaf path's own shapes
            for C, rows_c, br in [(3, 512, 256)] + leaf_shapes:
                th, g, seeds, sc, ops = _packed_operands(
                    gen, kops.make_packed_layout(torch.zeros(rows_c * 128),
                                                 block_rows=rows_c), C,
                    variant, dynamics)
                kw = dict(variant=variant, dynamics=dynamics, chains=C,
                          **ops)
                out = fk.fsgld_update_2d(th, g, seeds[:, 0], sc[:, 0],
                                         block_rows=br, **kw)
                ref = fk.fsgld_update_2d_plain(th, g, seeds[:, 0],
                                               sc[:, 0], **kw)
                cuda_sync()
                e = _err(out, ref)
                if (C, rows_c, br) in leaf_shapes:
                    worst["fsgld_update_2d"] = max(worst["fsgld_update_2d"],
                                                   e)
                cells.append(f"2d/C={C}x{rows_c} {e:.3e}")
            log(f"  {variant:6s} {dynamics:8s} max|kernel-plain|: "
                + ", ".join(cells))
    return worst


def _qkv(gen, B, S, H, Hkv, hd, dtype):
    dev = gen.device
    return (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype))


def flash_err(out, ref, bound=None):
    """(max |kernel - plain|, the largest share of the tolerance
    ``bound(ref)`` (default: the kernel's ``tolerance``) used); the share
    is infinite for a wrong dtype or a non-finite output."""
    from repro_torch.kernels import flash_attention as fa
    bound = bound or fa.tolerance
    d = (out.float() - ref.float()).abs()
    if out.dtype != ref.dtype or not bool(torch.isfinite(out).all()):
        return float(d.max()), math.inf
    return float(d.max()), float((d / bound(ref).clamp_min(1e-30)).max())


def flash_sweep(gen, bound=None):
    """Every cell of the kernel-vs-plain sweep: causal, causal + window and
    non-causal, fp32 and bf16, Hkv = H and H/2, each hd of FLASH_HDS, a
    ragged S (1,000) and a multi-tile S (2,048). Yields (dtype, causal,
    window, max |diff|, share of the tolerance used; see ``flash_err``)."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in ((True, None), (True, 300), (False, None)):
            for (H, Hkv), hd, S in itertools.product(
                    ((4, 4), (4, 2)), FLASH_HDS, (1000, 2048)):
                q, k, v = _qkv(gen, 2, S, H, Hkv, hd, dtype)
                out = fa.flash_attention(q, k, v, causal=causal,
                                         window=window)
                ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
                cuda_sync()
                yield (dtype, causal, window) + flash_err(out, ref, bound)


def sweep_groups(cells):
    """Sweep cells grouped by (dtype, causal, window): the largest |diff|
    and the largest share of the tolerance, over the group's cells."""
    groups = {}
    for dtype, causal, window, err, use in cells:
        e, u, n = groups.get((dtype, causal, window), (0.0, 0.0, 0))
        groups[dtype, causal, window] = (max(e, err), max(u, use), n + 1)
    return groups


def check_flash(gen):
    """The sweep of ``flash_sweep``, then the serving path's prefill
    shape. Returns the worst |diff| at the path's shape."""
    from repro_torch.kernels import flash_attention as fa
    failed = False
    for (dtype, causal, window), (err, use, n) in sweep_groups(
            flash_sweep(gen)).items():
        failed = failed or not use <= 1
        log(f"  {str(dtype)[6:]:8s} causal={causal!s:5s} "
            f"window={window!s:4s}: {n} cells (Hkv=H,H/2 x hd "
            f"{','.join(map(str, FLASH_HDS))} x S 1000,2048), "
            f"max|kernel-plain| {err:.3e}, {100 * use:.1f}% of the "
            "tolerance at most")
    q, k, v = _qkv(gen, *FLASH_PATH, torch.bfloat16)
    worst, use = flash_err(fa.flash_attention(q, k, v),
                           fa.flash_attention_plain(q, k, v))
    log(f"  serving path shape (B, S, H, Hkv, hd) = {FLASH_PATH}, causal, "
        f"bf16: max|kernel-plain| {worst:.3e}, {100 * use:.1f}% of the "
        "tolerance")
    if failed or not use <= 1:
        raise AssertionError("flash kernel disagrees with its plain version")
    return worst


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def call_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed eager calls after ``warmup``:
    at small shapes this is the host's time through the wrapper, the
    device idling between the events."""
    for _ in range(warmup):
        fn()
    cuda_sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int, replays: int = 20) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times between CUDA events after a
    warm-up; the median replay over ``calls``. Host dispatch is out of
    the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    cuda_sync()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


# operations per element (integer and float, transcendental = 1): the
# noise hash 22, uniforms 6, Box-Muller 6, drift 3 (+8 for a surrogate
# variant), Langevin update 7 / SGHMC 10
def ops_per_element(variant: str, dynamics: str) -> int:
    return 34 + 3 + (0 if variant == "plain" else 8) \
        + (7 if dynamics == "langevin" else 10)


def bound_ms(variant, dynamics, C, n, L):
    """Least time on an H100 for the update of ``n`` live parameters per
    chain (pad excluded): bytes each input read once + each output written
    once, over the memory rate; operations over the fp32 rate. The inputs
    are theta, g, mu_s, lam_s (and r) per chain, mu_g and lam_g once, and
    a seed and 9-float scalar row per (chain, leaf)."""
    per_chain = 2 + {"plain": 0, "scalar": 1, "diag": 2}[variant] \
        + (2 if dynamics == "sghmc" else 0) + 1          # ins + theta'
    shared = {"plain": 0, "scalar": 1, "diag": 2}[variant]
    nbytes = 4 * (per_chain * C * n + shared * n) + C * L * 4 * 10
    ops = ops_per_element(variant, dynamics) * C * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def time_kernels(gen, shapes):
    """(kernel ms, plain ms, bound ms, bound_by, bytes) per named shape.
    The seeds are int32, as the engine's draws hand them to the kernel (a
    wider integer would add its conversion's launches to the time)."""
    from repro_torch.kernels import fsgld_update as fk
    rows = {}
    for name, entry, layout, C, calls in shapes:
        th, g, seeds, sc, ops = _packed_operands(gen, layout, C, "diag",
                                                 "langevin")
        seeds = fk._seeds_i32(seeds)
        if entry == "fsgld_update_packed":
            sl, sb = layout.tables(th.device)
            kw = dict(variant="diag", seg_leaf=sl, seg_base=sb,
                      block_rows=layout.block_rows, chains=C, **ops)
            kern = lambda: fk.fsgld_update_packed(  # noqa: E731
                th, g, seeds, sc, **kw)
            plain = lambda: fk.fsgld_update_packed_plain(  # noqa: E731
                th, g, seeds, sc, dynamics="langevin", **kw)
            L = layout.num_leaves
        else:
            # one leaf, 8-row blocks as the per-leaf executor pads it
            kw = dict(variant="diag", chains=C, **ops)
            kern = lambda: fk.fsgld_update_2d(  # noqa: E731
                th, g, seeds[:, 0], sc[:, 0],
                block_rows=layout.block_rows, **kw)
            plain = lambda: fk.fsgld_update_2d_plain(  # noqa: E731
                th, g, seeds[:, 0], sc[:, 0], dynamics="langevin", **kw)
            L = 1
        ms = device_ms(kern, calls=calls)
        plain_ms = device_ms(plain, calls=max(1, calls // 4),
                             replays=20 if calls > 1 else 5)
        wrap_ms = call_ms(kern)
        n_live = sum(layout.sizes)
        b_ms, b_by, nbytes = bound_ms("diag", "langevin", C, n_live, L)
        rows[name] = (ms, plain_ms, b_ms, b_by, nbytes)
        log(f"  {name}: {entry} diag/langevin C={C} "
            f"rows/chain={layout.rows_total} live/chain={n_live}: "
            f"kernel {ms:.4f} ms on the device ({wrap_ms:.4f} ms per eager "
            f"call through the wrapper), plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.7f} ms ({b_by}; {nbytes} live bytes), "
            f"{100 * b_ms / ms:.2f}% of bound")
    return rows


def flash_bound_ms(B, S, H, Hkv, hd, itemsize, causal=True):
    """Least time on an H100 for causal (or bidirectional) attention at
    this shape: q, k, v and out each moved once over the memory rate, or
    4*B*H*hd flops per unmasked (query, key) pair over the bf16
    tensor-core rate."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def sdpa_backend_ms(sdpa, calls, replays):
    """The SDPA yardstick's device ms under each backend that accepts the
    call ({backend: ms, or the reason it refused})."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                out[backend.name] = device_ms(sdpa, calls=calls,
                                              replays=replays)
        except RuntimeError as e:
            out[backend.name] = str(e).splitlines()[0][:100]
    return out


def time_flash(gen):
    """(kernel ms, plain ms, SDPA ms, bound ms, bound_by) at the serving
    path's prefill shape and at whisper's encoder shape (not causal), and
    kernel / SDPA ms at the long shape; SDPA is also timed under each of
    its backends."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = {}
    for name, shape, calls, causal in (
            ("path", FLASH_PATH, 20, True), ("long", FLASH_LONG, 1, True),
            ("encoder", FLASH_ENCODER, 20, False)):
        q, k, v = _qkv(gen, *shape, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        replays = 20 if calls > 1 else 5
        ms = device_ms(lambda: fa.flash_attention(  # noqa: B023
            q, k, v, causal=causal), calls=calls, replays=replays)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal,  # noqa: B023
                enable_gqa=True)

        sdpa_ms = device_ms(sdpa, calls=calls, replays=replays)
        backends = sdpa_backend_ms(sdpa, calls, replays)
        plain_ms = None
        if name != "long":
            plain_ms = device_ms(
                lambda: fa.flash_attention_plain(  # noqa: B023
                    q, k, v, causal=causal), calls=1, replays=5)
        b_ms, b_by, nbytes, flops = flash_bound_ms(*shape, 2, causal)
        rows[name] = (ms, plain_ms, sdpa_ms, b_ms, b_by)
        log(f"  flash_attention {name} (B, S, H, Hkv, hd) = {shape} "
            f"{'causal' if causal else 'not causal'} "
            f"bf16: kernel {ms:.4f} ms, plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
            f"SDPA (library) {sdpa_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {flops:.3e} flops, {nbytes} bytes), "
            f"{100 * b_ms / ms:.1f}% of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        log(f"  SDPA {name} by backend: " + ", ".join(
            f"{b} {v:.4f} ms" if isinstance(v, float) else f"{b} refused "
            f"({v})" for b, v in backends.items()))
    return rows


# ---------------------------------------------------------------------------
# the production dry run (launch.dryrun) against the card
# ---------------------------------------------------------------------------

def start_dryruns(root: str) -> list:
    """The [dryrun] phase's fake-world traces, started at the beginning:
    each a process of its own (a fake world is process-global), on the
    CPU only, one thread each: DRY_GRID's combinations of the pods' grids
    and the one-card prediction of the step [dryrun] runs. Returns
    [(what, process, JSON path)]."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    runs = [(f"{a}|{s}|{pod}", ["--arch", a, "--shape", s]
             + (["--multi-pod"] if pod == "pod2" else []))
            for a, s, pod in DRY_GRID]
    runs.append(("card prediction", [
        "--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh-shape",
        "1,1", "--batch", str(DRY_B), "--seq-len", str(DRY_S)]))
    out = []
    for i, (what, argv) in enumerate(runs):
        path = os.path.join(root, f"dryrun{i}.json")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--json-out", path], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        out.append((what, proc, path))
    atexit.register(_stop, [proc for _, proc, _ in out])
    return out


def _stop(procs) -> None:
    """Kill what is still running (an earlier phase failed)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dryrun_result(what, proc, path, timeout=900):
    """A dry-run process's OK / SKIP / FAIL lines and its one result."""
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("OK ", "SKIP ", "FAIL ", "done:"))]
    for ln in lines:
        log(f"  {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"[dryrun] {what}: exit {proc.returncode}: "
                             f"{text[-2000:]}")
    with open(path) as f:
        (info,) = json.load(f).values()
    return info


def phase_dryrun(dev, runs):
    """(a) DRY_GRID's combinations and the one-card prediction,
    traced meanwhile on the CPU; (b) on the card, qwen3-1.7b at full width
    and depth: ``launch.steps.make_train_step`` for DRY_STEPS steps at
    (DRY_B, DRY_S), fed by ``data.pipeline.FederatedPipeline`` over
    DRY_CLIENTS token_shards clients on a categorical schedule, each step
    56 flash and 14 update launches: the differentiable flash entry held
    against plain autograd at the step's attention shape first; step 0's
    14 leaf updates each held against the plain version on the same
    operands; step 1 under the dry run's op counter, its FLOPs and peak
    memory against the prediction; the rest timed against the roofline
    bound; then ``make_prefill_step`` (28 flash launches) and DRY_STEPS + 1
    ``make_serve_step`` tokens after ``prefill_with_cache`` (none). Every
    trace must be OK: placed by the rules, nothing resharded."""
    from repro_torch import tree as tu
    from repro_torch.configs import SamplerConfig, get_config
    from repro_torch.data import token_shards
    from repro_torch.data.pipeline import (ClientDataset, FederatedPipeline,
                                           categorical_schedule)
    from repro_torch.launch.steps import (init_surrogate_state,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import (init_params, prefill_with_cache,
                                    serving_cast, serving_params)
    from repro_torch.roofline import report
    from repro_torch.roofline.hlo_analysis import OpCounter
    *grid, (_, pproc, ppath) = runs
    for what, proc, path in grid:
        info = _dryrun_result(what, proc, path)
        if info.get("status") != "ok":
            raise AssertionError(f"[dryrun] {what}: {info}")
        log(f"  {what}: collective bytes per device "
            f"{info['static_collective_total']:.4e} "
            + json.dumps({k: float(v) for k, v in sorted(
                info["static_collective_bytes"].items())}))
    pred = _dryrun_result("card prediction", pproc, ppath)
    if pred.get("status") != "ok":
        raise AssertionError(f"[dryrun] card prediction: {pred}")

    cfg = get_config("qwen3-1.7b")
    check_flash_diff(dev, (DRY_B, DRY_S, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim))
    cuda_sync()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    surr = init_surrogate_state(params)
    shards = token_shards(torch.Generator().manual_seed(1),
                          num_shards=DRY_CLIENTS, shard_size=2 * DRY_B,
                          seq_len=DRY_S, vocab_size=cfg.vocab_size)
    clients = [ClientDataset({k: v[c].numpy() for k, v in shards.items()},
                             seed=c) for c in range(DRY_CLIENTS)]
    pipe = FederatedPipeline(clients, DRY_B, categorical_schedule(
        [1.0 / DRY_CLIENTS] * DRY_CLIENTS, seed=2), device=dev)
    n = 2 * DRY_B     # N_s / (f_s m), f_s = 1 / clients
    step = make_train_step(cfg, SamplerConfig(
        method="fsgld", step_size=TRAIN_H, num_shards=DRY_CLIENTS),
        scale=n / (DRY_B / DRY_CLIENTS), f_s=1.0 / DRY_CLIENTS)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_leaves = len(tu.leaves(params))
    flash = grad_attn_launches(cfg)
    times, lls = [], []
    for i in range(DRY_STEPS):
        s, batch = next(pipe)
        mode = (LeafUpdateCheck() if i == 0 else OpCounter() if i == 1
                else contextlib.nullcontext())
        if i == 1:
            cuda_sync()
            torch.cuda.reset_peak_memory_stats()

        def one(batch=batch, mode=mode):
            with mode:
                return step(params, surr, batch, gen)
        (params, m), dt, _, _ = _counted(
            f"[dryrun] train step {i}", one,
            {"fsgld_update_2d": n_leaves, "fsgld_update_packed": 0}, flash)
        lls.append(float(m["ll_per_token"]))
        if i == 0:
            if mode.n != n_leaves:
                raise AssertionError(f"[dryrun] {mode.n} leaf updates "
                                     f"checked, {n_leaves} leaves")
            log(f"  step 0's {mode.n} leaf updates (fsgld_update_2d, "
                f"'scalar') against the plain version on the same leaves, "
                f"seeds and surrogate operand: max |kernel - plain| "
                f"{mode.err:.3e} (tolerance {ATOL:g} + {RTOL:g}|x|)")
        elif i == 1:
            peak = torch.cuda.max_memory_allocated() - base
            card = mode.result()
        else:
            times.append(dt * 1e3)
        log(f"  train step {i}: client {s}, {dt * 1e3:.2f} ms, ll/token "
            f"{lls[-1]:.4f}, launches: update {n_leaves}, flash {flash}")
    assert all(math.isfinite(x) for x in lls), lls
    rel = abs(card["flops"] - pred["flops"]) / pred["flops"]
    ratio = pred["peak_bytes"] / peak
    log(f"  FLOPs per step: card {card['flops']:.6e} (the op counter on the "
        f"real step), predicted {pred['flops']:.6e} on a fake (1, 1) world: "
        f"{100 * rel:.4f}% apart (limit {100 * DRY_FLOPS_REL:g}%)")
    log(f"  HBM bytes per step: card {card['static_hbm_bytes']:.6e}, "
        f"predicted {pred['static_hbm_bytes']:.6e}")
    log(f"  peak memory of the step: card {peak / 1e9:.3f} GB "
        f"(max_memory_allocated less the {base / 1e9:.3f} GB held before "
        f"its arguments), predicted {pred['peak_bytes'] / 1e9:.3f} GB: "
        f"ratio {ratio:.4f} (limit {DRY_PEAK}); arguments "
        f"{pred['argument_size_bytes'] / 1e9:.3f} GB")
    terms = report.row_terms(pred)
    t_c, t_m = terms["t_compute"], terms["t_memory"]
    bound = 1e3 * max(t_c, t_m)
    ms = statistics.mean(times)
    by = "compute" if t_c >= t_m else "memory"
    least = pred["argument_size_bytes"] + pred["output_size_bytes"]
    log(f"  step time {ms:.2f} ms (mean of steps 2-{DRY_STEPS - 1}) against "
        f"the roofline bound {bound:.2f} ms ({by}; compute: the counted "
        f"FLOPs, the recompute's included, {1e3 * t_c:.2f} ms at "
        f"{report.PEAK_FLOPS:g} FLOP/s; memory: the arguments read once "
        f"and the outputs written once, {least / 1e9:.3f} GB, "
        f"{1e3 * t_m:.2f} ms at {report.HBM_BW:g} B/s): "
        f"{100 * bound / ms:.2f}% of the bound; the eager op stream's "
        f"traffic ({pred['static_hbm_bytes'] / 1e12:.3f} TB of operand + "
        f"result bytes) at the HBM rate takes "
        f"{1e3 * terms['t_opstream']:.2f} ms, not a bound")
    if rel > DRY_FLOPS_REL:
        raise AssertionError(f"[dryrun] FLOPs {card['flops']} vs predicted "
                             f"{pred['flops']}")
    if not DRY_PEAK[0] <= ratio <= DRY_PEAK[1]:
        raise AssertionError(f"[dryrun] predicted/card peak {ratio:.4f}")

    _, batch = next(pipe)
    toks, dt, _, _ = _counted(
        "[dryrun] prefill step",
        lambda: make_prefill_step(cfg)(params, {"tokens": batch["tokens"]}),
        {"fsgld_update_2d": 0, "fsgld_update_packed": 0}, attn_layers(cfg))
    assert toks.dtype == torch.int32 and toks.shape == (DRY_B,)
    log(f"  prefill step ({DRY_B}, {DRY_S}): {dt * 1e3:.2f} ms, "
        f"{attn_layers(cfg)} flash launches")
    draw = serving_cast(params)
    del params, surr
    logits, cache = prefill_with_cache(serving_params(draw), cfg,
                                       batch["tokens"], DRY_S + DRY_STEPS + 1)
    serve = make_serve_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for t in range(DRY_STEPS + 1):
        pos = torch.full((DRY_B,), DRY_S + t, dtype=torch.int64, device=dev)
        (tok, cache), dt, _, _ = _counted(
            f"[dryrun] serve step {t}",
            lambda tok=tok, pos=pos: serve(draw, cache, tok, pos),
            {"fsgld_update_2d": 0, "fsgld_update_packed": 0}, 0)
        tok = tok[:, None]
    log(f"  {DRY_STEPS + 1} serve steps after prefill_with_cache: last "
        f"{dt * 1e3:.2f} ms, no flash launch; tokens {tok[:, 0].tolist()}")
    del draw, cache


def launch_floor_ms() -> float:
    """Device time of an empty kernel (``torch.cuda._sleep(0)``: one launch
    that returns at once) per launch, 200 of them in a CUDA graph: the
    least any kernel launch takes on this card."""
    return device_ms(lambda: torch.cuda._sleep(0), calls=200)


# ---------------------------------------------------------------------------
# the sampling paths
# ---------------------------------------------------------------------------

def table1_setup(dev):
    """Table-1 data and a Fisher bank fitted on the card at
    table1_bnn.py's settings (non-IID Beta(0.5, 0.5) labels)."""
    from repro_torch.core import fit_bank_fisher, sample_local_likelihood
    from repro_torch.data import susy_shards, susy_test_set
    from repro_torch.workloads import TABLE1_P, table1_log_lik
    g = torch.Generator(device=dev).manual_seed(0)
    shards, _ = susy_shards(g, num_shards=T1_S, shard_size=T1_N,
                            beta_a=0.5)
    test = susy_test_set(torch.Generator(device=dev).manual_seed(7),
                         size=4000)
    theta0 = 0.1 * torch.randn(TABLE1_P, generator=g, device=dev)
    t0 = time.perf_counter()
    samples = sample_local_likelihood(
        table1_log_lik, shards, theta0, g, minibatch=T1_M, step_size=T1_H,
        num_steps=400, burn_in=200, thin=2, prior_precision=1.0)
    bank = fit_bank_fisher(table1_log_lik, shards, samples.mean(1),
                           batch=2000)
    cuda_sync()
    log(f"  surrogate fit on the card (400 local SGLD steps x {T1_S} "
        f"clients + Fisher over {T1_S * T1_N} points): "
        f"{time.perf_counter() - t0:.2f} s")
    return shards, test, theta0, bank


def time_small_fit(dev, shards, theta0):
    """The local-SGLD 'scalar' fit of the Table-1 BNN on its T1_S clients
    (SurrogateSpec's 200 steps; under the fit's trace budget, so every
    client runs in one batch): the median of 5 fits, host clock."""
    from repro_torch import api
    from repro_torch.workloads import table1_log_lik
    times = []
    for rep in range(6):
        cuda_sync()
        t0 = time.perf_counter()
        api.fit_bank_local_sgld(table1_log_lik, shards, theta0,
                                _gen(dev, rep), fit_steps=200,
                                minibatch=T1_M, step_size=T1_H)
        cuda_sync()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times[1:])
    log(f"  local-SGLD 'scalar' fit ({T1_S} clients, 200 steps, all "
        f"clients at once): {ms:.2f} ms (median of 5 after a warm-up)")
    return ms


def _counted(name, fn, expect, flash=None):
    """Run ``fn`` with the launch counts set to 0 just before it and read
    just after; ``expect`` maps update entry -> launches it must make,
    ``flash`` the flash-attention launches (when given). Returns (fn's
    result, host seconds, update counts, flash launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fsgld_update as fk
    cuda_sync()
    fk.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    cuda_sync()
    dt = time.perf_counter() - t0
    counts, n_flash = dict(fk.LAUNCHES), fa.LAUNCHES["flash_attention"]
    if any(counts[k] != v for k, v in expect.items()) or \
            (flash is not None and n_flash != flash):
        raise AssertionError(f"{name}: launches {counts}, flash {n_flash}; "
                             f"expected {expect}, flash {flash}")
    return out, dt, counts, n_flash


def run_path(name, sampler, gen, theta0, expect, dynamics=None):
    """Drive one path with the launch counts set to 0 just before it and
    read just after; ``expect`` maps entry -> launches it must make (and
    every one of them with ``dynamics``, when given)."""
    from repro_torch.kernels import fsgld_update as fk
    out, dt, counts, _ = _counted(name, lambda: sampler.sample(gen, theta0),
                                  expect)
    if dynamics is not None and \
            fk.DYNAMICS_LAUNCHES[dynamics] != sum(counts.values()):
        raise AssertionError(f"{name}: launches by dynamics "
                             f"{fk.DYNAMICS_LAUNCHES}, expected all "
                             f"{dynamics}")
    from repro_torch import tree as tu
    if not all(bool(torch.isfinite(v).all()) for v in tu.leaves(out)):
        raise AssertionError(f"{name}: non-finite state")
    sched = sampler.schedule
    steps = sched.rounds * sched.local_steps * sched.n_chains
    log(f"  {name}: launches {counts}, {dt:.3f} s, "
        f"{steps / dt:.1f} chain-steps/s")
    return out, counts


def heldout_check(name, tr_a, tr_b, test):
    """Per-chain held-out log-lik over each chain's second half: run a
    must agree with run b within 5 standard errors of the difference of
    the two chain means (floor 0.01)."""
    from repro_torch.workloads import avg_loglik
    half = tr_a.shape[1] // 2
    ll_a = torch.tensor([avg_loglik(c[half:], test) for c in tr_a])
    ll_b = torch.tensor([avg_loglik(c[half:], test) for c in tr_b])
    se = math.sqrt(float(ll_a.var() + ll_b.var()) / tr_a.shape[0])
    diff = float(ll_a.mean() - ll_b.mean())
    log(f"  {name} held-out avg log-lik: {float(ll_a.mean()):.4f} (chains "
        f"{ll_a.tolist()}), reference {float(ll_b.mean()):.4f} (chains "
        f"{ll_b.tolist()}); difference {diff:.4f}, standard error "
        f"{se:.4f}")
    if not (math.isfinite(diff) and abs(diff) < max(0.01, 5 * se)):
        raise AssertionError(f"{name}: strays from its reference")


def same(name, a, b):
    """``a`` and ``b`` bitwise equal, leaf by leaf (a leaf of ``a`` is
    moved to its counterpart's device first)."""
    from repro_torch import tree as tu
    if not all(torch.equal(x.to(y.device), y)
               for x, y in zip(tu.leaves(a), tu.leaves(b))):
        raise AssertionError(f"{name}: the runs differ")
    log(f"  {name}: equal, bitwise")


class ExchangeTimer:
    """Times every call of the engine's exchange (host clock, the device
    synchronised before and after) while in a ``with`` block."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        from repro_torch.core import engine as teng
        self._real = real = teng.make_exchange

        def make(*a, **k):
            exchange, carry0 = real(*a, **k)

            def timed(*xa):
                cuda_sync()
                t0 = time.perf_counter()
                out = exchange(*xa)
                cuda_sync()
                self.seconds.append(time.perf_counter() - t0)
                return out

            return timed, carry0

        teng.make_exchange = make
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine as teng
        teng.make_exchange = self._real

    def line(self) -> str:
        if not self.seconds:
            return "no exchange"
        ms = sorted(1e3 * t for t in self.seconds)
        return (f"exchange {len(ms)} times, median "
                f"{statistics.median(ms):.4f} ms per communication round "
                f"(min {ms[0]:.4f}, max {ms[-1]:.4f})")


# ---------------------------------------------------------------------------
# the federated comparisons
# ---------------------------------------------------------------------------

def t1_sampler(dev, shards, bank, executor, *, rounds=T1_ROUNDS,
               local_steps=T1_T, thin=20, method="fsgld", step_size=T1_H,
               exe=None, **kw):
    """The Table-1 BNN through the facade (a Fisher bank for FSGLD);
    ``exe``: more ``Execution`` fields."""
    from repro_torch import api
    from repro_torch.workloads import table1_log_lik
    return api.FSGLD(
        api.Posterior(table1_log_lik, prior_precision=1.0), shards,
        minibatch=T1_M, step_size=step_size, method=method,
        surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                   if method == "fsgld" else None),
        schedule=api.Schedule(rounds=rounds, local_steps=local_steps,
                              n_chains=T1_CHAINS, thin=thin),
        execution=api.Execution(device=dev, executor=executor,
                                **(exe or {})), **kw)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _expect(executor, steps):
    """Launches a Table-1 path must make: one per step (one leaf)."""
    return {"fsgld_update_packed": steps if executor == "packed" else 0,
            "fsgld_update_2d": steps if executor == "per_leaf" else 0}


def timed_exchange(name, sampler, gen, theta0):
    """One more run of a path with every exchange timed."""
    with ExchangeTimer() as timer:
        sampler.sample(gen, theta0)
    log(f"  {name}: {timer.line()}")


def phase_sghmc(dev, shards, test, theta0, bank):
    from repro_torch.workloads import avg_loglik
    steps = T1_ROUNDS * T1_T
    runs = {}
    for ex in ("packed", "per_leaf", "vmap"):
        runs[ex], _ = run_path(
            f"sghmc/{ex}", t1_sampler(dev, shards, bank, ex, kernel="sghmc",
                                      friction=SGHMC_FRICTION,
                                      step_size=SGHMC_H),
            _gen(dev, 21), theta0, _expect(ex, steps), dynamics="sghmc")
    same("sghmc: packed == per_leaf", runs["packed"], runs["per_leaf"])
    heldout_check("sghmc packed vs vmap", runs["packed"], runs["vmap"], test)
    # a diverged pair of runs would pass the check above on its huge
    # standard error: no chain may fall below SGHMC_DIVERGED nats/point
    for ex in ("packed", "vmap"):
        tr = runs[ex]
        worst = min(avg_loglik(c[tr.shape[1] // 2:], test) for c in tr)
        if not worst > SGHMC_DIVERGED:
            raise AssertionError(f"sghmc/{ex} diverged: held-out log-lik "
                                 f"{worst:.4g} per point")


def phase_fed(dev, shards, theta0, bank, tr_main):
    tr, _ = run_path("identity/packed (the table1 run again)",
                     t1_sampler(dev, shards, bank, "packed",
                                federation="identity"),
                     _gen(dev, 20), theta0,
                     _expect("packed", T1_ROUNDS * T1_T))
    same("federation='identity' == federation=None", tr, tr_main)
    steps = FED_ROUNDS * FED_T
    for name in FED_SCENARIOS:
        out = {}
        for ex in ("packed", "per_leaf"):
            out[ex], _ = run_path(
                f"{name}/{ex}", t1_sampler(
                    dev, shards, bank, ex, rounds=FED_ROUNDS,
                    local_steps=FED_T, thin=5, federation=name),
                _gen(dev, 22), theta0, _expect(ex, steps),
                dynamics="langevin")
        same(f"{name}: packed == per_leaf", out["packed"], out["per_leaf"])
        timed_exchange(f"{name}/packed", t1_sampler(
            dev, shards, bank, "packed", rounds=FED_ROUNDS,
            local_steps=FED_T, thin=5, federation=name),
            _gen(dev, 22), theta0)


def phase_fald(dev, shards, theta0):
    from repro_torch.rivals import fald_run_vmap
    from repro_torch.workloads import table1_log_lik
    steps = FED_ROUNDS * FED_T
    for fed in (None, "elf-bidir-qsgd-8bit"):
        name = f"fald {fed or 'exact'}"

        def make(ex, fed=fed):
            return t1_sampler(dev, shards, None, ex, rounds=FED_ROUNDS,
                              local_steps=FED_T, thin=5, method="fald",
                              federation=fed)

        s = make("packed")
        tr, _ = run_path(f"{name}/packed", s, _gen(dev, 23), theta0,
                         _expect("packed", steps), dynamics="langevin")
        ref = fald_run_vmap(table1_log_lik, s.cfg, s.data, T1_M,
                            _gen(dev, 23), theta0, FED_ROUNDS,
                            n_chains=T1_CHAINS, collect_every=5,
                            federation=fed, sizes=s.sizes, use_kernel=True)
        same(f"{name}: engine == fald_run_vmap oracle", tr, ref)
        timed_exchange(f"{name}/packed", make("packed"), _gen(dev, 23),
                       theta0)


def phase_mesh(dev, shards, theta0, bank):
    """The mesh path at one rank: an NCCL world of one process and a
    (1, 1) ('data', 'model') DeviceMesh on the card; a Table-1 packed run
    and an FA-LD run on it, each bitwise the run without it (the chains'
    gathers and FA-LD's average go through NCCL all-gathers), and the
    mesh's cost per round (the runs in turns). Returns the mesh."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_host_mesh("cuda")
    log(f"  backend {dist.get_backend()}, world {dist.get_world_size()}, "
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
        f"{mesh.device_type}")
    steps = T1_ROUNDS * T1_T
    packed = {"fsgld_update_packed": steps, "fsgld_update_2d": 0}
    runs = {}
    # the first run on the mesh sets up NCCL's communicators: untimed
    for tag in ("mesh",) + ("meshless", "mesh", "mesh", "meshless") * 2:
        exe = {"mesh": mesh} if tag == "mesh" else None
        out, dt, _, _ = _counted(
            f"mesh/table1 {tag}", lambda: t1_sampler(
                dev, shards, bank, "packed", exe=exe).sample(
                _gen(dev, 20), theta0), packed)
        runs.setdefault(tag, []).append((out, dt))
    same("mesh: Table-1 packed on the mesh == without",
         runs["mesh"][0][0], runs["meshless"][0][0])
    ms = {t: sorted(round(1e3 * dt / T1_ROUNDS, 3) for _, dt in r[-4:])
          for t, r in runs.items()}
    log(f"  Table-1 packed, {T1_ROUNDS} rounds x {T1_T} steps, C="
        f"{T1_CHAINS}: ms per round on the mesh {ms['mesh']}, without "
        f"{ms['meshless']} (in turns; {card_line()})")
    fed = "elf-bidir-qsgd-8bit"
    outs = []
    for exe in ({"mesh": mesh}, None):
        s = t1_sampler(dev, shards, None, "packed", rounds=FED_ROUNDS,
                       local_steps=FED_T, thin=5, method="fald",
                       federation=fed, exe=exe)
        outs.append(_counted(f"mesh/fald {fed} {'on' if exe else 'off'}",
                             lambda: s.sample(_gen(dev, 23), theta0),
                             _expect("packed", FED_ROUNDS * FED_T))[0])
    same(f"mesh: FA-LD under {fed} on the mesh == without", *outs)
    return mesh


def phase_fig2_3(dev):
    from repro_torch import api
    from repro_torch.workloads import (FIG2_3_CASES, FIG2_3_D, FIG2_3_H,
                                       FIG2_3_M, chain_mse, fig2_3_claims,
                                       gaussian_log_lik, gaussian_problem)
    data, post, bank = gaussian_problem(_gen(dev, 0))
    mse = {}
    for method, scen in FIG2_3_CASES:
        s = api.FSGLD(
            api.Posterior(gaussian_log_lik, prior_precision=1.0), data,
            minibatch=FIG2_3_M, step_size=FIG2_3_H, method=method,
            surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                       if method == "fsgld" else None),
            schedule=api.Schedule(rounds=FIG_ROUNDS, local_steps=1,
                                  n_chains=FIG_CHAINS),
            execution=api.Execution(device=dev, executor="packed"),
            federation=scen)
        tr, _ = run_path(f"fig2-3/{method} {scen}", s, _gen(dev, 2),
                         torch.zeros(FIG2_3_D, device=dev),
                         _expect("packed", FIG_ROUNDS), dynamics="langevin")
        mse[method, scen] = chain_mse(tr, post)
        log(f"    single-chain posterior-mean MSE {mse[method, scen]:.4e}")
    claims = fig2_3_claims(mse)
    log(f"  claims of fig2_3_gaussian.py: {claims}")
    if not all(claims.values()):
        raise AssertionError(f"Figs. 2-3 claims fail: {claims}")
    # adaptive refresh: the 'diag' bank re-fitted at the chain mean every
    # REFRESH_EVERY rounds (refresh_bank's per-example gradient pass over
    # each client), packed against per_leaf on one generator
    rounds, T = REFRESH_ROUNDS, REFRESH_T
    outs = {}
    for ex in ("packed", "per_leaf"):
        s = api.FSGLD(
            api.Posterior(gaussian_log_lik, prior_precision=1.0), data,
            minibatch=FIG2_3_M, step_size=FIG2_3_H,
            surrogate=api.SurrogateSpec(kind="diag", bank=bank,
                                        refresh_every=REFRESH_EVERY),
            schedule=api.Schedule(rounds=rounds, local_steps=T,
                                  n_chains=FIG_CHAINS),
            execution=api.Execution(device=dev, executor=ex))
        outs[ex], _ = run_path(
            f"fig2-3/fsgld refresh_every={REFRESH_EVERY} {ex}", s,
            _gen(dev, 4), torch.zeros(FIG2_3_D, device=dev),
            _expect(ex, rounds * T), dynamics="langevin")
    same("fig2-3: the refreshing run, packed == per_leaf", outs["packed"],
         outs["per_leaf"])
    log(f"    {rounds} rounds x {T} steps, {rounds // REFRESH_EVERY - 1} "
        f"refreshes: single-chain posterior-mean MSE "
        f"{chain_mse(outs['packed'], post):.4e}")


def phase_frontier(dev):
    from repro_torch import api
    from repro_torch.fed import get_scenario
    from repro_torch.workloads import (FIG2_3_H, FIG2_3_M, FRONTIER_D,
                                       FRONTIER_METHODS, FRONTIER_N,
                                       FRONTIER_S, FRONTIER_SCENARIOS,
                                       gaussian_log_lik, gaussian_problem)
    data, post, bank = gaussian_problem(_gen(dev, 0), num_shards=FRONTIER_S,
                                        shard_size=FRONTIER_N,
                                        dim=FRONTIER_D)
    exact = get_scenario("identity").compression.bytes_per_round(FRONTIER_D)
    for method in FRONTIER_METHODS:
        for scen in FRONTIER_SCENARIOS:
            s = api.FSGLD(
                api.Posterior(gaussian_log_lik, prior_precision=1.0), data,
                minibatch=FIG2_3_M, step_size=FIG2_3_H, method=method,
                surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                           if method == "fsgld" else None),
                schedule=api.Schedule(rounds=FRONTIER_ROUNDS, local_steps=1,
                                      n_chains=FRONTIER_CHAINS),
                execution=api.Execution(device=dev, executor="packed"),
                federation=scen)
            tr, _ = run_path(f"frontier/{method} {scen}", s, _gen(dev, 2),
                             torch.zeros(FRONTIER_D, device=dev),
                             _expect("packed", FRONTIER_ROUNDS),
                             dynamics="langevin")
            half = tr[:, tr.shape[1] // 2:]
            m = float(((half.mean((0, 1)) - post) ** 2).sum())
            fed = get_scenario(scen)
            bpr = fed.compression.bytes_per_round(FRONTIER_D)
            n_comm = -(-FRONTIER_ROUNDS // fed.schedule.delay)
            log(f"    posterior-mean MSE {m:.4e}; {bpr:.0f} bytes per chain "
                f"per communication round, {n_comm} communications")
            if method == "fsgld" and not m < FRONTIER_CEILING:
                raise AssertionError(f"frontier: FSGLD {scen} MSE {m} "
                                     f"above {FRONTIER_CEILING}")
            if not fed.compression.identity and not bpr < exact:
                raise AssertionError(f"frontier: {scen} saves no bytes")


# ---------------------------------------------------------------------------
# the paper's own workloads
# ---------------------------------------------------------------------------

def _paper_sampler(dev, executor, log_lik, shards, bank, **kw):
    from repro_torch.workloads import sampler
    return sampler(log_lik, shards, bank=bank, execution=_exec(dev, executor),
                   **kw)


def _exec(dev, executor):
    from repro_torch import api
    return api.Execution(device=dev, executor=executor)


def checked_run(prefix, executor, steps):
    """A workload runner's ``run``: ``run_path`` with one launch per step
    of ``executor``, every one of them Langevin."""
    def run(label, sampler, gen, theta0):
        return run_path(f"{prefix} {label}/{executor}", sampler, gen,
                        theta0, _expect(executor, steps),
                        dynamics="langevin")[0]
    return run


def prefix_check(name, make, seed, theta0, steps_per_round, dev):
    """packed == per_leaf, bitwise, on the first PREFIX_ROUNDS rounds;
    ``make(executor, rounds)`` builds the sampler."""
    out = {}
    for ex in ("packed", "per_leaf"):
        out[ex], _ = run_path(f"{name}/{ex}, first {PREFIX_ROUNDS} rounds",
                              make(ex, PREFIX_ROUNDS), _gen(dev, seed),
                              theta0,
                              _expect(ex, PREFIX_ROUNDS * steps_per_round))
    same(f"{name}: packed == per_leaf", out["packed"], out["per_leaf"])


def paper_kernel_shapes():
    """The update's shapes on the paper's workloads: (packed (name,
    layout, chains), per-leaf (chains, rows per chain, block rows)) of
    [linreg]'s three sets and [metric] at C = PAPER_CHAINS, and [calib]'s
    two problems at C = 1."""
    from repro_torch import workloads as W
    from repro_torch.data import LINREG_SPECS
    from repro_torch.kernels import ops as kops
    dims = [(f"linreg/{name}", d, PAPER_CHAINS)
            for name, _, d, _ in LINREG_SPECS]
    dims += [("metric", W.FIG5_K + 1, PAPER_CHAINS),
             ("calib/logreg", W.CALIB_LOG["d"], 1),
             ("calib/linreg", W.CALIB_LIN["d"], 1)]
    packed, leaf = [], []
    for name, d, C in dims:
        layout = kops.make_packed_layout(torch.zeros(d))
        packed.append((name, layout, C))
        shape = (C, layout.rows_total, layout.block_rows)
        if shape not in leaf:
            leaf.append(shape)
    return packed, leaf


def phase_linreg(dev):
    from repro_torch import workloads as W
    from repro_torch.data import linreg_datasets
    steps = W.F1_ROUNDS * W.F1_T
    for name, ds in linreg_datasets(_gen(dev, 0)).items():
        n, d = ds["x"].shape
        log(f"  {name}: n={n}, d={d}, sigma={ds['sigma']}, {W.F1_S} shards")
        res = W.run_f1(ds, n_chains=PAPER_CHAINS,
                       execution=_exec(dev, "packed"),
                       run=checked_run(f"linreg/{name}", "packed", steps))
        exact = res["exact"]
        for method in ("dsgld", "fsgld"):
            mse = res[method]
            log(f"    {method} test MSE per chain {mse}, mean "
                f"{statistics.mean(mse):.6f}, worst {max(mse) / exact:.4f}x"
                f" the exact posterior mean's {exact:.6f}")
            if not max(mse) <= LINREG_REL * exact:
                raise AssertionError(f"linreg/{name} {method}: test MSE "
                                     f"{max(mse)} above {LINREG_REL} x "
                                     f"{exact}")
        prefix_check(f"linreg/{name} fsgld", lambda ex, rounds, ds=ds,
                     res=res: W.f1_sampler(
                         ds, res["shards"], res["bank"], method="fsgld",
                         n_chains=PAPER_CHAINS, execution=_exec(dev, ex),
                         rounds=rounds),
                     31, torch.zeros(d, device=dev), W.F1_T, dev)


def phase_metric(dev):
    from repro_torch import workloads as W
    shards, test = W.metric_problem(_gen(dev, 0))
    cuda_sync()
    t0 = time.perf_counter()
    bank = W.metric_bank(_gen(dev, 1), shards)
    cuda_sync()
    lam = bank.precs
    log(f"  surrogate fit on the card ({W.FIG5_FIT_STEPS} local SGLD steps "
        f"x {W.FIG5_S} clients + Fisher): {time.perf_counter() - t0:.2f} s;"
        f" precisions {float(lam.min()):.4g}..{float(lam.max()):.4g}")
    if not (bool(torch.isfinite(bank.means).all()) and bool((lam > 0).all())):
        raise AssertionError("metric: the fitted bank is not finite and "
                             "positive")
    res = W.run_fig5(shards, test, bank, n_chains=PAPER_CHAINS,
                     execution=_exec(dev, "packed"),
                     run=checked_run("metric", "packed",
                                     W.FIG5_ROUNDS * W.FIG5_T))
    for method, ll in res.items():
        log(f"    {method} train ll per chain {ll['train']}, test ll "
            f"{ll['test']}")
        if not all(v > -math.log(2) for v in ll["train"] + ll["test"]):
            raise AssertionError(f"metric/{method}: not above chance")
    f, d = res["fsgld"]["test"], res["dsgld"]["test"]
    diff = statistics.mean(f) - statistics.mean(d)
    se = math.sqrt((statistics.variance(f) + statistics.variance(d))
                   / PAPER_CHAINS)
    # fig5's row is mean FSGLD test ll >= mean DSGLD's, a difference below
    # the noise of 3 chains in both packages (PERF.md): tools/paper_runs.py
    # holds the claim over 48 chains. Here FSGLD may not fall METRIC_SE
    # standard errors below DSGLD.
    log(f"  fsgld_beats_dsgld_test: {diff >= 0} (difference {diff:.5f}, "
        f"{diff / se:.2f} standard errors of {se:.5f})")
    if not diff >= -METRIC_SE * se:
        raise AssertionError(f"metric: FSGLD's test ll is {diff:.5f} below "
                             f"DSGLD's, beyond {METRIC_SE} standard errors")
    prefix_check("metric fsgld", lambda ex, rounds: W.fig5_sampler(
        shards, bank, method="fsgld", n_chains=PAPER_CHAINS,
        execution=_exec(dev, ex), rounds=rounds), 11,
        torch.zeros(W.FIG5_K + 1, device=dev), W.FIG5_T, dev)


def phase_calib(dev):
    from repro_torch import api
    from repro_torch import workloads as W
    c = W.CALIB_LOG
    shards, test = W.calib_logreg_problem(_gen(dev, 11))
    s = api.FSGLD(
        api.Posterior(W.logreg_log_lik, prior_precision=1.0), shards,
        minibatch=c["m"], step_size=c["h"],
        surrogate=api.SurrogateSpec(kind="diag", fit="fisher"),
        schedule=api.Schedule(rounds=c["rounds"], local_steps=c["T"],
                              thin=c["thin"]),
        execution=api.Execution(device=dev, executor="packed"))
    tr, _ = run_path("calib/logreg fsgld/packed (Fisher fit at theta0)", s,
                     _gen(dev, 12), torch.zeros(c["d"], device=dev),
                     _expect("packed", c["rounds"] * c["T"]),
                     dynamics="langevin")
    log_scores = W.calib_logreg_scores(tr[0], test)
    log(f"    {log_scores}")
    c = W.CALIB_LIN
    shards, test, bank = W.calib_linreg_problem(_gen(dev, 23))
    s = _paper_sampler(dev, "packed", W.linreg_log_lik(c["sigma"]), shards,
                       bank, minibatch=c["m"], step_size=c["h"],
                       rounds=c["rounds"], local_steps=c["T"],
                       thin=c["thin"], n_chains=1)
    tr, _ = run_path("calib/linreg fsgld/packed", s, _gen(dev, 24),
                     torch.zeros(c["d"], device=dev),
                     _expect("packed", c["rounds"] * c["T"]),
                     dynamics="langevin")
    lin_scores = W.calib_linreg_scores(tr[0], test, _gen(dev, 25))
    log(f"    {lin_scores}")
    bad = W.calib_failures(log_scores, lin_scores)
    if bad:
        raise AssertionError(f"calib: {bad}")
    log(f"  every bound of bench_calibration.py held, and each NLL within "
        f"{W.CALIB_TRUE_MARGIN} of the true weights'")


def phase_kinds(dev):
    from repro_torch import workloads as W
    from repro_torch.core import make_bank
    from repro_torch.data import linreg_datasets
    data, post, bank, total = W.linear_surrogate_problem(_gen(dev, 0))
    log(f"  'linear' bank: f-weighted sum of the conducive terms "
        f"{total.tolist()}")
    if not float(total.abs().max()) < W.LINEAR_SUM_ATOL:
        raise AssertionError("kinds: the conducive terms do not sum to 0")

    def make(ex, bank, rounds, **kw):
        return _paper_sampler(dev, ex, W.gaussian_log_lik, data, bank,
                              minibatch=10, step_size=1e-4, rounds=rounds,
                              **kw)

    s = make("auto", bank, KINDS_ROUNDS, local_steps=W.LINEAR_T,
             thin=W.LINEAR_THIN, n_chains=1)
    if s.engine.use_kernel:
        raise AssertionError("kinds: 'auto' took a kernel executor for a "
                             "'linear' bank")
    tr, _ = run_path("kinds/linear auto (-> vmap)", s, _gen(dev, 3),
                     torch.zeros(2, device=dev), _expect("vmap", 0))
    mse = float(((tr[0, tr.shape[1] // 2:].mean(0) - post) ** 2).sum())
    log(f"    posterior-mean MSE {mse:.4e}")
    if not mse < W.LINEAR_MSE_CEILING:
        raise AssertionError(f"kinds: linear MSE {mse}")
    ds = linreg_datasets(_gen(dev, 0))["concrete"]
    shards, test, mus, prec = W.linreg_problem(ds)
    full = make_bank(mus, prec, "full")
    for kind, b in (("linear", bank), ("full", full)):
        for ex in ("packed", "per_leaf"):
            try:
                make(ex, b, 1, local_steps=1, thin=1, n_chains=1)
            except ValueError as e:
                log(f"  {kind} bank, executor={ex!r}: refused ({e})")
            else:
                raise AssertionError(f"kinds: {ex} took a {kind} bank")
    s = _paper_sampler(dev, "auto", W.linreg_log_lik(ds["sigma"]), shards,
                       full, minibatch=W.F1_M, step_size=W.F1_H,
                       rounds=W.F1_ROUNDS, local_steps=W.F1_T,
                       thin=W.F1_THIN, n_chains=PAPER_CHAINS)
    tr, _ = run_path("kinds/full concrete auto (-> vmap)", s, _gen(dev, 30),
                     torch.zeros(ds["x"].shape[1], device=dev),
                     _expect("vmap", 0))
    mse = W.linreg_test_mse(tr, test)
    exact = W.linreg_exact_mse(shards, test, ds["sigma"])
    log(f"    test MSE per chain {mse} (the exact posterior mean's "
        f"{exact:.6f})")
    if not (all(math.isfinite(v) for v in mse)
            and max(mse) <= LINREG_REL * exact):
        raise AssertionError(f"kinds: 'full' bank test MSE {mse}")


def phase_oracle(dev, shards, theta0, bank):
    from repro_torch.core import FederatedSampler
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch.workloads import table1_log_lik
    s = t1_sampler(dev, shards, bank, "per_leaf", rounds=ORACLE_ROUNDS)
    want, _ = run_path("oracle: table1/per_leaf", s, _gen(dev, 26), theta0,
                       _expect("per_leaf", ORACLE_ROUNDS * T1_T))
    oracle = FederatedSampler(table1_log_lik, s.cfg, s.data, T1_M,
                              bank=s.bank, use_kernel=True)
    cuda_sync()
    fk.reset_launches()
    got = oracle.run_vmap(_gen(dev, 26), theta0, ORACLE_ROUNDS,
                          n_chains=T1_CHAINS, collect_every=20)
    cuda_sync()
    n = dict(fk.LAUNCHES)
    log(f"  FederatedSampler(use_kernel=True).run_vmap: launches {n} (one "
        f"per chain per step)")
    if n != _expect("per_leaf", ORACLE_ROUNDS * T1_T * T1_CHAINS):
        raise AssertionError(f"oracle: launches {n}")
    same("oracle: run_vmap(use_kernel=True) == per_leaf", got, want)


def profile_call(fn, what: str, steps: int) -> None:
    """Where one call of ``fn`` (``steps`` steps) spends its time: the top
    operators by host time, the kernels by device time, and the device's
    busy share of the wall time (measured under the profiler, which slows
    the host), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    cuda_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        cuda_sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    log(ev.table(sort_by="self_cpu_time_total", row_limit=12,
                 max_name_column_width=48))
    # the kernels' own events: an operator's self device time repeats the
    # time of the kernels it launched
    busy = [(e.self_device_time_total, e.key) for e in ev
            if e.device_type == DeviceType.CUDA]
    dev_us = sum(t for t, _ in busy)
    top = sorted(busy, reverse=True)[:6]
    log("  device time by kernel (us): " + ", ".join(
        f"{k[:40]} {t:.0f}" for t, k in top if t > 0))
    busy_pct = 100 * dev_us / wall_us
    log(f"  {what} wall {wall_us / 1e3:.2f} ms ({wall_us / steps / 1e3:.3f} "
        f"ms per step), device busy {dev_us / 1e3:.2f} ms = {busy_pct:.1f}% "
        f"(idle {100 - busy_pct:.1f}%)")


# ---------------------------------------------------------------------------
# the serving paths
# ---------------------------------------------------------------------------

def _check_signals(name, res, n_draws):
    sig = (res.mean_logprob, res.entropy, res.mutual_info, res.token_var)
    if not all(bool(torch.isfinite(s).all()) for s in sig):
        raise AssertionError(f"{name}: non-finite uncertainty signals")
    mi = res.mutual_info
    if not bool((mi[:, 0] == 0).all()):
        raise AssertionError(f"{name}: token 0 (anchor prefill) has "
                             "mutual information")
    if n_draws > 1 and not bool((mi[:, 1:] > 0).all()):
        raise AssertionError(f"{name}: {n_draws} distinct draws show no "
                             "mutual information")


def _peak(base: int) -> str:
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
            f"{base / 1e9:.2f} GB allocated before)")


def _self_attending(cfg) -> list:
    """The kind of each of ``cfg``'s decoder layers that has a
    self-attention: 'attn', 'swa', and an audio 'xattn' layer
    (self-attention, then cross-attention). A vlm 'xattn' layer has none:
    its cross-attention is the plain scan."""
    pat = cfg.layer_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    return [k for k in kinds if k in ("attn", "swa")
            or (k == "xattn" and cfg.family == "audio")]


def attn_layers(cfg) -> int:
    """``cfg``'s self-attentions: one flash launch each per prefill or
    gradient pass, the encoder's layers included ('rglru', 'rwkv' and a
    vlm 'xattn' layer launch none)."""
    return len(_self_attending(cfg)) + cfg.encoder_layers


def grad_attn_launches(cfg) -> int:
    """Flash launches of one gradient pass: every self-attention once in
    the forward, and once more in the backward's re-run where the
    recompute covers it (``cfg.remat``: the layers of the full periods
    of ``cfg.layer_pattern`` and every encoder layer, not the remainder
    layers)."""
    if not cfg.remat:
        return attn_layers(cfg)
    pat = cfg.layer_pattern
    in_periods = (cfg.num_layers // len(pat)) * len(pat)
    again = sum(1 for i in range(in_periods)
                if pat[i % len(pat)] in ("attn", "swa")
                or (pat[i % len(pat)] == "xattn" and cfg.family == "audio"))
    return attn_layers(cfg) + again + cfg.encoder_layers


def flash_expected(cfg, grads: int, forwards: int = 0) -> int:
    """Flash launches of ``grads`` gradient passes and ``forwards``
    forwards of ``cfg``."""
    return grads * grad_attn_launches(cfg) + forwards * attn_layers(cfg)


def attn_shapes(cfg, B, S) -> list:
    """(shape (B, S, H, Hkv, hd), causal, window) of each kind of
    self-attention ``cfg`` gives the flash kernel at batch B x S tokens:
    the decoder's, causal, with no window ('attn', audio 'xattn') and
    ``cfg.swa_window`` ('swa'); the encoder's over its frames, not
    causal."""
    kinds = set(_self_attending(cfg))
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    out = [((B, S) + heads, True, None)] if kinds - {"swa"} else []
    if "swa" in kinds:
        out.append(((B, S) + heads, True, cfg.swa_window))
    if cfg.encoder_layers:
        out.append(((B, cfg.encoder_seq) + heads, False, None))
    return out


def open_gates(params, value=VLM_GATE):
    """``params`` (one draw) with every vlm 'xattn' gate set to ``value``
    (in the gate's dtype); the draw itself is not written."""
    out = dict(params)
    for group in ("blocks", "rem_blocks"):
        if group not in out:
            continue
        out[group] = {k: dict(v) for k, v in out[group].items()}
        for layer in out[group].values():
            if "gate" in layer.get("xattn", {}):
                layer["xattn"] = {**layer["xattn"], "gate": torch.full_like(
                    layer["xattn"]["gate"], value)}
    return out


def _prefill_rel(anchor, cfg, prompt, total, enc_embeds=None):
    """Anchor prefill logits through the kernel vs the plain attention
    (the encoder's too, from the frames ``enc_embeds``):
    max|diff| / max|logits| (None where no layer attends: the two would
    be one computation); also the kernel's launches."""
    from repro_torch import models as TM
    from repro_torch.kernels import flash_attention as fa
    fa.reset_launches()
    logits, cache = TM.prefill_with_cache(anchor, cfg, prompt, total,
                                          enc_embeds=enc_embeds)
    launched = fa.LAUNCHES["flash_attention"]
    cuda_sync()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    if not attn_layers(cfg):
        return logits, cache, launched, None
    plain, _ = TM.prefill_with_cache(anchor, cfg, prompt, total,
                                     enc_embeds=enc_embeds,
                                     attention=fa.flash_attention_plain)
    rel = float((logits - plain).abs().max() / plain.abs().max())
    if not rel < PREFILL_REL:
        raise AssertionError(f"{cfg.name}: prefill through the kernel is "
                             f"{rel:.3e} of max|logits| from the plain "
                             f"attention's (limit {PREFILL_REL})")
    return logits, cache, launched, rel


def prompt_checks(server, cfg, prompt, gen, enc_embeds=None):
    """One prompt (and its frames ``enc_embeds``, for the vlm and audio
    families) on the anchor draw: prefill through the kernel against
    the plain attention (``_prefill_rel``), the flash launches of prefill
    (one per self-attention, the encoder's included) and of decode (none)
    apart, and the K=1 ensemble (prefill, ``gen - 1`` decode steps, and a
    server's request) against the plain prefill + decode_step loop,
    bitwise."""
    from repro_torch import models as TM
    from repro_torch import tree as tu
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import (EnsembleServer, ensemble_prefill,
                                   predictive_stats)
    B, S = prompt.shape
    dev, total = prompt.device, S + gen
    anchor = tu.tree_map(lambda t: t[0], server.draws)
    logits, cache, n_prefill, rel = _prefill_rel(anchor, cfg, prompt, total,
                                                 enc_embeds)
    enc_out = server._encoder_inputs(None, B, enc_embeds)
    fa.reset_launches()
    want_tok, want_logits = [torch.argmax(logits, -1)], []
    for t in range(S, total - 1):
        lg, cache = TM.decode_step(anchor, cfg, cache, want_tok[-1][:, None],
                                   torch.full((B,), t, device=dev),
                                   enc_out=enc_out)
        want_logits.append(lg)
        want_tok.append(torch.argmax(lg, -1))
    n_decode = fa.LAUNCHES["flash_attention"]
    if n_prefill != attn_layers(cfg) or n_decode != 0:
        raise AssertionError(f"flash_attention: {n_prefill} launches in "
                             f"prefill, {n_decode} in decode")
    log("  anchor prefill: " + (
        "no attending layer, so no plain attention to compare"
        if rel is None else f"kernel vs plain attention max|diff|/max|"
        f"logits| {rel:.3e} (limit {PREFILL_REL})") + "; flash_attention "
        f"launches: prefill {n_prefill}, decode {n_decode}")
    del cache
    draws1 = tu.tree_map(lambda t: t[:1], server.draws)
    logits0, caches = ensemble_prefill(draws1, cfg, prompt, total,
                                       enc_out=enc_out)
    same = torch.equal(logits0, logits)
    tok = predictive_stats(logits0[None]).token[:, None]
    for i, t in enumerate(range(S, total - 1)):
        lk, caches = TM.ensemble_decode_step(
            draws1, cfg, caches, tok, torch.full((B,), t, device=dev),
            enc_out=enc_out)
        same = same and torch.equal(lk[0], want_logits[i])
        tok = predictive_stats(lk).token[:, None]
    del caches, enc_out
    res1 = EnsembleServer(cfg, draws=draws1, device=dev).generate(
        prompt, gen=gen, enc_embeds=enc_embeds)
    if not (same and torch.equal(res1.tokens, torch.stack(want_tok, 1))):
        raise AssertionError("K=1 ensemble serving differs from the plain "
                             "prefill + decode_step loop")
    _check_signals("K=1", res1, 1)
    if not bool((res1.mutual_info == 0).all()):
        raise AssertionError("K=1: mutual information is not 0")
    log("  K=1 ensemble == plain prefill + decode_step loop, bitwise "
        f"(prefill logits, {gen - 1} steps' logits, tokens); mutual "
        "info 0")


def serve_qwen3(dev, mesh=None):
    """The serving path at full width, through ``FSGLD.serve``; returns
    the flash-attention launches of its two requests. With ``mesh`` (the
    one-rank NCCL mesh of [mesh]) a server on it, over the same K draws,
    serves one of the requests again: every token and statistic equal to
    the meshless server's."""
    from repro_torch import api
    from repro_torch import models as TM
    from repro_torch import tree as tu
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import ensemble_prefill
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = api.FSGLD.serve(api.Serving(arch="qwen3-1.7b", smoke=False,
                                         draws=SERVE_K))
    cuda_sync()
    cfg = server.cfg
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) != QWEN3_WIDTH:
        raise AssertionError(f"not qwen3-1.7b's published width: {cfg}")
    held = sum(t.numel() * t.element_size() for t in tu.leaves(server.draws))
    head = server.draws["head_f32"].numel() * 4
    log(f"  {SERVE_K} draws of {cfg.name} ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}) initialised on the card one at a time in "
        f"{time.perf_counter() - t0:.2f} s; served weights {held / 1e9:.2f}"
        f" GB (bf16, of which the fp32 heads {head / 1e9:.2f} GB); peak "
        f"device memory while initialising {_peak(base)}")

    gen = torch.Generator(device=dev).manual_seed(11)
    cuda_sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_launches()  # the main path: two requests
    per_request, results = [], []
    for _ in range(2):
        before = fa.LAUNCHES["flash_attention"]
        results.append(server.generate(generator=gen, gen=SERVE_GEN,
                                       batch=SERVE_B, prompt_len=SERVE_S))
        per_request.append(fa.LAUNCHES["flash_attention"] - before)
    cuda_sync()
    launches = fa.LAUNCHES["flash_attention"]
    for i, (res, n) in enumerate(zip(results, per_request)):
        if n != attn_layers(cfg):
            raise AssertionError(f"request {i}: flash_attention launched {n}"
                                 f" times, expected {attn_layers(cfg)}")
        if tuple(res.tokens.shape) != (SERVE_B, SERVE_GEN) \
                or res.n_draws != SERVE_K:
            raise AssertionError(f"request {i}: tokens {res.tokens.shape}")
        _check_signals(f"request {i}", res, SERVE_K)
        mi = res.mutual_info[:, 1:]
        log(f"  request {i}: batch {SERVE_B} x prompt {SERVE_S}, "
            f"{SERVE_GEN} new tokens, K={SERVE_K}: prefill "
            f"{res.prefill_s:.3f} s, decode {res.decode_s:.3f} s = "
            f"{SERVE_B * (SERVE_GEN - 1) / res.decode_s:.1f} tok/s "
            f"({1e3 * res.decode_s / (SERVE_GEN - 1):.1f} ms per step of "
            f"{SERVE_K} draws); flash_attention launches {n}; mutual info "
            f"{float(mi.min()):.3e}..{float(mi.max()):.3e}, entropy mean "
            f"{float(res.entropy.mean()):.3f}")
    log(f"  main path: {launches} flash_attention launches in 2 requests; "
        f"peak device memory while serving {_peak(base)}")
    if mesh is not None:
        from repro_torch.serve import EnsembleServer
        on = EnsembleServer(cfg, draws=server.draws, device=dev, mesh=mesh)
        if not on.sharded or on.n_draws != SERVE_K:
            raise AssertionError("mesh server: the draws are not on 'data'")
        again = [s.generate(generator=torch.Generator(device=dev)
                            .manual_seed(12), gen=SERVE_GEN, batch=SERVE_B,
                            prompt_len=SERVE_S) for s in (on, server)]
        for f in ("tokens", "mean_logprob", "entropy", "mutual_info",
                  "token_var"):
            same(f"serve: Serving(mesh=) {f} == the meshless server's",
                 getattr(again[0], f), getattr(again[1], f))
        log(f"  Serving(mesh=): K={SERVE_K} draws on 'data' of a "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} mesh, one "
            f"request: prefill {again[0].prefill_s:.3f} s, decode "
            f"{again[0].decode_s:.3f} s (meshless {again[1].prefill_s:.3f} / "
            f"{again[1].decode_s:.3f} s); tokens and statistics bitwise")
        del on

    # one prompt: prefill through the kernel vs the plain attention, the
    # launches of prefill and decode apart, and K=1 against a plain loop
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=gen, device=dev)
    total = SERVE_S + SERVE_GEN
    prompt_checks(server, cfg, prompt, SERVE_GEN)

    log(f"  [profile] one decode step of the {SERVE_K}-draw ensemble under "
        "torch.profiler")
    _, caches = ensemble_prefill(server.draws, cfg, prompt, total)
    tok = prompt[:, -1:]
    pos = torch.full((SERVE_B,), SERVE_S, device=dev)
    profile_call(lambda: TM.ensemble_decode_step(server.draws, cfg, caches,
                                                 tok, pos),
                 "decode step", 1)
    return launches


def serve_danube(dev):
    """h2o-danube-1.8b at full width, 2 layers: a prompt longer than the
    4,096-token window, so the kernel's window branch and the ring cache
    run through the model."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import EnsembleServer
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2)
    server = EnsembleServer(cfg, n_draws=2, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    B, S, G = 2, 5000, 8
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    cuda_sync()
    fa.reset_launches()
    res = server.generate(prompt, gen=G)
    cuda_sync()
    n = fa.LAUNCHES["flash_attention"]
    if n != attn_layers(cfg):
        raise AssertionError(f"danube: flash_attention launched {n} times, "
                             f"expected {attn_layers(cfg)}")
    _check_signals("danube", res, 2)
    _, _, _, rel = _prefill_rel(tu.tree_map(lambda t: t[0], server.draws),
                                cfg, prompt, S + G)
    log(f"  {cfg.name} (d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, hd {cfg.head_dim}), {cfg.num_layers} "
        f"layers, window {cfg.swa_window}, K=2: batch {B} x prompt {S} "
        f"(ring cache of {cfg.swa_window} slots), {G} new tokens; prefill "
        f"{res.prefill_s:.3f} s, decode {B * (G - 1) / res.decode_s:.1f} "
        f"tok/s; flash_attention launches {n}; kernel vs plain attention "
        f"prefill max|diff|/max|logits| {rel:.3e}")


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _train_argv():
    return ["--arch", "qwen3-1.7b"] + (
        [] if TRAIN_H == 1e-5 else ["--step-size", repr(TRAIN_H)])


def phase_train(dev, failures):
    """qwen3-1.7b at full width and depth through the train driver's flag
    parser and run (``main`` minus its exit code), then per_leaf on the
    same generator and bank (bitwise), then one step split three ways.
    Returns the path's numbers. A chain beyond the divergence guard is
    appended to ``failures`` (the script fails after its other phases)."""
    from repro_torch import tree as tu
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch.launch import train
    from repro_torch.obs import read_jsonl, read_metrics_jsonl
    mdir = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    args = train.parse_args(_train_argv() + ["--metrics-dir", mdir,
                                             "--log-every", "1"])
    cuda_sync()
    fk.reset_launches()
    fa.reset_launches()  # the main path: the driver's whole run
    try:
        tr = train.run(args)
        cuda_sync()
        frame = read_metrics_jsonl(os.path.join(mdir, "metrics.jsonl"))
        events = read_jsonl(os.path.join(mdir, "trace.jsonl"))
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    counts, n_flash = dict(fk.LAUNCHES), fa.LAUNCHES["flash_attention"]
    cfg = tr.cfg
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) != QWEN3_WIDTH:
        raise AssertionError(f"not qwen3-1.7b's published width: {cfg}")
    n_params = sum(t.numel() for t in tu.leaves(tr.theta0))
    if n_params != QWEN3_P:
        raise AssertionError(f"{n_params} parameters, expected {QWEN3_P}")
    steps = TRAIN_R * TRAIN_T
    # gradient passes: the fit's, the sampling's and telemetry's probe
    # (one per round); forwards: the probes at theta0 and at each chain's
    # final state
    grads = TRAIN_S * TRAIN_FIT + steps + TRAIN_R
    passes = grads + 1 + args.chains
    if counts != {"fsgld_update_packed": steps, "fsgld_update_2d": 0} or \
            n_flash != flash_expected(cfg, grads, 1 + args.chains):
        raise AssertionError(f"train: launches {counts}, flash {n_flash}; "
                             f"expected {steps} packed and "
                             f"{flash_expected(cfg, grads, 1 + args.chains)}"
                             " flash")
    if not (all(math.isfinite(x) for x in tr.lls)
            and min(tr.lls) >= tr.ll0 - TRAIN_GUARD):
        failures.append(f"train diverged: ll/token {tr.lls} against "
                        f"{tr.ll0:.4f} at theta0 (guard {TRAIN_GUARD} "
                        f"nats, h {args.step_size:g})")
        log(f"  FAILED: {failures[-1]}")
    log(f"  {cfg.name}: {n_params} parameters per chain, h "
        f"{args.step_size:g}; fit {tr.fit_s:.2f} s, sampling "
        f"{tr.sample_s:.2f} s = {steps / tr.sample_s:.3f} chain-steps/s; "
        f"peak device memory fit {tr.peak_gb['fit']:.2f} GB, sampling "
        f"{tr.peak_gb['sampling']:.2f} GB; ll/token theta0 {tr.ll0:.4f}, "
        f"chains {[round(x, 4) for x in tr.lls]}")
    log(f"  main path launches: fsgld_update_packed {counts['fsgld_update_packed']}"
        f" (1 per step), flash_attention {n_flash} = "
        f"{grad_attn_launches(cfg)} x {grads} gradient passes ({TRAIN_S} x "
        f"{TRAIN_FIT} fit + {steps} sampling + {TRAIN_R} telemetry probe; "
        f"the recompute runs each layer's forward twice) + "
        f"{attn_layers(cfg)} x {1 + args.chains} probe forwards")
    import numpy as np
    _finite_frame("train telemetry", frame, TRAIN_R, args.chains)
    if len(frame.names) != 9 or \
            [e["round"] for e in events if e["name"] == "engine.progress"] \
            != list(range(1, TRAIN_R + 1)):
        raise AssertionError(f"train telemetry: {frame.names}")
    m = frame.metrics
    tokens = args.batch * args.seq
    probe_ll = (m["log_post"][:, 0].astype(np.float64) + 0.5
                * m["theta_norm"][:, 0].astype(np.float64) ** 2) / tokens
    if abs(probe_ll[-1] - tr.lls[0]) > TRAIN_GUARD:
        raise AssertionError(f"train telemetry: probe ll/token "
                             f"{probe_ll.tolist()} against the driver's "
                             f"{tr.lls}")
    log(f"  telemetry ({TRAIN_R} x {args.chains} x {len(frame.names)} "
        "frame, --log-every 1): " + "; ".join(
            f"{n} {np.round(m[n][:, 0], 6).tolist()}" for n in
            ("drift_norm", "conducive_norm", "grad_norm", "log_post",
             "theta_norm")) + f"; probe ll/token "
        f"{np.round(probe_ll, 4).tolist()} (the driver's final "
        f"{tr.lls[0]:.4f})")

    # one round of CHECK_T steps on each: packed with telemetry on and
    # per_leaf, from theta0 on the driver's generator (per_leaf takes
    # ~6 s a step here, so not the whole run)
    tr.finals = None
    gen3 = lambda: train._generator(dev, args.seed, 3)  # noqa: E731
    from repro_torch.obs import Telemetry
    packed_s = _executor_copy(tr.sampler, "packed", dev)
    (packed, _), _, _, _ = _counted(
        "train/packed one round", lambda: packed_s.sample(
            gen3(), tr.theta0, rounds=1, telemetry=Telemetry()),
        _expect("packed", CHECK_T), flash_expected(cfg, CHECK_T + 1))
    per_leaf = _executor_copy(tr.sampler, "per_leaf", dev)
    L = len(tu.leaves(tr.theta0))
    out, dt, _, n = _counted(
        "train/per_leaf", lambda: per_leaf.sample(gen3(), tr.theta0,
                                                  rounds=1),
        {"fsgld_update_packed": 0, "fsgld_update_2d": CHECK_T * L},
        flash_expected(cfg, CHECK_T))
    log(f"  per_leaf, one round of {CHECK_T} step(s): {CHECK_T * L} "
        f"fsgld_update_2d launches ({L} leaves), {n} flash_attention "
        f"({grad_attn_launches(cfg)} per gradient pass), {CHECK_T / dt:.3f}"
        " chain-steps/s")
    same("train: packed with telemetry == per_leaf without, one round",
         packed, out)
    del out, packed
    split = step_split(dev, tr)
    return {"launches": counts["fsgld_update_packed"], "flash": n_flash,
            "passes": passes, **split}


class Allocations:
    """Device memory allocated since the last ``step``, in GB."""

    def __init__(self):
        cuda_sync()
        self.at = torch.cuda.memory_allocated()

    def step(self) -> float:
        cuda_sync()
        now, before = torch.cuda.memory_allocated(), self.at
        self.at = now
        return (now - before) / 1e9


def step_split(dev, tr):
    """One sampling step at full width split three ways: the gradient
    pass (host clock, synchronised), packing the gradients (CUDA events),
    and the update launch in place (CUDA-graph replay) against its bytes
    bound; one launch held against the plain version; the device memory
    each of the step's buffers holds. Then the plain attention backward
    of one layer at the train shape."""
    from torch.func import grad, vmap
    from repro_torch.core import engine as teng
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch.kernels import ops as kops
    from repro_torch import tree as tu
    s = tr.sampler
    mem, held = Allocations(), {}
    layout = kops.make_packed_layout(tr.theta0)
    th_p = layout.pack(tu.tree_map(lambda t: t[None], tr.theta0), device=dev)
    held["packed theta"] = mem.step()
    thetas = layout.unpack(th_p)
    pbank = teng.pack_bank(layout, s.bank, dev)
    held["global mean mu_g (fp32)"] = mem.step()
    gen = _gen(dev, 17)
    sids = torch.zeros(1, dtype=torch.int64, device=dev)
    idx = torch.randint(0, 64, (1, s.minibatch), generator=gen, device=dev)
    batch = tu.tree_map(lambda d: d[sids[:, None], idx], s.data)
    grad_v = vmap(grad(s.posterior.log_lik))
    g_p = torch.zeros_like(th_p)
    held["packed gradient buffer"] = mem.step()
    ops = {"mu_g": pbank["mu_g"],
           "mu_s": teng._gather(pbank["means"], sids, dev)}
    held["gathered client mean mu_s (fp32)"] = mem.step()
    times = []
    for _ in range(3):
        g = None
        cuda_sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = grad_v(thetas, batch)
        cuda_sync()
        times.append(1e3 * (time.perf_counter() - t0))
    grad_ms = statistics.median(times)
    held["gradient pass, transient peak"] = \
        (torch.cuda.max_memory_allocated() - mem.at) / 1e9
    held["leaf gradients"] = mem.step()
    pack_ms = call_ms(lambda: layout.pack(g, out=g_p), reps=3, warmup=1)
    del g
    log("  device memory held in one sampling step at full width (C = 1; "
        "torch.cuda.memory_allocated, GB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in held.items()))
    log("  [profile] one gradient pass at full width under torch.profiler")
    profile_call(lambda: grad_v(thetas, batch), "gradient pass", 1)
    scale, f_s = teng.chain_scales(s.cfg, s.engine.scheme, sids, s.minibatch)
    scalars = kops.packed_scalar_rows(
        layout, h=s.cfg.step_size, scale=scale, f_s=f_s,
        prior_prec=s.cfg.prior_precision, alpha=s.cfg.alpha,
        temperature=s.cfg.temperature, lam_g_leaf=pbank["lam_g_leaf"],
        lam_s_leaf=pbank["lam_s_leaf"][sids])
    seeds = kops.chain_leaf_seeds(gen, 1, layout.num_leaves)
    sl, sb = layout.tables(dev)
    t0 = time.perf_counter()
    ref = fk.fsgld_update_packed_plain(
        th_p, g_p, seeds, scalars, variant="scalar", dynamics="langevin",
        seg_leaf=sl, seg_base=sb, block_rows=layout.block_rows, chains=1,
        **ops)
    cuda_sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    kops.packed_step(layout, th_p, g_p, seeds, scalars, variant="scalar",
                     **ops)
    cuda_sync()
    err = _err(th_p, ref)
    del ref
    upd_ms = device_ms(lambda: kops.packed_step(
        layout, th_p, g_p, seeds, scalars, variant="scalar", **ops),
        calls=5, replays=5)
    n = sum(layout.sizes)
    b_ms, b_by, nbytes = bound_ms("scalar", "langevin", 1, n,
                                  layout.num_leaves)
    log(f"  one step at C*P = {n}: gradient pass {grad_ms:.2f} ms (host "
        f"clock), packing {pack_ms:.2f} ms, update {upd_ms:.4f} ms on the "
        f"device (in place; bound {b_ms:.4f} ms, {b_by}, {nbytes} bytes: "
        f"{100 * b_ms / upd_ms:.1f}% of bound; plain version {plain_ms:.1f}"
        f" ms), max|kernel-plain| {err:.3e}")
    del th_p, g_p, thetas, ops, pbank
    bwd_ms = attention_bwd_ms(dev)
    return {"grad_ms": grad_ms, "pack_ms": pack_ms, "update_ms": upd_ms,
            "update_plain_ms": plain_ms, "update_bound_ms": b_ms,
            "update_err": err, "bwd_ms": bwd_ms}


def attention_bwd_ms(dev):
    """The plain attention backward of one layer at the train shape
    (device time, CUDA-graph replay), beside the kernel's forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, Hkv, hd = TRAIN_ATTN
    q, k, v = _qkv(_gen(dev, 19), B, S, H, Hkv, hd, torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v)
    dout = torch.randn_like(out)
    pos = torch.arange(S, device=dev).expand(B, S)
    ones = torch.ones_like(lse)
    bwd = device_ms(lambda: fa.attention_scan_bwd(
        q, k, v, pos, pos, lse, ones, dout), calls=10, replays=10)
    fwd = device_ms(lambda: fa.flash_attention_lse(q, k, v), calls=10,
                    replays=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), calls=10, replays=10)
    b_ms, b_by, _, _ = flash_bound_ms(B, S, H, Hkv, hd, 2)
    log(f"  attention at the train shape (B, S, H, Hkv, hd) = {TRAIN_ATTN}, "
        f"bf16, per layer: forward kernel (with row statistics) {fwd:.4f} "
        f"ms (bound {b_ms:.5f} ms, {b_by}: {100 * b_ms / fwd:.1f}% of "
        f"bound; SDPA {sdpa:.4f} ms), plain backward {bwd:.4f} ms")
    return bwd


class FirstUpdateCheck:
    """While in a ``with`` block: the first packed step the engine makes
    is also computed by the plain version on the same operands, and the
    largest |kernel - plain| kept (``err``)."""

    def __init__(self):
        self.err = None

    def __enter__(self):
        from repro_torch.kernels import fsgld_update as fk
        from repro_torch.kernels import ops as kops
        self._real = real = kops.packed_step

        def checked(layout, th_p, g_p, seeds, scalars, *, variant, **kw):
            if self.err is not None:
                return real(layout, th_p, g_p, seeds, scalars,
                            variant=variant, **kw)
            sl, sb = layout.tables(th_p.device)
            ref = fk.fsgld_update_packed_plain(
                th_p, g_p, seeds, scalars, variant=variant,
                dynamics=kw.get("dynamics", "langevin"), seg_leaf=sl,
                seg_base=sb, block_rows=layout.block_rows,
                chains=seeds.shape[0], r2d=kw.get("r_p"),
                **{k: kw[k] for k in ("mu_g", "mu_s", "lam_g", "lam_s")
                   if k in kw})
            out = real(layout, th_p, g_p, seeds, scalars, variant=variant,
                       **kw)
            cuda_sync()
            self.err = _err(out, ref)
            return out

        kops.packed_step = checked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops
        kops.packed_step = self._real


class LeafUpdateCheck:
    """While in a ``with`` block: every per-leaf update that
    ``kernels.ops`` makes (``fsgld_update_2d``) is also computed by the
    plain version on the same operands; ``err`` the largest |kernel -
    plain|, ``n`` the updates checked. The plain version makes no
    launch, so the launch counts are those of the path alone."""

    def __enter__(self):
        from repro_torch.kernels import fsgld_update as fk
        from repro_torch.kernels import ops as kops
        self._real = real = kops.fsgld_update_2d
        self.err, self.n = 0.0, 0

        def checked(theta2d, g2d, seed, scalars, *, variant="plain",
                    dynamics="langevin", block_rows=fk.BLOCK_ROWS,
                    chains=1, **kw):
            out = real(theta2d, g2d, seed, scalars, variant=variant,
                       dynamics=dynamics, block_rows=block_rows,
                       chains=chains, **kw)
            ref = fk.fsgld_update_2d_plain(
                theta2d, g2d, seed, scalars, variant=variant,
                dynamics=dynamics, block_rows=block_rows, chains=chains,
                **kw)
            cuda_sync()
            self.err = max(self.err, _err(out, ref))
            self.n += 1
            return out

        kops.fsgld_update_2d = checked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops
        kops.fsgld_update_2d = self._real


def check_flash_diff(dev, shape=TRAIN_ATTN, window=None, causal=True):
    """The differentiable flash entry at a train shape (B, S, H, Hkv, hd),
    window and mask, bf16 inputs: forward (one launch) and row log-sum-exp
    against the plain scan, dq/dk/dv against autograd through
    ``attention_scan`` on the same values in fp32 (autograd through the
    bf16 scan rounds its probabilities to bf16 before P V, and its dq
    then strays 6-10x the tolerance from this exact gradient, on the
    CPU), each within the kernel's ``tolerance`` (the statistics within
    1e-3). Returns the largest share of the tolerance used."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, Hkv, hd = shape
    q, k, v = _qkv(_gen(dev, 23), B, S, H, Hkv, hd, torch.bfloat16)
    dout = torch.randn(B, S, H, hd, generator=_gen(dev, 29),
                       device=dev).bfloat16()
    pos = torch.arange(S, device=dev).expand(B, S)
    mask = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_lse(q, k, v, **mask)
    ref, m, l = fa.attention_scan(q, k, v, pos, pos, stats=True, **mask)
    stat_err = float((lse - (m + torch.log(l))).abs().max())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention_diff(*leaves, **mask),
                              leaves, dout)
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_scan(*plain, pos, pos, **mask),
                               plain, dout.float())
    shares = [flash_err(out, ref)[1]] + [
        flash_err(a, b.to(a.dtype))[1] for a, b in zip(got, want)]
    del got, want, plain, leaves
    log(f"  flash_attention_diff at the train shape {shape}, causal "
        f"{causal}, window {window}, bf16: share of the tolerance used out "
        f"{shares[0]:.3f}, "
        f"dq {shares[1]:.3f}, dk {shares[2]:.3f}, dv {shares[3]:.3f}; row "
        f"log-sum-exp max|kernel-plain| {stat_err:.3e}")
    if not (max(shares) <= 1 and stat_err <= 1e-3):
        raise AssertionError("the differentiable flash entry disagrees with "
                             "plain autograd")
    return max(shares)


def phase_train_c2(dev):
    """qwen3-1.7b at full width, C2_LAYERS of its 28 layers, C2_CHAINS
    chains: the vmap rule folds the chains into the flash kernel's batch
    (one launch per layer per pass) and the packed buffer holds both;
    the first step's update held against the plain version."""
    from repro_torch import api
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch import tree as tu
    cfg, theta0, data, bank, ll = _c2_problem(dev)
    T = 2
    s = api.FSGLD(api.Posterior(ll, prior_precision=1.0), data, minibatch=8,
                  step_size=TRAIN_H,
                  surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                  schedule=api.Schedule(rounds=1, local_steps=T,
                                        n_chains=C2_CHAINS,
                                        reassign="permutation"),
                  execution=api.Execution(device=dev, executor="packed",
                                          collect=False,
                                          dtype=torch.bfloat16))
    with FirstUpdateCheck() as chk:
        cuda_sync()
        fk.reset_launches()
        fa.reset_launches()
        out = s.sample(_gen(dev, 43), theta0)
        cuda_sync()
    n_flash = fa.LAUNCHES["flash_attention"]
    if fk.LAUNCHES["fsgld_update_packed"] != T or \
            n_flash != flash_expected(cfg, T):
        raise AssertionError(f"train-c2: launches {fk.LAUNCHES}, flash "
                             f"{n_flash}")
    if not all(bool(torch.isfinite(t).all()) for t in tu.leaves(out)):
        raise AssertionError("train-c2: non-finite state")
    P = sum(t.numel() for t in tu.leaves(theta0))
    log(f"  {C2_LAYERS} layers, {P} parameters per chain, C={C2_CHAINS} "
        f"(C*P = {C2_CHAINS * P}): {T} fsgld_update_packed launches, "
        f"{n_flash} flash_attention ({grad_attn_launches(cfg)} per gradient "
        f"pass, chains folded); first update max|kernel-plain| "
        f"{chk.err:.3e}")
    from repro_torch.obs import Telemetry
    (on, frame), _, _, _ = _counted(
        "train-c2 telemetry", lambda: s.sample(_gen(dev, 43), theta0,
                                               telemetry=Telemetry()),
        _expect("packed", T), flash_expected(cfg, T + 1))
    same("train-c2: telemetry on == off", out, on)
    _finite_frame("train-c2 telemetry", frame, 1, C2_CHAINS)
    log(f"  train-c2 telemetry: {T} update and "
        f"{flash_expected(cfg, T + 1)} flash "
        "launches (one probe pass); " + ", ".join(
            f"{n} {frame.metrics[n][0].tolist()}" for n in frame.names))
    return chk.err


# ---------------------------------------------------------------------------
# fault tolerance: chain health and chaos, run snapshots, the draw bank
# ---------------------------------------------------------------------------

class Timed:
    """While in a ``with`` block: every call of ``obj.name`` is timed
    (host clock, the device synchronised before and after) into
    ``seconds``."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds = obj, name, []

    def __enter__(self):
        self._real = real = getattr(self.obj, self.name)

        def timed(*a, **k):
            cuda_sync()
            t0 = time.perf_counter()
            out = real(*a, **k)
            cuda_sync()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self._real)


class RequestLaunches:
    """While in a ``with`` block: each ``EnsembleServer.generate`` call's
    result, and its flash launches in the prefill and in the decode."""

    def __init__(self):
        self.results, self.prefill, self.decode = [], [], []

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.serve import server as srv
        self._gen, self._pre = srv.EnsembleServer.generate, \
            srv.ensemble_prefill
        real_gen, real_pre, mark = self._gen, self._pre, []

        def prefill(*a, **k):
            out = real_pre(*a, **k)
            mark.append(fa.LAUNCHES["flash_attention"])
            return out

        def generate(server, *a, **k):
            n0 = fa.LAUNCHES["flash_attention"]
            res = real_gen(server, *a, **k)
            self.results.append(res)
            self.prefill.append(mark[-1] - n0)
            self.decode.append(fa.LAUNCHES["flash_attention"] - mark[-1])
            return res

        srv.ensemble_prefill, srv.EnsembleServer.generate = prefill, generate
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import server as srv
        srv.EnsembleServer.generate, srv.ensemble_prefill = self._gen, \
            self._pre


def in_scratch(fn, *args):
    """``fn(*args, root)`` with ``root`` a new temporary directory, deleted
    when ``fn`` returns or raises."""
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return fn(*args, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _need_disk(root: str, need: float, what: str) -> None:
    """Print the free space at ``root`` and the bytes ``what`` needs;
    raise, naming both, when the disk is short."""
    free = shutil.disk_usage(root).free
    log(f"  disk at {root}: {free / 1e9:.2f} GB free; {what} needs "
        f"{need / 1e9:.2f} GB")
    if free < need:
        raise AssertionError(f"{what} needs {need / 1e9:.2f} GB of disk, "
                             f"{root} has {free / 1e9:.2f} GB free")


def _tree_bytes(tree) -> int:
    from repro_torch import tree as tu
    return sum(t.numel() * t.element_size() for t in tu.leaves(tree))


def phase_chaos(dev, shards, theta0, bank):
    """Table-1 BNN, T1_ROUNDS x T1_T steps, C = T1_CHAINS, every step in
    the trace, through the engine's ``run`` (chaos is a test harness of
    the engine, as in the reference), on packed and per_leaf: quarantine,
    respawn, the detector and a corrupted payload, each against the
    fault-free run; then, on packed, the health check's cost."""
    from repro_torch.core.health import Recovery
    from repro_torch.fed import CommSchedule, Compression, Federation
    from repro_torch.testing import ChaosSpec
    C, steps = T1_CHAINS, T1_ROUNDS * T1_T
    nan = ChaosSpec(nan_chains=(1,), nan_rounds=(2,))
    fed = Federation(schedule=CommSchedule(delay=2),
                     compression=Compression(kind="topk", frac=0.5,
                                             error_feedback=True))
    for ex in ("packed", "per_leaf"):
        eng = t1_sampler(dev, shards, bank, ex).engine
        want = _expect(ex, steps)

        def run(ex=ex, eng=eng, **kw):
            return eng.run(_gen(dev, 20), theta0, T1_ROUNDS, n_chains=C,
                           **kw)

        base, t_off, _, _ = _counted(f"chaos/{ex}", run, want)
        (out, h), _, counts, _ = _counted(
            f"chaos/{ex} quarantine",
            lambda: run(recovery=Recovery("quarantine"), chaos=nan), want)
        k = 2 * T1_T  # round 2's first step
        if h.word.tolist() != [0, 3, 0, 0]:
            raise AssertionError(f"quarantine word {h.word.tolist()}")
        same(f"chaos/{ex}: chains 0, 2, 3 under quarantine == fault-free",
             base[[0, 2, 3]], out[[0, 2, 3]])
        if not (torch.equal(out[1, :k], base[1, :k])
                and torch.equal(out[1, k:], base[1, k - 1].expand(
                    steps - k, -1))
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"chaos/{ex}: chain 1 does not repeat its "
                                 "post-round-1 state")
        log(f"  chaos/{ex} quarantine: word {h.word.tolist()}, "
            f"{sum(counts.values())} update launches ({steps} steps); "
            f"chain 1 finite, its "
            f"{steps - k} steps from round 2 on = its state after round 1")
        resp = [_counted(f"chaos/{ex} respawn", lambda: run(
            recovery=Recovery("respawn"), chaos=nan), want)[0]
            for _ in range(2)]
        if [r[1].word.tolist() for r in resp] != [[0, 1, 0, 0]] * 2:
            raise AssertionError(f"respawn words "
                                 f"{[r[1].word.tolist() for r in resp]}")
        same(f"chaos/{ex}: respawn, run twice", resp[0][0], resp[1][0])
        if not bool(torch.isfinite(resp[0][0]).all()):
            raise AssertionError("respawn: non-finite trace")
        (det, hd), _, _, _ = _counted(f"chaos/{ex} detector", lambda: run(
            recovery=Recovery("quarantine",
                              divergence_threshold=CHAOS_THRESHOLD)), want)
        if hd.n_healthy != C:
            raise AssertionError(f"detector tripped: {hd.word.tolist()}")
        same(f"chaos/{ex}: detector (threshold {CHAOS_THRESHOLD:g} nats) "
             "on a fault-free run == recovery off", det, base)
        log(f"  chaos/{ex} detector: window reference lp_ref "
            f"{[round(float(x), 3) for x in hd.lp_ref]}")
        fbase, _, _, _ = _counted(f"chaos/{ex} fed", lambda: run(
            federation=fed), want)
        (fout, hf), _, _, _ = _counted(f"chaos/{ex} payload", lambda: run(
            federation=fed, recovery=Recovery("quarantine"),
            chaos=ChaosSpec(payload_nan_chains=(1,),
                            payload_nan_rounds=(2,))), want)
        if hf.word.tolist() != [0, 3, 0, 0]:
            raise AssertionError(f"payload word {hf.word.tolist()}")
        same(f"chaos/{ex}: a NaN payload (delay 2, top-k 0.5, error "
             "feedback) quarantines chain 1 alone, word [0, 3, 0, 0]; "
             "chains 0, 2, 3", fbase[[0, 2, 3]], fout[[0, 2, 3]])

        # the cost, on the main (packed) path: recovery off / on / on with
        # the detector, in turns, on this run and on CHAOS_TIME_ROUNDS
        # one-step rounds (where a round's check is not lost in the noise
        # of 40 steps)
        if ex != "packed":
            continue
        kws = {"off": {}, "on": dict(recovery=Recovery("quarantine")),
               "detector": dict(recovery=Recovery(
                   "quarantine", divergence_threshold=CHAOS_THRESHOLD))}
        short = t1_sampler(dev, shards, bank, ex, rounds=CHAOS_TIME_ROUNDS,
                           local_steps=1).engine
        reps = {n: ([], []) for n in kws}
        for _ in range(CHAOS_REPS):
            for name, kw in kws.items():
                reps[name][0].append(_counted("chaos timing", lambda: run(
                    **kw), want)[1])
                reps[name][1].append(_counted(
                    "chaos timing", lambda: short.run(
                        _gen(dev, 20), theta0, CHAOS_TIME_ROUNDS,
                        n_chains=C, **kw),
                    _expect(ex, CHAOS_TIME_ROUNDS))[1])
        med = {n: [statistics.median(v) for v in r] for n, r in reps.items()}
        per_round = {n: 1e3 * (med[n][1] - med["off"][1]) / CHAOS_TIME_ROUNDS
                     for n in ("on", "detector")}
        log(f"  chaos/{ex} chain-steps/s (median of {CHAOS_REPS}, in turns):"
            + "".join(f" {n} {steps * C / med[n][0]:.1f};" for n in med)
            + f" health check per round (from {CHAOS_TIME_ROUNDS} one-step "
            f"rounds: off {1e3 * med['off'][1] / CHAOS_TIME_ROUNDS:.4f} ms "
            f"per round) {per_round['on']:.4f} ms, with the detector "
            f"{per_round['detector']:.4f} ms ({card_line()})")


def phase_resume_t1(dev, shards, theta0, bank, root):
    """Table-1, RESUME_ROUNDS rounds, snapshots every RESUME_EVERY, packed,
    through the facade, without a federation and under HARD_FED: the
    snapshotted run and the killed (newest snapshot deleted) and resumed
    run == the uninterrupted run, bitwise."""
    from repro_torch.checkpoint import list_snapshots
    from repro_torch.core import engine as teng
    from repro_torch.fed import CommSchedule, Compression, Federation
    hard = Federation(
        schedule=CommSchedule(delay=2, participation=0.6,
                              straggler_prob=0.2),
        compression=Compression(kind="topk", frac=0.5, error_feedback=True))
    steps = RESUME_ROUNDS * T1_T
    for name, fed in (("identity", None), ("HARD_FED", hard)):
        snaps = os.path.join(root, f"t1-{name}")

        def sample(fed=fed, **exe):
            s = t1_sampler(dev, shards, bank, "packed",
                           rounds=RESUME_ROUNDS, federation=fed, exe=exe)
            return s.sample(_gen(dev, 24), theta0)

        ref = _counted(name, sample, _expect("packed", steps))[0]
        kw = dict(snapshot_every=RESUME_EVERY, snapshot_path=snaps)
        with Timed(teng, "save_snapshot") as saves:
            a = _counted(name, lambda: sample(**kw),
                         _expect("packed", steps))[0]
        same(f"resume/table1 {name}: snapshots every {RESUME_EVERY} == "
             "uninterrupted", ref, a)
        kept = [r for r, _ in list_snapshots(snaps)]
        shutil.rmtree(list_snapshots(snaps)[-1][1])
        left = RESUME_ROUNDS - kept[-2]
        with Timed(teng, "latest_snapshot") as loads:
            b = _counted(name, lambda: sample(resume=True, **kw),
                         _expect("packed", left * T1_T))[0]
        same(f"resume/table1 {name}: snapshots {kept}, the newest deleted, "
             f"resumed from round {kept[-2]} ({left * T1_T} launches) == "
             "uninterrupted", ref, b)
        log(f"  save_snapshot {[round(s, 4) for s in saves.seconds]} s, "
            f"latest_snapshot {loads.seconds[0]:.4f} s")


def _c2_problem(dev):
    """[train-c2]'s model and data: qwen3-1.7b at full width, C2_LAYERS
    layers, 4 token clients, a bf16 'scalar' bank from 4 fit steps."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.data import token_shards
    from repro_torch.models import init_params, log_lik_fn
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=C2_LAYERS)
    theta0 = init_params(cfg, _gen(dev, 31), device=dev)
    data = token_shards(_gen(dev, 37), num_shards=TRAIN_S, shard_size=64,
                        seq_len=128, vocab_size=cfg.vocab_size)
    ll = lambda p, b: log_lik_fn(p, cfg, b)  # noqa: E731
    bank = api.fit_bank_local_sgld(ll, data, theta0, _gen(dev, 41),
                                   fit_steps=4, minibatch=8,
                                   step_size=TRAIN_H,
                                   store_dtype=torch.bfloat16)
    return cfg, theta0, data, bank, ll


def phase_resume_c2(dev, root):
    """[train-c2]'s model, C = C2_RESUME_CHAINS, collect=False,
    C2_RESUME_ROUNDS rounds x 2 steps, snapshots every C2_RESUME_EVERY:
    the killed and resumed run's final states == the uninterrupted run's,
    bitwise; the snapshot I/O timed."""
    from repro_torch import api
    from repro_torch import tree as tu
    from repro_torch.checkpoint import list_snapshots
    from repro_torch.core import engine as teng
    cfg, theta0, data, bank, ll = _c2_problem(dev)
    T = 2
    state_b = C2_RESUME_CHAINS * _tree_bytes(theta0)
    _need_disk(root, 3 * state_b, f"{C2_RESUME_ROUNDS // C2_RESUME_EVERY} "
               "snapshots kept and one being written")

    def sample(**exe):
        s = api.FSGLD(
            api.Posterior(ll, prior_precision=1.0), data, minibatch=8,
            step_size=TRAIN_H,
            surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
            schedule=api.Schedule(rounds=C2_RESUME_ROUNDS, local_steps=T,
                                  n_chains=C2_RESUME_CHAINS,
                                  reassign="permutation"),
            execution=api.Execution(device=dev, executor="packed",
                                    collect=False, dtype=torch.bfloat16,
                                    **exe))
        return s.sample(_gen(dev, 43), theta0)

    steps = C2_RESUME_ROUNDS * T
    flash = flash_expected(cfg, steps)
    ref, dt, _, _ = _counted("resume/c2", sample,
                             _expect("packed", steps), flash)
    ref = tu.tree_map(lambda t: t.cpu(), ref)
    snaps = os.path.join(root, "c2")
    kw = dict(snapshot_every=C2_RESUME_EVERY, snapshot_path=snaps)
    with Timed(teng, "save_snapshot") as saves:
        _counted("resume/c2 snapshots", lambda: sample(**kw),
                 _expect("packed", steps), flash)
    kept = [r for r, _ in list_snapshots(snaps)]
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    left = C2_RESUME_ROUNDS - kept[-2]
    with Timed(teng, "latest_snapshot") as loads, \
            Timed(teng, "save_snapshot") as saves2:
        b, _, _, _ = _counted("resume/c2 resumed",
                              lambda: sample(resume=True, **kw),
                              _expect("packed", left * T),
                              flash_expected(cfg, left * T))
    same(f"resume/c2 ({C2_LAYERS} layers, C={C2_RESUME_CHAINS}, "
         f"{state_b / 1e9:.2f} GB of fp32 chain state): snapshots {kept}, "
         f"the newest deleted, resumed from round {kept[-2]}: final states "
         "== uninterrupted", ref, tu.tree_map(lambda t: t.cpu(), b))
    del b, ref
    shutil.rmtree(snaps)
    w = saves.seconds + saves2.seconds
    log(f"  uninterrupted run {dt:.2f} s; save_snapshot of {state_b / 1e9:.2f}"
        f" GB: {[round(s, 2) for s in w]} s = "
        f"{[round(state_b / s / 1e9, 3) for s in w]} GB/s; latest_snapshot "
        f"(restore, hash, move back): {loads.seconds[0]:.2f} s = "
        f"{state_b / loads.seconds[0] / 1e9:.3f} GB/s ({card_line()})")


def phase_bank(dev, root):
    """The reference's train -> draw bank -> serve pipeline at qwen3-1.7b's
    full width and BANK_LAYERS of its layers through both drivers (the
    served request through ``launch.serve --log-jsonl``: its prefill and
    decode spans against the request's own times), then a refresh
    hot-swap and a corrupt draw at the same size. Full depth runs in
    [train]; the draws' I/O at full depth is PR 17's (PERF.md)."""
    import gc
    from repro_torch import checkpoint, configs
    from repro_torch import tree as tu
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.obs import read_jsonl
    from repro_torch.serve import EnsembleServer
    from repro_torch.serve.server import skeleton
    from repro_torch.testing import corrupt_draw
    n_draws = BANK_ROUNDS // BANK_EVERY
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"),
                              num_layers=BANK_LAYERS)
    like = skeleton(cfg)
    draw_b = _tree_bytes(like)
    P = draw_b // 4
    _need_disk(root, n_draws * draw_b,
               f"{n_draws} fp32 draws of {P} parameters")
    D = os.path.join(root, "bank")
    args = train.parse_args(_train_argv() + [
        "--rounds", str(BANK_ROUNDS), "--draw-bank", D, "--bank-every",
        str(BANK_EVERY), "--fit-steps", str(FAM_FIT)])
    steps = BANK_ROUNDS * TRAIN_T
    grads = TRAIN_S * FAM_FIT + steps
    real_cfg = (train.get_config, configs.get_config)
    train.get_config = configs.get_config = lambda arch: cfg
    try:
        tr, dt, _, n_flash = _counted(
            "bank/train", lambda: train.run(args), _expect("packed", steps),
            flash_expected(cfg, grads, 1 + args.chains))
    finally:
        train.get_config, configs.get_config = real_cfg
    want = checkpoint.tree_fingerprint(like)
    metas = [checkpoint.read_meta(p) for p in checkpoint.list_draws(D)]
    if [(m.arch, m.round, m.dtype, m.config_hash) for m in metas] != [
            (cfg.name, r, "float32", want)
            for r in range(BANK_EVERY, BANK_ROUNDS + 1, BANK_EVERY)]:
        raise AssertionError(f"bank metas {metas}")
    t0 = time.perf_counter()
    fresh, _, _ = checkpoint.restore(tr.draws[-1], like)
    read_s = time.perf_counter() - t0
    same(f"bank: the freshest draw (round {metas[-1].round}) == the run's "
         "final chain state", fresh,
         tu.tree_map(lambda t: t[0].cpu(), tr.finals))
    log(f"  train --draw-bank ({BANK_LAYERS} layers): {steps} update and "
        f"{n_flash} flash launches in {dt:.2f} s; {n_draws} draws of {P} "
        f"fp32 parameters ({draw_b / 1e9:.2f} GB each): write "
        f"{[round(s, 2) for s in tr.draw_write_s]} s = "
        f"{[round(draw_b / s / 1e9, 3) for s in tr.draw_write_s]} GB/s;"
        f" a draw read back (restore: hash + parse) {read_s:.2f} s; metas "
        f"arch {cfg.name}, rounds {[m.round for m in metas]}, float32, "
        f"config_hash {want} (the skeleton's)")
    del tr, fresh
    gc.collect()
    torch.cuda.empty_cache()

    log_path = os.path.join(root, "serve.jsonl")
    configs.get_config = lambda arch: cfg
    try:
        with Timed(EnsembleServer, "_load") as loads, \
                RequestLaunches() as req:
            _, dt, _, _ = _counted("bank/serve", lambda: serve_cli.main([
                "--arch", "qwen3-1.7b", "--bank", D, "--draws",
                str(n_draws), "--device", str(dev), "--batch", str(SERVE_B),
                "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN),
                "--log-jsonl", log_path]), {}, BANK_LAYERS)
    finally:
        configs.get_config = real_cfg[1]
    res, = req.results
    if (req.prefill, req.decode) != ([BANK_LAYERS], [0]) or \
            tuple(res.tokens.shape) != (SERVE_B, SERVE_GEN) or \
            res.n_draws != n_draws:
        raise AssertionError(f"bank/serve: flash prefill {req.prefill}, "
                             f"decode {req.decode}, tokens {res.tokens.shape}")
    _check_signals("bank/serve", res, n_draws)
    spans = {r["name"]: r for r in read_jsonl(log_path)
             if r["type"] == "span"}
    for name, s in (("serve.prefill", res.prefill_s),
                    ("serve.decode", res.decode_s)):
        if name not in spans or not (
                s <= spans[name]["dur_s"] + 1e-6
                and spans[name]["dur_s"] - s < SPAN_SLACK_S):
            raise AssertionError(f"bank/serve --log-jsonl: {name} "
                                 f"{spans.get(name)} against {s} s")
    log(f"  launch.serve --bank --draws {n_draws} --log-jsonl: load "
        f"{loads.seconds[0]:.2f} s ({n_draws} draws read, moved and cast one "
        f"at a time); one request of {SERVE_B} x {SERVE_S}, {SERVE_GEN} "
        f"tokens: prefill {res.prefill_s:.4f} s (span "
        f"{spans['serve.prefill']['dur_s']:.4f}), decode "
        f"{res.decode_s:.4f} s (span {spans['serve.decode']['dur_s']:.4f});"
        f" flash launches prefill {req.prefill[0]}, decode "
        f"{req.decode[0]}; the command {dt:.2f} s")
    del res, req
    gc.collect()
    torch.cuda.empty_cache()

    # the refresh checks on the training run's bank (rounds r1 < r2): two
    # draws appended, one of them then truncated
    _need_disk(root, 2 * draw_b, f"2 more fp32 draws of {BANK_LAYERS} "
               "layers")
    r1, r2 = [m.round for m in metas]
    r3, r4 = BANK_ROUNDS + 1, BANK_ROUNDS + 2

    def append(r):
        p = init_params(cfg, _gen(dev, 60 + r), device=dev)
        with Timed(checkpoint, "save_draw") as t:
            checkpoint.save_draw(D, p, checkpoint.DrawMeta(
                round=r, arch=cfg.name, dtype="float32"), step=r)
        return t.seconds[0]

    gen = _gen(dev, 17)

    def request(server, what):
        res, _, _, n = _counted(f"bank/{what}", lambda: server.generate(
            generator=gen, gen=8, batch=2, prompt_len=512), {},
            BANK_LAYERS)
        _check_signals(f"bank/{what}", res, server.n_draws)
        return n

    with Timed(EnsembleServer, "_load") as loads:
        server = EnsembleServer(cfg, bank=D, n_draws=2, device=dev)
    if [m.round for m in server.metas] != [r1, r2]:
        raise AssertionError(f"bank server: {server.metas}")
    request(server, "initial")
    writes = [append(r3)]
    with Timed(EnsembleServer, "refresh") as refresh:
        swapped = server.refresh()
    if not swapped or [m.round for m in server.metas] != [r2, r3]:
        raise AssertionError(f"refresh: {swapped}, {server.metas}")
    request(server, "hot-swapped")
    writes.append(append(r4))
    corrupt_draw(checkpoint.list_draws(D)[-2], mode="truncate")
    import warnings
    with Timed(EnsembleServer, "refresh") as refresh2, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        swapped = server.refresh(backoff_s=0.0)
    if not swapped or [m.round for m in server.metas] != [r2, r4] or \
            not any("corrupt" in str(w.message) for w in caught):
        raise AssertionError(f"refresh past a corrupt draw: {swapped}, "
                             f"{server.metas}")
    n = request(server, "degraded")
    del server
    shutil.rmtree(D)
    log(f"  {BANK_LAYERS} layers ({draw_b / 4:.0f} parameters, "
        f"{draw_b / 1e9:.2f} GB per fp32 draw): save_draw "
        f"{[round(s, 2) for s in writes]} s = "
        f"{[round(draw_b / s / 1e9, 3) for s in writes]} GB/s; a server on "
        f"the training run's rounds [{r1}, {r2}] loaded in "
        f"{loads.seconds[0]:.2f} s; refresh() hot-swap to rounds [{r2}, "
        f"{r3}] {refresh.seconds[0]:.2f} s; round {r3}'s draw truncated, "
        f"refresh() serves rounds [{r2}, {r4}] with a warning in "
        f"{refresh2.seconds[0]:.2f} s; {n} flash launches per request "
        f"({card_line()})")


# ---------------------------------------------------------------------------
# observability and the streamed client axis
# ---------------------------------------------------------------------------

class Traced:
    """While in a ``with`` block: the process-wide tracer writes to a JSONL
    file in a new temporary directory; ``records`` reads it back."""

    def __enter__(self):
        from repro_torch.obs import trace as obs_trace
        self.root = tempfile.mkdtemp(prefix="chip_smoke_trace_")
        self.path = os.path.join(self.root, "trace.jsonl")
        obs_trace.configure(self.path)
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import trace as obs_trace
        obs_trace.configure()
        self.records = (obs_trace.read_jsonl(self.path)
                        if os.path.exists(self.path) else [])
        shutil.rmtree(self.root, ignore_errors=True)

    def named(self, name):
        return [r for r in self.records if r["name"] == name]


def _finite_frame(name, frame, rounds, chains):
    import numpy as np
    finite = {n: bool(np.isfinite(a).all()) for n, a in frame.metrics.items()}
    if (frame.rounds, frame.n_chains) != (rounds, chains) or \
            not all(finite.values()):
        raise AssertionError(f"{name}: frame {frame.rounds} x "
                             f"{frame.n_chains}, finite rows {finite}")


def phase_telemetry(dev, shards, theta0, bank):
    """Table-1 BNN with ``Telemetry(probe=True)`` on packed and per_leaf:
    bitwise the run without it under no federation, a federation with
    partial participation and top-k, and recovery with a NaN chain (its
    health_word non-zero); participation / bytes_per_round against the
    schedule; log_every=2's progress events; the JSONL / Prometheus files
    read back; telemetry's cost per round, off against on."""
    import numpy as np
    from repro_torch.core.health import Recovery
    from repro_torch.fed import CommSchedule, Compression, Federation
    from repro_torch.obs import (Telemetry, parse_prometheus,
                                 read_metrics_jsonl, write_metrics_jsonl,
                                 write_prometheus)
    from repro_torch.testing import ChaosSpec
    C, steps, R = T1_CHAINS, T1_ROUNDS * T1_T, T1_ROUNDS
    tel = Telemetry(probe=True)
    fed = Federation(schedule=CommSchedule(participation=0.6),
                     compression=Compression(kind="topk", frac=0.01))
    wire = fed.compression.bytes_per_round(854)
    nan = ChaosSpec(nan_chains=(1,), nan_rounds=(2,))
    for ex in ("packed", "per_leaf"):
        eng = t1_sampler(dev, shards, bank, ex).engine
        want = _expect(ex, steps)

        def run(ex=ex, eng=eng, **kw):
            return eng.run(_gen(dev, 20), theta0, R, n_chains=C, **kw)

        for what, kw in (("no federation", {}),
                         ("participation 0.6 + top-k 1%",
                          dict(federation=fed)),
                         ("quarantine, NaN chain 1 at round 2",
                          dict(recovery=Recovery("quarantine"),
                               chaos=nan))):
            off = _counted(f"telemetry/{ex} off", lambda: run(**kw), want)[0]
            on = _counted(f"telemetry/{ex} {what}",
                          lambda: run(telemetry=tel, **kw), want)[0]
            frame = on[-1]
            same(f"telemetry/{ex} {what}: on == off",
                 off if isinstance(off, torch.Tensor) else off[0], on[0])
            _finite_frame(f"telemetry/{ex} {what}", frame, R, C)
            m = frame.metrics
            if "federation" in kw:
                part = m["participation"]
                if not (set(np.unique(part)) <= {0.0, 1.0}
                        and (part[0] == 1).all() and 0 < part.mean() < 1
                        and np.array_equal(m["bytes_per_round"],
                                           part * np.float32(wire))):
                    raise AssertionError(f"participation {part.tolist()}")
                log(f"  telemetry/{ex} {what}: participation per round "
                    f"{part.sum(1).tolist()} of {C}, bytes_per_round "
                    f"{wire:g} per exchange")
            if "recovery" in kw:
                hw = m["health_word"]
                if hw[:, 1].tolist() != [0, 0, 3, 3, 3] or \
                        hw[:, [0, 2, 3]].any() or \
                        on[1].word.tolist() != [0, 3, 0, 0]:
                    raise AssertionError(f"health_word {hw.tolist()}")
                log(f"  telemetry/{ex} {what}: health_word chain 1 "
                    f"{hw[:, 1].tolist()}, the others 0; drift_norm chain 1 "
                    f"{m['drift_norm'][:, 1].tolist()}")
            if not kw:
                one = on
                log(f"  telemetry/{ex}: last round " + ", ".join(
                    f"{n} {np.round(m[n][-1], 6).tolist()}"
                    for n in frame.names))
        # log_every=2: 3 segments, their progress events, bitwise
        with Traced() as tr:
            seg = _counted(f"telemetry/{ex} log_every", lambda: run(
                telemetry=Telemetry(log_every=2)), want)[0]
        same(f"telemetry/{ex}: log_every=2 == one segment", one[0], seg[0])
        for n in tel.names:
            if not np.array_equal(one[1].metrics[n], seg[1].metrics[n]):
                raise AssertionError(f"log_every frame row {n}")
        prog = tr.named("engine.progress")
        if [p["round"] for p in prog] != [2, 4, 5]:
            raise AssertionError(f"progress events {prog}")
        log(f"  telemetry/{ex}: log_every=2 progress events at rounds "
            f"{[p['round'] for p in prog]}, steps/s "
            f"{[p['steps_per_s'] for p in prog]}")
    root = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    try:
        frame = one[1]
        write_metrics_jsonl(frame, os.path.join(root, "m.jsonl"))
        write_prometheus(frame, os.path.join(root, "m.prom"))
        back = read_metrics_jsonl(os.path.join(root, "m.jsonl"))
        prom = parse_prometheus(os.path.join(root, "m.prom"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for n in frame.names:
        if not np.array_equal(back.metrics[n], frame.metrics[n]):
            raise AssertionError(f"metrics.jsonl row {n} does not read back")
    if prom["fsgld_rounds_total"] != R or len(prom) != 1 + len(
            frame.names) * (C + 1):
        raise AssertionError(f"metrics.prom: {len(prom)} samples")
    log(f"  metrics.jsonl read back bitwise; metrics.prom {len(prom)} "
        "samples")

    # the cost: TEL_TIME_ROUNDS one-step packed rounds, off / probe-free /
    # with the probe, in turns
    short = t1_sampler(dev, shards, bank, "packed", rounds=TEL_TIME_ROUNDS,
                       local_steps=1).engine
    kws = {"off": {}, "on, no probe": dict(telemetry=Telemetry(probe=False)),
           "on": dict(telemetry=tel)}
    reps = {n: [] for n in kws}
    for _ in range(TEL_REPS):
        for name, kw in kws.items():
            reps[name].append(_counted("telemetry timing", lambda: short.run(
                _gen(dev, 20), theta0, TEL_TIME_ROUNDS, n_chains=C, **kw),
                _expect("packed", TEL_TIME_ROUNDS))[1])
    med = {n: statistics.median(v) for n, v in reps.items()}
    ms = {n: 1e3 * med[n] / TEL_TIME_ROUNDS for n in med}
    log(f"  telemetry cost on {TEL_TIME_ROUNDS} one-step packed rounds "
        f"(median of {TEL_REPS}, in turns): ms per round " + ", ".join(
            f"{n} {v:.4f}" for n, v in ms.items())
        + f"; telemetry {ms['on'] - ms['off']:.4f} ms per round "
        f"({ms['on, no probe'] - ms['off']:.4f} without the probe) "
        f"({card_line()})")
    return ms


def _t1_perm(dev, shards, bank, executor, method, federation=None,
             stream=None):
    """The Table-1 BNN with permutation reassignment (the streamed axis
    replays it), through the facade."""
    from repro_torch import api
    from repro_torch.workloads import table1_log_lik
    return api.FSGLD(
        api.Posterior(table1_log_lik, prior_precision=1.0), shards,
        minibatch=T1_M, step_size=T1_H, method=method,
        surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                   if method == "fsgld" else None),
        schedule=api.Schedule(rounds=T1_ROUNDS, local_steps=T1_T,
                              n_chains=T1_CHAINS, reassign="permutation",
                              thin=20),
        execution=api.Execution(device=dev, executor=executor,
                                stream=stream),
        federation=federation)


def phase_stream_t1(dev, shards, theta0, bank):
    """Table 1's 10 clients streamed through Stream(4, 1) and 2-round
    windows, C = 4, on packed and per_leaf, for DSGLD, FSGLD with the
    Fisher bank and under delay 2 / participation 0.6: each streamed run
    bitwise the resident run; chain-steps/s streamed against resident and
    with the prefetch on against off. The 2-round windows are Stream(6, 2)
    where the plan fits: under the delayed schedule it always does (rounds
    2r + 1 keep round 2r's clients); where every round reassigns two
    rounds may touch 8 clients, the planner then refuses Stream(6, 2)
    naming that minimum, and the run takes Stream(8, 2)."""
    from repro_torch.fed import CommSchedule, Federation, Stream
    steps = T1_ROUNDS * T1_T
    sched = Federation(schedule=CommSchedule(delay=2, participation=0.6))
    cases = (("dsgld", "dsgld", None), ("fsgld", "fsgld", None),
             ("delay 2 / participation 0.6", "fsgld", sched))
    rate = {}
    for ex in ("packed", "per_leaf"):
        want = _expect(ex, steps)
        for name, method, fed in cases:
            ref, dt, _, _ = _counted(
                f"stream/{ex} {name} resident", lambda: _t1_perm(
                    dev, shards, bank, ex, method, fed).sample(
                    _gen(dev, 30), theta0), want)
            rate.setdefault((ex, "resident"), []).append(dt)
            K2 = 6
            try:
                _t1_perm(dev, shards, bank, ex, method, fed,
                         Stream(resident=6, window=2)).sample(
                    _gen(dev, 30), theta0)
            except ValueError as e:
                if fed is not None or \
                        "raise resident to at least 8" not in str(e):
                    raise
                log(f"  stream/{ex} {name}: Stream(6, 2) refused: {e}")
                K2 = 8
            for K, W in ((4, 1), (K2, 2)):
                for pf in (True, False):
                    got, dt, _, _ = _counted(
                        f"stream/{ex} {name} ({K}, {W})", lambda: _t1_perm(
                            dev, shards, bank, ex, method, fed,
                            Stream(resident=K, window=W, prefetch=pf)
                        ).sample(_gen(dev, 30), theta0), want)
                    if not torch.equal(ref, got):
                        raise AssertionError(f"stream/{ex} {name} "
                                             f"Stream({K}, {W}, {pf}) != "
                                             "resident")
                    rate.setdefault((ex, f"window {W} prefetch "
                                     f"{'on' if pf else 'off'}"),
                                    []).append(dt)
        log(f"  stream/{ex}: Stream(4, 1) and 2-round windows, prefetch on "
            "and off, == resident bitwise for dsgld, fsgld (Fisher bank), "
            "delay 2 / participation 0.6")
    log("  stream chain-steps/s (median over the 3 cases): " + "; ".join(
        f"{ex} {what} {T1_CHAINS * steps / statistics.median(v):.1f}"
        for (ex, what), v in rate.items()) + f" ({card_line()})")


def phase_stream_qwen3(dev):
    """qwen3-1.7b at full width and C2_LAYERS of its 28 layers (the
    streamed mechanism does not depend on depth; [train] runs the full
    depth) through the train driver with 10^6 lazy clients and 4
    resident: one update launch per step, one flash launch per layer per
    pass, at most 4 clients' rows built per window, the chain finite and
    within TRAIN_GUARD of theta0; the stage ms per window, overlap_frac,
    peak device memory, chain-steps/s."""
    from repro_torch.configs import get_config
    from repro_torch.fed import SyntheticClientSource
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-1.7b", "--method", "dsgld", "--clients",
            str(STREAM_CLIENTS), "--resident", "4", "--step-size",
            repr(STREAM_H)]
    args = train.parse_args(argv)
    built = []
    real = SyntheticClientSource.rows

    def rows(src, ids):
        built.append(len(ids))
        return real(src, ids)

    steps = TRAIN_R * TRAIN_T
    passes = steps + 1 + args.chains
    SyntheticClientSource.rows = rows
    real_config = train.get_config
    c2_cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                                 num_layers=C2_LAYERS)
    train.get_config = lambda arch: dataclasses.replace(
        get_config(arch), num_layers=C2_LAYERS)
    try:
        with Traced() as tr_trace:
            tr, dt, _, n_flash = _counted(
                "stream/qwen3", lambda: train.run(args),
                _expect("packed", steps),
                flash_expected(c2_cfg, steps, 1 + args.chains))
    finally:
        SyntheticClientSource.rows = real
        train.get_config = real_config
    stage = [1e3 * r["dur_s"] for r in tr_trace.named("stream.stage")]
    disp = [1e3 * r["dur_s"] for r in tr_trace.named("stream.dispatch")]
    ov, = tr_trace.named("stream.prefetch_overlap")
    # the windows' rows (one per window) and the ll probe's one client
    if sorted(built) != [1] + [4] * TRAIN_R:
        raise AssertionError(f"client rows built: {built}")
    if not (all(math.isfinite(x) for x in tr.lls)
            and min(tr.lls) >= tr.ll0 - TRAIN_GUARD):
        raise AssertionError(f"stream/qwen3: ll/token {tr.lls} against "
                             f"{tr.ll0} at theta0")
    log(f"  {STREAM_CLIENTS} clients, resident 4, dsgld, h {STREAM_H:g} "
        f"(h S N_s / m = {STREAM_H * STREAM_CLIENTS * 64 / 8:g}): "
        f"{steps} update and {n_flash} flash launches "
        f"({grad_attn_launches(c2_cfg)} x {steps} gradient passes + "
        f"{C2_LAYERS} x {passes - steps} forwards); client rows built per "
        f"call {built} (never "
        f"{STREAM_CLIENTS}); ll/token theta0 {tr.ll0:.4f}, chains "
        f"{[round(x, 4) for x in tr.lls]}; sampling {tr.sample_s:.2f} s = "
        f"{steps / tr.sample_s:.3f} chain-steps/s; peak device memory "
        f"sampling {tr.peak_gb['sampling']:.2f} GB; stage ms per window "
        f"{[round(x, 2) for x in stage]}, dispatch ms per window "
        f"{[round(x, 1) for x in disp]}; overlap_frac "
        f"{ov['overlap_frac']} (stage {ov['stage_s']} s of wall "
        f"{ov['wall_s']} s) ({card_line()})")
    if tr.peak_gb["sampling"] > 79.18 * 2**30 / 1e9:
        raise AssertionError(f"peak {tr.peak_gb}")
    return {"stage_ms": stage, "overlap_frac": ov["overlap_frac"],
            "peak_gb": tr.peak_gb["sampling"],
            "steps_per_s": steps / tr.sample_s}


def phase_stream_c2(dev):
    """The train driver at [train-c2]'s size (full width, C2_LAYERS
    layers, C = C2_CHAINS) on STREAM_C2_SHARDS token shards, FSGLD with
    FAM_FIT fit steps: ``--resident 2`` bitwise the same run without
    it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    real = train.get_config
    train.get_config = lambda arch: dataclasses.replace(
        get_config(arch), num_layers=C2_LAYERS)
    base = _train_argv() + ["--num-shards", str(STREAM_C2_SHARDS),
                            "--chains", str(C2_CHAINS), "--fit-steps",
                            str(FAM_FIT)]
    steps = TRAIN_R * TRAIN_T
    try:
        runs = [_counted(f"stream/c2 {what}", lambda: train.run(
            train.parse_args(base + extra)), _expect("packed", steps))
            for what, extra in (("resident", []),
                                ("--resident 2", ["--resident", "2"]))]
    finally:
        train.get_config = real
    (a, dta, _, _), (b, dtb, _, _) = runs
    same(f"stream/c2: {C2_LAYERS} layers, C={C2_CHAINS}, "
         f"{STREAM_C2_SHARDS} shards, --resident 2 == resident", a.finals,
         b.finals)
    log(f"  stream/c2: ll/token {[round(x, 4) for x in b.lls]}; sampling "
        f"{a.sample_s:.2f} s resident, {b.sample_s:.2f} s streamed "
        f"({steps * C2_CHAINS / a.sample_s:.3f} / "
        f"{steps * C2_CHAINS / b.sample_s:.3f} chain-steps/s)")


# ---------------------------------------------------------------------------
# the MoE, RG-LRU and RWKV-6 families
# ---------------------------------------------------------------------------

def family_config(arch, layers):
    """``arch``'s published config at ``layers`` layers (None: all),
    checked against its published width."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    width = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.d_ff, cfg.vocab_size)
    if width != FAMILIES[arch]["width"]:
        raise AssertionError(f"not {arch}'s published width: {width}")
    return cfg


# (module of repro_torch.models, function): the blocks block_ms ranges
BLOCKS = (("layers", "moe_ffn"), ("layers", "rglru_forward"),
          ("layers", "linear_scan"), ("layers", "rwkv_forward"),
          ("model", "encoder_forward"), ("model", "_cross_attn"))


def block_ms(fn, what: str) -> None:
    """One call of ``fn`` (a path the phase has already run, so warm)
    under torch.profiler with each block of ``repro_torch.models`` named
    in BLOCKS inside a ``record_function`` range: each block's device ms
    summed over the call (its kernels' time) and its calls, beside the
    call's kernels' device ms and wall ms."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mods = {m: importlib.import_module(f"repro_torch.models.{m}")
            for m, _ in BLOCKS}
    real = {(m, n): getattr(mods[m], n) for m, n in BLOCKS}

    def ranged(name, f):
        def g(*a, **k):
            with record_function(f"block:{name}"):
                return f(*a, **k)
        return g

    for (m, n), f in real.items():
        setattr(mods[m], n, ranged(n, f))
    try:
        cuda_sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            cuda_sync()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for (m, n), f in real.items():
            setattr(mods[m], n, f)
    # a range is listed twice: on the host (its kernels' time summed) and
    # as a span on the device, which is not a kernel
    ev = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("block:")) / 1e3
    parts = [f"{e.key[6:]} {e.device_time_total / 1e3:.2f} ms in "
             f"{e.count} calls" for e in ev if e.key.startswith("block:")
             and e.device_type == DeviceType.CPU]
    log(f"  [profile] {what}: wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms; "
        + ("; ".join(parts) or "no block") + f" ({card_line()})")


def serve_family(dev, arch):
    """``arch`` at its published width and serving depth through
    ``FSGLD.serve``: K fresh draws, one request of batch x prompt (and
    its patches or frames, drawn by the server; the main path: flash
    launches one per self-attention in prefill, the encoder's included,
    none in decode), the kernel against its plain version at each of the
    path's attention shapes, then ``prompt_checks`` (for the vlm once
    more with the anchor's gates opened to VLM_GATE: at 0 they hide the
    cross-attention) and the blocks' device time in one prefill. Returns
    the request's flash launches."""
    from repro_torch import api, configs
    from repro_torch import models as TM
    from repro_torch import tree as tu
    from repro_torch.models.model import ENCODER_FAMILIES
    fam = FAMILIES[arch]
    layers, K, B, S = fam["serve"]
    cfg = family_config(arch, layers)
    n_attn = attn_layers(cfg)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    real = configs.get_config
    configs.get_config = lambda a: cfg
    try:
        t0 = time.perf_counter()
        server = api.FSGLD.serve(api.Serving(arch=arch, smoke=False,
                                             draws=K))
        cuda_sync()
    finally:
        configs.get_config = real
    P = sum(t[0].numel() for t in tu.leaves(server.draws))
    held = sum(t.numel() * t.element_size() for t in tu.leaves(server.draws))
    log(f"  {K} draws of {cfg.name} ({cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "") + f", {n_attn} self-attending, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} "
        f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f"): {P} parameters per draw, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s; served weights "
        f"{held / 1e9:.2f} GB; peak device memory while initialising "
        f"{_peak(base)}")
    gen = _gen(dev, 17)
    cuda_sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with RequestLaunches() as req:
        res, dt, _, n = _counted(
            f"serve-{fam['tag']}", lambda: server.generate(
                generator=gen, gen=SERVE_GEN, batch=B, prompt_len=S),
            {}, n_attn)
    if (req.prefill, req.decode) != ([n_attn], [0]) or \
            tuple(res.tokens.shape) != (B, SERVE_GEN) or res.n_draws != K:
        raise AssertionError(f"serve-{fam['tag']}: flash prefill "
                             f"{req.prefill}, decode {req.decode}, tokens "
                             f"{tuple(res.tokens.shape)}")
    _check_signals(f"serve-{fam['tag']}", res, K)
    log(f"  request: batch {B} x prompt {S}, {SERVE_GEN} new tokens, K={K}:"
        f" prefill {res.prefill_s:.3f} s, decode {res.decode_s:.3f} s = "
        f"{B * (SERVE_GEN - 1) / res.decode_s:.1f} tok/s "
        f"({1e3 * res.decode_s / (SERVE_GEN - 1):.1f} ms per step of {K} "
        f"draws); flash_attention launches {n} (prefill {req.prefill[0]}, "
        f"decode {req.decode[0]}); peak device memory while serving "
        f"{_peak(base)} ({card_line()})")
    from repro_torch.kernels import flash_attention as fa
    for shape, causal, window in attn_shapes(cfg, B, S):
        q, k, v = _qkv(gen, *shape, torch.bfloat16)
        mask = dict(causal=causal, window=window)
        err, use = flash_err(fa.flash_attention(q, k, v, **mask),
                             fa.flash_attention_plain(q, k, v, **mask))
        del q, k, v
        log(f"  flash kernel at the path's shape (B, S, H, Hkv, hd) = "
            f"{shape}, causal {causal}, window {window}, bf16: "
            f"max|kernel-plain| {err:.3e}, {100 * use:.1f}% of the "
            "tolerance")
        if not use <= 1:
            raise AssertionError(f"serve-{fam['tag']}: the flash kernel "
                                 "disagrees with its plain version")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    enc = None
    if cfg.family in ENCODER_FAMILIES:
        T = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq
        enc = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
    prompt_checks(server, cfg, prompt, SERVE_GEN, enc)
    anchor = tu.tree_map(lambda t: t[0], server.draws)
    pcfg, panchor = _shallow(cfg, anchor, fam.get("profile"))
    if cfg.family == "vlm":
        _, _, launched, rel = _prefill_rel(open_gates(anchor), cfg, prompt,
                                           S + SERVE_GEN, enc)
        log(f"  anchor prefill with every gate at {VLM_GATE}: kernel vs "
            f"plain attention max|diff|/max|logits| {rel:.3e} (limit "
            f"{PREFILL_REL}); flash_attention launches {launched}")
    block_ms(lambda: TM.prefill_with_cache(panchor, pcfg, prompt,
                                           S + SERVE_GEN, enc_embeds=enc),
             f"one prefill of batch {B} x {S} on one draw, "
             f"{pcfg.num_layers} of its {cfg.num_layers} layers")
    return n


def _shallow(cfg, params, layers):
    """``cfg`` and one draw ``params`` cut to their first ``layers``
    decoder layers (whole periods, no remainder; None: as they are)."""
    if layers is None:
        return cfg, params
    from repro_torch import tree as tu
    n = min(layers, cfg.num_layers) // len(cfg.layer_pattern)
    out = {k: v for k, v in params.items() if k != "rem_blocks"}
    out["blocks"] = tu.tree_map(lambda t: t[:n], params["blocks"])
    return dataclasses.replace(
        cfg, num_layers=n * len(cfg.layer_pattern)), out


def _executor_copy(s, executor, dev):
    """The sampler ``s`` (a train driver's) with its bank, on another
    executor, without telemetry, CHECK_T local steps per round."""
    from repro_torch import api
    return api.FSGLD(
        s.posterior, s.data, minibatch=s.minibatch,
        step_size=s.cfg.step_size,
        surrogate=api.SurrogateSpec(kind="scalar", bank=s.bank),
        schedule=dataclasses.replace(s.schedule, local_steps=CHECK_T),
        execution=api.Execution(device=dev, executor=executor,
                                collect=False, dtype=s.execution.dtype,
                                bank_device=s.execution.bank_device))


def _driver_run(cfg, args):
    """The train driver's run of ``args`` with ``cfg`` in place of its
    arch's config and its telemetry written to a temporary
    ``--metrics-dir``: (TrainRun, the telemetry frame)."""
    from repro_torch.launch import train
    from repro_torch.obs import read_metrics_jsonl
    args.metrics_dir = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    real = train.get_config
    train.get_config = lambda a: cfg
    try:
        tr = train.run(args)
        return tr, read_metrics_jsonl(os.path.join(args.metrics_dir,
                                                   "metrics.jsonl"))
    finally:
        train.get_config = real
        shutil.rmtree(args.metrics_dir, ignore_errors=True)


def _facade_run(cfg, args):
    """What the train driver's run of ``args`` does (its data, parameters,
    fit, sampling with telemetry and probes, on the packed executor), for
    a family whose likelihood reads enc_embeds, which the driver refuses:
    through ``api.FSGLD`` directly, each row of the token shards carrying
    its frames (``make_batch``'s bf16 normals; the engine gathers them
    with the row's tokens). (TrainRun, the telemetry frame)."""
    from repro_torch import api
    from repro_torch import tree as tu
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch, token_shards
    from repro_torch.launch import train
    from repro_torch.models import init_params, log_lik_fn
    dev = torch.device(DEVICE)

    def gen(stream):
        return train._generator(dev, args.seed, stream)

    params = init_params(cfg, gen(0), device=dev)
    S, n = args.num_shards, args.shard_size
    shards = token_shards(gen(1), num_shards=S, shard_size=n,
                          seq_len=args.seq, vocab_size=cfg.vocab_size)
    frames = make_batch(cfg, InputShape("shards", seq_len=args.seq,
                                        global_batch=S * n, kind="train"),
                        gen(4))["enc_embeds"]
    shards["enc_embeds"] = frames.reshape((S, n) + tuple(frames.shape[1:]))
    del frames
    m = min(args.batch, n)
    fsgld = api.FSGLD(
        api.Posterior(lambda p, b: log_lik_fn(p, cfg, b),
                      prior_precision=1.0),
        shards, minibatch=m, step_size=args.step_size,
        surrogate=api.SurrogateSpec(kind="scalar", fit="local_sgld",
                                    fit_steps=args.fit_steps,
                                    fit_minibatch=m),
        schedule=api.Schedule(rounds=args.rounds,
                              local_steps=args.local_updates,
                              n_chains=args.chains, reassign="permutation"),
        execution=api.Execution(device=dev, executor="packed", collect=False,
                                dtype=getattr(torch, cfg.surrogate_dtype),
                                bank_device="cpu",
                                telemetry=api.Telemetry()))
    probe = tu.tree_map(lambda d: d[0][:args.batch], shards)
    ll0 = train.ll_per_token(params, cfg, probe)
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fsgld.fit(gen(2), params)
    cuda_sync()
    fit_s = time.perf_counter() - t0
    peak["fit"] = torch.cuda.max_memory_allocated() / 1e9
    params = tu.tree_map(lambda t: t.to("cpu"), params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    finals, frame = fsgld.sample(gen(3), params)
    cuda_sync()
    dt = time.perf_counter() - t0
    peak["sampling"] = torch.cuda.max_memory_allocated() / 1e9
    lls = [train.ll_per_token(tu.tree_map(lambda t: t[c], finals), cfg,
                              probe) for c in range(args.chains)]
    return train.TrainRun(cfg=cfg, sampler=fsgld, theta0=params,
                          finals=finals, ll0=ll0, lls=lls, fit_s=fit_s,
                          sample_s=dt, peak_gb=peak, frame=frame), frame


def remat_check(dev, arch, layers):
    """One chain's ``vmap(grad(log_lik_fn))`` at ``arch``'s published width
    and ``layers`` layers, on one minibatch of the driver's shape (8 x
    128 tokens), with the recompute (``cfg.remat``) on and off: every
    gradient leaf within ATOL + RTOL|x| of the other and the pass's peak
    device memory lower with it on."""
    from torch.func import grad, vmap
    from repro_torch import tree as tu
    from repro_torch.models import model as TM
    cfg = family_config(arch, layers)
    gen = _gen(dev, 31)
    params = tu.tree_map(lambda t: t[None],
                         TM.init_params(cfg, gen, device=dev))
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 8, 128), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    grads, peaks, secs = {}, {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        cuda_sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads[remat] = vmap(grad(lambda p, b: TM.log_lik_fn(p, c, b)))(
            params, batch)
        cuda_sync()
        secs[remat] = time.perf_counter() - t0
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
    worst = _err(tuple(tu.leaves(grads[True])),
                 tuple(tu.leaves(grads[False])))
    if not peaks[True] < peaks[False]:
        raise AssertionError(f"remat: peak {peaks[True]:.2f} GB with the "
                             f"recompute, {peaks[False]:.2f} GB without")
    log(f"  remat on vs off, {cfg.name} at {layers} layers, one gradient "
        f"pass of 8 x 128 tokens: max |on - off| {worst:.3e} (tolerance "
        f"{ATOL:g} + {RTOL:g}|x|); peak above the parameters "
        f"{peaks[True]:.2f} GB on, {peaks[False]:.2f} GB off; {secs[True]:.3f}"
        f" s / {secs[False]:.3f} s ({card_line()})")


def train_family(dev, arch, failures):
    """``arch`` at its published width and sampling depth through the
    train driver, or for the encoder families (whose batches carry
    enc_embeds, which the driver refuses) through the facade as the
    driver would run it (the main path: one update launch per step, one
    flash launch per self-attention per gradient or probe pass), held to
    TRAIN_GUARD like [train] (a breach is appended to ``failures``, with
    telemetry's conducive and gradient norms printed); the
    differentiable flash entry at each of the path's attention shapes;
    then one round on packed and on per_leaf from theta0 on one
    generator, bitwise; the MoE's aux loss finite at the final state;
    the blocks' device time in one forward at the train shape."""
    import numpy as np
    from repro_torch import models as TM
    from repro_torch import tree as tu
    from repro_torch.launch import train
    from repro_torch.models.model import ENCODER_FAMILIES
    fam = FAMILIES[arch]
    cfg = family_config(arch, fam["train"])
    if "train_encoder" in fam:
        cfg = dataclasses.replace(cfg, encoder_layers=fam["train_encoder"])
    n_attn = attn_layers(cfg)
    encoded = cfg.family in ENCODER_FAMILIES
    # the driver's flags; the encoder families' run reads all but --arch
    args = train.parse_args(
        ([] if encoded else ["--arch", arch]) + [
            "--step-size", repr(TRAIN_H), "--fit-steps", str(FAM_FIT),
            "--rounds", str(FAM_R), "--local-updates", str(FAM_T),
            "--batch", str(fam.get("batch", 8))])
    steps = FAM_R * FAM_T
    # gradient passes: the fit's, the sampling's, telemetry's probe (one
    # per round); forwards: the probes at theta0 and at the final state
    grads = TRAIN_S * FAM_FIT + steps + FAM_R
    run = _facade_run if encoded else _driver_run
    with FirstUpdateCheck() as chk:
        (tr, frame), _, counts, n_flash = _counted(
            f"train-{fam['tag']}", lambda: run(cfg, args),
            _expect("packed", steps),
            flash_expected(cfg, grads, 1 + args.chains))
    if chk.err is None:
        raise AssertionError(f"train-{fam['tag']}: no packed update was "
                             "held against its plain version")
    _finite_frame(f"train-{fam['tag']} telemetry", frame, FAM_R,
                  args.chains)
    P = sum(t.numel() for t in tu.leaves(tr.theta0))
    log(f"  {cfg.name}, {cfg.num_layers} layers ({n_attn} attending): {P} "
        f"parameters per chain, h {args.step_size:g}; fit {tr.fit_s:.2f} s,"
        f" sampling {tr.sample_s:.2f} s = {steps / tr.sample_s:.3f} "
        f"chain-steps/s; peak device memory fit {tr.peak_gb['fit']:.2f} GB,"
        f" sampling {tr.peak_gb['sampling']:.2f} GB; ll/token theta0 "
        f"{tr.ll0:.4f}, chains {[round(x, 4) for x in tr.lls]} "
        f"({card_line()})")
    log(f"  main path launches: fsgld_update_packed "
        f"{counts['fsgld_update_packed']} (1 per step), flash_attention "
        f"{n_flash} = {grad_attn_launches(cfg)} x {grads} gradient passes "
        f"({TRAIN_S} x {FAM_FIT} fit + {steps} sampling + {FAM_R} telemetry "
        f"probe) + {n_attn} x {1 + args.chains} probe forwards; first update"
        f" at this packed "
        f"layout ({len(tu.leaves(tr.theta0))} leaves) max|kernel-plain| "
        f"{chk.err:.3e} (tolerance {ATOL:g} + {RTOL:g}|x|)")
    for shape, causal, window in attn_shapes(cfg, args.batch, args.seq):
        check_flash_diff(dev, shape, window, causal)
    m = frame.metrics
    log("  telemetry per round: " + "; ".join(
        f"{n} {np.round(m[n][:, 0], 6).tolist()}"
        for n in ("conducive_norm", "grad_norm", "drift_norm")))
    if not (all(math.isfinite(x) for x in tr.lls)
            and min(tr.lls) >= tr.ll0 - TRAIN_GUARD):
        failures.append(f"train-{fam['tag']} diverged: ll/token {tr.lls} "
                        f"against {tr.ll0:.4f} at theta0 (guard "
                        f"{TRAIN_GUARD} nats, h {args.step_size:g})")
        log(f"  FAILED: {failures[-1]}")
    s = tr.sampler
    probe = tu.tree_map(lambda d: d[0][:args.batch], s.data)
    final = tu.tree_map(lambda t: t[0], tr.finals)
    if cfg.moe is not None:
        with torch.no_grad():
            aux = float(TM.forward(final, cfg, probe["tokens"])[1])
        if not math.isfinite(aux):
            raise AssertionError(f"train-{fam['tag']}: aux loss {aux}")
        log(f"  MoE load-balance aux loss at the final state, summed over "
            f"{cfg.num_layers} layer(s), on the probe batch: {aux:.6f}")
    block_ms(lambda: train.ll_per_token(final, cfg, probe),
             f"one forward of {args.batch} x {args.seq} tokens (no grad)")
    del final
    tr.finals = None
    outs, L = {}, len(tu.leaves(tr.theta0))
    for ex, expect in (("packed", {"fsgld_update_packed": CHECK_T,
                                   "fsgld_update_2d": 0}),
                       ("per_leaf", {"fsgld_update_packed": 0,
                                     "fsgld_update_2d": CHECK_T * L})):
        smp = _executor_copy(s, ex, dev)
        outs[ex], dt, _, _ = _counted(
            f"train-{fam['tag']} {ex}", lambda: smp.sample(
                train._generator(dev, args.seed, 3), tr.theta0, rounds=1),
            expect, flash_expected(cfg, CHECK_T))
        if ex == "packed":  # waits on the host while per_leaf runs
            outs[ex] = tu.tree_map(lambda t: t.cpu(), outs[ex])
        log(f"  one round of {CHECK_T} step(s) on {ex}: {dt:.2f} s; host "
            f"{host_gb():.2f} GB resident")
    same(f"train-{fam['tag']}: packed == per_leaf over one round",
         outs["packed"], outs["per_leaf"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 matmul/cudnn TF32 disabled (full float32 throughout)")
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import ENCODER_FAMILIES
    from repro_torch.workloads import (TABLE1_P, avg_loglik, mlp_log_lik,
                                       mlp_problem)
    dev = torch.device(DEVICE)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_seconds = {}
    _build.build(seconds=build_seconds)
    log(f"[build] nvcc {' '.join(_build.FLAGS)}, one process per source "
        f"({', '.join(_build.SOURCES)}), in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, seconds in build_seconds.items():
        log(f"  {name}: {seconds:.2f} s ({_build.SOURCES[name].name})")
    dry_root = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry_runs = start_dryruns(dry_root)
    log(f"[dryrun] {len(dry_runs)} fake-world traces started on the CPU "
        "(one process each), collected in the [dryrun] phase")

    gen = torch.Generator(device=dev).manual_seed(1234)
    t1_layout = kops.make_packed_layout(torch.zeros(TABLE1_P))
    mlp_gen = torch.Generator(device=dev).manual_seed(99)
    mlp_data, mlp_bank, mlp_theta0 = mlp_problem(mlp_gen, S=4, n=256,
                                                 din=64, hid=256, dout=32)
    mlp_layout = kops.make_packed_layout(mlp_theta0)
    phase("[kernels] kernel vs plain version on the card "
        f"(tolerance {ATOL:g} + {RTOL:g}|x|; bf16 leaf one bf16 ulp)")
    paper_packed, paper_leaf = paper_kernel_shapes()
    worst = check_kernels(gen, [("table1", t1_layout, T1_CHAINS),
                                ("mlp4", mlp_layout, 8)] + paper_packed,
                          [(T1_CHAINS, t1_layout.rows_total,
                            t1_layout.block_rows)] + paper_leaf)

    phase("[flash] flash-attention kernel vs plain version on the card "
        "(fp32 2e-5 + 2e-3|ref|, bf16 2^-6 (|ref| + rms of ref's row))")
    flash_worst = check_flash(gen)

    phase(f"[table1] Bayesian MLP, P={TABLE1_P}, {T1_S} x {T1_N} clients")
    shards, test, theta0, bank = table1_setup(dev)
    time_small_fit(dev, shards, theta0)

    def t1(executor):
        return t1_sampler(dev, shards, bank, executor)

    steps = T1_ROUNDS * T1_T
    seed = 20
    tr_p, main_counts = run_path(
        "table1/packed", t1("packed"),
        torch.Generator(device=dev).manual_seed(seed), theta0,
        {"fsgld_update_packed": steps, "fsgld_update_2d": 0})
    tr_l, leaf_counts = run_path(
        "table1/per_leaf", t1("per_leaf"),
        torch.Generator(device=dev).manual_seed(seed), theta0,
        {"fsgld_update_packed": 0, "fsgld_update_2d": steps})
    if not torch.equal(tr_p, tr_l):
        raise AssertionError("packed and per_leaf traces differ on one "
                             "generator")
    log("  packed == per_leaf, bitwise, on one generator")
    tr_v, _ = run_path(
        "table1/vmap (plain reference)", t1("vmap"),
        torch.Generator(device=dev).manual_seed(seed), theta0,
        {"fsgld_update_packed": 0, "fsgld_update_2d": 0})
    log(f"  held-out avg log-lik at theta0: "
        f"{avg_loglik(theta0[None], test):.4f}")
    heldout_check("packed vs vmap (plain reference)", tr_p, tr_v, test)

    phase("[mlp4] bench_chains multi-leaf MLP (24,864 params, 4 leaves), "
        "'scalar' bank, C=8, 3 rounds x 8 steps, packed")
    mlp = api.FSGLD(
        api.Posterior(mlp_log_lik, prior_precision=1.0), mlp_data,
        minibatch=16, step_size=1e-5,
        surrogate=api.SurrogateSpec(kind="scalar", bank=mlp_bank),
        schedule=api.Schedule(rounds=3, local_steps=8, n_chains=8, thin=8),
        execution=api.Execution(device=dev, executor="packed"))
    run_path("mlp4/packed", mlp, torch.Generator(device=dev).manual_seed(3),
             mlp_theta0, {"fsgld_update_packed": 24,
                          "fsgld_update_2d": 0})

    phase(f"[sghmc] Table-1 BNN, kernel='sghmc' (friction "
          f"{SGHMC_FRICTION}, h {SGHMC_H:g}), {T1_ROUNDS} rounds x {T1_T} "
          f"steps, C={T1_CHAINS}, on packed / per_leaf / vmap")
    phase_sghmc(dev, shards, test, theta0, bank)
    phase(f"[fed] Table-1 BNN under {', '.join(FED_SCENARIOS)}: "
          f"{FED_ROUNDS} rounds x {FED_T} steps, C={T1_CHAINS}")
    phase_fed(dev, shards, theta0, bank, tr_p)
    phase(f"[fald] Table-1 BNN, method='fald', {FED_ROUNDS} rounds x "
          f"{FED_T} steps, C={T1_CHAINS}, against the port's oracle")
    phase_fald(dev, shards, theta0)
    phase(f"[fig2-3] Gaussian of Figs. 2-3 (S=10 x 200, d=2), "
          f"{FIG_ROUNDS} single-step rounds (reduced from 30,000), "
          f"C={FIG_CHAINS}, packed")
    phase_fig2_3(dev)
    phase(f"[frontier] Gaussian d=64: dsgld/fsgld/fald x identity/"
          f"delayed-5x/elf-bidir-qsgd-8bit, {FRONTIER_ROUNDS} rounds "
          f"(reduced from 4,000), C={FRONTIER_CHAINS}, packed")
    phase_frontier(dev)
    phase("[linreg] App. F.1 linear regression: concrete / noise / "
          f"conductivity at full (n, d), dsgld and fsgld, 100 rounds x 40 "
          f"steps (uncut), C={PAPER_CHAINS} for the 3 repetitions, packed")
    phase_linreg(dev)
    phase(f"[metric] Fig. 5 metric learning at full size (20 classes, dim "
          f"32, 10 shards x 400 pairs), 100 rounds x 40 steps (uncut), "
          f"C={PAPER_CHAINS}, packed")
    phase_metric(dev)
    phase("[calib] bench_calibration.py: logistic regression (600 x 5, "
          "Fisher fit) and linear regression (600 x 5), C=1, packed, "
          "uncut")
    phase_calib(dev)
    phase(f"[kinds] 'linear' bank on the Figs. 2-3 Gaussian, {KINDS_ROUNDS}"
          " rounds x 100 steps (cut from 100 rounds); 'full' bank on f1's "
          "concrete, 100 rounds x 40 steps (uncut); both through 'auto' (-> "
          "vmap)")
    phase_kinds(dev)
    phase(f"[oracle] FederatedSampler.run_vmap(use_kernel=True) vs per_leaf "
          f"on Table 1, {ORACLE_ROUNDS} rounds x {T1_T} steps, "
          f"C={T1_CHAINS}")
    phase_oracle(dev, shards, theta0, bank)

    phase(f"[chaos] Table-1 BNN, {T1_ROUNDS} rounds x {T1_T} steps, "
          f"C={T1_CHAINS}, every step kept: quarantine, respawn, the "
          "detector and a NaN payload against the fault-free run, on packed"
          " and per_leaf")
    phase_chaos(dev, shards, theta0, bank)
    phase(f"[resume] Table-1 BNN, {RESUME_ROUNDS} rounds x {T1_T} steps, a "
          f"snapshot every {RESUME_EVERY}, packed, without a federation and "
          "under HARD_FED")
    in_scratch(phase_resume_t1, dev, shards, theta0, bank)
    phase(f"[telemetry] Table-1 BNN, {T1_ROUNDS} rounds x {T1_T} steps, "
          f"C={T1_CHAINS}, Telemetry(probe=True) on packed and per_leaf: "
          "bitwise off, the rows, log_every, the files, the cost")
    phase_telemetry(dev, shards, theta0, bank)
    phase(f"[stream] Table-1 BNN, {T1_S} clients, Stream(4, 1) and 2-round "
          f"windows, C={T1_CHAINS}, permutation, packed and per_leaf")
    phase_stream_t1(dev, shards, theta0, bank)

    phase(f"[mesh] the mesh path at one rank (NCCL): Table-1 packed and "
          f"FA-LD under elf-bidir-qsgd-8bit, C={T1_CHAINS}, on a (1, 1) "
          "DeviceMesh against the runs without it")
    mesh = phase_mesh(dev, shards, theta0, bank)

    phase("[profile] one packed Table-1 round (40 steps) under "
        "torch.profiler")
    prof_sampler = t1("packed")
    prof_gen = torch.Generator(device=dev).manual_seed(5)
    profile_call(lambda: prof_sampler.sample(prof_gen, theta0, rounds=1),
                 "round", T1_T)

    phase(f"[serve] qwen3-1.7b at full width through FSGLD.serve: K="
        f"{SERVE_K} draws, 2 requests of batch {SERVE_B} x prompt "
        f"{SERVE_S}, {SERVE_GEN} new tokens each; one more through "
        "Serving(mesh=) on [mesh]'s mesh")
    serve_launches = serve_qwen3(dev, mesh)
    phase("[serve] h2o-danube-1.8b at full width, 2 layers (sliding window)")
    serve_danube(dev)

    torch.cuda.empty_cache()
    phase(f"[train] qwen3-1.7b at full width and depth through "
          f"repro_torch.launch.train {' '.join(_train_argv())}: S="
          f"{TRAIN_S} clients, {TRAIN_FIT} fit steps, {TRAIN_R} rounds x "
          f"{TRAIN_T} steps, C=1, packed")
    failures = []
    phase_train(dev, failures)
    torch.cuda.empty_cache()
    phase(f"[train-c2] qwen3-1.7b at full width, {C2_LAYERS} of 28 layers, "
          f"C={C2_CHAINS}, packed")
    phase_train_c2(dev)
    check_flash_diff(dev)
    torch.cuda.empty_cache()
    phase(f"[stream] qwen3-1.7b at full width, {C2_LAYERS} of 28 layers, "
          f"through repro_torch.launch.train --method dsgld --clients "
          f"{STREAM_CLIENTS} --resident 4 --step-size {STREAM_H:g}: C=1, "
          f"{TRAIN_R} rounds x {TRAIN_T} steps, packed")
    phase_stream_qwen3(dev)
    torch.cuda.empty_cache()
    phase(f"[stream] the train driver at {C2_LAYERS} of 28 layers, "
          f"C={C2_CHAINS}, --num-shards {STREAM_C2_SHARDS} --fit-steps "
          f"{FAM_FIT} --resident 2 against the resident run")
    phase_stream_c2(dev)
    torch.cuda.empty_cache()
    phase(f"[resume] qwen3-1.7b at full width, {C2_LAYERS} of 28 layers, "
          f"C={C2_RESUME_CHAINS}, collect=False, {C2_RESUME_ROUNDS} rounds x "
          f"2 steps, a snapshot every {C2_RESUME_EVERY}")
    in_scratch(phase_resume_c2, dev)
    torch.cuda.empty_cache()
    phase(f"[bank] repro_torch.launch.train at full width, {BANK_LAYERS} "
          f"of 28 layers, {BANK_ROUNDS} rounds, --draw-bank --bank-every "
          f"{BANK_EVERY} -> launch.serve --bank --log-jsonl; refresh")
    in_scratch(phase_bank, dev)
    torch.cuda.empty_cache()

    for arch, fam in FAMILIES.items():
        layers, K, B, S = fam["serve"]
        phase(f"[serve-{fam['tag']}] {arch} at full width, "
              f"{'all' if layers is None else layers} layers, through "
              f"FSGLD.serve: K={K} draws, one request of batch {B} x prompt "
              f"{S}, {SERVE_GEN} new tokens")
        serve_family(dev, arch)
        torch.cuda.empty_cache()
    for arch, fam in FAMILIES.items():
        if fam["train"] is None:
            continue
        encoded = family_config(arch, None).family in ENCODER_FAMILIES
        phase(f"[train-{fam['tag']}] {arch} at full width, {fam['train']} "
              f"layers"
              + (f" and {fam['train_encoder']} encoder layers"
                 if "train_encoder" in fam else "") + ", through "
              + ("api.FSGLD with enc_embeds in the shards (the driver's "
                 "run)" if encoded else "repro_torch.launch.train")
              + f": S={TRAIN_S} clients, {FAM_FIT} fit steps, {FAM_R} "
              f"rounds x {FAM_T} steps, C=1, packed, h {TRAIN_H:g}")
        train_family(dev, arch, failures)
        torch.cuda.empty_cache()
        if fam["tag"] == "rwkv":
            remat_check(dev, arch, fam["train"])
            torch.cuda.empty_cache()

    phase(f"[dryrun] qwen3-1.7b at full width and depth through "
          f"launch.steps: {DRY_STEPS} train steps at ({DRY_B}, {DRY_S}) fed "
          f"by FederatedPipeline over {DRY_CLIENTS} clients, held against "
          "the dry run's prediction; prefill and serve steps; the pod "
          f"grid's {', '.join('|'.join(c) for c in DRY_GRID)}")
    try:
        phase_dryrun(dev, dry_runs)
    finally:
        for _, proc, _ in dry_runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(dry_root, ignore_errors=True)
    torch.cuda.empty_cache()

    phase("[times] device time per launch: CUDA graphs of back-to-back "
        "launches replayed 20 times between CUDA events (median)")
    floor = launch_floor_ms()
    log(f"  launch floor: an empty kernel takes {floor:.7f} ms per launch "
        "in a CUDA graph (torch.cuda._sleep(0), 200 launches) on "
        f"{card_line()}")
    big = kops.make_packed_layout(torch.zeros(2**24))
    times = time_kernels(gen, [
        ("table1/packed", "fsgld_update_packed", t1_layout, T1_CHAINS, 20),
        ("table1/per_leaf", "fsgld_update_2d", t1_layout, T1_CHAINS, 20),
        ("mlp4/packed", "fsgld_update_packed", mlp_layout, 8, 20),
        ("large/packed C*P=2^27", "fsgld_update_packed", big, 8, 1),
        ("large/per_leaf C*P=2^27", "fsgld_update_2d", big, 8, 1)])
    log("  no single PyTorch call computes this update, so there is no "
        "library time (library_ms null)")
    flash_times = time_flash(gen)

    src = "src/repro_torch/kernels/csrc/fsgld_update.cu"
    rows = []
    for entry, line, shape, launches in (
            ("fsgld_update_packed", 273, "table1/packed",
             main_counts["fsgld_update_packed"]),
            ("fsgld_update_2d", 189, "table1/per_leaf",
             leaf_counts["fsgld_update_2d"])):
        ms, plain_ms, b_ms, b_by, _ = times[shape]
        least = max(b_ms, floor)
        log(f"  {shape}: bytes bound {b_ms:.7f} ms, launch floor "
            f"{floor:.7f} ms: the least time at this shape {least:.7f} ms "
            f"({'the launch floor' if floor > b_ms else b_by}); the kernel "
            f"{ms:.7f} ms is {100 * least / ms:.1f}% of it")
        rows.append({"name": entry, "route": "cuda", "source": src,
                     "replaces": f"src/repro/kernels/fsgld_update.py:{line}",
                     "launches": launches, "max_abs_err": worst[entry],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    ms, plain_ms, sdpa_ms, b_ms, b_by = flash_times["path"]
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:88",
                 "launches": serve_launches, "max_abs_err": flash_worst,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": sdpa_ms})
    log(f"[end] {time.perf_counter() - _PHASE_START[-1]:.1f} s since the "
        "last header")
    if failures:
        raise AssertionError("; ".join(failures))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
