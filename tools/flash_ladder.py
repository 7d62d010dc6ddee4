"""Time the bf16 flash-attention kernel beside other builds of it and SDPA.

    python3 tools/flash_ladder.py [--baseline OTHER_SOURCE.cu]
                                  [--experiments] [--rounds N]

Needs one CUDA card and nvcc. Builds ``csrc/flash_attention.cu`` as it
is and, with ``--baseline``, another version of the same source (an
earlier commit's, say), all in parallel and with ptxas's resource
report. Each build is held against the plain version at the serving
path's shape and at a few tile edges, within the kernel's tolerance.
Then every build and SDPA are timed with chip_smoke's ``device_ms``
(CUDA-graph replay) at each shape of ``SHAPES``, in ``--rounds`` rounds
of alternating order; the kernel as it is is timed twice per round
under two names (``as_is``, ``as_is_again``), so that the spread between
identical builds stands beside every other difference. Prints the card,
each build's seconds, registers and spills, and per shape and build the
median device ms, TFLOP/s, the share of the operations bound, and the
median over rounds of its time over ``as_is``'s. Exits non-zero when a
build fails its check. ``--experiments`` adds the what-if builds of
``EXPERIMENTS``, which break the result on purpose and are timed only.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from flash_planted_faults import build_and_report, plant  # noqa: E402

# --experiments: what-if builds that break the kernel's result on purpose,
# timed only, to show where its time goes: name -> (what it changes,
# [(source text, its replacement), ...])
EXPERIMENTS = {
    "no_softmax": (
        "softmax_tile returns at once: P = the raw scores, O never rescaled",
        [("                                             float& c1) {\n",
          "                                             float& c1) {\n"
          "  c0 = c1 = 1.f;\n  return;\n")]),
    "no_mma": (
        "no wgmma is issued: the softmax, the loads and the barriers alone",
        [("    wgmma_ss(sc, sw128_desc(q_lo,",
          "    if (kk < 0) wgmma_ss(sc, sw128_desc(q_lo,"),
         ("    wgmma_rs(o, pf[kk], sw128_desc(v_lo,",
          "    if (kk < 0) wgmma_rs(o, pf[kk], sw128_desc(v_lo,")]),
    "no_loads": (
        "past the first STAGES key tiles (of a causal row without window) "
        "the producer arrives on the full barriers without loading: the "
        "consumers reread stale K and V",
        [("  mbar_expect_tx(bar, BK * HD * 2);\n",
          "  if (k0 >= STAGES * BK) {\n    mbar_arrive(bar);\n    return;\n"
          "  }\n  mbar_expect_tx(bar, BK * HD * 2);\n")]),
    "no_exp": (
        "ex2 returns its argument: no MUFU work in the softmax",
        [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n',
          "  y = x;\n")]),
    "libm_exp": (
        "ex2 is CUDA's exp2f (subnormal results kept), as in the mma.sync "
        "kernel before this one",
        [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n',
          "  y = exp2f(x);\n")]),
    "one_work_per_cta": (
        "one CTA per work tile (no persistence: each CTA loads Q, runs its "
        "tiles and stores O alone, and the hardware deals CTAs to SMs as "
        "they free up)",
        [("  const int ctas = n_work < sms ? n_work : sms;",
          "  const int ctas = n_work;")]),
    "q_fastest": (
        "works run the q tiles fastest, heavy to light within each head",
        [("  const int bh = w % (p.B * p.H), n_q = (p.S + BQ - 1) / BQ;\n"
          "  *q0 = (n_q - 1 - w / (p.B * p.H)) * BQ;",
          "  const int n_q = (p.S + BQ - 1) / BQ, bh = w / n_q;\n"
          "  *q0 = (n_q - 1 - w % n_q) * BQ;")]),
    "stages3": (
        "3 K and 3 V stages and one Q slot (hd <= 128 only: hd 256 no "
        "longer fits)",
        [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
         ("static constexpr int Q_SLOTS = HD <= 128 ? 2 : 1;",
          "static constexpr int Q_SLOTS = 1;")]),
}
# (B, S, H, Hkv, hd, causal, window) cells each build must pass first
EDGES = [(2, 129, 4, 2, 128, True, None), (2, 1000, 4, 1, 80, True, 300),
         (2, 2048, 4, 2, 256, False, None), (1, 127, 8, 1, 64, True, 100)]
# name -> ((B, S, H, Hkv, hd), launches per graph, replays); causal, bf16.
# Work tiles (128 query rows of one head) per SM of an H100's 132: 7.8,
# 15.5, 31.0 and 31.0.
SHAPES = {"path": (cs.FLASH_PATH, 20, 20),
          "S4096": ((4, 4096, 16, 8, 128), 10, 10),
          "S8192": ((4, 8192, 16, 8, 128), 3, 5),
          "long": (cs.FLASH_LONG, 1, 5)}


def check(lib, gen) -> float:
    """The largest share of the tolerance over the path's shape and EDGES."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.load = lambda name: lib
    worst = 0.0
    for B, S, H, Hkv, hd, causal, window in [
            cs.FLASH_PATH + (True, None)] + EDGES:
        q, k, v = cs._qkv(gen, B, S, H, Hkv, hd, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                       window=window)
        cs.cuda_sync()
        worst = max(worst, cs.flash_err(out, ref)[1])
    return worst


def time_shape(libs, gen, shape, calls, replays, rounds):
    """{name: [device ms per round]} of every library and SDPA at
    ``shape``, the order reversed every other round; ``as_is`` is also
    timed as ``as_is_again``."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    q, k, v = cs._qkv(gen, *shape, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    order = [*libs, "as_is_again", "SDPA"]
    times = {n: [] for n in order}
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            if name == "SDPA":
                def fn():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True,  # noqa: B023
                        enable_gqa=True)
            else:
                lib = libs["as_is" if name == "as_is_again" else name]
                _build.load = lambda n, lib=lib: lib

                def fn():
                    return fa.flash_attention(q, k, v)  # noqa: B023
            times[name].append(cs.device_ms(fn, calls=calls,
                                            replays=replays))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="another flash_attention.cu to time beside")
    ap.add_argument("--experiments", action="store_true",
                    help="also time the what-if builds of EXPERIMENTS")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timing rounds per shape (default 3)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ladder: no CUDA device", file=sys.stderr)
        return 2
    cs.log(cs.card_line())
    from repro_torch.kernels import _build
    src = _build.SOURCES["flash_attention"]
    sources = {"as_is": (src, ())}
    if args.baseline:
        sources["baseline"] = (args.baseline.resolve(), ())
    gen = torch.Generator(device="cuda").manual_seed(7)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        if args.experiments:
            text = src.read_text()
            for name, (what, edits) in EXPERIMENTS.items():
                planted = Path(tmp) / f"{name}.cu"
                planted.write_text(plant(text, name, edits))
                sources[name] = (planted, ())
                cs.log(f"[experiment] {name}: {what}")
        cs.log("[build]")
        paths, _ = build_and_report(sources, Path(tmp),
                                    report={"as_is", "baseline"})
        libs = {n: _build.open_library(p, "flash_attention")
                for n, p in paths.items()}
        for name, lib in libs.items():
            if name in EXPERIMENTS:
                continue  # wrong on purpose
            use = check(lib, gen)
            ok = ok and use <= 1
            what = "the source as it is" if name == "as_is" \
                else str(args.baseline)
            cs.log(f"[check] {name} ({what}): {100 * use:.1f}% of the "
                   "tolerance at most")
        for shape_name, (shape, calls, replays) in SHAPES.items():
            times = time_shape(libs, gen, shape, calls, replays,
                               args.rounds)
            b_ms, _, _, flops = cs.flash_bound_ms(*shape, 2)
            for name, ts in times.items():
                ms = statistics.median(ts)
                ratio = statistics.median(
                    t / a for t, a in zip(ts, times["as_is"]))
                cs.log(f"[time] {shape_name} {shape}: {name:16s} "
                       f"{ms:.4f} ms, x{ratio:.4f} of as_is "
                       f"({', '.join(f'{t:.4f}' for t in ts)}), "
                       f"{flops / ms / 1e9:.1f} TFLOP/s, "
                       f"{100 * b_ms / ms:.1f}% of the {b_ms:.4f} ms bound")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
