"""Time the fused update kernel beside other builds of it.

    python3 tools/update_ladder.py [--baseline OTHER_SOURCE.cu]
                                   [--experiments [NAME ...]] [--rounds N]

Needs one CUDA card and nvcc. Builds ``csrc/fsgld_update.cu`` as it is
and, with ``--baseline``, another version of the same source (an earlier
commit's, say: ``git show HEAD:src/repro_torch/kernels/csrc/fsgld_update.cu
> build/old.cu``), all in parallel with ptxas's resource report; the C
interfaces must agree. ``--experiments`` adds the builds of the named
``EXPERIMENTS`` (all when none is named): design alternatives, whose
outputs must equal the build
as it is bitwise, and what-if builds that break the result on purpose and
are timed only (where the time of a small launch goes).

At each shape of ``_cases`` (Table 1 packed and per-leaf at C = 4, the
multi-leaf MLP at C = 8, C*P = 2^27 packed and per-leaf at C = 8,
qwen3-1.7b's 2.03e9 parameters at C = 1), for every variant x dynamics,
the build as it is runs out of place through the library's C entry and
is held against the plain version within chip_smoke's tolerance (not at
qwen3's size, where the plain version's temporaries do not fit beside
the operands), in place against its own out-of-place result bitwise, and
against the baseline's and each design experiment's outputs bitwise: the
count of elements that differ is printed (0 expected) with the largest
difference and its share of the tolerance. Then, in ``--rounds`` rounds of
alternating order, every build is timed at each shape's own variant
('diag', 'scalar' at qwen3) and Langevin with chip_smoke's ``device_ms``
(CUDA-graph replay): the packed entry's shapes in place, as the packed
executor runs them, the per-leaf ones into a preallocated output; once
with updates back to back, and once with each update after the kernel
that precedes it on the engine's path (the copy that packs the step's
gradient into g), where a build's gain must show to count. The build as
it is is timed twice per round under two names (``as_is``,
``as_is_again``: the spread of identical builds). Prints the card, the
launch floor (an empty kernel in a CUDA graph), per shape, mode and
build the median device ms, back to back its share of the least time
(the larger of the bytes bound and the launch floor, as chip_smoke's
``[times]``), and the median over rounds of its time over ``as_is``'s. Exits non-zero when the build
as it is fails a check or a design experiment differs from it.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from flash_planted_faults import plant  # noqa: E402

_GRID = ("  fsgld_update_kernel<V, HMC><<<(unsigned)items, threads, 0, "
         "stream>>>(a, p);\n")
_HEAD = "  const size_t chain_elems = (size_t)p.nvec * VEC;\n"
_THREADS = "  while (threads > MIN_THREADS\n"
_NOISE = ("  const float rad = sqrtf(-2.0f * logf(u1));\n"
          "  return rad * cosf(6.28318530717958647692f * u2);\n")
_ITEM = ("  Step<V, HMC> s;\n"
         "  if (!open_item(a, p, blockIdx.x, s)) return;  // one CTA per item\n")
_LAST = "           (uint32_t)__ldg(a.seeds + cl), s);\n  }\n}\n"

# --experiments: name -> (what it changes, whether its outputs must equal
# the build as it is, [(source text, its replacement), ...])
EXPERIMENTS = {
    "no_walk": (
        "every chain is a group of its own: no thread walks chains, and a "
        "tile's chains run as neighbouring items (the shared rows from L2)",
        True, [("  groups = groups < chains ? groups : chains;",
                "  groups = chains;")]),
    "walk_all": (
        "one group holds every chain at every size: a small launch's "
        "threads walk its chains one after another",
        True, [("  groups = groups < chains ? groups : chains;",
                "  groups = 1;")]),
    "threads_256": (
        "256 threads per CTA at every size: Table 1 on 4 CTAs",
        True, [(_THREADS, "  while (false && threads > MIN_THREADS\n")]),
    "persistent": (
        "a persistent grid: as many CTAs as fit on the SMs at once, each "
        "walking items blockIdx.x, + gridDim.x, ...",
        True, [("  uint32_t nvec;   // float4 vectors per chain\n",
                "  uint32_t nvec;   // float4 vectors per chain\n"
                "  uint32_t items;\n"),
               ("  const int64_t items = tiles * p.groups;\n",
                "  const int64_t items = tiles * p.groups;\n"
                "  p.items = (uint32_t)items;\n"),
               (_GRID, "  fsgld_update_kernel<V, HMC><<<(unsigned)(items < "
                "slots ? items : slots), threads, 0, stream>>>(a, p);\n"),
               (_ITEM, "  for (uint32_t w = blockIdx.x; w < p.items; "
                "w += gridDim.x) {\n  Step<V, HMC> s;\n"
                "  if (!open_item(a, p, w, s)) continue;\n"),
               (_LAST, _LAST + "}\n")]),
    "divide": (
        "the segment's block and the item's tile by 32-bit division in "
        "every item, with no shift and no shortcut for one group",
        True, [("  const uint32_t tile = p.groups == 1 ? w : w / "
                "(uint32_t)p.groups;", "  const uint32_t tile = w / "
                "(uint32_t)p.groups;"),
               ("p.br_shift >= 0 ? row >> p.br_shift\n"
                "                                     : row / "
                "(uint32_t)a.block_rows;", "row / (uint32_t)a.block_rows;")]),
    "pdl": (
        "programmatic dependent launch: cudaLaunchKernelEx with programmatic "
        "stream serialization, griddepcontrol.wait before any read and "
        "launch_dependents at once",
        True, [(_HEAD, '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
                '  asm volatile("griddepcontrol.launch_dependents;");\n'
                + _HEAD),
               (_GRID + "  return (int)cudaGetLastError();\n",
                "  cudaLaunchConfig_t cfg = {};\n"
                "  cfg.gridDim = dim3((unsigned)items);\n"
                "  cfg.blockDim = dim3(threads);\n"
                "  cfg.stream = stream;\n"
                "  cudaLaunchAttribute attr[1];\n"
                "  attr[0].id = "
                "cudaLaunchAttributeProgrammaticStreamSerialization;\n"
                "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
                "  cfg.attrs = attr;\n"
                "  cfg.numAttrs = 1;\n"
                "  return (int)cudaLaunchKernelEx(&cfg, "
                "fsgld_update_kernel<V, HMC>, a, p);\n")]),
    "streaming_loads": (
        "every stream loaded with the evict-first hint (ld.global.cs)",
        True, [("  return __ldg(reinterpret_cast<const float4*>(p));",
                "  return __ldcs(reinterpret_cast<const float4*>(p));"),
               ("  return *reinterpret_cast<const float4*>(p);",
                "  return __ldcs(reinterpret_cast<const float4*>(p));")]),
    "streaming_stores": (
        "theta' and r' stored with the evict-first hint (st.global.cs)",
        True, [("  *reinterpret_cast<float4*>(a.theta_out + off) = out4;",
                "  __stcs(reinterpret_cast<float4*>(a.theta_out + off), "
                "out4);"),
               ("  if (HMC) *reinterpret_cast<float4*>(a.r_out + off) = "
                "rout4;",
                "  if (HMC) __stcs(reinterpret_cast<float4*>(a.r_out + off), "
                "rout4);")]),
    "no_box_muller": (
        "the normal is u1 - u2: the hash and the uniforms stay, the "
        "logf / sqrtf / cosf go",
        False, [(_NOISE, "  return u1 - u2;\n")]),
    "no_noise": (
        "the normal is 0: no hash, no transcendental",
        False, [(_NOISE, "  return 0.0f;\n")]),
    "launch_only": (
        "every CTA returns at once: the launch of this grid and nothing "
        "else",
        False, [(_HEAD, "  if (p.nvec) return;\n" + _HEAD)]),
    "launch_only_256": (
        "launch_only at 256 threads per CTA (Table 1 on 4 CTAs)",
        False, [(_HEAD, "  if (p.nvec) return;\n" + _HEAD),
                (_THREADS, "  while (false && threads > MIN_THREADS\n")]),
}


@dataclasses.dataclass
class Case:
    """One timed shape: the chain-major buffer's segment table as the
    entry launches it."""
    name: str
    entry: str          # "packed" (in place) or "per_leaf" (new buffers)
    chains: int
    rows_total: int     # rows per chain
    block_rows: int
    num_leaves: int
    n_live: int         # parameters per chain, pad excluded
    variant: str        # the variant timed
    calls: int          # launches per CUDA graph
    replays: int
    big: bool = False   # no plain version, no out-of-place builds beside
    tables: tuple = ()  # (seg_leaf, seg_base) int32 on the card


def _cases(dev) -> list[Case]:
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.kernels import fsgld_update as fk
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import param_layout
    from repro_torch.workloads import TABLE1_P
    t1 = kops.make_packed_layout(torch.zeros(TABLE1_P))
    # bench_chains' multi-leaf MLP (workloads.mlp_problem)
    mlp = kops.make_packed_layout({
        "w1": torch.zeros(64, 256), "b1": torch.zeros(256),
        "w2": torch.zeros(256, 32), "b2": torch.zeros(32)})
    big = kops.make_packed_layout(torch.zeros(2**24))
    qwen3 = kops.make_packed_layout(tu.tree_map(
        lambda leaf: torch.empty(leaf.shape, device="meta"),
        param_layout(get_config("qwen3-1.7b"))))

    def packed(name, layout, C, variant, calls, replays, big=False):
        return Case(name, "packed", C, layout.rows_total, layout.block_rows,
                    layout.num_leaves, sum(layout.sizes), variant, calls,
                    replays, big, layout.tables(dev))

    def per_leaf(name, layout, C, calls, replays):
        # one leaf, its rows in blocks of the packed layout's rows, as the
        # per-leaf executor pads it
        br, rows = layout.block_rows, layout.rows_total
        return Case(name, "per_leaf", C, rows, br, 1, sum(layout.sizes),
                    "diag", calls, replays, False,
                    fk._one_leaf_tables(dev, rows // br, br))

    return [packed("table1 packed", t1, cs.T1_CHAINS, "diag", 20, 20),
            per_leaf("table1 per_leaf", t1, cs.T1_CHAINS, 20, 20),
            packed("mlp packed", mlp, 8, "diag", 20, 20),
            packed("2^27 packed", big, 8, "diag", 5, 5),
            per_leaf("2^27 per_leaf", big, 8, 5, 5),
            packed("qwen3 packed", qwen3, 1, "scalar", 5, 5, big=True)]


def operands(gen, case, variant, dynamics):
    """The streams of one launch, made in place (no full-size temporaries:
    qwen3's 'diag' SGHMC holds seven 8.1 GB streams)."""
    dev = gen.device
    rows, shared = case.chains * case.rows_total, case.rows_total

    def rn(n):
        return torch.empty(n, 128, device=dev).normal_(generator=gen)

    ops = {"theta": rn(rows), "g": rn(rows).mul_(50)}
    if variant != "plain":
        ops.update(mu_g=rn(shared), mu_s=rn(rows))
    if variant == "diag":
        ops.update(lam_g=rn(shared).abs_().add_(0.1),
                   lam_s=rn(rows).abs_().add_(0.1))
    if dynamics == "sghmc":
        ops["r"] = rn(rows)
    L = case.num_leaves
    ops["seeds"] = torch.randint(0, 2**31 - 1, (case.chains, L),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
    ops["scalars"] = torch.empty(case.chains, L, 9, device=dev).normal_(
        generator=gen).abs_().mul_(0.1).add_(0.05)
    return ops


def launch(lib, case, variant, dynamics, ops, out=None, r_out=None):
    """One launch of ``lib`` through its C entry, writing ``out`` and
    ``r_out`` (the operands themselves when None: in place)."""
    from repro_torch.kernels import fsgld_update as fk
    p = fk._ptr
    out = ops["theta"] if out is None else out
    if dynamics == "sghmc" and r_out is None:
        r_out = ops["r"]
    sl, sb = case.tables
    err = lib.fsgld_update_launch(
        fk.VARIANTS.index(variant), int(dynamics == "sghmc"),
        p(ops["theta"]), p(ops.get("r")), p(ops["g"]), p(ops.get("mu_g")),
        p(ops.get("mu_s")), p(ops.get("lam_g")), p(ops.get("lam_s")),
        p(sl, 4), p(sb, 4), p(ops["seeds"], 4), p(ops["scalars"], 4),
        p(out), p(r_out), ops["theta"].shape[0], case.rows_total,
        case.block_rows, case.num_leaves,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"launch failed: cudaError {err} "
                           f"({lib.fsgld_update_error_string(err).decode()})")


def plain(case, variant, dynamics, ops):
    from repro_torch.kernels import fsgld_update as fk
    sur = {k: ops.get(k) for k in ("mu_g", "mu_s", "lam_g", "lam_s")}
    kw = dict(variant=variant, dynamics=dynamics, chains=case.chains,
              r2d=ops.get("r"), **sur)
    if case.entry == "packed":
        sl, sb = case.tables
        return cs._first(fk.fsgld_update_packed_plain(
            ops["theta"], ops["g"], ops["seeds"], ops["scalars"],
            seg_leaf=sl, seg_base=sb, block_rows=case.block_rows, **kw))
    return cs._first(fk.fsgld_update_2d_plain(
        ops["theta"], ops["g"], ops["seeds"][:, 0], ops["scalars"][:, 0],
        seg_base=case.tables[1], block_rows=case.block_rows, **kw))


def compare(a, b):
    """(elements that differ, largest |a - b|, its largest share of the
    tolerance against b) over chunks of rows."""
    n, worst, share = 0, 0.0, 0.0
    for x, y in zip(a, b):
        for r0 in range(0, x.shape[0], 1 << 19):
            xs, ys = x[r0:r0 + (1 << 19)], y[r0:r0 + (1 << 19)]
            ne = xs != ys
            if bool(ne.any()):
                d = (xs - ys).abs()
                n += int(ne.sum())
                worst = max(worst, float(d.max()))
                share = max(share, float((d / (cs.ATOL + cs.RTOL * ys.abs())
                                          ).max()))
    return n, worst, share


def finite(t) -> bool:
    return all(bool(torch.isfinite(t[r0:r0 + (1 << 19)]).all())
               for r0 in range(0, t.shape[0], 1 << 19))


def check(libs, case, gen, exact) -> bool:
    """Every variant x dynamics at ``case``: the build as it is against the
    plain version, in place against out of place, and the baseline and
    the ``exact`` experiments against it bitwise."""
    from repro_torch.kernels import fsgld_update as fk
    ok = True
    others = (["baseline"] if "baseline" in libs else []) + \
        ([] if case.big else exact)
    for variant in fk.VARIANTS:
        for dynamics in fk.DYNAMICS:
            ops = operands(gen, case, variant, dynamics)
            hmc = dynamics == "sghmc"
            outs = [torch.empty_like(ops["theta"])]
            if hmc:
                outs.append(torch.empty_like(ops["r"]))
            launch(libs["as_is"], case, variant, dynamics, ops, *outs)
            ok = ok and all(finite(o) for o in outs)
            words = []
            if not case.big:
                ref = plain(case, variant, dynamics, ops)
                _, d, share = compare(outs, ref)
                ok = ok and share <= 1
                words.append(f"plain: max |diff| {d:.3e}, {share:.3f} of "
                             "the tolerance")
                del ref
            for name in others:
                if case.big:  # room for one more output: the baseline in place
                    launch(libs[name], case, variant, dynamics, ops)
                    got = [ops["theta"]] + ([ops["r"]] if hmc else [])
                else:
                    got = [torch.empty_like(o) for o in outs]
                    launch(libs[name], case, variant, dynamics, ops, *got)
                n, d, share = compare(got, outs)
                ok = ok and (n == 0 or name == "baseline")
                words.append(f"{name}: {n} elements differ"
                             + (f" (max |diff| {d:.3e}, {share:.3f} of the "
                                "tolerance)" if n else ""))
                del got
            if not case.big:
                launch(libs["as_is"], case, variant, dynamics, ops)
                n, _, _ = compare([ops["theta"]] + ([ops["r"]] if hmc
                                                    else []), outs)
                ok = ok and n == 0
                words.append(f"in place: {n} elements differ")
            cs.cuda_sync()
            cs.log(f"[check] {case.name} {variant}/{dynamics}: "
                   + "; ".join(words))
            del ops, outs
            torch.cuda.empty_cache()
    return ok


def time_case(builds, case, gen, rounds):
    """{(build, mode): [device ms per round]} at ``case``'s variant,
    Langevin, in two modes: ``back to back`` (the graph holds only updates)
    and ``after the g pack`` (each update follows the kernel that precedes
    it on the engine's path: ``PackedChains.pack``'s copy of the step's
    gradient into g, a PyTorch kernel). ``("pack", "alone")`` times that
    copy by itself."""
    ops = operands(gen, case, case.variant, "langevin")
    out = None if case.entry == "packed" else torch.empty_like(ops["theta"])
    g_live = ops["g"].view(case.chains, -1)[:, :case.n_live]
    g_src = g_live.clone()

    def pack():
        g_live.copy_(g_src)

    def step(lib, packs):
        def fn():
            if packs:
                pack()
            launch(lib, case, case.variant, "langevin", ops, out)
        return fn

    runs = {(b, mode): step(lib, mode != "back to back")
            for mode in ("back to back", "after the g pack")
            for b, lib in builds.items()}
    runs["pack", "alone"] = pack
    order = list(runs)
    times = {k: [] for k in order}
    for r in range(rounds):
        for k in order if r % 2 == 0 else order[::-1]:
            times[k].append(cs.device_ms(runs[k], calls=case.calls,
                                         replays=case.replays))
    del ops, out, g_src
    torch.cuda.empty_cache()
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--experiments", nargs="*", default=None,
                    choices=list(EXPERIMENTS), metavar="NAME",
                    help="also build and time these EXPERIMENTS (all of "
                    "them when none is named)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_ladder: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    cs.log(cs.card_line())
    src = _build.SOURCES["fsgld_update"]
    srcs = {"as_is": src}
    tmp = Path(tempfile.mkdtemp(prefix="update_ladder_"))
    if args.baseline is not None:
        srcs["baseline"] = args.baseline.resolve()
    if args.experiments is not None:
        text = src.read_text()
        for name in args.experiments or EXPERIMENTS:
            what, exact, edits = EXPERIMENTS[name]
            srcs[name] = tmp / f"{name}.cu"
            srcs[name].write_text(plant(text, name, edits))
            cs.log(f"[experiment] {name} ({'exact' if exact else 'timed only'}"
                   f"): {what}")
    runs = _build.compile_all({n: (s, tmp / f"{n}.so", ("-Xptxas", "-v"))
                               for n, s in srcs.items()})
    libs = {}
    for n, (proc, took) in runs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {n}:\n{proc.stdout}")
        cs.log(f"[build] {n}: {took:.2f} s ({srcs[n]})")
        if n in ("as_is", "baseline"):
            for line in proc.stdout.splitlines():
                if "entry function" in line:
                    kernel = line.split("'")[1]
                elif "registers" in line:
                    cs.log(f"    {kernel}: {line.split(':', 1)[1].strip()}")
        libs[n] = _build.open_library(tmp / f"{n}.so", "fsgld_update")
    exact = [n for n, (_, e, _) in EXPERIMENTS.items() if e and n in libs]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = _cases(dev)
    ok = all([check(libs, case, gen, exact) for case in cases])

    floors = [cs.launch_floor_ms() for _ in range(3)]
    floor = statistics.median(floors)
    cs.log(f"[floor] an empty kernel in a CUDA graph: {floor:.7f} ms per "
           f"launch (median of {', '.join(f'{f:.7f}' for f in floors)})")
    builds = {"as_is": libs["as_is"], "as_is_again": libs["as_is"]}
    builds.update((n, lib) for n, lib in libs.items() if n != "as_is")
    for case in cases:
        times = time_case(builds, case, gen, args.rounds)
        b_ms, b_by, nbytes = cs.bound_ms(case.variant, "langevin",
                                         case.chains, case.n_live,
                                         case.num_leaves)
        least = max(b_ms, floor)
        cs.log(f"[time] {case.name} ({case.entry}, {case.variant}/langevin,"
               f" C={case.chains}, {case.rows_total} rows per chain, "
               f"{case.n_live} live): bound {b_ms:.7f} ms ({b_by}, {nbytes} "
               f"bytes), least time {least:.7f} ms ("
               f"{'the launch floor' if floor > b_ms else b_by}); "
               f"{args.rounds} rounds")
        pack_ts = times.pop(("pack", "alone"))
        cs.log(f"  the g pack alone {statistics.median(pack_ts):9.5f} ms (rounds "
               f"{', '.join(f'{t:.5f}' for t in pack_ts)})")
        for (b, mode), ts in times.items():
            ms = statistics.median(ts)
            base = times["as_is", mode]
            rel = statistics.median(t / a for t, a in zip(ts, base))
            share = (f"{100 * least / ms:5.1f}% of the least time" if
                     mode == "back to back" else "pack + update")
            cs.log(f"  {mode:16s} {b:14s} {ms:9.5f} ms  {share}  x{rel:.4f} "
                   f"of as_is  (rounds {', '.join(f'{t:.5f}' for t in ts)})")
    cs.log(f"[end] {'every check held' if ok else 'A CHECK FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
