"""Time the fused update kernel beside another build of it.

    python3 tools/update_ladder.py [--baseline OTHER_SOURCE.cu] [--rounds N]

Needs one CUDA card and nvcc. Builds ``csrc/fsgld_update.cu`` as it is
and, with ``--baseline``, another version of the same source (an earlier
commit's, say: ``git show REV:src/repro_torch/kernels/csrc/fsgld_update.cu
> build/old.cu``), in parallel; the C interfaces must agree. Each build is
held against the plain version on a ragged three-leaf layout (every
variant, out of place; the build as it is in place through the wrapper,
every variant and dynamics).
Then, in ``--rounds`` rounds of alternating order, every build is timed
out of place with chip_smoke's ``device_ms`` (CUDA-graph replay) at

* 'diag' Langevin at C*P = 2^27 (8 chains of one 2^24 leaf), and
* 'scalar' Langevin at qwen3-1.7b's layout, C = 1 (C*P = 2,031,739,904),

the build as it is twice per round under two names (``as_is``,
``as_is_again``: the spread of identical builds), and in place
(``as_is_in_place``, what the packed executor runs; an earlier build may
not allow it). Every timed launch goes straight to the library's C entry
with a preallocated output, so no allocation enters the time. Prints the
card, per shape and build the median device ms and its share of the
bytes bound, and the median over rounds of its time over ``as_is``'s.
Exits non-zero when a build fails its check.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def _layouts():
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import param_layout
    qwen3 = tu.tree_map(lambda leaf: torch.empty(leaf.shape, device="meta"),
                        param_layout(get_config("qwen3-1.7b")))
    return {"ragged": (kops.make_packed_layout({
                "a": torch.zeros(1500), "b": torch.zeros(7, 11),
                "c": torch.zeros(3)}), 3),
            "2^27 diag": (kops.make_packed_layout(torch.zeros(2**24)), 8),
            "qwen3 scalar": (kops.make_packed_layout(qwen3), 1)}


class Using:
    """While in a ``with`` block the update's wrapper launches ``lib``."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from repro_torch.kernels import _build
        self._real = _build.load
        _build.load = lambda name: self.lib
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build.load = self._real


def launch(lib, variant, th, g, ops, seeds, sc, sl, sb, layout, C, out):
    """One Langevin launch of ``lib`` writing ``out`` (``th`` itself: in
    place), as the wrapper makes it but into a given buffer."""
    import ctypes
    from repro_torch.kernels import fsgld_update as fk
    p = fk._ptr
    err = lib.fsgld_update_launch(
        fk.VARIANTS.index(variant), 0, p(th), None, p(g),
        p(ops.get("mu_g")), p(ops.get("mu_s")), p(ops.get("lam_g")),
        p(ops.get("lam_s")), p(sl, 4), p(sb, 4), p(seeds, 4), p(sc, 4),
        p(out), None, th.shape[0], layout.rows_total, layout.block_rows,
        layout.num_leaves,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def _share(out, ref) -> float:
    return float(((out - ref).abs() / (cs.ATOL + cs.RTOL * ref.abs())).max())


def check(libs, layout, C):
    """Every build out of place through its C entry (Langevin, each
    variant), and the build as it is in place through the wrapper (each
    variant and dynamics), against the plain version. Logs each one's
    largest share of the tolerance; True when none exceeds 1."""
    from repro_torch.kernels import fsgld_update as fk
    gen = cs._gen(torch.device("cuda"), 5)
    worst = dict.fromkeys(list(libs) + ["as_is in place"], 0.0)
    for variant in fk.VARIANTS:
        for dynamics in fk.DYNAMICS:
            th, g, seeds, sc, ops = cs._packed_operands(gen, layout, C,
                                                        variant, dynamics)
            sl, sb = layout.tables(th.device)
            kw = dict(variant=variant, dynamics=dynamics, seg_leaf=sl,
                      seg_base=sb, block_rows=layout.block_rows, chains=C,
                      **ops)
            ref = cs._first(fk.fsgld_update_packed_plain(th, g, seeds, sc,
                                                         **kw))
            if dynamics == "langevin":
                for name, lib in libs.items():
                    out = torch.empty_like(th)
                    launch(lib, variant, th, g, ops, fk._seeds_i32(seeds),
                           sc, sl, sb, layout, C, out)
                    torch.cuda.synchronize()
                    worst[name] = max(worst[name], _share(out, ref[0]))
            with Using(libs["as_is"]):
                out = cs._first(fk.fsgld_update_packed(th, g, seeds, sc,
                                                       **kw))
            torch.cuda.synchronize()
            worst["as_is in place"] = max(
                [worst["as_is in place"]]
                + [_share(a, b) for a, b in zip(out, ref)])
    for name, w in worst.items():
        cs.log(f"  {name}: largest share of the tolerance {cs.ATOL:g} + "
               f"{cs.RTOL:g}|x| used {w:.3f}")
    return max(worst.values()) <= 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_ladder: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import fsgld_update as fk
    cs.log(cs.card_line())
    srcs = {"as_is": _build.SOURCES["fsgld_update"]}
    if args.baseline is not None:
        srcs["baseline"] = args.baseline
    tmp = Path(tempfile.mkdtemp(prefix="update_ladder_"))
    runs = _build.compile_all({n: (s, tmp / f"{n}.so", ())
                               for n, s in srcs.items()})
    libs = {}
    for n, (proc, took) in runs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {n}:\n{proc.stdout}")
        cs.log(f"  {n}: built in {took:.2f} s ({srcs[n]})")
        libs[n] = _build.open_library(tmp / f"{n}.so", "fsgld_update")
    layouts = _layouts()
    small, C = layouts.pop("ragged")
    ok = check(libs, small, C)

    builds = {"as_is": (libs["as_is"], False),
              "as_is_again": (libs["as_is"], False),
              "as_is_in_place": (libs["as_is"], True)}
    if "baseline" in libs:
        builds["baseline"] = (libs["baseline"], False)
    gen = cs._gen(torch.device("cuda"), 7)
    for shape, (layout, C) in layouts.items():
        variant = shape.split()[-1]
        th, g, seeds, sc, ops = cs._packed_operands(gen, layout, C, variant,
                                                    "langevin")
        seeds = fk._seeds_i32(seeds)
        sl, sb = layout.tables(th.device)
        n = sum(layout.sizes)
        b_ms, b_by, nbytes = cs.bound_ms(variant, "langevin", C, n,
                                         layout.num_leaves)
        out = torch.empty_like(th)
        times = {b: [] for b in builds}
        for r in range(args.rounds):
            order = list(builds) if r % 2 == 0 else list(builds)[::-1]
            for b in order:
                lib, inplace = builds[b]
                dst = th if inplace else out
                times[b].append(cs.device_ms(
                    lambda: launch(lib, variant, th, g, ops, seeds, sc, sl,
                                   sb, layout, C, dst), calls=5, replays=5))
        cs.log(f"[{shape}] C*P = {C * n}, bound {b_ms:.4f} ms ({b_by}, "
               f"{nbytes} bytes); {args.rounds} rounds")
        base = times["as_is"]
        for b, ts in times.items():
            ms = statistics.median(ts)
            rel = statistics.median(t / a for t, a in zip(ts, base))
            cs.log(f"  {b:16s} {ms:9.4f} ms  {100 * b_ms / ms:5.1f}% of "
                   f"bound  x{rel:.4f} of as_is  (rounds "
                   f"{', '.join(f'{t:.4f}' for t in ts)})")
        del th, g, ops, out
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
