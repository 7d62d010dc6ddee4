"""Does the flash-attention kernel's tolerance catch a wrong kernel?

    python3 tools/flash_planted_faults.py

Needs one CUDA card and nvcc. Compiles ``csrc/flash_attention.cu`` as it
is and once with each fault of ``FAULTS`` planted (a textual edit of a copy
in a temporary directory; the checkout is not touched), all in parallel,
and runs chip_smoke's kernel-vs-plain sweep (``chip_smoke.flash_sweep``)
through the wrapper on each build. Prints, per dtype and mask, the largest
|kernel - plain| and the largest share of the kernel's tolerance
(``repro_torch.kernels.flash_attention.tolerance``) used,
and beside it the share of the earlier, looser bf16 tolerance (atol 3e-2
+ rtol 3e-2). Also prints the build's seconds and ptxas's register and
spill counts (and any wgmma serialisation warning) for every
instantiation of the kernel, and how many wgmma (HGMMA), mma.sync (HMMA),
TMA-load (UTMALDG) and mbarrier (SYNCS) instructions each holds. Exits
non-zero when the kernel as it is fails the tolerance or spills in a bf16
instantiation, or when a planted fault passes the tolerance.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

LOOSE_BF16 = (3e-2, 3e-2)  # (atol, rtol) before the row-scaled tolerance

# name -> (what it plants, [(source text, its replacement), ...]); each
# fault hurts only rows late in a long sequence, where outputs are small:
# rows whose CTA spans more than 1,024 keys (more than 8 tiles of 128 keys,
# or 16 of 64 at hd 256); SPAN recomputes that inside softmax_tile
SPAN = ("  int kb_, ke_;\n"
        "  key_range(p, qc0 / BQ * BQ, BQ, &kb_, &ke_);\n"
        "  const bool span = ke_ - kb_ / BK * BK > 1024;\n"
        "  const bool last = k0 + BK >= ke_;\n")
MASK = "if (!unmasked(p, e < 2 ? qr0 : qr1, k0 + n8 * 8 + t4 * 2 + (e & 1)))"


def _masked_when(cond: str):
    """Replacements that mask the keys of the last tile where ``cond``."""
    return [("  if (edge) {\n", SPAN + "  if (edge || (span && last)) {\n"),
            (MASK, MASK.replace("if (!", f"if (({cond}) || !"))]


FAULTS = {
    "last_tile": (
        "rows with more than 1,024 keys skip their last key tile",
        _masked_when("span && last")),
    "last_keys": (
        "rows with more than 1,024 keys drop the last 8 keys of their last"
        " tile",
        _masked_when("span && last && n8 == BK / 8 - 1")),
    "self_key": (
        "causal rows past 1,024 do not see their own key",
        [("if (p.causal) ok = ok && kj <= qi;",
          "if (p.causal) ok = ok && (qi >= 1024 ? kj < qi : kj <= qi);")]),
    "misweight": (
        "rows with more than 1,024 keys leave their last tile out of the"
        " softmax's sum (bf16)",
        [("  l0 = l0 * c0 + ((r0[0] + r0[1]) + (r0[2] + r0[3]));\n"
          "  l1 = l1 * c1 + ((r1[0] + r1[1]) + (r1[2] + r1[3]));\n",
          SPAN + "  l0 = l0 * c0 + (span && last ? 0.f : ((r0[0] + r0[1]) +"
          " (r0[2] + r0[3])));\n"
          "  l1 = l1 * c1 + (span && last ? 0.f : ((r1[0] + r1[1]) +"
          " (r1[2] + r1[3])));\n")]),
}


def ptxas_report(text: str) -> list[tuple[str, str, int]]:
    """ptxas -v's lines on the flash kernels in ``text``: (kernel, line,
    bytes of spill stores) for each resource line, and ("", line, 0) for
    each wgmma warning (ptxas prints its warnings first)."""
    rows, kernel = [], ""
    for line in text.splitlines():
        line = line.strip()
        if "entry function" in line:
            kernel = line.split("'")[1]
        elif "wgmma" in line and "flash_fwd" in line:
            rows.append(("", line, 0))
        elif "flash_fwd" in kernel and ("spill" in line or "Used" in line):
            stores = re.search(r"(\d+) bytes spill stores", line)
            rows.append((kernel, line, int(stores.group(1)) if stores else 0))
    return rows


def build_and_report(sources: dict[str, tuple[Path, tuple[str, ...]]],
                     tmp: Path, report=None):
    """One nvcc per build (name -> (source, extra nvcc arguments)), all in
    parallel into ``tmp``, with ptxas's resource report. Logs each build's
    seconds and, for the builds named in ``report`` (all when None), the
    registers, spills and wgmma warnings of every flash kernel. Returns
    {name: library path} and the names of the builds in which a bf16
    instantiation spills."""
    from repro_torch.kernels import _build
    runs = _build.compile_all({
        name: (src, tmp / f"{name}.so", ("-Xptxas", "-v", *extra))
        for name, (src, extra) in sources.items()})
    spilled = set()
    for name, (proc, took) in runs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}")
        cs.log(f"  {name}: built in {took:.2f} s")
        for kernel, line, stores in ptxas_report(proc.stdout):
            if stores and "flash_fwd_bf16" in kernel:
                spilled.add(name)
            if report is None or name in report:
                cs.log(f"    {kernel[-40:]}: {line}" if kernel
                       else f"    {line[:160]}")
    return {name: tmp / f"{name}.so" for name in sources}, spilled


def plant(text: str, name: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; ``old`` must
    occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in the "
                               "source exactly once")
        text = text.replace(old, new)
    return text


def build_all(tmp: Path):
    """The kernel as it is and each planted fault, one nvcc each, in
    parallel; the resource report of the kernel as it is. Returns {name:
    library path} and whether a bf16 instantiation of the kernel as it is
    spills."""
    from repro_torch.kernels import _build
    src = _build.SOURCES["flash_attention"]
    text = src.read_text()
    sources = {"as_is": (src, ())}
    for name, (_, edits) in FAULTS.items():
        planted = tmp / f"{name}.cu"
        planted.write_text(plant(text, name, edits))
        sources[name] = (planted, ())
    libs, spilled = build_and_report(sources, tmp, report={"as_is"})
    return libs, "as_is" in spilled


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS")  # wgmma, mma.sync, TMA
                                                 # load, mbarrier


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Per flash kernel of the library, how many instructions of each of
    SASS_OPS its machine code holds (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            if "flash_fwd" in fn:
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn in counts:
            for op in SASS_OPS:
                counts[fn][op] += f" {op}" in line
    return counts


def loose_bound(ref):
    from repro_torch.kernels import flash_attention as fa
    if ref.dtype == torch.float32:
        return fa.tolerance(ref)
    return LOOSE_BF16[0] + LOOSE_BF16[1] * ref.float().abs()


def sweep(lib):
    """chip_smoke's sweep on one build, run once per tolerance on the same
    inputs; per (dtype, causal, window): the largest |diff|, the share of
    the tolerance, the number of cells and the share of the loose one."""
    from repro_torch.kernels import _build
    _build.load = lambda name: lib  # what the wrapper launches
    groups = [cs.sweep_groups(cs.flash_sweep(
        torch.Generator(device="cuda").manual_seed(1234), bound))
        for bound in (None, loose_bound)]
    return {key: val + (groups[1][key][1],)
            for key, val in groups[0].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        cs.log("[build] ptxas resources of the kernel as it is:")
        libs, spilled = build_all(Path(tmp))
        if spilled:
            cs.log("  FAILED: a bf16 instantiation spills")
            ok = False
        cs.log("[sass] instructions of the kernel as it is "
               "(cuobjdump -sass):")
        for fn, counts in sass_counts(libs["as_is"]).items():
            cs.log(f"  {fn[-48:]}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
        for name, path in libs.items():
            what = "the kernel as it is" if name == "as_is" \
                else f"planted fault {name}: {FAULTS[name][0]}"
            cs.log(f"[{name}] {what}")
            worst = loosest = 0.0
            for (dtype, causal, window), (err, use, n, loose) in sweep(
                    _build.open_library(path, "flash_attention")).items():
                worst = max(worst, use)
                if dtype == torch.bfloat16:
                    loosest = max(loosest, loose)
                cs.log(f"  {str(dtype)[6:]:8s} causal={causal!s:5s} "
                       f"window={window!s:4s}: {n} cells, max|diff| "
                       f"{err:.3e}, {100 * use:.1f}% of the tolerance, "
                       f"{100 * loose:.1f}% of the loose one")
            caught = worst > 1
            cs.log(f"  -> {'fails' if caught else 'passes'} the tolerance "
                   f"({100 * worst:.1f}% at most); bf16 "
                   f"{'fails' if loosest > 1 else 'passes'} the loose one "
                   f"({100 * loosest:.1f}%)")
            ok = ok and (caught != (name == "as_is"))
    cs.log("all planted faults caught, the kernel as it is passes" if ok
           else "FAILED: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
