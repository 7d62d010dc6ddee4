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
+ rtol 3e-2). Also prints ptxas's register and spill counts for every
instantiation of the kernel. Exits non-zero when the kernel as it is
fails the tolerance or a planted fault passes it.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

LOOSE_BF16 = (3e-2, 3e-2)  # (atol, rtol) before the row-scaled tolerance

# name -> (what it plants, the source text, its replacement); each fault
# hurts only rows late in a long sequence, where outputs are small
FAULTS = {
    "last_tile": (
        "rows with more than 1,024 keys skip their last 64-key tile",
        "for (int kt = kt0; kt < kt1; ++kt) {",
        "for (int kt = kt0; kt < kt1 - (kt1 - kt0 > 16); ++kt) {"),
    "last_keys": (
        "rows with more than 1,024 keys drop the last 8 keys of their last"
        " tile",
        "        if (edge && !unmasked(p, e < 2 ? qr0 : qr1,",
        "        if ((kt == kt1 - 1 && kt1 - kt0 > 16 && nt == BK / 8 - 1)"
        " ||\n            edge && !unmasked(p, e < 2 ? qr0 : qr1,"),
    "self_key": (
        "causal rows past 1,024 do not see their own key",
        "if (p.causal) ok = ok && kj <= qi;",
        "if (p.causal) ok = ok && (qi >= 1024 ? kj < qi : kj <= qi);"),
    "misweight": (
        "rows with more than 1,024 keys leave their last tile out of the"
        " softmax's sum (bf16)",
        "        l0 += pv[t][0] + pv[t][1];\n"
        "        l1 += pv[t][2] + pv[t][3];\n",
        "        if (kt != kt1 - 1 || kt1 - kt0 <= 16) {\n"
        "          l0 += pv[t][0] + pv[t][1];\n"
        "          l1 += pv[t][2] + pv[t][3];\n"
        "        }\n"),
}


def _compile(nvcc, src: Path, out: Path, extra=()):
    from repro_torch.kernels import _build
    cmd = _build.nvcc_command(nvcc, src, out)
    return subprocess.Popen(cmd[:1] + list(extra) + cmd[1:],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(tmp: Path):
    """The kernel as it is (with ptxas's resource report) and each planted
    fault, one nvcc each, in parallel. Returns {name: library path}."""
    from repro_torch.kernels import _build
    src = _build.SOURCES["flash_attention"]
    text = src.read_text()
    nvcc = _build.find_nvcc()
    jobs = {"as_is": _compile(nvcc, src, tmp / "as_is.so",
                              ("-Xptxas", "-v"))}
    for name, (_, old, new) in FAULTS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in the "
                               "source exactly once")
        planted = tmp / f"{name}.cu"
        planted.write_text(text.replace(old, new))
        jobs[name] = _compile(nvcc, planted, tmp / f"{name}.so")
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        if name == "as_is":
            for line in out.splitlines():
                if "entry function" in line:
                    cs.log("  " + line.split("'")[1])
                elif "spill" in line or "Used" in line:
                    cs.log("    " + line.strip())
    return {name: tmp / f"{name}.so" for name in jobs}


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
        libs = build_all(Path(tmp))
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
