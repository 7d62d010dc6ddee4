"""Build and load the CUDA kernels (nvcc into shared libraries with a plain
C interface, loaded with ctypes).

Each source in ``csrc/`` becomes one library, compiled at first use into
``build/repro_torch_kernels/`` at the repository root and named by a hash
of its source and the flags, so a changed source rebuilds and an
unchanged one loads what is there. ``build`` starts one nvcc per missing
library, all at once. Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fsgld_update": CSRC / "fsgld_update.cu",
           "flash_attention": CSRC / "flash_attention.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# no --use_fast_math: the approximate log/cos would move the normals
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# library -> {launch function: its argument types}
_SIGNATURES = {
    "fsgld_update": {
        "fsgld_update_launch": [_I32, _I32] + [_PTR] * 13
        + [ctypes.c_longlong, _I32, _I32, _I32, _PTR]},
    "flash_attention": {
        "flash_attention_launch": [_I32] + [_PTR] * 4 + [_I32] * 7 + [_PTR],
        "flash_attention_lse_launch": [_I32] + [_PTR] * 5 + [_I32] * 7
        + [_PTR]},
}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source at first use")


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_all(jobs: dict[str, tuple[Path, Path, tuple[str, ...]]]
                ) -> dict[str, tuple[subprocess.CompletedProcess, float]]:
    """One nvcc per job (name -> (source, output, extra nvcc arguments)),
    all in parallel: name -> (the finished process, its seconds)."""
    nvcc = find_nvcc()

    def run(job):
        src, out, extra = job
        cmd = nvcc_command(nvcc, src, out)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd[:1] + list(extra) + cmd[1:],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(zip(jobs, pool.map(run, jobs.values())))


def build(*names: str,
          seconds: dict[str, float] | None = None) -> dict[str, Path]:
    """Compile the named libraries (all when none are named) unless an
    identical build exists; one nvcc per library, run in parallel. Each
    library compiled here gets its nvcc's seconds in ``seconds``."""
    names = names or tuple(SOURCES)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmps, failed = {}, []
    try:
        for n in todo:  # each compiles into a temporary file of BUILD_DIR
            fd, tmps[n] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
        runs = compile_all({n: (SOURCES[n], Path(tmps[n]), ())
                            for n in todo})
        for n, (proc, took) in runs.items():
            if seconds is not None:
                seconds[n] = took
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{SOURCES[n]}:\n{proc.stdout}")
            else:
                os.replace(tmps[n], out[n])  # atomic: no partial file seen
    finally:
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its argument types declared."""
    return open_library(build(name)[name], name)


def open_library(path: Path, name: str) -> ctypes.CDLL:
    """The shared library at ``path``, built from library ``name``'s
    source, with the argument types of each launch function it defines
    declared (an older source may lack a later entry)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I32
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [_I32]
    err.restype = ctypes.c_char_p
    return lib
