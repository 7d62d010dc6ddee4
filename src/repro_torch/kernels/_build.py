"""Build and load the CUDA kernels (nvcc into a shared library with a plain
C interface, loaded with ctypes).

The library is compiled at first use into ``build/repro_torch_kernels/``
at the repository root, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads what is there. Nothing
is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fsgld_update.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# no --use_fast_math: the approximate log/cos would move the normals
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfsgld_update-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless an identical build exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(nvcc_command(find_nvcc(), SOURCE, Path(tmp)),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) on "
                               f"{SOURCE}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: readers never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded kernel library with its argument types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fsgld_update_launch.argtypes = (
        [i32, i32] + [ptr] * 13 + [ctypes.c_longlong, i32, i32, i32, ptr])
    lib.fsgld_update_launch.restype = i32
    lib.fsgld_update_error_string.argtypes = [i32]
    lib.fsgld_update_error_string.restype = ctypes.c_char_p
    return lib
