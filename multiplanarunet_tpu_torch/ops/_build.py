"""Build and load the port's CUDA kernels.

The sources under `multiplanarunet_tpu_torch/csrc/` are compiled with
`nvcc` for `sm_90a` into one shared library with a plain C interface, at
first use, and loaded with ctypes. The library lands in `build/kernels/`
at the checkout root (listed in .gitignore), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads the existing library.

Nothing here falls back: a missing `nvcc` or a failed compile raises
`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("shear_pass.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
# --split-compile=0 runs nvcc's optimisation of the module's functions on
# every host core; the SASS is the same as a serial compile's, function
# for function
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc():
    """Path of `nvcc`: $CUDA_HOME/bin (default /usr/local/cuda), then PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {cand} and on PATH): the port's CUDA "
            f"kernels are built from multiplanarunet_tpu_torch/csrc at first "
            f"use and need the CUDA toolkit")
    return found


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(build_dir=BUILD_DIR):
    """Compile the kernels unless a library of the same sources exists.
    Returns (path, seconds spent compiling, compiler log); the log is kept
    beside the library."""
    build_dir = Path(build_dir)
    lib_path = build_dir / f"libmp_kernels_{_source_hash()}.so"
    log_path = lib_path.with_suffix(".log")

    def built():
        log = log_path.read_text() if log_path.is_file() else ""
        return lib_path, 0.0, log

    if lib_path.is_file():
        return built()
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # One compile for several processes (the ranks of a group): the others
    # wait on the lock, then load what the first built
    with open(build_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.is_file():
            return built()
        return _compile(nvcc, lib_path, log_path, build_dir)


def _compile(nvcc, lib_path, log_path, build_dir):
    # Compile to a private name and rename into place: a library is never
    # loaded half-written
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


class _Kernels:
    """The loaded library, its build time and the compiler's report."""

    def __init__(self, path, build_seconds, log):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        fn = self.lib.mp_shear_pass
        i64, f32, ptr = ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
        c_int = ctypes.c_int
        fn.argtypes = [ptr, ptr, c_int, c_int,
                       i64, i64, i64, i64,   # sizes
                       c_int, c_int, i64,
                       f32, f32, f32, f32, f32, f32,
                       *[c_int] * 7,         # tile geometry (tile_plan)
                       ptr]                  # stream
        fn.restype = ctypes.c_int
        self.shear_pass = fn


@functools.cache
def kernels():
    """Build (at first use) and load the kernel library."""
    return _Kernels(*build())
