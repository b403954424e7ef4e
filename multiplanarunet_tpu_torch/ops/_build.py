"""Build and load the port's CUDA kernels.

Each source under `multiplanarunet_tpu_torch/csrc/` is compiled with
`nvcc` for `sm_90a` into a shared library of its own with a plain C
interface, at first use, one nvcc process per source, all started
together; the libraries are loaded with ctypes. They land in
`build/kernels/` at the checkout root (listed in .gitignore), each named
by a hash of its source and the flags, so a changed source rebuilds and
an unchanged one loads the existing library.

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
SOURCES = ("shear_pass.cu", "threefry.cu", "unet_epilogue.cu")
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


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch returned an error code."""


def _library_path(build_dir, source):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    h.update((CSRC / source).read_bytes())
    return build_dir / f"libmp_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(build_dir=BUILD_DIR):
    """Compile the sources whose library does not exist yet, one nvcc
    process each, all at once. Returns ({source: library path}, seconds
    spent compiling, the compiler logs of every library); each log is kept
    beside its library."""
    build_dir = Path(build_dir)
    paths = {s: _library_path(build_dir, s) for s in SOURCES}

    def built(seconds=0.0):
        log = "".join(p.with_suffix(".log").read_text() for p in
                      paths.values() if p.with_suffix(".log").is_file())
        return paths, seconds, log

    if all(p.is_file() for p in paths.values()):
        return built()
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # One compile for several processes (the ranks of a group): the others
    # wait on the lock, then load what the first built
    with open(build_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = {s: p for s, p in paths.items() if not p.is_file()}
        return built(_compile(nvcc, todo, build_dir) if todo else 0.0)


def _compile(nvcc, todo, build_dir):
    """Run one nvcc per source of `todo` ({source: library path}) in
    parallel; each compiles to a private name and is renamed into place,
    so a library is never loaded half-written. Returns the wall seconds."""
    procs = {}
    t0 = time.perf_counter()
    for source, lib_path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        procs[source] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for source, (cmd, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        todo[source].with_suffix(".log").write_text(log)
        os.replace(tmp, todo[source])
    if failed:
        raise KernelBuildError("\n".join(failed))
    return time.perf_counter() - t0


class _Kernels:
    """The loaded libraries, their build time and the compiler's report."""

    def __init__(self, paths, build_seconds, log):
        self.paths = paths
        self.build_seconds = build_seconds
        self.log = log
        i64, f32, ptr = ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
        c_int, u32 = ctypes.c_int, ctypes.c_uint32
        fn = ctypes.CDLL(str(paths["shear_pass.cu"])).mp_shear_pass
        fn.argtypes = [ptr, ptr, c_int, c_int,
                       i64, i64, i64, i64,   # sizes
                       c_int, c_int, i64,
                       f32, f32, f32, f32, f32, f32,
                       *[c_int] * 7,         # tile geometry (tile_plan)
                       ptr]                  # stream
        fn.restype = ctypes.c_int
        self.shear_pass = fn
        fn = ctypes.CDLL(str(paths["threefry.cu"])).mp_threefry2x32
        fn.argtypes = [ptr, i64, i64, u32, u32, c_int, f32, f32, f32, ptr]
        fn.restype = ctypes.c_int
        self.threefry = fn
        fn = ctypes.CDLL(str(paths["unet_epilogue.cu"])).mp_unet_epilogue
        fn.argtypes = [ptr, i64, i64, c_int, ptr, c_int,
                       ptr, ptr, ptr, ptr, f32,  # BatchNorm (null mean: none)
                       ptr]                      # stream
        fn.restype = ctypes.c_int
        self.unet_epilogue = fn


@functools.cache
def kernels():
    """Build (at first use) and load the kernel libraries."""
    return _Kernels(*build())
