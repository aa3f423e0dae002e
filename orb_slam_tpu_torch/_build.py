"""Build and load the hand-written CUDA kernels of csrc/.

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, under `_build/`, named by a hash of the source, the
shared headers of csrc/ and the flags, and is loaded with ctypes at first
use (never at import: the CPU tests import every module on a host without
nvcc). `build_libraries` compiles several sources at once, one nvcc
process each. A missing nvcc or a failed build raises; nothing falls back.

Each C entry point returns the cudaError_t of its launch, and
`CudaKernel.__call__` raises if it is not 0. The only mutable state is
each kernel's `launches` counter, which the wrappers bump once per launch.
nvcc runs with `-Xptxas -v`; its report (registers, shared memory and
spills of each kernel) is kept beside the library and read by
`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then the toolkit's default prefix."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and TOOLKIT_NVCC.exists():
        nvcc = str(TOOLKIT_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _job(job):
    """(source, extra nvcc flags) of a build job: a csrc/ file name, or a
    (name, flags) pair such as ("pose_gn.cu", ("-DPOSE_GN_PROFILE",))."""
    return (job, ()) if isinstance(job, str) else (job[0], tuple(job[1]))


def library_path(source: str, flags=()) -> Path:
    """_build/<stem>-<hash>.so for csrc/<source> built with NVCC_FLAGS and
    `flags`; the hash covers the source, every header of csrc/ and the
    flags."""
    src = CSRC / source
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build_libraries(jobs) -> dict:
    """Compile each job (see _job) that has no library in _build/ yet, all
    nvcc processes at once. Returns {job: library path}."""
    outs = {j: library_path(*_job(j)) for j in jobs}
    todo = {j: o for j, o in outs.items() if not o.exists()}
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for job, out in todo.items():
            source, flags = _job(job)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / source)]
            procs[job] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          tmp)
        failed = []
        for job, (proc, tmp) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {job}:\n{stdout}\n{stderr}")
            else:
                todo[job].with_suffix(".ptxas.txt").write_text(stdout + stderr)
                os.replace(tmp, todo[job])
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def ptxas_report(source: str) -> str:
    """nvcc's -Xptxas -v output for the built library of csrc/<source>."""
    return library_path(source).with_suffix(".ptxas.txt").read_text()


def build_library(source: str) -> Path:
    """Compile csrc/<source> into _build/ unless a library for the same
    source text and flags is already there. Returns the library path."""
    return build_libraries([source])[source]


class CudaKernel:
    """One C entry point of one csrc/ file, built and loaded at first use.

    `argtypes` are ctypes types; every pointer and the stream travel as
    c_void_p (a bare Python int would be cut to 32 bits)."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds = None
        self._fn = None
        self._lib = None

    def load(self):
        if self._fn is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build_library(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
            self.build_seconds = time.perf_counter() - t0
        return self._fn

    def __call__(self, *args):
        rc = self.load()(*args)
        if rc != 0:
            msg = self._lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1
