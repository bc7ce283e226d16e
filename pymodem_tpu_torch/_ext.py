"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels expose a plain C interface, so they are compiled by ``nvcc``
alone into one shared library and loaded with ``ctypes``; no PyTorch header
is involved, which keeps the build to seconds.  The build happens at first
use, never at import, into ``pymodem_tpu_torch/_build/`` (listed in
``.gitignore``), under a file name keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the library
already there.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` with no fast math,
so that nvcc does not contract a multiply and an add into one fused
operation that the JAX reference and PyTorch round separately.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"pymodem_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the shared library if it is not built yet;
    returns its path.  A file lock serialises concurrent builds."""
    import fcntl

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cu = [s for s in _sources() if s.endswith(".cu")]
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(build())


def kernel(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints)."""
    fn = getattr(_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
