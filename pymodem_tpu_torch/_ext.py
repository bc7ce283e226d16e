"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels expose a plain C interface, so they are compiled by ``nvcc``
alone, one process per source in parallel, and linked into one shared
library loaded with ``ctypes``; no PyTorch header is involved, which keeps
the build to seconds.  The build happens at first use, never at import,
into ``pymodem_tpu_torch/_build/`` (listed in
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
    returns its path.  Each source compiles in its own nvcc process, all
    started together, then one nvcc links them.  A file lock serialises
    concurrent builds."""
    import fcntl
    import tempfile

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cu = [s for s in _sources() if s.endswith(".cu")]
            objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                    for s in cu]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            cmds = [[_nvcc(), *compile_flags, "-Xptxas", "-v", "-c", "-o", o,
                     s] for s, o in zip(cu, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for c in cmds]
            logs = []
            for cmd, proc in zip(cmds, procs):
                stdout, stderr = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                        f"\n{stdout}\n{stderr}")
                logs.append(stderr.strip())
            tmp_out = os.path.join(tmp, "lib.so")
            link = [_nvcc(), *NVCC_FLAGS, "-o", tmp_out, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{' '.join(link)}\n{proc.stderr}")
            if verbose:
                print("\n".join(logs))
            os.replace(tmp_out, out)
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


def require(device, dtype, **tensors) -> None:
    """Raise ValueError unless ``device`` is a CUDA device and every named
    tensor is a contiguous ``dtype`` tensor on it (what the kernels take)."""
    _require(device, dtype, lambda t: t.is_contiguous(), "contiguous",
             tensors)


def require_rows(device, dtype, **tensors) -> None:
    """``require`` for the (n, T) inputs of the kernels that take rows of
    unit stride that need not follow one another (``lane_rows``,
    ``lane_rows_pair``)."""
    _require(device, dtype, lambda t: t.ndim == 2 and t.stride(-1) == 1,
             "(n, T) with contiguous rows", tensors)


def _require(device, dtype, layout_ok, layout: str, tensors: dict) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: the kernels run on "
                         "CUDA, the plain twins on the CPU")
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype or not layout_ok(t):
            raise ValueError(f"{name}: need a {layout} {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}, "
                             f"strides {t.stride()}")


# a bulk copy (TMA) moves a multiple of 16 bytes between 16-byte-aligned
# addresses
BULK_BYTES = 16


def rows_aligned(t) -> bool:
    """Whether the staged lane kernels (K1-K8, K10, K11, K13-K16) can copy
    the rows of the (n, T) tensor ``t`` (rows of unit stride) as they are,
    by bulk copies: 16-byte aligned starts a multiple of 16 bytes apart (4
    floats, 2 doubles).  For a contiguous ``t``: T floats a multiple of 4,
    T doubles a multiple of 2."""
    return (t.stride(-1) == 1
            and t.stride(0) * t.element_size() % BULK_BYTES == 0
            and t.stride(0) >= t.shape[-1]
            and t.data_ptr() % BULK_BYTES == 0)


def _padded(t, stride: int):
    """A zero-padded copy of the (n, T) rows of ``t`` into rows ``stride``
    elements apart, counted in ``lane_rows.copies``."""
    n, T = t.shape
    out = t.new_zeros((n, stride))
    out[:, :T] = t
    lane_rows.copies += 1
    return out


def lane_rows(t):
    """The rows of the (n, T) tensor ``t`` (rows of unit stride) as the
    staged lane kernels of one input rail (K1-K5, K8, K10, K11, K13, K14)
    copy them: ``t`` itself when ``rows_aligned``, else a copy into rows of
    T rounded up to a multiple of 16 bytes (4 floats, 2 doubles),
    zero-padded.  The kernels take the row stride, ``.stride(0)``, and read
    T samples a row.  ``lane_rows.copies`` counts the copies."""
    if rows_aligned(t):
        return t
    per = BULK_BYTES // t.element_size()
    return _padded(t, -(-t.shape[1] // per) * per)


lane_rows.copies = 0


def pair_aligned(a, b) -> bool:
    """Whether the staged two-rail kernels (K6, K7, K15, K16), which take
    one row stride for both rails, can copy the rows of ``a`` and ``b`` as
    they are: both ``rows_aligned`` and as far apart."""
    return rows_aligned(a) and rows_aligned(b) and a.stride(0) == b.stride(0)


def lane_rows_pair(a, b):
    """The two (n, T) rails ``a`` and ``b`` (same shape and dtype, rows of
    unit stride) as the staged two-rail kernels (K6, K7, K15, K16) copy
    them: at one row stride, each 16-byte aligned.  Both as they are when
    ``pair_aligned``; else a rail that is ``rows_aligned`` stays as it is
    and the other is copied, zero-padded, into rows of its stride; else
    both are copied into rows of T rounded up to 16 bytes.  Returns (n, T)
    views whose ``.stride(0)`` the kernels take for both rails; each copy
    counts in ``lane_rows.copies``."""
    if pair_aligned(a, b):
        return a, b
    T = a.shape[1]
    if rows_aligned(a):
        return a, _padded(b, a.stride(0))[:, :T]
    if rows_aligned(b):
        return _padded(a, b.stride(0))[:, :T], b
    per = BULK_BYTES // a.element_size()
    stride = -(-T // per) * per
    return _padded(a, stride)[:, :T], _padded(b, stride)[:, :T]


def launch(name: str, device, argtypes: tuple, *args) -> None:
    """Launch the C entry point ``name`` with ``args`` on the current
    stream of ``device`` (the stream goes last); raise on a CUDA error."""
    import torch

    fn = kernel(name, argtypes + (ctypes.c_void_p,))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(name, fn(*args, stream))
