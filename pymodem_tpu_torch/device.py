"""Device resolution, with no fallback.

``resolve("cuda")`` returns the GPU or raises; it never carries on quietly
on the CPU.  The CPU is used only when a caller asks for it by name, as the
CPU tests and ``PYMODEM_TPU_TORCH_DEVICE=cpu`` do.

TF32 is switched off for matmuls and cuDNN convolutions when this module is
imported, by the legacy ``allow_tf32`` flags and, where torch has them, the
per-backend ``fp32_precision`` settings ("ieee"): reduced-precision f32
products flip bit-marginal slicer decisions (docs/ROOFLINE.md).  On the
card the port's FIRs with more than 8 taps are banded matmuls on cuBLAS
(``dsp/fir.py``).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for _backend in (torch.backends.cuda.matmul, torch.backends.cudnn):
    if hasattr(_backend, "fp32_precision"):
        _backend.fp32_precision = "ieee"

ENV_VAR = "PYMODEM_TPU_TORCH_DEVICE"


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``device``; raises when CUDA is asked for and
    no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is "
                f"available (set {ENV_VAR}=cpu to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


class DeviceLostError(RuntimeError):
    """The device's CUDA context is dead: a sticky error (a device-side
    assert, an illegal address, a kernel fault) fails every later call on
    it in this process, so no retry there can succeed."""


def lost(device: str | torch.device) -> str | None:
    """The sticky error that ``device`` reports on a synchronize (its
    first line), or None while the device still runs work.  A CPU device
    is never lost."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        torch.cuda.synchronize(dev)
    except Exception as exc:  # noqa: BLE001 - any failure is the answer
        return f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return None


def resolve_dtype(dtype=None) -> torch.dtype:
    """The float dtype of a decode: ``dtype`` (float32 or float64, as a
    torch or numpy dtype or its name), or for None the mode's
    (``mode.x64``: float64 under ``PYMODEM_TPU_TORCH_X64``, else
    float32)."""
    from .mode import x64

    if dtype is None:
        return torch.float64 if x64() else torch.float32
    name = str(dtype).replace("torch.", "")
    if "float64" in name or name in ("double", "<class 'float'>"):
        return torch.float64
    if "float32" in name:
        return torch.float32
    raise ValueError(f"dtype {dtype!r}: the decode runs float32 or float64")


def from_env() -> torch.device:
    """The device named by PYMODEM_TPU_TORCH_DEVICE (default ``cuda``)."""
    import os

    return resolve(os.environ.get(ENV_VAR) or "cuda")


def upload(host, device: str | torch.device) -> torch.Tensor:
    """``host`` (a numpy array or a CPU tensor) on ``device``.  A copy to
    the card goes through pinned memory with ``non_blocking``: a copy from
    pageable memory synchronises the stream, so it would wait for every
    launch queued before it (torch's pinned allocator keeps the staging
    block until its copy is done)."""
    if isinstance(host, torch.Tensor):
        t = host
    else:
        a = np.asarray(host)
        # ascontiguousarray would turn a 0-d array into a 1-d one
        t = torch.from_numpy(a if a.flags.c_contiguous
                             else np.ascontiguousarray(a))
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_CONSTANTS: dict = {}


def constant(table, device: str | torch.device) -> torch.Tensor:
    """A module-level constant ``table`` (a CPU tensor, or a numpy array
    that lives as long as the process) on ``device``, uploaded once per
    device (``upload``).  The cache holds ``table`` itself, so its id is
    never reused while the entry stands."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (table if isinstance(table, torch.Tensor)
                else torch.from_numpy(table))
    key = (id(table), dev)
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = (table, upload(table, dev))
    return hit[1]
