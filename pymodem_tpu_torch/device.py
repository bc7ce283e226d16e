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


def from_env() -> torch.device:
    """The device named by PYMODEM_TPU_TORCH_DEVICE (default ``cuda``)."""
    import os

    return resolve(os.environ.get(ENV_VAR) or "cuda")
