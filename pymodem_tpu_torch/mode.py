"""The float64 parity mode's switch, read without importing torch.

``PYMODEM_TPU_TORCH_X64`` (the JAX package's ``PYMODEM_TPU_X64`` under the
port's prefix) turns the decode to float64 when its value is set and is not
``0``, empty or ``false``, as the JAX package reads it
(``pymodem_tpu/cli.py``).  Unlike the JAX package, the mode does not move
the run to the CPU: the H100 has native float64, so the device stays what
``PYMODEM_TPU_TORCH_DEVICE`` names (``device.from_env``), and the entry
points' ``dtype=None`` means this mode's dtype (``device.resolve_dtype``).
"""

from __future__ import annotations

import os

X64_VAR = "PYMODEM_TPU_TORCH_X64"


def x64() -> bool:
    """Whether the float64 parity mode is on."""
    return os.environ.get(X64_VAR, "0") not in ("0", "", "false")
