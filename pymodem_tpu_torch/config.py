"""Chain and run configuration: specs, JSONL loading, run plans.

The port reads the same JSONL chain configs as ``pymodem_tpu`` and builds
the same frozen specs.  ``pymodem_tpu.config`` is plain Python and numpy
with no JAX, so the port takes it as it is rather than keeping a second
copy; port modules and scripts import the names from here.
"""

from pymodem_tpu.config import (
    AFSKModemSpec,
    AFSKPLLModemSpec,
    AGCSpec,
    BinarySlicerSpec,
    ChainSpec,
    IL2PCodecSpec,
    ReportSpec,
    RunPlan,
    build_chain_spec,
    load_plan,
)

__all__ = [
    "AFSKModemSpec", "AFSKPLLModemSpec", "AGCSpec", "BinarySlicerSpec",
    "ChainSpec", "IL2PCodecSpec", "ReportSpec", "RunPlan",
    "build_chain_spec", "load_plan",
]
