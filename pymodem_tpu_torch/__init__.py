"""pymodem_tpu_torch: the PyTorch/CUDA port of pymodem_tpu.

The package mirrors ``pymodem_tpu``'s layout module for module, so each
function's counterpart sits at the same path.  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package (K1-K8), and the scans
that the JAX package runs without one on the main paths (K9, the AX.25
bit deframer; K10-K16, the float64 AGC, carrier loops and slicers), is a
hand-written CUDA kernel for Hopper (``csrc/``), built at first use, with
a plain PyTorch twin beside its wrapper.  The package imports no JAX.

Carried so far: the decode of every modem family (``afsk``,
``afsk_pll``, ``bpsk``, ``qpsk``, ``mpsk``, ``fsk``) with the binary,
quadrature and four-level slicers and both codecs (IL2P+CRC and AX.25, on
the device codecs by default or the host state machines), through every
front door of the JAX package: ``runtime/bank.py`` (``run_banked``,
``run_banked_many``, ``run_banked_files``, ``run_plan_banked`` with its
resilient retry, ``run_plan_banked_many``, ``run_plans_banked_pipelined``),
the streaming decoder (``runtime/stream.StreamDecoder``, exported here),
the sequential executor (``runtime/executor.py``), the CLI (``python -m
pymodem_tpu_torch``) and the decode server (``python -m
pymodem_tpu_torch.serve``); the synthesizer CLI (``python -m
pymodem_tpu_torch.synth``) and ``debug``.  The float64 parity mode
(``PYMODEM_TPU_TORCH_X64``, ``mode.py``) runs every family through every
one of those front doors, on the card and on the CPU.  Not yet ported:
multi-GPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # StreamDecoder imports torch; the CLI and the server's client path
    # import this package without it
    if name == "StreamDecoder":
        from .runtime.stream import StreamDecoder

        return StreamDecoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
