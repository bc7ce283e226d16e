"""pymodem_tpu_torch: the PyTorch/CUDA port of pymodem_tpu.

The package mirrors ``pymodem_tpu``'s layout module for module, so each
function's counterpart sits at the same path.  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package (K1-K8) is a hand-written
CUDA kernel for Hopper (``csrc/``), built at first use, with a plain
PyTorch twin beside its wrapper.  The package imports no JAX.

Slice carried so far: the banked IL2P+CRC decode (``runtime/bank.run_banked``,
``run_plan_banked``, the CLI) for every modem family (``afsk``,
``afsk_pll``, ``bpsk``, ``qpsk``, ``mpsk``, ``fsk``) with the binary,
quadrature and four-level slicers, on the device IL2P codec route (the
default, ``codecs/il2p_device.py``) or the host state machines
(``codec="host"``).  Not yet ported: AX.25, float64 parity mode, the
sequential executor, streaming and serving, multi-GPU.
"""

__version__ = "0.1.0"
