"""pymodem_tpu_torch: the PyTorch/CUDA port of pymodem_tpu.

The package mirrors ``pymodem_tpu``'s layout module for module, so each
function's counterpart sits at the same path.  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package that this port carries is a
hand-written CUDA kernel for Hopper (``csrc/``), built at first use, with a
plain PyTorch twin beside its wrapper.  The package imports no JAX.

Slice carried so far: the banked AFSK-300 IL2P+CRC decode on the host-codec
route (``runtime/bank.run_banked(codec="host")``) for the ``afsk`` and
``afsk_pll`` modems with the binary slicer.
"""

__version__ = "0.1.0"
