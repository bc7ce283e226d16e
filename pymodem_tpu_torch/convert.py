"""Bank parameters: from the host (numpy) pytree to the port's tensors.

Both packages build a bank's parameters the same way: per-chain numpy
leaves (filter taps, loop and AGC constants, slicer rates) stacked along a
leading chain axis, plus the switches ``space_scale`` (a pure space-gain
AFSK sweep, demodulated once and scaled per chain) and ``pre_shared`` (a
coherent carrier sweep whose pre-loop stages are identical across chains).
``bank_params_from_jax`` turns the pytree that
``pymodem_tpu.runtime.bank.group_chains(chains, jnp.float32)`` builds into
the port's dict of tensors; the port's own ``group_chains`` goes through it
too, so the two agree leaf for leaf.  The port adds what its kernels read
in place of the JAX package's in-kernel transcendentals: the NCO's sine
and cosine tables (coherent banks) and, for ``mpsk``, each chain's f32
phase-detector error table (``dsp/loops.py``).

``chain_params_from_jax`` does the same for one chain's modem parameters
(``pymodem_tpu.modems.build_params(spec)``), the input of the sequential
executor's whole-recording demods (``modems.demod``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import upload
from .dsp.loops import (
    f64_nco_tables,
    nco_cos_table,
    nco_sine_table,
    pd_error_table,
)
from .dsp.window_design import qpsk_error_table


def _leaf(v, device) -> torch.Tensor:
    return upload(np.array(v, copy=True), device)


def _tree(node, device):
    if hasattr(node, "_asdict"):  # NamedTuple (e.g. the AGC constants)
        node = node._asdict()
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _leaf(node, device)


def bank_params_from_jax(jax_bank_params: dict, sine_table=None,
                         device: str | torch.device = "cpu") -> dict:
    """The port's bank parameters from a JAX-package bank pytree.

    Leaves keep their dtype (float32 for the f32 bank, float64 for the
    f64 bank of the parity mode).  Coherent banks (those with ``loop``
    leaves) also get ``sine_table`` and ``cos_table``: at float32 the NCO's
    256-entry f32 tables, ``nco_sine_table()`` (unless a sine table is
    given, for instance XLA's own ``sin`` of the same angles) and
    ``nco_cos_table()``; at float64 the bank's reference wavetable as the
    JAX package's f64 NCO gathers it (``f64_nco_tables``).  ``mpsk`` banks
    get ``pd_error_table``, (C, g*g) int32, from each chain's
    ``pd_granularity`` and ``pd_gain``, in place of the JAX package's
    ``modem.pd_table``, which no kernel reads: at float32 the f32 formula's
    table (``pd_error_table``), at float64 the reference's own table
    (``qpsk_error_table``), as the JAX package's f64 detector gathers it.
    """
    params = _tree(dict(jax_bank_params), device)
    f64 = np.asarray(jax_bank_params["sps"]).dtype == np.float64
    if "loop" in params:
        if f64:
            sine, cosine = f64_nco_tables(
                np.asarray(jax_bank_params["loop"]["wavetable"])[0])
        else:
            sine = np.asarray(nco_sine_table() if sine_table is None
                              else sine_table, np.float32)
            cosine = nco_cos_table()
        params["sine_table"] = _leaf(sine, device)
        params["cos_table"] = _leaf(cosine, device)
    if "pd_gain" in jax_bank_params:
        params["modem"].pop("pd_table", None)
        table = ((lambda g, k: qpsk_error_table(g, k).reshape(-1)) if f64
                 else pd_error_table)
        params["pd_error_table"] = _leaf(np.stack([
            table(int(g), float(k)) for g, k in zip(
                np.asarray(jax_bank_params["pd_granularity"]),
                np.asarray(jax_bank_params["pd_gain"]))
        ]).astype(np.int32), device)
    return params


def chain_params_from_jax(jax_params):
    """The port's modem parameters (``modems.build_params``'s NamedTuple of
    the same name: ``AFSKParams``, ``PLLParams``, ``PSKParams``,
    ``MPSKParams`` or ``FSKParams``) from the JAX package's, leaf for leaf
    (numpy arrays and scalars as they are, the AGC constants as the port's
    ``AGCParams``).  The JAX package's f64 ``pd_table`` is dropped: the
    port's K6 reads ``dsp/loops.pd_error_table``."""
    from . import modems

    cls = getattr(modems, type(jax_params).__name__)
    fields = jax_params._asdict()
    if "agc" in fields:
        fields["agc"] = modems.AGCParams(*fields["agc"])
    return cls(**{k: fields[k] for k in cls._fields})
