"""Sequential chain execution: one chain at a time over a whole recording.

Port of ``pymodem_tpu.runtime.executor``, the reference-parity orchestrator
(the analog of the reference's process-per-chain driver, pymodem.py:
140-166).  Each chain demodulates the whole recording as one lane of the
port's kernels (``modems.demod``: K2, K3, K5 with the AGC fused, K4 and K6
for ``mpsk``), slices it with K1, K7 or K8 at one lane, compacts and
descrambles on the device, and decodes on the host with the
reference-exact AX.25 and IL2P state machines.  The banked runtime retries
a failed bank through ``run_chain`` (``runtime/bank.run_plan_banked``), on
the same device.  Everything runs on ``device`` (default ``cuda``, no
fallback); on the CPU the kernels' plain twins run.

``dtype`` (None: the mode's, ``device.resolve_dtype``) is float32 or, in
the float64 parity mode, float64 -- the JAX package's reference-parity
mode and its CLI's default route there.  At float64 the demods and
slicers run their f64 kernels on the card: K11 for ``afsk_pll`` and
``bpsk``, K14 for ``qpsk``, K13 and K15 for ``mpsk``, K10, K16 and K12
for the binary, quadrature and four-level slicers, the FIRs as float64
DGEMMs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import modems
from ..codecs.host import ax25_decode_host, il2p_decode_host
from ..device import resolve, resolve_dtype
from ..ops.lfsr import descramble_bytes
from ..ops.slicers import (
    binary_slice_lanes,
    compact_bytes,
    decode_emissions,
    four_level_slice_lanes,
    quadrature_slice_lanes,
    safe_compact_window,
)


@dataclass
class RunResult:
    aggregate: Any  # packets.PacketAggregate
    reports: list[str] = field(default_factory=list)


def _slice_capacity(n_samples: int, samples_per_symbol: float,
                    bits_per_symbol: int) -> int:
    nominal = n_samples / samples_per_symbol * bits_per_symbol / 8.0
    return int(nominal * 4) + 64


def slicer_lane_params(spec, device, dtype=torch.float32) -> torch.Tensor:
    """(2, 1) ``dtype`` lane rows (sps, lock_rate) of a slicer spec, each
    rounded once from the float64 value (the JAX scan's Python floats)."""
    return torch.tensor([[spec.sample_rate / spec.symbol_rate],
                         [float(spec.lock_rate)]], dtype=torch.float64,
                        device=device).to(dtype)


def run_slicer(spec, baseband):
    """Slice a whole-recording baseband ((n,), or an (i, q) pair for the
    quadrature slicer) with the spec's kernel at one lane (K1 binary, K7
    quadrature, K8 four-level; at float64 K10 and K12; emissions per
    sample), then compact; returns (bytes, addresses, count) tensors, as
    the JAX package's ``compact_bytes`` over the slicer scan's output."""
    sps = spec.sample_rate / spec.symbol_rate
    if spec.kind == "quadrature":
        i_data, q_data = baseband
        lanes = slicer_lane_params(spec, i_data.device, i_data.dtype)
        enc = quadrature_slice_lanes(i_data[None], q_data[None], lanes,
                                     spec.demap, spec.state_mask,
                                     spec.bits_per_symbol)
        n, bps = i_data.shape[-1], spec.bits_per_symbol
    elif spec.kind == "binary":
        lanes = slicer_lane_params(spec, baseband.device, baseband.dtype)
        enc = binary_slice_lanes(baseband[None], lanes)
        n, bps = baseband.shape[-1], 1
    elif spec.kind == "4level":
        lanes = slicer_lane_params(spec, baseband.device, baseband.dtype)
        enc = four_level_slice_lanes(baseband[None], lanes, spec.demap)
        n, bps = baseband.shape[-1], 2
    else:
        raise ValueError(f"no slicer {spec.kind!r}")
    capacity = _slice_capacity(n, sps, bps)
    window = safe_compact_window(sps, spec.lock_rate, bps)
    return compact_bytes(decode_emissions(enc[0]), capacity, window)


def run_chain(spec, audio: np.ndarray, device: str | torch.device = "cuda",
              dtype=None) -> list:
    """Run one chain over a whole recording at ``dtype`` (None: the
    mode's); returns its decoded packets."""
    dev = resolve(device)
    dtype = resolve_dtype(dtype)
    params = modems.build_params(spec.modem)
    wire = torch.from_numpy(np.ascontiguousarray(np.asarray(audio)))
    baseband = modems.demod(spec.modem, params, wire.to(dev).to(dtype))
    data, addr, count = run_slicer(spec.slicer, baseband)
    if spec.stream is not None and spec.stream.polynomial != 0:
        data = descramble_bytes(data.to(torch.uint8), spec.stream.polynomial,
                                spec.stream.invert)
    n = int(count)
    data_np = data[:n].cpu().numpy().astype(np.int64)
    addr_np = addr[:n].cpu().numpy()
    codec = spec.codec
    if codec.kind == "ax25":
        return ax25_decode_host(
            data_np, addr_np, codec.ident,
            min_packet_length=codec.min_packet_length,
            max_packet_length=codec.max_packet_length,
        )
    if codec.kind == "il2p":
        return il2p_decode_host(
            data_np, addr_np, codec.ident,
            collect_trailing_crc=codec.collect_trailing_crc,
            disable_rs=codec.disable_rs,
            min_distance=codec.min_distance,
            sync_tolerance=codec.sync_tolerance,
        )
    raise ValueError(f"no codec {codec.kind!r}")


def run_plan(plan, audio: np.ndarray, sample_rate: float,
             verbose: bool = False, resilient: bool = True,
             device: str | torch.device = "cuda", dtype=None) -> RunResult:
    """Run every chain at ``dtype`` (None: the mode's), then aggregate,
    correlate and report (pymodem.py:134-183).

    ``resilient`` is the reference's skip-and-continue (chain_execute.py:
    8-27): a chain that raises is reported and skipped and the others
    still decode, unless the failure left the device lost (a sticky CUDA
    error, ``device.lost``): then the message names the error once and
    ``DeviceLostError`` is raised.  ``resilient=False`` raises."""
    from ..device import DeviceLostError, lost
    from ..packets import PacketAggregate

    dtype = resolve_dtype(dtype)
    aggregate = PacketAggregate()
    for chain in plan.chains:
        if verbose:
            print(f"{chain.name} chain start")
        try:
            packets = run_chain(chain, audio, device=device, dtype=dtype)
        except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
            if not resilient:
                raise
            dead = lost(device)
            if dead is not None:
                print(f"chain {chain.name} failed ({dead}); the device is "
                      f"lost, no retry")
                raise DeviceLostError(dead) from exc
            print(f"skipped chain {chain.name}: {type(exc).__name__}: {exc}")
            packets = []
        aggregate.add(packets)
    aggregate.validate_all()
    aggregate.correlate(address_distance=sample_rate / 40)
    reports = [
        aggregate.render_raw_bad() + aggregate.render_report(r.style)
        for r in plan.reports
    ]
    return RunResult(aggregate=aggregate, reports=reports)
