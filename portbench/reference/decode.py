"""Plain reference decode of (chain, block) lanes, for the check that
decides ``correct``.

It imports nothing of the port.  From the configuration's chain lines and
the int16 recording it works out again everything the port derives: the
chain specs, the filter taps, the block geometry, the AGC normal of each
block group, each lane's demod, timing slicer, descrambler, codec state
machine and the block's keep range.  The block semantics are the port's
banked runtime's (the geometry rules are frozen from
``pymodem_tpu_torch/runtime/bank.py`` at commit b13223a, for every family:
a packet's wire time, the byte capacity and the acquisition floors follow
the chain's bits per slicer decision): the recording is cut into
overlapped blocks, every block starts its loops from rest, and a packet
belongs to the block whose keep range holds its stream address.

The stages are found by the chain spec's kinds: ``modems/<kind>.py``,
``slicers/<kind>.py``, ``streams/<kind>.py`` and ``codecs/<kind>.py``, so a
configuration of another family brings new files, not an edit here.  The
precisions are ``arith.py``'s: ``float64`` for the reference, ``control``
for the check's control.

Lanes are independent, so ``decode_lanes`` spreads them over worker
processes (spawned: they import this package, numpy and scipy only).
"""

from __future__ import annotations

import importlib
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from multiprocessing import get_context

import numpy as np
from scipy.signal import fftconvolve

from .arith import Arith
from .frozen import config as fcfg

# Geometry rules of the banked runtime (frozen, runtime/bank.py at b13223a)
_ACQ_SECONDS_FLOOR = 0.35
_ACQ_SYMBOLS = 192.0
_ACQ_COHERENT_FLOOR = 1.25
# the four-level slicer learns its threshold on absolute time scales too
_ACQ_FLOOR_BY_SLICER = {"4level": 1.2}
_TARGET_LANES = 2048
_LANE_BUDGET_BYTES = 3e9
_GROUP_BUDGET_BYTES = 16e9
_F32_BYTES = 4


def chains_from_lines(lines: list[dict], sample_rate: float) -> list:
    """Chain specs of the configuration's demod_chain lines."""
    return [fcfg.build_chain_spec(float(sample_rate), line) for line in lines
            if line.get("object_type") == "demod_chain"]


def stage(family: str, kind: str):
    """The reference module of one stage kind (``modems``, ``slicers``,
    ``streams`` or ``codecs``)."""
    return importlib.import_module(f".{family}.{kind}", __package__)


def bits_per_symbol(slicer) -> int:
    """Bits per slicer decision: the quadrature slicer's field, 2 for the
    four-level slicer, else 1."""
    return getattr(slicer, "bits_per_symbol",
                   2 if slicer.kind == "4level" else 1)


def _max_packet_seconds(chain) -> float:
    return stage("codecs", chain.codec.kind).max_packet_seconds(
        chain.codec, chain.slicer.symbol_rate * bits_per_symbol(chain.slicer))


@dataclass(frozen=True)
class Geometry:
    """One bank's block layout over one recording (demod units = input
    samples: the reference decodes no output oversample)."""

    n_audio: int
    trim: int
    block_len: int
    overlap: int
    per_group: int
    capacity: int

    @property
    def n_demod(self) -> int:
        return self.n_audio - self.trim

    @property
    def n_blocks(self) -> int:
        return -(-self.n_demod // self.block_len)

    @property
    def input_len(self) -> int:
        return self.block_len + self.overlap + self.trim

    def keep_range(self, b: int) -> tuple[int, int]:
        lo = b * self.block_len
        return lo, min(lo + self.block_len, self.n_demod)

    def block_of(self, address: int) -> int:
        return (address - 1) // self.block_len


def geometry(chains: list, n_audio: int, sample_rate: float,
             block_seconds="auto", overlap_seconds="auto",
             max_packet_seconds=None) -> Geometry:
    """The bank geometry of chains that form one bank."""
    modem = stage("modems", chains[0].modem.kind)
    trim = modem.trim(modem.params(chains[0].modem))
    floor = _ACQ_COHERENT_FLOOR if modem.COHERENT else _ACQ_SECONDS_FLOOR
    acq = max(max(_ACQ_FLOOR_BY_SLICER.get(c.slicer.kind, floor)
                  for c in chains),
              max(_ACQ_SYMBOLS / c.slicer.symbol_rate for c in chains))
    packet = (max(_max_packet_seconds(c) for c in chains)
              if max_packet_seconds is None else float(max_packet_seconds))
    auto_overlap = acq + packet
    lane_seconds = _LANE_BUDGET_BYTES / (
        _TARGET_LANES * sample_rate * _F32_BYTES * 2.5)
    auto_block = max(3.0 * auto_overlap, lane_seconds - auto_overlap)
    block_s = auto_block if block_seconds == "auto" else float(block_seconds)
    overlap_s = auto_overlap if overlap_seconds == "auto" else float(overlap_seconds)
    block_len = max(int(block_s * sample_rate), 1)
    overlap = int(overlap_s * sample_rate)
    n_demod = n_audio - trim
    if block_len >= n_demod:
        block_len, overlap = max(n_demod, 1), 0
    input_len = block_len + overlap + trim
    per_block = max(len(chains) * input_len * modem.BYTES_PER_CHAIN_SAMPLE
                    * _F32_BYTES // 4, 1)
    g = max(int(_GROUP_BUDGET_BYTES // per_block), 1)
    n_blocks = -(-n_demod // block_len)
    n_groups = -(-n_blocks // g)
    per_group = -(-n_blocks // n_groups)
    cap = 16
    for c in chains:
        sps = c.slicer.sample_rate / c.slicer.symbol_rate
        nominal = (block_len + overlap) / sps * bits_per_symbol(c.slicer) / 8.0
        cap = max(cap, int(nominal * 1.5) + 16)
    return Geometry(n_audio, trim, block_len, overlap, per_group,
                    -(-cap // 8) * 8)


def block_frame(audio: np.ndarray, geo: Geometry, b: int) -> np.ndarray:
    """Block b's input samples (float64): the recording with ``overlap``
    zeros ahead of it and zeros after it."""
    start = b * geo.block_len - geo.overlap
    out = np.zeros(geo.input_len, np.float64)
    lo, hi = max(start, 0), min(start + geo.input_len, len(audio))
    if hi > lo:
        out[lo - start : hi - start] = audio[lo:hi]
    return out


def group_normal(audio: np.ndarray, geo: Geometry, g: int, bpf: np.ndarray,
                 arith: Arith) -> float:
    """A coherent bank's AGC normal for block group g: the signed max of
    the band-passed frames of the group's blocks."""
    b0 = g * geo.per_group
    b1 = min(b0 + geo.per_group, geo.n_blocks)
    start = b0 * geo.block_len - geo.overlap
    n = (b1 - 1 - b0) * geo.block_len + geo.input_len
    seg = np.zeros(n, np.float64)
    lo, hi = max(start, 0), min(start + n, len(audio))
    seg[lo - start : hi - start] = audio[lo:hi]
    seg, bpf = arith.operands(seg, bpf)
    # an FFT convolution: its float64 rounding (~1e-12 of the max) is far
    # below what the normal's use (the AGC's step sizes) can resolve
    return float(fftconvolve(seg, bpf, "valid").max())


def decode_lane(spec, geo: Geometry, b: int, frame: np.ndarray, normal: float,
                precision: str = "float64") -> list[tuple[tuple, int]]:
    """Packets of chain ``spec`` that block b keeps: [(bytes, address)]."""
    arith = Arith(precision)
    modem = stage("modems", spec.modem.kind)
    baseband = modem.baseband(spec.modem, modem.params(spec.modem), frame,
                              normal, arith)
    data, addr = stage("slicers", spec.slicer.kind).slice(
        spec.slicer, baseband, arith)
    data, addr = data[: geo.capacity], addr[: geo.capacity]
    if not data:
        return []
    raw = np.asarray(data, np.uint8)
    if spec.stream is not None:
        raw = stage("streams", spec.stream.kind).apply(spec.stream, raw)
    addresses = np.asarray(addr, np.int64) + b * geo.block_len - geo.overlap
    pkts = stage("codecs", spec.codec.kind).decode(spec.codec, raw, addresses)
    lo, hi = geo.keep_range(b)
    return [(tuple(int(v) for v in p.data), int(p.streamaddress))
            for p in pkts if lo < p.streamaddress <= hi]


def _lane_job(args):
    return decode_lane(*args)


def decode_lanes(lines: list[dict], sample_rate: float, audio: np.ndarray,
                 lanes: list[tuple[int, int]], geometry_kw: dict | None = None,
                 precision: str = "float64", workers: int | None = None
                 ) -> dict[tuple[int, int], list]:
    """Reference packets of each (chain index, block) lane, as
    ``decode_lane`` gives them.  The chains of ``lines`` form one bank."""
    chains = chains_from_lines(lines, sample_rate)
    audio = np.asarray(audio)
    geo = geometry(chains, len(audio), sample_rate, **(geometry_kw or {}))
    arith = Arith(precision)
    normals: dict[tuple[int, int], float] = {}
    jobs = []
    for c, b in lanes:
        spec = chains[c].modem
        modem = stage("modems", spec.kind)
        normal = 0.0
        if modem.COHERENT:
            key = (c, b // geo.per_group)
            if key not in normals:
                normals[key] = group_normal(
                    audio, geo, key[1], modem.params(spec).input_bpf, arith)
            normal = normals[key]
        jobs.append((chains[c], geo, b, block_frame(audio, geo, b), normal,
                     precision))
    workers = workers or min(len(jobs), os.cpu_count() or 1, 8)
    if workers <= 1:
        results = [_lane_job(j) for j in jobs]
    else:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
            results = list(ex.map(_lane_job, jobs))
    return dict(zip(lanes, results))
