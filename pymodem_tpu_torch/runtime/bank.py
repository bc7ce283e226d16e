"""Banked, block-parallel chain execution on one GPU.

Port of the parts of ``pymodem_tpu.runtime.bank`` that the AX.25 and IL2P
decode of every modem family (``afsk``, ``afsk_pll``, ``bpsk``, ``qpsk``,
``mpsk``, ``fsk``) runs on ``run_banked``, with the binary, quadrature and
four-level slicers:

* **Chain bank axis**: chains with the same static structure (modem family
  and parameter shapes, slicer, rates) stack into one bank, whose
  parameters carry a leading chain axis.
* **Time-block axis**: the recording is cut into overlapped blocks.  FIR
  stages read ``trim`` extra input samples per block (exact, like
  overlap-save); the recurrent stages (AGC, PLL, slicer clock) warm up in
  the ``overlap`` halo, which covers loop acquisition plus the longest
  packet, and each packet belongs to exactly one block by its stream
  address.  Sequential scans thus become ``chains x blocks`` independent
  lanes: one thread each in the loop and slicer kernels.

Per bank, every device stage runs on the GPU: framing (``unfold``), the
modem demod (FIRs on the ``dsp/fir.py`` engines, the whole of the ``fsk``
demod; the carrier loops as kernels K2 ``afsk_pll``, K3 ``bpsk``, K5
``qpsk`` and K6 ``mpsk``, the MPSK AGC as K4), the slicer (K1 binary, K7
quadrature, K8 four-level), compaction,
``descramble_bytes_multi`` and ``il2p_sync_candidates``.  Then one of two
codec routes:

* ``codec="device"`` (the default, as in the JAX package): the codecs run
  on the same device, one call per codec sub-group of chains (IL2P:
  ``codecs/il2p_device.py``; AX.25: ``codecs/ax25_device.py``, whose bit
  FSM is kernel K9), compact their packets into one buffer and read it
  back once; budgets that overflow escalate on the device, and only blocks
  still saturated after that go to the host state machines.
* ``codec="host"``: the byte streams and sync maps come back to the host,
  where the reference-exact AX.25 and IL2P state machines decode each
  block (``codecs/host.py``).

``PacketAggregate`` then correlates and reports.

Entry points: ``run_banked`` (one recording), ``run_banked_many`` (a stream
of recordings, pipelined: recording i+1's device work is queued before
recording i's packets are read back), ``run_banked_files`` (several
recordings in one dispatch per bank, their blocks stacked), and over a
``RunPlan`` ``run_plan_banked``, ``run_plan_banked_many`` and
``run_plans_banked_pipelined`` (jobs of different configs).  With
``resilient=True`` a failing bank is retried chain by chain through the
sequential executor (``runtime/executor.py``), on the same device and
kernels, and chains that still fail are skipped with a message.

Float64, the JAX package's parity mode: ``run_banked`` and
``run_plan_banked`` take ``dtype`` (None: the mode's,
``device.resolve_dtype``), as the JAX package's do.  At float64 the bank's
leaves, frames, basebands and slicer rows are float64; an AFSK space-gain
sweep demods per chain (no ``space_scale`` row, as the JAX package keeps
the reference operand order at f64), a coherent carrier sweep keeps
``pre_shared`` (bitwise equal to the per-chain form at any dtype); on the
card ``afsk_pll`` and ``bpsk`` banks run kernel K11 and the binary and
four-level slicers K10 and K12, the FIRs float64 DGEMMs.  ``qpsk`` and
``mpsk`` banks are refused at float64 on the card (their f64 kernels are
not yet ported: ``modems.check_f64_kernels``); on the CPU every family
runs at float64 through the twins.  The integer stages (compaction,
descramble, sync, the device codecs, K9) are the same at both dtypes.
``run_banked_many``, ``run_banked_files``, ``run_plan_banked_many`` and
``run_plans_banked_pipelined`` run float32 only so far, and raise at
float64 (``_float32_only``).

Deliberate differences from the JAX package: block geometry drops the TPU
lane-tile snapping of ``plan_bank_run``, and the device codec route drops
its TPU tiling and per-group pipelining.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import modems
from ..config import ChainSpec
from ..convert import bank_params_from_jax
from ..device import constant, resolve, resolve_dtype, upload
from ..dsp import window_design as wd
from ..dsp.agc import agc_lanes
from ..dsp.fir import fir_valid_multi, fir_valid_nd, fir_valid_per_chain
from ..dsp.loops import (
    afsk_pll_lanes,
    agc_lane_params,
    bpsk_costas_lanes,
    lane_params_from_loop,
    mpsk_loop_lanes,
    qpsk_costas_lanes,
)
from ..ops.lfsr import descramble_bytes_multi
from ..ops.slicers import (
    binary_slice_lanes,
    compact_bytes,
    compact_windowed,
    decode_emissions,
    four_level_slice_lanes,
    quadrature_slice_lanes,
    safe_compact_window,
)
from ..ops.sync import _POPCOUNT8, il2p_sync_candidates, pack_bits
from .executor import RunResult

# ---------------------------------------------------------------------------
# Block plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockPlan:
    """Time-block layout over the demodulated stream (copied from the JAX
    package, plain Python).

    Block ``b`` computes demod indices ``[b*block_len - overlap,
    b*block_len + block_len)``; the leading ``overlap`` is warm-up halo and
    packets are kept only when their stream address lands in
    ``(b*block_len, (b+1)*block_len]``.  ``up > 1`` models AFSK
    output_oversample: ``block_len``/``overlap`` stay in demod units
    (multiples of ``up``), ``trim`` is the input-rate FIR trim before the
    polyphase upsample and ``trim_post`` the demod-rate trim after it.
    """

    n_audio: int
    trim: int  # input-rate FIR trim of the modem cascade (sum of taps-1)
    block_len: int
    overlap: int
    up: int = 1  # demod-output rate multiple (AFSK output_oversample)
    trim_post: int = 0  # demod-rate FIR trim after the upsample (up > 1)

    @property
    def n_demod(self) -> int:
        if self.up == 1:
            return self.n_audio - self.trim
        return (self.n_audio - self.trim) * self.up - self.trim_post

    @property
    def n_blocks(self) -> int:
        return -(-self.n_demod // self.block_len)

    @property
    def stride_in(self) -> int:
        """Input samples between consecutive block starts."""
        return self.block_len // self.up

    @property
    def front_pad(self) -> int:
        """Zero pad ahead of the audio (block 0's halo), input units."""
        return self.overlap // self.up + (10 if self.up > 1 else 0)

    @property
    def block_input_len(self) -> int:
        if self.up == 1:
            return self.block_len + self.overlap + self.trim
        return (
            (self.block_len + self.overlap) // self.up + self.trim
            + 20 + -(-self.trim_post // self.up)
        )

    def keep_range(self, b: int) -> tuple[int, int]:
        """(lo, hi]: stream addresses owned by block b (1-based addresses)."""
        lo = b * self.block_len
        return lo, min(lo + self.block_len, self.n_demod)


def overlapped_frames(window: torch.Tensor, n_blocks: int, stride: int,
                      ext: int) -> torch.Tensor:
    """(n_blocks*stride + ext,) window -> (n_blocks, stride + ext)
    overlapped frames, stride ``stride``.  ``unfold`` returns a view, so
    nothing is copied; the window keeps its wire dtype (int16) until the
    caller casts the frames."""
    return window[: n_blocks * stride + ext].unfold(0, stride + ext, stride)


def frame_blocks(audio: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """(n,) -> (n_blocks, block_input_len) overlapped frames, stride
    ``stride_in``: front-padded with block 0's halo, tail-padded to fill the
    last block (``overlapped_frames`` of the padded recording)."""
    ext = plan.block_input_len - plan.stride_in
    total = plan.n_blocks * plan.stride_in + ext
    padded = F.pad(audio, (plan.front_pad,
                           total - plan.front_pad - plan.n_audio))
    return overlapped_frames(padded, plan.n_blocks, plan.stride_in, ext)


# ---------------------------------------------------------------------------
# Bank grouping
# ---------------------------------------------------------------------------


@dataclass
class Bank:
    """A group of chains executable as one batched device program."""

    kind: str  # modem family
    specs: list[ChainSpec]
    params: Any  # dict of tensors with a leading chain axis on every leaf
    trim: int
    slicer_kind: str
    # per-chain descrambler settings -- data, not grouping keys
    # (ops/lfsr.descramble_bytes_multi)
    stream_polys: tuple[int, ...] = ()
    stream_inverts: tuple[bool, ...] = ()
    up: int = 1
    trim_post: int = 0
    dtype: torch.dtype = torch.float32  # of the leaves, frames, basebands


def _modem_geometry(kind: str, p) -> tuple[int, int, int]:
    """(input-rate trim, demod-rate trim_post, up) for the block plan: the
    sum of the modem cascade's FIR trims (taps - 1 each)."""
    if kind == "afsk" and p.oversample > 1:
        trim_pre = (p.input_bpf.shape[-1] - 1) + (p.mark_i.shape[-1] - 1)
        return trim_pre, p.output_lpf.shape[-1] - 1, int(p.oversample)
    if kind == "afsk":
        taps = (p.input_bpf, p.mark_i, p.output_lpf)
    elif kind == "afsk_pll":
        taps = (p.input_bpf, p.output_lpf)
    elif kind in ("bpsk", "qpsk"):
        taps = (p.input_bpf, p.rrc)
    elif kind == "fsk":
        taps = (p.input_lpf,)
    else:  # mpsk: the Hilbert FIR sits between the AGC and the loop
        taps = (p.input_bpf, p.hilbert, p.rrc)
    return sum(t.shape[-1] - 1 for t in taps), 0, 1


def _chain_device_params(chain: ChainSpec, np_dtype=np.float32) -> dict:
    """Per-chain numpy leaves, floats at ``np_dtype`` (float32, or float64
    in the parity mode): modem + loop + slicer constants, in the JAX
    package's pytree layout."""
    f = np.dtype(np_dtype).type

    def to_host(a):
        a = np.asarray(a)
        return a.astype(np_dtype) if a.dtype.kind == "f" else a

    spec = chain.modem
    mp = modems.build_params(spec)
    modem = {k: to_host(v) for k, v in mp._asdict().items() if k != "agc"}
    d: dict[str, Any] = {"modem": modem}
    if spec.kind in _COHERENT_KINDS:
        modem["agc"] = {k: to_host(v) for k, v in mp.agc._asdict().items()}
        d["loop"] = {k: to_host(v) for k, v in
                     modems._loop_params_host(spec)._asdict().items()}
    if spec.kind == "qpsk":
        b0, a1 = wd.iir1_lpf_coefs(spec.sample_rate, spec.branch_lpf_cutoff,
                                   1.0)
        d["branch_b0"] = f(b0)
        d["branch_a1"] = f(a1)
    if spec.kind == "mpsk":
        d["pd_granularity"] = np.int32(spec.pd_granularity)
        d["pd_gain"] = f(spec.pd_gain)
    if spec.kind == "fsk":
        # invert as a sign multiplier, so that banks mix inverted chains
        modem["sign"] = f(-1.0 if spec.invert else 1.0)
        del modem["invert"]
    sl = chain.slicer
    d["sps"] = f(sl.sample_rate / sl.symbol_rate)
    d["lock_rate"] = f(sl.lock_rate)
    if sl.kind in ("quadrature", "4level"):
        d["demap"] = np.asarray(sl.demap, dtype=np.int32)
    return d


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _afsk_shared_scales(specs: list[ChainSpec]):
    """(C,) space-gain ratios when an AFSK bank is a pure space_gain sweep
    (every other modem field equal, all gains > 0): then the demod is linear
    in the gain, and one chain's convolutions plus a per-chain
    ``mark - s_c * space`` combine replace C demods.  None otherwise."""
    if len(specs) < 2:
        return None
    fields = (
        "sample_rate", "symbol_rate", "correlator_span", "correlator_offset",
        "mark_freq", "space_freq", "input_bpf_low_cutoff",
        "input_bpf_high_cutoff", "input_bpf_span", "output_lpf_cutoff",
        "output_lpf_span", "output_oversample",
    )
    m0 = specs[0].modem
    for c in specs[1:]:
        if any(getattr(c.modem, k) != getattr(m0, k) for k in fields):
            return None
    g0 = float(m0.space_gain)
    gains = [float(c.modem.space_gain) for c in specs]
    if g0 <= 0 or any(g <= 0 for g in gains):
        return None
    return np.asarray([g / g0 for g in gains])


def group_chains_host(chains: list[ChainSpec],
                      np_dtype=np.float32) -> list[tuple]:
    """[(kind, specs, numpy pytree, trim, trim_post, up)] per bank, in the
    JAX package's grouping and leaf layout, floats at ``np_dtype``."""
    banks: dict[tuple, list] = {}
    for chain in chains:
        params = _chain_device_params(chain, np_dtype)
        sl = chain.slicer
        shapes = tuple((np.shape(v), str(np.asarray(v).dtype))
                       for v in _leaves(params))
        slicer_static = (sl.kind, getattr(sl, "bits_per_symbol", None),
                         getattr(sl, "state_mask", None),
                         getattr(sl, "demap", None))
        rates = (chain.modem.sample_rate, sl.sample_rate, sl.symbol_rate)
        # one phase-detector granularity per bank (the JAX package keys it
        # through the shape of its pd_table leaf, which the port drops)
        key = (chain.modem.kind, shapes, slicer_static, rates,
               getattr(chain.modem, "pd_granularity", None))
        banks.setdefault(key, []).append((chain, params))
    out = []
    for members in banks.values():
        specs = [c for c, _ in members]
        kind = specs[0].modem.kind
        tree = _stack([p for _, p in members])
        if kind == "afsk" and np.dtype(np_dtype) != np.float64:
            # f64 keeps the per-chain operand order of the reference, as
            # the JAX package's f64 bank does (no scale row)
            scales = _afsk_shared_scales(specs)
            if scales is not None:
                tree["space_scale"] = scales.astype(np_dtype)
        elif kind in _COHERENT_KINDS and len(specs) >= 2 and all(
            bool(np.all(leaf == leaf[:1])) for leaf in _leaves(tree["modem"])
        ):
            # coherent carrier sweep: every modem leaf identical, so the
            # pre-loop stages (BPF; for mpsk also the AGC and the Hilbert
            # FIR) run once and broadcast, bitwise equal to the per-chain
            # form.  The mpsk detector gain is not a modem leaf, so a gain
            # sweep shares too (the JAX package's pd_table leaf keeps such
            # a sweep per chain there)
            tree["pre_shared"] = np.ones(len(specs), np_dtype)
        trim, trim_post, up = _modem_geometry(
            kind, modems.build_params(specs[0].modem))
        out.append((kind, specs, tree, trim, trim_post, up))
    return out


def group_chains(chains: list[ChainSpec],
                 device: str | torch.device = "cuda",
                 dtype=torch.float32) -> list[Bank]:
    """Group chains into banks keyed by their static structure; parameters
    become ``dtype`` (float32 or float64) tensors on ``device``
    (convert.bank_params_from_jax)."""
    dev = resolve(device)
    dtype = resolve_dtype(dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return [
        Bank(
            kind=kind, specs=specs,
            params=bank_params_from_jax(tree, device=dev), trim=trim,
            slicer_kind=specs[0].slicer.kind,
            stream_polys=tuple(c.stream.polynomial if c.stream else 0
                               for c in specs),
            stream_inverts=tuple(bool(c.stream.invert) if c.stream else False
                                 for c in specs),
            up=up, trim_post=trim_post, dtype=dtype,
        )
        for kind, specs, tree, trim, trim_post, up
        in group_chains_host(chains, np_dtype)
    ]


# ---------------------------------------------------------------------------
# Per-family demodulation (all chains x blocks of a bank)
# ---------------------------------------------------------------------------


def _afsk_tail(diff: torch.Tensor, m: dict, c: int) -> torch.Tensor:
    """The (linear) oversample + output-LPF tail of chain c's AFSK demod.
    With output_oversample (afsk.py:164-165) the block halo supplies the
    neighbour samples scipy's resample_poly zero-pads for: an unpadded
    zero-stuff plus valid convolutions (BlockPlan)."""
    n_rs = m["resample_taps"].shape[-1]
    if n_rs == 0:
        return fir_valid_nd(diff, m["output_lpf"][c])
    up = (n_rs - 1) // 20
    n = diff.shape[-1]
    stuffed = diff.new_zeros(diff.shape[:-1] + (n * up,))
    stuffed[..., ::up] = diff
    y = fir_valid_nd(stuffed, m["resample_taps"][c])
    y = fir_valid_nd(y, m["output_lpf"][c])
    t_post = m["output_lpf"].shape[-1] - 1
    return y[..., : (n - 20 - -(-t_post // up)) * up]


def _afsk_correlate(m: dict, blocks: torch.Tensor, c: int):
    """Chain c's band-pass + quadrature tone correlators -> (mark, space)
    magnitudes over (B, L) blocks."""
    x = fir_valid_nd(blocks, m["input_bpf"][c])
    corr = torch.stack([m["mark_i"][c], m["mark_q"][c],
                        m["space_i"][c], m["space_q"][c]])
    mi, mq, si, sq = fir_valid_multi(x, corr)
    return torch.sqrt(mi * mi + mq * mq), torch.sqrt(si * si + sq * sq)


def afsk_bank_demod(params: dict, blocks: torch.Tensor) -> torch.Tensor:
    """(B, Lin) blocks -> (C, B, L2) AFSK basebands.

    A pure space_gain sweep (``space_scale``) demods ONE chain and combines
    per chain as ``mark - s_c * space`` (s_c the gain ratio to row 0),
    exactly as the JAX package's f32 path; other banks demod per chain."""
    m = params["modem"]
    if "space_scale" in params:
        mark, space = _afsk_correlate(m, blocks, 0)
        mark_f, space_f = _afsk_tail(mark, m, 0), _afsk_tail(space, m, 0)
        scales = params["space_scale"]
        s = (scales / scales[0]).reshape(-1, 1, 1).to(mark_f.dtype)
        return mark_f[None] - s * space_f[None]
    out = []
    for c in range(m["input_bpf"].shape[0]):
        mark, space = _afsk_correlate(m, blocks, c)
        out.append(_afsk_tail(mark - space, m, c))
    return torch.stack(out)


def _input_bpf(params: dict, blocks: torch.Tensor):
    """A coherent bank's input band-pass: ((C, B, L1) per-chain streams,
    (C,) AGC normals).  The ``normal`` is each chain's signed max over
    every block (agc.py:67); a ``pre_shared`` carrier sweep runs the FIR
    once and broadcasts it, a view."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    if "pre_shared" in params:
        x1 = fir_valid_nd(blocks, m["input_bpf"][0])
        return x1[None].expand(C, *x1.shape), x1.max().expand(C)
    x = fir_valid_multi(blocks, m["input_bpf"])
    return x, x.amax(dim=(1, 2))


def _coherent_lane_params(params: dict, normals: torch.Tensor, C: int,
                          B: int) -> torch.Tensor:
    """The (n, C*B) lane rows of kernels K2, K3, K5 and K11, at the
    normals' dtype: the loop's 10, for ``qpsk`` the branch IIR's
    ``branch_b0`` and ``branch_a1``, then the fused AGC's 5."""
    dtype = normals.dtype
    branch = [params[k].to(dtype).reshape(C).repeat_interleave(B)
              [None] for k in ("branch_b0", "branch_a1") if k in params]
    return torch.cat([
        lane_params_from_loop(params["loop"], C, B, dtype),
        *branch,
        agc_lane_params(params["modem"]["agc"], normals, C, B, dtype),
    ]).contiguous()


def _shared_rows(x: torch.Tensor, shared: bool):
    """(C, B, T) lane streams -> the input rows a loop kernel reads and each
    lane's row (C*B,) int32: a ``pre_shared`` bank's B shared rows once
    (lane c*B + b reads row b), not C copies of them; any other bank's C*B
    rows.  Contiguous: the staged kernels copy whole 16-byte-aligned rows
    in bulk."""
    C, B, T = x.shape
    if shared:
        rows, row_of_lane = x[0], torch.arange(B, dtype=torch.int32,
                                               device=x.device).repeat(C)
    else:
        rows, row_of_lane = x.reshape(C * B, T), torch.arange(
            C * B, dtype=torch.int32, device=x.device)
    return rows.contiguous(), row_of_lane


def coherent_loop_inputs(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the inputs of kernels K2, K3 and K5 for all C*B
    lanes: the band-passed input rows, the (15 or 17, C*B) lane rows and
    each lane's input row (C*B,) int32 (``_shared_rows``)."""
    x, normals = _input_bpf(params, blocks)
    C, B, _ = x.shape
    rows, row_of_lane = _shared_rows(x, "pre_shared" in params)
    return rows, _coherent_lane_params(params, normals, C, B), row_of_lane


def afsk_pll_bank_demod(params: dict, blocks: torch.Tensor) -> torch.Tensor:
    """(B, Lin) blocks -> (C, B, L2) AFSK-PLL basebands: band-pass FIR, then
    the AGC follower and the PLL as ONE pass of kernel K2 over all C*B
    lanes, then the per-chain output LPF."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    x, lane_params, row_of_lane = coherent_loop_inputs(params, blocks)
    demod = afsk_pll_lanes(x, lane_params, params["sine_table"],
                           row_of_lane)
    return fir_valid_per_chain(demod.reshape(C, -1, x.shape[-1]),
                               m["output_lpf"])


def bpsk_bank_demod(params: dict, blocks: torch.Tensor) -> torch.Tensor:
    """(B, Lin) blocks -> (C, B, L2) BPSK basebands: band-pass FIR, then
    the AGC follower and the Costas loop as ONE pass of kernel K3 over all
    C*B lanes, then the per-chain RRC."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    x, lane_params, row_of_lane = coherent_loop_inputs(params, blocks)
    demod = bpsk_costas_lanes(x, lane_params, params["sine_table"],
                              params["cos_table"], row_of_lane)
    return fir_valid_per_chain(demod.reshape(C, -1, x.shape[-1]), m["rrc"])


def qpsk_bank_demod(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the (i, q) Costas-QPSK basebands, each (C, B, L2):
    band-pass FIR, then the AGC follower and the Costas loop with its
    branch IIRs as ONE pass of kernel K5 over all C*B lanes, then the
    per-chain RRC on both rails.  I is the sine branch, Q the cosine
    branch (psk.py:453-454).  A pre-shared sweep's lanes read its B shared
    band-passed rows."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    x, lane_params, row_of_lane = coherent_loop_inputs(params, blocks)
    i_d, q_d = qpsk_costas_lanes(x, lane_params, params["sine_table"],
                                 params["cos_table"], row_of_lane)
    L1 = x.shape[-1]
    return (fir_valid_per_chain(i_d.reshape(C, -1, L1), m["rrc"]),
            fir_valid_per_chain(q_d.reshape(C, -1, L1), m["rrc"]))


def fsk_bank_demod(params: dict, blocks: torch.Tensor) -> torch.Tensor:
    """(B, Lin) blocks -> (C, B, L2) FSK basebands: each chain's input
    filter times its ``sign`` (fsk.py:149-159), all C filters in one pass
    over the shared blocks.  The sign goes into the taps: negating every
    term of a sum negates the rounded sum exactly, so this equals the JAX
    package's filter-then-multiply value for value (an exact zero may take
    the other sign, which no slicer comparison tells apart) and saves a
    copy of the basebands."""
    m = params["modem"]
    taps = m["input_lpf"] * m["sign"].to(m["input_lpf"].dtype)[:, None]
    return fir_valid_multi(blocks, taps)


def mpsk_agc_inputs(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the inputs of kernel K4 for an MPSK bank: the
    band-passed lanes and their (5, lanes) AGC rows.  A ``pre_shared``
    sweep hands over its B shared lanes with chain 0's AGC rows; any other
    bank all C*B lanes."""
    m = params["modem"]
    x, normals = _input_bpf(params, blocks)
    C, B, L1 = x.shape
    if "pre_shared" in params:
        agc0 = {k: v[:1] for k, v in m["agc"].items()}
        rows = agc_lane_params(agc0, normals[:1], 1, B, x.dtype)
        return x[0].contiguous(), rows.contiguous()
    rows = agc_lane_params(m["agc"], normals, C, B, x.dtype)
    return x.reshape(C * B, L1).contiguous(), rows.contiguous()


def mpsk_analytic(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the MPSK analytic signal (real, imag), each
    (C, B, L2): band-pass FIR, the AGC follower (kernel K4), the Hilbert
    FIR for the imaginary rail and its delay for the real one
    (psk.py:714-716).  A ``pre_shared`` sweep runs K4 and the Hilbert FIR
    once over its B shared lanes, then broadcasts."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    lanes, rows = mpsk_agc_inputs(params, blocks)
    B = blocks.shape[0]
    xa = agc_lanes(lanes, rows)
    delay = (m["hilbert"].shape[-1] - 1) // 2
    if "pre_shared" in params:
        imag = fir_valid_nd(xa, m["hilbert"][0])
        real = xa[..., delay:-delay] if delay else xa
        return (real[None].expand(C, *real.shape),
                imag[None].expand(C, *imag.shape))
    xa = xa.reshape(C, B, -1)
    imag = fir_valid_per_chain(xa, m["hilbert"])
    real = xa[..., delay:-delay] if delay else xa
    return real, imag


def mpsk_loop_inputs(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the inputs of kernel K6 for all C*B lanes: the
    analytic (real, imag) input rows, (12, C*B) lane rows (the loop's, then
    pd_gain and pd_granularity), the bank's distinct phase-detector tables
    (U, g*g) int32, each lane's table (C*B,) int32 and each lane's input
    row (C*B,) int32.  A ``pre_shared`` sweep hands over its B shared rows
    once (lane c*B + b reads row b), not C copies of them; any other bank
    its C*B rows."""
    real, imag = mpsk_analytic(params, blocks)
    C, B, _ = real.shape
    shared = "pre_shared" in params
    real, row_of_lane = _shared_rows(real, shared)
    imag, _ = _shared_rows(imag, shared)

    def rep(leaf):
        return leaf.to(real.dtype).reshape(C).repeat_interleave(B)

    lane_params = torch.cat([
        lane_params_from_loop(params["loop"], C, B, real.dtype),
        torch.stack([rep(params["pd_gain"]), rep(params["pd_granularity"])]),
    ]).contiguous()
    tables, chain_table = torch.unique(params["pd_error_table"], dim=0,
                                       return_inverse=True)
    pd_index = chain_table.to(torch.int32).repeat_interleave(B)
    return (real, imag, lane_params, tables.contiguous(),
            pd_index.contiguous(), row_of_lane)


def mpsk_bank_demod(params: dict, blocks: torch.Tensor):
    """(B, Lin) blocks -> the (i, q) MPSK basebands, each (C, B, L3): the
    analytic signal, the carrier loop as ONE pass of kernel K6 over all C*B
    lanes (a pre-shared sweep's lanes reading its B shared rows), then the
    per-chain RRC on both rails."""
    m = params["modem"]
    C = m["input_bpf"].shape[0]
    re, im, lane_params, tables, pd_index, row_of_lane = mpsk_loop_inputs(
        params, blocks)
    i_d, q_d = mpsk_loop_lanes(re, im, lane_params, params["sine_table"],
                               params["cos_table"], tables, pd_index,
                               row_of_lane)
    L2 = re.shape[-1]
    return (fir_valid_per_chain(i_d.reshape(C, -1, L2), m["rrc"]),
            fir_valid_per_chain(q_d.reshape(C, -1, L2), m["rrc"]))


_DEMODS = {"afsk": afsk_bank_demod, "afsk_pll": afsk_pll_bank_demod,
           "bpsk": bpsk_bank_demod, "qpsk": qpsk_bank_demod,
           "mpsk": mpsk_bank_demod, "fsk": fsk_bank_demod}


def bank_basebands(bank: Bank, blocks: torch.Tensor):
    """(B, Lin) frames at the bank's dtype -> (C, B, L2) demodulated
    basebands, or an (i, q) pair of them for ``qpsk`` and ``mpsk``."""
    return _DEMODS[bank.kind](bank.params, blocks)


def slicer_lane_params(bank: Bank, blocks_per_chain: int) -> torch.Tensor:
    """(2, C*B) rows (sps, lock_rate) at the bank's dtype for kernels K1,
    K7 and K8 (K10 and K12 at float64)."""
    p = bank.params
    return torch.stack([
        p["sps"].repeat_interleave(blocks_per_chain),
        p["lock_rate"].repeat_interleave(blocks_per_chain),
    ]).to(bank.dtype).contiguous()


def _bits_per_symbol(slicer) -> int:
    """Bits per symbol decision: the quadrature slicer's field, 2 for the
    four-level slicer (which has no such field), else 1."""
    return getattr(slicer, "bits_per_symbol",
                   2 if slicer.kind == "4level" else 1)


def slice_lanes(bank: Bank, basebands, window: int) -> torch.Tensor:
    """Basebands -> the (C, B, ceil(L/window)) int32 emission stream: kernel
    K1 (binary) or K8 (four-level) over the C*B lanes of a real baseband,
    K7 over the lane pairs of an (i, q) one.  The demap (and the quadrature
    slicer's state mask and bits per decision) are bank-uniform, part of
    the grouping key.  K1 and K8 take the lanes as rows of the basebands
    as they lie (a FIR's matmul output keeps rows a tile multiple apart),
    so a bank whose T is not a multiple of 4 copies no rows."""
    pair = isinstance(basebands, tuple)
    C, B, L2 = (basebands[0] if pair else basebands).shape
    rows = slicer_lane_params(bank, B)

    def lanes(t):
        return t.reshape(C * B, L2).contiguous()

    if bank.slicer_kind == "binary":
        enc = binary_slice_lanes(basebands.reshape(C * B, L2), rows,
                                 window=window)
    elif bank.slicer_kind == "4level":
        enc = four_level_slice_lanes(basebands.reshape(C * B, L2), rows,
                                     bank.specs[0].slicer.demap,
                                     window=window)
    else:
        sl = bank.specs[0].slicer
        enc = quadrature_slice_lanes(
            lanes(basebands[0]), lanes(basebands[1]), rows, sl.demap,
            sl.state_mask, _bits_per_symbol(sl), window=window)
    return enc.reshape(C, B, -1)


def bank_frames_compute(bank: Bank, blocks: torch.Tensor, capacity: int,
                        window: int, sync_tolerance: int):
    """(B, Lin) frames at the bank's dtype -> per-chain (C, B, cap)
    descrambled bytes (uint8), addresses (int32), counts (C, B) and the
    packed IL2P sync candidate map (C, B, cap) uint8."""
    enc = slice_lanes(bank, bank_basebands(bank, blocks), window)
    if window > 1:
        data, addr, count = compact_windowed(enc, window, capacity)
    else:
        data, addr, count = compact_bytes(decode_emissions(enc), capacity)
    data = descramble_bytes_multi(data.to(torch.uint8), bank.stream_polys,
                                  bank.stream_inverts)
    sync = il2p_sync_candidates(data, sync_tolerance)
    return data, addr, count, pack_bits(sync)


def bank_device_step_stream(bank: Bank, tail: torch.Tensor,
                            fresh: torch.Tensor, n_blocks: int, stride: int,
                            ext: int, capacity: int, window: int,
                            sync_tolerance: int):
    """A streaming step with a device-resident audio tail.

    The step window is ``cat(tail, fresh)`` on the device: ``tail`` (ext
    samples) is the previous step's overlap+trim halo, returned by the
    previous call and never read back, and ``fresh`` the ``n_blocks *
    stride`` new input samples, so in steady state only new samples cross
    to the card, in their wire dtype.  The window is framed into
    ``n_blocks`` overlapped frames (``overlapped_frames``) that go through
    ``bank_frames_compute`` as float32.  Returns its (data, addr, count,
    sync) and the next step's tail, the window's last ``ext`` samples,
    still on the device."""
    win = torch.cat((tail, fresh))
    frames = overlapped_frames(win, n_blocks, stride, ext)
    out = bank_frames_compute(bank, frames.to(torch.float32), capacity,
                              window, sync_tolerance)
    return out + (win[n_blocks * stride:].clone(),)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

# Warm-up floors for the recurrent stages (AGC attack, PLL lock, slicer
# clock), as validated for the JAX package (bank.py, parity matrix): the
# longer of a fixed settle time and ~192 symbol periods; coherent families
# acquire on absolute time scales.
_ACQ_SECONDS_FLOOR = 0.35
_ACQ_SYMBOLS = 192.0
_ACQ_COHERENT_FLOOR = 1.25
_COHERENT_KINDS = ("afsk_pll", "bpsk", "qpsk", "mpsk")
# the four-level slicer learns its decision threshold from sync patterns
# on absolute time scales too (the JAX package's validated floor)
_ACQ_FLOOR_BY_SLICER = {"4level": 1.2}
# Block length: long enough that the halo tax (block+overlap)/block stays
# <= 4/3, and otherwise sized so _TARGET_LANES lanes of one bank hold
# _LANE_BUDGET_BYTES of working set (2.5 live copies per sample, of 4
# bytes, or 8 at float64).
_TARGET_LANES = 2048
_LANE_BUDGET_BYTES = 3e9
# Block groups: a bank runs all its blocks in one pass unless its working
# set would pass _GROUP_BUDGET_BYTES of the 80 GB card.  The working set
# per chain and input sample, by family, is what the demod holds at its
# peak: the f32 streams on the chain axis alive together (4 bytes each) and
# the banded-matmul FIR's framed copy of its input ((128 + taps - 1)/128
# streams: ~2 for the 133-tap PLL LPF, ~3 for a 44.1 kHz RRC).  Rounded up
# from the peaks chip_smoke.py prints per bank (PERF.md); twice these at
# float64 (``blocks_per_group``).
_GROUP_BUDGET_BYTES = 16e9
_BYTES_PER_CHAIN_SAMPLE = {
    # basebands, a chain's four correlator streams, their magnitudes
    "afsk": 16,
    # the C-filter product and its chain-major copy (the sign rides in the
    # taps) and the slicer's lanes, ~9; but at 9600 bit/s the sync scan's
    # int64 windows over the byte slots (~400 B each) peak higher: measured
    # FSK-9600 sweep 8.9, 4FSK sweep 16.4 (two bits a decision)
    "fsk": 24,
    # loop lanes, loop output, the output FIR's frames (~2-3) and output;
    # the B-sized frames weigh more in a bank of few chains (measured: PLL
    # pair 32.0, PLL sweep 26.8, BPSK-1200 sweep at 44.1 kHz 28.3)
    "afsk_pll": 40,
    "bpsk": 32,
    # band-passed lanes, K4's output, the Hilbert output, real and imag
    # lanes, the loop's two outputs, the RRC frames (~3) and outputs
    # (QPSK sweep 40.4 and MPSK pair 43.3 measured)
    "mpsk": 48,
    # loop lanes, the loop's two outputs, the RRC frames (~2) and outputs
    # of both rails, the slicer's contiguous lane pairs (Costas QPSK sweep
    # 32.8 measured)
    "qpsk": 48,
}


def _chain_bit_rate(chain: ChainSpec) -> float:
    return chain.slicer.symbol_rate * _bits_per_symbol(chain.slicer)


def _protocol_max_packet_seconds(chain: ChainSpec) -> float:
    """Wire time of the codec's longest packet at the chain's bit rate:
    what the block overlap must cover so that no protocol-legal packet
    straddles a boundary unseen.  AX.25: max_packet_length decoded bytes
    (ax25.py:15) at the worst-case HDLC stuffing of 6/5, plus flags.  IL2P:
    sync(3) + header(15) + 1023 payload + 16 parity per 239-byte block +
    CRC(4) bytes."""
    codec = chain.codec
    if codec.kind == "ax25":
        wire_bits = codec.max_packet_length * 8 * 1.2 + 32
    else:
        payload = 1023
        wire_bits = (3 + 15 + payload + -(-payload // 239) * 16 + 4) * 8
    return wire_bits / _chain_bit_rate(chain)


def bank_auto_geometry(bank: Bank, sample_rate: float,
                       max_packet_seconds: float | None = None
                       ) -> tuple[float, float]:
    """(block_seconds, overlap_seconds) for one bank.  The overlap covers
    loop acquisition plus the longest packet (the protocol maximum unless
    the caller bounds its traffic with ``max_packet_seconds``)."""
    floor = (_ACQ_COHERENT_FLOOR if bank.kind in _COHERENT_KINDS
             else _ACQ_SECONDS_FLOOR)
    acq = max(max(_ACQ_FLOOR_BY_SLICER.get(c.slicer.kind, floor)
                  for c in bank.specs),
              max(_ACQ_SYMBOLS / c.slicer.symbol_rate for c in bank.specs))
    if max_packet_seconds is None:
        packet = max(_protocol_max_packet_seconds(c) for c in bank.specs)
    else:
        packet = float(max_packet_seconds)
    overlap = acq + packet
    lane_seconds = _LANE_BUDGET_BYTES / (
        _TARGET_LANES * sample_rate * bank.up * bank.dtype.itemsize * 2.5)
    return max(3.0 * overlap, lane_seconds - overlap), overlap


def resolve_bank_geometry(bank: Bank, sample_rate: float, block_seconds,
                          overlap_seconds,
                          max_packet_seconds: float | None = None
                          ) -> tuple[float, float]:
    """Resolve 'auto' block/overlap requests to concrete per-bank seconds."""
    if block_seconds == "auto" or overlap_seconds == "auto":
        auto_block, auto_ov = bank_auto_geometry(bank, sample_rate,
                                                 max_packet_seconds)
        if block_seconds == "auto":
            block_seconds = auto_block
        if overlap_seconds == "auto":
            overlap_seconds = auto_ov
    return float(block_seconds), float(overlap_seconds)


def _block_geometry(sample_rate: float, up: int, block_seconds: float,
                    overlap_seconds: float) -> tuple[int, int]:
    """(block_len, overlap) in demod units (``up`` times the input rate),
    each a whole number of input samples: the block rounded up, the
    overlap down."""
    demod_rate = sample_rate * up
    block_len = -(-max(int(block_seconds * demod_rate), up) // up) * up
    return block_len, int(overlap_seconds * demod_rate) // up * up


def default_block_plan(n_audio: int, trim: int, sample_rate: float,
                       block_seconds: float = 16.0,
                       overlap_seconds: float = 6.0, up: int = 1,
                       trim_post: int = 0) -> BlockPlan:
    """Block layout in demod units (``up`` times the input rate, block
    starts on input-sample phases); one block when the recording is
    shorter than a block."""
    block_len, overlap = _block_geometry(sample_rate, up, block_seconds,
                                         overlap_seconds)
    n_demod = (n_audio - trim) * up - trim_post
    if block_len >= n_demod:
        one = -(-max(n_demod, 1) // up) * up
        return BlockPlan(n_audio, trim, one, 0, up, trim_post)
    return BlockPlan(n_audio, trim, block_len, overlap, up, trim_post)


def bank_plan(bank: Bank, n_audio: int,
              block_seconds: float | str = "auto",
              overlap_seconds: float | str = "auto",
              max_packet_seconds: float | None = None) -> BlockPlan:
    """The bank's block plan over an ``n_audio``-sample recording."""
    rate = bank.specs[0].modem.sample_rate
    block_s, overlap_s = resolve_bank_geometry(
        bank, rate, block_seconds, overlap_seconds, max_packet_seconds)
    return default_block_plan(n_audio, bank.trim, rate, block_s, overlap_s,
                              bank.up, bank.trim_post)


def blocks_per_group(bank: Bank, plan: BlockPlan,
                     n_blocks: int | None = None) -> int:
    """Blocks per device pass, so a pass's working set stays under
    _GROUP_BUDGET_BYTES; balanced so the last group is not mostly empty.
    ``n_blocks``: the blocks of the dispatch (default ``plan.n_blocks``;
    run_banked_files stacks several recordings' blocks)."""
    n_blocks = plan.n_blocks if n_blocks is None else n_blocks
    per_block = max(len(bank.specs) * plan.block_input_len * plan.up
                    * _BYTES_PER_CHAIN_SAMPLE[bank.kind]
                    * bank.dtype.itemsize // 4, 1)
    g = max(int(_GROUP_BUDGET_BYTES // per_block), 1)
    n_groups = -(-n_blocks // g)
    return -(-n_blocks // n_groups)


def slicer_window(bank: Bank) -> int:
    """The bank's emission window: the smallest safe window over its
    chains (ops/slicers.safe_compact_window)."""
    return min(
        safe_compact_window(c.slicer.sample_rate / c.slicer.symbol_rate,
                            c.slicer.lock_rate, _bits_per_symbol(c.slicer))
        for c in bank.specs
    )


def bank_capacity(bank: Bank, plan: BlockPlan) -> int:
    """Byte slots per (chain, block): 1.5x the nominal byte count + 16."""
    cap = 16
    for c in bank.specs:
        sps = c.slicer.sample_rate / c.slicer.symbol_rate
        nominal = ((plan.block_len + plan.overlap) / sps
                   * _bits_per_symbol(c.slicer) / 8.0)
        cap = max(cap, int(nominal * 1.5) + 16)
    return -(-cap // 8) * 8


# ---------------------------------------------------------------------------
# Bank runner
# ---------------------------------------------------------------------------


def _compute_groups(bank: Bank, frames: torch.Tensor, per_group: int,
                    capacity: int, sync_tolerance: int):
    """bank_frames_compute over (N, Lin) wire-dtype frames, ``per_group``
    blocks a pass (cast to the bank's dtype), concatenated along the block
    axis."""
    window = slicer_window(bank)
    outs = [
        bank_frames_compute(bank, frames[s : s + per_group].to(bank.dtype),
                            capacity, window, sync_tolerance)
        for s in range(0, frames.shape[0], per_group)
    ]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def dispatch_bank(bank: Bank, plan: BlockPlan, audio: torch.Tensor,
                  sync_tolerance: int):
    """Run the bank's device stages over the recording, one block group at
    a time; returns (data, addr, count, sync) device tensors over all
    blocks.  Each group normalises its AGC over its own blocks, as the JAX
    package's grouped dispatch does; the 600 s main-path banks fit one
    group."""
    return _compute_groups(bank, frame_blocks(audio, plan),
                           blocks_per_group(bank, plan),
                           bank_capacity(bank, plan), sync_tolerance)


def sync_tolerance(bank: Bank) -> int:
    """The bank's IL2P sync tolerance: the largest of its IL2P chains' (an
    AX.25 chain has none)."""
    return max((getattr(c.codec, "sync_tolerance", 0) for c in bank.specs
                if c.codec.kind == "il2p"), default=0)


def _audio_tensor(audio, device: torch.device,
                  dtype=torch.float32) -> torch.Tensor:
    """A recording on ``device`` in its wire dtype (int16 or float32; any
    other dtype becomes ``dtype``, the decode's: float64 audio keeps its
    precision in the parity mode, as in the JAX package)."""
    wire = np.asarray(audio)
    if wire.dtype not in (np.int16, np.float32):
        wire = wire.astype(np.float64 if dtype == torch.float64
                           else np.float32)
    return upload(wire, device)


def _check_codec(codec: str) -> None:
    if codec not in ("device", "host"):
        raise ValueError(f"codec={codec!r}: expected 'device' or 'host'")


def _float32_only(entry: str, dtype) -> None:
    """Raise ValueError when ``dtype`` (None: the mode's) is float64: the
    float64 route of ``entry`` is not yet ported."""
    if resolve_dtype(dtype) == torch.float64:
        raise ValueError(f"{entry}: the float64 parity mode's route of "
                         "this entry point is not yet ported; it runs "
                         "float32 only (run_banked and run_plan_banked run "
                         "float64)")


def _check_f64_chains(chains: list[ChainSpec], dtype,
                      device: torch.device) -> None:
    """modems.check_f64_kernels for every chain, before any runs."""
    for chain in chains:
        modems.check_f64_kernels(chain.modem.kind, dtype, device.type,
                                 chain.name)


def _submit_banked(chains: list[ChainSpec], audio,
                   block_seconds: float | str = "auto",
                   overlap_seconds: float | str = "auto",
                   codec: str = "device", max_packets_per_block: int = 8,
                   total_candidates: int | None = None,
                   max_packet_seconds: float | None = None,
                   device: str | torch.device = "cuda",
                   dtype=torch.float32) -> list:
    """Queue every bank's device stages for one recording at ``dtype``;
    return one collect() per bank, each giving {chain_name: [Packet]}.

    Launches are asynchronous, so bank i's first readback overlaps the
    device work of banks i+1..n.  On a budget-cache hit the device codec
    and its compaction are queued here too, with the packed readback
    (``_device_codec_submit``): the whole recording then runs back to back
    on the device, and collect() waits for its own readback only, not for
    work queued after it (run_banked_many pipelines recordings on this).
    ``codec="host"`` collectors read the byte streams back in collect()."""
    from .. import profiling

    _check_codec(codec)
    dev = resolve(device)
    dtype = resolve_dtype(dtype)
    _check_f64_chains(chains, dtype, dev)
    n_audio = len(audio)
    audio_t = _audio_tensor(audio, dev, dtype)
    with profiling.timed("group_chains"):
        banks = group_chains(chains, dev, dtype)
    collectors = []
    for bank in banks:
        plan = bank_plan(bank, n_audio, block_seconds, overlap_seconds,
                         max_packet_seconds)
        tol = sync_tolerance(bank)
        with profiling.timed("device_step"):
            arrays = dispatch_bank(bank, plan, audio_t, tol)
        if codec == "device":
            collectors.append(_device_codec_submit_mixed(
                bank, plan, _codec_subgroups(bank), *arrays,
                max_packets_per_block, total_candidates))
        else:
            collectors.append(partial(host_codec_collect, bank, plan, tol,
                                      arrays))
    return collectors


def _drain(collectors) -> dict[str, list]:
    out: dict[str, list] = {}
    for collect in collectors:
        out.update(collect())
    return out


def run_banked(chains: list[ChainSpec], audio: np.ndarray,
               block_seconds: float | str = "auto",
               overlap_seconds: float | str = "auto", codec: str = "device",
               max_packets_per_block: int = 8,
               total_candidates: int | None = None,
               max_packet_seconds: float | None = None,
               device: str | torch.device = "cuda",
               dtype=None) -> dict[str, list]:
    """Decode a chain list over one recording; returns {chain_name:
    [Packet]}, each packet attributed to exactly one block.

    ``audio`` is int16 (the WAV wire type, framed before the cast to
    ``dtype``) or float; ``dtype`` is float32 or float64 (None: the
    mode's).  The device stages run on ``device``.  ``codec="device"``
    (the default, as in the JAX package) decodes on the same device
    (``il2p_decode_blocks``, ``ax25_decode_blocks``), reads back one packed
    buffer per codec sub-group and runs the host state machines only for
    blocks whose budgets still overflow after escalation;
    ``max_packets_per_block`` and ``total_candidates`` are its first
    packet-slot and (IL2P) candidate budgets (None: sized from the sync
    map).  ``codec="host"`` reads the byte streams back and runs the
    reference-exact state machines on every block (an IL2P chain's only
    where it has a sync candidate)."""
    return _drain(_submit_banked(
        chains, audio, block_seconds, overlap_seconds, codec,
        max_packets_per_block, total_candidates, max_packet_seconds, device,
        resolve_dtype(dtype)))


def run_banked_many(chains: list[ChainSpec], audios, depth: int = 1,
                    block_seconds: float | str = "auto",
                    overlap_seconds: float | str = "auto",
                    codec: str = "device", max_packets_per_block: int = 8,
                    total_candidates: int | None = None,
                    max_packet_seconds: float | None = None,
                    device: str | torch.device = "cuda",
                    dtype=None) -> list[dict]:
    """Pipelined decode of a stream of recordings (the serving loop):
    recording i+1's device work is queued before recording i's results are
    read back, so each readback and host packet build overlaps the next
    recording's device work.  ``depth`` recordings stay in flight (device
    memory holds depth+1 recordings' block outputs).  Returns one
    {chain: packets} dict per recording, in order, equal to
    [run_banked(chains, a) for a in audios].  float32 only so far
    (``_float32_only``)."""
    _float32_only("run_banked_many", dtype)
    kw = (block_seconds, overlap_seconds, codec, max_packets_per_block,
          total_candidates, max_packet_seconds, device)
    out = []
    queue: deque = deque()
    for audio in audios:
        queue.append(_submit_banked(chains, audio, *kw))
        if len(queue) > depth:
            out.append(_drain(queue.popleft()))
    while queue:
        out.append(_drain(queue.popleft()))
    return out


def run_banked_files(chains: list[ChainSpec], audios,
                     block_seconds: float | str = "auto",
                     overlap_seconds: float | str = "auto",
                     codec: str = "device", max_packets_per_block: int = 8,
                     max_packet_seconds: float | None = None,
                     device: str | torch.device = "cuda",
                     dtype=None) -> list[dict]:
    """Decode several recordings in one device dispatch per bank: every
    file's blocks stack along the block axis, so a corpus fills the lanes
    of one pass.  Returns one {chain_name: packets} dict per file, with the
    file's own stream addresses.

    Geometry is uniform (the JAX package's rule): every file takes the
    bank's block and overlap lengths, a short file too (padded, its
    packets clipped to its length), so every file's codec runs against one
    template plan and shares its budget-cache entry by block count; all
    files' codecs are queued before any packed readback.  ``codec="host"``
    runs the reference-exact state machines per file.

    The AGC of a coherent bank normalises over the frames of its dispatch,
    so a coherent bank runs every file's blocks in ONE pass, as the JAX
    package's single call does: a file decoded here may then differ from
    the same file decoded alone, in both packages, but equals the JAX
    package's batched result.  A corpus whose working set does not fit the
    card must be split by the caller.  The other banks' blocks are
    independent, so they keep the group budget (``blocks_per_group``).
    float32 only so far (``_float32_only``)."""
    _float32_only("run_banked_files", dtype)
    _check_codec(codec)
    dev = resolve(device)
    audios = [np.asarray(a) for a in audios]
    results: list[dict[str, list]] = [dict() for _ in audios]
    waves = [_audio_tensor(a, dev) for a in audios]
    for bank in group_chains(chains, dev):
        rate = bank.specs[0].modem.sample_rate
        bank_block, bank_overlap = resolve_bank_geometry(
            bank, rate, block_seconds, overlap_seconds, max_packet_seconds)
        block_len, overlap = _block_geometry(rate, bank.up, bank_block,
                                             bank_overlap)
        plans = [BlockPlan(len(a), bank.trim, block_len, overlap, bank.up,
                           bank.trim_post) for a in audios]
        frames = torch.cat([frame_blocks(w, p) for w, p in zip(waves, plans)])
        tol = sync_tolerance(bank)
        per_group = (frames.shape[0] if bank.kind in _COHERENT_KINDS else
                     blocks_per_group(bank, plans[0], frames.shape[0]))
        arrays = _compute_groups(bank, frames, per_group,
                                 max(bank_capacity(bank, p) for p in plans),
                                 tol)
        del frames
        template = BlockPlan(0, bank.trim, block_len, overlap, bank.up,
                             bank.trim_post)
        groups = _codec_subgroups(bank)
        collectors = []
        start = 0
        for plan in plans:
            part = tuple(t[:, start : start + plan.n_blocks].contiguous()
                         for t in arrays)
            start += plan.n_blocks
            if codec == "device":
                collectors.append(_device_codec_submit_mixed(
                    bank, template, groups, *part, max_packets_per_block,
                    None, host_plan=plan))
            else:
                collectors.append(partial(host_codec_collect, bank, plan,
                                          tol, part))
        for res, collect in zip(results, collectors):
            res.update(collect())
    return results


def host_codec_collect(bank: Bank, plan: BlockPlan, sync_tol: int, arrays):
    """Read a bank's byte streams back and run the reference-exact state
    machines (AX.25 or IL2P, per chain) per block, keeping packets inside
    each block's range."""
    from .. import profiling
    from ..codecs.host import il2p_seeded_sync_any

    with profiling.timed("transfer"):
        data, addr, count, sync = (t.cpu().numpy() for t in arrays)
    # a block without any sync candidate (and no possible seeded-history
    # sync in its first 32 bits) emits nothing
    has_cand = sync.any(axis=2) | il2p_seeded_sync_any(data[:, :, :4],
                                                       sync_tol)
    results: dict[str, list] = {}
    for ci, chain in enumerate(bank.specs):
        # only an IL2P chain's blocks need a sync candidate
        skippable = chain.codec.kind == "il2p"
        packets = []
        for b in range(plan.n_blocks):
            n = int(count[ci, b])
            if n == 0 or (skippable and not has_cand[ci, b]):
                continue
            # addresses are 1-based within the block's demod range, which
            # starts at absolute index b*block_len - overlap
            offset = b * plan.block_len - plan.overlap
            with profiling.timed("host_codec"):
                pkts = host_decode_block(
                    chain, data[ci, b, :n].astype(np.int64),
                    addr[ci, b, :n].astype(np.int64) + offset, sync[ci, b])
            lo, hi = plan.keep_range(b)
            packets.extend(p for p in pkts if lo < p.streamaddress <= hi)
        results[chain.name] = _dedup_block_boundary(packets, chain)
    return results


def host_decode_block(chain: ChainSpec, block_bytes: np.ndarray,
                      block_addr: np.ndarray, sync_row: np.ndarray | None):
    """Run the chain's codec state machine (AX.25 or IL2P) over one block's
    byte stream.  ``sync_row``: the block's packed IL2P sync-candidate
    bitmap, or None to rescan on the host."""
    from ..codecs.host import (
        ax25_decode_host,
        il2p_decode_host,
        il2p_seeded_sync_possible,
    )

    codec = chain.codec
    if codec.kind == "ax25":
        return ax25_decode_host(
            block_bytes, block_addr, codec.ident,
            min_packet_length=codec.min_packet_length,
            max_packet_length=codec.max_packet_length,
        )
    n = len(block_bytes)
    candidates = None
    if sync_row is not None:
        if not sync_row[:n].any() and not il2p_seeded_sync_possible(
            block_bytes[:4], codec.sync_tolerance
        ):
            return []
        candidates = np.flatnonzero(np.unpackbits(sync_row[:n]))
    return il2p_decode_host(
        block_bytes, block_addr, codec.ident,
        collect_trailing_crc=codec.collect_trailing_crc,
        disable_rs=codec.disable_rs,
        min_distance=codec.min_distance,
        sync_tolerance=codec.sync_tolerance,
        sync_candidates=candidates,
    )


def _dedup_block_boundary(packets, chain):
    """Drop block-boundary duplicates: a packet ending within one byte-phase
    quantum of a block edge can be claimed by both neighbouring blocks under
    different reported addresses."""
    sl = chain.slicer
    window = 16.0 * sl.sample_rate / sl.symbol_rate
    packets.sort(key=lambda p: p.streamaddress)
    deduped = []
    for p in packets:
        if (
            deduped
            and list(p.data) == list(deduped[-1].data)
            and p.streamaddress - deduped[-1].streamaddress < window
        ):
            continue
        deduped.append(p)
    return deduped


# ---------------------------------------------------------------------------
# Device codec route
# ---------------------------------------------------------------------------


def bank_codec_step(codec_kind: str, data, addr, count, sync, plan: BlockPlan,
                    max_packets: int = 8, collect_crc: bool = True,
                    disable_rs: bool = False, min_distance: int = 0,
                    total_candidates: int | None = None,
                    total_rs_blocks: int | None = None,
                    scan_cap: int = 64, rs_fail_frac: int | None = 2,
                    max_payload: int = 1023, min_packet_length: int = 18,
                    max_packet_length: int = 1023,
                    keep_filter: bool = True) -> dict:
    """The device codec (``"il2p"`` or ``"ax25"``) over dispatch_bank
    outputs: (C, B, cap) byte streams -> fixed-capacity packet buffers
    (C, B, max_packets, ...).

    Absolute stream addresses are formed on the device (block b's demod
    range starts at b*block_len - overlap).  With ``keep_filter`` each
    block's keep window (plan.keep_range) applies on the device, so halo
    duplicates never reach the packed readback (the host filter stays as
    an idempotent guard); it needs ``plan`` to be the recording's own, so
    a template plan (run_banked_files) leaves the filter to the host."""
    from ..codecs.ax25_device import ax25_decode_blocks
    from ..codecs.il2p_device import il2p_decode_blocks

    n_blocks = data.shape[1]
    offsets = (torch.arange(n_blocks, dtype=torch.int32, device=data.device)
               * plan.block_len - plan.overlap)
    addr_abs = addr + offsets[None, :, None]
    if codec_kind == "il2p":
        out = il2p_decode_blocks(
            data.to(torch.uint8), sync, count, addr_abs,
            max_packets=max_packets, collect_crc=collect_crc,
            disable_rs=disable_rs, min_distance=min_distance,
            total_candidates=total_candidates,
            total_rs_blocks=total_rs_blocks, scan_cap=scan_cap,
            rs_fail_frac=rs_fail_frac, max_payload=max_payload,
        )
    elif codec_kind == "ax25":
        out = ax25_decode_blocks(
            data.to(torch.uint8), count, addr_abs, max_packets=max_packets,
            min_packet_length=min_packet_length,
            max_packet_length=max_packet_length,
        )
    else:
        raise ValueError(codec_kind)
    if keep_filter:
        lo = (torch.arange(n_blocks, device=data.device)
              * plan.block_len)[None, :, None]
        hi = (lo + plan.block_len).clamp(max=plan.n_demod)
        out["ok"] = (out["ok"] & (out["address"] > lo)
                     & (out["address"] <= hi))
    return out


def _codec_static_key(codec):
    """Static (kind, options) of one chain's device codec."""
    if codec.kind == "il2p":
        return ("il2p", codec.collect_trailing_crc, codec.disable_rs,
                codec.min_distance, codec.sync_tolerance)
    if codec.kind == "ax25":
        return ("ax25", codec.min_packet_length, codec.max_packet_length)
    raise ValueError(f"no device codec for {codec.kind!r}")


def _codec_subgroups(bank: Bank):
    """[(codec_key, chain_index_list)] in config order.  A bank mixing
    codecs or codec options runs one device codec per sub-group of
    chains."""
    order: list[tuple] = []
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(bank.specs):
        key = _codec_static_key(c.codec)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    return [(k, groups[k]) for k in order]


def _bank_chain_subset(bank: Bank, idxs: list[int]) -> Bank:
    """A chain-index view of the bank for the codec and packet stage (which
    reads only specs and the per-chain stream settings, never params)."""
    from dataclasses import replace as _replace

    return _replace(
        bank,
        specs=[bank.specs[i] for i in idxs],
        params=None,
        stream_polys=tuple(bank.stream_polys[i] for i in idxs),
        stream_inverts=tuple(bank.stream_inverts[i] for i in idxs),
    )


def _popcount_stats(sync: torch.Tensor) -> torch.Tensor:
    """(total candidates, max candidates in any one block) of a packed
    (..., cap) sync bitmap."""
    per_block = constant(_POPCOUNT8, sync.device)[sync.long()].sum(-1)
    return torch.stack([per_block.sum(), per_block.max()])


def auto_candidate_budget_device(sync) -> tuple[int, int, int]:
    """(candidate-slot budget, acceptance-scan cap, busiest block's
    candidate count) for a device-resident bitmap: reads back two scalars
    in one transfer.  The scan cap is the power-of-two bucket covering the
    busiest block; blocks past 64 fall back via ``dropped``."""
    total, max_pb = (int(v) for v in _popcount_stats(sync).cpu().tolist())
    cap = 8
    while cap < min(max_pb, 64):
        cap *= 2
    return _budget_bucket(total), cap, max_pb


def _auto_max_packets(max_pb: int, default_mp: int, n_rows: int,
                      lmax: int, mem_limit: float = 1e9) -> int:
    """First per-block packet-slot budget from the busiest block's
    candidate count (emitted packets never exceed candidates), a power of
    two, bounded so the (rows, mp, lmax) packet buffer stays under
    ``mem_limit`` bytes."""
    mp = default_mp
    while mp < min(max_pb, MP_CAP):
        mp *= 2
    mem_mp = max(int(mem_limit / max(n_rows * lmax, 1)), default_mp)
    return max(min(mp, MP_CAP, mem_mp), default_mp)


def _budget_bucket(n: int, lo: int = 64) -> int:
    """Bucket >= 1.25*n from {2^k, 1.5*2^k}: distinct budgets stay few and
    the worst overshoot is 1.5x."""
    need = max(lo, int(n * 1.25) + 16)
    p = 1 << (need - 1).bit_length()
    return p - p // 4 if need <= p - p // 4 else p


def _codec_out_sizes(ok, length) -> torch.Tensor:
    """(n_valid_packets, total_valid_bytes, max_packet_len)."""
    okf = ok.reshape(-1)
    lenf = torch.where(okf, length.reshape(-1).to(torch.int64), 0)
    return torch.stack([okf.sum(dtype=torch.int64), lenf.sum(), lenf.max()])


# row order of compact_codec_out's stacked metadata (AX.25 has no
# ``corrected`` row)
COMPACT_META_KEYS = ("address", "length", "chain", "block", "base",
                     "corrected")


def _le_bytes(x) -> torch.Tensor:
    """Integer tensor -> flat little-endian uint8 bytes of its int32
    values (the host reassembles them with ndarray.view('<i4'))."""
    x = x.to(torch.int32)
    b = torch.stack([(x >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return b.to(torch.uint8).reshape(-1)


def compact_codec_out(ok, address, length, corrected, packet, dropped,
                      meta_budget: int, len_budget: int) -> torch.Tensor:
    """Dense-pack the codec's fixed (C, B, P, Lmax) packet buffers on the
    device into ONE flat uint8 buffer: the exact output sizes (so a caller
    on cached budgets can check them from the same readback), the int32
    metadata in COMPACT_META_KEYS row order (without ``corrected`` when it
    is None, as for AX.25), the per-block ``dropped`` counts, then
    ``meta_budget`` rows of ``len_budget`` length-masked packet bytes.
    Valid packets rank-compact into the metadata slots; those past
    ``meta_budget`` are dropped (the sizes say so)."""
    C, B, Pk = ok.shape
    dev = ok.device
    okf = ok.reshape(-1)
    rank = torch.cumsum(okf.to(torch.int64), 0) - 1
    # invalid rows, and valid ones past the budget, land in a dummy slot
    pos = torch.where(okf & (rank < meta_budget), rank, meta_budget)

    def cmeta(x):
        buf = torch.zeros((meta_budget + 1,), dtype=torch.int64, device=dev)
        buf[pos] = x.reshape(-1).to(torch.int64)
        return buf[:meta_budget]

    lenf = torch.where(okf, length.reshape(-1).to(torch.int64), 0)
    ci = torch.arange(C, device=dev)[:, None, None].expand(C, B, Pk)
    bi = torch.arange(B, device=dev)[None, :, None].expand(C, B, Pk)
    base = torch.cumsum(lenf, 0) - lenf
    meta_rows = [cmeta(address), cmeta(length), cmeta(ci), cmeta(bi),
                 cmeta(base)]
    if corrected is not None:
        meta_rows.append(cmeta(corrected))
    row_src = cmeta(torch.arange(C * B * Pk, device=dev))
    flat_pk = packet.reshape(C * B * Pk, -1)[:, :len_budget]
    rows = flat_pk[row_src]  # (meta_budget, len_budget) uint8
    j = torch.arange(rows.shape[-1], device=dev)[None, :]
    rows = torch.where(j < meta_rows[1][:, None], rows, 0).to(torch.uint8)
    return torch.cat([_le_bytes(_codec_out_sizes(ok, length)),
                      _le_bytes(torch.stack(meta_rows)), _le_bytes(dropped),
                      rows.reshape(-1)])


# Steady-state codec budgets per (codec options, block geometry, bank
# shape): a repeat call with the same workload shape skips both exact
# sizing readbacks and runs codec and compaction with a SINGLE readback at
# the end.  Safe because every undershoot is detected: candidate and scan
# saturation surface per block in ``dropped`` (escalation, then the host
# FSM past MP_CAP), and compaction overflow in the packed sizes (redo with
# exact budgets).  The lock guards get, merge and pop: run_banked may run
# on several threads.
_CODEC_BUDGET_CACHE: dict = {}
_CODEC_BUDGET_LOCK = threading.Lock()

# terminal per-block packet-slot budget of the escalation ladder; blocks
# still saturated at MP_CAP decode on the host FSM (packets_from_compact)
MP_CAP = 64


def _merge_budget_entry(prev, new):
    """Upper-bound merge of two budget-cache entries sharing one key: the
    elementwise maximum, and the safer side of the RS split knob (None
    wins), so dispatches of different traffic under one key converge
    instead of overwriting each other."""
    if prev is None:
        return new
    mp = max(prev[0], new[0])
    cand = (
        None if prev[1] is None or new[1] is None
        else max(prev[1], new[1])
    )
    scan = max(prev[2], new[2])
    meta = max(prev[3], new[3])
    lenb = max(prev[4], new[4])
    frac = (
        None if prev[5] is None or new[5] is None
        else min(prev[5], new[5])
    )
    pay = max(prev[6], new[6])
    return (mp, cand, scan, meta, lenb, frac, pay)


def _il2p_payload_budget(bank: Bank, plan: BlockPlan) -> int:
    """Per-candidate payload-byte budget for the device IL2P codec, from
    the longest packet the plan protects: the block overlap covers loop
    acquisition plus the longest packet, so a packet whose wire time
    exceeds the overlap is outside the runtime's protection anyway.
    Bucketed {2^k, 1.5*2^k}; a header announcing more marks its block
    dropped (escalation to 1023, then the exact host fallback)."""
    wire_bytes = 0.0
    for c in bank.specs:
        sl = c.slicer
        sps = sl.sample_rate / sl.symbol_rate
        wire_bytes = max(wire_bytes,
                         plan.overlap / sps * _bits_per_symbol(sl) / 8.0)
    if plan.overlap <= 0:
        return 1023  # single-block plan: no straddle bound to infer from
    # invert wire = sync(3) + header(15) + mp + 16*ceil(mp/239) + crc(4)
    mp = 0
    for blocks in range(1, 6):
        cand = int(wire_bytes) - 3 - 15 - 16 * blocks - 4
        cand = min(cand, blocks * 239)
        if cand > (blocks - 1) * 239:
            mp = max(mp, cand)
    return min(_budget_bucket(max(mp, 64), lo=64), 1023)


def _dispatch_codec(codec_key, data, addr, count, sync, plan,
                    max_packets_per_block, total_candidates, scan_cap,
                    rs_fail_frac: int | None, max_payload: int,
                    keep_filter: bool = True) -> dict:
    if codec_key[0] == "ax25":
        return bank_codec_step(
            "ax25", data, addr, count, sync, plan,
            max_packets=max_packets_per_block,
            min_packet_length=codec_key[1], max_packet_length=codec_key[2],
            keep_filter=keep_filter)
    return bank_codec_step(
        "il2p", data, addr, count, sync, plan,
        max_packets=max_packets_per_block, keep_filter=keep_filter,
        collect_crc=codec_key[1], disable_rs=codec_key[2],
        min_distance=codec_key[3],
        total_candidates=total_candidates,
        # failed-header candidates contribute no RS rows, so the live-row
        # population is ~1 payload block per real packet; overflow falls
        # back per block via ``dropped``
        total_rs_blocks=total_candidates,
        scan_cap=scan_cap, rs_fail_frac=rs_fail_frac,
        max_payload=max_payload,
    )


def _start_readback(t: torch.Tensor):
    """Start reading a device tensor back; return a wait() that gives it
    as a numpy array.  On CUDA the copy goes into a pinned host buffer of
    its own (never one still in flight) without blocking, and wait()
    blocks on an event recorded right after it: only on the work queued
    before the copy, not on what was queued after it (a blocking
    ``.cpu()`` waits for the whole stream, the next recording's kernels
    included).  On the CPU wait() gives the tensor itself."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def _read_compact(flat: np.ndarray, meta_budget: int, len_budget: int,
                  dropped_shape: tuple, has_corrected: bool = True):
    """Split compact_codec_out's buffer, read back (``flat``), by the
    budget sizes into (sizes, comp dict, dropped)."""
    n_ok, total_bytes, max_len = (int(v) for v in flat[:12].view("<i4"))
    off = 12
    keys = COMPACT_META_KEYS if has_corrected else COMPACT_META_KEYS[:-1]
    end = off + len(keys) * meta_budget * 4
    comp = dict(zip(keys, flat[off:end].view("<i4").reshape(len(keys), -1)))
    off = end
    dsize = int(np.prod(dropped_shape))
    dropped = flat[off : off + dsize * 4].view("<i4").reshape(dropped_shape)
    rows_np = flat[off + dsize * 4:].reshape(meta_budget, len_budget)
    # the length-masked rows flattened to the contiguous byte stream the
    # packet builder slices by ``base`` (slots are rank-ordered, so row
    # order is stream order)
    comp["bytes"] = rows_np[
        np.arange(rows_np.shape[-1])[None, :] < comp["length"][:, None]
    ]
    return (n_ok, total_bytes, max_len), comp, dropped


def _len_bucket(max_len: int, lmax: int) -> int:
    """Byte-row width bucket {2^k, 1.5*2^k} of the packed readback, at
    most the packet buffer's width."""
    need = max(max_len, 64)
    p = 1 << (need - 1).bit_length()
    b = p - p // 4 if need <= p - p // 4 else p
    return min(b, lmax)


def _device_codec_submit(bank, plan, codec_key, data, addr, count, sync,
                         max_packets_per_block, total_candidates,
                         block0: int = 0, host_plan: BlockPlan | None = None):
    """Run the device codec and compaction over bank outputs; return a
    collect() closure that performs the single packed readback and builds
    packet objects.

    On a budget-cache hit the codec and compaction launch NOW, with the
    packed readback into pinned memory (``_start_readback``), and collect()
    waits for that copy alone; a compaction overflow there redoes the
    compaction with exact budgets.  On a miss collect() sizes exactly: one
    readback of the sync map's candidate statistics, one of the output
    sizes, then the packed one.  Blocks still saturated (``dropped``)
    ESCALATE on the device -- packet slots and scan cap double, the RS
    split turns off, the payload budget goes to 1023 and an auto-sized
    candidate budget doubles -- up to MP_CAP; the host FSM decodes only the
    blocks still dropped after that.  The learned budgets land in the
    cache.

    ``host_plan`` (run_banked_files, the streaming decoder): the device
    program addresses the blocks against the template ``plan`` (so the
    budget-cache key does not change from file to file or step to step),
    and the host packet build keeps packets inside ``host_plan``'s blocks,
    the recording's own.  ``block0`` (the streaming decoder): the global
    index of the buffers' block 0; the host packet build shifts addresses
    by ``block0 * plan.block_len`` and keep windows by ``block0`` blocks.
    The device keep filter runs only with neither."""
    from .. import profiling

    device_keep = host_plan is None and block0 == 0
    if host_plan is None:
        host_plan = plan
    cache_key = (codec_key, plan, tuple(data.shape[:2]),
                 max_packets_per_block)
    cached = None
    if total_candidates is None:
        with _CODEC_BUDGET_LOCK:
            cached = _CODEC_BUDGET_CACHE.get(cache_key)

    def dispatch(mp, cand_budget, scan_cap, rs_frac, pay_budget):
        with profiling.timed("device_codec_step"):
            return _dispatch_codec(codec_key, data, addr, count, sync, plan,
                                   mp, cand_budget, scan_cap, rs_frac,
                                   pay_budget, device_keep)

    def compact(out, meta_budget, len_budget):
        return compact_codec_out(
            out["ok"], out["address"], out["length"], out.get("corrected"),
            out["packet"], out["dropped"], meta_budget, len_budget)

    def read(flat, meta_budget, len_budget):
        with profiling.timed("device_codec_transfer"):
            return _read_compact(flat, meta_budget, len_budget,
                                 tuple(data.shape[:2]),
                                 has_corrected=codec_key[0] == "il2p")

    def run_exact(mp, cand_budget, scan_cap, rs_frac, pay_budget):
        out = dispatch(mp, cand_budget, scan_cap, rs_frac, pay_budget)
        with profiling.timed("codec_sizes"):
            n_ok, _total_bytes, max_len = (
                int(v) for v in
                _codec_out_sizes(out["ok"], out["length"]).cpu().tolist())
        with profiling.timed("device_codec_compact"):
            len_budget = _len_bucket(max_len, out["packet"].shape[-1])
            meta_budget = _budget_bucket(n_ok)
            packed = compact(out, meta_budget, len_budget)
        _sizes, comp, dropped = read(packed.cpu().numpy(), meta_budget,
                                     len_budget)
        return n_ok, meta_budget, len_budget, comp, dropped

    def resolve_budgets(mp, cand_budget, scan_cap, rs_frac, pay_budget, n_ok,
                        meta_budget, len_budget, comp, dropped):
        while dropped.any() and mp < MP_CAP:
            with profiling.timed("device_codec_escalate"):
                mp = mp * 2
                scan_cap = min(scan_cap * 2, 128)
                # dropped does not say WHICH budget saturated; turn off the
                # RS split and the payload budget alongside the doublings
                # so any saturated budget converges to exact
                rs_frac = None
                pay_budget = 1023
                if total_candidates is None and cand_budget is not None:
                    cand_budget = cand_budget * 2
                n_ok, meta_budget, len_budget, comp, dropped = run_exact(
                    mp, cand_budget, scan_cap, rs_frac, pay_budget
                )
        with _CODEC_BUDGET_LOCK:
            if total_candidates is None and not dropped.any():
                _CODEC_BUDGET_CACHE[cache_key] = _merge_budget_entry(
                    _CODEC_BUDGET_CACHE.get(cache_key),
                    (mp, cand_budget, scan_cap, meta_budget, len_budget,
                     rs_frac, pay_budget),
                )
            else:
                _CODEC_BUDGET_CACHE.pop(cache_key, None)
        return packets_from_compact(
            bank, host_plan, comp, n_ok, dropped, data, addr, count, sync,
            block0,
        )

    if cached is not None:
        # speculative steady-state path: no readback before the packed one
        (mp0, cand_budget, scan_cap, meta_budget0, len_budget0, rs_frac0,
         pay0) = cached
        out = dispatch(mp0, cand_budget, scan_cap, rs_frac0, pay0)
        with profiling.timed("device_codec_compact"):
            readback = _start_readback(compact(out, meta_budget0,
                                               len_budget0))

        def collect():
            meta_budget, len_budget = meta_budget0, len_budget0
            sizes, comp, dropped = read(readback(), meta_budget, len_budget)
            n_ok, _total_bytes, max_len = sizes
            if n_ok > meta_budget or max_len > len_budget:
                # compaction budgets overflowed (the workload grew): redo
                # the compaction with exact budgets
                with profiling.timed("device_codec_redo"):
                    meta_budget = _budget_bucket(n_ok)
                    len_budget = _len_bucket(max_len,
                                             out["packet"].shape[-1])
                    _, comp, dropped = read(
                        compact(out, meta_budget, len_budget).cpu().numpy(),
                        meta_budget, len_budget)
            return resolve_budgets(mp0, cand_budget, scan_cap, rs_frac0,
                                   pay0, n_ok, meta_budget, len_budget, comp,
                                   dropped)

        return collect

    def collect():
        scan_cap = 64
        cand_budget = total_candidates
        mp = max_packets_per_block
        # AX.25 starts at max_packets_per_block and pays no IL2P budget
        il2p = codec_key[0] == "il2p"
        pay0 = _il2p_payload_budget(bank, plan) if il2p else 1023
        if il2p and total_candidates is None:
            with profiling.timed("candidate_budget"):
                cand_budget, scan_cap, max_pb = (
                    auto_candidate_budget_device(sync)
                )
            # right-size the packet-slot budget from the busiest block's
            # candidate count, skipping the escalation ladder on
            # packet-dense blocks
            mp = _auto_max_packets(
                max_pb, max_packets_per_block,
                data.shape[0] * data.shape[1], 16 + pay0 + 2,
            )
        frac0 = 2  # the syndrome-zero split's first fraction
        n_ok, meta_budget, len_budget, comp, dropped = run_exact(
            mp, cand_budget, scan_cap, frac0, pay0
        )
        return resolve_budgets(mp, cand_budget, scan_cap, frac0, pay0, n_ok,
                               meta_budget, len_budget, comp, dropped)

    return collect


def _device_codec_submit_mixed(bank, plan, groups, data, addr, count, sync,
                               max_packets_per_block, total_candidates,
                               block0: int = 0,
                               host_plan: BlockPlan | None = None):
    """_device_codec_submit over the bank's codec SUB-GROUPS (from
    _codec_subgroups): a bank whose chains mix codec options runs one
    device codec per sub-group of chain rows; the demod already ran once
    for the whole bank.  collect() drains them in config order."""
    if len(groups) == 1:
        return _device_codec_submit(
            bank, plan, groups[0][0], data, addr, count, sync,
            max_packets_per_block, total_candidates, block0, host_plan,
        )
    subs = []
    for key, idxs in groups:
        lo, hi = idxs[0], idxs[-1] + 1
        if idxs == list(range(lo, hi)):
            sel = slice(lo, hi)
        else:
            sel = upload(np.asarray(idxs, np.int64), data.device)
        subs.append(_device_codec_submit(
            _bank_chain_subset(bank, idxs), plan, key,
            data[sel], addr[sel], count[sel], sync[sel],
            max_packets_per_block, total_candidates, block0, host_plan,
        ))
    return partial(_drain, subs)


def _fallback_block_packets(per_chain, bank, plan, fallback, data, addr,
                            count, sync, block0: int = 0) -> None:
    """Decode the blocks still saturated after escalation with the exact
    host FSM (the device result may be incomplete there).  Reads the byte
    streams back only when such blocks exist.  ``fallback`` holds local
    (chain, block) indices; ``block0`` shifts them to their global stream
    position (streaming steps)."""
    from .. import profiling

    if not fallback:
        return
    profiling.count("packet_fallback_blocks", len(fallback))
    data, addr, count, sync = (t.cpu().numpy()
                               for t in (data, addr, count, sync))
    for ci, b in sorted(fallback):
        chain = bank.specs[ci]
        n = int(count[ci, b])
        if n == 0:
            continue
        offset = (b + block0) * plan.block_len - plan.overlap
        pkts = host_decode_block(
            chain,
            data[ci, b, :n].astype(np.int64),
            addr[ci, b, :n].astype(np.int64) + offset,
            sync[ci, b],
        )
        lo, hi = plan.keep_range(b + block0)
        per_chain.setdefault(int(ci), []).extend(
            p for p in pkts if lo < p.streamaddress <= hi
        )


def packets_from_compact(bank, plan, comp, n_ok, dropped, data, addr, count,
                         sync, block0: int = 0):
    """Per-chain Packet lists from compact_codec_out's readback, with the
    host FSM for the blocks still dropped.  ``block0``: the global stream
    index of the buffers' block 0 (streaming steps address their blocks
    locally on the device; addresses and keep windows shift by whole
    blocks here)."""
    from .. import profiling
    from ..packets import Packet

    with profiling.timed("packet_objects"):
        fallback = set(map(tuple, np.argwhere(dropped > 0).tolist()))
        # vectorized keep filter (keep_range + fallback membership), then
        # one bulk bytes->list conversion and a plain loop of constructions
        chain_a = comp["chain"][:n_ok].astype(np.int64)
        block_a = comp["block"][:n_ok].astype(np.int64)  # local indices
        addr_a = (comp["address"][:n_ok].astype(np.int64)
                  + block0 * plan.block_len)
        lo = (block_a + block0) * plan.block_len
        keep = (addr_a > lo) & (
            addr_a <= np.minimum(lo + plan.block_len, plan.n_demod)
        )
        if fallback:
            key = chain_a * plan.n_blocks + block_a
            fb_keys = np.array(
                [ci * plan.n_blocks + b for ci, b in fallback], dtype=np.int64
            )
            keep &= ~np.isin(key, fb_keys)
        idx = np.nonzero(keep)[0]
        flat_list = comp["bytes"].tolist()
        corrected = comp.get("corrected")
        corr_l = (corrected[:n_ok][idx].tolist() if corrected is not None
                  else [0] * len(idx))
        idents = [spec.codec.ident for spec in bank.specs]
        per_chain: dict[int, list] = {}
        with profiling.timed("packet_build"):
            for ci, address, length, base, corr in zip(
                chain_a[idx].tolist(), addr_a[idx].tolist(),
                comp["length"][:n_ok][idx].tolist(),
                comp["base"][:n_ok][idx].tolist(), corr_l,
            ):
                per_chain.setdefault(ci, []).append(
                    Packet(
                        data=flat_list[base : base + length],
                        streamaddress=address,
                        source_decoder=idents[ci],
                        bytes_corrected=corr,
                    )
                )
        if fallback:
            with profiling.timed("packet_fallback"):
                _fallback_block_packets(
                    per_chain, bank, plan, fallback, data, addr, count, sync,
                    block0,
                )
        for pkts in per_chain.values():
            pkts.sort(key=lambda p: p.streamaddress)
        with profiling.timed("packet_dedup"):
            return {
                chain.name: _dedup_block_boundary(per_chain.get(ci, []), chain)
                for ci, chain in enumerate(bank.specs)
            }


def run_plan_banked(plan, audio: np.ndarray, sample_rate: float,
                    block_seconds: float | str = "auto",
                    overlap_seconds: float | str = "auto",
                    codec: str = "device", verbose: bool = False,
                    resilient: bool = True,
                    max_packet_seconds: float | None = None,
                    device: str | torch.device = "cuda",
                    dtype=None) -> RunResult:
    """Full plan -> aggregated report (chains in config order), at
    ``dtype`` (None: the mode's).  A chain that cannot run at float64 on
    the card (``modems.check_f64_kernels``) raises ValueError first.

    ``resilient`` is the reference's skip-and-continue (chain_execute.py:
    8-27): if the banked run fails, every chain is retried alone through
    the sequential executor, on the same device and kernels, and a chain
    that still fails is reported and skipped.  If the failure left the
    device lost (a sticky CUDA error, ``device.lost``), no retry could
    run: the message names the error once and ``DeviceLostError`` is
    raised.  ``resilient=False`` raises."""
    from ..device import DeviceLostError, lost
    from .executor import run_chain

    dtype = resolve_dtype(dtype)
    _check_f64_chains(plan.chains, dtype, torch.device(device))
    if verbose:
        print(f"banked runtime: {len(plan.chains)} chains")
    seq_chains = []
    try:
        by_name = run_banked(
            plan.chains, audio, block_seconds=block_seconds,
            overlap_seconds=overlap_seconds, codec=codec,
            max_packet_seconds=max_packet_seconds, device=device,
            dtype=dtype,
        )
    except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
        if not resilient:
            raise
        dead = lost(device)
        if dead is not None:
            print(f"banked runtime failed ({dead}); the device is lost, "
                  f"no retry")
            raise DeviceLostError(dead) from exc
        print(f"banked runtime failed ({type(exc).__name__}: {exc}); "
              f"retrying chains sequentially")
        by_name = {}
        seq_chains = list(plan.chains)
    for c in seq_chains:
        try:
            by_name[c.name] = run_chain(c, audio, device=device, dtype=dtype)
        except Exception as exc:  # noqa: BLE001
            print(f"skipped chain {c.name}: {type(exc).__name__}: {exc}")
            by_name[c.name] = []
    return _finish_plan(plan, by_name, sample_rate)


def run_plans_banked_pipelined(jobs, depth: int = 1,
                               block_seconds: float | str = "auto",
                               overlap_seconds: float | str = "auto",
                               codec: str = "device",
                               max_packet_seconds: float | None = None,
                               device: str | torch.device = "cuda",
                               dtype=None) -> list[RunResult]:
    """Pipelined decode of (plan, audio, sample_rate) jobs that may use
    different configs: every job's device work is queued before earlier
    jobs' readbacks (up to ``depth`` jobs in flight), so a mixed queue (a
    decode server's batch across config files) overlaps each readback and
    report build with the next job's device work.  Returns one RunResult
    per job, equal to per-job run_plan_banked.  float32 only so far
    (``_float32_only``)."""
    _float32_only("run_plans_banked_pipelined", dtype)
    out = []
    queue: deque = deque()
    for plan, audio, rate in jobs:
        queue.append((plan, rate, _submit_banked(
            plan.chains, audio, block_seconds, overlap_seconds, codec,
            max_packet_seconds=max_packet_seconds, device=device)))
        if len(queue) > depth:
            plan_, rate_, collectors = queue.popleft()
            out.append(_finish_plan(plan_, _drain(collectors), rate_))
    while queue:
        plan_, rate_, collectors = queue.popleft()
        out.append(_finish_plan(plan_, _drain(collectors), rate_))
    return out


def run_plan_banked_many(plan, audios, sample_rate: float, depth: int = 1,
                         block_seconds: float | str = "auto",
                         overlap_seconds: float | str = "auto",
                         codec: str = "device", resilient: bool = True,
                         max_packet_seconds: float | None = None,
                         device: str | torch.device = "cuda",
                         dtype=None) -> list[RunResult]:
    """Pipelined run_plan_banked over several recordings (the serving warm
    path, run_banked_many).  Returns one RunResult per recording, equal to
    per-recording run_plan_banked; with ``resilient`` a failure retries
    each recording through run_plan_banked.  float32 only so far
    (``_float32_only``)."""
    _float32_only("run_plan_banked_many", dtype)
    try:
        per_rec = run_banked_many(
            plan.chains, audios, depth=depth, block_seconds=block_seconds,
            overlap_seconds=overlap_seconds, codec=codec,
            max_packet_seconds=max_packet_seconds, device=device,
        )
    except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
        if not resilient:
            raise
        print(f"banked runtime failed ({type(exc).__name__}: {exc}); "
              f"retrying recordings individually")
        return [
            run_plan_banked(plan, a, sample_rate,
                            block_seconds=block_seconds,
                            overlap_seconds=overlap_seconds, codec=codec,
                            max_packet_seconds=max_packet_seconds,
                            device=device)
            for a in audios
        ]
    return [_finish_plan(plan, by_name, sample_rate) for by_name in per_rec]


def _finish_plan(plan, by_name: dict, sample_rate: float) -> RunResult:
    """Aggregate one recording's per-chain packets (config-order chains,
    cross-chain correlate, rendered reports)."""
    from ..packets import PacketAggregate

    aggregate = PacketAggregate()
    for chain in plan.chains:
        aggregate.add(by_name.get(chain.name, []))
    aggregate.validate_all()
    # cross-chain dedup window: the reference's rate/40 (pymodem.py:175)
    # widened by two byte-phase quanta (block slicers restart their byte
    # counter per block)
    max_sps = max(
        (c.slicer.sample_rate / c.slicer.symbol_rate for c in plan.chains),
        default=1.0,
    )
    aggregate.correlate(address_distance=sample_rate / 40 + 16 * max_sps)
    reports = [
        aggregate.render_raw_bad() + aggregate.render_report(r.style)
        for r in plan.reports
    ]
    return RunResult(aggregate=aggregate, reports=reports)
