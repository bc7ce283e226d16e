"""Streaming decode: unbounded recordings in bounded device memory.

Port of ``pymodem_tpu.runtime.stream``.  Feed audio chunks of any size;
whenever enough samples have arrived for a fixed group of
``blocks_per_step`` blocks, one device step of the bank runtime decodes
them (``bank.bank_device_step_stream``: always the same shapes), and the
host keeps only the samples a later step may still read.  Stream addresses
are global, so a correlator bank's packets equal a one-shot
``run_banked`` of the concatenated audio.

Between steps the ``overlap + trim`` halo stays on the device: each bank
keeps the previous step's tail there, so in steady state only the new
samples go up (pinned, ``non_blocking``), in their wire dtype.  A cold
step (the first, a retry after a failed collect, a wire dtype switch)
rebuilds the window on the host and re-seeds the tail.

The decoder's progress is a plain (offset, tail) pair per bank plus the
packets not yet pruned: ``state()`` is a JSON checkpoint, the same JSON as
the JAX package's at the same point, and ``restore()`` reads either
package's checkpoints (versions 1-3).

AGC: a one-shot run normalises a coherent bank over the whole recording
(agc.py:67); a stream normalises per step group instead, as the JAX
package's stream does.  Coherent chains' byte phase may then shift by up
to one byte period against the one-shot run; payloads do not change.

``dtype`` is float32 or float64 (None: the mode's,
``device.resolve_dtype``), as the JAX package's: at float64 the banks,
frames and kernels run float64 (the parity mode's, ``runtime/bank.py``).
Deliberate differences from the JAX package: no ``method`` or ``unroll``,
as ``run_banked`` has none; the stream runs on ``device`` (``"cuda"`` by
default, which raises without a GPU); float feeds, carried as float64 on
the host as in the JAX package, go up at the stream's dtype, the one the
frames are cast to, so they take the warm path too.
"""

from __future__ import annotations

import base64
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..device import resolve, resolve_dtype, upload
from ..packets import Packet
from . import bank as bank_mod
from .bank import (
    Bank,
    BlockPlan,
    _dedup_block_boundary,
    bank_capacity,
    host_decode_block,
    slicer_window,
    sync_tolerance,
)


@dataclass
class _BankState:
    bank: Bank
    plan: BlockPlan  # geometry template (block_len / overlap / trim)
    capacity: int
    window: int  # the slicer's emission window (bank.slicer_window)
    sync_tol: int
    next_block: int = 0  # index of the next undecoded block
    # the device-resident audio tail (the overlap+trim halo between
    # steps): bank_device_step_stream returns it and the next step reads
    # it.  ``tail_block`` is the step start it is positioned for; any
    # mismatch (first step, retry after a failed collect, dtype switch)
    # takes a window built on the host and re-seeds the tail.
    tail: torch.Tensor | None = None
    tail_block: int = -1


def _check_dtype(dtype) -> torch.dtype:
    """The stream's float dtype: float32 or float64 (None: the mode's,
    ``device.resolve_dtype``); any other raises."""
    try:
        return resolve_dtype(dtype)
    except ValueError:
        raise ValueError(f"dtype {dtype!r}: the stream runs float32 or "
                         "float64") from None


class StreamDecoder:
    """Incremental decoder over a fixed chain list.

    >>> dec = StreamDecoder(chains, sample_rate=8000)
    >>> for chunk in chunks:
    ...     packets += dec.feed(chunk)
    >>> packets += dec.flush()

    ``overlap_seconds`` must cover loop acquisition plus the longest
    packet: packets that straddle a block boundary are decoded by the next
    block's halo, so a too-short overlap drops them.  The default 'auto'
    geometry protects the protocol's longest packet at each bank's bit
    rate (``bank_auto_geometry``); ``max_packet_seconds`` bounds the
    traffic's packets when they are known to be shorter.
    """

    def __init__(self, chains, sample_rate: float, dtype=None,
                 block_seconds: float | str = "auto",
                 overlap_seconds: float | str = "auto",
                 blocks_per_step: int = 4, codec: str = "device",
                 max_packets_per_block: int = 8, pipeline_depth: int = 2,
                 max_packet_seconds: float | None = None,
                 device: str | torch.device = "cuda"):
        self.dtype = _check_dtype(dtype)
        bank_mod._check_codec(codec)
        self.device = resolve(device)
        self.codec = codec
        self.max_packets_per_block = max_packets_per_block
        # steps kept in flight beyond the one being collected: device
        # memory holds (depth+1) steps' buffers while each readback hides
        # behind the next step's compute
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.blocks_per_step = blocks_per_step
        banks = bank_mod.group_chains(list(chains), self.device, self.dtype)
        if block_seconds == "auto" or overlap_seconds == "auto":
            # one feed geometry serves every bank: the widest auto choice
            geos = [bank_mod.bank_auto_geometry(b, sample_rate,
                                                max_packet_seconds)
                    for b in banks]
            if block_seconds == "auto":
                block_seconds = max(g[0] for g in geos)
            if overlap_seconds == "auto":
                overlap_seconds = max(g[1] for g in geos)
        self.block_len = max(int(block_seconds * sample_rate), 1)
        self.overlap = int(overlap_seconds * sample_rate)
        self._audio = np.zeros(0, dtype=np.float64)
        self._consumed = 0  # absolute index of self._audio[0]
        # steps dispatched but not yet collected, across feeds: a feed
        # returns once its dispatches are queued and drains only the steps
        # past pipeline_depth.  collect() runs on ONE worker thread, so a
        # readback overlaps the next step's upload and launches.
        self._pending: deque = deque()  # (state, advance_to, Future)
        self._collector = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-collect")
        self._banks: list[_BankState] = []
        for bank in banks:
            # output_oversample chains: the feed and windows stay at the
            # input rate; the plan's demod-unit geometry frames them
            plan = BlockPlan(n_audio=0, trim=bank.trim,
                             block_len=self.block_len * bank.up,
                             overlap=self.overlap * bank.up, up=bank.up,
                             trim_post=bank.trim_post)
            cap_plan = BlockPlan(
                n_audio=self.block_len + self.overlap + bank.trim + 20,
                trim=bank.trim, block_len=plan.block_len,
                overlap=plan.overlap, up=bank.up, trim_post=bank.trim_post)
            self._banks.append(_BankState(
                bank=bank, plan=plan, capacity=bank_capacity(bank, cap_plan),
                window=slicer_window(bank), sync_tol=sync_tolerance(bank)))
        self._results: dict[str, list] = {c.name: [] for c in chains}
        # per chain: deduplicated packets already returned by feed()/flush()
        self._n_emitted: dict[str, int] = {c.name: 0 for c in chains}
        # per chain: deduplicated packets pruned from the front of _results
        # (emitted packets far behind the committed frontier), so retained
        # state and checkpoints stay bounded by the stream's tail
        self._emitted_base: dict[str, int] = {c.name: 0 for c in chains}
        self._total = 0  # absolute samples received

    def _audio_window(self, start_abs: int, length: int) -> np.ndarray:
        """``length`` retained stream samples from absolute input index
        ``start_abs``, zero-padded where the stream has none (before 0 or
        past the current total)."""
        buf = np.zeros(length, dtype=self._audio.dtype)
        lo = max(start_abs, 0)
        hi = min(start_abs + length, self._total)
        if hi > lo:
            rel = lo - self._consumed
            buf[lo - start_abs: hi - start_abs] = (
                self._audio[rel: rel + (hi - lo)])
        return buf

    def _window_for(self, state: _BankState, first_block: int) -> np.ndarray:
        """The audio window of blocks_per_step blocks (plus the
        overlap+trim halo) from ``first_block``, zero-padded where the
        stream has no samples: a cold step's whole upload."""
        lin = state.plan.block_input_len
        # absolute input start: block_len input samples per block, and
        # front_pad covers the demod-unit overlap and resample halo
        a0 = first_block * self.block_len - state.plan.front_pad
        span = (self.blocks_per_step - 1) * self.block_len + lin
        return self._audio_window(a0, span)

    def _wire(self) -> torch.dtype:
        """The device dtype of the carried samples: int16 feeds keep their
        wire dtype; float ones (carried as float64) go up at the stream's
        dtype."""
        return (torch.int16 if self._audio.dtype == np.int16
                else self.dtype)

    def _upload(self, samples: np.ndarray) -> torch.Tensor:
        if samples.dtype != np.int16:
            samples = samples.astype(
                np.float64 if self.dtype == torch.float64 else np.float32)
        return upload(samples, self.device)

    def _submit_blocks(self, state: _BankState, first_block: int,
                       n_blocks: int, final: bool):
        """Dispatch one step's device work; return its collect() closure.

        A warm step (the tail positioned at ``first_block``, the same wire
        dtype) uploads only the new samples; a cold one builds the whole
        window on the host and re-seeds the tail.  The device work is the
        same either way.  collect() runs on the worker thread under the
        stream this step was submitted on, so any device work it launches
        (codec sizing on a budget-cache miss) queues behind the step."""
        lin = state.plan.block_input_len
        ext = lin - self.block_len
        warm = (state.tail is not None and state.tail_block == first_block
                and state.tail.dtype == self._wire())
        if warm:
            tail = state.tail
            a0 = first_block * self.block_len - state.plan.front_pad
            fresh = self._upload(self._audio_window(
                a0 + ext, self.blocks_per_step * self.block_len))
        else:
            window = self._window_for(state, first_block)
            tail, fresh = (self._upload(window[:ext]),
                           self._upload(window[ext:]))
        data, addr, count, sync, new_tail = bank_mod.bank_device_step_stream(
            state.bank, tail, fresh, self.blocks_per_step, self.block_len,
            ext, state.capacity, state.window, state.sync_tol)
        state.tail = new_tail
        state.tail_block = first_block + self.blocks_per_step
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        if self.codec == "device":
            # the device codec and compaction against the FIXED template
            # plan (block indices local to the step, so the budget-cache
            # key is the same every step); packets go global by block0 and
            # are clipped against the real stream length on the host
            host_plan = BlockPlan(
                n_audio=self._total, trim=state.bank.trim,
                block_len=state.plan.block_len, overlap=state.plan.overlap,
                up=state.bank.up, trim_post=state.bank.trim_post)
            collect = bank_mod._device_codec_submit_mixed(
                state.bank, state.plan, bank_mod._codec_subgroups(state.bank),
                data, addr, count, sync, self.max_packets_per_block, None,
                block0=first_block, host_plan=host_plan)
        else:
            collect = self._host_collect(state, first_block, n_blocks, final,
                                         (data, addr, count, sync))

        def on_stream():
            with (torch.cuda.stream(stream) if stream is not None
                  else nullcontext()):
                return collect()

        return on_stream

    def _host_collect(self, state: _BankState, first_block: int,
                      n_blocks: int, final: bool, arrays):
        """collect() of the host codec route: the exact state machines per
        block, with global offsets, keeping each block's packets inside
        its window (clipped to the stream on the final step)."""
        bl = state.plan.block_len
        ov = state.plan.overlap
        n_demod_total = BlockPlan(
            n_audio=self._total, trim=state.bank.trim, block_len=bl,
            overlap=ov, up=state.bank.up, trim_post=state.bank.trim_post,
        ).n_demod

        def collect():
            d, a, c, s = (t.cpu().numpy() for t in arrays)
            out: dict[str, list] = {}
            for ci, chain in enumerate(state.bank.specs):
                new_pkts = []
                for i in range(n_blocks):
                    b = first_block + i
                    n = int(c[ci, i])
                    if n == 0:
                        continue
                    pkts = host_decode_block(
                        chain, d[ci, i, :n].astype(np.int64),
                        a[ci, i, :n].astype(np.int64) + b * bl - ov,
                        s[ci, i])
                    lo, hi = b * bl, (b + 1) * bl
                    if final and b * bl < n_demod_total:
                        hi = min(hi, max(n_demod_total, 0))
                    new_pkts.extend(p for p in pkts
                                    if lo < p.streamaddress <= hi)
                out[chain.name] = new_pkts
            return out

        return collect

    def feed(self, chunk: np.ndarray) -> list:
        """Append samples; decode every block that is now complete.

        Returns the newly decoded packets (globally addressed, block
        boundary repeats removed).  int16 chunks keep their wire dtype to
        the card (int16 -> float32 or float64 there is exact); anything else
        is carried as float64 and uploaded at the stream's dtype."""
        chunk = np.asarray(chunk)
        if chunk.dtype != np.int16:
            chunk = chunk.astype(np.float64)
        if self._audio.dtype != chunk.dtype:
            if self._total == 0 and len(self._audio) == 0:
                self._audio = self._audio.astype(chunk.dtype)
            else:  # mixed dtypes across feeds: carry everything as f64
                self._audio = self._audio.astype(np.float64)
                chunk = chunk.astype(np.float64)
        self._audio = np.concatenate([self._audio, chunk])
        self._total += len(chunk)
        # pipelined across feeds: up to pipeline_depth steps stay in
        # flight when feed() returns.  state.next_block commits only after
        # a step's collect succeeds, so after a failed collect the retry
        # feed re-submits the uncollected blocks (their audio is still
        # retained: retention keys off the committed cursor)
        for state in self._banks:
            # block b reads the input window [b*L - front_pad,
            # b*L - front_pad + block_input_len); submit once complete
            cursor = self._cursor(state)
            while True:
                last = cursor + self.blocks_per_step - 1
                need = (last * self.block_len - state.plan.front_pad
                        + state.plan.block_input_len)
                if need > self._total:
                    break
                self._pending.append((
                    state, cursor + self.blocks_per_step,
                    self._collector.submit(self._submit_blocks(
                        state, cursor, self.blocks_per_step, final=False)),
                ))
                cursor += self.blocks_per_step
                while len(self._pending) > self.pipeline_depth:
                    self._drain_one()
        while len(self._pending) > self.pipeline_depth:
            self._drain_one()
        # drop audio no bank will read again (committed cursors only, so a
        # failed collect can always re-read its blocks' samples)
        min_needed_from = self._total
        for state in self._banks:
            needed_from = (state.next_block * self.block_len
                           - state.plan.front_pad)
            min_needed_from = min(min_needed_from, max(needed_from, 0))
        drop = min_needed_from - self._consumed
        if drop > 0:
            self._audio = self._audio[drop:]
            self._consumed += drop
        return self._emit_fresh()

    def _cursor(self, state: _BankState) -> int:
        """Next block index not yet submitted (the committed cursor or the
        end of this bank's in-flight steps)."""
        cursor = state.next_block
        for st, advance_to, _future in self._pending:
            if st is state:
                cursor = max(cursor, advance_to)
        return cursor

    def _drain_one(self) -> None:
        # .result() re-raises a failed collect here, before next_block
        # advances.  On failure the WHOLE in-flight pipeline is abandoned:
        # later steps' advance_to values feed _cursor, so leaving them
        # queued would let the next commit jump next_block past the failed
        # step's blocks (silent packet loss).  The retry feed re-submits
        # everything from the committed cursors.
        state, advance_to, future = self._pending.popleft()
        try:
            results = future.result()
        except BaseException:
            self._pending.clear()
            raise
        for name, pkts in results.items():
            self._results[name].extend(pkts)
        state.next_block = advance_to

    def drain(self) -> list:
        """Collect every in-flight step (without submitting new work)."""
        while self._pending:
            self._drain_one()
        return self._emit_fresh()

    def flush(self) -> list:
        """Decode the final partial blocks; returns the remaining packets."""
        for state in self._banks:
            bank = state.bank
            n_demod = (self._total * bank.up - state.plan.trim * bank.up
                       - bank.trim_post)
            last_block = max(-(-n_demod // state.plan.block_len) - 1, -1)
            if last_block < self._cursor(state):
                continue
            for start in range(self._cursor(state), last_block + 1,
                               self.blocks_per_step):
                n = min(self.blocks_per_step, last_block - start + 1)
                self._pending.append((
                    state, start + n,
                    self._collector.submit(self._submit_blocks(
                        state, start, n, final=True)),
                ))
                while len(self._pending) > self.pipeline_depth:
                    self._drain_one()
        while self._pending:
            self._drain_one()
        return self._emit_fresh()

    def _emit_fresh(self) -> list:
        """Newly deduplicated packets since the last feed()/flush().

        Blocks decode in address order per chain, so the deduplicated list
        only grows at its tail: the suffix past the emitted count is
        what packets() has gained.  Emitted packets far behind the
        committed frontier are then pruned."""
        fresh: list = []
        for state in self._banks:
            for chain in state.bank.specs:
                name = chain.name
                deduped = _dedup_block_boundary(list(self._results[name]),
                                                chain)
                start = self._n_emitted[name] - self._emitted_base[name]
                fresh.extend(deduped[start:])
                self._n_emitted[name] = (self._emitted_base[name]
                                         + len(deduped))
                self._prune_chain(state, chain)
        return fresh

    def _prune_chain(self, state: _BankState, chain) -> None:
        """Drop emitted packets that can no longer dedup against anything:
        addresses at least a block + overlap + dedup window behind the
        committed frontier, cut only across an address gap wider than the
        dedup window so that no duplicate pair spans the cut."""
        name = chain.name
        raw = self._results[name]
        if len(raw) < 64:
            return
        sl = chain.slicer
        window = 16.0 * sl.sample_rate / sl.symbol_rate
        cutoff = (state.next_block * state.plan.block_len
                  - state.plan.block_len - state.plan.overlap - window)
        cut = 0
        for i, p in enumerate(raw):
            if p.streamaddress > cutoff:
                break
            nxt = raw[i + 1].streamaddress if i + 1 < len(raw) else None
            if nxt is None or nxt - p.streamaddress >= window:
                cut = i + 1
        if cut:
            self._emitted_base[name] += len(
                _dedup_block_boundary(raw[:cut], chain))
            self._results[name] = raw[cut:]

    def packets(self) -> dict[str, list]:
        """Retained packets per chain, block-boundary deduplicated.

        Long streams prune emitted packets far behind the frontier (the
        feed()/flush() return values carry the whole stream); short runs
        retain everything."""
        name_to_chain = {c.name: c for st in self._banks
                         for c in st.bank.specs}
        return {name: _dedup_block_boundary(list(pkts), name_to_chain[name])
                for name, pkts in self._results.items()}

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------

    def state(self) -> dict:
        """JSON-serialisable checkpoint of the decode progress, the JAX
        package's version 3: the retained audio tail (zlib-compressed,
        base64), the stream counters, each bank's block progress and the
        retained packets.  In-flight steps are collected first (without
        emitting: their packets come back from feed()/flush() after a
        restore).  Restore into a new StreamDecoder built with the same
        chains and settings:

        >>> blob = json.dumps(dec.state())
        >>> dec2 = StreamDecoder(chains, rate, ...)   # same construction
        >>> dec2.restore(json.loads(blob))
        """
        while self._pending:
            self._drain_one()
        tail = np.ascontiguousarray(self._audio)
        return {
            "version": 3,
            "consumed": int(self._consumed),
            "total": int(self._total),
            "audio_tail": {
                "dtype": str(tail.dtype),
                "b64z": base64.b64encode(
                    zlib.compress(tail.tobytes())).decode("ascii"),
            },
            "next_block": [st.next_block for st in self._banks],
            "n_emitted": dict(self._n_emitted),
            "emitted_base": dict(self._emitted_base),
            "results": {name: [asdict(p) for p in pkts]
                        for name, pkts in self._results.items()},
        }

    def restore(self, state: dict) -> None:
        """Restore a state() checkpoint (of either package, versions 1-3)
        into this freshly built decoder.  It must have the same chains and
        block geometry as the decoder that wrote it; feeds after the
        restore give the packets of an uninterrupted decode."""
        if state.get("version") not in (1, 2, 3):
            raise ValueError(
                f"unknown checkpoint version: {state.get('version')!r}")
        if len(state["next_block"]) != len(self._banks):
            raise ValueError("checkpoint bank count does not match decoder")
        if set(state["results"]) != set(self._results):
            raise ValueError("checkpoint chain names do not match decoder")
        self._consumed = int(state["consumed"])
        self._total = int(state["total"])
        tail = state["audio_tail"]
        if isinstance(tail, dict):  # v2, v3: compressed raw samples
            self._audio = np.frombuffer(
                zlib.decompress(base64.b64decode(tail["b64z"])),
                dtype=np.dtype(tail["dtype"])).copy()
        else:  # v1: a JSON float list
            self._audio = np.asarray(tail, dtype=np.float64)
        for st, nb in zip(self._banks, state["next_block"]):
            st.next_block = int(nb)
        self._n_emitted = {k: int(v) for k, v in state["n_emitted"].items()}
        self._emitted_base = {
            k: int(v) for k, v in state.get(
                "emitted_base", {k: 0 for k in state["results"]}).items()}
        self._results = {name: [Packet(**d) for d in pkts]
                         for name, pkts in state["results"].items()}
