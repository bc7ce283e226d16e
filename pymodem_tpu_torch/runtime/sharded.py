"""Multi-device execution: the bank program over a ('chain', 'time') mesh.

Port of ``pymodem_tpu.runtime.sharded`` to ``torch.distributed``, one rank
per shard.  The JAX package runs one SPMD program under ``shard_map``; here
every rank runs the single-device bank program on its own shard and calls
collectives where the JAX program has them.  Every rank calls
``run_banked_sharded`` with the whole recording on its host and returns
the same ``{chain_name: [Packet]}``.

* Mesh axis ``chain``: each codec sub-group of a bank's chains is padded
  to a multiple of the axis (``_reorder_pad_bank``) and every rank takes
  its 1/n_chain of each sub-group (``bank.bank_chain_slice``, parameters
  included); no communication.
* Mesh axis ``time``: the overlap-save block axis.  The block count is
  padded to a multiple of the axis with all-zero blocks, and each rank
  frames and uploads only its own blocks' windows (``frame_blocks_host``:
  ~n_audio/n_time plus the per-block halo).  The halos are in the frames,
  so no shard reads a neighbour's samples; the one cross-shard dependence,
  the AGC's whole-recording max (agc.py:67), is a MAX all-reduce over the
  time group, the ``normal_fn`` hook of ``bank._input_bpf``.  A shard
  whose blocks pass ``max_blocks_per_step`` runs them in groups, each with
  its own all-reduce (the JAX program's in-shard ``lax.map``).
* The device codec runs on each shard through the single-device
  machinery, ``bank._device_codec_submit``, with its readback replaced
  (``_ShardReadback``): the device addresses and keeps packets from the
  shard's first global block, each shard compacts into one packed buffer
  of the same static size, and the buffers are gathered ONCE per codec
  sub-group, on the host, and merged (``_merge_shard_compacts``).  Budgets
  come from two-scalar reductions, a local reduction and a MAX all-reduce
  over the world, and are cached per workload shape
  (``_SHARDED_BUDGET_CACHE``): a warm call reads nothing back before its
  gathers.  Every branch of the budget logic is decided from all-reduced
  or gathered values, so every rank issues the same collectives in the
  same order.

Launch: ``spawn(fn, n_ranks, device_type, *args)`` starts the ranks
(``torch.multiprocessing``, start method ``spawn``) and initialises them
through a ``file://`` store in a temporary directory; inside a rank
``make_mesh`` builds the DeviceMesh.  Backends: ``gloo`` for CPU ranks;
``cpu:gloo,cuda:nccl`` with one rank a GPU; ``cpu:gloo,cuda:gloo`` where
ranks share a GPU (NCCL refuses two ranks on one device).  A mesh of
``device_type="cuda"`` without a GPU raises; a rank that fails fails the
call, and nothing reruns a shard elsewhere.

The dry run ``python -m pymodem_tpu_torch.runtime.sharded N [--device
cpu]`` (``dryrun_multichip``) decodes a mixed IL2P/AX.25 bank whose chain
count does not divide the mesh and checks the warm call's contract.

Like the JAX package, the sharded runtime has no CLI, server or stream
route.
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback
from dataclasses import replace
from datetime import timedelta
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from .. import profiling
from ..device import resolve, resolve_dtype, upload
from . import bank as bank_mod
from .bank import BlockPlan

MESH_DIMS = ("chain", "time")
# the process group's timeout: a collective whose peer is gone fails after
# this long (torch's default is 30 minutes)
TIMEOUT = timedelta(minutes=5)

# ---------------------------------------------------------------------------
# Ranks and the mesh
# ---------------------------------------------------------------------------


def backend_for(n_ranks: int, device_type: str) -> str:
    """The process-group backend: ``gloo`` for CPU ranks; for CUDA ranks
    gloo for host tensors and NCCL for device tensors when each rank has a
    GPU of its own, gloo for both when ranks share a GPU."""
    if device_type == "cpu":
        return "gloo"
    if n_ranks <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "cpu:gloo,cuda:gloo"


def _rank_main(rank, n_ranks, init_method, device_type, timeout, fn, args,
               conn) -> None:
    """One rank: join the group, run ``fn(*args)``, send ("ok", result) or
    ("err", traceback) to the launcher."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend_for(n_ranks, device_type),
                                init_method=init_method,
                                world_size=n_ranks, rank=rank,
                                timeout=timeout)
        out = fn(*args)
    except BaseException:  # noqa: BLE001 - reported to the launcher
        conn.send(("err", traceback.format_exc()))
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    conn.send(("ok", out))
    conn.close()
    dist.destroy_process_group()


def spawn(fn, n_ranks: int, device_type: str = "cuda", *args,
          timeout: timedelta = TIMEOUT) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined in one
    process group (rank r on ``cuda:{r % device_count}``, or the CPU);
    return each rank's result, by rank.  ``fn`` and ``args`` must pickle
    (``fn`` a module-level function).  The group is initialised through a
    ``file://`` store in a temporary directory, so launchers running side
    by side never share a port.  If a rank raises or exits early, this
    raises with its traceback and kills the other ranks; it never returns
    a partial result."""
    import multiprocessing.connection as mpc

    import torch.multiprocessing as mp

    if device_type == "cuda":
        resolve("cuda")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs, pipes = [], []
        try:
            for rank in range(n_ranks):
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(
                    target=_rank_main,
                    args=(rank, n_ranks, init, device_type, timeout, fn, args,
                          send), daemon=True)
                proc.start()
                send.close()
                procs.append(proc)
                pipes.append(recv)
            results: dict[int, object] = {}
            while len(results) < n_ranks:
                for pipe in mpc.wait([p for r, p in enumerate(pipes)
                                      if r not in results]):
                    rank = pipes.index(pipe)
                    try:
                        status, out = pipe.recv()
                    except EOFError:
                        procs[rank].join(10)
                        raise RuntimeError(
                            f"rank {rank} of {n_ranks} exited (code "
                            f"{procs[rank].exitcode}) without a result"
                        ) from None
                    if status != "ok":
                        raise RuntimeError(
                            f"rank {rank} of {n_ranks} failed:\n{out}")
                    results[rank] = out
            for proc in procs:
                proc.join(timeout.total_seconds())
            return [results[r] for r in range(n_ranks)]
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()


def make_mesh(n_chain: int, n_time: int, device_type: str = "cuda"):
    """The ('chain', 'time') DeviceMesh over an initialised world of
    exactly ``n_chain * n_time`` ranks, row-major: rank = chain index *
    n_time + time index.  Rank r computes on ``cuda:{r % device_count}``;
    ``device_type="cpu"`` only when asked.  Raises without a GPU for
    ``cuda``."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        resolve("cuda")
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or spawn)")
    if dist.get_world_size() != n_chain * n_time:
        raise ValueError(f"a ({n_chain}, {n_time}) mesh needs "
                         f"{n_chain * n_time} ranks, the world has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (n_chain, n_time),
                            mesh_dim_names=MESH_DIMS)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return resolve(torch.device("cuda", torch.cuda.current_device()))
    return torch.device("cpu")


def gather_to_host(x, mesh) -> np.ndarray:
    """All-gather ``x`` (a tensor on any device, or a numpy array) over the
    whole mesh, on the host: every rank ends with the same (n_chain,
    n_time, *x.shape) numpy stack, rank order row-major (the JAX package's
    ``process_allgather(tiled=True)``)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    with profiling.timed("host_wait"):
        t = t.detach().cpu().contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
    return torch.stack(parts).reshape(*mesh.mesh.shape, *t.shape).numpy()


def _gather_grid(x, mesh) -> torch.Tensor:
    """Every rank's (c_local, b_local, ...) block of a (C, B, ...) array,
    gathered and placed: the whole (C, B, ...) array as a CPU tensor."""
    g = gather_to_host(x, mesh)  # (n_chain, n_time, c_local, b_local, ...)
    n_chain, n_time, c_local, b_local = g.shape[:4]
    g = np.ascontiguousarray(np.moveaxis(g, 1, 2))
    return torch.from_numpy(g.reshape(n_chain * c_local, n_time * b_local,
                                      *g.shape[4:]))


def _world_max(t: torch.Tensor) -> list[int]:
    """A local integer reduction's values, each the largest over every
    rank (one MAX all-reduce of the host copy)."""
    with profiling.timed("host_wait"):
        v = t.detach().cpu().to(torch.int64).reshape(-1)
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
    return [int(a) for a in v.tolist()]


def _time_max(group):
    """``normal_fn`` under sharding: the AGC normals of a shard's blocks
    all-reduced to their MAX over the time group, on the device (the JAX
    program's ``lax.pmax(n, "time")``)."""
    def normal_fn(normals: torch.Tensor) -> torch.Tensor:
        normals = normals.contiguous()
        dist.all_reduce(normals, op=dist.ReduceOp.MAX, group=group)
        profiling.count("sharded_agc_normal")
        return normals

    return normal_fn


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def blocks_per_shard(plan: BlockPlan, n_time: int) -> int:
    """Blocks of each time shard: the plan's, padded up to a multiple of
    the time axis with all-zero blocks."""
    return -(-plan.n_blocks // n_time)


def frame_blocks_host(audio: np.ndarray, plan: BlockPlan, n_time: int = 1,
                      t: int = 0) -> np.ndarray:
    """Host-side overlap-save framing of time shard ``t`` of ``n_time``:
    its (blocks_per_shard, block_input_len) rows of the frame matrix that
    ``bank.frame_blocks`` makes of the whole recording (block b starts at
    input sample b * stride_in of the front-padded recording), followed by
    all-zero rows past the plan's blocks, in the audio's own dtype.  Only
    the shard's window of the recording is read, so a rank holds
    ~n_audio/n_time plus its blocks' halos."""
    audio = np.asarray(audio)
    b_local = blocks_per_shard(plan, n_time)
    start = t * b_local * plan.stride_in  # in padded-recording samples
    n = b_local * plan.stride_in + plan.block_input_len - plan.stride_in
    window = np.zeros(n, audio.dtype)
    a0 = max(start - plan.front_pad, 0)
    a1 = min(start + n - plan.front_pad, len(audio))
    if a1 > a0:
        window[a0 + plan.front_pad - start: a1 + plan.front_pad - start] = \
            audio[a0:a1]
    step = window.strides[0]
    rows = np.lib.stride_tricks.as_strided(
        window, (b_local, plan.block_input_len),
        (step * plan.stride_in, step)).copy()
    rows[max(plan.n_blocks - t * b_local, 0):] = 0  # the padding blocks
    return rows


def upload_bound(plan: BlockPlan, n_time: int) -> int:
    """The most input samples a time shard's frames may hold: its share of
    the recording plus each of its blocks' halo and one block, n_audio /
    n_time + blocks_per_shard * (block_input_len - stride_in) + stride_in
    (for ``up == 1``: + blocks_per_shard * (overlap + trim) + block_len,
    the JAX package's bound)."""
    b_local = blocks_per_shard(plan, n_time)
    return (plan.n_audio // n_time
            + b_local * (plan.block_input_len - plan.stride_in)
            + plan.stride_in)


# ---------------------------------------------------------------------------
# Chain axis: codec sub-groups padded to the mesh
# ---------------------------------------------------------------------------


_PAD_PREFIX = "__pad"


def _reorder_pad_bank(bank, n_chain: int, subgroups):
    """Reorder a bank's chains so codec sub-groups are contiguous, padding
    each to a multiple of the chain axis with clones of its first chain
    under reserved ``__pad{i}~name`` names, whose packets are dropped by
    name.  Every rank then holds the same number of chains of each
    sub-group, so every collective sees equal shapes.  ``subgroups``:
    ``bank._codec_subgroups``'s list, or None (the host codec: one group
    of all chains).  Returns (bank, [(codec_key, lo, hi)])."""
    if subgroups is None:
        subgroups = [(None, list(range(len(bank.specs))))]
    perm: list[int] = []
    specs: list = []
    slices: list[tuple] = []
    n_pad = 0
    for key, idxs in subgroups:
        lo = len(perm)
        perm.extend(idxs)
        specs.extend(bank.specs[i] for i in idxs)
        for _ in range(-len(idxs) % n_chain):
            s0 = bank.specs[idxs[0]]
            perm.append(idxs[0])
            specs.append(replace(s0, name=f"{_PAD_PREFIX}{n_pad}~{s0.name}"))
            n_pad += 1
        slices.append((key, lo, len(perm)))
    if perm == list(range(len(bank.specs))):
        return bank, slices  # already contiguous and aligned
    return replace(bank_mod.bank_chain_slice(bank, perm), specs=specs), slices


def _shard_chains(slices, n_chain: int, c: int):
    """Chain shard ``c``'s chains of the padded bank: its 1/n_chain of each
    sub-group, and each sub-group's (codec_key, lo, hi, a, b): global
    chains [lo, hi) and the shard's local rows [a, b)."""
    mine: list[int] = []
    local = []
    for key, lo, hi in slices:
        k = (hi - lo) // n_chain
        local.append((key, lo, hi, len(mine), len(mine) + k))
        mine.extend(range(lo + c * k, lo + (c + 1) * k))
    return mine, local


# ---------------------------------------------------------------------------
# The per-shard device codec and its one gather
# ---------------------------------------------------------------------------


# Steady-state per-shard codec budgets per (codec options, block geometry,
# shard shape): a repeat call with the same workload shape skips
# both sizing reductions and gathers each sub-group's packed buffers once.
# Every undershoot is detected (``dropped`` per block; a compaction
# overflow from the sizes in each shard's buffer), so correctness never
# depends on the cache.  Each rank keeps its own, and they stay equal:
# every entry is written from all-reduced or gathered values.
_SHARDED_BUDGET_CACHE: dict = {}


def _merge_shard_compacts(packed: np.ndarray, has_corrected: bool,
                          meta_budget: int, len_budget: int,
                          c_local: int, b_local: int):
    """Merge the gathered per-shard packed buffers (n_chain, n_time, L)
    into one compact dict over the sub-group (local chain and block
    indices made global, byte bases offset by the preceding shards'
    streams).  Returns (n_ok_total, shard_ok_max, max_len, comp,
    dropped)."""
    n_chain, n_time = packed.shape[:2]
    keys = [k for k in bank_mod.COMPACT_META_KEYS
            if has_corrected or k != "corrected"]
    merged: dict[str, list] = {k: [] for k in keys}
    parts: list[np.ndarray] = []
    dropped = np.zeros((n_chain * c_local, n_time * b_local), np.int32)
    n_ok_total = shard_ok_max = max_len_all = byte_off = 0
    for i in range(n_chain):
        for j in range(n_time):
            (n_ok, _bytes, max_len), comp, drp = bank_mod._read_compact(
                packed[i, j], meta_budget, len_budget, (c_local, b_local),
                has_corrected)
            shard_ok_max = max(shard_ok_max, n_ok)
            max_len_all = max(max_len_all, max_len)
            n_keep = min(n_ok, meta_budget)
            shift = {"chain": i * c_local, "block": j * b_local,
                     "base": byte_off}
            for k in keys:
                merged[k].append(comp[k][:n_keep].astype(np.int64)
                                 + shift.get(k, 0))
            parts.append(comp["bytes"])
            byte_off += len(comp["bytes"])
            dropped[i * c_local:(i + 1) * c_local,
                    j * b_local:(j + 1) * b_local] = drp
            n_ok_total += n_keep
    comp_all = {k: np.concatenate(v) for k, v in merged.items()}
    comp_all["bytes"] = np.concatenate(parts)
    return n_ok_total, shard_ok_max, max_len_all, comp_all, dropped


class _ShardReadback(bank_mod.CodecReadback):
    """``bank._device_codec_submit``'s readback on one rank of a mesh:
    every integer statistic is a MAX over the ranks, the packed buffer is
    gathered from every shard and merged (``_merge_shard_compacts``), and
    the byte streams for the host FSM are gathered only when some block
    is still dropped.  The device addresses and keeps packets from the
    shard's first global block, so everything read back is global; every
    rank reads the same values and takes the same branches."""

    stage = "sharded_codec"
    sizing = "sharded_codec_sizing"
    budget = "sharded_candidate_budget"
    cache = _SHARDED_BUDGET_CACHE
    ints = staticmethod(_world_max)

    def __init__(self, mesh, plan: BlockPlan, block0: int):
        self.mesh, self.n_blocks, self.device_block0 = (
            mesh, plan.n_blocks, block0)

    def packed(self, packed, meta_budget, len_budget, dropped_shape,
               has_corrected, now):
        def wait():
            n_ok, n_ok_max, max_len, comp, dropped = _merge_shard_compacts(
                gather_to_host(packed, self.mesh), has_corrected,
                meta_budget, len_budget, *dropped_shape)
            # the time axis's all-zero blocks past the plan decode nothing
            return n_ok, n_ok_max, max_len, comp, dropped[:, :self.n_blocks]

        return wait

    def host_arrays(self, data, addr, count, sync, dropped):
        if not dropped.any():
            return (None,) * 4  # read only for blocks still dropped
        profiling.count("host_codec", int((dropped > 0).sum()))
        return tuple(_gather_grid(x, self.mesh)
                     for x in (data, addr, count, sync))


def _host_codec_collect(mesh, bank, plan: BlockPlan, sync_tol: int, arrays):
    """``codec="host"``: gather every shard's byte streams and sync maps,
    then run the exact state machines over the whole bank on every
    rank."""
    with profiling.timed("sharded_codec_transfer"):
        full = tuple(_gather_grid(x, mesh) for x in arrays)
    return bank_mod.host_codec_collect(bank, plan, sync_tol, full)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def run_banked_sharded(chains, audio: np.ndarray, mesh, dtype=None,
                       block_seconds: float | str = "auto",
                       overlap_seconds: float | str = "auto",
                       codec: str = "device", max_packets_per_block: int = 8,
                       total_candidates: int | None = None,
                       max_blocks_per_step: int | None | str = "auto",
                       max_packet_seconds: float | None = None
                       ) -> dict[str, list]:
    """The sharded ``bank.run_banked``: called by every rank of ``mesh``
    (``make_mesh``) with the whole recording; every rank returns the same
    {chain_name: [Packet]}.

    The block plan is ``run_banked``'s (from the unpadded bank), so block
    boundaries, and the packets, are the same.  Any chain count works
    (``_reorder_pad_bank``), and the block count is padded up to a
    multiple of the time axis.  ``max_blocks_per_step`` bounds a shard's
    working set: 'auto' sizes its block groups as ``run_banked`` does
    (``bank.blocks_per_group``), None runs its blocks in one pass.
    ``dtype``: float32 or float64 (None: the mode's); at float64 the
    shards launch the f64 kernels, as ``run_banked`` does.

    ``codec="device"`` (the default) decodes on each shard, one device
    codec per codec sub-group with one packed gather each
    (``bank._device_codec_submit`` through ``_ShardReadback``);
    ``codec="host"`` gathers the byte streams
    and runs the exact state machines on every rank."""
    bank_mod._check_codec(codec)
    dtype = resolve_dtype(dtype)
    dev = _mesh_device(mesh)
    n_chain, n_time = mesh.mesh.shape
    c_idx, t_idx = mesh.get_coordinate()
    normal_fn = _time_max(mesh.get_group("time"))
    wire = bank_mod._wire(audio, dtype)
    collects = []
    for bank0 in bank_mod.group_chains(list(chains), dev, dtype):
        plan = bank_mod.bank_plan(bank0, len(wire), block_seconds,
                                  overlap_seconds, max_packet_seconds)
        groups = bank_mod._codec_subgroups(bank0) if codec == "device" \
            else None
        bank, slices = _reorder_pad_bank(bank0, n_chain, groups)
        mine, local = _shard_chains(slices, n_chain, c_idx)
        sub = bank_mod.bank_chain_slice(bank, mine)
        b_local = blocks_per_shard(plan, n_time)
        rows = frame_blocks_host(wire, plan, n_time, t_idx)
        profiling.count("sharded_upload_samples", rows.size)
        per_group = (b_local if max_blocks_per_step is None else
                     bank_mod.blocks_per_group(sub, plan, b_local)
                     if max_blocks_per_step == "auto"
                     else int(max_blocks_per_step))
        tol = bank_mod.sync_tolerance(bank)
        with profiling.timed("sharded_bank_step"):
            arrays = bank_mod._compute_groups(
                sub, upload(rows, dev), per_group,
                bank_mod.bank_capacity(bank, plan), tol, normal_fn)
        if codec == "host":
            collects.append(partial(_host_codec_collect, mesh, bank, plan,
                                    tol, arrays))
            continue
        io = _ShardReadback(mesh, plan, t_idx * b_local)
        for key, lo, hi, a, b in local:
            # the codec stage holds the sub-group's chains over all shards
            collects.append(bank_mod._device_codec_submit(
                bank_mod._bank_chain_subset(bank, list(range(lo, hi))),
                plan, key, *(x[a:b] for x in arrays), max_packets_per_block,
                total_candidates, io=io))
    results: dict[str, list] = {}
    for collect in collects:
        results.update({name: pkts for name, pkts in collect().items()
                        if not name.startswith(_PAD_PREFIX)})
    return results



# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

DRYRUN_KW = dict(codec="device", block_seconds=1.0, overlap_seconds=0.6)


def dryrun_case():
    """The dry run's chains and audio (the JAX package's
    ``__graft_entry__.dryrun_multichip``): one 3-chain AFSK-1200 bank at
    8 kHz mixing codecs, two IL2P chains that differ only in descrambler
    invert and an AX.25 chain, each decoding its own segment of the
    concatenated audio (3 frames of 24 bytes each, rng 11).  Three chains
    never divide a chain axis of 2, so the bank is padded too."""
    from ..config import (
        AFSKModemSpec,
        AX25CodecSpec,
        BinarySlicerSpec,
        ChainSpec,
        IL2PCodecSpec,
        LFSRStreamSpec,
    )
    from ..synth import fixtures as fx
    from ..synth import modulate as mod

    rate = 8000.0
    rng = np.random.default_rng(11)

    def chain(name, invert, codec):
        return ChainSpec(
            name=name, modem=AFSKModemSpec(sample_rate=rate),
            slicer=BinarySlicerSpec(sample_rate=rate, symbol_rate=1200.0,
                                    lock_rate=0.75),
            stream=LFSRStreamSpec(polynomial=0x3, invert=invert),
            codec=codec)

    chains, segments = [], []
    for i, invert in enumerate((False, True)):
        line = fx.il2p_line_bits(fx.payloads(rng, count=3, size=24),
                                 polynomial=0x3, invert=invert,
                                 gap_bits=2000)
        segments.append(mod.afsk_modulate(line, rate, 1200.0, 1200.0,
                                          2200.0))
        chains.append(chain(f"dry{i}", invert, IL2PCodecSpec(ident=f"dry{i}")))
    line = fx.ax25_line_bits(fx.payloads(rng, count=3, size=24),
                             polynomial=0x3, invert=False, gap_bits=2000)
    segments.append(mod.afsk_modulate(line, rate, 1200.0, 1200.0, 2200.0))
    chains.append(chain("dryax", False, AX25CodecSpec(ident="dryax")))
    return chains, np.concatenate(segments).astype(np.float32)


def packet_rows(by_name: dict) -> dict:
    """{chain: [(address, bytes)]}: what two runs are held equal by."""
    return {name: [(int(p.streamaddress), bytes(p.data)) for p in pkts]
            for name, pkts in by_name.items()}


def _dryrun_rank(n_chain: int, n_time: int, device_type: str) -> dict:
    """One rank of the dry run: a cold and a warm call, the warm one
    counted (``profiling``)."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(n_chain, n_time, device_type)
    chains, audio = dryrun_case()
    _SHARDED_BUDGET_CACHE.clear()
    first = run_banked_sharded(chains, audio, mesh, **DRYRUN_KW)
    profiling.reset()
    profiling.enable(True)
    try:
        again = run_banked_sharded(chains, audio, mesh, **DRYRUN_KW)
    finally:
        profiling.enable(False)
    return dict(first=packet_rows(first), again=packet_rows(again),
                counts=profiling.counts())


def dryrun_multichip(n_ranks: int, device_type: str = "cuda") -> dict:
    """The sharded fast path end to end on ``n_ranks`` spawned ranks, a
    mesh of ``n_ranks // n_time`` chains x ``n_time = max(n_ranks // 2,
    1)`` time shards: ``run_banked_sharded`` on ``dryrun_case()`` twice,
    asserting on every rank one packed gather per codec sub-group (2), no
    block on the host FSM and no sizing reduction in the warm call, equal
    packets in both calls and on every rank, and at least 3 packets a
    chain.  Prints one ``dryrun_multichip OK`` line; returns rank 0's
    result (``_dryrun_rank``)."""
    n_time = max(n_ranks // 2, 1)
    n_chain = n_ranks // n_time
    outs = spawn(_dryrun_rank, n_chain * n_time, device_type, n_chain,
                 n_time, device_type)
    for rank, out in enumerate(outs):
        c = out["counts"]
        if (c.get("sharded_codec_transfer", 0) != 2
                or c.get("host_codec", 0)
                or c.get("sharded_codec_sizing", 0)
                or c.get("sharded_candidate_budget", 0)):
            raise AssertionError(f"rank {rank}: warm-call counts {c}")
        if out["again"] != out["first"] or out["first"] != outs[0]["first"]:
            raise AssertionError(f"rank {rank}: packets differ between the "
                                 f"calls or from rank 0's")
        short = {k: len(v) for k, v in out["first"].items() if len(v) < 3}
        if short:
            raise AssertionError(f"rank {rank}: chains under 3 packets "
                                 f"{short}")
    counts = {k: len(v) for k, v in outs[0]["first"].items()}
    print(f"dryrun_multichip OK: mesh(chain={n_chain}, time={n_time}) on "
          f"{device_type}, mixed il2p+ax25 bank with dead-lane padding, "
          f"packets per chain {counts}, warm call = one packed gather per "
          f"codec sub-group, zero sizing reductions, zero host-FSM blocks")
    return outs[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m pymodem_tpu_torch.runtime.sharded",
        description="Dry run of the sharded runtime on N spawned ranks.")
    ap.add_argument("n_ranks", type=int, nargs="?", default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)
    return 0


if __name__ == "__main__":
    # run through the package's module, so the ranks unpickle its functions
    from pymodem_tpu_torch.runtime import sharded as _sharded

    raise SystemExit(_sharded.main())
