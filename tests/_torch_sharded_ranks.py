"""Rank functions of tests/test_torch_sharded.py.

Each runs inside a rank that ``pymodem_tpu_torch.runtime.sharded.spawn``
started on the CPU, so it imports no JAX: a rank unpickles the function by
this module's name and imports only torch and the port.  Each runs every
case of one mesh shape in the one spawn and returns plain values
(packets as (address, bytes) rows, profiling counts).
"""

import torch
import torch.distributed as dist

from pymodem_tpu_torch import profiling
from pymodem_tpu_torch.runtime import sharded


def _counted(fn):
    """(fn(), the profiling counts of that call)."""
    profiling.reset()
    profiling.enable(True)
    try:
        out = fn()
    finally:
        profiling.enable(False)
    return out, profiling.counts()


def time_axis(chains, audio, kw):
    """Mesh (1, 2): the AFSK-PLL pair's blocks over two time shards, the
    AGC normal all-reduced over them, its uploads counted."""
    torch.set_num_threads(1)
    mesh = sharded.make_mesh(1, 2, "cpu")
    out, counts = _counted(
        lambda: sharded.run_banked_sharded(chains, audio, mesh, **kw))
    return dict(packets=sharded.packet_rows(out), counts=counts,
                rank=dist.get_rank())


def chain_axis(chains, audio, grown, kw, dense, dense_audio, dense_kw):
    """Mesh (2, 1): a space-gain sweep's chains over two chain shards, on
    the device codec and on the host codec; then, on the budgets the first
    call cached, a recording of the same length whose packets are longer
    (the cached compaction overflows: a redo); then a dense recording on
    budgets too small for it (escalation, then the host FSM)."""
    torch.set_num_threads(1)
    mesh = sharded.make_mesh(2, 1, "cpu")
    device = sharded.run_banked_sharded(chains, audio, mesh, **kw)
    host = sharded.run_banked_sharded(chains, audio, mesh, codec="host",
                                      **kw)
    redo, redo_counts = _counted(
        lambda: sharded.run_banked_sharded(chains, grown, mesh, **kw))
    forced, forced_counts = _counted(
        lambda: sharded.run_banked_sharded([dense], dense_audio, mesh,
                                           **dense_kw))
    return dict(device=sharded.packet_rows(device),
                host=sharded.packet_rows(host),
                redo=sharded.packet_rows(redo), redo_counts=redo_counts,
                forced=sharded.packet_rows(forced),
                forced_counts=forced_counts)


def fail_on_rank(bad: int):
    """Rank ``bad`` raises after the group is up; the others wait in a
    collective that it never joins."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()
