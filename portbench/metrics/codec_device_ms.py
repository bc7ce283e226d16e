"""codec_device_ms: device time of the device codecs (``codecs/
il2p_device.py``, ``codecs/ax25_device.py``: sync search, RS, CRC,
deframing), per recording: every device operation launched inside the
port's ``pymodem.device_codec_step`` ranges (``runtime/bank.
_device_codec_submit``), traced to its launch by the profiler's
correlation ids.  The compaction and the packed readback launch outside
it."""

from portbench.tracing import launched_within


def read(ctx):
    ops = launched_within(ctx.dev, ctx.host, "pymodem.device_codec_step")
    ns = sum(e.end - e.start for e in ops)
    return 1e-6 * ns / ctx.n_recs if ns and ctx.n_recs else None
