"""launches_per_rec: CUDA kernels launched per recording (the device
dispatch: ``runtime/bank._submit_banked``, ``_device_codec_submit``, the
device codecs), counted from the kernels in the traced window."""

from portbench.tracing import is_copy


def read(ctx):
    n = sum(1 for e in ctx.dev if not is_copy(e.name))
    return n / ctx.n_recs if n and ctx.n_recs else None
