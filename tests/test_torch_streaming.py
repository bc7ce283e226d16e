"""The port's streaming decoder against pymodem_tpu's on the CPU.

``runtime/stream.StreamDecoder`` of both packages over the same
synthesised 8 kHz AFSK-300 audio and chunks (an AFSK-300 correlator chain
and an AFSK-PLL chain, IL2P+CRC): packets per chain equal (payload, CRC,
stream address, corrections), ``state()`` JSON equal at the same feed,
checkpoints restored across packages and from the version 1 and 2 forms,
mixed int16/float feeds, the device-resident tail's warm steps, the
retained-audio bound, a failed collect and its retry, the host codec
route against the device codec route on a mixed AX.25/IL2P bank,
``block0`` in the device codec's packet build against the JAX package's
on the same arrays, and the float64 parity mode's stream against the JAX
package's f64 stream.  The stream against the port's one-shot
``run_banked``: the correlator chain exactly, the PLL chain by the JAX
package's rule (its AGC normalises per step group in a stream).

Cost: the port runs its kernels' plain twins here, whose loops step in
Python once a sample (~60 us a step on one thread, ~2x that with torch's
default thread pool on these small tensors), so this module runs torch
on one thread, keeps the block geometry short (1.5 s blocks, 2.5 s
overlap: the PLL's 1.25 s acquisition plus the 1.23 s frames), keeps each
stream to two steps and shares each stream run through module-scope
fixtures.
"""

import base64
import inspect
import json
import zlib
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymodem_tpu.config import build_chain_spec as jbuild_chain_spec
from pymodem_tpu.ops.crc import np_crc16
from pymodem_tpu.runtime import bank as jbank
from pymodem_tpu.runtime.stream import StreamDecoder as JStream
from pymodem_tpu_torch.config import build_chain_spec
from pymodem_tpu_torch.runtime import bank as tbank
from pymodem_tpu_torch.runtime.stream import StreamDecoder
from pymodem_tpu_torch.synth import encode as enc
from pymodem_tpu_torch.synth import fixtures as fx
from pymodem_tpu_torch.synth import modulate as mod

RATE = 8000
GEOM = dict(block_seconds=1.5, overlap_seconds=2.5)
BPS = 4


def _line(name, modem, codec="il2p", invert="no"):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": modem, "config": "300", "options": {}},
        "slicer": {"type": "binary", "config": "300", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": invert}},
        "codec": ({"type": "il2p", "options": {"crc": "yes"}}
                  if codec == "il2p" else {"type": "ax25", "options": {}}),
    }


LINES = [_line("AFSK 300 Il2Pc Correlator", "afsk"),
         _line("AFSK 300 Il2Pc PLL", "afsk_pll")]
MIXED_LINES = [_line("AFSK 300 Il2Pc Correlator", "afsk"),
               _line("AFSK 300 Il2Pc Correlator inverted", "afsk",
                     invert="yes"),
               _line("AFSK 300 AX25", "afsk", codec="ax25", invert="yes")]


def _chains(lines, build):
    return [build(float(RATE), ln) for ln in lines]


BOTH, JBOTH = _chains(LINES, build_chain_spec), _chains(LINES,
                                                         jbuild_chain_spec)
CORR, JCORR = BOTH[:1], JBOTH[:1]
MIXED = _chains(MIXED_LINES, build_chain_spec)


def _audio():
    """11.6 s of int16 AFSK-300 at 1600/1800 Hz (tones the "300" preset
    decodes from any block phase; the PLL chain locks to them too): 4
    IL2P+CRC frames of 8-byte payloads (1.23 s on the wire), 400 idle bits
    around each, so frames straddle block and step boundaries.  8 blocks:
    a stream of 4 blocks a step runs two steps, the second at block 4 and
    in flush()."""
    rng = np.random.default_rng(20261017)
    sent = fx.payloads(rng, count=4, size=8)
    line = fx.il2p_line_bits(sent, polynomial=0x3, invert=False,
                             gap_bits=400)
    return sent, mod.to_int16(mod.afsk_modulate(line, float(RATE), 300.0,
                                                1600.0, 1800.0))


def _mixed_audio():
    """~10 s of the mixed bank's traffic: 2 IL2P+CRC frames, then 2 AX.25
    UI frames (NRZI, HDLC flags around them), 8-byte payloads."""
    rng = np.random.default_rng(20261018)
    il2p = fx.payloads(rng, count=2, size=8)
    ax25 = fx.payloads(rng, count=2, size=8)
    bits = [1] * 8
    for p in ax25:
        bits += enc.hdlc_encode(enc.ax25_ui_frame("KI5ABC", "N0CALL", p),
                                flag_count=40)
    bits += [0, 1, 1, 1, 1, 1, 1, 0] * 40
    line = (fx.il2p_line_bits(il2p, polynomial=0x3, invert=False,
                              gap_bits=300)
            + enc.scramble_bits(bits, 0x3, invert=True))
    x = mod.to_int16(mod.afsk_modulate(line, float(RATE), 300.0, 1600.0,
                                       1800.0))
    return list(il2p) + list(ax25), x


SENT, AUDIO = _audio()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The twins' loops run tensors of a few lanes, where torch's thread
    pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pk(pkts):
    return [(list(map(int, p.data)), np_crc16(np.asarray(p.data[:-2])),
             int(p.streamaddress), int(p.bytes_corrected)) for p in pkts]


def _by_chain(d):
    return {name: _pk(p) for name, p in d.items()}


def _chunks(x, n):
    return [x[i: i + n] for i in range(0, len(x), n)]


@dataclass
class Run:
    """One stream run: the decoder after flush(), the packets feed() and
    flush() returned, the state() JSON taken after chunk ``snap_at``, the
    decoder's first bank just before flush() and the longest retained
    audio; for the port, the cold windows' first blocks, the sample counts
    of its uploads and each step's (data, addr, count, sync)."""

    dec: object
    out: list
    snap: str | None
    before_flush: dict
    longest: int
    cold: list = field(default_factory=list)
    uploads: list = field(default_factory=list)
    steps: list = field(default_factory=list)


def _spied(make, cold, uploads):
    """A port decoder whose cold windows (first block of each) and uploads
    (sample counts) are recorded."""
    dec = make()
    window_for, upload = dec._window_for, dec._upload
    dec._window_for = lambda st, b: cold.append(b) or window_for(st, b)
    dec._upload = lambda a: uploads.append(len(a)) or upload(a)
    return dec


def _stream(make, chunks, snap_at=None, spy=False):
    """Feed ``chunks`` to a new decoder, then flush."""
    cold, uploads, steps = [], [], []
    dec = _spied(make, cold, uploads) if spy else make()
    step = tbank.bank_device_step_stream

    def recorded(*args):
        outs = step(*args)
        steps.append(outs[:4])
        return outs

    out, snap, longest = [], None, 0
    if spy:
        tbank.bank_device_step_stream = recorded
    try:
        for i, c in enumerate(chunks):
            out.extend(dec.feed(c))
            longest = max(longest, len(dec._audio))
            if i + 1 == snap_at:
                snap = json.dumps(dec.state())
        st = dec._banks[0]
        before = dict(tail=st.tail, tail_block=st.tail_block,
                      next_block=st.next_block, consumed=dec._consumed,
                      pending=len(dec._pending))
        out.extend(dec.flush())
    finally:
        tbank.bank_device_step_stream = step
    return Run(dec, out, snap, before, longest, cold, uploads, steps)


def _port(chains=BOTH, **kw):
    kw.setdefault("blocks_per_step", BPS)
    return lambda: StreamDecoder(chains, RATE, device="cpu", **GEOM, **kw)


def _jax(chains=JBOTH, **kw):
    kw.setdefault("blocks_per_step", BPS)
    return lambda: JStream(chains, RATE, dtype=jnp.float32, **GEOM, **kw)


_RUNS: dict = {}
# the correlator chain's reference stream: 7,001-sample chunks, each step
# collected within its feed, the checkpoint after chunk 8 (56,008 samples:
# step 0 done)
CORR_RUN = dict(chains="corr", chunk=7_001, depth=0, snap_at=8)


def _run(pkg, chains="both", chunk=80_000, depth=2, snap_at=None):
    """Each stream run of this module, once."""
    key = (pkg, chains, chunk, depth, snap_at)
    if key not in _RUNS:
        port = pkg == "port"
        make = (_port if port else _jax)(
            {"both": BOTH if port else JBOTH,
             "corr": CORR if port else JCORR}[chains],
            pipeline_depth=depth)
        chunks = _chunks(AUDIO, chunk)
        _RUNS[key] = _stream(make, chunks, snap_at=(
            len(chunks) // 2 if snap_at is None else snap_at), spy=port)
    return _RUNS[key]


@pytest.mark.parametrize("chunk", [7_001, 80_000])
def test_stream_matches_jax(chunk):
    run, jrun = _run("port", chunk=chunk), _run("jax", chunk=chunk)
    dec, jdec = run.dec, jrun.dec
    assert _pk(run.out) == _pk(jrun.out)
    assert _by_chain(dec.packets()) == _by_chain(jdec.packets())
    for chain in BOTH:  # every chain decodes every frame
        assert [bytes(p.data[16:-2])
                for p in dec.packets()[chain.name]] == SENT


def test_stream_matches_oneshot():
    """The correlator chain equals the one-shot run exactly (its demod
    takes no whole-recording normal); the PLL chain by the JAX package's
    rule: payloads equal, addresses within rate/40 + 9 sample periods of
    a bit."""
    dec = _run("port").dec
    oneshot = tbank.run_banked(BOTH, AUDIO, device="cpu", **GEOM)
    got = dec.packets()
    corr, pll = (c.name for c in BOTH)
    assert _pk(got[corr]) == _pk(oneshot[corr])
    window = RATE / 40 + 9 * (RATE / 300)
    a, b = _pk(oneshot[pll]), _pk(got[pll])
    assert [p[0] for p in a] == [p[0] for p in b]
    assert all(abs(x[2] - y[2]) < window for x, y in zip(a, b))
    assert len(b) > 0


@pytest.mark.parametrize("chains", ["both", "corr"])
def test_state_json_matches_jax(chains):
    """state() at the same feed is the same JSON in both packages: Packet
    fields in order, the audio tail's bytes and dtype string."""
    kw = CORR_RUN if chains == "corr" else {}
    snap, jsnap = _run("port", **kw).snap, _run("jax", **kw).snap
    assert snap is not None and snap == jsnap
    state = json.loads(snap)
    assert state["version"] == 3 and state["audio_tail"]["dtype"] == "int16"
    assert sum(map(len, state["results"].values())) > 0


def _restored(state):
    dec = _port(CORR)()
    dec.restore(state)
    return dec


@pytest.mark.parametrize("source", ["port", "jax"])
def test_restore_continues_identically(source):
    """A checkpoint taken after the first step (the port's or the JAX
    package's) restores into a fresh port decoder, and the remaining feeds
    give the uninterrupted stream's packets: the emitted counters carry
    over, so feed()/flush() return what the uninterrupted stream returned
    after the checkpoint."""
    cont = _run("port", **CORR_RUN)
    state = json.loads(_run(source, **CORR_RUN).snap)
    dec = _restored(state)
    out = []
    for c in _chunks(AUDIO, CORR_RUN["chunk"])[CORR_RUN["snap_at"]:]:
        out.extend(dec.feed(c))
    out.extend(dec.flush())
    n_before = state["n_emitted"][CORR[0].name]
    assert state["results"][CORR[0].name] and n_before < len(cont.out)
    assert _pk(out) == _pk(cont.out[n_before:])
    assert _by_chain(dec.packets()) == _by_chain(cont.dec.packets())


def _v1(state):
    """The version 1 form of a checkpoint: the audio tail a JSON float list
    and no pruned-packet counts."""
    tail = np.frombuffer(zlib.decompress(base64.b64decode(
        state["audio_tail"]["b64z"])), dtype=state["audio_tail"]["dtype"])
    v1 = {k: v for k, v in state.items() if k != "emitted_base"}
    v1.update(version=1, audio_tail=tail.astype(float).tolist())
    return v1


@pytest.mark.parametrize("version", [1, 2])
def test_restore_reads_older_versions(version):
    """The version 1 (a JSON float list) and 2 (no pruned-packet counts)
    forms of a checkpoint restore to the decoder state version 3 gives."""
    state = json.loads(_run("port", **CORR_RUN).snap)
    old = _v1(state) if version == 1 else {
        k: v for k, v in dict(state, version=2).items()
        if k != "emitted_base"}
    want, got = _restored(state), _restored(old)
    assert np.array_equal(got._audio, want._audio)
    assert got._audio.dtype == (np.float64 if version == 1 else np.int16)
    for attr in ("_consumed", "_total", "_n_emitted", "_emitted_base"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert [st.next_block for st in got._banks] == [BPS]
    assert _by_chain(got._results) == _by_chain(want._results)


def test_restore_rejects_mismatch():
    state = json.loads(_run("port", **CORR_RUN).snap)
    with pytest.raises(ValueError, match="version"):
        _port(CORR)().restore(dict(state, version=9))
    with pytest.raises(ValueError, match="chain names"):
        _port(CORR)().restore(dict(state, results={"x": []}))


def test_mixed_int16_and_float_feeds():
    """int16 chunks keep the int16 wire dtype; a float chunk mid-stream
    carries the audio as float64 from then on (its next step is cold) and
    the packets equal the all-int16 stream's (int16 -> float is exact)."""
    run = _stream(_port(CORR), [AUDIO[:70_000],
                                AUDIO[70_000:].astype(np.float64)],
                  spy=True)
    assert run.dec._audio.dtype == np.float64
    assert _pk(run.out) == _pk(_run("port", **CORR_RUN).out)
    assert run.cold == [0, BPS]  # the first step, and the one after the switch


def test_device_tail_warm_path():
    """Steady-state steps read the previous step's tail: after the first
    (cold) step each step uploads only its new samples, the tail holds
    (ext,) samples in the wire dtype, and its cursor names the next
    step."""
    run = _run("port", **CORR_RUN)
    dec, before = run.dec, run.before_flush
    ext = dec._banks[0].plan.block_input_len - dec.block_len
    tail = before["tail"]
    assert isinstance(tail, torch.Tensor) and tail.shape == (ext,)
    assert tail.dtype == torch.int16 and before["pending"] == 0
    assert before["tail_block"] == before["next_block"] == BPS
    assert run.cold == [0]
    assert run.uploads == [ext, BPS * dec.block_len, BPS * dec.block_len]
    # the same packets as the JAX package's stream
    assert _pk(run.out) == _pk(_run("jax", **CORR_RUN).out)


def test_retained_audio_is_bounded():
    """Retained audio never exceeds the in-flight steps' blocks plus the
    halo, and audio no step will read again is dropped."""
    run = _run("port", **CORR_RUN)
    dec = run.dec
    bound = (BPS * (1 + dec.pipeline_depth) * dec.block_len + dec.overlap
             + 2 * RATE)
    assert 0 < run.longest <= bound
    assert run.before_flush["consumed"] == BPS * dec.block_len - dec.overlap


def test_failed_collect_abandons_pipeline_and_retry_loses_nothing():
    """A collect that raises abandons every in-flight step (their
    next_block never commits); the retry feed re-submits from the
    committed cursor, cold, and the stream's packets equal an
    uninterrupted run's."""
    cold = []
    dec = _spied(_port(CORR, pipeline_depth=1), cold, [])
    real = dec._submit_blocks
    failed = []

    def failing(state, first, n, final):
        collect = real(state, first, n, final)
        if first == 0 and not failed:
            def boom():
                failed.append(first)
                raise RuntimeError("injected collect failure")
            return boom
        return collect

    dec._submit_blocks = failing
    out = dec.feed(AUDIO)  # step 0 in flight
    with pytest.raises(RuntimeError, match="injected"):
        dec.flush()  # step 1 queued behind it, then step 0 fails
    assert failed == [0] and not dec._pending
    assert dec._banks[0].next_block == 0
    out += dec.feed(np.zeros(0, np.int16))  # the retry feed
    out += dec.flush()
    assert cold == [0, 0]  # the retry rebuilt its window
    assert _pk(out) == _pk(_run("port", **CORR_RUN).out)


def test_host_codec_equals_device_codec_mixed_bank():
    """codec="host" (the exact state machines, globally offset) equals the
    device codecs (one per codec sub-group, block0 and host_plan) packet
    for packet on an AX.25 + IL2P bank."""
    sent, x = _mixed_audio()
    got = {}
    for codec in ("device", "host"):
        run = _stream(_port(MIXED, codec=codec), _chunks(x, 30_000))
        got[codec] = (_pk(run.out), _by_chain(run.dec.packets()))
    assert got["device"] == got["host"]
    decoded = {bytes(d[16:-2]) for pkts in got["host"][1].values()
               for d, *_ in pkts}
    assert decoded == set(map(bytes, sent))


def _step_arrays():
    """The correlator bank's first streaming step: (decoder, bank state,
    its (data, addr, count, sync) outputs on the CPU)."""
    run = _run("port", **CORR_RUN)
    return run.dec, run.dec._banks[0], run.steps[0]


@pytest.mark.parametrize("block0", [0, 3])
@pytest.mark.parametrize("forced", [False, True], ids=["", "fallback"])
def test_packets_from_compact_block0_matches_jax(block0, forced):
    """packets_from_compact and _fallback_block_packets with ``block0``
    against the JAX package's on the same readback and arrays, with a
    block forced to the host fallback or not."""
    dec, st, arrays = _step_arrays()
    data, addr, count, sync = arrays
    plan = st.plan
    out = tbank._dispatch_codec(tbank._codec_subgroups(st.bank)[0][0], data,
                                addr, count, sync, plan, 8, 256, 64, None,
                                1023, keep_filter=False)
    n_ok = int(out["ok"].sum())
    packed = tbank.compact_codec_out(out["ok"], out["address"],
                                     out["length"], out["corrected"],
                                     out["packet"], out["dropped"], 64, 256)
    _, comp, dropped = tbank._read_compact(packed.numpy(), 64, 256,
                                           tuple(data.shape[:2]))
    assert n_ok > 0
    dropped = dropped.copy()
    if forced:
        dropped[0, int(np.argmax(count.numpy()[0] > 0)) + 1] = 1
    n_total = len(AUDIO) + block0 * dec.block_len
    host_plan = tbank.BlockPlan(n_total, st.bank.trim, plan.block_len,
                                plan.overlap)
    jhost_plan = jbank.BlockPlan(n_total, st.bank.trim, plan.block_len,
                                 plan.overlap)
    np_arrays = [t.numpy() for t in arrays]
    got = tbank.packets_from_compact(st.bank, host_plan, comp, n_ok,
                                     dropped, *arrays, block0)
    jbank_ = jbank.group_chains(JCORR, jnp.float32)[0]
    want = jbank.packets_from_compact(jbank_, jhost_plan, comp, n_ok,
                                      dropped, *np_arrays, block0)
    assert _by_chain(got) == _by_chain(want)
    assert sum(map(len, got.values())) > 0
    if block0:
        addrs = [p.streamaddress for p in got[CORR[0].name]]
        assert min(addrs) > block0 * plan.block_len


class _Stop(Exception):
    pass


@pytest.mark.parametrize("block0,host", [(0, False), (0, True), (2, False),
                                         (2, True)])
def test_device_keep_filter_off_where_jax_turns_it_off(block0, host,
                                                        monkeypatch):
    """_device_codec_submit runs the device keep filter only with neither
    ``host_plan`` nor ``block0``, JAX's rule."""
    _, st, arrays = _step_arrays()
    seen = []

    params = inspect.signature(tbank._dispatch_codec).parameters

    def spy(*args, **kw):
        seen.append(inspect.Signature(params.values()).bind(
            *args, **kw).arguments.get("keep_filter", True))
        raise _Stop

    monkeypatch.setattr(tbank, "_dispatch_codec", spy)
    key = tbank._codec_subgroups(st.bank)[0][0]
    host_plan = (tbank.BlockPlan(len(AUDIO), st.bank.trim, st.plan.block_len,
                                 st.plan.overlap) if host else None)
    with pytest.raises(_Stop):
        tbank._device_codec_submit(st.bank, st.plan, key, *arrays, 8, 256,
                                   block0=block0, host_plan=host_plan)()
    assert seen == [host_plan is None and block0 == 0]


def test_overlapped_frames_equal_frame_blocks():
    """A whole recording framed from its padded window equals
    frame_blocks; a streaming window frames as its blocks' slices."""
    x = torch.arange(1000, dtype=torch.int16)
    plan = tbank.BlockPlan(1000, 7, 96, 40)
    ext = plan.block_input_len - plan.stride_in
    framed = tbank.frame_blocks(x, plan)
    padded = torch.nn.functional.pad(
        x, (plan.front_pad, plan.n_blocks * plan.stride_in + ext
            - plan.front_pad - 1000))
    for b in range(plan.n_blocks):
        start = b * plan.stride_in
        assert torch.equal(framed[b], padded[start: start + plan.block_input_len])
    win = padded[96 * 3: 96 * 3 + 4 * 96 + ext]
    assert torch.equal(tbank.overlapped_frames(win, 4, 96, ext),
                       framed[3:7])


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, "float64"])
def test_float64_stream(dtype):
    """Each spelling of float64 gives a float64 stream (its banks, their
    leaves and the uploads of a float feed); a dtype the decode does not
    run still raises."""
    dec = StreamDecoder(CORR, RATE, dtype=dtype, device="cpu", **GEOM)
    assert dec.dtype == torch.float64
    assert all(st.bank.dtype == torch.float64 for st in dec._banks)
    assert dec._upload(np.zeros(3)).dtype == torch.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        StreamDecoder(CORR, RATE, dtype="float16", device="cpu", **GEOM)


def test_f64_stream_matches_jax():
    """An f64 stream (a float feed, carried and uploaded as float64) of
    both chains against the JAX package's f64 stream on the same chunks:
    packets equal, every chain every frame, and ``state()`` equal JSON at
    the same feed (a float64 audio tail)."""
    chunks = _chunks(AUDIO.astype(np.float64), 80_000)
    run = _stream(lambda: StreamDecoder(BOTH, RATE, dtype=torch.float64,
                                        device="cpu", blocks_per_step=BPS,
                                        **GEOM), chunks, snap_at=1)
    jrun = _stream(lambda: JStream(JBOTH, RATE, dtype=jnp.float64,
                                   blocks_per_step=BPS, **GEOM), chunks,
                   snap_at=1)
    assert _pk(run.out) == _pk(jrun.out)
    assert _by_chain(run.dec.packets()) == _by_chain(jrun.dec.packets())
    for chain in BOTH:
        assert [bytes(p.data[16:-2])
                for p in run.dec.packets()[chain.name]] == SENT
    assert run.snap is not None and run.snap == jrun.snap
    assert json.loads(run.snap)["audio_tail"]["dtype"] == "float64"


def test_stream_defaults_to_the_card():
    """No CPU fallback: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        StreamDecoder(CORR, RATE, **GEOM)
    assert StreamDecoder(CORR, RATE, dtype=torch.float32, device="cpu",
                         **GEOM).device.type == "cpu"
