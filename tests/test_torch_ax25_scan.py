"""Kernel K9's decomposition of the AX.25/HDLC bit FSM, checked on the CPU.

``csrc/ax25_deframe.cu`` does not step the FSM bit by bit: it classifies
every bit by the run of ones before it (data, abort, stuffed zero, flag,
nothing), counts data bits since the last reset with scans, and reads each
completed byte out of the 16 bits that end at it.  The numpy model below
follows the kernel's word-level steps (``classify``, ``counts_mod8``,
``byte_at``, the per-thread counts, the block's exclusive scans and the
carry from tile to tile) and is held bitwise against the plain twin
``codecs/ax25_device.ax25_deframe`` on every output, on short rows with the
patterns that stress the decomposition: runs of ones across words and
threads, all-ones rows, flags at every bit offset, stuffing, aborts, odd
K, counts of 0 and past K, more closing flags than packet slots, and a
byte counter that wraps.  A small tile (a few threads) makes the carries
between tiles run on short rows.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pymodem_tpu_torch.codecs.ax25_device import ax25_deframe
from pymodem_tpu_torch.synth.fixtures import ax25_edge_rows

M32 = 0xFFFFFFFF
SEG_FILL = 1 << 30
WORDS = 4  # words of a row a thread takes a tile (the kernel's kWords)


def above(q):
    return ((M32 << q) << 1) & M32


def popc(x):
    return bin(x).count("1")


def stream_word(row, o, n):
    """Row bytes [o, o + 4) in bit-stream order (bit q the q-th bit on the
    wire), bytes outside [0, n) as 0."""
    if o < 0 or o >= n:
        return 0
    w = 0
    for i in range(4):
        if o + i < n:
            w |= int(f"{int(row[o + i]):08b}"[::-1], 2) << (8 * i)
    return w


def live_bits(o, n):
    if o >= n or o < 0:
        return 0
    return M32 if n - o >= 4 else (1 << (8 * (n - o))) - 1


def classify(s, pw, live):
    """(data, reset, flag, stuffed) masks of word s after word pw."""
    z = (s << 32) | pw
    g = M32
    for j in range(1, 7):
        g &= (z >> (32 - j)) & M32
        if j == 5:
            g5 = g
    g6 = g
    g7 = g6 & ((z >> 25) & M32)
    one, zero = s & live, ~s & live & M32
    data = (one & ~g6 & M32) | (zero & ~g5 & M32)
    flag = zero & g6 & ~g7 & M32
    reset = (one & g6) | flag
    stuffed = zero & g5 & ~g6 & M32
    return data, reset, flag, stuffed


def last_bit(x):
    return x.bit_length() - 1


def count_after_reset(data, reset):
    return popc(data & above(last_bit(reset))) if reset else popc(data)


def add3(p, a):
    p0, p1, p2 = p
    a0, a1, a2 = a
    c0 = p0 & a0
    p0 ^= a0
    t1 = p1 ^ a1
    c1 = (p1 & a1) | (t1 & c0)
    p1 = t1 ^ c0
    p2 ^= a2 ^ c1
    return p0, p1, p2


def counts_mod8(data, reset, n0):
    """Bit planes of the segmented inclusive count of data bits mod 8."""
    p, head = (data, 0, 0), reset
    s = 1
    while s < 32:
        take = ~head & M32
        p = add3(p, tuple((v << s) & take for v in p))
        head = (head | (head << s)) & M32
        s <<= 1
    m = ~head & M32
    return add3(p, tuple(m if n0 >> i & 1 else 0 for i in range(3)))


def byte_at(cur, prev, st_cur, st_prev, q):
    sh = 17 + q
    w = (((cur << 32) | prev) >> sh) & 0xFFFF
    st = (((st_cur << 32) | st_prev) >> sh) & 0xFFFF
    while st:
        b = last_bit(st)
        below = (1 << b) - 1
        w = (w & above(b)) | ((w & below) << 1)
        st = (st & below) << 1
    return w >> 8


def seg_join(a, b):
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1], a[2] + b[2])


def model_row(row, count, P, min_len, max_len, threads):
    """One row as the kernel's block walks it with ``threads`` threads."""
    K = len(row)
    n = min(max(int(count), 0), K)
    stream = [0] * K
    stream_seg = [SEG_FILL] * K
    cb, cs, ce = [0] * P, [0] * P, [0] * P
    tile = threads * 4 * WORDS
    carry, placed = (0, 0, 0), (0, 0)
    for base in range(0, n, tile):
        per = []
        for t in range(threads):
            o = base + t * 4 * WORDS
            s = [stream_word(row, o + 4 * (j - 1), n)
                 for j in range(WORDS + 1)]
            st_before = classify(s[0], 0, live_bits(o - 4, n))[3]
            cl = [classify(s[j + 1], s[j], live_bits(o + 4 * j, n))
                  for j in range(WORDS)]
            mine = (0, 0, 0)
            for d, r, f, _ in cl:
                mine = seg_join(mine, (int(r != 0), count_after_reset(d, r),
                                       popc(f)))
            per.append((o, s, st_before, cl, mine))
        # the block's first exclusive scan (segmented n, flags)
        firsts, acc = [], carry
        for *_, mine in per:
            firsts.append(acc)
            acc = seg_join(acc, mine)
        tile_total = acc
        seconds, marks = [], []
        for (o, s, st_before, cl, _), first in zip(per, firsts):
            nw, done, closing = first[1], [], []
            for d, r, f, _ in cl:
                p0, p1, p2 = counts_mod8(d, r, nw)
                done.append(d & ~(p0 | p1 | p2) & M32)
                b = [((p << 1) & M32) | (nw >> i & 1)
                     for i, p in enumerate((p0, p1, p2))]
                cand, close = f & b[0] & b[1] & b[2], 0
                while cand:
                    q = last_bit(cand & -cand)
                    cand &= cand - 1
                    low = (1 << q) - 1
                    rb = r & low
                    nb = (popc(d & low & above(last_bit(rb))) if rb
                          else nw + popc(d & low))
                    bi = (nb >> 3) % (max_len + 1) if max_len >= 0 else 0
                    if bi >= min_len:
                        close |= 1 << q
                closing.append(close)
                nw = count_after_reset(d, r) if r else nw + popc(d)
            marks.append((done, closing))
            seconds.append((sum(map(popc, done)), sum(map(popc, closing))))
        # the second exclusive scan (bytes completed, flags closed)
        at, acc = [], placed
        for v in seconds:
            at.append(acc)
            acc = (acc[0] + v[0], acc[1] + v[1])
        tile_placed = acc
        for (o, s, st_before, cl, _), first, (done, closing), (d_, k) in zip(
                per, firsts, marks, at):
            seg = first[2]
            for j in range(WORDS):
                st_prev = cl[j - 1][3] if j else st_before
                m = done[j] | closing[j]
                while m:
                    q = last_bit(m & -m)
                    m &= m - 1
                    seg_q = seg + popc(cl[j][2] & ((1 << q) - 1))
                    if done[j] >> q & 1:
                        stream[d_] = byte_at(s[j + 1], s[j], cl[j][3],
                                             st_prev, q)
                        stream_seg[d_] = seg_q
                        d_ += 1
                    else:
                        if k < P:
                            cb[k], cs[k], ce[k] = 8 * (o + 4 * j) + q, seg_q, d_
                        k += 1
                seg += popc(cl[j][2])
        carry, placed = tile_total, tile_placed
    return stream, stream_seg, placed[0], cb, cs, ce, placed[1]


def model(rows, counts, P, min_len, max_len, threads):
    out = [model_row(r, c, P, min_len, max_len, threads)
           for r, c in zip(rows, counts)]
    return tuple(torch.tensor(np.array([o[i] for o in out], np.int64),
                              dtype=torch.int32) for i in range(7))


def _check(rows, counts, P=3, min_len=18, max_len=1023, threads=(1, 3)):
    rows = np.ascontiguousarray(rows, np.uint8)
    counts = np.asarray(counts, np.int32)
    want = ax25_deframe(torch.from_numpy(rows), torch.from_numpy(counts), P,
                        min_len, max_len)
    for th in threads:
        got = model(rows, counts, P, min_len, max_len, th)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w.reshape(g.shape)), (th, i)
    return want


def _bits_to_bytes(bits):
    bits = list(bits) + [0] * (-len(bits) % 8)
    return [int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8)]


_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]


def _stuffed(payload_bits):
    out, run = [], 0
    for b in payload_bits:
        out.append(b)
        run = run + 1 if b else 0
        if run == 5:
            out.append(0)
            run = 0
    return out


def _edge_rows():
    """Rows named by the pattern they stress, each 37 bytes (odd K): the
    port's AX.25 edge rows (``synth/fixtures.ax25_edge_rows``) and more."""
    K = 37
    g = np.random.default_rng(7)
    data, names = ax25_edge_rows(K, g)
    rows = dict(zip(names, (list(r) for r in data)))
    # runs of ones across 32-bit words, in noise
    for length in (5, 6, 7, 9, 33, 70):
        for start in (27, 28, 31, 125, 127):
            bits = [0] * start + [1] * length + [0] + _FLAG * 2
            bits += [int(b) for b in g.integers(0, 2, 8 * K)]
            rows[f"run{length}_at{start}"] = _bits_to_bytes(bits)[:K]
    # frames whose data holds runs of 10-17 ones: two stuffed zeros among
    # one byte's 8 data bits
    for run in range(10, 18):
        data = [int(b) for b in g.integers(0, 2, 8 * 18)]
        at = int(g.integers(0, 8 * 18 - run))
        data[at:at + run] = [1] * run
        bits = [0] * (run % 5) + _FLAG + _stuffed(data) + _FLAG
        rows[f"stuffed_run{run}"] = _bits_to_bytes(bits + [0] * 8 * K)[:K]
    # back-to-back frames: more closes than 3 slots at min_len 1
    frames = []
    for _ in range(8):
        frames += _FLAG + _stuffed([int(b) for b in g.integers(0, 2, 16)])
    rows["many_closes"] = _bits_to_bytes(frames + _FLAG + [0] * 8 * K)[:K]
    return rows


@pytest.mark.parametrize("max_len", [1023, 3])
@pytest.mark.parametrize("min_len", [18, 1])
def test_scan_model_matches_twin_on_edge_rows(min_len, max_len):
    """The model equals the twin on every edge row at full count, on counts
    of 0, short and past K, with 3 packet slots; min_len 1 and max_len 3
    close many short frames and wrap the byte counter."""
    rows = _edge_rows()
    data = np.array(list(rows.values()), np.uint8)
    K = data.shape[1]
    g = np.random.default_rng(3)
    for counts in (np.full(len(data), K + 9),
                   g.integers(-2, K + 3, len(data))):
        _check(data, counts, 3, min_len, max_len)
    none = _check(data, np.zeros(len(data)), 3, min_len, max_len)
    assert int(none[2].sum()) == 0
    full = _check(data, np.full(len(data), K), 3, min_len, max_len)
    names = list(rows)
    # the 20-byte frames close at every bit of a word, the 2-byte ones
    # past the slots
    if max_len == 1023:
        assert all(int(full[6][names.index(f"close_at_bit{o}")]) >= 1
                   for o in range(32))
    if min_len == 1:
        assert int(full[6][names.index("many_closes")]) > 3


@st.composite
def _rows(draw):
    K = draw(st.integers(1, 45))
    n_rows = draw(st.integers(1, 4))
    pieces = st.one_of(
        st.lists(st.integers(0, 1), min_size=1, max_size=40),
        st.integers(1, 40).map(lambda n: [1] * n),
        st.just(_FLAG),
        st.integers(5, 24).map(lambda n: _FLAG + _stuffed([1] * n)),
        st.lists(st.integers(0, 1), min_size=8, max_size=48).map(
            lambda b: _FLAG + _stuffed(b) + _FLAG))
    rows, counts = [], []
    for _ in range(n_rows):
        bits = []
        while len(bits) < 8 * K:
            bits += draw(pieces)
        rows.append(_bits_to_bytes(bits[:8 * K]))
        counts.append(draw(st.integers(-1, K + 2)))
    return rows, counts


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(case=_rows(), min_len=st.sampled_from([1, 2, 18]),
       max_len=st.sampled_from([1, 5, 1023]), slots=st.integers(0, 4))
def test_scan_model_matches_twin_on_drawn_rows(case, min_len, max_len, slots):
    """Rows drawn from random bits, runs of ones, flags and stuffed frames;
    every output bitwise, at one thread a tile (carries every 16 bytes)
    and at three."""
    rows, counts = case
    _check(rows, counts, slots, min_len, max_len)
