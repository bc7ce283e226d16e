"""Reed-Solomon decode (and encode, for the signal synthesizer).

Port of ``pymodem_tpu.ops.rs``: numpy copies of its host functions (in
``ops/rs_host.py``, which imports no torch, re-exported here), and its
batched device decoder (``rs_decode``, the counterpart of
``rs_decode_jax``) on torch tensors.  IL2P uses two RS codes over
GF(256)/0x11D, first root 0: a (15,13) header code (2 roots) and a
(N,N-16) payload-block code (16 roots) (il2p.py:130-136).

``rs_decode_np`` reproduces the reference decoder's exact behaviour
(rs_functions.py:33-150): Horner syndromes, a Berlekamp iteration with a
persistent (stale-carrying) next-locator buffer, Chien search over the block,
Forney magnitudes with the reference's index arithmetic quirks (log[0] == 0;
index reductions that may pass through -1, which aliases to table[254]), a
``min_distance`` margin that refuses corrections when error_count exceeds
(nroots/2 - min_distance), and a final syndrome recheck that returns -1 on
failure while leaving any corrections applied.  ``rs_decode`` returns the
same results for a batch of blocks at once, in fixed shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from ..device import constant, upload
from .gf import GF256, GFTables, gf_mul, np_gf_mul, torch_tables


from .rs_host import (  # noqa: F401 - the host half, re-exported
    RS_BLOCK,
    RS_HEADER,
    RSCode,
    _np_syndromes,
    make_rs,
    rs_decode_np,
    rs_encode_np,
)


# ---------------------------------------------------------------------------
# Device (torch) decoder -- batched, fixed shapes, mask-driven
# ---------------------------------------------------------------------------

_BIT_W = torch.arange(8)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of 8-bit values along ``dim``, as the parity of each bit plane
    (torch has no XOR reduction)."""
    bit_w = constant(_BIT_W, x.device)
    planes = (x.unsqueeze(-1) >> bit_w) & 1
    parity = planes.sum(dim if dim >= 0 else dim - 1) & 1
    return (parity << bit_w).sum(-1)


class _GFOps:
    """Table multiply, inverse and alpha power on ``device``: the JAX
    package's CPU form of ``_gf_ops`` (its TPU shift/xor ladders compute the
    same field values without gathers, which the GPU does not need)."""

    def __init__(self, gf: GFTables, device):
        self.order = gf.order
        self.antilog, self.log, self.inverse = torch_tables(gf, device)

    def mul(self, a, b):
        return gf_mul(self.antilog, self.log, a, b, self.order)

    def inv(self, a):
        return self.inverse[a]

    def pow(self, x):
        return self.antilog[x]


_OPS_CACHE: dict = {}


def _gf_ops(gf: GFTables, device) -> _GFOps:
    """The field's _GFOps on ``device``, its tables moved there once."""
    key = (id(gf), str(device))
    if key not in _OPS_CACHE:
        _OPS_CACHE[key] = _GFOps(gf, device)
    return _OPS_CACHE[key]


def rs_decode(data: torch.Tensor, block_size: torch.Tensor, num_roots: int,
              first_root: int = 0, min_distance: int = 0,
              gf: GFTables = GF256, chunk_size: int = 2048,
              fail_budget: int | None = None):
    """Batched RS decode (the counterpart of ``rs_decode_jax``).

    data: (B, L) integer bytes; block_size: (B,) integers.  Returns
    (corrected_data (B, L) int64, result (B,) int64), result being the
    corrected-error count or -1 on failure, as rs_decode_np per block.

    Batches larger than ``chunk_size`` decode chunk by chunk, the last one
    padded with ``block_size=1`` rows, exactly the JAX package's layout:
    ``fail_budget`` applies per chunk, so which rows overflow depends on it.

    ``fail_budget`` enables the syndrome-zero split: rows whose syndromes
    are all zero finish at once (result 0, data untouched, the reference's
    outcome for such a block), and only rows with nonzero syndromes compact
    into ``fail_budget`` slots per chunk for the correction path.  The
    return is then (corrected, result, overflow), ``overflow`` marking
    failing rows past the budget (result -1, data untouched).
    """
    with profiling.timed("rs_decode"):
        B = data.shape[0]
        data = data.to(torch.int64)
        block_size = block_size.to(torch.int64)
        if B > chunk_size:
            pad = -B % chunk_size
            data_p = torch.nn.functional.pad(data, (0, 0, 0, pad))
            bs_p = torch.nn.functional.pad(block_size, (0, pad), value=1)
            outs = [
                _rs_decode_batch(data_p[lo : lo + chunk_size],
                                 bs_p[lo : lo + chunk_size], num_roots,
                                 first_root, min_distance, gf, fail_budget)
                for lo in range(0, B + pad, chunk_size)
            ]
            out = tuple(torch.cat(parts)[:B] for parts in zip(*outs))
        else:
            out = _rs_decode_batch(data, block_size, num_roots, first_root,
                                   min_distance, gf, fail_budget)
        if fail_budget is None:
            return out[0], out[1]
        return out


_BITMAT_CACHE: dict = {}


def _bitlinear_mats(num_roots: int, first_root: int, gf: GFTables):
    """GF(2)-linear operator matrices for syndrome and Chien evaluation
    (numpy float32, cached per key).

    GF(2^8) multiplication by a constant is linear over GF(2), so with
    blocks right-aligned into a 255-byte frame both evaluations become
    binary matrix products followed by mod 2.  Row and column order is
    bit-major: input row (a, j') = a*lm + j', output column (c, j') =
    c*lm + j'.

    M_synd[(a, j'), (i, b)] = bit b of (2^a) * alpha^((254-j')*(fr+i))
    M_chien[(i-1)*8+b, (c, j')] = bit c of (2^b) * alpha^((j'+1)*i)
    (the reference's Chien exponent is (j + 256 - bs)*i, rs_functions.py:87).
    """
    key = (num_roots, first_root, gf.order)
    if key in _BITMAT_CACHE:
        return _BITMAT_CACHE[key]
    lm = gf.order - 1  # 255
    t2 = num_roots // 2
    jp = np.arange(lm)
    a = np.arange(8)
    i_r = np.arange(num_roots)
    exp_s = ((lm - 1 - jp)[:, None] * (first_root + i_r)[None, :]) % lm
    const_s = gf.antilog[exp_s]  # (lm, R)
    prod_s = np_gf_mul(gf, (1 << a)[None, :, None], const_s[:, None, :])
    bits_s = (prod_s[..., None] >> a[None, None, None, :]) & 1  # (lm, 8, R, 8)
    m_synd = bits_s.transpose(1, 0, 2, 3).reshape(
        lm * 8, num_roots * 8
    ).astype(np.float32)
    i_c = np.arange(1, t2 + 1)
    exp_c = (((jp + 1)[None, :]) * i_c[:, None]) % lm  # (t2, lm)
    const_c = gf.antilog[exp_c]
    prod_c = np_gf_mul(gf, (1 << a)[None, :, None], const_c[:, None, :])
    bits_c = (prod_c[..., None] >> a[None, None, None, :]) & 1
    m_chien = bits_c.transpose(0, 1, 3, 2).reshape(
        t2 * 8, lm * 8
    ).astype(np.float32)
    _BITMAT_CACHE[key] = (m_synd, m_chien)
    return _BITMAT_CACHE[key]


_DEVICE_MATS: dict = {}


def _device_mats(num_roots: int, first_root: int, gf: GFTables, device):
    """_bitlinear_mats as float32 tensors on ``device``, moved once."""
    key = (num_roots, first_root, gf.order, str(device))
    if key not in _DEVICE_MATS:
        _DEVICE_MATS[key] = tuple(
            upload(m, device)
            for m in _bitlinear_mats(num_roots, first_root, gf))
    return _DEVICE_MATS[key]


def _gf2_matmul(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(B, K) {0,1} @ (K, M) binary matrix over GF(2): a float32 matmul of
    0/1 operands (each sum counts at most K ones, exact in float32; TF32
    would be exact too), then parity."""
    prod = torch.matmul(bits.to(torch.float32), mat)
    return prod.to(torch.int64) & 1


def _rs_syndromes(data, block_size, num_roots, first_root, gf, m_synd, ops):
    """Batched syndromes: one GF(2) bit-matmul over left-aligned frames,
    with a per-root exponent fix-up: S_i = T_i * alpha^(-shift*r_i)."""
    B, L = data.shape
    lm = gf.order - 1
    col = torch.arange(L, device=data.device)[None, :]
    d_m = torch.where(col < block_size[:, None], data, 0)
    d_f = d_m if L >= lm else torch.nn.functional.pad(d_m, (0, lm - L))
    d_f = d_f[..., :lm]
    bits = torch.cat([(d_f >> k) & 1 for k in range(8)], dim=-1)
    sb = _gf2_matmul(bits, m_synd).reshape(B, num_roots, 8)
    t_i = (sb << constant(_BIT_W, data.device)).sum(2)  # (B, R)
    r_i = (first_root + torch.arange(num_roots, device=data.device))[None, :]
    shift = lm - block_size
    corr_e = (-(shift[:, None] * r_i)) % lm
    return ops.mul(t_i, ops.pow(corr_e))


def _rs_decode_batch(data, block_size, num_roots: int, first_root: int = 0,
                     min_distance: int = 0, gf: GFTables = GF256,
                     fail_budget: int | None = None):
    B, L = data.shape
    dev = data.device
    m_synd, m_chien = _device_mats(num_roots, first_root, gf, dev)
    ops = _gf_ops(gf, dev)
    synd = _rs_syndromes(data, block_size, num_roots, first_root, gf,
                         m_synd, ops)
    if fail_budget is None or fail_budget >= B:
        corr, res = _rs_correct_batch(
            data, block_size, synd, num_roots, first_root, min_distance, gf,
            m_synd, m_chien, ops,
        )
        return corr, res, torch.zeros((B,), dtype=torch.bool, device=dev)

    # syndrome-zero split: zero-syndrome rows are done (result 0, data
    # untouched); the failing rows compact into ``fail_budget`` slots
    nz = (synd != 0).any(1)
    cs = torch.cumsum(nz.to(torch.int64), 0)
    n_fail = cs[-1]
    F = fail_budget
    slots = torch.arange(1, F + 1, device=dev)
    src = torch.searchsorted(cs, slots).clamp(0, B - 1)
    valid = slots <= n_fail
    data_f = torch.where(valid[:, None], data[src], 0)
    synd_f = torch.where(valid[:, None], synd[src], 0)
    bs_f = torch.where(valid, block_size[src], 1)
    corr_f, res_f = _rs_correct_batch(
        data_f, bs_f, synd_f, num_roots, first_root, min_distance, gf,
        m_synd, m_chien, ops,
    )
    # scatter the corrected rows back (valid ``src`` are strictly
    # increasing, so unique); invalid slots land in a dummy row B
    dest = torch.where(valid, src, B)
    corrected = torch.cat([data, data.new_zeros((1, L))])
    corrected[dest] = torch.where(valid[:, None], corr_f, 0)
    result = torch.zeros((B + 1,), dtype=torch.int64, device=dev)
    result[dest] = torch.where(valid, res_f, 0)
    overflow = nz & (cs - 1 >= F)
    result = torch.where(overflow, -1, result[:B])
    return corrected[:B], result, overflow


def _rs_correct_batch(data, block_size, synd, num_roots, first_root,
                      min_distance, gf, m_synd, m_chien, ops):
    """The correction path on precomputed syndromes: Berlekamp-Massey,
    Chien search, Forney magnitudes, in-place fix, syndrome recheck."""
    order = gf.order
    B, L = data.shape
    dev = data.device
    t2 = num_roots // 2
    lm = order - 1
    shift = lm - block_size  # (B,) right-align offset
    gmul = ops.mul

    # Berlekamp-Massey, unrolled over the (static) root count
    locator = torch.zeros((B, num_roots), dtype=torch.int64, device=dev)
    locator[:, 0] = 1
    corrector = torch.zeros((B, num_roots + 1), dtype=torch.int64,
                            device=dev)
    corrector[:, 1] = 1
    next_locator = torch.zeros((B, num_roots), dtype=torch.int64, device=dev)
    tracker = torch.zeros((B,), dtype=torch.int64, device=dev)
    idx_r = torch.arange(num_roots, device=dev)[None, :]
    low = idx_r <= t2
    for step in range(1, num_roots + 1):
        y = step - 1
        # e = synd[y] ^ XOR_{1<=i<=tracker} locator[i]*synd[y-i]
        gather = (y - idx_r).clamp(0, num_roots - 1).expand(B, -1)
        terms = gmul(locator, torch.gather(synd, 1, gather))
        terms = torch.where((idx_r >= 1) & (idx_r <= tracker[:, None]),
                            terms, 0)
        e = synd[:, y] ^ _xor_reduce(terms, 1)
        active = (e != 0)[:, None]
        nl_upd = locator ^ gmul(e[:, None], corrector[:, :num_roots])
        in_range = idx_r <= tracker[:, None]
        next_locator = torch.where(active & in_range, nl_upd, next_locator)
        corr_upd = gmul(locator, ops.inv(e)[:, None])
        corrector = torch.cat([
            torch.where(active & low, corr_upd, corrector[:, :num_roots]),
            corrector[:, num_roots:]], dim=1)
        locator = torch.where(active & low, next_locator, locator)
        tracker = torch.where(2 * tracker < step, step - tracker, tracker)
        corrector = torch.nn.functional.pad(corrector[:, :-1], (1, 0))

    # Chien search as a GF(2) matmul over the right-aligned frame
    bit_w = constant(_BIT_W, dev)
    loc_bits = ((locator[:, 1 : t2 + 1, None] >> bit_w) & 1).reshape(
        B, t2 * 8)
    cb = _gf2_matmul(loc_bits, m_chien).reshape(B, 8, lm)
    chien = (cb << bit_w[None, :, None]).sum(1)
    chien = chien ^ locator[:, None, 0]
    jp = torch.arange(lm, device=dev)[None, :]
    j_orig = jp - shift[:, None]  # (B, lm) original byte positions
    is_err = (chien == 0) & (j_orig >= 0)
    error_count = is_err.sum(1)
    # the t2 smallest error positions in ascending order, padded with L
    loc_sorted = torch.topk(torch.where(is_err, j_orig, L), t2, dim=1,
                            largest=False, sorted=True).values

    apply_fix = error_count <= (t2 - min_distance)

    # Forney error evaluator omega[i], i < t2
    omega = []
    for i0 in range(t2):
        acc = synd[:, first_root + i0]
        for jj in range(1, i0 + 1):
            acc = acc ^ gmul(synd[:, first_root + i0 - jj], locator[:, jj])
        omega.append(acc)
    omega = torch.stack(omega, dim=1)  # (B, t2)

    e_pos = (block_size[:, None] - loc_sorted - 1).clamp(0, order - 2)

    def fold(epw, jw):
        # alpha^(-e*j): the reference's two-step index fold reduces to this
        return (-(epw * jw)) % (order - 1)

    k_idx = torch.arange(t2, device=dev)[None, :]
    valid_err = k_idx < error_count[:, None]  # (B, t2)

    z_acc = omega[:, 0:1].expand(B, t2)
    for jj in range(1, t2):
        term = gmul(omega[:, jj : jj + 1], ops.pow(fold(e_pos, jj)))
        z_acc = torch.where(jj < error_count[:, None], z_acc ^ term, z_acc)
    z_acc = gmul(z_acc, ops.pow(e_pos))
    y_acc = locator[:, 1:2].expand(B, t2)
    for jj in range(3, t2 + 1, 2):
        term = gmul(locator[:, jj : jj + 1], ops.pow(fold(e_pos, jj - 1)))
        y_acc = y_acc ^ term
    # y_val = antilog[order - log[y] - 1] with the reference's log[0] == 0
    # and yidx == 255 -> 0 quirks: y in {0, 1} give 1, else y^-1
    y_val = torch.where(y_acc == 0, 1, ops.inv(y_acc))
    mags = gmul(y_val, z_acc)

    do_fix = valid_err & apply_fix[:, None]
    # masked entries go to column L, sliced off (the JAX package drops them)
    scatter_pos = torch.where(do_fix, loc_sorted, L)
    corr = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    corr.scatter_add_(1, scatter_pos, torch.where(do_fix, mags, 0))
    corrected = data ^ corr[:, :L]

    recheck = _rs_syndromes(corrected, block_size, num_roots, first_root,
                            gf, m_synd, ops)
    ok = (recheck == 0).all(1)
    result = torch.where(ok, error_count, -1)
    return corrected, result
