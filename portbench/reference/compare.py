"""The comparisons that decide ``correct``.

``lane_mismatch``: the port's packets in sampled (chain, block) lanes
against the reference decode of the same lanes (``decode.decode_lanes``):
every packet, valid or not, pairs by its bytes and, within a byte of line
bits, its stream address.

``report_mismatch``: the aggregate.  ``aggregate.py``, written apart
from both packages, takes the port's per-chain packets (checked lane by
lane above) and works out again the validation, the cross-chain
correlation and the report text, which must equal the port's reports:
this stage follows the port's own per-chain packets, as it can follow
nothing else without decoding every lane.
"""

from __future__ import annotations

from . import aggregate, decode


def lane_mismatch(ref: dict, port: list[list], lanes: list, geo, chains,
                  log=None) -> dict:
    """The port's packets in the sampled lanes against the reference's.

    ref: {(chain, block): [(bytes, address)]}; port: per chain
    [(bytes, address, corrected)].  A packet pairs with one of the same
    bytes whose stream address lies within one byte of line bits
    (8 / bits per symbol symbol periods): a packet's address is that of
    its last byte's emission, so it carries the slicer's bit phase within
    the byte, which a coherent loop's path through noise before the frame
    sets.  A reference packet that the port dropped as a block-boundary
    duplicate (the same bytes within the dedup window, 16 symbol periods,
    of a packet it kept outside this block) counts as paired.  Returns the
    counts: ``missing`` (no partner), ``moved`` (paired at another
    address), ``paired`` and ``total`` (packets on both sides)."""
    out = dict(missing=0, moved=0, paired=0, total=0)
    for c, b in lanes:
        lo, hi = geo.keep_range(b)
        sl = chains[c].slicer
        sps = sl.sample_rate / sl.symbol_rate
        quantum = 8.0 / decode.bits_per_symbol(sl) * sps
        window = 16.0 * sps
        r = sorted(ref[(c, b)], key=lambda x: x[1])
        p = sorted(((d, a) for d, a, _ in port[c] if lo < a <= hi),
                   key=lambda x: x[1])
        out["total"] += len(r) + len(p)
        free = list(p)
        for d, a in r:
            near = [x for x in free if x[0] == d and abs(x[1] - a) <= quantum]
            if near:
                best = min(near, key=lambda x: abs(x[1] - a))
                free.remove(best)
                out["paired"] += 1
                out["moved"] += best[1] != a
            elif any(d2 == d and abs(a2 - a) < window and not lo < a2 <= hi
                     for d2, a2, _ in port[c]):
                out["paired"] += 1
            else:
                out["missing"] += 1
                if log:
                    log(f"  lane {(c, b)}: reference packet at {a}, "
                        f"{len(d)} bytes, not in the port's")
        out["missing"] += len(free)
        if log:
            for d, a in free:
                same = [a2 for d2, a2 in r if d2 == d]
                log(f"  lane {(c, b)}: port packet at {a}, {len(d)} bytes, "
                    f"not in the reference's (same bytes at {same})")
    return out


def readings(counts: dict) -> dict:
    """The numbers compared: packets without a partner, as a share of the
    packets on both sides, and paired packets at another address, as a
    share of the pairs."""
    return {
        "packet_mismatch_pct": 100.0 * counts["missing"] / max(counts["total"], 1),
        "address_moved_pct": 100.0 * counts["moved"] / max(counts["paired"], 1),
    }


def reports(lines: list[dict], chains: list, port: list[list],
            sample_rate: float) -> list[str]:
    """The reports of the configuration's report lines over the port's
    per-chain packets.  The dedup window is the plan runner's
    (``runtime/bank._finish_plan``): the upstream reference's rate / 40,
    widened by two byte-phase quanta of the slowest slicer, since every
    block restarts its slicer's byte count."""
    frames = [[aggregate.Frame(d, a, chain.codec.ident, k) for d, a, k in pk]
              for chain, pk in zip(chains, port)]
    max_sps = max((c.slicer.sample_rate / c.slicer.symbol_rate
                   for c in chains), default=1.0)
    styles = [line.get("options", {}).get("style", "raw") for line in lines
              if line.get("object_type") == "report"]
    return aggregate.reports(frames, styles, sample_rate / 40 + 16 * max_sps)


def report_mismatch(lines, chains, port, port_reports, sample_rate) -> int:
    """Reports whose text differs from the one worked out again."""
    mine = reports(lines, chains, port, sample_rate)
    if len(mine) != len(port_reports):
        return max(len(mine), len(port_reports))
    return sum(a != b for a, b in zip(mine, port_reports))
