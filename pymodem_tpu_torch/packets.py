"""Packet records and cross-chain correlation/reporting.

Host-side aggregation layer: collects decoded packets from every chain,
CRC/header-validates them, deduplicates across chains by (stream address
window, calculated CRC) and renders the text reports.  Mirrors the behaviour
of the reference's packet_meta.py (PacketMeta/PacketMetaArray) including its
exact report text format, so outputs are diffable against the reference.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from .ops.crc import check_rows, gather_rows


def printable_headers(flat: np.ndarray, starts: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
    """AX.25 address-field sanity check of every packet gathered by
    ``ops.crc.gather_rows`` (packet_meta.py:21-41), as a bool array.

    Every callsign character (first 7 bytes of each address subfield,
    shifted right once) must be printable ASCII or NUL.  Note the reference
    checks *all* bytes of the frame this way with subfield_character_index
    never reset, so in effect only the first 7 bytes are constrained, and a
    frame of 15 bytes or fewer fails.
    """
    long_enough = lengths > 15
    chars = flat[starts[long_enough, None] + np.arange(7)] >> 1
    printable = ((chars == 0) | ((chars >= 32) & (chars <= 126))).all(axis=1)
    out = np.zeros(len(lengths), dtype=bool)
    out[long_enough] = printable
    return out


def printable_header(frame) -> bool:
    """``printable_headers`` of one frame."""
    return bool(printable_headers(*gather_rows([frame]))[0])


@dataclass
class Packet:
    data: list[int] = field(default_factory=list)
    streamaddress: int = 0
    source_decoder: str | int = 0
    bytes_corrected: int = 0
    carried_crc: int = 0
    calculated_crc: int = 0
    valid_crc: bool = False
    valid_header: bool = False
    correlated_decoders: list = field(default_factory=list)

    def validate(self) -> None:
        validate_packets([self])


def validate_packets(packets: list[Packet]) -> int:
    """Set every packet's carried and calculated CRC, ``valid_crc`` and
    ``valid_header`` (Python ints and bools) from one batched CRC and
    header pass over all of them; returns the bytes the pass covered.  No
    packets, no numpy call."""
    if not packets:
        return 0
    flat, starts, lengths = gather_rows([p.data for p in packets])
    carried, calculated, valid = check_rows(flat, starts, lengths)
    header = printable_headers(flat, starts, lengths)
    for packet, c, k, v, h in zip(packets, carried.tolist(),
                                  calculated.tolist(), valid.tolist(),
                                  header.tolist()):
        packet.carried_crc, packet.calculated_crc = c, k
        packet.valid_crc, packet.valid_header = v, h
    return len(flat)


_U_CONTROL_NAMES = {
    0x6F: "SABME", 0x2F: "SABM", 0x43: "DISC", 0x0F: "DM", 0x63: "UA",
    0x87: "FRMR", 0x03: "UI", 0xAF: "XID", 0xE3: "TEST",
}

_PID_NAMES = {
    0x01: "ISO 8208", 0x06: "Compressed TCP/IP", 0x07: "Uncompressed TCP/IP",
    0x08: "Segmentation Fragment", 0xC3: "TEXNET", 0xC4: "Link Quality Protocol",
    0xCA: "Appletalk", 0xCC: "ARPA Internet Protocol",
    0xCD: "ARPA Address Resolution", 0xCF: "TheNET (NET/ROM)",
    0xF0: "No Layer 3", 0xFF: "Escape",
}


def format_ax25_header(frame, delimiter: str) -> tuple[int, str]:
    """Render To/From/Via + control/PID; returns (payload_start_index, text).

    Text format matches packet_meta.py:43-169 byte-for-byte (including the
    trailing space line).
    """
    out: list[str] = []
    count = len(frame)
    index = 0
    if count > 15:
        extension_bit = 0
        subfield_char = 0
        subfield = 0
        while extension_bit == 0 and index < count:
            ch = int(frame[index])
            if ch & 1:
                extension_bit = 1
            ch >>= 1
            subfield_char += 1
            if subfield_char == 1:
                if subfield == 0:
                    out.append("To:")
                elif subfield == 1:
                    out.append(delimiter + "From:")
                else:
                    out.append(delimiter + "Via:")
            if subfield_char < 7:
                if ch != 0 and ch != 0x20:
                    out.append(chr(ch))
            elif subfield_char == 7:
                out.append(f"-{ch & 0xF}")
                if ch & 0x80:
                    out.append("* ")
                subfield_char = 0
                subfield += 1
            index += 1
            if index > count:
                extension_bit = 1
        if index < count:
            control = int(frame[index])
            out.append(delimiter + f"Control: {hex(control)} ")
            if control & 1:
                frame_type = control & 3
            else:
                frame_type = 0
            u_type = control & 0xEF if frame_type == 3 else 0
            if u_type in _U_CONTROL_NAMES:
                out.append(_U_CONTROL_NAMES[u_type])
            if frame_type == 0 or u_type == 3:
                index += 1
                pid = int(frame[index])
                out.append(delimiter + f"PID: {hex(pid)} ")
                if pid in _PID_NAMES:
                    out.append(_PID_NAMES[pid])
            index += 1
        out.append(" \n")
    return index, "".join(out)


def _payload_text(data, start: int) -> str:
    out = []
    for i in range(start, len(data) - 2):
        byte = int(data[i])
        out.append(chr(byte) if 0x1F < byte < 0x7F else f"<{hex(byte)}>")
    return "".join(out)


class PacketAggregate:
    """Cross-chain packet collection (packet_meta.py:210-370)."""

    def __init__(self) -> None:
        self.chains: list[list[Packet]] = []
        self.unique: list[Packet] = []
        self.decoder_histogram: Counter = Counter()
        self.decoder_unique_histogram: Counter = Counter()

    def add(self, packets: list[Packet]) -> None:
        self.chains.append(packets)

    def validate_all(self) -> int:
        """Validate every chain's packets, in config order, in one batched
        pass (``validate_packets``); returns the bytes it covered."""
        return validate_packets(
            [packet for chain in self.chains for packet in chain])

    def correlate(self, address_distance: float) -> None:
        """Dedup valid packets by (|address delta| < distance, equal CRC,
        different decoder) (packet_meta.py:230-271).

        Semantics match the reference's O(unique x raw) pairwise scan
        exactly, but the work is bucketed by calculated CRC: only
        equal-CRC packets can ever correlate, and bucket insertion order
        is unique-list insertion order, so first-match-within-bucket ==
        the reference's first-match-in-unique-order.  Packet-dense bank
        runs (thousands of raw packets) stay linear-ish instead of
        quadratic."""
        from collections import defaultdict

        by_crc: dict[int, list[Packet]] = defaultdict(list)
        first = True
        for chain in self.chains:
            for packet in chain:
                if not (packet.valid_crc and packet.valid_header):
                    continue
                is_unique = True
                if not first:
                    for seen in by_crc[packet.calculated_crc]:
                        if (
                            seen.source_decoder != packet.source_decoder
                            and abs(packet.streamaddress - seen.streamaddress)
                            < address_distance
                        ):
                            is_unique = False
                            seen.correlated_decoders.append(packet.source_decoder)
                            break
                if is_unique:
                    packet.correlated_decoders.append(packet.source_decoder)
                    self.unique.append(packet)
                    by_crc[packet.calculated_crc].append(packet)
            first = False
        self.unique.sort(key=lambda p: p.streamaddress)
        unique_decoders = []
        all_decoders = []
        for packet in self.unique:
            all_decoders.extend(packet.correlated_decoders)
            if len(packet.correlated_decoders) == 1:
                unique_decoders.append(packet.source_decoder)
        self.decoder_unique_histogram = Counter(unique_decoders)
        self.decoder_histogram = Counter(all_decoders)

    def count_bad(self) -> int:
        return sum(
            1
            for chain in self.chains
            for p in chain
            if not (p.valid_crc and p.valid_header)
        )

    def count_good(self) -> int:
        return sum(1 for p in self.unique if p.valid_crc and p.valid_header)

    def render_raw_bad(self) -> str:
        """Defective-frame dump (packet_meta.py:283-309)."""
        out = []
        bad = 0
        for chain in self.chains:
            for p in chain:
                if p.valid_crc and p.valid_header:
                    continue
                bad += 1
                defects = ""
                if not p.valid_crc:
                    defects += " bad CRC"
                if not p.valid_header:
                    defects += " bad header"
                out.append(f"Frame with defect: {defects}\n")
                out.append(
                    f"Packet number:  {bad} Calc CRC:  {hex(p.calculated_crc)} "
                    f"Carried CRC:  {hex(p.carried_crc)} stream address:  "
                    f"{p.streamaddress}\n"
                )
                out.append(f"source decoder:  {p.source_decoder}\n")
                out.append(f"Packet byte count:  {len(p.data)}\n")
                out.append(f"Bytes corrected:  {p.bytes_corrected}\n")
                start, header = format_ax25_header(p.data, ", ")
                out.append(header)
                out.append(_payload_text(p.data, start))
                out.append("\n\n")
        return "".join(out)

    def render_report(self, style: str) -> str:
        """Styled report (packet_meta.py:337-370)."""
        out = []
        if style == "raw":
            out.append(self.render_raw_bad())
            good = 0
            for p in self.unique:
                if p.valid_crc and p.valid_header:
                    good += 1
                    out.append(
                        f"Packet number:  {good}  CRC:  {hex(p.calculated_crc)} "
                        f"stream address:  {p.streamaddress}\n"
                    )
                    out.append(f"source decoders:  {p.correlated_decoders}\n")
                    out.append(_payload_text(p.data, 0))
                    out.append(" \n")
            out.append(f"\nValid packets:  {self.count_good()}\n")
            out.append(f"CRC saves:  {self.count_bad()}\n")
        elif style == "decoded_headers":
            count = 0
            for p in self.unique:
                if not (p.valid_crc and p.valid_header):
                    continue
                count += 1
                out.append(
                    f"\n\nPacket number:  {count}  CRC:  {hex(p.calculated_crc)} "
                    f"stream address:  {p.streamaddress}\n"
                )
                out.append(f"Source decoders:  {p.correlated_decoders}\n")
                out.append(f"Packet byte count:  {len(p.data)}\n")
                out.append(f"Bytes corrected:  {p.bytes_corrected}\n")
                start, header = format_ax25_header(p.data, ", ")
                out.append(header)
                out.append(_payload_text(p.data, start))
            out.append(f"\n\nUnique, valid packets:  {self.count_good()}\n")
            out.append(
                "Packets rejected from all decoders for CRC failure:  "
                f"{self.count_bad()}\n"
            )
            out.append("Total packets by decoder:\n")
            for decoder, n in self.decoder_histogram.most_common():
                out.append(f"{decoder} {n}\n")
            out.append("Unique packets by decoder:\n")
            for decoder, n in self.decoder_unique_histogram.most_common():
                out.append(f"{decoder} {n}\n")
        return "".join(out)
