"""The aggregate worked out again: validation, cross-chain correlation and
the report text of one recording's per-chain packets, written plainly
from the upstream reference's semantics (pymodem's packet_meta.py and
crc_functions.py) and sharing no code with either package.

* CRC-16/X.25, bit-serial: init 0xFFFF, reflected polynomial 0x8408,
  final xor 0xFFFF; the carried CRC is the last two bytes, little-endian.
* A header is valid when the frame is longer than 15 bytes and its first
  seven bytes, shifted right once, are printable ASCII or NUL.
* Correlation: a valid packet, taken chain by chain, joins the first
  unique packet (in the order they were found) with the same calculated
  CRC, another decoder and a stream address nearer than the dedup window,
  and is unique otherwise.  The unique packets are then ordered by
  address.
* Reports: the dump of defective frames, then the styled report.
"""

from __future__ import annotations

U_FRAMES = {0x6F: "SABME", 0x2F: "SABM", 0x43: "DISC", 0x0F: "DM",
            0x63: "UA", 0x87: "FRMR", 0x03: "UI", 0xAF: "XID", 0xE3: "TEST"}
PIDS = {0x01: "ISO 8208", 0x06: "Compressed TCP/IP",
        0x07: "Uncompressed TCP/IP", 0x08: "Segmentation Fragment",
        0xC3: "TEXNET", 0xC4: "Link Quality Protocol", 0xCA: "Appletalk",
        0xCC: "ARPA Internet Protocol", 0xCD: "ARPA Address Resolution",
        0xCF: "TheNET (NET/ROM)", 0xF0: "No Layer 3", 0xFF: "Escape"}


def crc16(data) -> int:
    crc = 0xFFFF
    for byte in data:
        for k in range(8):
            if (crc ^ (byte >> k)) & 1:
                crc = (crc >> 1) ^ 0x8408
            else:
                crc >>= 1
    return crc ^ 0xFFFF


class Frame:
    """One decoded packet with its validation and correlation state."""

    def __init__(self, data, address: int, decoder: str, corrected: int):
        self.data = [int(v) for v in data]
        self.address = int(address)
        self.decoder = decoder
        self.corrected = int(corrected)
        self.carried = self.data[-1] * 256 + self.data[-2]
        self.calculated = crc16(self.data[:-2])
        self.crc_ok = self.carried == self.calculated
        self.header_ok = len(self.data) > 15 and all(
            v >> 1 == 0 or 32 <= v >> 1 <= 126 for v in self.data[:7])
        self.decoders: list = []

    @property
    def good(self) -> bool:
        return self.crc_ok and self.header_ok


def header_text(frame: list[int], sep: str) -> tuple[int, str]:
    """The address, control and PID fields as the reports print them, and
    the index of the first payload byte."""
    if len(frame) <= 15:
        return 0, ""
    text, i, n = [], 0, len(frame)
    field, pos, last = 0, 0, False
    while not last and i < n:
        last = bool(frame[i] & 1)
        c = frame[i] >> 1
        pos += 1
        if pos == 1:
            text.append("To:" if field == 0 else
                        sep + ("From:" if field == 1 else "Via:"))
        if pos < 7:
            if c not in (0, 0x20):
                text.append(chr(c))
        else:
            # the SSID byte; c is below 0x80, so the repeated mark, which
            # the reference tests as c & 0x80, never prints
            text.append(f"-{c & 0xF}")
            pos = 0
            field += 1
        i += 1
    if i < n:
        control = frame[i]
        text.append(f"{sep}Control: {hex(control)} ")
        kind = control & 3 if control & 1 else 0
        u = control & 0xEF if kind == 3 else 0
        if u in U_FRAMES:
            text.append(U_FRAMES[u])
        if kind == 0 or u == 3:
            i += 1
            text.append(f"{sep}PID: {hex(frame[i])} ")
            if frame[i] in PIDS:
                text.append(PIDS[frame[i]])
        i += 1
    text.append(" \n")
    return i, "".join(text)


def payload_text(frame: list[int], start: int) -> str:
    return "".join(chr(v) if 0x1F < v < 0x7F else f"<{hex(v)}>"
                   for v in frame[start:len(frame) - 2])


def _ranked(names: list) -> list[tuple]:
    """(name, count) by count, most first; ties in first-seen order."""
    counts: dict = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])


def reports(chains: list[list[Frame]], styles: list[str],
            window: float) -> list[str]:
    """The report text of each style over per-chain frames (in chain
    order), with the cross-chain dedup window ``window`` in samples."""
    unique: list[Frame] = []
    for frames in chains:
        for f in frames:
            if not f.good:
                continue
            twin = next((u for u in unique if u.calculated == f.calculated
                         and u.decoder != f.decoder
                         and abs(f.address - u.address) < window), None)
            if twin is None:
                f.decoders.append(f.decoder)
                unique.append(f)
            else:
                twin.decoders.append(f.decoder)
    unique.sort(key=lambda f: f.address)
    n_bad = sum(not f.good for frames in chains for f in frames)
    n_good = len(unique)

    dump, bad = [], 0
    for frames in chains:
        for f in frames:
            if f.good:
                continue
            bad += 1
            defects = (" bad CRC" if not f.crc_ok else "") + (
                " bad header" if not f.header_ok else "")
            start, head = header_text(f.data, ", ")
            dump += [f"Frame with defect: {defects}\n",
                     f"Packet number:  {bad} Calc CRC:  {hex(f.calculated)} "
                     f"Carried CRC:  {hex(f.carried)} stream address:  "
                     f"{f.address}\n",
                     f"source decoder:  {f.decoder}\n",
                     f"Packet byte count:  {len(f.data)}\n",
                     f"Bytes corrected:  {f.corrected}\n",
                     head, payload_text(f.data, start), "\n\n"]
    dump = "".join(dump)

    out = []
    for style in styles:
        text = []
        if style == "raw":
            text.append(dump)
            for k, f in enumerate(unique, 1):
                text += [f"Packet number:  {k}  CRC:  {hex(f.calculated)} "
                         f"stream address:  {f.address}\n",
                         f"source decoders:  {f.decoders}\n",
                         payload_text(f.data, 0), " \n"]
            text += [f"\nValid packets:  {n_good}\n", f"CRC saves:  {n_bad}\n"]
        elif style == "decoded_headers":
            for k, f in enumerate(unique, 1):
                start, head = header_text(f.data, ", ")
                text += [f"\n\nPacket number:  {k}  CRC:  {hex(f.calculated)} "
                         f"stream address:  {f.address}\n",
                         f"Source decoders:  {f.decoders}\n",
                         f"Packet byte count:  {len(f.data)}\n",
                         f"Bytes corrected:  {f.corrected}\n",
                         head, payload_text(f.data, start)]
            text += [f"\n\nUnique, valid packets:  {n_good}\n",
                     "Packets rejected from all decoders for CRC failure:  "
                     f"{n_bad}\n", "Total packets by decoder:\n"]
            text += [f"{d} {n}\n" for d, n in
                     _ranked([d for f in unique for d in f.decoders])]
            text.append("Unique packets by decoder:\n")
            text += [f"{d} {n}\n" for d, n in
                     _ranked([f.decoder for f in unique
                              if len(f.decoders) == 1])]
        out.append(dump + "".join(text))
    return out
