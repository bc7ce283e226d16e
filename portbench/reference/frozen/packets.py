# Frozen copy of the JAX package's pymodem_tpu/packets.py at commit
# 0117b87, only printable_header, Packet; its jax imports and device
# functions left out; relative imports pointed at this folder. The
# benchmark's reference: it is not the port's code, and it is not edited
# to follow either package.
"""Packet records and cross-chain correlation/reporting.

Host-side aggregation layer: collects decoded packets from every chain,
CRC/header-validates them, deduplicates across chains by (stream address
window, calculated CRC) and renders the text reports.  Mirrors the behaviour
of the reference's packet_meta.py (PacketMeta/PacketMetaArray) including its
exact report text format, so outputs are diffable against the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .crc import np_check_packet


def printable_header(frame) -> bool:
    """AX.25 address-field sanity check (packet_meta.py:21-41).

    Every callsign character (first 7 bytes of each address subfield,
    shifted right once) must be printable ASCII or NUL.  Note the reference
    checks *all* bytes of the frame this way with subfield_character_index
    never reset, so in effect only the first 7 bytes are constrained.
    """
    if len(frame) <= 15:
        return False
    subfield_char = 0
    for value in frame:
        ch = int(value) >> 1
        if subfield_char < 7 and (ch < 32 or ch > 126) and ch != 0:
            return False
        subfield_char += 1
    return True


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
        self.carried_crc, self.calculated_crc, self.valid_crc = np_check_packet(self.data)
        self.valid_header = printable_header(self.data)


