"""Reference codecs, one module a codec kind: ``max_packet_seconds(spec,
symbol_rate)`` (the wire time of its longest packet, for the block
overlap) and ``decode(spec, raw, addresses)`` (the packets)."""
