"""Reference codecs, one module a codec kind: ``max_packet_seconds(spec,
bit_rate)`` (the wire time of its longest packet at the chain's line bits
a second, for the block overlap) and ``decode(spec, raw, addresses)`` (the
packets)."""
