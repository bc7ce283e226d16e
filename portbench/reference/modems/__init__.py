"""Reference demods, one module a modem family, found by the chain spec's
``kind``.  Each has ``COHERENT`` (its bank takes an AGC normal a block
group), ``BYTES_PER_CHAIN_SAMPLE`` (the banked runtime's working set, for
the block geometry), ``params(spec)``, ``trim(params)`` (the samples the
FIRs consume) and ``baseband(spec, params, frame, normal, arith)``."""
