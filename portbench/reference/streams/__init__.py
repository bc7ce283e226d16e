"""Reference stream stages, one module a stream kind: ``apply(spec,
raw)`` turns the slicer's bytes into the codec's."""
