"""Reference slicers, one module a slicer kind: ``slice(spec, baseband,
arith)`` gives (bytes, 1-based sample addresses) of each completed byte."""
