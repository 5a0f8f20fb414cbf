"""Metrics read by name, one module a metric, each with ``read(ctx)``:
the value from the traced chunks' reading (``ctx["trace"]``, a
:class:`benchmark.trace.Reading`, and ``ctx["chunk"]``, the records a
chunk), the window (``ctx["window"]``, a
:class:`benchmark.window.Window`), the set-up's spans
(``ctx["spans"]``) and the step's byte count (``ctx["step_bytes"]``),
or None where it finds nothing to read. Every end-to-end metric but
``setup_s`` and every per-layer metric has one."""
