"""One reader a metric, found by the metric's name: read(run) -> float or
None (nothing to read). `run` is harness.Run; per-layer readers read
run.trace. A reader may name a program function whose arguments it needs
(CAPTURE = (module, attribute)), which the traced window then keeps."""
