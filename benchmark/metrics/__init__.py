"""One reader a metric, found by the metric's name: read(run) -> float or
None (nothing to read). `run` is harness.Run; per-layer readers read
run.trace. A name `<name>.<split>` is read by <name>'s reader: the same
quantity, split by the end-to-end metric its entry moves (`.device` for
device_mpix_s). A reader may name a program function whose arguments it
needs (CAPTURE = (module, attribute)), which the traced window then keeps;
an end-to-end reader that reads the traced steps says TRACE = True, and
the harness then runs them after the window of an untraced run too."""
