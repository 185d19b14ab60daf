"""The share of the traced window (%) in which the card ran no kernel, copy
or set: one minus the union of the profiler's device intervals over the
window's length."""


def read(run):
    return None if run.trace_data is None else run.trace_data.idle_pct()
