"""idle_pct.da: the share of an outer step (%) in which the card runs no
kernel, copy or set, as an untraced run sees it: one minus the device's busy
time per traced step (the union of the profiler's device intervals over the
traced steps, which the profiler's host overhead does not lengthen) over the
mean host-clock interval of the untraced steps."""

import numpy as np


def read(run):
    step = run.untraced("step_ms")
    if run.trace_data is None or not run.traced_steps or not step:
        return None
    busy_ms = 1e3 * run.trace_data.busy_s / run.traced_steps
    return 100.0 * (1.0 - busy_ms / float(np.mean(step)))
