"""da.fine_ms: the fine correction's time per outer step (ms), from the
benchmark's CUDA events around the fine-misfit callable that the window
hands to ``da_step`` (the batched FOM solve, its observables and misfit),
averaged over the steps of a ``--trace 1`` run before its trace starts."""

import numpy as np


def read(run):
    ms = run.untraced("fine_ms") if run.trace else None
    return float(np.mean(ms)) if ms else None
