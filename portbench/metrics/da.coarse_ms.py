"""da.coarse_ms: the rest of an outer step (ms), the subchain of rom_nn pCN
steps and the accept: the mean host-clock interval of the window's untraced
steps less the mean of their fine misfits (CUDA events). Read in a
``--trace 1`` run from the steps before the trace starts, which run as in an
untraced run."""

import numpy as np


def read(run):
    step, fine = run.untraced("step_ms"), run.untraced("fine_ms")
    if not run.trace or not step or not fine:
        return None
    return float(np.mean(step) - np.mean(fine))
