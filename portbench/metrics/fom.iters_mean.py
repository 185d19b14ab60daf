"""fom.iters_mean: the per-sample iteration counts the window's FOM solves
report (``make_fom_solver(..., with_iters=True)``), averaged."""

import numpy as np


def read(run):
    its = [r["iters"] for r in run.solves]
    return float(np.mean(np.concatenate(its))) if its else None
