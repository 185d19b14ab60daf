"""Canonical thermal-fin geometry (SURVEY.md Appendix B).

The domain is the classic reduced-basis thermal fin: a vertical central post
of width 1 (x in [-0.5, 0.5], y in [0, 4]) with four horizontal subfin pairs,
each a rectangle of thickness 0.25 extending to x = +-3, attached at heights
y in [0.75, 1.0], [1.75, 2.0], [2.75, 3.0], [3.75, 4.0].

Conductivity regions (SURVEY.md Appendix A.2, 5-parameter model):
  region i in {0,1,2,3}: subfin pair i+1 — the two wings (|x| > 0.5) at
      height band i;
  region 4 (REGION_POST): the central post, including the strip behind the
      wings.

Boundaries:
  Gamma_root: the bottom edge (y = 0, |x| <= 0.5) — unit heat flux in;
  Gamma_ext:  all remaining boundary — Robin (Biot) cooling.
"""

from __future__ import annotations

import numpy as np

POST_HALF_WIDTH = 0.5
POST_HEIGHT = 4.0
FIN_EXTENT = 3.0  # wings reach x = +-3
SUBFIN_THICKNESS = 0.25
N_SUBFIN_PAIRS = 4
N_REGIONS = 5
REGION_POST = 4


def subfin_y_interval(i: int) -> tuple[float, float]:
    """y-interval of subfin pair i (i = 0..3): [0.75 + i, 1.0 + i]."""
    lo = 0.75 + float(i)
    return lo, lo + SUBFIN_THICKNESS


def in_domain(points: np.ndarray) -> np.ndarray:
    """Boolean mask of which points lie inside the fin domain.

    points: (..., 2) array. Intended for cell centroids (never exactly on a
    region boundary for the structured meshes produced by ``build_fin_mesh``).
    """
    x = points[..., 0]
    y = points[..., 1]
    in_post = (np.abs(x) <= POST_HALF_WIDTH) & (y >= 0.0) & (y <= POST_HEIGHT)
    in_wing = np.zeros_like(in_post)
    for i in range(N_SUBFIN_PAIRS):
        lo, hi = subfin_y_interval(i)
        in_wing |= (np.abs(x) <= FIN_EXTENT) & (y >= lo) & (y <= hi)
    return in_post | in_wing


def region_of_points(points: np.ndarray) -> np.ndarray:
    """Conductivity region id for each point (intended for cell centroids).

    Returns int array in [0, N_REGIONS); points outside the domain get -1.
    """
    x = points[..., 0]
    y = points[..., 1]
    region = np.full(x.shape, -1, dtype=np.int32)
    # wings first: |x| > post half-width inside a subfin band
    for i in range(N_SUBFIN_PAIRS):
        lo, hi = subfin_y_interval(i)
        wing = (np.abs(x) > POST_HALF_WIDTH) & (np.abs(x) <= FIN_EXTENT)
        wing &= (y >= lo) & (y <= hi)
        region[wing] = i
    post = (np.abs(x) <= POST_HALF_WIDTH) & (y >= 0.0) & (y <= POST_HEIGHT)
    region[post] = REGION_POST
    return region
