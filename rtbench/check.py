"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference works out for the same inputs.

Every number is a gap that is 0 when the two agree; a run is correct when
each is finite and at most its limit
(``rtbench/limits/<config>.<render>.json``).
"""

from __future__ import annotations

import numpy as np
import torch

# a pixel is off when a channel differs by more than this: a path that
# takes another turn than the reference's moves its pixel by about
# 1 / spp of a radiance, far above it; rounding alone stays far below
PX_TOL = 3e-4


def image_sums(got, want) -> np.ndarray:
    """[pixels off, pixels, sum of |got - want|, values] of two (P, 3)
    arrays or tensors; a non-finite value counts as off."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64).to(got.device)
    d = (got - want).abs()
    worst = d.amax(dim=-1)
    return np.array([float((~(worst <= PX_TOL)).sum()), worst.numel(),
                     float(d.sum()), d.numel()], np.float64)


def image_numbers(sums) -> dict:
    """The image's compared numbers from :func:`image_sums` (summed over
    blocks or ranks): the share of pixels off and the mean absolute
    difference."""
    off, n, abs_sum, values = (float(x) for x in sums)
    return {"px_off_share": off / max(n, 1),
            "img_mae": abs_sum / max(values, 1)}


def leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.as_tensor(v).double().norm()) for k, v in
            leaves.items()}


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """max over leaves of | |got| - |want| | / max(|want|, the median
    leaf's |want|): the gap of the norms, not the norm of the difference,
    against the larger of the leaf's own norm and the median leaf's.
    ``keep``: the leaves compared (all by default)."""
    g, w = leaf_norms(got), leaf_norms(want)
    keys = [k for k in w if keep is None or k in keep]
    med = float(np.median([w[k] for k in w]))
    out = 0.0
    for k in keys:
        gap = abs(g[k] - w[k]) / max(w[k], med, 1e-30)
        out = max(out, gap if np.isfinite(gap) else float("inf"))
    return out


def moved_leaves(grads: dict, rule: float = 1e-3) -> set:
    """The leaves whose reference gradient is at least ``rule`` times the
    median leaf's: the others move by round-off alone."""
    n = leaf_norms(grads)
    med = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= rule * med}
