"""The comparison that decides ``correct``: each number beside its limit.

Norms are compared leaf by leaf, and a leaf's gap is that of the two
norms (not the norm of the difference), against the reference's norm of
that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the gradient, change and momentum
comparisons.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's is left out


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [n for n, g in ref_grad.items() if g >= QUIET * med]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) over ``leaves`` (default: all of ``ref``)."""
    gaps = leaf_gaps(prog, ref, leaves)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap over ``leaves`` (default: all of ``ref``)."""
    names = list(ref if leaves is None else leaves)
    med = float(np.median([ref[n] for n in names]))
    out = {}
    for n in names:
        p = prog.get(n, math.nan)
        out[n] = abs(p - ref[n]) / max(ref[n], med) if math.isfinite(p) else math.inf
    return out


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> float:
    """The median leaf's gap: steady from seed to seed where single leaves
    (BatchNorm's affine parameters, whose gradients are sums that nearly
    cancel) swing with rounding."""
    return float(np.median(list(leaf_gaps(prog, ref, leaves).values())))


def rel_gap(prog: List[float], ref: List[float]) -> float:
    """The largest |p − r| / |r| over paired values; inf where p is not finite."""
    worst = 0.0
    for p, r in zip(prog, ref):
        gap = abs(p - r) / abs(r) if math.isfinite(p) else math.inf
        worst = max(worst, gap)
    return worst if len(prog) == len(ref) else math.inf


def check(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[list]]:
    """(correct, [[name, value, limit], ...]): correct when every reading
    has a limit and is finite and within it."""
    rows, ok = [], True
    for name, value in readings.items():
        limit = limits.get(name)
        rows.append([name, value, limit])
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok, rows
