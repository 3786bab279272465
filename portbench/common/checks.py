"""Comparisons that decide `correct`, and the shared result types.

Every number compared is a gap between the program's reading and the
reference's, with a limit of its own from the configuration file; the
run is correct when every gap is at or under its limit and every number
is finite. A number that could not be read is not correct.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch


@dataclasses.dataclass
class Result:
    """What a driver hands back to the harness."""
    metrics: dict            # end-to-end metric name -> value
    checks: dict             # compared number -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    window: object = None    # the trace.Window of the run
    counts: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)   # earlier lines to print

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            isinstance(v, float) and math.isfinite(v) and v <= lim
            for v, lim in self.checks.values())


def held(readings: dict, limits: dict) -> dict:
    """{name: (value, limit)} for every limit; a reading that is missing
    stands as NaN, which fails."""
    return {k: (float(readings.get(k, float("nan"))), float(lim)) for k, lim in limits.items()}


def leaf_norms(tensors) -> list[float]:
    return [float(t.float().norm()) for t in tensors]


def norm_gap(got, want, masks=None) -> float:
    """Worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    if masks is not None:
        got = [g[m] for g, m in zip(got, masks)]
        want = [w[m] for w, m in zip(want, masks)]
    g, w = leaf_norms(got), leaf_norms(want)
    med = statistics.median(w)
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(g, w))


def moving_masks(ref_grad, share: float = 1e-3):
    """Elements whose reference gradient is at least `share` of the median
    leaf's RMS gradient: the others move under Adam by round-off alone."""
    rms = statistics.median(float(t.float().pow(2).mean().sqrt()) for t in ref_grad)
    return [t.abs() >= share * rms for t in ref_grad]


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / max(float(want.double().norm()), 1e-30))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of every value."""
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]
