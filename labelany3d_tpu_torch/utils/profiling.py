"""Per-stage timing.

Counterpart of `StageTimer` in `labelany3d_tpu/utils/profiling.py`: wall
clock and item counts per stage. Device traces come from `torch.profiler`
directly (see `chip_smoke.py`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    total_seconds: float = 0.0
    calls: int = 0
    items: int = 0

    @property
    def items_per_second(self) -> float:
        return self.items / self.total_seconds if self.total_seconds > 0 else 0.0


@dataclass
class StageTimer:
    stats: dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def measure(self, stage: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stats[stage]
            s.total_seconds += time.perf_counter() - t0
            s.calls += 1
            s.items += items

    def add_items(self, stage: str, items: int) -> None:
        self.stats[stage].items += items

    def report(self) -> str:
        lines = [f"{'stage':<20} {'sec':>9} {'calls':>7} {'items':>8} {'items/s':>9}"]
        for name in sorted(self.stats):
            s = self.stats[name]
            lines.append(f"{name:<20} {s.total_seconds:>9.2f} {s.calls:>7} {s.items:>8} "
                         f"{s.items_per_second:>9.2f}")
        return "\n".join(lines)
