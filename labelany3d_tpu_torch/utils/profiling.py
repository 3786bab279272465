"""Tracing and per-stage timing.

Counterpart of `labelany3d_tpu/utils/profiling.py`:
  * `StageTimer`: wall clock and item counts per stage; `GLOBAL_TIMER` is
    the one the runner's CLI reports at exit;
  * `trace(logdir)`: a `torch.profiler` run of the host and, when there is
    one, the card, written as a Chrome trace under `logdir`;
  * `annotate(name)`: a named range in that trace, and an NVTX range on the
    card for other tools.
"""

from __future__ import annotations

import contextlib
import os
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


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU activity, and CUDA activity when a card is
    present) and write `<logdir>/trace_<pid>_<ms>.json` (Chrome trace format,
    readable by chrome://tracing or Perfetto). Yields the profiler, whose
    `key_averages()` summarise the block; its trace file is
    `trace_path` once the block has ended."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's trace (`record_function`), and an NVTX
    range when CUDA is present."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
