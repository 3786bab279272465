"""Tracing and per-stage timing.

Counterpart of `labelany3d_tpu/utils/profiling.py`:
  * `StageTimer`: wall clock and item counts per stage; `GLOBAL_TIMER` is
    the one the runner's CLI reports at exit;
  * `trace(logdir)`: a `torch.profiler` run of the host and, when there is
    one, the card, written as a Chrome trace under `logdir`;
  * `annotate(name, unit)`: the program's span. Always an NVTX range on the
    card for other tools; while a `torch.profiler` runs (`trace`, or any
    other caller's), also a named range in its trace and a `Span` kept in
    memory (`spans()`, `clear_spans()`). A running profiler is the only
    switch: with none, nothing is kept.
"""

from __future__ import annotations

import contextlib
import os
import threading
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
    clear_spans()
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


@dataclass(slots=True)
class Span:
    """One `annotate` range recorded while a profiler ran. `start` and `end`
    are `time.perf_counter_ns()` (`end` is None while it is open);
    `parent` is the index in `spans()` of the span that enclosed it on the
    same thread; `unit` is the identifier the spans of one step or one
    batch share (a span given none takes its parent's); `events` are CUDA
    timing events recorded on the current stream at its two edges, where
    the process has initialised CUDA."""
    name: str
    thread: int
    start: int
    end: int | None
    parent: int | None
    unit: object
    events: tuple | None


class _Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.lock = threading.Lock()
        self.local = threading.local()   # `stack`: (list, index, span) of the open spans

    @contextlib.contextmanager
    def span(self, name: str, unit):
        import torch

        stack = self.local.__dict__.setdefault("stack", [])
        parent = None
        if stack and stack[-1][0] is self.spans:  # not from before a `clear_spans()`
            parent = stack[-1][1]
            if unit is None:
                unit = stack[-1][2].unit
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        rec = Span(name, threading.get_ident(), time.perf_counter_ns(), None, parent, unit, events)
        with self.lock:
            spans = self.spans
            spans.append(rec)
            index = len(spans) - 1
        stack.append((spans, index, rec))
        try:
            yield
        finally:
            stack.pop()
            if events is not None:
                events[1].record()
            rec.end = time.perf_counter_ns()

    def clear(self) -> None:
        with self.lock:
            self.spans = []


_RECORDER = _Recorder()


def spans() -> list[Span]:
    """The spans recorded since the last `clear_spans()` (or `trace()`), in
    the order they opened; the list itself, not a copy."""
    return _RECORDER.spans


def clear_spans() -> None:
    _RECORDER.clear()


@contextlib.contextmanager
def annotate(name: str, unit=None):
    """The program's span: an NVTX range when CUDA is present, and, while a
    torch profiler runs, a named range in its trace (`record_function`)
    and a `Span` in `spans()`."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(name), _RECORDER.span(name, unit):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
