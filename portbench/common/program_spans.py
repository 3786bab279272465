"""The program's own spans, placed on the device trace's clock.

The port records a span for each `annotate` range while a torch profiler
runs (`labelany3d_tpu_torch/utils/profiling.py`: `spans()`), which the
traced window's profiler does. A span holds its name, thread, host start
and end (`time.perf_counter_ns()`, the clock `Window` maps onto the trace
with its marker kernel), the index of its enclosing span on the same
thread, its unit, and, on CUDA, a pair of timing events recorded on the
stream at its edges.

Readers of per-layer metrics call `device_ms` or `idle_share`. Both read
nothing, and return None, where the program keeps no spans (a program
without `spans()`) or none of the name fell inside the window.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import NamedTuple


class Placed(NamedTuple):
    index: int      # the span's index in the program's list
    span: object    # the program's `Span`
    start: int      # trace ns
    end: int        # trace ns


def recorded() -> list:
    """The program's spans, or [] where it keeps none."""
    from labelany3d_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return list(spans()) if spans is not None else []


def in_window(win, spans=None) -> list[Placed]:
    """Each closed span that opened and closed inside the window, on the
    trace's clock."""
    spans = recorded() if spans is None else spans
    a, b = win.to_trace(win.t0), win.to_trace(win.t1)
    out = []
    for i, s in enumerate(spans):
        if s.end is None:
            continue
        s0, s1 = win.to_trace(s.start), win.to_trace(s.end)
        if a <= s0 and s1 <= b:
            out.append(Placed(i, s, s0, s1))
    return out


def device_ms(win, name: str, spans=None) -> float | None:
    """The median, over the window's spans called `name`, of the device
    time between the two CUDA events at their edges (ms)."""
    times = [p.span.events[0].elapsed_time(p.span.events[1])
             for p in in_window(win, spans) if p.span.name == name and p.span.events]
    return statistics.median(times) if times else None


def idle_intervals(win) -> tuple[list[tuple[int, int]], int, int]:
    """The window's idle intervals (the complement of the device's busy
    union), and the window's ends, on the trace's clock."""
    merged, a, b = win.busy_intervals()
    edges = [a] + [x for iv in merged for x in iv] + [b]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s], a, b


def self_intervals(placed: list[Placed]) -> dict[int, list[tuple[int, int]]]:
    """For each span, by index, the parts of it no child span covers: where
    it is the innermost span open on its thread."""
    children = defaultdict(list)
    for p in placed:
        if p.span.parent is not None:
            children[p.span.parent].append((p.start, p.end))
    out = {}
    for p in placed:
        parts, at = [], p.start
        for s, e in sorted(children[p.index]):
            if s > at:
                parts.append((at, min(s, p.end)))
            at = max(at, e)
        if at < p.end:
            parts.append((at, p.end))
        out[p.index] = parts
    return out


def overlap(intervals: list[tuple[int, int]], s: int, e: int) -> int:
    """The length of [s, e) that sorted, disjoint `intervals` cover."""
    starts = [iv[0] for iv in intervals]
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0
    while i < len(intervals) and intervals[i][0] < e:
        total += max(0, min(e, intervals[i][1]) - max(s, intervals[i][0]))
        i += 1
    return total


def idle_share(win, name: str, root: str, spans=None) -> float | None:
    """The window's idle time in which `name` is the innermost program span
    open on the thread of the `root` spans, over the window's length
    (percent)."""
    placed = in_window(win, spans)
    threads = {p.span.thread for p in placed if p.span.name == root}
    if not threads:
        return None
    idle, a, b = idle_intervals(win)
    own = self_intervals(placed)
    total = sum(overlap(idle, s, e) for p in placed
                if p.span.name == name and p.span.thread in threads for s, e in own[p.index])
    return 100.0 * total / (b - a) if b > a else None
