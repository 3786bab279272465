"""The measured window, traced or not.

`Window` times whole units of work on the host clock. With `trace`, the
window runs under `torch.profiler` with CUDA activity alone (no host op is
recorded), and after it closes the device's events are read back: every
kernel, copy and set by name, start and duration. Host spans, which the
harness records around the calls it makes into the program (`span`), are
placed on the trace's clock by a marker kernel launched at a known host
time. A driver may also bracket a layer's launches with marker kernels
(`mark`): the kernels between a pair are that layer's.

From the events: `busy_s`, the union of the device's busy intervals
inside the window; the kernel time by name; and the idle gaps, each named
by the innermost host span that was open at its middle.
"""

from __future__ import annotations

import contextlib
import time

import torch

MARKER = "spin_kernel"   # the kernel of torch.cuda._sleep
_MARK_CYCLES = 64


class Window:
    def __init__(self, trace: bool, device: torch.device):
        self.trace = trace and device.type == "cuda"
        self.device = device
        self.spans: list[tuple[str, int, int]] = []   # (name, start, end), host ns
        self.marks: list[int] = []                    # host ns of each `mark`
        self.t0 = self.t1 = 0
        self._prof = None
        self._calib_host = 0
        self.events: list[tuple[str, int, int, bool]] = []  # (name, start, end, kernel)

    def __enter__(self) -> "Window":
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            torch.cuda.synchronize(self.device)
            self._calib_host = time.perf_counter_ns()
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter_ns()
        return self

    def close(self) -> None:
        """End the window at the end of the last unit: wait for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        if not self.t1:
            self.close()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._read_events()
            self._prof = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def elapsed(self) -> float:
        return (time.perf_counter_ns() - self.t0) / 1e9

    @contextlib.contextmanager
    def span(self, name: str):
        a = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.perf_counter_ns()))

    def mark(self) -> None:
        """A marker kernel in stream order (traced runs only)."""
        if self.trace:
            torch.cuda._sleep(_MARK_CYCLES)

    # -- reading the trace ---------------------------------------------------

    def _read_events(self) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            start = e.start_ns()
            raw.append((e.name(), start, start + e.duration_ns(),
                        "memcpy" not in e.name().lower() and "memset" not in e.name().lower()))
        raw.sort(key=lambda r: r[1])
        markers = [r for r in raw if MARKER in r[0]]
        if not markers:
            raise RuntimeError("the trace holds no marker kernel: the profiler saw no device "
                               "activity")
        self._offset = markers[0][1] - self._calib_host
        self._marker_starts = [r[1] for r in markers[1:]]
        self.events = [r for r in raw if MARKER not in r[0]]

    def to_trace(self, host_ns: int) -> int:
        return host_ns + self._offset

    def window_events(self):
        a, b = self.to_trace(self.t0), self.to_trace(self.t1)
        return [e for e in self.events if e[2] > a and e[1] < b], a, b

    def busy_intervals(self):
        evs, a, b = self.window_events()
        merged: list[list[int]] = []
        for _, s, e, _k in evs:
            s, e = max(s, a), min(e, b)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged, a, b

    def busy_s(self) -> float:
        merged, _, _ = self.busy_intervals()
        return sum(e - s for s, e in merged) / 1e9

    def kernel_s(self, include, exclude=()) -> float:
        """Seconds of the window's kernels whose name holds any of
        `include` and none of `exclude`."""
        evs, _, _ = self.window_events()
        return sum(e - s for n, s, e, k in evs
                   if k and any(i in n for i in include) and not any(x in n for x in exclude)
                   ) / 1e9

    def marked_kernel_s(self) -> float:
        """Seconds of the kernels that ran between each pair of `mark`s."""
        starts = self._marker_starts
        pairs = list(zip(starts[0::2], starts[1::2]))
        total = 0
        i = 0
        evs = [e for e in self.events if e[3]]
        for a, b in pairs:
            while i < len(evs) and evs[i][1] < a:
                i += 1
            while i < len(evs) and evs[i][1] < b:
                total += evs[i][2] - evs[i][1]
                i += 1
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        evs, _, _ = self.window_events()
        by_name: dict[str, int] = {}
        for n, s, e, _k in evs:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        merged, a, b = self.busy_intervals()
        gaps = []
        edges = [a] + [x for iv in merged for x in iv] + [b]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps.append((e - s, self._span_at((s + e) // 2)))
        gaps.sort(key=lambda g: -g[0])
        return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[name, ns / 1e9] for ns, name in gaps[:top]]}

    def _span_at(self, trace_ns: int) -> str:
        best = None
        for name, s, e in self.spans:
            s, e = self.to_trace(s), self.to_trace(e)
            if s <= trace_ns < e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "harness"
