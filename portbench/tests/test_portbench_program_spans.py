"""`common/program_spans.py` on a fake window (busy intervals and a clock
offset) and synthetic spans: the window filter, the innermost-span rule,
the idle intersection, the median of event times, and the readers'
silence where the program keeps no spans."""

import importlib.util
from pathlib import Path

import pytest

from common import program_spans
from labelany3d_tpu_torch.utils.profiling import Span

HERE = Path(__file__).resolve().parents[1]
OFFSET = 1_000_000   # trace ns = host ns + OFFSET


class FakeWindow:
    """Host window [100, 1100) ns; the device busy on `busy` (trace ns)."""

    def __init__(self, busy):
        self.t0, self.t1 = 100, 1100
        self.busy = busy

    def to_trace(self, host_ns):
        return host_ns + OFFSET

    def busy_intervals(self):
        return [list(iv) for iv in self.busy], self.t0 + OFFSET, self.t1 + OFFSET


class FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def T(ns):
    return ns + OFFSET


def steps(thread=1):
    """Two steps of `train.step` (host ns), each around forward, backward
    and optimizer; the first backward holds a child span; one step's
    spans open before the window; one span on another thread."""
    spans, ev = [], lambda a, b: (FakeEvent(a), FakeEvent(b))

    def add(name, start, end, parent=None, events=None, th=thread):
        spans.append(Span(name, th, start, end, parent, None, events))
        return len(spans) - 1

    early = add("train.step", 0, 90)                            # before the window
    add("train.forward", 10, 40, early, ev(0.0, 99.0))
    for k, at in enumerate((200, 600)):
        top = add("train.step", at, at + 350)
        add("train.forward", at + 10, at + 110, top, ev(0.0, 20.0 + k))
        back = add("train.backward", at + 110, at + 260, top, ev(0.0, 40.0 + 10 * k))
        if k == 0:
            add("autograd.hook", at + 150, at + 200, back)     # a child of the backward
        add("train.optimizer", at + 260, at + 340, top, ev(0.0, 5.0))
    add("train.backward", 300, 900, None, ev(0.0, 1000.0), th=thread + 1)
    add("train.optimizer", 1000, None, None)                   # never closed
    return spans


def test_in_window_keeps_closed_spans_inside_it_on_the_trace_clock():
    placed = program_spans.in_window(FakeWindow([]), steps())
    assert [p.span.name for p in placed][:2] == ["train.step", "train.forward"]
    assert placed[0].start == T(200) and placed[0].end == T(550)
    assert all(p.span.end is not None and p.start >= T(100) for p in placed)
    assert len(placed) == 2 * 4 + 1 + 1


def test_device_ms_is_the_median_over_the_window():
    win = FakeWindow([])
    assert program_spans.device_ms(win, "train.forward", steps()) == pytest.approx(20.5)
    # the other thread's backward (1000 ms) counts: the span, not the thread, is read
    assert program_spans.device_ms(win, "train.backward", steps()) == pytest.approx(50.0)
    assert program_spans.device_ms(win, "train.optimizer", steps()) == pytest.approx(5.0)
    assert program_spans.device_ms(win, "train.nothing", steps()) is None
    spans = [Span("train.forward", 1, 200, 300, None, None, None)]
    assert program_spans.device_ms(win, "train.forward", spans) is None   # no events


def test_self_intervals_leave_out_children():
    placed = program_spans.in_window(FakeWindow([]), steps())
    own = program_spans.self_intervals(placed)
    by = {(p.span.name, p.start): own[p.index] for p in placed}
    assert by[("train.backward", T(310))] == [(T(310), T(350)), (T(400), T(460))]
    assert by[("train.step", T(200))] == [(T(200), T(210)), (T(540), T(550))]
    assert by[("train.forward", T(210))] == [(T(210), T(310))]


def test_overlap_of_sorted_intervals():
    ivs = [(0, 10), (20, 30), (40, 50)]
    assert program_spans.overlap(ivs, 5, 45) == 5 + 10 + 5
    assert program_spans.overlap(ivs, 10, 20) == 0
    assert program_spans.overlap(ivs, 25, 26) == 1
    assert program_spans.overlap([], 0, 100) == 0


def test_idle_share_takes_the_innermost_span_on_the_steps_thread():
    # Idle on [150, 250) (before the first step, its own time, then its
    # forward), [320, 420) (the backward, its child from 350 to 400),
    # [620, 700) (the second forward), [860, 1000) (the second optimizer,
    # the step's own time, then no span).
    busy = [(T(100), T(150)), (T(250), T(320)), (T(420), T(620)), (T(700), T(860)),
            (T(1000), T(1100))]
    win = FakeWindow(busy)
    share = {ph: program_spans.idle_share(win, f"train.{ph}", "train.step", steps())
             for ph in ("forward", "backward", "optimizer", "step")}
    # forward: [210, 250) of step 1 and [620, 700) of step 2; the window is 1000 ns.
    assert share["forward"] == pytest.approx(100 * (40 + 80) / 1000)
    # backward: [320, 350) and [400, 420); [350, 400) is under its child;
    # the other thread's backward over [300, 900) is not the step's thread.
    assert share["backward"] == pytest.approx(100 * (30 + 20) / 1000)
    # optimizer: [860, 940) of step 2.
    assert share["optimizer"] == pytest.approx(100 * 80 / 1000)
    # step's own time: [200, 210) and [940, 950).
    assert share["step"] == pytest.approx(100 * (10 + 10) / 1000)
    idle, a, b = program_spans.idle_intervals(win)
    total = sum(e - s for s, e in idle)
    assert total == 100 + 100 + 80 + 140
    assert sum(share.values()) <= 100 * total / (b - a)


def test_idle_share_without_steps_is_none():
    win = FakeWindow([])
    only_forward = [Span("train.forward", 1, 200, 300, None, None, None)]
    assert program_spans.idle_share(win, "train.forward", "train.step", only_forward) is None
    assert program_spans.idle_share(win, "train.forward", "train.step", []) is None


@pytest.mark.parametrize("name", ["forward.train_device_ms", "backward.train_device_ms",
                                  "optimizer.train_device_ms", "idle.train_forward",
                                  "idle.train_backward", "idle.train_optimizer"])
def test_readers_are_silent_without_program_spans(name, monkeypatch):
    """With no spans recorded (an untraced program, or one without
    `spans()`), each new reader returns None and does not raise."""
    from labelany3d_tpu_torch.utils import profiling

    spec = importlib.util.spec_from_file_location("m", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = type("Ctx", (), {"win": FakeWindow([(T(100), T(1100))])})()
    profiling.clear_spans()
    assert mod.read(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert mod.read(ctx) is None
