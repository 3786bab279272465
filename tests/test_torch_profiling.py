"""`utils/profiling.py` (`trace`, `annotate`, `GLOBAL_TIMER`) and
`utils/logging.py::reset_warnings` on the CPU.

`trace` must write a Chrome trace under its directory that holds the
`annotate` range and the operators run inside it; `annotate` must keep
spans (name, thread, parent, unit) while a profiler runs and nothing
without one, and `trace` must start from an empty list; the runner's CLI
must time its stages on `GLOBAL_TIMER`; `reset_warnings` must let a
warning print again.
"""

import json
import threading

import torch

from labelany3d_tpu_torch.utils import logging as plog
from labelany3d_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("port_range"):
            y = x @ x
    assert y.shape == (64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and str(files[0]) == prof.trace_path
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "port_range" in names
    assert any(n and "mm" in n for n in names)
    assert any(e.key == "port_range" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("alone"):
        assert torch.ones(2).sum() == 2


def test_annotate_records_nothing_without_a_profiler():
    profiling.clear_spans()
    with profiling.annotate("outer", unit=3):
        with profiling.annotate("inner"):
            pass
    assert profiling.spans() == []


def test_trace_records_nested_spans_with_thread_parent_and_unit(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("outer", unit=7):
            with profiling.annotate("inner"):
                torch.ones(4).sum()
            with profiling.annotate("other", unit="x"):
                pass
        with profiling.annotate("beside"):
            pass
    spans = profiling.spans()
    assert [s.name for s in spans] == ["outer", "inner", "other", "beside"]
    outer, inner, named, beside = spans
    me = threading.get_ident()
    assert all(s.thread == me for s in spans)
    assert outer.parent is None and beside.parent is None
    assert inner.parent == 0 and named.parent == 0
    assert (outer.unit, inner.unit, named.unit, beside.unit) == (7, 7, "x", None)
    for s in spans:
        assert s.end is not None and s.start <= s.end
        assert s.events is None  # no CUDA here
    assert outer.start <= inner.start <= inner.end <= named.start <= named.end <= outer.end


def test_spans_on_another_thread_have_their_own_parents(tmp_path):
    def work():
        with profiling.annotate("worker", unit=1):
            with profiling.annotate("worker.inner"):
                pass

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: (i, s) for i, s in enumerate(profiling.spans())}
    assert set(by) == {"main", "worker", "worker.inner"}
    assert by["worker"][1].parent is None and by["worker"][1].thread != by["main"][1].thread
    assert by["worker.inner"][1].parent == by["worker"][0]
    assert by["worker.inner"][1].unit == 1


def test_trace_clears_the_spans(tmp_path):
    with profiling.trace(str(tmp_path / "a")):
        with profiling.annotate("first"):
            pass
    assert [s.name for s in profiling.spans()] == ["first"]
    kept = profiling.spans()
    with profiling.trace(str(tmp_path / "b")):
        with profiling.annotate("second"):
            pass
    assert [s.name for s in profiling.spans()] == ["second"]
    assert [s.name for s in kept] == ["first"]
    profiling.clear_spans()
    assert profiling.spans() == []


def test_global_timer_is_the_runners(monkeypatch, tmp_path, capsys):
    from labelany3d_tpu_torch.pipeline import runner
    from tests.test_torch_ckpt_dir import _coco_root

    seen = {}

    def fake_run_stages(stage, *args, timer=None, **kw):
        seen["timer"] = timer
        with timer.measure("depth", items=1):
            pass

    monkeypatch.setattr(runner, "run_stages", fake_run_stages)
    assert isinstance(profiling.GLOBAL_TIMER, profiling.StageTimer)
    calls = profiling.GLOBAL_TIMER.stats["depth"].calls
    root = _coco_root(tmp_path)
    assert runner.main(["depth", "--dataset_root", str(root), "--save_dir",
                        str(tmp_path / "out"), "models.tiny=true"], device="cpu") == 0
    assert seen["timer"] is profiling.GLOBAL_TIMER
    assert profiling.GLOBAL_TIMER.stats["depth"].calls == calls + 1
    assert "depth" in capsys.readouterr().out


def test_reset_warnings_lets_a_warning_print_again(capsys):
    plog.reset_warnings()
    plog.warn_once("k", "first")
    plog.warn_once("k", "first")
    assert capsys.readouterr().err.count("first") == 1
    plog.reset_warnings()
    plog.warn_once("k", "first")
    assert capsys.readouterr().err.count("first") == 1
