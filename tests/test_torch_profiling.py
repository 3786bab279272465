"""`utils/profiling.py` (`trace`, `annotate`, `GLOBAL_TIMER`) and
`utils/logging.py::reset_warnings` on the CPU.

`trace` must write a Chrome trace under its directory that holds the
`annotate` range and the operators run inside it; the runner's CLI must
time its stages on `GLOBAL_TIMER`; `reset_warnings` must let a warning
print again.
"""

import json

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
