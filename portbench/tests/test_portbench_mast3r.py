"""`train.rope_b8` driven end to end on the CPU at a tiny size (the MASt3R
layout of `MatcherConfig.tiny_catmlpdpt_test`, 64 px views, 2 pairs a
step), with the look for a card skipped: a sound run comes out correct;
each fault the cell can have, planted in the timed path, comes out not
correct; the control (the reference with fp8 operands) fails a number.
The driver and its references load no JAX.

The tiny model computes in bf16 on the CPU; the limits here are set for
that size from its own readings (about 1e-3, 5e-2 and 3e-2; the cell's
own limits, in its configuration file, were set at its size on the card)."""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

import run
from test_portbench_imports import FORBIDDEN, loaded

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def cell():
    bench = run.load_json(HERE.parent / "BENCHMARK.json")
    cell, cfg, traffic = run.load_cell("train.rope_b8", bench)
    cfg.update(matcher="tiny_catmlpdpt_test", image_size=64, batch_pairs=2, matches=32,
               reference_micro_batch=1,
               limits={"loss_gap": 5e-3, "grad_gap": 0.2, "change_gap": 0.12})
    traffic["pool"] = 6
    return bench, cell, cfg, traffic


def _run(bench, cell, cfg, traffic, fault=None):
    opts = run.Options(seed=SEED, seconds=0.5, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), fault=fault)
    line, earlier, _ = run.run_cell(bench, cell, cfg, traffic, opts)
    json.dumps(line)
    assert list(line)[-1] == "checks"
    return line, earlier


def test_sound_run_is_correct(cell):
    line, earlier = _run(*cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_images_per_s", "train_step_p90_ms"}
    assert any(s.startswith("K2 launches a warm step:") for s in earlier)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "leaf_dropped"])
def test_fault_is_not_correct(cell, fault):
    line, _ = _run(*cell, fault=fault)
    assert not line["correct"], line["checks"]


def test_control_fails_a_number(cell):
    from drivers import train_pairs

    _, _, cfg, traffic = cell
    ref = train_pairs.reference_readings(cfg, traffic, SEED, torch.device("cpu"))
    ctrl = train_pairs.reference_readings(cfg, traffic, SEED, torch.device("cpu"),
                                          precision="fp8")
    numbers = train_pairs.compare(ctrl, ref)
    assert any(numbers[k] > lim for k, lim in cfg["limits"].items()), numbers


@pytest.mark.parametrize("modules", [
    ["drivers.train_pairs", "gen.view_pairs", "reference.matcher", "reference.train_pairs"],
])
def test_driver_loads_no_jax(modules):
    assert not loaded(modules) & FORBIDDEN


@pytest.mark.parametrize("name", ["forward.mast3r_device_ms", "backward.mast3r_device_ms",
                                  "optimizer.mast3r_device_ms", "encoder.mast3r_device_ms",
                                  "decoder.mast3r_device_ms", "heads.mast3r_device_ms"])
def test_span_readers_are_silent_without_program_spans(name, monkeypatch):
    """With no spans recorded (an untraced program, or one without
    `spans()`), each span reader returns None and does not raise."""
    from labelany3d_tpu_torch.utils import profiling
    from test_portbench_program_spans import FakeWindow, T

    spec = importlib.util.spec_from_file_location("m", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = type("Ctx", (), {"win": FakeWindow([(T(100), T(1100))])})()
    profiling.clear_spans()
    assert mod.read(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert mod.read(ctx) is None
