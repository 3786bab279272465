"""Each cell driven end to end on the CPU at a tiny size, with the look for
a card skipped: a sound run comes out correct; the timed path broken
underneath (each fault the cell can have), or the control standing in
the program's place, comes out not correct.

The tiny models compute in bf16 on the CPU; the limits here are set for
that size from its own readings (the cells' own limits, in their
configuration files, were set at the cells' sizes on the card)."""

import json
import time
from pathlib import Path

import pytest
import torch

import run

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 4242


def _tiny(name: str):
    bench = run.load_json(HERE.parent / "BENCHMARK.json")
    cell, cfg, traffic = run.load_cell(name, bench)
    return bench, cell, cfg, traffic


def _label():
    """`label.coco`, which `BENCHMARK.json` does not hold (PERF.md, Open
    questions): its configuration, traffic and metric as they stand."""
    cell = {"name": "label.coco", "config": "label-moge_vitl-depthpro35", "traffic": "coco",
            "chips": 1}
    bench = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "label_images_per_s", "unit": "images/s",
                             "workloads": ["label.coco"]}],
             "per_layer": []}
    cfg = run.load_json(HERE / "configs" / "label-moge_vitl-depthpro35.json")
    traffic = run.load_json(HERE / "traffic" / "coco.json")
    return bench, cell, cfg, traffic


def _run(bench, cell, cfg, traffic, fault=None, control=None, seconds=0.5):
    opts = run.Options(seed=SEED, seconds=seconds, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), fault=fault, control=control)
    line, _, checks = run.run_cell(bench, cell, cfg, traffic, opts)
    json.dumps(line)
    assert list(line)[-1] == "checks"
    return line


@pytest.fixture(scope="module")
def train_cell():
    bench, cell, cfg, traffic = _tiny("train.b16")
    cfg.update(moge="tiny_reference_test", image_size=64, batch_size=4,
               reference_micro_batch=2,
               # tiny bf16 on the CPU reads about 1e-4, 1e-2, 2e-2
               limits={"loss_gap": 2e-3, "grad_gap": 0.05, "change_gap": 0.1})
    traffic["pool"] = 12
    return bench, cell, cfg, traffic


@pytest.fixture(scope="module")
def label_cell(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("TMPDIR", str(tmp_path_factory.mktemp("label")))
    bench, cell, cfg, traffic = _label()
    cfg.update(moge="tiny_reference_test", depth_pro="tiny_test", bucket=[256, 256],
               batch_size=4, check_rows=2,
               # tiny bf16 on the CPU reads about 2e-3, 5e-4, 8e-3, then exactly 0
               limits={"points_rel": 0.02, "mask_rel": 0.01, "canonical_rel": 0.05,
                       "assembly_rel": 0.0, "aligned_rel": 0.0, "k_rel": 0.0, "box_gap": 0.0})
    traffic.update(images=16, shard=8)
    return bench, cell, cfg, traffic


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_sound_run_is_correct(train_cell):
    line = _run(*train_cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_images_per_s", "train_step_p90_ms"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "leaf_dropped"])
def test_train_fault_is_not_correct(train_cell, fault):
    line = _run(*train_cell, fault=fault)
    assert not line["correct"], line["checks"]


def test_train_control_fails_a_number(train_cell):
    from drivers import train

    _, _, cfg, traffic = train_cell
    ref = train.reference_readings(cfg, traffic, SEED, torch.device("cpu"))
    ctrl = train.reference_readings(cfg, traffic, SEED, torch.device("cpu"), precision="fp8")
    numbers = train.compare(ctrl, ref)
    assert any(numbers[k] > lim for k, lim in cfg["limits"].items()), numbers


def test_label_sound_run_is_correct(label_cell):
    line = _run(*label_cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "label_images_per_s"}


@pytest.mark.parametrize("fault", ["rows_dropped", "box_altered"])
def test_label_fault_is_not_correct(label_cell, fault):
    line = _run(*label_cell, fault=fault)
    assert not line["correct"], line["checks"]


def test_label_control_is_not_correct(label_cell):
    line = _run(*label_cell, control="fp8")
    assert not line["correct"], line["checks"]
