#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (`labelany3d_tpu_torch`), one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is a `workloads` entry of
`BENCHMARK.json`; its configuration (`portbench/configs/<config>.json`)
names the driver (`portbench/drivers/<driver>.py`) that builds and times
it, and its traffic (`portbench/traffic/<traffic>.json`) the generator
(`portbench/gen/<generator>.py`) that makes its inputs from the seed.
With `--trace 0` the result holds the cell's end-to-end metrics; with
`--trace 1` the window is traced and the result holds its per-layer
metrics, each read by `portbench/metrics/<metric>.py`.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and `checks` last: every compared number beside its limit).
The same numbers are the last lines of standard error. The run exits
non-zero, with no result, without enough CUDA devices, without the port
beside it, or when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from common import env  # noqa: E402


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    fault: str | None = None      # a planted fault (tests and tools/controls.py only)
    control: str | None = None    # judge the reference in this precision instead (tools only)
    cache: dict | None = None     # models kept across runs in one process (tools only)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict) -> tuple[dict, dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metric(name: str, ctx) -> float | None:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict, opts: Options) -> tuple:
    """Run one cell: (result line, earlier lines for stdout, check lines)."""
    import torch

    driver = importlib.import_module(f"drivers.{cfg['driver']}")
    res = driver.run(cell, cfg, traffic, opts)
    dev = opts.device
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(res.memory_peak_bytes)}
    if opts.trace:
        win = res.window
        ctx = SimpleCtx(win=win, cfg=cfg, traffic=traffic, cell=cell, counts=res.counts)
        values = {}
        for m in cell_metrics(bench, cell, "per_layer"):
            v = read_metric(m["name"], ctx) if win.trace else None
            if v is not None:
                values[m["name"]] = {"value": v, "unit": units[m["name"]]}
        line["metrics"] = values
        if win.trace:
            device["busy_s"] = win.busy_s()
            device["window_s"] = win.seconds
    else:
        line["metrics"] = {m["name"]: {"value": res.metrics[m["name"]], "unit": m["unit"]}
                           for m in cell_metrics(bench, cell, "end_to_end")}
    line["device"] = device
    if opts.trace and res.window.trace:
        line["breakdown"] = res.window.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res.checks.items()}
    earlier = list(res.notes)
    earlier.append(f"writes: {json.dumps(env.io_counters())}")
    earlier.append(f"memory_peak_bytes: {res.memory_peak_bytes}")
    checks = [f"check {k} = {v!r} (limit {lim!r})" for k, (v, lim) in res.checks.items()]
    checks.append(f"correct = {res.correct}")
    return line, earlier, checks


@dataclasses.dataclass
class SimpleCtx:
    """What a per-layer metric's reader is given."""
    win: object
    cfg: dict
    traffic: dict
    cell: dict
    counts: dict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    env.setup()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = load_cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    print(f"card: {env.card_state()}", flush=True)
    opts = Options(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=torch.device("cuda", 0), t_start=T_START)
    line, earlier, check_lines = run_cell(bench, cell, cfg, traffic, opts)
    found = env.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {env.card_state()}")
    for s in earlier:
        print(s)
    for s in check_lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
