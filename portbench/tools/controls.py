#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 portbench/tools/controls.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults <fault> ...] [--fault-seeds <n> ...] \
        [--config <name> --traffic <name>] [--out <file.json>]

A cell that `BENCHMARK.json` does not hold is named by its configuration
and traffic files (`--config`, `--traffic`).

For each seed: the program's numbers, as a run of the cell compares them
(sound runs: the lower readings). For each control seed: the control's,
the reference in the precision below the configuration's standing in the
program's place (fp8 operands where the configuration states bf16; TF32
for the float32 labelling program). For each fault and fault seed: the
program with that fault planted (the drivers' `FAULTS`). Runs in one
process on the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from common import env  # noqa: E402


def train_readings(cfg, traffic, args, dev) -> list[dict]:
    from drivers import train

    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        ref = train.reference_readings(cfg, traffic, seed, dev)
        kinds = [(None, None)] + [(f, None) for f in args.faults if seed in args.fault_seeds]
        if seed in args.control_seeds:
            kinds.append((None, "fp8"))
        for fault, control in kinds:
            if control:
                got = train.reference_readings(cfg, traffic, seed, dev, precision=control)
            else:
                prog = train.Program(cfg, traffic, seed, dev, fault)
                got = prog.first_steps()
                prog.free()
                del prog
            rows.append({"seed": seed, "fault": fault, "control": control,
                         "numbers": train.compare(got, ref), "losses": got["losses"],
                         "ref_losses": ref["losses"]})
            print(json.dumps(rows[-1]), flush=True)
            del got
        del ref
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def cell_readings(cell, cfg, traffic, args, dev) -> list[dict]:
    import importlib

    from run import Options

    driver = importlib.import_module(f"drivers.{cfg['driver']}")
    cache: dict = {}
    rows = []
    for seed in args.seeds:
        kinds = [(None, None)] + [(f, None) for f in args.faults if seed in args.fault_seeds]
        if seed in args.control_seeds:
            kinds.append((None, "fp8"))
        for fault, control in kinds:
            t0 = time.perf_counter()
            opts = Options(seed=seed, seconds=args.seconds, trace=False, device=dev,
                           t_start=time.perf_counter(), fault=fault, control=control,
                           cache=cache)
            res = driver.run(cell, cfg, traffic, opts)
            rows.append({"seed": seed, "fault": fault, "control": control,
                         "numbers": {k: v for k, (v, _) in res.checks.items()},
                         "seconds": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def summary(rows: list[dict]) -> dict:
    out = {}
    names = rows[0]["numbers"].keys()
    for k in names:
        sound = [r["numbers"][k] for r in rows if r["fault"] is None and r["control"] is None]
        ctrl = [r["numbers"][k] for r in rows if r["control"]]
        faults = {}
        for r in rows:
            if r["fault"]:
                faults.setdefault(r["fault"], []).append(r["numbers"][k])
        out[k] = {"lower": max(sound), "sound": sound,
                  "control_least": min(ctrl) if ctrl else None, "control": ctrl,
                  "faults_least": {f: min(v) for f, v in faults.items()}}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--out")
    args = p.parse_args()
    env.setup()
    import torch

    from run import load_cell, load_json

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {env.card_state()}", flush=True)
    if args.config:
        cell = {"name": args.workload, "config": args.config, "traffic": args.traffic,
                "chips": 1}
        cfg = load_json(HERE / "configs" / f"{args.config}.json")
        traffic = load_json(HERE / "traffic" / f"{args.traffic}.json")
    else:
        cell, cfg, traffic = load_cell(args.workload, load_json(ROOT / "BENCHMARK.json"))
    dev = torch.device("cuda", 0)
    if cfg["driver"] == "train":
        rows = train_readings(cfg, traffic, args, dev)
    else:
        rows = cell_readings(cell, cfg, traffic, args, dev)
    result = {"workload": args.workload, "card": env.card_state(), "rows": rows,
              "summary": summary(rows)}
    print(json.dumps(result["summary"], indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
