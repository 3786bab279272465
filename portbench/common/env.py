"""The environment of one run: where caches and scratch files live, what
it may not load, and what it wrote.

Build caches sit at fixed paths inside the checkout (`build/`, which the
port's kernel builder also uses), so only a checkout's first run builds.
Scratch data goes under `TMPDIR` (or the checkout's `build/` without it).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "labelany3d_tpu")
ROOT = Path(__file__).resolve().parents[2]   # the checkout


def setup() -> None:
    """Set the cache directories before torch is imported."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"      # keeps transformers, if loaded, off JAX
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def scratch_dir(name: str, root: Path = ROOT) -> Path:
    """A scratch directory for this run, emptied first."""
    import shutil

    base = Path(os.environ.get("TMPDIR") or (root / "build" / "tmp"))
    path = base / f"portbench-{name}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def forbidden_loaded() -> list[str]:
    """Modules loaded in this process whose top-level name is one of
    `FORBIDDEN`, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def io_counters() -> dict:
    """This process's write counters from /proc (bytes handed to write()
    and bytes sent to storage), or {} where /proc has none."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, v = line.split(":")
                out[k.strip()] = int(v)
    except OSError:
        return {}
    return {k: out[k] for k in ("wchar", "write_bytes") if k in out}


def card_state() -> str:
    """The card's name, clocks, power draw and limit, from nvidia-smi."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
