"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from the
root of the repository (about a minute on the CPU). They put `portbench/`
and the root on the path, as `portbench/run.py` does."""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
