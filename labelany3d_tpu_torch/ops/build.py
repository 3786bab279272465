"""Build and load the CUDA kernels of `csrc/` (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into `build/kernels/` at the root of the checkout. The file name carries a
hash of the source and of every shared header `csrc/*.cuh`, so an edited
kernel or header is rebuilt and a stale library is never loaded. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    """`build/kernels/lib<name>-<hash>.so`, the hash over `csrc/<name>.cu`
    and every `csrc/*.cuh` (names and contents)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, verbose: bool = False) -> str:
    """Compile `csrc/<name>.cu` unless its library is already built; returns
    nvcc's output ("" when nothing was built). `verbose` adds `-Xptxas -v`
    (registers, shared memory, spills)."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every `csrc/*.cu` at once, one nvcc process per source;
    returns {name: nvcc output}."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        logs = list(pool.map(lambda n: build(n, verbose), names))
    return dict(zip(names, logs))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a shared library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
