"""Native (C++) host code, built on demand and loaded with ctypes.

Counterpart of `labelany3d_tpu/native`, with its own copy of `rle.cpp` (the
COCO RLE codec's four hot loops, the pycocotools-C role). `load_rle()`
compiles it at first use with

    g++ -O3 -shared -fPIC -o build/native/librle-<hash>.so rle.cpp

into `build/native/` at the root of the checkout (the hash is over the
source, so an edited file is rebuilt), and returns its ctypes bindings, or
None when there is no host compiler or the build fails: callers then take
the numpy codec, as the JAX package's do. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "rle.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL | None] = {}


def library_path() -> Path:
    """`BUILD_DIR/librle-<hash>.so` (`BUILD_DIR` read at call time)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return Path(BUILD_DIR) / f"librle-{digest}.so"


def build() -> Path:
    """Compile `rle.cpp` unless its library is already built; raises when
    there is no host compiler or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, p_i64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.rle_from_string.restype = i64
    lib.rle_from_string.argtypes = [ctypes.c_char_p, i64, p_i64, i64]
    lib.rle_to_string.restype = i64
    lib.rle_to_string.argtypes = [p_i64, i64, ctypes.c_char_p, i64]
    lib.rle_to_mask.restype = None
    lib.rle_to_mask.argtypes = [p_i64, i64, i64, i64, p_u8]
    lib.mask_to_rle.restype = i64
    lib.mask_to_rle.argtypes = [p_u8, i64, i64, p_i64, i64]
    return lib


def load_rle() -> ctypes.CDLL | None:
    """ctypes handle to the RLE codec, or None when it cannot be built. Each
    library is built and loaded once per process."""
    path = library_path()
    with _lock:
        if path not in _loaded:
            try:
                _loaded[path] = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _loaded[path] = None
        return _loaded[path]
