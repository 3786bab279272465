"""Minimal `.safetensors` reader and writer on the standard library, numpy
and torch, so the port needs no `safetensors` package (the card's machine
lists none).

The format: an unsigned little-endian 64-bit header length N, N bytes of
JSON (`{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}` with
an optional `"__metadata__"` map of strings), then the tensors' raw
little-endian bytes, each at its offsets from the end of the header. The
writer lays tensors out back to back in the order given and pads the
header with spaces to a multiple of 8 bytes, as the reference
implementation does. Dtypes: F32, F16, BF16 (written and read through
a 16-bit integer view), I64, I32 and BOOL. The host is little-endian (x86-64
and aarch64 are), so the bytes go to and from memory as they are.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64, "I32": torch.int32, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
# numpy has no bfloat16: BF16 bytes travel as int16.
_RAW = {torch.float32: np.float32, torch.float16: np.float16, torch.bfloat16: np.int16,
        torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value, order="C")
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a flat uint8 array (a view where it is
    contiguous)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def save_file(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """Write {name: torch.Tensor or numpy array} to `path`."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    items = []
    offset = 0
    for name, value in tensors.items():
        t = _as_tensor(value)
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(_DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in items:
            f.write(memoryview(_raw_bytes(t)).cast("B"))


def read_header(path: str) -> tuple[dict, int]:
    """(header without `__metadata__`, byte offset of the data section)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Read every tensor of `path` into CPU torch tensors of its dtype, in
    the file's order of offsets."""
    header, start = read_header(path)
    out = {}
    with open(path, "rb") as f:
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{name}: dtype {info['dtype']} is not one of {sorted(_DTYPES)}")
            dtype = _DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(int(d) for d in info["shape"])
            raw = np.dtype(_RAW[dtype])
            n = int(np.prod(shape, dtype=np.int64))
            if end - begin != n * raw.itemsize:
                raise ValueError(f"{name}: data_offsets {info['data_offsets']} do not hold "
                                 f"{n} x {info['dtype']} in {path}")
            f.seek(start + begin)
            arr = np.fromfile(f, raw, count=n)
            if arr.size != n:
                raise ValueError(f"{name}: {path} ends inside the tensor")
            t = torch.from_numpy(arr.reshape(shape))
            out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out
