"""Minimum-area yaw search for oriented box fitting (K4).

Counterpart of `labelany3d_tpu/ops/boxfit_pallas.py::yaw_minarea_pallas`:
per instance of (I, N, 2) ground-plane points with an (I, N) mask, the yaw
among `num_angles` angles on [0, pi/2) whose rotated axis-aligned footprint
has the least area (first minimum on ties). On a CUDA tensor `yaw_minarea`
launches `csrc/yaw_minarea.cu`; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from labelany3d_tpu_torch.ops.attention import LaunchCounter

# Launches of the CUDA kernel, and calls of the plain version.
KERNEL_LAUNCHES = LaunchCounter()
PLAIN_CALLS = LaunchCounter()

_BIG = 3.0e38  # the masked-extent sentinels of the TPU kernel


def footprint_areas(points_xz: torch.Tensor, valid: torch.Tensor,
                    num_angles: int = 512) -> torch.Tensor:
    """(I, N, 2) points, (I, N) mask -> (I, A) masked footprint areas at the
    angles a * (pi/2) / A."""
    step = (math.pi / 2.0) / num_angles
    ang = torch.arange(num_angles, dtype=torch.float32, device=points_xz.device) * step
    c, s = torch.cos(ang), torch.sin(ang)
    pts = points_xz.float()
    x, z = pts[..., 0:1], pts[..., 1:2]          # (I, N, 1)
    u = x * c + z * s                             # (I, N, A)
    w = -x * s + z * c
    vm = valid.bool()[..., None]
    big = torch.full((), _BIG, dtype=torch.float32, device=pts.device)
    return ((torch.where(vm, u, -big).amax(1) - torch.where(vm, u, big).amin(1))
            * (torch.where(vm, w, -big).amax(1) - torch.where(vm, w, big).amin(1)))


def yaw_minarea_reference(points_xz: torch.Tensor, valid: torch.Tensor,
                          num_angles: int = 512) -> torch.Tensor:
    """Plain PyTorch version: (I, N, 2) points, (I, N) mask -> (I,) yaws."""
    PLAIN_CALLS.count += 1
    area = footprint_areas(points_xz, valid, num_angles)
    return area.argmin(-1).float() * ((math.pi / 2.0) / num_angles)


def _lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load("yaw_minarea").yaw_minarea_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def yaw_minarea_kernel(points_xz: torch.Tensor, valid: torch.Tensor,
                       num_angles: int = 512) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if points_xz.device.type != "cuda" or valid.device != points_xz.device:
        raise ValueError(f"yaw kernel needs CUDA tensors on one device, got "
                         f"{points_xz.device} and {valid.device}")
    if points_xz.dim() != 3 or points_xz.shape[-1] != 2 or \
            tuple(valid.shape) != tuple(points_xz.shape[:2]):
        raise ValueError(f"need points (I, N, 2) and valid (I, N), got "
                         f"{tuple(points_xz.shape)} and {tuple(valid.shape)}")
    i, n, _ = points_xz.shape
    if not 1 <= i <= 65535 or not 1 <= n <= 4096 or not 1 <= num_angles <= 1024:
        raise ValueError(f"the kernel takes 1 <= I <= 65535 instances, 1 <= N <= 4096 points "
                         f"and 1 <= A <= 1024 angles, got I={i}, N={n}, A={num_angles}")
    pts = points_xz.float().contiguous()
    vm = valid.to(torch.uint8).contiguous()
    yaw = torch.empty((i,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(pts.data_ptr(), vm.data_ptr(), yaw.data_ptr(), i, n, num_angles, stream)
    if err:
        raise RuntimeError(f"yaw kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.count += 1
    return yaw


def yaw_minarea(points_xz: torch.Tensor, valid: torch.Tensor,
                num_angles: int = 512) -> torch.Tensor:
    """(I, N, 2) points + (I, N) masks -> (I,) min-area yaws. CPU tensors
    take the plain version; CUDA tensors the kernel (or raise)."""
    if points_xz.device.type == "cpu":
        return yaw_minarea_reference(points_xz, valid, num_angles)
    return yaw_minarea_kernel(points_xz, valid, num_angles)
