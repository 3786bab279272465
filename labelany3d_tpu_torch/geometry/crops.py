"""Instance crop bookkeeping: square padded crops by inverse-map sampling.

Counterpart of `labelany3d_tpu/geometry/crops.py`: crop geometry, the
bilinear resample, and the inverse maps from crop space back to the image
(`restore_mask_from_crop`, `crop_to_image_coords`). Each output pixel
inverse-maps to a source coordinate and is sampled directly, reproducing the
reference's paste-into-square + cv2 resizes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CropParams(NamedTuple):
    offset_x: torch.Tensor
    offset_y: torch.Tensor
    scale: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    side_len: torch.Tensor


def mask_bounding_rect(mask: torch.Tensor):
    """cv2.boundingRect semantics: (x, y, w, h) int64; zeros when empty."""
    mask = mask.bool()
    h, w = mask.shape[-2], mask.shape[-1]
    cols, rows = mask.any(-2), mask.any(-1)
    col_idx = torch.arange(w, device=mask.device)
    row_idx = torch.arange(h, device=mask.device)
    big = 1 << 30
    x0 = torch.where(cols, col_idx, big).amin(-1)
    x1 = torch.where(cols, col_idx, -big).amax(-1)
    y0 = torch.where(rows, row_idx, big).amin(-1)
    y1 = torch.where(rows, row_idx, -big).amax(-1)
    empty = ~mask.any(dim=(-2, -1))
    zero = torch.zeros_like(x0)
    return (torch.where(empty, zero, x0), torch.where(empty, zero, y0),
            torch.where(empty, zero, x1 - x0 + 1), torch.where(empty, zero, y1 - y0 + 1))


def crop_object_params(mask: torch.Tensor, crop_size: int = 512, ratio: float = 0.7) -> CropParams:
    x, y, w, h = mask_bounding_rect(mask)
    side_len = torch.floor(torch.maximum(w, h).float() / ratio).long().clamp_min(1)
    offset_x = x.float() + (w - side_len).float() / 2.0
    offset_y = y.float() + (h - side_len).float() / 2.0
    scale = torch.tensor(float(crop_size), device=mask.device) / side_len.float()
    return CropParams(offset_x, offset_y, scale, x, y, w, h, side_len)


def _bilinear_gather(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rect) -> torch.Tensor:
    """Bilinear sample of (H, W[, C]) with zero padding; taps outside the
    rect (x, y, w, h) read as zero."""
    h, w = image.shape[0], image.shape[1]
    img = image.float()
    if img.dim() == 2:
        img = img[..., None]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    rx, ry, rw, rh = rect

    def tap(yi, xi):
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                  & (yi >= ry) & (yi < ry + rh) & (xi >= rx) & (xi < rx + rw))
        vals = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], vals, torch.zeros_like(vals))

    out = (tap(y0i, x0i) * (1 - fy) * (1 - fx) + tap(y0i, x0i + 1) * (1 - fy) * fx
           + tap(y0i + 1, x0i) * fy * (1 - fx) + tap(y0i + 1, x0i + 1) * fy * fx)
    return out[..., 0] if image.dim() == 2 else out


def crop_resample(image: torch.Tensor, mask: torch.Tensor, params: CropParams,
                  crop_size: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """(crop_size, crop_size) RGB crop (float) and boolean mask crop."""
    out_idx = torch.arange(crop_size, dtype=torch.float32, device=image.device)
    inv_scale = params.side_len.float() / float(crop_size)
    q = (out_idx + 0.5) * inv_scale - 0.5
    center = params.side_len // 2
    row_start = (center - params.h // 2).float()
    col_start = (center - params.w // 2).float()
    src_y = q[:, None] - row_start + params.y.float()
    src_x = q[None, :] - col_start + params.x.float()
    ys = src_y.expand(crop_size, crop_size)
    xs = src_x.expand(crop_size, crop_size)
    rect = (params.x, params.y, params.w, params.h)
    rgb = _bilinear_gather(image, ys, xs, rect)
    m = _bilinear_gather(mask.float(), ys, xs, rect)
    return rgb, m >= 0.999


def restore_mask_from_crop(resized_mask: torch.Tensor, offset_x: float, offset_y: float,
                           scale: float, out_shape: tuple[int, int]) -> torch.Tensor:
    """Map a (crop, crop) mask back onto the full image; (H, W) bool.

    Every output pixel nearest-samples the crop (cv2 INTER_NEAREST:
    src = floor(dst * src_size / dst_size)) inside the pasted window of side
    int(crop / scale) at the rounded offset. The quotient is nudged by 1e-6
    relative before flooring, as in the JAX package: in float32 it can land a
    hair below its integer value (256 / 2.048 = 124.99999)."""
    crop = resized_mask
    crop_size = crop.shape[-1]
    oh, ow = out_shape
    dev = crop.device
    q = torch.tensor(float(crop_size), dtype=torch.float32) / torch.tensor(
        scale, dtype=torch.float32)
    ocs = max(int(torch.floor(q * (1.0 + 1e-6))), 1)
    x1 = int(torch.round(torch.tensor(offset_x, dtype=torch.float32)))
    y1 = int(torch.round(torch.tensor(offset_y, dtype=torch.float32)))
    u = torch.arange(ow, device=dev)[None, :] - x1
    v = torch.arange(oh, device=dev)[:, None] - y1
    inside = (u >= 0) & (u < ocs) & (v >= 0) & (v < ocs)
    ratio = torch.tensor(float(crop_size), dtype=torch.float32) / float(ocs)
    cu = torch.floor(u.float() * ratio).long().clamp(0, crop_size - 1)
    cv = torch.floor(v.float() * ratio).long().clamp(0, crop_size - 1)
    return inside & crop[cv, cu].bool()


def crop_to_image_coords(pts_crop: torch.Tensor, offset_x, offset_y, scale) -> torch.Tensor:
    """(..., 2) crop-pixel coordinates -> full-image pixels:
    pts / scale + (offset_x, offset_y)."""
    offs = torch.stack(torch.broadcast_tensors(torch.as_tensor(offset_x, dtype=torch.float32),
                                               torch.as_tensor(offset_y, dtype=torch.float32)),
                       dim=-1).to(pts_crop.device)
    return pts_crop / torch.as_tensor(scale, dtype=torch.float32,
                                      device=pts_crop.device)[..., None] + offs
