"""Pillow-convention uint8 resize on tensors, byte-exact to Pillow.

PyTorch counterpart of sdn3d_tpu/ops/pil_resize.py.  The textural
branch's conditioning downsizes the geometric branch's full-resolution
instance and normal planes with PIL (`Image.resize` NEAREST / BICUBIC
inside `textural_data.transform_image`, textural/data/base_dataset.py:
40-66).  Done on the device, the serving chain fetches the 192x624
planes instead of the full 375x1242 frame (ops below; the chain's
`small_fetch`).

Pillow resizes 8-bit images with integer fixed-point arithmetic
(libImaging/Resample.c): coefficients rounded to int32 at
PRECISION_BITS = 32 - 8 - 2 = 22 bits, int32 sums seeded with a rounding
half, an arithmetic shift and a clip to [0, 255] after each pass,
horizontal first.  Integer sums do not depend on their order, so the same
operations give Pillow's bytes on any device.  NEAREST is a gather with
Pillow's accumulated source positions.

The sums are int32 (`sum(dtype=torch.int32)`; torch would widen them to
int64 otherwise, with the same bytes).  They cannot overflow: a term is
a byte (<= 255) times a weight, and every partial sum is at most
255 * sum(|k|) with sum(|k|) = 2^22 * sum(|w|) of the normalised filter.
That stays below 2^31 while sum(|w|) < 2^31 / (255 * 2^22) = 2.008;
bicubic's (a = -0.5) is at most 1.27 on a grid of size pairs up to 1300
(tests/test_torch_pil_resize.py checks it), so |sum| < 1.4e9.  There is
no integer product on CUDA: each pass is an `index_select` gather and a
multiply-sum.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2          # Pillow Resample.c 8bpc precision


def _bicubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=None)
def coeffs_u8(in_size: int, out_size: int, method: str = "bicubic"
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs and its 8bpc integer conversion.

    Returns (idx [out, ksize] int32 source indices, ki [out, ksize] int32
    fixed-point weights; weight zero past each output pixel's support,
    where idx repeats an in-bounds index)."""
    filt, support0 = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int32)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            w = filt((x + xmin - center + 0.5) * ss)
            kk[xx, x] = w
            ww += w
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        idx[xx, :xmax] = xmin + np.arange(xmax)
        idx[xx, xmax:] = xmin
    # round half away from zero: Pillow's (int)(+-0.5 + k * 2^P)
    scaled = kk * (1 << PRECISION_BITS)
    ki = np.where(kk < 0, scaled - 0.5, scaled + 0.5).astype(np.int32)
    return idx, ki


@functools.lru_cache(maxsize=None)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Pillow NEAREST source index per output pixel.  ImagingScaleAffine
    accumulates the source position in a double (scale/2, then += scale),
    which flips indices where (x + 0.5) * scale lands on an integer
    (200 -> 178 at output row 133), so it is accumulated here too."""
    scale = in_size / out_size
    xs = np.empty(out_size, np.int64)
    xo = scale * 0.5
    for i in range(out_size):
        xs[i] = int(xo)
        xo += scale
    return np.clip(xs, 0, in_size - 1).astype(np.int32)


# The device tables are kept for the process: a captured CUDA graph
# (pipelines/derender_infer._RenderGraph) reads them on every replay.
@functools.lru_cache(maxsize=None)
def _device_coeffs(in_size: int, out_size: int, method: str,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx, ki = coeffs_u8(in_size, out_size, method)
    return (torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(ki).to(device))


@functools.lru_cache(maxsize=None)
def _device_nearest(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        nearest_indices(in_size, out_size).astype(np.int64)).to(device)


def _pass_u8(img32: torch.Tensor, in_size: int, out_size: int, method: str,
             axis: int) -> torch.Tensor:
    """One fixed-point pass along `axis` of an int32 tensor; returns int32
    values already clipped to [0, 255]."""
    idx, ki = _device_coeffs(in_size, out_size, method, img32.device)
    x = img32.movedim(axis, 0)                     # [in_size, ...rest]
    ksize = ki.shape[1]
    g = x.index_select(0, idx).reshape((out_size, ksize) + x.shape[1:])
    w = ki.reshape((out_size, ksize) + (1,) * (x.dim() - 1))
    ss = (g * w).sum(dim=1, dtype=torch.int32) + (1 << (PRECISION_BITS - 1))
    v = torch.clamp(ss >> PRECISION_BITS, 0, 255)
    return v.movedim(0, axis)


def resize_u8(img: torch.Tensor, out_w: int, out_h: int,
              method: str = "bicubic") -> torch.Tensor:
    """Pillow-exact uint8 convolution resize of [H, W, C] (or [H, W]) to
    [out_h, out_w, ...]: `Image.fromarray(img).resize((out_w, out_h),
    BICUBIC)` byte for byte (horizontal pass, then vertical, the
    intermediate clipped to 8 bits as Pillow's uint8 temp image)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[0], img.shape[1]
    x32 = img.to(torch.int32)
    if W != out_w:
        x32 = _pass_u8(x32, W, out_w, method, axis=1)
    if H != out_h:
        x32 = _pass_u8(x32, H, out_h, method, axis=0)
    out = x32.to(torch.uint8)
    return out[..., 0] if squeeze else out


def resize_nearest_u8(img: torch.Tensor, out_w: int,
                      out_h: int) -> torch.Tensor:
    """Pillow-exact NEAREST resize of [H, W, ...] (two gathers)."""
    H, W = img.shape[0], img.shape[1]
    out = img
    if W != out_w:
        out = out.index_select(1, _device_nearest(W, out_w, img.device))
    if H != out_h:
        out = out.index_select(0, _device_nearest(H, out_h, img.device))
    return out


@dataclasses.dataclass(frozen=True)
class TransformPlan:
    """The geometry of textural_data.transform_image for one source
    shape: scale_width (with the 188 -> 192 height rule) then a centre
    crop."""
    resize_w: int
    resize_h: int
    crop_x: int
    crop_y: int
    out_w: int
    out_h: int


def transform_plan(src_wh: Tuple[int, int], load_size: int,
                   fine_wh: Tuple[int, int]) -> Optional[TransformPlan]:
    """transform_image's geometry (scale_width, then centre crop;
    textural/data/base_dataset.py:40-66) for a source size.

    None where the host path's output would not be exactly `fine_wh`
    (a source narrower or shorter than the crop, which PIL zero-pads):
    the caller then takes the full-resolution planes and the host PIL
    path, as the JAX package does."""
    ow, oh = src_wh
    if ow == load_size:
        w, h = ow, oh
    else:
        w = load_size
        h = int(load_size * oh / ow)
        if h == 188:                       # the reference's 188 -> 192 rule
            h = 192
    tw, th = fine_wh
    if w < tw or h < th:
        return None
    cx, cy = max(0, w - tw) // 2, max(0, h - th) // 2
    return TransformPlan(w, h, cx, cy, tw, th)


def apply_plan_u8(img: torch.Tensor, plan: TransformPlan,
                  nearest: bool = False) -> torch.Tensor:
    """transform_image on a uint8 tensor [H, W, ...]: Pillow-exact resize
    to (resize_w, resize_h), then the centre crop.  Returns uint8
    [out_h, out_w, ...]."""
    if nearest:
        out = resize_nearest_u8(img, plan.resize_w, plan.resize_h)
    else:
        out = resize_u8(img, plan.resize_w, plan.resize_h, "bicubic")
    return out[plan.crop_y:plan.crop_y + plan.out_h,
               plan.crop_x:plan.crop_x + plan.out_w]
