"""Stand-in for sdn3d_tpu_torch/data/native in numpy, never the C
library: its crop and resize written out in numpy with the host
library's filter taps and order of sums (native/sdn3d_host.cpp), so that
a crop equals the port's to the bit."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _taps(in_size: int, out_size: int):
    """PIL's triangle filter taps for a resize of in_size to out_size:
    (first source index [out], weights [out, taps] float32), computed in
    float64 and normalised in float32, as the host library builds them."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    max_taps = int(math.ceil(support)) * 2 + 1
    lo_all = np.zeros(out_size, np.int64)
    w = np.zeros((out_size, max_taps), np.float32)
    for x in range(out_size):
        center = (x + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        total = 0.0
        for i in range(lo, hi):
            d = (i + 0.5 - center) / fscale
            weight = 0.0 if (d < -1.0 or d > 1.0) else 1.0 - abs(d)
            w[x, i - lo] = np.float32(weight)
            total += weight
        if total > 0:
            w[x, :hi - lo] /= np.float32(total)
        lo_all[x] = lo
    return lo_all, w


def _resize(src: np.ndarray, size: int) -> np.ndarray:
    """Separable resize of src [h, w, c] float32 to [size, size, c]: the
    horizontal pass, then the vertical, each summing its taps in order in
    float32, as the host library does."""
    sh, sw, c = src.shape
    lo, w = _taps(sw, size)
    tmp = np.zeros((sh, size, c), np.float32)
    for i in range(w.shape[1]):
        idx = np.minimum(lo + i, sw - 1)
        tmp += w[None, :, i, None] * src[:, idx, :]
    lo, w = _taps(sh, size)
    dst = np.zeros((size, size, c), np.float32)
    for i in range(w.shape[1]):
        idx = np.minimum(lo + i, sh - 1)
        dst += w[:, i, None, None] * tmp[idx, :, :]
    return dst


def crop_square_resize(img: np.ndarray, roi: Sequence[int], size: int,
                       fill: float = 0.5, mean=(0.5, 0.5, 0.5),
                       std=(0.25, 0.25, 0.25)) -> np.ndarray:
    """img [H, W, C] float32 in [0, 1]; roi (y1, x1, y2, x2) ints: the
    square crop (padded with `fill`), resized to [size, size, C] with
    PIL's bilinear (triangle) filter, summed in the host library's order,
    and normalised ((v - mean) / std)."""
    from perfbench.reference.frozen.data.vkitti import crop_square
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    crop = crop_square(np.ascontiguousarray(img, np.float32),
                       np.asarray(roi, np.int32), fill=np.float32(fill))
    return ((_resize(crop, size) - mean) / std).astype(np.float32)
