"""CropAndResize (ROIAlign): TF-style bilinear box crops, PyTorch port.

PyTorch counterpart of sdn3d_tpu/ops/roi_align.py (the reference's
geometric/maskrcnn/roialign/roi_align/src/crop_and_resize_kernel.cu:10-83):
boxes in normalised (y1, x1, y2, x2), corner-aligned sampling
(in_y = y1 * (H - 1) + i * step), bilinear interpolation, zero
extrapolation outside the image.  Images are channels-last ([B, H, W, C],
the JAX package's layout), so each of the four corner gathers reads whole
channel rows.

The gather form never builds `image[box_indices]` ([N, H, W, C]: ~67 GB at
P2 with 1000 boxes): `crop_and_resize_flat` gathers from one flat
[rows, C] table, where each box names its own first row and (H, W).  That
is how pyramid_roi_align crops every box from its own pyramid level and
frame in one pass, where the JAX package crops every box at every level
and keeps one.  A sample outside the image (or at a NaN position, from a
box that overflowed) reads row 0 and is replaced by the extrapolation
value, as JAX's clamped gather is; no index leaves the table.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _positions(lo: torch.Tensor, hi: torch.Tensor, size_m1: torch.Tensor,
               n: int) -> torch.Tensor:
    """Sample positions [N, n] along one axis (crop_and_resize_kernel.cu:
    28-44); size_m1 [N] is the axis length less one.

    The operations are those the JAX package's compiled program runs: the
    step as (hi - lo) * ((size - 1) * f32(1 / (n - 1))), and
    lo * (size - 1) + step * i as a fused multiply-add (one rounding; here
    in float64, exact before it).  A box clipped to the image's far edge
    puts its last sample at size - 1 up to that rounding, so any other
    order moves it in or out of the image and the sample between the
    feature value and zero."""
    if n > 1:
        step = (hi - lo) * (size_m1 * (1.0 / (n - 1)))
        i = torch.arange(n, dtype=torch.float64, device=lo.device)
        return ((lo * size_m1).double()[:, None]
                + step.double()[:, None] * i[None]).float()
    return (0.5 * (lo + hi) * size_m1)[:, None].expand(-1, n)


def crop_and_resize_flat(table: torch.Tensor, offsets: torch.Tensor,
                         heights: torch.Tensor, widths: torch.Tensor,
                         boxes: torch.Tensor, crop_size: Tuple[int, int],
                         extrapolation_value: float = 0.0) -> torch.Tensor:
    """Crops [N, ch, cw, C] from `table` [rows, C]: box n reads the
    row-major [heights[n], widths[n], C] image that starts at row
    offsets[n] (all three int tensors [N])."""
    ch, cw = crop_size
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    hm = (heights - 1).float()
    wm = (widths - 1).float()
    in_y = _positions(y1, y2, hm, ch)                      # [N, ch]
    in_x = _positions(x1, x2, wm, cw)                      # [N, cw]
    valid_y = (in_y >= 0) & (in_y <= hm[:, None])
    valid_x = (in_x >= 0) & (in_x <= wm[:, None])

    y0 = torch.minimum(torch.floor(in_y).clamp(min=0), hm[:, None])
    x0 = torch.minimum(torch.floor(in_x).clamp(min=0), wm[:, None])
    y_lerp = in_y - y0
    x_lerp = in_x - x0
    y0i = torch.where(valid_y, y0, 0.0).long()
    x0i = torch.where(valid_x, x0, 0.0).long()
    y1i = torch.minimum(y0i + 1, hm.long()[:, None])
    x1i = torch.minimum(x0i + 1, wm.long()[:, None])

    w_row = widths.long()[:, None]
    base = offsets.long()[:, None, None]                   # [N, 1, 1]

    def gather(yy, xx):
        return table[base + (yy * w_row)[:, :, None] + xx[:, None, :]]

    tl = gather(y0i, x0i)                                  # [N, ch, cw, C]
    tr = gather(y0i, x1i)
    bl = gather(y1i, x0i)
    br = gather(y1i, x1i)

    top = tl + (tr - tl) * x_lerp[:, None, :, None]
    bot = bl + (br - bl) * x_lerp[:, None, :, None]
    out = top + (bot - top) * y_lerp[:, :, None, None]

    valid = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    return torch.where(valid, out, extrapolation_value)


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    box_indices: torch.Tensor, crop_size: Tuple[int, int],
                    extrapolation_value: float = 0.0) -> torch.Tensor:
    """image [B, H, W, C], boxes [N, 4] normalised (y1, x1, y2, x2),
    box_indices [N] (the image of each box) -> crops [N, ch, cw, C]."""
    B, H, W, C = image.shape
    n = boxes.shape[0]
    size = torch.full((n,), 1, dtype=torch.long, device=boxes.device)
    return crop_and_resize_flat(image.reshape(B * H * W, C),
                                box_indices.long() * (H * W), size * H,
                                size * W, boxes, crop_size,
                                extrapolation_value)
