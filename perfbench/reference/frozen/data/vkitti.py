# Frozen copy of sdn3d_tpu_torch/data/vkitti.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Virtual KITTI 1.3.1 data layer (host-side numpy), the subset the
chain's geometric stage uses: the camera intrinsics and the ROI crop
transforms (geometric/derender3d/datasets.py:18-137).  The RGB crops go
through data/native.py, the numpy stand-in for the port's host library;
the mask crops go through PIL.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

WORLD_IDS = ["0001", "0002", "0006", "0018", "0020"]
SCENE_IDS = ["15-deg-left", "15-deg-right", "30-deg-left", "30-deg-right",
             "clone", "fog", "morning", "overcast", "rain", "sunset"]
# 14 background/semantic categories (datasets/vkitti_utils.py:8-10).
CATEGORIES = ["Misc", "Building", "Car", "GuardRail", "Pole", "Road", "Sky",
              "Terrain", "TrafficLight", "TrafficSign", "Tree", "Truck",
              "Van", "Vegetation"]
# Train/test frame ranges per world (vkitti_utils.py:50-53).
SPLIT_RANGES = {
    "train": [range(0, 356), range(0, 185), range(69, 270), range(0, 270),
              range(167, 837)],
    "test": [range(356, 447), range(185, 233), range(0, 69),
             range(270, 339), range(0, 167)],
    "all": [range(0, 447), range(0, 233), range(0, 270), range(0, 339),
            range(0, 837)],
}


class Camera:
    """VKITTI intrinsics (derender3d/datasets.py:207-213)."""
    width = 1242
    height = 375
    focal = 725.0
    u0 = 620.5
    v0 = 187.0


def crop_square(image: np.ndarray, roi: Sequence[int],
                fill: float = 0.0) -> np.ndarray:
    """Square crop around roi (y1, x1, y2, x2) with padding
    (datasets.py:51-73).  image [H, W, C]."""
    y1, x1, y2, x2 = [int(v) for v in roi]
    h, w = y2 - y1, x2 - x1
    s = max(h, w)
    dh, dw = (s - h) // 2, (s - w) // 2
    top, left = y1 - dh, x1 - dw
    H, W = image.shape[:2]
    out = np.full((s, s) + image.shape[2:], fill, image.dtype)
    sy1, sx1 = max(0, top), max(0, left)
    sy2, sx2 = min(H, top + s), min(W, left + s)
    if sy2 > sy1 and sx2 > sx1:
        out[sy1 - top:sy2 - top, sx1 - left:sx2 - left] = image[sy1:sy2,
                                                                sx1:sx2]
    return out


def transform_rgb(image_rgb: np.ndarray, roi: Sequence[int],
                  image_size: int = 256,
                  mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                  prescaled: bool = False) -> np.ndarray:
    """Square-crop (fill 0.5), resize and normalize an object crop for the
    derenderer (geometric/scripts/main.py:365-373), through the native
    host library: [image_size, image_size, 3] float32.  `prescaled=True`
    means the caller already converted the frame to float32 in [0, 1]."""
    from perfbench.reference.frozen.data import native
    img = (image_rgb if prescaled
           else np.asarray(image_rgb, np.float32) / 255.0)
    return native.crop_square_resize(img, [int(v) for v in roi], image_size,
                                     fill=0.5, mean=mean, std=std)


def transform_rgb_u8(image_rgb: np.ndarray, roi: Sequence[int],
                     image_size: int = 256,
                     prescaled: bool = False) -> np.ndarray:
    """Square-crop (fill 0.5) + resize an object crop and QUANTIZE to
    uint8; normalization happens on the device
    (pipelines/derender_infer._U8_NORM_TABLE).  `prescaled=True` means the
    caller already converted the frame to float32 in [0, 1]."""
    crop = transform_rgb(image_rgb, roi, image_size, mean=(0.0, 0.0, 0.0),
                         std=(1.0, 1.0, 1.0), prescaled=prescaled)
    return np.clip(np.rint(crop * 255.0), 0, 255).astype(np.uint8)


def transform_mask(mask: np.ndarray, roi: Sequence[int],
                   render_size: int = 384) -> np.ndarray:
    """Square-crop + resize a binary mask to the render frame."""
    crop = crop_square(np.asarray(mask, np.float32), roi, fill=0.0)
    crop = resize_bilinear_np(crop, render_size)
    return crop.astype(np.float32)


def roi_norms_from_rois(rois: np.ndarray) -> np.ndarray:
    """Pixel rois (y1, x1, y2, x2) -> camera-normalized
    (geometric/scripts/main.py:375-382)."""
    offs = np.asarray([Camera.v0, Camera.u0, Camera.v0, Camera.u0],
                      np.float32)
    return (rois.astype(np.float32) - offs) / Camera.focal
