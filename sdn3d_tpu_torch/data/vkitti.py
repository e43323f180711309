"""Virtual KITTI 1.3.1 data layer (host-side numpy), the subset the
geometric serving path uses.

Counterpart of sdn3d_tpu/data/vkitti.py: the camera intrinsics, the ROI
crop transforms (geometric/derender3d/datasets.py:18-137) and the
edit-benchmark JSON protocol.  Crops go through numpy + PIL (the JAX
package may route them through its native host library, whose float
crops match this path to 1e-5).  Dataset iteration (scenegt decoding,
GT objects) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence

import numpy as np


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


def resize_bilinear_np(image: np.ndarray, size: int) -> np.ndarray:
    """PIL-style bilinear resize to (size, size)."""
    from PIL import Image
    if image.ndim == 2:
        pil = Image.fromarray(image)
        return np.asarray(pil.resize((size, size), Image.BILINEAR))
    chans = [np.asarray(Image.fromarray(image[..., c]).resize(
        (size, size), Image.BILINEAR)) for c in range(image.shape[2])]
    return np.stack(chans, axis=-1)


def transform_rgb_u8(image_rgb: np.ndarray, roi: Sequence[int],
                     image_size: int = 256,
                     prescaled: bool = False) -> np.ndarray:
    """Square-crop (fill 0.5) + resize an object crop and QUANTIZE to
    uint8; normalization happens on the device
    (pipelines/derender_infer._U8_NORM_TABLE).  `prescaled=True` means the
    caller already converted the frame to float32 in [0, 1]."""
    img = (image_rgb if prescaled
           else np.asarray(image_rgb, np.float32) / 255.0)
    crop = crop_square(np.ascontiguousarray(img, np.float32),
                       [int(v) for v in roi], fill=0.5)
    crop = resize_bilinear_np(crop, image_size).astype(np.float32)
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


@dataclasses.dataclass
class EditItem:
    world: str
    topic: str
    source: str
    target: str
    operations: List[dict]

    @property
    def source_name(self) -> str:
        return f"{self.world}_{self.topic}_{self.source}"

    @property
    def target_name(self) -> str:
        return f"{self.world}_{self.topic}_{self.source}_{self.target}"


def load_edit_json(path: str) -> List[EditItem]:
    with open(path) as f:
        raw = json.load(f)
    return [EditItem(d["world"], d["topic"], d["source"], d["target"],
                     d.get("operations", [])) for d in raw]
