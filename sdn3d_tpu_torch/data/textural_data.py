"""Textural-branch data assembly for edit-time inference (host-side numpy).

Copy of the edit-time part of sdn3d_tpu/data/textural_data.py:
textural/data/base_dataset.py (scale-width/crop/flip transforms, the
188->192 hack) and the edit-time assembly of textural/edit_vkitti.py:
41-107.  The training dataset waits for the textural trainer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

POSE_BINS = np.array(list(range(-180, 181, 360 // 24))) / 180.0


def scale_width(img: Image.Image, target_width: int,
                method=Image.BICUBIC) -> Image.Image:
    """base_dataset.py:__scale_width incl. the 188->192 hack."""
    ow, oh = img.size
    if ow == target_width:
        return img
    w = target_width
    h = int(target_width * oh / ow)
    if h == 188:
        h = 192
    return img.resize((w, h), method)


def transform_image(img: Image.Image, load_size: int = 624,
                    fine_wh: Tuple[int, int] = (624, 192),
                    nearest: bool = False,
                    normalize: bool = True) -> np.ndarray:
    """scale_width -> centre crop -> float [C-last]; get_transform for
    'scale_width_and_crop' at test time (base_dataset.py:40-66).

    Returns [H, W, C] float32; normalize maps to [-1, 1]."""
    method = Image.NEAREST if nearest else Image.BICUBIC
    img = scale_width(img, load_size, method)
    w, h = img.size
    tw, th = fine_wh
    crop_pos = (max(0, w - tw) // 2, max(0, h - th) // 2)
    if w > tw or h > th:
        img = img.crop((crop_pos[0], crop_pos[1],
                        crop_pos[0] + tw, crop_pos[1] + th))
    arr = np.asarray(img).astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if normalize:
        arr = arr / 255.0
        arr = (arr - 0.5) / 0.5
    else:
        arr = arr / 255.0     # ToTensor semantics (callers re-scale)
    return arr


def assemble_condition_maps(
    segm_png: np.ndarray,         # [H, W] precomputed label map (raw ids)
    inst_png: np.ndarray,         # [H, W] instance map (object idx, 0 = bg)
    json_obj: Dict[str, dict],    # per-object {class_id, alpha}
    normal_png: Optional[np.ndarray] = None,  # [H, W, 3] uint8
    depth_png: Optional[np.ndarray] = None,   # [H, W] uint16
) -> Dict[str, np.ndarray]:
    """Per-frame conditioning from geometric outputs
    (edit_vkitti.py:62-107 / vkitti_dataset.py:68-136).

    Returns dict with: label [H, W] int32 (precomputed +1 shift applied,
    car/van pixels set from instances), inst [H, W] int32 (k*1000 ids,
    background filled with labels), pose [H, W] int32 (bin ids), normal
    [H, W, 3] float (+1/255 bias on normalized), depth [H, W] float.
    """
    segm = segm_png.astype(np.int32) + 1        # precomputed shift (:55-56)
    inst = inst_png.astype(np.int32)

    # Remove original cars/vans from the label map (edit_vkitti.py:72-74).
    segm = np.where(segm == 2, 5, segm)
    segm = np.where(segm == 12, 5, segm)

    pose = np.zeros_like(segm)
    inst_scaled = inst * 1000
    for k_str, v in json_obj.items():
        k = int(k_str)
        sel = inst == k
        class_id = int(v["class_id"])
        segm = np.where(sel, {1: 2, 2: 12}.get(class_id, 2), segm)
        alpha = float(v["alpha"])
        pose = np.where(sel, int(np.digitize(alpha / np.pi, POSE_BINS)),
                        pose)

    # Background instance pixels get the label id (edit_vkitti.py:85).
    inst_full = np.where(inst_scaled == 0, segm, inst_scaled)

    out = {
        "label": segm.astype(np.int32),
        "inst": inst_full.astype(np.int32),
        "pose": pose.astype(np.int32),
    }
    if normal_png is not None:
        out["normal"] = (normal_png.astype(np.float32) / 255.0 - 0.5) / 0.5 \
            + 1.0 / 255.0                       # bias (edit_vkitti.py:93)
    if depth_png is not None:
        out["depth"] = 1.0 - depth_png.astype(np.float32) / 65535.0
    return out


def dense_instance_slots(inst: np.ndarray, max_instances: int
                         ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Map arbitrary instance ids to dense slots [0, max_instances) for the
    segment-sum instance pooling.  Returns (slots [H, W] int32,
    id->slot dict)."""
    ids = np.unique(inst)
    if len(ids) > max_instances:
        # Overflow ids stay at slot 0, polluting its pooled feature mean —
        # never hit on VKITTI (<= 14 labels + <= 16 instances), but make
        # it loud rather than silent on other data.
        import warnings
        warnings.warn(
            f"{len(ids)} unique instance ids > {max_instances} slots; "
            "overflow ids share slot 0", stacklevel=2)
    mapping = {int(v): i for i, v in enumerate(ids[:max_instances])}
    slots = np.zeros_like(inst, np.int32)
    for v, s in mapping.items():
        slots[inst == v] = s
    return slots, mapping
