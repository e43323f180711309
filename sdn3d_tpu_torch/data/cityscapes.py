"""Cityscapes data layer: labels, cameras, instance decoding, disparity
ignore masks, PyTorch port (host-side numpy).

Counterpart of sdn3d_tpu/data/cityscapes.py, itself a re-expression of textural/data/cityscapes_labels.py (the standard
Cityscapes label spec subset the reference uses), geometric/derender3d/
datasets.py:772-1112 (cameras, instanceIds decoding, disparity-percentile
ignore masks) and the textural cityscapes dataset conventions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (name, id, trainId, color) — standard Cityscapes label table
# (textural/data/cityscapes_labels.py).
LABELS: List[Tuple[str, int, int, Tuple[int, int, int]]] = [
    ("unlabeled", 0, 255, (0, 0, 0)),
    ("ego vehicle", 1, 255, (0, 0, 0)),
    ("rectification border", 2, 255, (0, 0, 0)),
    ("out of roi", 3, 255, (0, 0, 0)),
    ("static", 4, 255, (0, 0, 0)),
    ("dynamic", 5, 255, (111, 74, 0)),
    ("ground", 6, 255, (81, 0, 81)),
    ("road", 7, 0, (128, 64, 128)),
    ("sidewalk", 8, 1, (244, 35, 232)),
    ("parking", 9, 255, (250, 170, 160)),
    ("rail track", 10, 255, (230, 150, 140)),
    ("building", 11, 2, (70, 70, 70)),
    ("wall", 12, 3, (102, 102, 156)),
    ("fence", 13, 4, (190, 153, 153)),
    ("guard rail", 14, 255, (180, 165, 180)),
    ("bridge", 15, 255, (150, 100, 100)),
    ("tunnel", 16, 255, (150, 120, 90)),
    ("pole", 17, 5, (153, 153, 153)),
    ("polegroup", 18, 255, (153, 153, 153)),
    ("traffic light", 19, 6, (250, 170, 30)),
    ("traffic sign", 20, 7, (220, 220, 0)),
    ("vegetation", 21, 8, (107, 142, 35)),
    ("terrain", 22, 9, (152, 251, 152)),
    ("sky", 23, 10, (70, 130, 180)),
    ("person", 24, 11, (220, 20, 60)),
    ("rider", 25, 12, (255, 0, 0)),
    ("car", 26, 13, (0, 0, 142)),
    ("truck", 27, 14, (0, 0, 70)),
    ("bus", 28, 15, (0, 60, 100)),
    ("caravan", 29, 255, (0, 0, 90)),
    ("trailer", 30, 255, (0, 0, 110)),
    ("train", 31, 16, (0, 80, 100)),
    ("motorcycle", 32, 17, (0, 0, 230)),
    ("bicycle", 33, 18, (119, 11, 32)),
    ("license plate", -1, -1, (0, 0, 142)),
]

ID_TO_TRAIN_ID = {lid: tid for _, lid, tid, _ in LABELS}
CAR_ID = 26


class Camera:
    """Cityscapes intrinsics used by the de-renderer
    (derender3d/datasets.py:788-791)."""
    focal = 2250.0
    u0 = 925.0
    v0 = 460.0


def index2cat(obj_index: np.ndarray) -> np.ndarray:
    """instanceIds convention: instance id = 1000 * category + obj
    (datasets.py:848-849)."""
    return obj_index // 1000


def car_instances(instance_ids: np.ndarray) -> List[int]:
    """Instance ids of cars in a gtFine instanceIds map
    (datasets.py:890-896)."""
    return [int(v) for v in np.unique(instance_ids)
            if index2cat(v) == CAR_ID]


def instance_mask(instance_ids: np.ndarray, obj_index: int) -> np.ndarray:
    return (instance_ids == obj_index).astype(np.float32)


def disparity_ignore(disparity: np.ndarray, mask: np.ndarray,
                     pct: float = 95.0) -> np.ndarray:
    """Occlusion ignore mask from the disparity percentile
    (datasets.py:950-956): take the object's own nonzero-disparity
    pixels, find their 95th percentile, and ignore EVERY image pixel
    nearer than that (disparity > p95) — including pixels inside the
    mask, exactly as the reference computes `image_ignore`."""
    vals = disparity[mask > 0]
    vals = vals[vals != 0]
    thresh = np.percentile(vals, pct) if vals.size else 0.0
    return (disparity > thresh).astype(np.float32)


def id_map_to_train_ids(label_ids: np.ndarray) -> np.ndarray:
    """Raw label ids -> train ids (255 = ignore)."""
    out = np.full_like(label_ids, 255)
    for _, lid, tid, _ in LABELS:
        if lid >= 0:
            out[label_ids == lid] = tid
    return out


def color_map(num: int = 35) -> np.ndarray:
    cmap = np.zeros((num, 3), np.uint8)
    for _, lid, _, color in LABELS:
        if 0 <= lid < num:
            cmap[lid] = color
    return cmap
