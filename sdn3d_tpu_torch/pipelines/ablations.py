"""2D / 2D+ editing ablation baselines (geometric/scripts/main.py:215-322;
PyTorch port of sdn3d_tpu/pipelines/ablations.py, host numpy and PIL, the
same bytes).

The paper's ablations: instead of 3D de-rendering, edits act directly on 2D
masks — `modify` translates the mask by the op's pixel delta and rescales
its box by `zoom` (2D+ additionally foreshortens width by cos(ry));
`delete` drops the object.  Output is the same instance-map contract as the
3D path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _resize_mask(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    if hw[0] <= 0 or hw[1] <= 0:
        return np.zeros((max(hw[0], 0), max(hw[1], 0)), np.float32)
    pil = Image.fromarray((mask * 255).astype(np.uint8))
    out = pil.resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(out).astype(np.float32) / 255.0


def edit_2d(
    image_hw: Tuple[int, int],
    class_ids: np.ndarray,
    image_masks: np.ndarray,        # [N, 1, H, W]
    rois: np.ndarray,               # [N, 4] (y1, x1, y2, x2)
    operations: Optional[List[dict]] = None,
    use_ry: bool = False,
) -> Dict[str, object]:
    """Returns {instance_map [H, W] int32, json_obj, interests}."""
    H, W = image_hw
    n = len(class_ids)
    interests = np.ones(n, np.uint8)
    rois = rois.astype(np.int32)

    mrois = np.stack([rois[:, 2] + rois[:, 0],
                      rois[:, 3] + rois[:, 1]], 1).astype(np.float32) / 2
    drois = np.stack([rois[:, 2] - rois[:, 0],
                      rois[:, 3] - rois[:, 1]], 1).astype(np.float32)
    new_m = mrois.copy()
    new_d = drois.copy()

    if operations:
        op_centers = np.asarray([[float(op["from"]["v"]),
                                  float(op["from"]["u"])]
                                 for op in operations], np.float32)
        diffs = ((mrois[:, None] - op_centers[None]) ** 2).sum(2)
        if n < len(operations):
            pairs = [(i, int(j)) for i, j in enumerate(diffs.argmin(1))]
        else:
            pairs = [(int(i), j) for j, i in enumerate(diffs.argmin(0))]
        for i_obj, i_op in pairs:
            op = operations[i_op]
            if op["type"] == "delete":
                interests[i_obj] = 0
            elif op["type"] == "modify":
                u = float(op["from"]["u"])
                v = float(op["from"]["v"])
                _u = float(op["to"].get("u", u))
                _v = float(op["to"].get("v", v))
                zoom = float(op["zoom"])
                ry = float(op["ry"])
                new_m[i_obj] += [_v - v, _u - u]
                if use_ry:
                    new_d[i_obj] = [zoom * new_d[i_obj, 0],
                                    zoom * abs(np.cos(ry)) * new_d[i_obj, 1]]
                else:
                    new_d[i_obj] = zoom * new_d[i_obj]

    json_obj = {}
    inst = np.zeros((H, W), np.float32)
    for i in range(n):
        if not interests[i]:
            continue
        json_obj[i + 1] = {"class_id": int(class_ids[i])}
        crop = image_masks[i, 0, rois[i, 0]:rois[i, 2], rois[i, 1]:rois[i, 3]]
        resized = _resize_mask(crop, (int(new_d[i, 0]), int(new_d[i, 1])))
        top = int(new_m[i, 0] - new_d[i, 0] / 2)
        left = int(new_m[i, 1] - new_d[i, 1] / 2)
        full = np.zeros((H, W), np.float32)
        y1, x1 = max(0, top), max(0, left)
        y2 = min(H, top + resized.shape[0])
        x2 = min(W, left + resized.shape[1])
        if y2 > y1 and x2 > x1:
            full[y1:y2, x1:x2] = resized[y1 - top:y2 - top,
                                         x1 - left:x2 - left]
        full = np.round(full)
        inst = (1 - full) * inst + full * (i + 1)

    return {"instance_map": inst.astype(np.int32), "json_obj": json_obj,
            "interests": interests}


def edit_2d_plus(*args, **kwargs):
    """2D+ ablation (main.py:322): width foreshortening by cos(ry)."""
    kwargs["use_ry"] = True
    return edit_2d(*args, **kwargs)
