"""Real-KITTI data layer: object labels, calibration, targets, PyTorch
port (host-side numpy).

Counterpart of sdn3d_tpu/data/kitti.py, itself a re-expression of geometric/derender3d/datasets.py:423-606 (KittiObject —
label_2 txt parsing, P2 calibration, pretrain targets with no width
correction) and :609-769 (KittiSemantics, the mask-only fine-tuning
crops).  The hybrid's per-item weights (datasets.py:175-190) are
data/loader.hybrid_weights.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional

import numpy as np

# KITTI label_2 column layout (datasets.py:442-459).
MOTGT_NAMES = ["type", "truncated", "occluded", "alpha",
               "left", "top", "right", "bottom",
               "h", "w", "l", "x", "y", "z", "ry", "score"]

TRAIN_FRAMES = range(0, 6733)
VALIDATION_FRAMES = range(6733, 7481)
TRAIN_TYPES = ("Car", "Van", "Truck")
VAL_TYPES = ("Car",)


class Camera:
    """Nominal intrinsics (datasets.py:427-430); per-frame values come from
    the calib files."""
    focal = 725.0
    u0 = 610.0
    v0 = 185.0


def parse_label_file(path: str) -> List[dict]:
    """One label_2 {frame}.txt -> list of object dicts."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            row = {"type": parts[0]}
            for name, v in zip(MOTGT_NAMES[1:], parts[1:]):
                row[name] = float(v)
            rows.append(row)
    return rows


def parse_calib_file(path: str) -> Dict[str, float]:
    """P2 row of a calib txt -> {focal, u0, v0} (datasets.py:507-521:
    columns 1, 3, 7 of the P2 line)."""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "P2:":
                return {"focal": float(parts[1]), "u0": float(parts[3]),
                        "v0": float(parts[7])}
    raise ValueError(f"no P2 line in {path}")


def kitti_targets(row: Dict[str, float], camera: Dict[str, float]
                  ) -> Dict[str, np.ndarray]:
    """KittiObject pretrain targets (datasets.py:557-606).  Unlike VKITTI,
    scale = (l, h, w) with NO width correction, and the roi comes from the
    label box."""
    focal, u0, v0 = camera["focal"], camera["u0"], camera["v0"]
    roi_norm = np.asarray([
        (row["top"] - v0) / focal,
        (row["left"] - u0) / focal,
        (row["bottom"] - v0) / focal,
        (row["right"] - u0) / focal,
    ], np.float32)
    mroi = np.asarray([(roi_norm[2] + roi_norm[0]) / 2,
                       (roi_norm[3] + roi_norm[1]) / 2], np.float32)
    droi = np.asarray([roi_norm[2] - roi_norm[0],
                       roi_norm[3] - roi_norm[1]], np.float32)

    theta = np.asarray([-row["ry"]], np.float32)
    scale = np.asarray([row["l"], row["h"], row["w"]], np.float32)
    xyz = np.asarray([row["x"], -(row["y"] - row["h"] / 2), -row["z"]],
                     np.float32)
    translation2d = np.clip(np.asarray([
        (xyz[1] / xyz[2] - mroi[0]) / droi[0],
        (-xyz[0] / xyz[2] - mroi[1]) / droi[1],
    ], np.float32), -6, 6)
    depth_sq = float(np.sum(xyz ** 2))
    log_depth = np.asarray(
        [np.log(depth_sq) + np.log(droi[0]) + np.log(droi[1])], np.float32)

    return {
        "roi_norms": roi_norm,
        "focals": np.asarray([focal], np.float32),
        "thetas": theta,
        "translation2ds": translation2d,
        "log_scales": np.log(scale).astype(np.float32),
        "log_depths": log_depth,
        "rois": np.asarray([row["top"], row["left"], row["bottom"],
                            row["right"]], np.float32),
    }


@dataclasses.dataclass
class KittiObjectDataset:
    """label_2 + calib loader (requires KITTI_OBJECT_ROOT_DIR)."""

    root_dir: str
    is_train: bool = True
    image_size: int = 224

    def __post_init__(self):
        frames = TRAIN_FRAMES if self.is_train else VALIDATION_FRAMES
        types = TRAIN_TYPES if self.is_train else VAL_TYPES
        self.items = []
        for frame in frames:
            path = os.path.join(self.root_dir, "training", "label_2",
                                f"{frame:06d}.txt")
            if not os.path.isfile(path):
                continue
            for row in parse_label_file(path):
                if row["type"] in types:
                    self.items.append((frame, row))

    def __len__(self):
        return len(self.items)

    def camera(self, frame: int) -> Dict[str, float]:
        return parse_calib_file(os.path.join(
            self.root_dir, "training", "calib", f"{frame:06d}.txt"))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        frame, row = self.items[index]
        out = kitti_targets(row, self.camera(frame))
        out["frame"] = frame
        out["targets"] = 1                      # TargetType.pretrain
        rgb_path = os.path.join(self.root_dir, "training", "image_2",
                                f"{frame:06d}.png")
        if os.path.isfile(rgb_path):
            from PIL import Image
            from sdn3d_tpu_torch.data.vkitti import transform_rgb
            image_rgb = np.asarray(Image.open(rgb_path))
            out["images"] = transform_rgb(image_rgb, out["rois"],
                                          image_size=self.image_size)
        return out


def semantics_instance_cat(obj_index: int) -> int:
    """KITTI-semantics instance ids encode category*100 (well, the
    reference's index2cat, datasets.py:624-626); car == 66."""
    return obj_index // 100


KITTI_SEMANTICS_CAR = 66
SEMANTICS_TRAIN_FRAMES = range(0, 180)
SEMANTICS_VALIDATION_FRAMES = range(180, 200)


@dataclasses.dataclass
class KittiSemanticsDataset:
    """KITTI semantic-instance crops for mask-only fine-tuning
    (datasets.py:609-769 KittiSemantics): car instances from the
    `training/instance` maps, filtered by area > 32x32 and aspect < 4,
    yielding finetune-mode items (mask supervision, zero ignores).

    ROI extraction per frame is cached as JSON next to the data (or in
    `cache_dir`), mirroring the reference's cache files."""

    root_dir: str
    is_train: bool = True
    cache_dir: Optional[str] = None
    image_size: int = 256
    render_size: int = 256
    jitter_rng: Optional[random.Random] = None

    def __post_init__(self):
        import json
        frames = (SEMANTICS_TRAIN_FRAMES if self.is_train
                  else SEMANTICS_VALIDATION_FRAMES)
        cache_dir = self.cache_dir or os.path.join(self.root_dir, "_cache")
        os.makedirs(cache_dir, exist_ok=True)
        self.items = []
        for frame in frames:
            scene_path = self._scene_path(frame)
            if not os.path.isfile(scene_path):
                continue
            json_path = os.path.join(cache_dir, f"_{frame:06d}.json")
            if os.path.isfile(json_path):
                with open(json_path) as f:
                    json_objs = json.load(f)
            else:
                scene = self.read_scene(frame)
                json_objs = []
                for obj_index in np.unique(scene):
                    mask = scene == obj_index
                    cols = np.where(np.any(mask, axis=0))[0]
                    rows = np.where(np.any(mask, axis=1))[0]
                    json_objs.append({
                        "obj_index": int(obj_index),
                        "roi": [int(rows[0]), int(cols[0]),
                                int(rows[-1] + 1), int(cols[-1] + 1)],
                    })
                with open(json_path, "w") as f:
                    json.dump(json_objs, f)
            for obj in json_objs:
                if semantics_instance_cat(obj["obj_index"]) != \
                        KITTI_SEMANTICS_CAR:
                    continue
                y1, x1, y2, x2 = obj["roi"]
                dy, dx = y2 - y1, x2 - x1
                # datasets.py:723-732: area and aspect-ratio filters.
                if dy * dx <= 32 * 32 or dx >= 4 * dy or dy >= 4 * dx:
                    continue
                self.items.append((frame, obj["obj_index"], obj["roi"]))

    def _scene_path(self, frame: int) -> str:
        return os.path.join(self.root_dir, "training", "instance",
                            f"{frame:06d}_10.png")

    def read_scene(self, frame: int) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.open(self._scene_path(frame)))

    def read_rgb(self, frame: int) -> np.ndarray:
        from PIL import Image
        path = os.path.join(self.root_dir, "training", "image_2",
                            f"{frame:06d}_10.png")
        return np.asarray(Image.open(path))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from sdn3d_tpu_torch.data.vkitti import transform_mask, transform_rgb
        from sdn3d_tpu_torch.data.vkitti_derender import roi_jitter

        frame, obj_index, roi = self.items[index]
        scene = self.read_scene(frame)
        image_rgb = self.read_rgb(frame)
        if self.is_train and self.jitter_rng is not None:
            roi = roi_jitter(roi, rng=self.jitter_rng)

        # Nominal KITTI camera (datasets.py:427-430); roi normalized the
        # KittiSemantics way — principal point from the image center
        # (datasets.py:744-752).
        u0 = (image_rgb.shape[1] - 1) / 2.0
        v0 = (image_rgb.shape[0] - 1) / 2.0
        roi_norm = np.asarray([
            (roi[0] - v0) / Camera.focal,
            (roi[1] - u0) / Camera.focal,
            (roi[2] - v0) / Camera.focal,
            (roi[3] - u0) / Camera.focal,
        ], np.float32)

        mask = (scene == obj_index)[..., None]
        return {
            "targets": 2,                       # TargetType.finetune (reproject)
            "images": transform_rgb(image_rgb, roi,
                                    image_size=self.image_size),
            "focals": np.asarray([Camera.focal], np.float32),
            "masks": transform_mask(mask, roi,
                                    render_size=self.render_size)[None, ..., 0],
            "ignores": np.zeros((1, self.render_size, self.render_size),
                                np.float32),
            "roi_norms": roi_norm,
        }

