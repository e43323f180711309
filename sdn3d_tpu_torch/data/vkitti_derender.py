"""VKITTI de-renderer data: motgt tables -> GT targets, PyTorch port.

Counterpart of sdn3d_tpu/data/vkitti_derender.py (geometric/derender3d/
datasets.py:193-420): the motgt per-object rows become the derenderer's
supervision targets (theta / rotation, per-axis scale, projected 2D
translation, log-depth) and occlusion ignore maps come from depth order.
The motgt tables are read without pandas (the card's machine has none):
each space-separated table is parsed with `csv`, and every column takes
the type pandas' read_csv infers for it over all tables (int, float, bool
or str), so `objects()` gives the rows pandas' `to_dict()` gives.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sdn3d_tpu_torch.data.vkitti import (Camera, SCENE_IDS, SPLIT_RANGES,
                                         WORLD_IDS)

# Empirical width correction baked into the reference's scale target
# (datasets.py:370: scale = [l3d, h3d, 1.2206 * w3d]).
WIDTH_CORRECTION = 1.2206


def mask_to_roi(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Binary mask [H, W] -> (y1, x1, y2, x2) (Transforms.mask_to_roi)."""
    ys, xs = np.nonzero(mask)
    return int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1


def roi_jitter(roi: Sequence[int], ratio: float = 0.1,
               rng: Optional[random.Random] = None) -> List[int]:
    """Random ROI jitter (derender3d/datasets.py:39-49)."""
    rng = rng or random
    dy = int(ratio * (roi[2] - roi[0]))
    dx = int(ratio * (roi[3] - roi[1]))
    return [roi[0] + rng.randint(-dy, dy), roi[1] + rng.randint(-dx, dx),
            roi[2] + rng.randint(-dy, dy), roi[3] + rng.randint(-dx, dx)]


def motgt_targets(row: Dict[str, float], roi: Sequence[float],
                  camera=Camera) -> Dict[str, np.ndarray]:
    """One motgt row + its ROI -> derenderer GT targets
    (datasets.py:351-391).  row must carry ry, l3d, h3d, w3d, x3d, y3d,
    z3d."""
    roi_norm = np.asarray([
        (roi[0] - camera.v0) / camera.focal,
        (roi[1] - camera.u0) / camera.focal,
        (roi[2] - camera.v0) / camera.focal,
        (roi[3] - camera.u0) / camera.focal,
    ], np.float32)
    mroi = np.asarray([(roi_norm[2] + roi_norm[0]) / 2,
                       (roi_norm[3] + roi_norm[1]) / 2], np.float32)
    droi = np.asarray([roi_norm[2] - roi_norm[0],
                       roi_norm[3] - roi_norm[1]], np.float32)

    ry = float(row["ry"])
    theta = np.asarray([-ry], np.float32)
    rotation = np.asarray([np.cos(ry / 2), 0, -np.sin(ry / 2), 0],
                          np.float32)
    scale = np.asarray([row["l3d"], row["h3d"],
                        WIDTH_CORRECTION * row["w3d"]], np.float32)
    xyz = np.asarray([row["x3d"], -(row["y3d"] - row["h3d"] / 2),
                      -row["z3d"]], np.float32)

    translation2d = np.clip(np.asarray([
        (xyz[1] / xyz[2] - mroi[0]) / droi[0],
        (-xyz[0] / xyz[2] - mroi[1]) / droi[1],
    ], np.float32), -6, 6)

    depth_sq = float(np.sum(xyz ** 2))
    log_depth = np.asarray(
        [np.log(depth_sq) + np.log(droi[0]) + np.log(droi[1])], np.float32)

    return {
        "roi_norms": roi_norm,
        "thetas": theta,
        "rotations": rotation,
        "translations": xyz,
        "translation2ds": translation2d,
        "scales": scale,
        "log_scales": np.log(scale).astype(np.float32),
        "log_depths": log_depth,
    }


def object_depth_sq(row: Dict[str, float]) -> float:
    xyz = np.asarray([row["x3d"], -(row["y3d"] - row["h3d"] / 2),
                      -row["z3d"]])
    return float(np.sum(xyz ** 2))


def occlusion_ignore(masks: np.ndarray, depths_sq: np.ndarray,
                     own_index: int) -> np.ndarray:
    """Ignore map for one object: union of strictly-nearer objects' masks
    (datasets.py:385-391)."""
    nearer = depths_sq < depths_sq[own_index]
    return np.clip((masks * nearer[:, None, None]).sum(0), 0, 1)


def training_row_filter(row: Dict[str, float]) -> bool:
    """Sample selection (datasets.py:313-327): area > 16^2, truncation
    ratio < 0.7, occupancy ratio > 0.3."""
    area = (row["b"] - row["t"]) * (row["r"] - row["l"])
    return bool(area > 16 * 16 and row["truncr"] < 0.7
                and row["occupr"] > 0.3)


_INT = re.compile(r"[+-]?\d+")
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


def _column_type(tokens: List[str]):
    """The Python type of pandas' read_csv inference for one column:
    int64 if every token is an integer, float64 if every token is a
    number, bool if every token is a boolean word, else str."""
    if all(_INT.fullmatch(t) for t in tokens):
        return int
    try:
        for t in tokens:
            float(t)
        return float
    except ValueError:
        pass
    if all(t in _BOOLS for t in tokens):
        return bool
    return str


@dataclasses.dataclass
class VKittiMotgt:
    """motgt table loader (datasets.py:236-258): every
    vkitti_1.3.1_motgt/{world}_{topic}.txt under `root_dir`, indexed by
    (world, topic, frame)."""

    root_dir: str

    def __post_init__(self):
        tables = []                     # (world, topic, header, rows)
        for world in WORLD_IDS:
            for topic in SCENE_IDS:
                path = os.path.join(self.root_dir, "vkitti_1.3.1_motgt",
                                    f"{world}_{topic}.txt")
                if not os.path.isfile(path):
                    continue
                with open(path, newline="") as fh:
                    lines = list(csv.reader(fh, delimiter=" "))
                # blank lines are skipped, as read_csv skips them
                tables.append((world, topic, lines[0],
                               [r for r in lines[1:] if r]))
        # one type per column over every table (pd.concat of the frames)
        columns: Dict[str, List[str]] = {}
        for _, _, header, rows in tables:
            for j, name in enumerate(header):
                columns.setdefault(name, []).extend(r[j] for r in rows)
        types = {name: _column_type(toks) for name, toks in columns.items()}
        # (world, topic) -> frame -> rows, frames in first-seen order
        self._rows: Dict[Tuple[str, str], Dict[int, List[dict]]] = {}
        for world, topic, header, rows in tables:
            frames = self._rows.setdefault((world, topic), {})
            for r in rows:
                row = {}
                for name, tok in zip(header, r):
                    typ = types[name]
                    row[name] = _BOOLS[tok] if typ is bool else typ(tok)
                frames.setdefault(row.pop("frame"), []).append(row)

    def frames(self, split: str) -> List[Tuple[str, str, int]]:
        """(world, topic, frame) of every table's frames inside `split`'s
        ranges ("train", else the test ranges), by world, topic and
        first-seen frame order."""
        out = []
        for wi, world in enumerate(WORLD_IDS):
            rng = SPLIT_RANGES["train" if split == "train" else "test"][wi]
            for topic in SCENE_IDS:
                frames = self._rows.get((world, topic), {})
                out.extend((world, topic, int(f)) for f in frames
                           if f in rng)
        return out

    def objects(self, world: str, topic: str, frame: int) -> List[dict]:
        """The frame's motgt rows in table order (columns but `frame`)."""
        return [dict(r) for r in self._rows[(world, topic)][frame]]


def read_scenegt_codes(root_dir: str, world: str, topic: str
                       ) -> Dict[str, Tuple[int, int, int]]:
    """Per-(world, topic) scenegt encoding: 'Category(:id)' -> RGB code
    (datasets.py:259-277 _read_scenegt)."""
    path = os.path.join(root_dir, "vkitti_1.3.1_scenegt",
                        f"{world}_{topic}_scenegt_rgb_encoding.txt")
    codes = {}
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            name, r, g, b = line.split(" ")
            codes[name] = (int(r), int(g), int(b))
    return codes


@dataclasses.dataclass
class VKittiDerenderDataset:
    """Per-object derenderer training items (datasets.py:279-420 VKitti).

    Each item is one vehicle instance: normalized 224^2 RGB crop, 256^2
    mask + occlusion-ignore crops, and the motgt GT targets.  Training
    items are filtered by area > 16^2, truncr < 0.7, occupr > 0.3
    (datasets.py:313-327) and get ROI jitter.
    """

    root_dir: str
    is_train: bool = True
    is_evaluate: bool = False
    image_size: int = 224
    render_size: int = 256
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    jitter_rng: Optional[random.Random] = None

    def __post_init__(self):
        self.motgt = VKittiMotgt(self.root_dir)
        self._codes: Dict[Tuple[str, str], Dict] = {}
        self.items: List[Tuple[str, str, int, dict]] = []
        split = "train" if self.is_train else "test"
        for world, topic, frame in self.motgt.frames(split):
            for row in self.motgt.objects(world, topic, frame):
                if self.is_evaluate or training_row_filter(row):
                    self.items.append((world, topic, frame, row))

    def __len__(self):
        return len(self.items)

    def codes(self, world: str, topic: str) -> Dict:
        key = (world, topic)
        if key not in self._codes:
            self._codes[key] = read_scenegt_codes(self.root_dir, world,
                                                  topic)
        return self._codes[key]

    def read_rgb(self, world, topic, frame) -> np.ndarray:
        from PIL import Image

        from sdn3d_tpu_torch.data.vkitti import rgb_path
        return np.asarray(Image.open(
            rgb_path(self.root_dir, world, topic, frame)).convert("RGB"))

    def read_scene(self, world, topic, frame) -> np.ndarray:
        from PIL import Image

        from sdn3d_tpu_torch.data.vkitti import scenegt_path
        return np.asarray(Image.open(
            scenegt_path(self.root_dir, world, topic, frame)))

    @staticmethod
    def _obj_name(row: dict) -> str:
        return f"{row['orig_label']}:{int(row['tid'])}"

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from sdn3d_tpu_torch.data.vkitti import (crop_square,
                                                 resize_bilinear_np,
                                                 transform_mask,
                                                 transform_rgb)

        world, topic, frame, row = self.items[index]
        codes = self.codes(world, topic)
        scene = self.read_scene(world, topic, frame)

        mask = np.all(scene == np.asarray(codes[self._obj_name(row)]),
                      axis=-1)
        roi = mask_to_roi(mask)
        if self.is_train:
            roi = roi_jitter(roi, rng=self.jitter_rng)

        out = motgt_targets(row, roi)
        out["targets"] = 3                  # pretrain | finetune
        out["rois"] = np.asarray(roi, np.float32)
        out["focals"] = np.asarray([Camera.focal], np.float32)
        out["widths"] = np.asarray([Camera.width], np.float32)
        out["heights"] = np.asarray([Camera.height], np.float32)
        out["u0s"] = np.asarray([Camera.u0], np.float32)
        out["v0s"] = np.asarray([Camera.v0], np.float32)

        # occlusion ignores from depth ordering over ALL frame objects
        rows = self.motgt.objects(world, topic, frame)
        masks = np.stack([
            np.all(scene == np.asarray(codes[self._obj_name(r)]), axis=-1)
            for r in rows]).astype(np.float32)
        depths = np.asarray([object_depth_sq(r) for r in rows])
        own = next(i for i, r in enumerate(rows)
                   if self._obj_name(r) == self._obj_name(row))
        ignore = occlusion_ignore(masks, depths, own)

        if not self.is_evaluate:
            image_rgb = self.read_rgb(world, topic, frame)
            out["images"] = transform_rgb(image_rgb, roi,
                                          image_size=self.image_size,
                                          mean=self.mean, std=self.std)
            out["masks"] = transform_mask(
                mask[..., None], roi,
                render_size=self.render_size)[None, ..., 0]
            # outside-the-frame pixels count as ignored (fill=255,
            # datasets.py:144)
            ig = crop_square(ignore[..., None].astype(np.float32), roi,
                             fill=1.0)
            out["ignores"] = resize_bilinear_np(
                ig, self.render_size)[None, ..., 0]
        return out
