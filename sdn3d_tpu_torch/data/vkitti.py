"""Virtual KITTI 1.3.1 data layer (host-side numpy), the subset the
serving paths use.

Counterpart of sdn3d_tpu/data/vkitti.py: the scenegt lookup tables and
GT objects (datasets/vkitti_utils.py, the geometric CLI's `--source gt`),
the train/test split lists, the camera intrinsics, the ROI crop
transforms (geometric/derender3d/datasets.py:18-137) and the
edit-benchmark JSON protocol.  The scenegt decode and the RGB crops go
through the native host library (data/native.py) as in the JAX package,
or its numpy path where no compiler is found; the mask crops go through
PIL in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence, Tuple

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


def get_tables(opt: str, datadir: str
               ) -> Dict[Tuple[str, str, int, int, int], int]:
    """scenegt RGB -> {segm class | instance id} lookup
    (vkitti_utils.py:12-42).  Instance id = 5000 * category + global_obj."""
    global_obj_id = 0
    table_inst, table_segm = {}, {}
    for world in WORLD_IDS:
        for scene in SCENE_IDS:
            path = os.path.join(
                datadir, "vkitti_1.3.1_scenegt",
                f"{world}_{scene}_scenegt_rgb_encoding.txt")
            with open(path) as fin:
                for i, line in enumerate(fin):
                    if i == 0:
                        continue
                    name, r, g, b = line.split(" ")
                    key = (world, scene, int(r), int(g), int(b))
                    if ":" not in name:
                        table_segm[key] = CATEGORIES.index(name)
                        table_inst[key] = CATEGORIES.index(name)
                    else:
                        global_obj_id += 1
                        cat = CATEGORIES.index(name.split(":")[0])
                        table_segm[key] = cat
                        table_inst[key] = 5000 * cat + global_obj_id
    return table_segm if opt == "segm" else table_inst


def get_lists(opt: str) -> List[str]:
    """Train/test file lists (vkitti_utils.py:45-59)."""
    out = []
    for wi, world in enumerate(WORLD_IDS):
        for scene in SCENE_IDS:
            for img in SPLIT_RANGES[opt][wi]:
                out.append(f"{world}/{scene}/{img:05d}.png")
    return out


def decode_scenegt(img_rgb: np.ndarray, world: str, scene: str,
                   table: Dict) -> np.ndarray:
    """scenegt RGB png [H, W, 3] -> id map [H, W] int32 via the lookup
    table (-1 for colours not in it), in the native host library's one
    pass (data/native.scenegt_decode)."""
    from sdn3d_tpu_torch.data import native

    keys = {}
    for (w, s, r, g, b), v in table.items():
        if w == world and s == scene:
            keys[(r << 16) | (g << 8) | b] = v
    if not keys:
        return np.full(img_rgb.shape[:2], -1, np.int32)
    lut_keys = np.asarray(sorted(keys), np.uint32)
    lut_vals = np.asarray([keys[int(k)] for k in lut_keys], np.int32)
    return native.scenegt_decode(img_rgb.astype(np.uint8), lut_keys,
                                 lut_vals)


def rgb_path(root: str, world: str, topic: str, frame: int) -> str:
    """VKITTI 1.3.1 RGB frame path."""
    return os.path.join(root, "vkitti_1.3.1_rgb", world, topic,
                        f"{frame:05d}.png")


def scenegt_path(root: str, world: str, topic: str, frame: int) -> str:
    return os.path.join(root, "vkitti_1.3.1_scenegt", world, topic,
                        f"{frame:05d}.png")


def gt_objects(root: str, world: str, topic: str, frame: int,
               table_inst: Dict, min_area: int = 50,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GT instance proposals from the scenegt map — the `--source gt`
    path (vehicle instances only, area > 50 px, matching the Mask R-CNN
    data loader's filter, maskrcnn/vkitti.py:83-102).

    Returns (class_ids [N], masks [N, 1, H, W] float32, rois [N, 4]
    y1,x1,y2,x2 pixel coords)."""
    from PIL import Image

    scene = np.asarray(Image.open(scenegt_path(root, world, topic, frame)))
    inst = decode_scenegt(scene, world, topic, table_inst)
    car, van = CATEGORIES.index("Car"), CATEGORIES.index("Van")

    class_ids, masks, rois = [], [], []
    for iid in np.unique(inst):
        cat = iid // 5000
        if cat not in (car, van) or iid < 5000:
            continue
        m = inst == iid
        if m.sum() <= min_area:
            continue
        ys, xs = np.nonzero(m)
        class_ids.append(1 if cat == car else 2)
        masks.append(m[None].astype(np.float32))
        rois.append([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
    if not class_ids:
        H, W = inst.shape
        return (np.zeros((0,), np.int32),
                np.zeros((0, 1, H, W), np.float32),
                np.zeros((0, 4), np.float32))
    return (np.asarray(class_ids, np.int32), np.stack(masks),
            np.asarray(rois, np.float32))


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


def transform_rgb(image_rgb: np.ndarray, roi: Sequence[int],
                  image_size: int = 256,
                  mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                  prescaled: bool = False) -> np.ndarray:
    """Square-crop (fill 0.5), resize and normalize an object crop for the
    derenderer (geometric/scripts/main.py:365-373), through the native
    host library: [image_size, image_size, 3] float32.  `prescaled=True`
    means the caller already converted the frame to float32 in [0, 1]."""
    from sdn3d_tpu_torch.data import native
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


def benchmark_split(items: List[EditItem]) -> List[EditItem]:
    """First half = edit pairs; second half = reconstruction
    (textural/edit_benchmark.py:46, semantic/vkitti_dataset.py:274)."""
    return items[:len(items) // 2]
