"""Cityscapes derenderer dataset: extend-mode car crops with
disparity-percentile occlusion ignores, PyTorch port (host-side numpy).

Counterpart of sdn3d_tpu/data/cityscapes_derender.py, itself a
re-expression of geometric/derender3d/datasets.py:837-971
(CityscapesSemantics): every gtFine car instance (instanceIds //
1000 == 26) becomes one finetune-target item — 224^2 normalized RGB
crop, 256^2 mask crop, and an ignore map marking every pixel nearer
than the object's own 95th disparity percentile.  Per-frame car lists
are cached as JSON like the reference's CITYSCAPES_SEMANTICS_CACHE_DIR
files (:866-899).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from sdn3d_tpu_torch.data.cityscapes import (CAR_ID, Camera,
                                             disparity_ignore, index2cat)


@dataclasses.dataclass
class CityscapesSemanticsDataset:
    """Layout (reference CityscapesBaseDataset readers, :794-796,852-861):
      rgb        root/images/leftImg8bit/{split}/{city}/*_leftImg8bit.png
      instances  root/gtFine/{split}/{city}/*_gtFine_instanceIds.png
      disparity  root/disparity/{split}/{city}/*_disparity.png
    """

    root_dir: str
    is_train: bool = True
    cache_dir: Optional[str] = None
    image_size: int = 224
    render_size: int = 256
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    jitter_rng: Optional[random.Random] = None

    def __post_init__(self):
        split = "train" if self.is_train else "val"
        cache_dir = self.cache_dir or os.path.join(self.root_dir, "_cache")
        os.makedirs(cache_dir, exist_ok=True)
        self.items: List[Tuple[str, str, str, str, int]] = []
        split_dir = os.path.join(self.root_dir, "gtFine", split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(split_dir)
        for city in sorted(os.listdir(split_dir)):
            city_dir = os.path.join(split_dir, city)
            for name in sorted(os.listdir(city_dir)):
                if not name.endswith("gtFine_instanceIds.png"):
                    continue
                seq, frame = name.split("_")[1:3]
                json_path = os.path.join(
                    cache_dir, f"{city}_{seq}_{frame}_gtFine.json")
                if os.path.isfile(json_path):
                    with open(json_path) as f:
                        objs = json.load(f)
                else:
                    scene = self.read_scene(split, city, seq, frame)
                    objs = [{"obj_index": int(v)} for v in np.unique(scene)
                            if index2cat(int(v)) == CAR_ID]
                    with open(json_path, "w") as f:
                        json.dump(objs, f)
                for obj in objs:
                    self.items.append((split, city, seq, frame,
                                       int(obj["obj_index"])))

    # -- readers (datasets.py:794-796,852-861) --------------------------

    def _frame_path(self, kind: str, split, city, seq, frame,
                    suffix: str) -> str:
        base = {"rgb": os.path.join("images", "leftImg8bit", split, city),
                "gt": os.path.join("gtFine", split, city),
                "disp": os.path.join("disparity", split, city)}[kind]
        return os.path.join(self.root_dir, base,
                            f"{city}_{seq}_{frame}_{suffix}")

    def read_rgb(self, split, city, seq, frame) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.open(self._frame_path(
            "rgb", split, city, seq, frame, "leftImg8bit.png")))

    def read_scene(self, split, city, seq, frame) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.open(self._frame_path(
            "gt", split, city, seq, frame, "gtFine_instanceIds.png")))

    def read_disparity(self, split, city, seq, frame) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.open(self._frame_path(
            "disp", split, city, seq, frame, "disparity.png")))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from sdn3d_tpu_torch.data.vkitti import (crop_square,
                                                 resize_bilinear_np,
                                                 transform_mask,
                                                 transform_rgb)
        from sdn3d_tpu_torch.data.vkitti_derender import (mask_to_roi,
                                                          roi_jitter)

        split, city, seq, frame, obj_index = self.items[index]
        scene = self.read_scene(split, city, seq, frame)
        mask = scene == obj_index
        roi = mask_to_roi(mask)
        if self.is_train and self.jitter_rng is not None:
            roi = roi_jitter(roi, rng=self.jitter_rng)

        # roi normalized with the nominal Cityscapes intrinsics
        # (datasets.py:788-791,943-948 — the per-frame camera JSONs feed
        # only the dataframe, not the item)
        roi_norm = np.asarray([
            (roi[0] - Camera.v0) / Camera.focal,
            (roi[1] - Camera.u0) / Camera.focal,
            (roi[2] - Camera.v0) / Camera.focal,
            (roi[3] - Camera.u0) / Camera.focal,
        ], np.float32)

        disparity = self.read_disparity(split, city, seq, frame)
        image_ignore = disparity_ignore(disparity.astype(np.float32),
                                        mask.astype(np.float32))

        image_rgb = self.read_rgb(split, city, seq, frame)
        ig = crop_square(image_ignore[..., None], roi, fill=1.0)
        return {
            "targets": 2,                 # TargetType.finetune (reproject)
            "images": transform_rgb(image_rgb, roi,
                                    image_size=self.image_size,
                                    mean=self.mean, std=self.std),
            "masks": transform_mask(mask[..., None], roi,
                                    render_size=self.render_size
                                    )[None, ..., 0],
            "ignores": resize_bilinear_np(ig, self.render_size)[None, ..., 0],
            "widths": np.asarray([image_rgb.shape[1]], np.float32),
            "heights": np.asarray([image_rgb.shape[0]], np.float32),
            "focals": np.asarray([Camera.focal], np.float32),
            "u0s": np.asarray([Camera.u0], np.float32),
            "v0s": np.asarray([Camera.v0], np.float32),
            "rois": np.asarray(roi, np.float32),
            "roi_norms": roi_norm,
        }
