"""Textural-branch Cityscapes dataset (the reference ui_model demo's
data path; PyTorch port of sdn3d_tpu/data/textural_cityscapes.py, host
numpy and PIL, byte for byte).

Re-expression of textural/data/cityscapes_dataset.py:1-141 +
cityscapes_labels.py:1-184 (the label spec subset lives in
data/cityscapes.py:LABELS).  The reference's textural branch — and its
interactive ui_model demo — runs on Cityscapes; this module assembles
the same conditioning dict the VKITTI textural dataset produces
(data/textural_data.py) from the Cityscapes layout:

  annotations/instancesonly_gtFine_{train,val}.json   (file list)
  images/{name}_leftImg8bit.png                       (RGB)
  gtFine/{subset}/{city}/*_labelIds / *_instanceIds   (GT maps)
  <segm_precomputed>/{city}/{name}_leftImg8bit.png    (semantic output)
  <inst_precomputed>/{city}/{name}.png(.json)         (geometric output)
  <normal_dir>/{city}/{name}-normal.png               (geometric output)

Reference quirks kept exactly (cityscapes_dataset.py):
  * all path lists shuffled with random.Random(20) — the same seed gives
    the same permutation per list, which is what keeps them aligned (:25-29);
  * precomputed instance maps are scaled x255 x1000 with background
    pixels filled from the label map (:60-63);
  * a missing instance map falls back to inst = label (:64-65);
  * pose bins digitize alpha/pi over range(-180, 181, 360//num_bins)/180,
    skipping instance 0 and instances smaller than 256 px (:79-91);
  * the normal map gets the +1/255 bias (:99-101);
  * without a precomputed semantic map, raw ids map to trainId + 1
    (255/ignore -> 0) (:104-107).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from sdn3d_tpu_torch.data.cityscapes import LABELS
from sdn3d_tpu_torch.data.textural_data import (
    dense_instance_slots, scale_width, transform_image)

POSE_AREA_MIN = 256          # cityscapes_dataset.py:85


def pose_bins(num_bins: int = 24) -> np.ndarray:
    """cityscapes_dataset.py:81 — bins over [-1, 1] in alpha/pi units."""
    return np.asarray(list(range(-180, 181, 360 // num_bins))) / 180.0


def ids_to_train_ids_shifted(label_ids: np.ndarray) -> np.ndarray:
    """Raw Cityscapes ids -> trainId + 1, ignore (255) -> 0
    (cityscapes_dataset.py:104-107)."""
    out = label_ids.copy()
    for _, lid, tid, _ in LABELS:
        if lid >= 0:
            out[label_ids == lid] = tid + 1 if tid != 255 else 0
    return out


def get_cityscapes_lists(
    root: str, subset: str,
    segm_precomputed: Optional[str] = None,
    inst_precomputed: Optional[str] = None,
    pose_dir: Optional[str] = None,
    normal_dir: Optional[str] = None,
) -> List[Dict[str, Optional[str]]]:
    """Per-item path records from the COCO-style annotations JSON
    (cityscapes_dataset.py:115-138), in the reference's seeded-shuffle
    order."""
    with open(os.path.join(
            root, "annotations",
            f"instancesonly_gtFine_{subset}.json")) as f:
        images = json.load(f)["images"]

    items = []
    for item in images:
        name = item["file_name"]          # city_seq_frame_leftImg8bit.png
        city = name.split("_")[0]
        if segm_precomputed:
            label = os.path.join(segm_precomputed, city, name)
        else:
            label = os.path.join(
                root, "gtFine", subset, city,
                item["seg_file_name"].replace("instance", "label"))
        if inst_precomputed:
            inst = os.path.join(inst_precomputed, city,
                                name.replace("_leftImg8bit", ""))
        else:
            inst = os.path.join(root, "gtFine", subset, city,
                                item["seg_file_name"])
        rec = {
            "label": label,
            "image": os.path.join(root, "images", name),
            "inst": inst,
            "inst_precomputed": bool(inst_precomputed),
            "label_precomputed": bool(segm_precomputed),
            "pose": (os.path.join(
                pose_dir, city, name.replace("_leftImg8bit.png", ".json"))
                if pose_dir else None),
            "normal": (os.path.join(
                normal_dir, city,
                name.replace("_leftImg8bit.png", "-normal.png"))
                if normal_dir else None),
        }
        items.append(rec)

    # The reference shuffles each aligned path list with random.Random(20)
    # (:25-29) — same seed, same length => same permutation, so shuffling
    # the records once is equivalent.
    random.Random(20).shuffle(items)
    return items


class TexturalCityscapesDataset:
    """Cityscapes counterpart of TexturalVKittiDataset: yields the
    label/inst/inst_slots/image/pose/normal conditioning dict for the
    textural trainer and the interactive (ui_model) pipeline."""

    def __init__(self, root: str, subset: str = "train",
                 segm_precomputed: Optional[str] = None,
                 inst_precomputed: Optional[str] = None,
                 pose_dir: Optional[str] = None,
                 normal_dir: Optional[str] = None,
                 load_size: int = 1024,
                 fine_wh: Tuple[int, int] = (1024, 512),
                 pose_num_bins: int = 24, max_instances: int = 64):
        self.items = get_cityscapes_lists(
            root, subset, segm_precomputed, inst_precomputed, pose_dir,
            normal_dir)
        if not self.items:
            raise FileNotFoundError(f"no cityscapes items under {root}")
        self.train = subset == "train"
        self.load_size, self.fine_wh = load_size, fine_wh
        self.bins = pose_bins(pose_num_bins)
        self.max_instances = max_instances

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState(index)
        rec = self.items[index]

        img = Image.open(rec["image"]).convert("RGB")
        # shared random crop/flip across all of the item's maps
        # (get_params semantics, base_dataset.py:21-38)
        sw = scale_width(img, self.load_size, Image.BICUBIC)
        w, h = sw.size
        tw, th = self.fine_wh
        if self.train:
            crop = (rng.randint(0, max(0, w - tw) + 1),
                    rng.randint(0, max(0, h - th) + 1))
            flip = bool(rng.rand() > 0.5)
        else:
            crop = (max(0, w - tw) // 2, max(0, h - th) // 2)
            flip = False

        def t(im, nearest=False, normalize=True):
            return transform_image(im, self.load_size, self.fine_wh,
                                   nearest=nearest, normalize=normalize,
                                   crop_pos=crop, flip=flip)

        image = t(img)
        label = (t(Image.open(rec["label"]), nearest=True,
                   normalize=False) * 255.0).astype(np.int32)[..., 0]

        # instance map (:54-65)
        inst = None
        if os.path.exists(rec["inst"]):
            inst = (t(Image.open(rec["inst"]), nearest=True,
                      normalize=False) * 255.0).astype(np.int32)[..., 0]
            if rec["inst_precomputed"]:
                inst = inst * 1000
                inst = np.where(inst == 0, label, inst)
        if inst is None:
            inst = label.copy()               # FileNotFoundError path

        # pose bins from the geometric JSON (:67-94)
        pose = np.zeros_like(label)
        if rec["pose"] and os.path.exists(rec["pose"]):
            with open(rec["pose"]) as f:
                d = json.load(f)
            pose_inst = (t(Image.open(
                rec["pose"].replace(".json", ".png")), nearest=True,
                normalize=False) * 255.0).astype(np.int32)[..., 0]
            for v in np.unique(pose_inst):
                if v == 0 or (pose_inst == v).sum() < POSE_AREA_MIN:
                    continue
                if str(int(v)) not in d:
                    continue
                alpha = float(d[str(int(v))]["alpha"])
                pose = np.where(pose_inst == v,
                                int(np.digitize(alpha / np.pi, self.bins)),
                                pose)

        # normal conditioning with the +1/255 bias (:96-101)
        if rec["normal"] and os.path.exists(rec["normal"]):
            normal = t(Image.open(rec["normal"]).convert("RGB")) \
                + 1.0 / 255.0
        else:
            normal = np.zeros(image.shape, np.float32)

        # raw ids -> trainId + 1 unless the semantic branch already wrote
        # shifted train ids (:104-107)
        if not rec["label_precomputed"]:
            label = ids_to_train_ids_shifted(label)

        slots, _ = dense_instance_slots(inst, self.max_instances)
        return {
            "label": label,
            "inst": inst,
            "inst_slots": slots,
            "image": image,
            "pose": pose,
            "normal": normal.astype(np.float32),
        }

    def batch(self, rng: np.random.RandomState, batch_size: int
              ) -> Dict[str, np.ndarray]:
        samples = [self.__getitem__(int(rng.randint(len(self))), rng)
                   for _ in range(batch_size)]
        return {k: np.stack([s[k] for s in samples])
                for k in sorted(samples[0])}
