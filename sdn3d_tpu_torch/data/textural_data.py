"""Textural-branch data assembly (host-side numpy).

Copy of sdn3d_tpu/data/textural_data.py: textural/data/base_dataset.py
(scale-width/crop/flip transforms, the 188->192 hack),
textural/data/vkitti_dataset.py:40-148 (the training dataset: label /
inst / pose / normal / depth assembly, colour jitter) and the edit-time
assembly of textural/edit_vkitti.py:41-107 (the instance codes splatted
from the source's).  PIL and numpy calls are made in the JAX module's
order from the same RandomState, so every array equals its own.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

POSE_BINS = np.array(list(range(-180, 181, 360 // 24))) / 180.0
# an edited object's label id by its JSON class_id (car 2, van 12; else 2)
CLASS_LABEL = {1: 2, 2: 12}


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
                    nearest: bool = False, normalize: bool = True,
                    crop_pos: Optional[Tuple[int, int]] = None,
                    flip: bool = False) -> np.ndarray:
    """scale_width -> crop -> flip -> float [C-last]; get_transform for
    'scale_width_and_crop' (base_dataset.py:40-66), the centre crop unless
    `crop_pos` is given.

    Returns [H, W, C] float32; normalize maps to [-1, 1]."""
    method = Image.NEAREST if nearest else Image.BICUBIC
    img = scale_width(img, load_size, method)
    w, h = img.size
    tw, th = fine_wh
    if crop_pos is None:
        crop_pos = (max(0, w - tw) // 2, max(0, h - th) // 2)
    if w > tw or h > th:
        img = img.crop((crop_pos[0], crop_pos[1],
                        crop_pos[0] + tw, crop_pos[1] + th))
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
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
        segm = np.where(sel, CLASS_LABEL.get(class_id, 2), segm)
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
        out["normal"] = condition_normal(normal_png)
    if depth_png is not None:
        out["depth"] = 1.0 - depth_png.astype(np.float32) / 65535.0
    return out


def condition_normal(normal_png: np.ndarray) -> np.ndarray:
    """The normal map's conditioning [H, W, 3] float32 from its PNG values:
    normalised to [-1, 1] plus the reference's 1/255 bias
    (edit_vkitti.py:93)."""
    return (normal_png.astype(np.float32) / 255.0 - 0.5) / 0.5 + 1.0 / 255.0


def assemble_train_maps(
    segm_png: np.ndarray,         # [H, W] precomputed label map (raw ids)
    inst_png: np.ndarray,         # [H, W] instance map (object idx, 0 = bg)
    json_obj: Dict[str, dict],    # per-object {class_id, alpha}
    normal_png: Optional[np.ndarray] = None,
    depth_png: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """TRAIN-time conditioning (vkitti_dataset.py:53-138).  Differs from
    the edit path (assemble_condition_maps): car/van labels are removed
    only where inst == 0 (uninstanced pixels keep their semantic label),
    and instance pixels are NOT relabeled from the json class ids."""
    segm = segm_png.astype(np.int32) + 1        # precomputed shift (:60)
    inst = inst_png.astype(np.int32)
    inst_scaled = inst * 1000
    # remove original cars/vans ONLY where no instance covers them (:78-79)
    bg = inst_scaled == 0
    segm = np.where(bg & (segm == 2), 5, segm)
    segm = np.where(bg & (segm == 12), 5, segm)
    inst_full = np.where(bg, segm, inst_scaled)  # bg fill (:80)

    # pose from the RAW instance indices against the json keys (:96-117)
    pose = np.zeros_like(segm)
    for k_str, v in json_obj.items():
        sel = inst == int(k_str)
        pose = np.where(sel, int(np.digitize(float(v["alpha"]) / np.pi,
                                             POSE_BINS)), pose)

    out = {
        "label": segm.astype(np.int32),
        "inst": inst_full.astype(np.int32),
        "pose": pose.astype(np.int32),
    }
    if normal_png is not None:
        out["normal"] = (normal_png.astype(np.float32) / 255.0 - 0.5) / 0.5 \
            + 1.0 / 255.0                       # bias (:125)
    if depth_png is not None:
        out["depth"] = 1.0 - depth_png.astype(np.float32) / 65535.0
    return out


def color_jitter(img: Image.Image, rng: np.random.RandomState,
                 brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1) -> Image.Image:
    """Train-time photometric augmentation
    (vkitti_dataset.py:39-41: ColorJitter(0.1, 0.1, 0.1, 0.05)).
    Random brightness/contrast/saturation factors via PIL enhancers;
    the reference's tiny hue jitter (0.05) is omitted — distributional
    augmentation, not a deterministic parity surface."""
    from PIL import ImageEnhance

    img = ImageEnhance.Brightness(img).enhance(
        1.0 + rng.uniform(-brightness, brightness))
    img = ImageEnhance.Contrast(img).enhance(
        1.0 + rng.uniform(-contrast, contrast))
    img = ImageEnhance.Color(img).enhance(
        1.0 + rng.uniform(-saturation, saturation))
    return img


class TexturalVKittiDataset:
    """Training dataset over the reference's precomputed-directory layout
    (textural/README.md Train, data/vkitti_dataset.py): per split frame
    `world/topic/#####.png`,
      image  <- data_root/vkitti_1.3.1_rgb/<rel>       (jitter when train)
      label  <- segm_dir/<rel>        (semantic-branch output, +1 shift)
      inst   <- geo_dir/<rel>         (geometric-branch instance map)
      pose   <- geo_dir/<rel .json>   (alpha -> 24 bins over inst)
      normal <- geo_dir/<rel -normal.png>
      depth  <- geo_dir/<rel -depth.png>   (only when present)
    Frames missing the rgb or segm file are skipped (tiny fixtures);
    a missing geo instance map falls back to inst = label
    (vkitti_dataset.py:87-89 FileNotFoundError path).
    """

    def __init__(self, data_root: str, segm_dir: str, geo_dir: str,
                 split: str = "train", load_size: int = 624,
                 fine_wh: Tuple[int, int] = (624, 192),
                 max_instances: int = 64, augment: bool = True):
        import os

        from sdn3d_tpu_torch.data.vkitti import (SCENE_IDS, SPLIT_RANGES,
                                                 WORLD_IDS)

        self.data_root, self.segm_dir, self.geo_dir = (data_root, segm_dir,
                                                       geo_dir)
        self.load_size, self.fine_wh = load_size, fine_wh
        self.max_instances = max_instances
        self.train = split == "train"
        self.augment = augment and self.train
        self.rels = []
        for wi, world in enumerate(WORLD_IDS):
            for topic in SCENE_IDS:
                for frame in SPLIT_RANGES[split][wi]:
                    rel = f"{world}/{topic}/{frame:05d}.png"
                    if (os.path.exists(os.path.join(
                            data_root, "vkitti_1.3.1_rgb", rel))
                            and os.path.exists(os.path.join(segm_dir, rel))):
                        self.rels.append(rel)
        if not self.rels:
            raise FileNotFoundError(
                f"no frames with rgb+segm under {data_root} / {segm_dir}")
        # Depth conditioning is a dataset-level property: decided per
        # frame, the 'depth' key would come and go between batches (and
        # feat_depth=True would fail on a batch without it).
        self.with_depth = all(os.path.exists(os.path.join(
            geo_dir, rel.replace(".png", "-depth.png")))
            for rel in self.rels)

    def __len__(self):
        return len(self.rels)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, np.ndarray]:
        import json as _json
        import os

        rng = rng or np.random.RandomState(index)
        rel = self.rels[index]
        img = Image.open(os.path.join(
            self.data_root, "vkitti_1.3.1_rgb", rel)).convert("RGB")
        if self.augment:
            img = color_jitter(img, rng)

        # shared random crop/flip across every map (get_params, :31-38)
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
        segm = (t(Image.open(os.path.join(self.segm_dir, rel)),
                  nearest=True, normalize=False)
                * 255.0).astype(np.int32)[..., 0]

        inst_path = os.path.join(self.geo_dir, rel)
        inst = None
        if os.path.exists(inst_path):
            inst = (t(Image.open(inst_path), nearest=True, normalize=False)
                    * 255.0).astype(np.int32)[..., 0]
        json_path = inst_path.replace(".png", ".json")
        json_obj = {}
        if os.path.exists(json_path):
            with open(json_path) as f:
                json_obj = _json.load(f)
        normal = None
        npath = inst_path.replace(".png", "-normal.png")
        if os.path.exists(npath):
            normal = t(Image.open(npath).convert("RGB"),
                       normalize=False) * 255.0
        depth = None
        dpath = inst_path.replace(".png", "-depth.png")
        if self.with_depth and os.path.exists(dpath):
            # I;16 PNG: transform_image's /255 is undone to recover the
            # raw uint16 values save_outputs wrote (clip(d,0,1)*65535)
            depth = (t(Image.open(dpath), nearest=True, normalize=False)
                     * 255.0).astype(np.float32)[..., 0]

        maps = assemble_train_maps(
            segm, inst if inst is not None else np.zeros_like(segm),
            json_obj, normal, depth)
        if inst is None:
            # FileNotFoundError fallback (vkitti_dataset.py:87-88):
            # inst = the (+1-shifted) label tensor, and the label keeps
            # its car/van ids (the reference raises before the
            # 2/12 -> 5 remap)
            shifted = (segm.astype(np.int32) + 1)
            maps["label"] = shifted
            maps["inst"] = shifted
        slots, _ = dense_instance_slots(maps["inst"], self.max_instances)
        out = {
            "label": maps["label"],
            "inst": maps["inst"],
            "inst_slots": slots,
            "image": image,
            "pose": maps["pose"],
            "normal": maps.get(
                "normal", np.zeros(image.shape, np.float32)),
        }
        if "depth" in maps:
            out["depth"] = maps["depth"]
        return out

    def batch(self, rng: np.random.RandomState, batch_size: int
              ) -> Dict[str, np.ndarray]:
        """Stack batch_size random samples (train.py's loader step)."""
        samples = [self.__getitem__(int(rng.randint(len(self))), rng)
                   for _ in range(batch_size)]
        keys = set(samples[0])
        for s in samples[1:]:
            keys &= set(s)
        return {k: np.stack([s[k] for s in samples]) for k in sorted(keys)}


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


def splat_feat_codes(inst: np.ndarray, feat_dict: Dict[int, np.ndarray],
                     feat_num: int = 5) -> np.ndarray:
    """Per-pixel feat map from per-instance codes (edit_vkitti.py:99-105).
    Unknown ids get zeros."""
    H, W = inst.shape
    out = np.zeros((H, W, feat_num), np.float32)
    for inst_id, code in feat_dict.items():
        out[inst == inst_id] = np.asarray(code, np.float32)
    return out
