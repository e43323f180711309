"""Mask R-CNN training examples (load_image_gt), PyTorch port.

Counterpart of sdn3d_tpu/data/detect_data.py (maskrcnn/model.py:1154-1212
load_image_gt: resize, box extraction, mini-masks; utils.py:338-373
minimize_mask; the VKITTI driver's instance decoding, maskrcnn/
vkitti.py:83-102; the Cityscapes driver, maskrcnn/cityscapes.py).  All of
it is host numpy and PIL producing fixed-shape examples, byte for byte the
JAX package's under the same numpy draws: the RPN targets' balance and the
max_gt subsample draw from `rng`, or from the global np.random as the JAX
package's datasets do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig
from sdn3d_tpu_torch.models.maskrcnn_train import build_rpn_targets
from sdn3d_tpu_torch.pipelines.detect import resize_image


def minimize_mask(mask: np.ndarray, box, mini_shape: Tuple[int, int]
                  ) -> np.ndarray:
    """A full-size mask cropped to its (pixel) box and resized to
    mini_shape (utils.py:338-356): PIL's bilinear resize of the 0/255 mask,
    then a threshold at >= 128 (the reference's scipy.misc.imresize and
    np.where(m >= 128, 1, 0)).  float32 0/1."""
    from PIL import Image

    y1, x1, y2, x2 = [int(round(v)) for v in box]
    crop = mask[y1:y2, x1:x2]
    if crop.size == 0:
        return np.zeros(mini_shape, np.float32)
    img = Image.fromarray((crop > 0.5).astype(np.uint8) * 255)
    out = np.asarray(img.resize(mini_shape[::-1], Image.BILINEAR))
    return (out >= 128).astype(np.float32)


def mold_gt_example(image: np.ndarray, class_ids: np.ndarray,
                    masks: np.ndarray, config: MaskRCNNConfig,
                    anchors: np.ndarray,
                    mini_shape: Tuple[int, int] = (56, 56),
                    max_gt: Optional[int] = None,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, np.ndarray]:
    """(image [H, W, 3] uint8 / float, class_ids [N], masks [N, H, W]) ->
    a fixed-shape training example:

      image        [H', W', 3] float32, molded (resized, padded, mean off)
      rpn_match    [A] int32, rpn_bbox [train_anchors, 4] float32
      gt_class_ids [max_gt] int32, gt_boxes [max_gt, 4] normalised,
      gt_masks     [max_gt, mh, mw] mini-masks in each box's own frame

    The RPN targets come from the FULL GT set, before the max_gt
    subsample (model.py:1384-1394): anchors over instances dropped from
    the head arrays stay positives."""
    if max_gt is None:
        max_gt = config.max_gt_instances
    # resize_image goes through PIL, which needs uint8 for RGB
    molded, window, scale = resize_image(
        np.clip(image, 0, 255).astype(np.uint8), config.image_min_dim,
        config.image_max_dim)
    molded = molded.astype(np.float32) - np.asarray(config.mean_pixel,
                                                    np.float32)
    H, W = molded.shape[:2]
    oy, ox = window[0], window[1]

    boxes_px, ids, minis = [], [], []
    for i in range(len(class_ids)):
        m = masks[i]
        ys, xs = np.nonzero(m > 0.5)
        if len(ys) == 0:
            continue
        # the box in molded-image pixels
        boxes_px.append(np.asarray(
            [ys.min() * scale + oy, xs.min() * scale + ox,
             (ys.max() + 1) * scale + oy, (xs.max() + 1) * scale + ox],
            np.float32))
        ids.append(class_ids[i])
        minis.append(minimize_mask(
            m, [ys.min(), xs.min(), ys.max() + 1, xs.max() + 1],
            mini_shape))

    bpx_all = (np.stack(boxes_px) if boxes_px
               else np.zeros((0, 4), np.float32))
    rpn_match, rpn_bbox = build_rpn_targets(anchors, bpx_all, config,
                                            rng=rng)

    # head arrays: a random subsample past max_gt (model.py:1388-1394),
    # zero-padded to fixed shapes
    keep = np.arange(len(ids))
    if len(ids) > max_gt:
        keep = (rng or np.random).choice(len(ids), max_gt, replace=False)
    n = len(keep)
    gt_ids = np.zeros((max_gt,), np.int32)
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_masks = np.zeros((max_gt,) + tuple(mini_shape), np.float32)
    if n:
        gt_ids[:n] = np.asarray(ids, np.int32)[keep]
        gt_boxes[:n] = bpx_all[keep] / np.asarray([H, W, H, W], np.float32)
        gt_masks[:n] = np.stack(minis)[keep]
    return {
        "image": molded.astype(np.float32),
        "rpn_match": rpn_match.astype(np.int32),
        "rpn_bbox": rpn_bbox.astype(np.float32),
        "gt_class_ids": gt_ids,
        "gt_boxes": gt_boxes,
        "gt_masks": gt_masks,
    }


def synthetic_detect_example(config: MaskRCNNConfig, anchors: np.ndarray,
                             seed: int = 0,
                             mini_shape: Tuple[int, int] = (56, 56)
                             ) -> Dict[str, np.ndarray]:
    """Random boxes painted as rectangles on a random frame (the CLI's
    synthetic mode): the frame and boxes from RandomState(seed), the RPN
    balance from the global np.random."""
    rng = np.random.RandomState(seed)
    H = W = config.image_max_dim
    img = rng.rand(H, W, 3).astype(np.float32) * 255.0
    n = rng.randint(1, 4)
    masks, ids = [], []
    for _ in range(n):
        y1, x1 = rng.randint(0, H - 40), rng.randint(0, W - 40)
        h, w = rng.randint(20, H - y1), rng.randint(20, W - x1)
        m = np.zeros((H, W), np.float32)
        m[y1:y1 + h, x1:x1 + w] = 1.0
        masks.append(m)
        ids.append(rng.randint(1, config.num_classes))
    return mold_gt_example(img, np.asarray(ids, np.int32),
                           np.stack(masks), config, anchors, mini_shape)


@dataclasses.dataclass
class VKittiDetectDataset:
    """VKITTI Mask R-CNN training frames (maskrcnn/vkitti.py:43-124): car
    and van instances of the scenegt map with area > 50 px, classes
    {1: car, 2: van} (NUM_CLASSES = 3); the frames of the split whose RGB
    and scenegt files both exist under `root`."""

    root: str
    config: MaskRCNNConfig
    anchors: np.ndarray
    split: str = "train"
    mini_shape: Tuple[int, int] = (56, 56)

    def __post_init__(self):
        from sdn3d_tpu_torch.data import vkitti as VK
        self._vk = VK
        self.table_inst = VK.get_tables("inst", self.root)
        self.frames: List[Tuple[str, str, int]] = []
        for rel in VK.get_lists(self.split):
            world, topic, name = rel.split("/")
            frame = int(name[:-4])
            if (os.path.exists(VK.rgb_path(self.root, world, topic, frame))
                    and os.path.exists(VK.scenegt_path(
                        self.root, world, topic, frame))):
                self.frames.append((world, topic, frame))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image
        world, topic, frame = self.frames[i]
        img = np.asarray(
            Image.open(self._vk.rgb_path(self.root, world, topic, frame))
            .convert("RGB"))
        ids, masks, _ = self._vk.gt_objects(self.root, world, topic, frame,
                                            self.table_inst)
        return mold_gt_example(img, ids, masks[:, 0], self.config,
                               self.anchors, self.mini_shape)


@dataclasses.dataclass
class CityscapesDetectDataset:
    """Cityscapes car instances from *_gtFine_instanceIds.png
    (maskrcnn/cityscapes.py: cars only, area > 50 px, NUM_CLASSES = 2)."""

    root: str
    config: MaskRCNNConfig
    anchors: np.ndarray
    split: str = "train"
    mini_shape: Tuple[int, int] = (56, 56)

    def __post_init__(self):
        img_root = os.path.join(self.root, "leftImg8bit", self.split)
        self.items: List[Tuple[str, str]] = []
        for city in sorted(os.listdir(img_root)):
            for f in sorted(os.listdir(os.path.join(img_root, city))):
                if not f.endswith("_leftImg8bit.png"):
                    continue
                stem = f[:-len("_leftImg8bit.png")]
                inst = os.path.join(self.root, "gtFine", self.split, city,
                                    stem + "_gtFine_instanceIds.png")
                if os.path.exists(inst):
                    self.items.append(
                        (os.path.join(img_root, city, f), inst))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        from sdn3d_tpu_torch.data.cityscapes import (car_instances,
                                                     instance_mask)
        img_path, inst_path = self.items[i]
        img = np.asarray(Image.open(img_path).convert("RGB"))
        inst = np.asarray(Image.open(inst_path)).astype(np.int32)
        ids, masks = [], []
        for iid in car_instances(inst):
            m = instance_mask(inst, iid).astype(np.float32)
            if m.sum() <= 50:
                continue
            ids.append(1)
            masks.append(m)
        if not ids:
            ids = np.zeros((0,), np.int32)
            masks = np.zeros((0,) + inst.shape, np.float32)
        else:
            ids = np.asarray(ids, np.int32)
            masks = np.stack(masks)
        return mold_gt_example(img, ids, masks, self.config, self.anchors,
                               self.mini_shape)
