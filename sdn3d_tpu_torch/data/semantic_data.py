"""Semantic-branch sample preparation and constants (host-side numpy).

Counterpart of sdn3d_tpu/data/semantic_data.py, itself a re-expression of
semantic/vkitti_dataset.py:57-163 (TrainDataset) and :213-221 (the eval
sizes): a random short-edge scale from {100,150,200,300,375}, the
max-size cap, colour jitter, a random flip, padding to a multiple of 8,
labels downsampled x8 by nearest and shifted by -1, BGR channel order
with the reference's normalisation.  The random.Random draws come in the
JAX package's order and the float32 arithmetic is its own, so the arrays
are byte-equal.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

TRAIN_SCALES = (100, 150, 200, 300, 375)   # vkitti_train.py imgSize
# Long-edge caps: train 1274 (vkitti_train.py:237), eval 1242
# (vkitti_eval.py:175).  Neither binds on the 375x1242 VKITTI frames.
IMG_MAX_SIZE = 1274
IMG_MAX_SIZE_EVAL = 1242
PADDING_CONSTANT = 8
SEGM_DOWNSAMPLING = 8
# img_transform normalization (semantic/vkitti_dataset.py:43-44): the
# image is flipped to BGR (:152) and then normalized with ImageNet means
# scaled to 0..255 but stds left in 0..1 scale — a reference quirk kept
# verbatim (the mean list stays in RGB order while the image is BGR).
MEAN_BGR = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD_BGR = (0.229, 0.224, 0.225)


def round2nearest_multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p


def resize_shorter_edge(h: int, w: int, short: int,
                        max_size: int = IMG_MAX_SIZE) -> Tuple[int, int]:
    """Scale so the short edge hits `short`, capped so the long edge stays
    <= max_size (vkitti_dataset.py:92-96)."""
    scale = min(short / min(h, w), max_size / max(h, w))
    return int(h * scale), int(w * scale)


def color_jitter(img: np.ndarray, rng: random.Random,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> np.ndarray:
    """ColorJitter-style augmentation (Transforms.color_jitter,
    derender3d/datasets.py:25) on uint8 RGB: brightness, contrast and
    saturation factors drawn in that order."""
    out = img.astype(np.float32)
    b = rng.uniform(1 - brightness, 1 + brightness)
    out = out * b
    c = rng.uniform(1 - contrast, 1 + contrast)
    mean = out.mean()
    out = (out - mean) * c + mean
    s = rng.uniform(1 - saturation, 1 + saturation)
    gray = out.mean(axis=2, keepdims=True)
    out = (out - gray) * s + gray
    return np.clip(out, 0, 255).astype(np.uint8)


def prepare_train_sample(
    rgb: np.ndarray,              # [H, W, 3] uint8
    segm: np.ndarray,             # [H, W] int class ids (raw, >= 0)
    rng: Optional[random.Random] = None,
    scales: Sequence[int] = TRAIN_SCALES,
    flip: bool = True,
    jitter: bool = True,
) -> Dict[str, np.ndarray]:
    """One augmented training sample: image [h8, w8, 3] float32
    (BGR-normalized, zero padding), label [h8/8, w8/8] int32 shifted by -1
    (-1 = ignore)."""
    from PIL import Image

    rng = rng or random.Random()
    if jitter:
        rgb = color_jitter(rgb, rng)
    if flip and rng.random() > 0.5:
        rgb = rgb[:, ::-1]
        segm = segm[:, ::-1]

    short = rng.choice(list(scales))
    nh, nw = resize_shorter_edge(rgb.shape[0], rgb.shape[1], short)
    img = np.asarray(Image.fromarray(rgb).resize((nw, nh), Image.BILINEAR))
    seg = np.asarray(Image.fromarray(segm.astype(np.uint8)).resize(
        (nw, nh), Image.NEAREST))

    ph = round2nearest_multiple(nh, PADDING_CONSTANT)
    pw = round2nearest_multiple(nw, PADDING_CONSTANT)
    seg_pad = np.zeros((ph, pw), np.uint8)
    seg_pad[:nh, :nw] = seg

    # label downsample x8 via nearest (vkitti_dataset.py:143-149)
    seg_small = np.asarray(Image.fromarray(seg_pad).resize(
        (pw // SEGM_DOWNSAMPLING, ph // SEGM_DOWNSAMPLING), Image.NEAREST))
    label = seg_small.astype(np.int32) - 1        # -1 = ignore

    # RGB -> BGR + normalize before padding, so pad pixels are 0 in
    # normalized space like the reference's zero batch canvas
    # (vkitti_dataset.py:108,152-157)
    bgr = img.astype(np.float32)[:, :, ::-1]
    bgr = (bgr - np.asarray(MEAN_BGR, np.float32)) / np.asarray(
        STD_BGR, np.float32)
    img_pad = np.zeros((ph, pw, 3), np.float32)
    img_pad[:nh, :nw] = bgr
    return {"image": img_pad, "label": label}
