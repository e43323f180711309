"""Mask R-CNN inference (FPN + RPN + heads), NCHW, PyTorch port.

PyTorch counterpart of the inference graph of sdn3d_tpu/models/maskrcnn.py
(geometric/maskrcnn/model.py, the torch port of multimask-rcnn).  Every
stage keeps the JAX package's fixed shapes and validity masks (top-k,
padded NMS, masked refinement), with a leading frame axis F: the batched
detector puts N frames through one pass, and a box's frame selects its
feature rows (ops/roi_align.crop_and_resize_flat).  Training
(`train_forward`, the detection targets) waits for the Mask R-CNN trainer.

The backbone is the reference's, not torchvision's: the stride sits on the
1x1 conv1 of each bottleneck, padding is TF "SAME", BatchNorm eps is 1e-3
and convolutions have biases (model.py:210-305).  Module names follow the
reference state_dict (`fpn.C1.0`, `fpn.C2.0.conv1`, ..., `fpn.P2_conv2.1`,
`rpn.conv_*`, `classifier.*`, `mask.*`), which utils/port.py's
maskrcnn_state_dict_from_jax writes from JAX variables.  Images are
mean-subtracted float [F, 3, H, W].

Orders that the JAX package fixes and the port keeps: lax.top_k's
(descending by IEEE total order, +NaN first and -NaN last, ties by index:
`top_k`), jnp.argsort's (stable, NaNs last: ops/nms.nms_padded), jnp.round
(half to even, as torch.round), and the NHWC (y, x, anchor) order of the
RPN's outputs, which generate_pyramid_anchors follows.  Boxes from `exp` of
random deltas may be inf or NaN; every comparison then goes as in JAX
(NaN compares false, max / min propagate it, `* valid` keeps it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdn3d_tpu_torch.models.layers import (BatchNorm2d, Conv2d, ConvTranspose,
                                           Linear, set_compute_dtype)
from sdn3d_tpu_torch.ops.nms import nms_padded
from sdn3d_tpu_torch.ops.roi_align import crop_and_resize_flat
from sdn3d_tpu_torch.utils.transfer import constant

BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# Config (geometric/maskrcnn/config.py:19-183 + vkitti.py:30-41)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    """The JAX package's MaskRCNNConfig: the same fields and defaults."""
    name: str = "vkitti"
    num_classes: int = 3                 # BG + car + van (vkitti.py:36)
    backbone_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    rpn_anchor_scales: Tuple[int, ...] = (32, 64, 128, 256, 512)
    rpn_anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_anchor_stride: int = 1
    rpn_nms_threshold: float = 0.7
    rpn_train_anchors_per_image: int = 256
    pre_nms_limit: int = 6000
    post_nms_rois_training: int = 2000
    post_nms_rois_inference: int = 1000
    image_min_dim: int = 300             # vkitti.py IMAGE_MIN_DIM
    image_max_dim: int = 1024
    mean_pixel: Tuple[float, float, float] = (123.7, 116.8, 103.9)
    train_rois_per_image: int = 200
    roi_positive_ratio: float = 0.33
    pool_size: int = 7
    mask_pool_size: int = 14
    mask_shape: Tuple[int, int] = (28, 28)
    max_gt_instances: int = 100
    rpn_bbox_std_dev: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    bbox_std_dev: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    detection_max_instances: int = 100
    detection_min_confidence: float = 0.7
    detection_nms_threshold: float = 0.3
    fpn_channels: int = 256
    # resnet101 for vkitti (model.py:1445 default "resnet101")
    stage_sizes: Tuple[int, ...] = (3, 4, 23, 3)
    # compute dtype of the convolutions and dense layers ("bfloat16");
    # parameters, BatchNorm and the box math stay float32
    compute_dtype: str = "float32"

    def __post_init__(self):
        # config.py:181-183: the FPN's top-down adds need sizes divisible
        # by 2 six times
        if self.image_max_dim % 64:
            raise ValueError(f"image_max_dim must be a multiple of 64, got "
                             f"{self.image_max_dim}")

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_max_dim, self.image_max_dim, 3)

    @property
    def backbone_shapes(self) -> np.ndarray:
        h, w = self.image_shape[:2]
        return np.array([[int(np.ceil(h / s)), int(np.ceil(w / s))]
                         for s in self.backbone_strides])


# ---------------------------------------------------------------------------
# Anchors (maskrcnn/utils.py:399-458), host numpy, computed once
# ---------------------------------------------------------------------------

def generate_anchors(scales, ratios, shape, feature_stride, anchor_stride
                     ) -> np.ndarray:
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales, ratios = scales.flatten(), ratios.flatten()
    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)
    shifts_y = np.arange(0, shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)
    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)
    box_centers = np.stack([box_centers_y, box_centers_x], 2).reshape(-1, 2)
    box_sizes = np.stack([box_heights, box_widths], 2).reshape(-1, 2)
    return np.concatenate([box_centers - 0.5 * box_sizes,
                           box_centers + 0.5 * box_sizes], 1)


def generate_pyramid_anchors(config: MaskRCNNConfig) -> np.ndarray:
    anchors = [
        generate_anchors(config.rpn_anchor_scales[i],
                         config.rpn_anchor_ratios,
                         config.backbone_shapes[i],
                         config.backbone_strides[i],
                         config.rpn_anchor_stride)
        for i in range(len(config.rpn_anchor_scales))
    ]
    return np.concatenate(anchors, 0).astype(np.float32)


# ---------------------------------------------------------------------------
# Box math (model.py:307-341) and top-k
# ---------------------------------------------------------------------------

def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor
                     ) -> torch.Tensor:
    """boxes, deltas [..., 4] -> boxes [..., 4]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height + deltas[..., 0] * height
    center_x = boxes[..., 1] + 0.5 * width + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])
    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    return torch.stack([y1, x1, y1 + height, x1 + width], dim=-1)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clip boxes [..., N, 4] to window [..., 4] = (y1, x1, y2, x2), each
    coordinate as jnp.clip (max, then min; NaN stays NaN)."""
    lo = torch.cat([window[..., :2], window[..., :2]], -1)[..., None, :]
    hi = torch.cat([window[..., 2:], window[..., 2:]], -1)[..., None, :]
    return torch.minimum(torch.maximum(boxes, lo), hi)


def _hwhw(config: MaskRCNNConfig, device) -> torch.Tensor:
    """(h, w, h, w) of the molded image, float32 on `device`."""
    h, w = config.image_shape[:2]
    return constant((float(h), float(w), float(h), float(w)), torch.float32,
                    device)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over the last axis of float32 `x`: descending by IEEE
    total order (+NaN > +inf > ... > -inf > -NaN, -0 < +0), ties by index."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


# ---------------------------------------------------------------------------
# Backbone + FPN (model.py:148-305)
# ---------------------------------------------------------------------------

class SamePad2d(nn.Module):
    """TF "SAME" padding of a (kernel, stride) window: the odd pixel on the
    high side (flax's padding="SAME"; the reference's SamePad2d), filled
    with `value`."""

    def __init__(self, kernel: int, stride: int, value: float = 0.0):
        super().__init__()
        self.kernel, self.stride, self.value = kernel, stride, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size in (x.shape[3], x.shape[2]):
            out = -(-size // self.stride)
            total = max((out - 1) * self.stride + self.kernel - size, 0)
            pads += [total // 2, total - total // 2]
        return F.pad(x, pads, value=self.value)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=0.01)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: stride on the 1x1 conv1 (model.py:210-247);
    the downsample branch where the shapes differ (a stage's first
    block)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, stride=stride)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if stride != 1 or in_ch != planes * 4:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, planes * 4, 1, stride=stride), _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


def _up2(t: torch.Tensor) -> torch.Tensor:
    """Nearest 2x repeat along H and W (jnp.repeat twice)."""
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    """ResNet bottom-up (C1: 7x7 stem, BN, ReLU, 3x3 stride-2 SAME max
    pool, which pads the high side only) and the top-down pyramid P2..P6
    (model.py:148-305)."""

    def __init__(self, out_channels: int = 256,
                 stage_sizes: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.C1 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3), _bn(64), nn.ReLU(),
            SamePad2d(3, 2, value=-math.inf), nn.MaxPool2d(3, stride=2))
        in_ch = 64
        for i, (blocks, planes) in enumerate(zip(stage_sizes,
                                                 (64, 128, 256, 512))):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(in_ch, planes,
                                        (1 if i == 0 else 2) if j == 0 else 1))
                in_ch = planes * 4
            setattr(self, f"C{i + 2}", nn.Sequential(*layer))
        for k, ch in zip((5, 4, 3, 2), (2048, 1024, 512, 256)):
            setattr(self, f"P{k}_conv1", Conv2d(ch, out_channels, 1))
            setattr(self, f"P{k}_conv2", nn.Sequential(
                SamePad2d(3, 1), Conv2d(out_channels, out_channels, 3)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c1 = self.C1(x)
        c2 = self.C2(c1)
        c3 = self.C3(c2)
        c4 = self.C4(c3)
        c5 = self.C5(c4)
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + _up2(p5)
        p3 = self.P3_conv1(c3) + _up2(p4)
        p2 = self.P2_conv1(c2) + _up2(p3)
        p5 = self.P5_conv2(p5)
        p4 = self.P4_conv2(p4)
        p3 = self.P3_conv2(p3)
        p2 = self.P2_conv2(p2)
        # P6: stride-2 subsample of P5 (MaxPool2d(kernel=1, stride=2))
        return [p2, p3, p4, p5, p5[:, :, ::2, ::2]]


class RPNHead(nn.Module):
    """Shared RPN head (model.py:862-913).  Its outputs are reshaped in
    NHWC order, (y, x, anchor), as the anchors are generated."""

    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 depth: int = 256):
        super().__init__()
        self.conv_shared = Conv2d(depth, 512, 3, stride=anchor_stride,
                                  padding=1)
        self.conv_class = Conv2d(512, 2 * anchors_per_location, 1)
        self.conv_bbox = Conv2d(512, 4 * anchors_per_location, 1)

    def forward(self, x: torch.Tensor):
        shared = torch.relu(self.conv_shared(x))
        B = x.shape[0]
        logits = self.conv_class(shared).permute(0, 2, 3, 1).reshape(
            B, -1, 2).float()
        bbox = self.conv_bbox(shared).permute(0, 2, 3, 1).reshape(
            B, -1, 4).float()
        return logits, torch.softmax(logits, dim=2), bbox


# ---------------------------------------------------------------------------
# Proposal layer (model.py:344-407), fixed shapes
# ---------------------------------------------------------------------------

def proposal_boxes(rpn_probs: torch.Tensor, rpn_bbox: torch.Tensor,
                   anchors: torch.Tensor, config: MaskRCNNConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposal layer's NMS input: the pre_nms_limit best anchors by
    RPN score, moved by their deltas and clipped to the molded image.
    rpn_probs [F, A, 2], rpn_bbox [F, A, 4], anchors [A, 4] (pixels) ->
    (boxes [F, pre, 4] in pixels, scores [F, pre], descending)."""
    dev = rpn_bbox.device
    deltas = rpn_bbox * constant(config.rpn_bbox_std_dev, torch.float32, dev)
    pre = min(config.pre_nms_limit, anchors.shape[0])
    top_scores, order = top_k(rpn_probs[..., 1], pre)      # [F, pre]
    top_deltas = torch.gather(deltas, 1, order[..., None].expand(-1, -1, 4))
    boxes = apply_box_deltas(anchors[order], top_deltas)
    h, w = config.image_shape[:2]
    boxes = clip_boxes(boxes, constant((0.0, 0.0, float(h), float(w)),
                                       torch.float32, dev))
    return boxes, top_scores


def proposal_layer(rpn_probs: torch.Tensor, rpn_bbox: torch.Tensor,
                   anchors: torch.Tensor, config: MaskRCNNConfig,
                   proposal_count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """rpn_probs [F, A, 2], rpn_bbox [F, A, 4], anchors [A, 4] (pixels) ->
    (proposals [F, proposal_count, 4] normalised, valid [F, count])."""
    boxes, top_scores = proposal_boxes(rpn_probs, rpn_bbox, anchors, config)
    keep_idx, keep_valid = nms_padded(boxes, top_scores,
                                      config.rpn_nms_threshold,
                                      proposal_count)
    props = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    props = props / _hwhw(config, boxes.device) * keep_valid[..., None]
    return props, keep_valid


# ---------------------------------------------------------------------------
# Pyramid ROI align (model.py:414-502)
# ---------------------------------------------------------------------------

class RoiFeatures:
    """P2..P5 ([F, C, h, w] each) as one channels-last row table, shared
    by the classifier and the mask head: a box of frame f at level l reads
    the rows that start at offsets[l, f]."""

    def __init__(self, feature_maps: Sequence[torch.Tensor]):
        rows, offsets, shapes, start = [], [], [], 0
        for p in feature_maps:
            Fr, C, h, w = p.shape
            rows.append(p.permute(0, 2, 3, 1).reshape(Fr * h * w, C))
            offsets.append([start + f * h * w for f in range(Fr)])
            shapes.append((h, w))
            start += Fr * h * w
        dev = feature_maps[0].device
        self.table = torch.cat(rows)
        self.offsets = constant(tuple(map(tuple, offsets)), torch.long, dev)
        self.shapes = constant(tuple(shapes), torch.long, dev)


def roi_levels(boxes: torch.Tensor, image_shape) -> torch.Tensor:
    """The pyramid level (2..5) of each normalised box [..., 4]
    (model.py:414-502)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    image_area = float(image_shape[0] * image_shape[1])
    level = 4 + torch.log2(torch.sqrt(torch.clamp(h * w, min=1e-12))
                           / (224.0 / np.sqrt(image_area)))
    return torch.round(level).clamp(2, 5).long()


def pyramid_roi_align(boxes: torch.Tensor, feats: RoiFeatures,
                      pool_size: int, image_shape) -> torch.Tensor:
    """boxes [F, N, 4] normalised -> crops [F * N, C, pool, pool], each box
    cropped from its own level of its own frame (the JAX package crops it
    at every level and keeps its own: the same values)."""
    Fr, N = boxes.shape[:2]
    lvl = roi_levels(boxes, image_shape).reshape(-1) - 2       # [F * N]
    frame = torch.arange(Fr, device=boxes.device).repeat_interleave(N)
    shape = feats.shapes[lvl]
    crops = crop_and_resize_flat(feats.table, feats.offsets[lvl, frame],
                                 shape[:, 0], shape[:, 1],
                                 boxes.reshape(-1, 4), (pool_size, pool_size))
    return crops.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Heads (model.py:920-997)
# ---------------------------------------------------------------------------

class Classifier(nn.Module):
    def __init__(self, depth: int = 256, pool_size: int = 7,
                 num_classes: int = 3, image_shape=(1024, 1024, 3)):
        super().__init__()
        self.pool_size, self.num_classes = pool_size, num_classes
        self.image_shape = image_shape
        self.conv1 = Conv2d(depth, 1024, pool_size)
        self.bn1 = _bn(1024)
        self.conv2 = Conv2d(1024, 1024, 1)
        self.bn2 = _bn(1024)
        self.linear_class = Linear(1024, num_classes)
        self.linear_bbox = Linear(1024, num_classes * 4)

    def forward(self, feats: RoiFeatures, rois: torch.Tensor):
        """rois [F, N, 4] -> (logits, probs [F, N, C], deltas
        [F, N, C, 4]), float32."""
        Fr, N = rois.shape[:2]
        x = pyramid_roi_align(rois, feats, self.pool_size, self.image_shape)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = x.reshape(-1, 1024)
        logits = self.linear_class(x).float().reshape(Fr, N, -1)
        bbox = self.linear_bbox(x).float().reshape(Fr, N, self.num_classes, 4)
        return logits, torch.softmax(logits, dim=2), bbox


class MaskHead(nn.Module):
    def __init__(self, depth: int = 256, pool_size: int = 14,
                 num_classes: int = 3, image_shape=(1024, 1024, 3)):
        super().__init__()
        self.pool_size, self.image_shape = pool_size, image_shape
        for k in range(1, 5):
            setattr(self, f"conv{k}", Conv2d(depth if k == 1 else 256, 256, 3,
                                             padding=1))
            setattr(self, f"bn{k}", _bn(256))
        # torch ConvTranspose2d semantics (JAX: transpose_kernel=True),
        # computed as a forward convolution of the dilated input
        self.deconv = ConvTranspose(256, 256, 2, stride=2)
        self.conv5 = Conv2d(256, num_classes, 1)

    def forward(self, feats: RoiFeatures, rois: torch.Tensor) -> torch.Tensor:
        """rois [F, N, 4] -> sigmoid masks [F, N, C, 2 * pool, 2 * pool]."""
        Fr, N = rois.shape[:2]
        x = pyramid_roi_align(rois, feats, self.pool_size, self.image_shape)
        for k in range(1, 5):
            conv, bn = getattr(self, f"conv{k}"), getattr(self, f"bn{k}")
            x = torch.relu(bn(conv(x)))
        x = torch.relu(self.deconv(x))
        x = torch.sigmoid(self.conv5(x).float())
        return x.reshape(Fr, N, *x.shape[1:])


# ---------------------------------------------------------------------------
# Detection refinement (model.py:744-838), fixed shapes
# ---------------------------------------------------------------------------

def refine_detections(rois: torch.Tensor, probs: torch.Tensor,
                      deltas: torch.Tensor, window: torch.Tensor,
                      roi_valid: torch.Tensor, config: MaskRCNNConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rois [F, N, 4] normalised, probs [F, N, C], deltas [F, N, C, 4],
    window [F, 4] (pixels of the molded frame), roi_valid [F, N] ->
    (detections [F, D, 6] = (y1, x1, y2, x2, class_id, score) in pixels,
    valid [F, D])."""
    Fr, N, C = probs.shape
    class_ids = torch.argmax(probs, dim=2)                     # [F, N]
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    deltas_specific = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]

    # reference quirk kept: the head's deltas scale by RPN_BBOX_STD_DEV
    # (model.py:772), the same values as BBOX_STD_DEV by default
    dev = rois.device
    std = constant(config.rpn_bbox_std_dev, torch.float32, dev)
    refined = apply_box_deltas(rois, deltas_specific * std)
    refined = torch.round(clip_boxes(refined * _hwhw(config, dev), window))

    keep = (class_ids > 0) & roi_valid
    if config.detection_min_confidence:
        keep = keep & (class_scores >= config.detection_min_confidence)

    # per-class NMS over the (few) foreground classes
    nms_keep = torch.zeros_like(keep)
    for c in range(1, C):
        in_class = keep & (class_ids == c)
        scores_c = torch.where(in_class, class_scores, -1.0)
        kidx, kvalid = nms_padded(refined, scores_c,
                                  config.detection_nms_threshold,
                                  min(config.detection_max_instances, N),
                                  valid=in_class)
        # scatter-max of the kept flags (padding entries carry False)
        hits = torch.zeros(Fr, N, dtype=torch.int32, device=rois.device)
        hits = hits.scatter_reduce(1, kidx, kvalid.int(), "amax") > 0
        nms_keep = nms_keep | (hits & in_class)
    keep = keep & nms_keep

    masked_scores = torch.where(keep, class_scores, -math.inf)
    top_scores, top_idx = top_k(masked_scores,
                                config.detection_max_instances)
    valid = torch.isfinite(top_scores)
    dets = torch.cat([
        torch.gather(refined, 1, top_idx[..., None].expand(-1, -1, 4)),
        torch.gather(class_ids, 1, top_idx)[..., None].float(),
        torch.gather(class_scores, 1, top_idx)[..., None]], dim=2)
    return dets * valid[..., None], valid


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class MaskRCNN(nn.Module):
    """Inference graph (model.py:1705-1781, 'inference' mode) over F
    frames at once (the reference's own limit was 1, model.py:358)."""

    def __init__(self, config: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        cfg = self.config = config
        self.fpn = FPN(cfg.fpn_channels, cfg.stage_sizes)
        self.rpn = RPNHead(len(cfg.rpn_anchor_ratios), cfg.rpn_anchor_stride,
                           cfg.fpn_channels)
        self.classifier = Classifier(cfg.fpn_channels, cfg.pool_size,
                                     cfg.num_classes, cfg.image_shape)
        self.mask = MaskHead(cfg.fpn_channels, cfg.mask_pool_size,
                             cfg.num_classes, cfg.image_shape)
        set_compute_dtype(self, cfg.compute_dtype)

    def forward(self, images: torch.Tensor, anchors: torch.Tensor,
                windows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [F, 3, H, W] mean-subtracted, anchors [A, 4] (pixels),
        windows [F, 4] -> rpn_class_logits [F, A, 2], rpn_bbox [F, A, 4],
        proposals [F, P, 4], proposal_valid [F, P], detections [F, D, 6],
        det_valid [F, D], masks [F, D, num_classes, mh, mw] (per-roi
        sigmoid masks; the class is chosen and unmolded on the host)."""
        cfg = self.config
        if images.is_cuda:
            from sdn3d_tpu_torch.models.derenderer import strict_fp32
            strict_fp32()
        pyramid = self.fpn(images)
        rpn_logits, rpn_probs, rpn_bbox = self.rpn_forward(pyramid)
        proposals, prop_valid = proposal_layer(
            rpn_probs, rpn_bbox, anchors, cfg, cfg.post_nms_rois_inference)
        feats = RoiFeatures(pyramid[:4])                       # P2..P5
        _, mrcnn_probs, mrcnn_bbox = self.classifier(feats, proposals)
        detections, det_valid = refine_detections(
            proposals, mrcnn_probs, mrcnn_bbox, windows, prop_valid, cfg)
        det_boxes = detections[..., :4] / _hwhw(cfg, images.device)
        masks = self.mask(feats, det_boxes)
        return {"rpn_class_logits": rpn_logits, "rpn_bbox": rpn_bbox,
                "proposals": proposals, "proposal_valid": prop_valid,
                "detections": detections, "det_valid": det_valid,
                "masks": masks}

    def rpn_forward(self, feature_maps: Sequence[torch.Tensor]):
        """The shared RPN over every level, concatenated along the anchor
        axis (model.py:1731-1745): (logits, probs, bbox) [F, A, .]."""
        outs = [self.rpn(p) for p in feature_maps]
        return tuple(torch.cat(t, dim=1) for t in zip(*outs))


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at +-2 standard
    deviations, scaled so its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights drawn as the JAX package's MaskRCNN.init draws them
    (lecun-normal kernels, zero biases, BatchNorm scale 1, bias 0, mean 0,
    var 1), from a torch.Generator seeded with `seed` on the CPU (the
    global generator is untouched).  Returns `model`."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, (Conv2d, Linear, ConvTranspose)):
            # fan-in: in * kh * kw ([out, in, kh, kw]), in ([out, in]), and
            # for the transposed kernel ([in, out, kh, kw]) out * kh * kw,
            # as flax's transpose_kernel layout counts it
            w = torch.empty(m.weight.shape)
            _lecun_normal_(w, m.weight[0].numel(), g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return model
