"""Plain Mask R-CNN inference for one frame: the benchmark's reference for
the edit chain's detector.

Mask R-CNN (He, Gkioxari, Dollar, Girshick, ICCV 2017, arXiv:1703.06870)
with the ResNet-101 FPN backbone, in the variant 3D-SDN runs
(github.com/ysymyth/3D-SDN, geometric/maskrcnn: config.py:19-183,
vkitti.py:30-41, model.py), written from that description in plain
`torch` and numpy, float32, with TF32 off (`no_tf32`).  One frame, no
batching, no fixed-shape padding (each stage keeps only its valid rows),
no kernel of the program.  It reads the program's state_dict layout
(`fpn.C1.0`, `fpn.C2.0.conv1`, ..., `fpn.P2_conv2.1`, `rpn.conv_*`,
`classifier.*`, `mask.*`), which `layout` lists.

3D-SDN's variant, kept here:
- the stride of a bottleneck sits on its 1x1 conv1 (model.py:210-247);
- TF "SAME" padding where model.py pads with SamePad2d (the stem's max
  pool, the FPN's 3x3 output convolutions); the stem convolution pads 3
  on every side and the 3x3 convolutions of the bottlenecks, the RPN and
  the mask head pad 1, as model.py builds them;
- BatchNorm eps 1e-3, every convolution with a bias;
- the RPN's outputs in NHWC order (y, x, anchor), as the anchors are made;
- pixel-inclusive IoU (x2 - x1 + 1) in both NMS passes (the Faster R-CNN
  NMS kernel, maskrcnn/nms);
- RoIAlign as TF crop_and_resize (maskrcnn/roialign's kernel): corner
  aligned bilinear samples, in_y = y1 * (H - 1) + i * step, zero outside
  the image, each box from its own level 4 + log2(sqrt(hw) / (224 /
  sqrt(image area))), rounded and clipped to 2..5;
- the head's box deltas scaled by RPN_BBOX_STD_DEV (model.py:772);
- detect (model.py:1610-1654) and unmold_detections (model.py:2084-2128).

Departures, each to agree with the program where two sound float32
computations would otherwise part on a rounding:
- the sample positions of RoIAlign are computed as the program computes
  them: step = (hi - lo) * ((size - 1) * f32(1 / (n - 1))), and
  lo * (size - 1) + step * i with one rounding (the kernel's `fmaf`), so
  that a box clipped to the far edge samples the edge the same way; a
  sample at a NaN position reads zero (the kernel's is undefined);
- the classifier's 7x7 convolution over a 7x7 crop and its 1x1 one are
  computed as the products they are (F.linear over the flattened crop);
- a mask plane is quantised for the resize as (m * 255) cast to uint8,
  where scipy.misc.imresize (gone from scipy) stretched [min, max] to
  [0, 255]; the resize is PIL's bilinear, as imresize's was;
- unmolding clips each box to the frame and drops one under a pixel or
  with a non-finite coordinate (a random detector's exp() of a box delta
  may overflow; geometric/scripts/main.py:798-810 skips such objects).

The greedy NMS is the textbook loop over score-sorted boxes (ties kept in
index order) on the host, over an IoU matrix computed once on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
PLANES = (64, 128, 256, 512)
FPN_IN = {2: 256, 3: 512, 4: 1024, 5: 2048}


def no_tf32(on: bool = False) -> None:
    """float32 products and convolutions in full float32 (TF32 off); `on`
    turns TF32 on (the check's control)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# -- the state_dict's layout ----------------------------------------------

def layout(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{key: (shape, dtype)} of the detector's state_dict for the
    configuration `cfg` (MaskRCNNConfig's fields, as a dict)."""
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    f32 = torch.float32

    def conv(name, o, i, k):
        out[name + ".weight"] = ((o, i, k, k), f32)
        out[name + ".bias"] = ((o,), f32)

    def bn(name, c):
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{p}"] = ((c,), f32)
        out[name + ".num_batches_tracked"] = ((), torch.int64)

    def linear(name, o, i):
        out[name + ".weight"] = ((o, i), f32)
        out[name + ".bias"] = ((o,), f32)

    fpn, C = int(cfg["fpn_channels"]), int(cfg["num_classes"])
    conv("fpn.C1.0", 64, 3, 7)
    bn("fpn.C1.1", 64)
    cin = 64
    for i, (blocks, planes) in enumerate(zip(cfg["stage_sizes"], PLANES)):
        for j in range(blocks):
            pre = f"fpn.C{i + 2}.{j}"
            conv(pre + ".conv1", planes, cin, 1)
            bn(pre + ".bn1", planes)
            conv(pre + ".conv2", planes, planes, 3)
            bn(pre + ".bn2", planes)
            conv(pre + ".conv3", planes * 4, planes, 1)
            bn(pre + ".bn3", planes * 4)
            if j == 0:
                conv(pre + ".downsample.0", planes * 4, cin, 1)
                bn(pre + ".downsample.1", planes * 4)
            cin = planes * 4
    for k in (5, 4, 3, 2):
        conv(f"fpn.P{k}_conv1", fpn, FPN_IN[k], 1)
        conv(f"fpn.P{k}_conv2.1", fpn, fpn, 3)
    a = len(cfg["rpn_anchor_ratios"])
    conv("rpn.conv_shared", 512, fpn, 3)
    conv("rpn.conv_class", 2 * a, 512, 1)
    conv("rpn.conv_bbox", 4 * a, 512, 1)
    conv("classifier.conv1", 1024, fpn, int(cfg["pool_size"]))
    bn("classifier.bn1", 1024)
    conv("classifier.conv2", 1024, 1024, 1)
    bn("classifier.bn2", 1024)
    linear("classifier.linear_class", C, 1024)
    linear("classifier.linear_bbox", C * 4, 1024)
    for k in range(1, 5):
        conv(f"mask.conv{k}", 256, fpn if k == 1 else 256, 3)
        bn(f"mask.bn{k}", 256)
    out["mask.deconv.weight"] = ((256, 256, 2, 2), f32)     # [in, out]
    out["mask.deconv.bias"] = ((256,), f32)
    conv("mask.conv5", C, 256, 1)
    return out


# -- layers ---------------------------------------------------------------

def _conv(sd, name, x, stride=1, padding=0):
    return F.conv2d(x, sd[name + ".weight"], sd[name + ".bias"],
                    stride=stride, padding=padding)


def _bn(sd, name, x):
    return F.batch_norm(x, sd[name + ".running_mean"],
                        sd[name + ".running_var"], sd[name + ".weight"],
                        sd[name + ".bias"], False, 0.0, BN_EPS)


def _dense(sd, name, x):
    """A convolution whose kernel covers its whole input, as a product:
    [N, C, k, k] -> [N, O, 1, 1]."""
    w = sd[name + ".weight"]
    return F.linear(x.reshape(x.shape[0], -1), w.reshape(w.shape[0], -1),
                    sd[name + ".bias"])[:, :, None, None]


def same_pad(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """TF "SAME" padding: the odd pixel on the high side."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


# -- backbone, FPN, RPN -----------------------------------------------------

def backbone(sd, cfg: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """Mean-subtracted [1, 3, H, W] -> the pyramid [P2, P3, P4, P5, P6]."""
    c = torch.relu(_bn(sd, "fpn.C1.1", _conv(sd, "fpn.C1.0", x, 2, 3)))
    c = F.max_pool2d(same_pad(c, 3, 2, -math.inf), 3, 2)
    stages = []
    for i, blocks in enumerate(cfg["stage_sizes"]):
        for j in range(blocks):
            pre = f"fpn.C{i + 2}.{j}"
            s = 2 if (i > 0 and j == 0) else 1
            y = torch.relu(_bn(sd, pre + ".bn1",
                               _conv(sd, pre + ".conv1", c, s)))
            y = torch.relu(_bn(sd, pre + ".bn2",
                               _conv(sd, pre + ".conv2", y, 1, 1)))
            y = _bn(sd, pre + ".bn3", _conv(sd, pre + ".conv3", y))
            r = c if j else _bn(sd, pre + ".downsample.1",
                                _conv(sd, pre + ".downsample.0", c, s))
            c = torch.relu(y + r)
        stages.append(c)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa
    p = {5: _conv(sd, "fpn.P5_conv1", stages[3])}
    for k in (4, 3, 2):
        p[k] = _conv(sd, f"fpn.P{k}_conv1", stages[k - 2]) + up(p[k + 1])
    out = [_conv(sd, f"fpn.P{k}_conv2.1", same_pad(p[k], 3, 1))
           for k in (2, 3, 4, 5)]
    return out + [out[3][:, :, ::2, ::2]]       # P6: P5 at stride 2


def rpn(sd, pyramid: Sequence[torch.Tensor]):
    """The shared RPN head over every level -> (logits [A, 2], probs
    [A, 2], deltas [A, 4]), anchors in (level, y, x, anchor) order."""
    logits, deltas = [], []
    for p in pyramid:
        s = torch.relu(_conv(sd, "rpn.conv_shared", p, 1, 1))
        logits.append(_conv(sd, "rpn.conv_class", s).permute(0, 2, 3, 1)
                      .reshape(-1, 2))
        deltas.append(_conv(sd, "rpn.conv_bbox", s).permute(0, 2, 3, 1)
                      .reshape(-1, 4))
    logits = torch.cat(logits)
    return logits, torch.softmax(logits, dim=1), torch.cat(deltas)


def anchors(cfg: Dict) -> np.ndarray:
    """[A, 4] (y1, x1, y2, x2) pixels: each level's scale at each ratio,
    centred on every anchor_stride-th cell of its feature map, in
    (level, y, x, ratio) order."""
    dim = int(cfg["image_max_dim"])
    out = []
    for scale, stride in zip(cfg["rpn_anchor_scales"],
                             cfg["backbone_strides"]):
        r = np.asarray(cfg["rpn_anchor_ratios"], np.float64)
        h, w = scale / np.sqrt(r), scale * np.sqrt(r)
        n = int(math.ceil(dim / stride))
        c = np.arange(0, n, int(cfg["rpn_anchor_stride"])) * stride
        cy, cx = np.meshgrid(c, c, indexing="ij")
        cy, cx = cy[..., None], cx[..., None]
        out.append(np.stack([cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h,
                             cx + 0.5 * w], -1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


# -- boxes and NMS ------------------------------------------------------------

def apply_deltas(boxes: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(y1, x1, y2, x2) boxes moved by (dy, dx, log dh, log dw)."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    cy = boxes[:, 0] + 0.5 * h + d[:, 0] * h
    cx = boxes[:, 1] + 0.5 * w + d[:, 1] * w
    h = h * torch.exp(d[:, 2])
    w = w * torch.exp(d[:, 3])
    y1 = cy - 0.5 * h
    x1 = cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], dim=1)


def clip(boxes: torch.Tensor, window: Sequence[float]) -> torch.Tensor:
    """Each coordinate into the window (y1, x1, y2, x2)."""
    lo = boxes.new_tensor([window[0], window[1], window[0], window[1]])
    hi = boxes.new_tensor([window[2], window[3], window[2], window[3]])
    return torch.minimum(torch.maximum(boxes, lo), hi)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pixel-inclusive IoU [len(a), len(b)] of (y1, x1, y2, x2) boxes."""
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    hh = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1.0).clamp(min=0.0)
    ww = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1.0).clamp(min=0.0)
    inter = hh * ww
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms(boxes: torch.Tensor, threshold: float) -> List[int]:
    """Indices of the boxes kept by greedy NMS, boxes already in
    descending score order: each box is kept unless a kept earlier box
    overlaps it with IoU > threshold (a NaN IoU suppresses nothing)."""
    over = (iou(boxes, boxes) > threshold).cpu().numpy()
    gone = np.zeros(len(over), bool)
    keep = []
    for i in range(len(over)):
        if not gone[i]:
            keep.append(i)
            gone |= over[i]
    return keep


def score_order(scores: torch.Tensor) -> torch.Tensor:
    """Descending by score, ties in index order."""
    return torch.sort(scores, descending=True, stable=True).indices


def proposals(cfg: Dict, probs, deltas, anchors_px: torch.Tensor):
    """The proposal layer: the pre_nms_limit best anchors moved by their
    deltas and clipped to the image, NMS at rpn_nms_threshold, the first
    post_nms_rois_inference kept.  -> (boxes [P, 4] normalised, their
    pixel boxes before NMS [pre, 4], the kept rows [P])."""
    dim = float(cfg["image_max_dim"])
    order = score_order(probs[:, 1])[:int(cfg["pre_nms_limit"])]
    std = deltas.new_tensor(cfg["rpn_bbox_std_dev"])
    boxes = clip(apply_deltas(anchors_px[order], deltas[order] * std),
                 (0.0, 0.0, dim, dim))
    keep = greedy_nms(boxes, float(cfg["rpn_nms_threshold"]))
    keep = keep[:int(cfg["post_nms_rois_inference"])]
    return boxes[keep] / boxes.new_tensor([dim, dim, dim, dim]), boxes, keep


# -- RoIAlign -----------------------------------------------------------------

def _positions(lo, hi, size_m1: float, n: int) -> torch.Tensor:
    """Sample positions [N, n] along one axis (see the module's
    departures)."""
    m1 = torch.full_like(lo, size_m1)
    if n == 1:
        return (0.5 * (lo + hi) * m1)[:, None]
    step = (hi - lo) * (m1 * (1.0 / (n - 1)))
    i = torch.arange(n, dtype=torch.float64, device=lo.device)
    return ((lo * m1).double()[:, None] + step.double()[:, None] * i).float()


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    size: int) -> torch.Tensor:
    """image [C, H, W], boxes [N, 4] normalised -> crops [N, C, size,
    size]: bilinear samples on the corner-aligned grid of each box, zero
    where a sample falls outside the image."""
    C, H, W = image.shape
    ys = _positions(boxes[:, 0], boxes[:, 2], float(H - 1), size)
    xs = _positions(boxes[:, 1], boxes[:, 3], float(W - 1), size)
    ok = (((ys >= 0) & (ys <= H - 1))[:, :, None]
          & ((xs >= 0) & (xs <= W - 1))[:, None, :])
    ys = torch.where(ys.isnan(), 0.0, ys).clamp(0, H - 1)
    xs = torch.where(xs.isnan(), 0.0, xs).clamp(0, W - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    y_lerp = (ys - y0)[:, None, :, None]
    x_lerp = (xs - x0)[:, None, None, :]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.ceil(ys).long(), torch.ceil(xs).long()

    def at(yy, xx):                     # [N, C, size, size]
        return image[:, yy[:, :, None], xx[:, None, :]].permute(1, 0, 2, 3)

    top = at(y0, x0) + (at(y0, x1) - at(y0, x0)) * x_lerp
    bot = at(y1, x0) + (at(y1, x1) - at(y1, x0)) * x_lerp
    out = top + (bot - top) * y_lerp
    return torch.where(ok[:, None], out, 0.0)


def roi_align(pyramid: Sequence[torch.Tensor], boxes: torch.Tensor,
              size: int, cfg: Dict) -> torch.Tensor:
    """boxes [N, 4] normalised -> crops [N, C, size, size], each box from
    its own level of P2..P5."""
    dim = float(cfg["image_max_dim"])
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    level = 4 + torch.log2(torch.sqrt(torch.clamp(h * w, min=1e-12))
                           / (224.0 / math.sqrt(dim * dim)))
    level = torch.round(level).clamp(2, 5)
    level = torch.where(level.isnan(), 2.0, level).long()
    out = boxes.new_zeros(len(boxes), pyramid[0].shape[1], size, size)
    for k in range(2, 6):
        idx = torch.nonzero(level == k)[:, 0]
        if len(idx):
            out[idx] = crop_and_resize(pyramid[k - 2][0], boxes[idx], size)
    return out


# -- heads ------------------------------------------------------------------

def classifier_head(sd, crops: torch.Tensor):
    """crops [N, C, pool, pool] -> (logits [N, classes], probs, deltas
    [N, classes, 4])."""
    x = torch.relu(_bn(sd, "classifier.bn1",
                       _dense(sd, "classifier.conv1", crops)))
    x = torch.relu(_bn(sd, "classifier.bn2",
                       _dense(sd, "classifier.conv2", x)))
    x = x.reshape(x.shape[0], -1)
    logits = F.linear(x, sd["classifier.linear_class.weight"],
                      sd["classifier.linear_class.bias"])
    deltas = F.linear(x, sd["classifier.linear_bbox.weight"],
                      sd["classifier.linear_bbox.bias"])
    return (logits, torch.softmax(logits, dim=1),
            deltas.reshape(len(x), -1, 4))


def mask_head(sd, crops: torch.Tensor) -> torch.Tensor:
    """crops [N, C, mpool, mpool] -> sigmoid masks [N, classes, 2 mpool,
    2 mpool]."""
    x = crops
    for k in range(1, 5):
        x = torch.relu(_bn(sd, f"mask.bn{k}", _conv(sd, f"mask.conv{k}",
                                                     x, 1, 1)))
    x = torch.relu(F.conv_transpose2d(x, sd["mask.deconv.weight"],
                                      sd["mask.deconv.bias"], stride=2))
    return torch.sigmoid(_conv(sd, "mask.conv5", x))


def refine(cfg: Dict, rois: torch.Tensor, probs: torch.Tensor,
           deltas: torch.Tensor, window: Sequence[float]):
    """Detection refinement (model.py:744-838) over the valid proposals
    `rois` [N, 4] (normalised) -> (boxes [D, 4] whole pixels of the molded
    frame, class ids [D], scores [D]), by descending score."""
    dim = float(cfg["image_max_dim"])
    scale = rois.new_tensor([dim, dim, dim, dim])
    n = torch.arange(len(rois), device=rois.device)
    cls = torch.argmax(probs, dim=1)
    score = probs[n, cls]
    std = rois.new_tensor(cfg["rpn_bbox_std_dev"])
    boxes = torch.round(clip(apply_deltas(rois, deltas[n, cls] * std)
                             * scale, window))
    keep = (cls > 0) & (score >= float(cfg["detection_min_confidence"]))
    kept = []
    for c in range(1, int(cfg["num_classes"])):
        idx = torch.nonzero(keep & (cls == c))[:, 0]
        idx = idx[score_order(score[idx])]
        kept += idx[greedy_nms(boxes[idx],
                               float(cfg["detection_nms_threshold"]))
                    ].tolist()
    kept = torch.as_tensor(sorted(kept), dtype=torch.long,
                           device=rois.device)
    top = kept[score_order(score[kept])][:int(cfg["detection_max_instances"])]
    return boxes[top], cls[top], score[top]


# -- one frame ----------------------------------------------------------------

def mold(image: np.ndarray, cfg: Dict):
    """maskrcnn/utils.py:272-335: the frame scaled (PIL bilinear) so its
    short side is >= image_min_dim and its long side <= image_max_dim,
    centred in a square of image_max_dim.  -> (molded uint8, window (y1,
    x1, y2, x2), scale)."""
    from PIL import Image

    h, w = image.shape[:2]
    lo, hi = int(cfg["image_min_dim"]), int(cfg["image_max_dim"])
    scale = max(1.0, lo / min(h, w))
    if round(max(h, w) * scale) > hi:
        scale = hi / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    top, left = (hi - nh) // 2, (hi - nw) // 2
    out = np.zeros((hi, hi, 3), image.dtype)
    out[top:top + nh, left:left + nw] = np.asarray(
        Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
    return out, (top, left, top + nh, left + nw), scale


def detect(sd, cfg: Dict, image: np.ndarray, device) -> Dict[str, object]:
    """One frame [H, W, 3] uint8 through every stage.  -> pyramid
    (P2..P6), rpn_logits [A, 2], rpn_deltas [A, 4], proposals [P, 4]
    normalised, boxes [D, 4] molded pixels, class_ids [D], scores [D],
    masks [D, 2 mpool, 2 mpool] (each detection's own class's plane),
    window, scale."""
    molded, window, scale = mold(image, cfg)
    mean = torch.tensor(cfg["mean_pixel"], dtype=torch.float32,
                        device=device)
    x = (torch.as_tensor(molded, device=device).float() - mean
         ).permute(2, 0, 1)[None].contiguous()
    with torch.no_grad():
        pyramid = backbone(sd, cfg, x)
        logits, probs, deltas = rpn(sd, pyramid)
        props, _, _ = proposals(cfg, probs, deltas, torch.as_tensor(
            anchors(cfg), device=device))
        crops = roi_align(pyramid[:4], props, int(cfg["pool_size"]), cfg)
        _, cprobs, cdeltas = classifier_head(sd, crops)
        boxes, cls, scores = refine(cfg, props, cprobs, cdeltas,
                                    [float(v) for v in window])
        dim = float(cfg["image_max_dim"])
        planes = mask_head(sd, roi_align(
            pyramid[:4], boxes / dim, int(cfg["mask_pool_size"]), cfg))
        own = planes[torch.arange(len(cls), device=device), cls]
    return {"pyramid": pyramid, "rpn_logits": logits, "rpn_deltas": deltas,
            "proposals": props, "boxes": boxes, "class_ids": cls,
            "scores": scores, "masks": own, "window": window,
            "scale": scale}


def unmold(boxes: np.ndarray, class_ids: np.ndarray, masks: np.ndarray,
           window, scale: float, hw: Tuple[int, int],
           threshold: float = 0.5):
    """Detections of the molded frame back on the original one
    (model.py:2084-2128): (class_ids [N], masks [N, 1, H, W] float32 0/1,
    rois [N, 4] pixels)."""
    from PIL import Image

    H, W = hw
    ids, full_masks, rois = [], [], []
    for (y1, x1, y2, x2), c, m in zip(boxes, class_ids, masks):
        if not np.isfinite([y1, x1, y2, x2]).all():
            continue
        if c <= 0 or y2 <= y1 or x2 <= x1:
            continue
        oy1, oy2 = np.clip([(y1 - window[0]) / scale,
                            (y2 - window[0]) / scale], 0, H)
        ox1, ox2 = np.clip([(x1 - window[1]) / scale,
                            (x2 - window[1]) / scale], 0, W)
        if oy2 - oy1 < 1 or ox2 - ox1 < 1:
            continue
        m = np.asarray(Image.fromarray((m * 255).astype(np.uint8)).resize(
            (int(ox2 - ox1), int(oy2 - oy1)), Image.BILINEAR))
        full = np.zeros((H, W), np.float32)
        full[int(oy1):int(oy1) + m.shape[0],
             int(ox1):int(ox1) + m.shape[1]] = \
            m.astype(np.float32) / 255.0 >= threshold
        ids.append(int(c))
        full_masks.append(full[None])
        rois.append([oy1, ox1, oy2, ox2])
    if not ids:
        return (np.zeros((0,), np.int32), np.zeros((0, 1, H, W), np.float32),
                np.zeros((0, 4), np.float32))
    return (np.asarray(ids, np.int32), np.stack(full_masks),
            np.asarray(rois, np.float32))


def flops(cfg: Dict, rois: int, detections: int) -> float:
    """FLOPs (torch.utils.flop_counter: convolutions and products) of one
    frame's networks at the given numbers of RoIs in the box head and of
    detections in the mask head, counted on the meta device (NMS, RoIAlign
    and the elementwise work count 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    sd = {k: torch.empty(s, dtype=d, device=meta)
          for k, (s, d) in layout(cfg).items()}
    dim, fpn = int(cfg["image_max_dim"]), int(cfg["fpn_channels"])
    pool, mpool = int(cfg["pool_size"]), int(cfg["mask_pool_size"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        pyramid = backbone(sd, cfg, torch.empty(1, 3, dim, dim, device=meta))
        rpn(sd, pyramid)
        classifier_head(sd, torch.empty(rois, fpn, pool, pool, device=meta))
        mask_head(sd, torch.empty(detections, fpn, mpool, mpool,
                                  device=meta))
    return float(fc.get_total_flops())
