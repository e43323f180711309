"""Mask R-CNN training-time layers: target assignment and losses, PyTorch
port.

PyTorch counterpart of sdn3d_tpu/models/maskrcnn_train.py (maskrcnn/
model.py:1004-1151, the losses; :545-730, detection_target_layer;
:1214-1324, build_rpn_targets on the host).  Device code keeps the JAX
package's fixed shapes: the reference's nonzero / compaction sampling is a
masked top-k (models/maskrcnn.top_k, lax.top_k's order) with validity
masks, and no step reads a count back to the host.

Where the JAX package's compiled program divides by a constant, XLA
multiplies by the constant's float32 reciprocal; the port does the same
(`_recip`): the negatives' cap floor(n_pos / 0.33) is 67 at 33 positives
that way, 66 by true division.  The sampling's uniform draws come from a
torch.Generator (JAX: jax.random.uniform of the step's key split in two);
`detection_targets` also takes them as tensors, which is how the CPU
tests hand it JAX's.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig, top_k
from sdn3d_tpu_torch.ops.roi_align import crop_and_resize
from sdn3d_tpu_torch.utils.transfer import constant


# ---------------------------------------------------------------------------
# Host-side RPN target assignment (model.py:1214-1324)
# ---------------------------------------------------------------------------

def build_rpn_targets(anchors: np.ndarray, gt_boxes: np.ndarray,
                      config: MaskRCNNConfig,
                      rng: "np.random.RandomState" = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """anchors [A, 4], gt_boxes [G, 4] pixel coords ->
    (rpn_match [A] in {-1, 0, 1}, rpn_bbox [train_anchors, 4] deltas).

    `rng` makes the pos/neg anchor balance sampling reproducible
    (defaults to the global np.random, the reference's behaviour); the
    draws are the JAX package's, call for call."""
    rng = rng or np.random
    rpn_match = np.zeros((anchors.shape[0],), np.int32)
    rpn_bbox = np.zeros((config.rpn_train_anchors_per_image, 4), np.float32)
    if len(gt_boxes) == 0:
        rpn_match[:] = -1
        neg = np.where(rpn_match == -1)[0]
        keep = rng.choice(
            neg, min(len(neg), config.rpn_train_anchors_per_image),
            replace=False)
        rpn_match[:] = 0
        rpn_match[keep] = -1
        return rpn_match, rpn_bbox

    # IoU (no +1 here: model.py:1260 uses exclusive areas via utils)
    a_y1, a_x1, a_y2, a_x2 = anchors.T
    g_y1, g_x1, g_y2, g_x2 = gt_boxes.T
    a_area = (a_y2 - a_y1) * (a_x2 - a_x1)
    g_area = (g_y2 - g_y1) * (g_x2 - g_x1)
    iy1 = np.maximum(a_y1[:, None], g_y1[None])
    ix1 = np.maximum(a_x1[:, None], g_x1[None])
    iy2 = np.minimum(a_y2[:, None], g_y2[None])
    ix2 = np.minimum(a_x2[:, None], g_x2[None])
    inter = np.maximum(iy2 - iy1, 0) * np.maximum(ix2 - ix1, 0)
    overlaps = inter / (a_area[:, None] + g_area[None] - inter)

    anchor_iou_argmax = overlaps.argmax(axis=1)
    anchor_iou_max = overlaps.max(axis=1)
    rpn_match[anchor_iou_max < 0.3] = -1
    gt_iou_argmax = overlaps.argmax(axis=0)
    rpn_match[gt_iou_argmax] = 1
    rpn_match[anchor_iou_max >= 0.7] = 1

    # balance (model.py:1285-1302)
    ids = np.where(rpn_match == 1)[0]
    extra = len(ids) - config.rpn_train_anchors_per_image // 2
    if extra > 0:
        rpn_match[rng.choice(ids, extra, replace=False)] = 0
    ids = np.where(rpn_match == -1)[0]
    extra = len(ids) - (config.rpn_train_anchors_per_image
                        - np.sum(rpn_match == 1))
    if extra > 0:
        rpn_match[rng.choice(ids, extra, replace=False)] = 0

    # deltas for positive anchors, std-normalised (model.py:1305-1324)
    ids = np.where(rpn_match == 1)[0]
    std = np.asarray(config.rpn_bbox_std_dev)
    for ix, i in enumerate(ids[:config.rpn_train_anchors_per_image]):
        gt = gt_boxes[anchor_iou_argmax[i]]
        a = anchors[i]
        gh, gw = gt[2] - gt[0], gt[3] - gt[1]
        gcy, gcx = gt[0] + 0.5 * gh, gt[1] + 0.5 * gw
        ah, aw = a[2] - a[0], a[3] - a[1]
        acy, acx = a[0] + 0.5 * ah, a[1] + 0.5 * aw
        rpn_bbox[ix] = [(gcy - acy) / ah, (gcx - acx) / aw,
                        np.log(gh / ah), np.log(gw / aw)]
        rpn_bbox[ix] /= std
    return rpn_match, rpn_bbox


# ---------------------------------------------------------------------------
# Fixed-shape detection target layer (model.py:545-730)
# ---------------------------------------------------------------------------

def _recip(values, dev) -> torch.Tensor:
    """The float32 reciprocals of constants, as XLA folds a division by a
    constant into a product."""
    return constant(tuple(float(np.float32(1.0) / np.float32(v))
                          for v in np.atleast_1d(values)), torch.float32, dev)


def box_deltas(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Refinement targets [N, 4] of rois [N, 4] towards gt [N, 4]
    (model.py:506-542 box_refinement)."""
    h = rois[:, 2] - rois[:, 0]
    w = rois[:, 3] - rois[:, 1]
    cy = rois[:, 0] + 0.5 * h
    cx = rois[:, 1] + 0.5 * w
    gh = gt[:, 2] - gt[:, 0]
    gw = gt[:, 3] - gt[:, 1]
    gcy = gt[:, 0] + 0.5 * gh
    gcx = gt[:, 1] + 0.5 * gw
    h = torch.clamp(h, min=1e-6)
    w = torch.clamp(w, min=1e-6)
    return torch.stack([(gcy - cy) / h, (gcx - cx) / w,
                        torch.log(torch.clamp(gh, min=1e-6) / h),
                        torch.log(torch.clamp(gw, min=1e-6) / w)], dim=1)


Draws = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def sampling_draws(n: int, draws: Draws, dev
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positive and negative sampling scores' uniform draws [n] each:
    two torch.rand draws from a generator (on `dev`), or the given pair."""
    if isinstance(draws, torch.Generator):
        return (torch.rand(n, generator=draws, device=dev),
                torch.rand(n, generator=draws, device=dev))
    return draws[0].to(dev), draws[1].to(dev)


def detection_targets(proposals: torch.Tensor, prop_valid: torch.Tensor,
                      gt_class_ids: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_masks: torch.Tensor, draws: Draws,
                      config: MaskRCNNConfig) -> Dict[str, torch.Tensor]:
    """Sample train_rois_per_image proposals with a ~1:2 pos:neg ratio and
    build class / delta / mask targets, fixed shapes, masked.

    proposals [P, 4] normalised, prop_valid [P], gt_class_ids [G] (0 =
    pad), gt_boxes [G, 4] normalised, gt_masks [G, mh, mw] (mini-masks);
    `draws` a torch.Generator or the (positive, negative) uniform draws
    [P] each.  Returns rois [T, 4], roi_valid [T], class_ids [T], deltas
    [T, 4], masks [T, *mask_shape], is_pos [T]."""
    T = config.train_rois_per_image
    n_pos_max = int(T * config.roi_positive_ratio)
    dev = proposals.device
    gt_valid = gt_class_ids > 0

    # the direct [P, G] cross-IoU
    py1, px1, py2, px2 = proposals.unbind(-1)
    gy1_, gx1_, gy2_, gx2_ = gt_boxes.unbind(-1)
    p_area = (py2 - py1) * (px2 - px1)
    g_area = (gy2_ - gy1_) * (gx2_ - gx1_)
    iy1 = torch.maximum(py1[:, None], gy1_[None])
    ix1 = torch.maximum(px1[:, None], gx1_[None])
    iy2 = torch.minimum(py2[:, None], gy2_[None])
    ix2 = torch.minimum(px2[:, None], gx2_[None])
    inter = (torch.clamp(iy2 - iy1, min=0) * torch.clamp(ix2 - ix1, min=0))
    union = p_area[:, None] + g_area[None] - inter
    overlaps = inter / torch.clamp(union, min=1e-12)           # [P, G]
    overlaps = torch.where(gt_valid[None, :], overlaps, -1.0)
    # jnp.max / argmax: NaN is the largest, its first index wins
    roi_iou_max, best_gt = overlaps.max(dim=1)

    positive = (roi_iou_max >= 0.5) & prop_valid
    negative = (roi_iou_max < 0.5) & prop_valid

    u_pos, u_neg = sampling_draws(proposals.shape[0], draws, dev)
    _, pos_idx = top_k(torch.where(positive, u_pos, -1.0), n_pos_max)
    pos_ok = positive[pos_idx]
    _, neg_idx = top_k(torch.where(negative, u_neg, -1.0), T - n_pos_max)
    neg_ok = negative[neg_idx]

    # the reference's pos:neg ratio against the ACTUAL positive count
    # (model.py:667-671; zero negatives without positives)
    n_pos = pos_ok.sum().to(torch.int32)
    neg_allowed = (torch.floor(n_pos.float() * _recip(
        config.roi_positive_ratio, dev)[0]).to(torch.int32) - n_pos)
    neg_rank = torch.cumsum(neg_ok.to(torch.int32), 0) - 1
    neg_ok = neg_ok & (neg_rank < neg_allowed)

    roi_idx = torch.cat([pos_idx, neg_idx])
    is_pos = torch.cat([pos_ok, torch.zeros_like(neg_ok)])
    roi_ok = torch.cat([pos_ok, neg_ok])

    rois = proposals[roi_idx]
    gt_assign = best_gt[roi_idx]
    class_ids = torch.where(is_pos, gt_class_ids[gt_assign].long(), 0)

    gt_for_roi = gt_boxes[gt_assign]                           # [T, 4]
    deltas = box_deltas(rois, gt_for_roi) * _recip(config.bbox_std_dev, dev)
    deltas = torch.where(is_pos[:, None], deltas, 0.0)

    # mask targets: the assigned GT mini-mask cropped to the roi in the GT
    # box's own frame, resized to mask_shape (model.py:689-718)
    gy1, gx1, gy2, gx2 = gt_for_roi.unbind(-1)
    gh = torch.clamp(gy2 - gy1, min=1e-6)
    gw = torch.clamp(gx2 - gx1, min=1e-6)
    boxes = torch.stack([(rois[:, 0] - gy1) / gh, (rois[:, 1] - gx1) / gw,
                         (rois[:, 2] - gy1) / gh, (rois[:, 3] - gx1) / gw],
                        dim=1)
    crops = crop_and_resize(gt_masks[..., None].float(), boxes, gt_assign,
                            config.mask_shape)[..., 0]
    masks = torch.round(crops) * is_pos[:, None, None]

    return {"rois": rois, "roi_valid": roi_ok, "class_ids": class_ids,
            "deltas": deltas, "masks": masks, "is_pos": is_pos}


# ---------------------------------------------------------------------------
# Losses (model.py:1004-1151), masked fixed-shape versions
# ---------------------------------------------------------------------------

def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long())[:, 0]


def rpn_class_loss(rpn_match: torch.Tensor,
                   rpn_class_logits: torch.Tensor) -> torch.Tensor:
    """rpn_match [A] in {-1, 0, 1}; logits [A, 2]."""
    use = rpn_match != 0
    nll = _nll(rpn_class_logits, (rpn_match == 1).long())
    return torch.sum(nll * use) / torch.clamp(use.sum(), min=1)


def rpn_bbox_loss(target_bbox: torch.Tensor, rpn_match: torch.Tensor,
                  rpn_pred: torch.Tensor) -> torch.Tensor:
    """target_bbox [K, 4] (packed positives); rpn_pred [A, 4]."""
    pos = rpn_match == 1
    K = target_bbox.shape[0]
    # the positives' predicted deltas packed to the front in anchor order,
    # like the reference's nonzero gather (model.py:1046-1056)
    order = torch.argsort((~pos).to(torch.uint8), stable=True)
    pred_packed = rpn_pred[order[:K]]
    use = (torch.arange(K, device=pos.device) < pos.sum())[:, None]
    loss = smooth_l1(pred_packed - target_bbox) * use
    return torch.sum(loss) / torch.clamp(use.sum() * 4, min=1)


def mrcnn_class_loss(class_ids: torch.Tensor, valid: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """class_ids [T], valid [T], logits [T, C]."""
    nll = _nll(logits, class_ids)
    return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)


def mrcnn_bbox_loss(target_deltas: torch.Tensor, class_ids: torch.Tensor,
                    is_pos: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """pred [T, C, 4]; only positive rois' own class contributes."""
    sel = torch.gather(pred, 1, class_ids.long()[:, None, None].expand(
        -1, 1, 4))[:, 0]
    loss = smooth_l1(sel - target_deltas) * is_pos[:, None]
    return torch.sum(loss) / torch.clamp(is_pos.sum() * 4, min=1)


def mrcnn_mask_loss(target_masks: torch.Tensor, class_ids: torch.Tensor,
                    is_pos: torch.Tensor, pred_masks: torch.Tensor
                    ) -> torch.Tensor:
    """target_masks [T, mh, mw]; pred_masks [T, C, mh, mw] sigmoid outputs
    (the port's channels-first layout; JAX [T, mh, mw, C])."""
    mh, mw = target_masks.shape[1:]
    sel = torch.gather(pred_masks, 1, class_ids.long()[:, None, None, None]
                       .expand(-1, 1, mh, mw))[:, 0]
    eps = 1e-7
    bce = -(target_masks * torch.log(sel + eps)
            + (1 - target_masks) * torch.log(1 - sel + eps))
    bce = bce * is_pos[:, None, None]
    return torch.sum(bce) / torch.clamp(is_pos.sum() * (mh * mw), min=1)


LOSS_NAMES = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
              "mrcnn_bbox_loss", "mrcnn_mask_loss")


def train_losses(out: Dict[str, torch.Tensor], rpn_match: torch.Tensor,
                 rpn_target_bbox: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The five losses of one frame's MaskRCNN.train_forward outputs, in
    the JAX step's order (LOSS_NAMES)."""
    tgt = out["targets"]
    return {
        "rpn_class_loss": rpn_class_loss(rpn_match, out["rpn_class_logits"]),
        "rpn_bbox_loss": rpn_bbox_loss(rpn_target_bbox, rpn_match,
                                       out["rpn_bbox"]),
        "mrcnn_class_loss": mrcnn_class_loss(
            tgt["class_ids"], tgt["roi_valid"], out["mrcnn_class_logits"]),
        "mrcnn_bbox_loss": mrcnn_bbox_loss(
            tgt["deltas"], tgt["class_ids"], tgt["is_pos"],
            out["mrcnn_bbox"]),
        "mrcnn_mask_loss": mrcnn_mask_loss(
            tgt["masks"], tgt["class_ids"], tgt["is_pos"],
            out["mrcnn_masks"]),
    }
