"""The check of the edit chain's detector in `chain_maskrcnn`'s cell.

The reference is perfbench/reference/maskrcnn_ref.py (plain Mask R-CNN,
float32, TF32 off) with the detector's weights (harness/detect_weights,
from the configuration's seed).  It
judges the program's detector on the frames of the requests the check
samples (chain_ref judges the stages after it, on the program's own
objects), and reads, the worst over those frames:

  det_pyramid_gap      P2..P6 of the program's detector entry at its
                       molded size, relative to the largest |value| of
                       each level (1 where a level is missing or differs
                       in shape or in which values are finite);
  det_rpn_gap          the RPN's logits and deltas, the same way;
  det_proposal_unpaired
                       proposals of either side with no equal partner on
                       the other, not admitted as a tie;
  det_unpaired         detections (the network's valid ones, from the
                       program's packed buffer) with no partner of the
                       same class at IoU >= PAIR_IOU, not admitted;
  det_score_gap        the same of their scores;
  det_mask_gap         the same of their own-class mask planes;
  dets_unpaired        objects the timed chain used (unmolded, capped to
                       the 16 slots) with no partner of the same class at
                       IoU >= PAIR_IOU among the reference's (unmolded
                       and capped the same way), not admitted;
  dets_mask_mismatch   the full-frame mask pixels on which paired objects
                       differ, over the pixels either side sets.

Two sound float32 computations may part only at a near-tie, and only
such a flip is admitted, each by its kind (the readings count them):
`score_tie` a detection whose score lies within SCORE_TIE of the
detector's confidence floor (0.7); `nms_tie` one whose IoU with a
higher-scoring detection of its class on the other side lies within
IOU_TIE of the detection NMS's 0.3; `rpn_tie` a proposal whose IoU with
a kept proposal on the other side lies within IOU_TIE of the RPN NMS's
0.7 (then the proposals after it in the list shift, and a detection on
that frame may have no partner); `cap_tie` an object that the 16-slot
cap kept on a side where it cut (that side holds exactly 16) whose mask
area equals the smallest area the other side kept (an exact tie, which
the two sides' sorts may break either way).  A paired detection's box
needs no number of its own: boxes are whole molded pixels, and pairing
at IoU >= PAIR_IOU bounds how far they may part.

The control is the reference computed in TF32 (the configuration states
float32 with TF32 off) in the program's place, on the same frames, its
objects unmolded and capped as the program's are.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from perfbench.harness import detect_weights as DWt
from perfbench.reference import maskrcnn_ref as R

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")
PAIR_IOU = 0.99
SCORE_TIE = 1e-5
IOU_TIE = 1e-5
CHECKS = ("det_pyramid_gap", "det_rpn_gap", "det_proposal_unpaired",
          "det_unpaired", "det_score_gap", "det_mask_gap",
          "dets_unpaired", "dets_mask_mismatch")
TIES = ("score_tie", "nms_tie", "rpn_tie", "cap_tie")


def detector_config(cfg: Dict) -> Dict:
    """The configuration's `detector` with its lists as tuples
    (MaskRCNNConfig's fields)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["detector"].items()}


def weights(cfg: Dict, device):
    """The detector's weights: one draw, from the configuration's own
    seed (detector_weights.seed), whatever the run's --seed."""
    dc = detector_config(cfg)
    w = cfg["detector_weights"]
    return DWt.make(R.layout(dc), int(w["seed"]), device, w["class_bias"],
                    dc["mean_pixel"])


def limits(config_name: str) -> Dict[str, float]:
    with open(os.path.join(LIMITS_DIR, config_name + ".json")) as fh:
        return json.load(fh)["detector"]


def tensor_gap(got, want) -> float:
    """max |got - want| over max |want| of two tensors; 1.0 where their
    shapes, or which entries are finite, or the non-finite values,
    differ."""
    import torch
    if got is None or tuple(got.shape) != tuple(want.shape):
        return 1.0
    got, want = got.double(), want.double()
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(fg, fw) or not torch.equal(got[~fg], want[~fw]):
        return 1.0
    if not bool(fw.any()):
        return 0.0
    scale = max(float(want[fw].abs().max()), 1e-30)
    return float((got[fg] - want[fw]).abs().max()) / scale


def box_iou(a: np.ndarray, b: np.ndarray, plus_one: bool) -> np.ndarray:
    """IoU [len(a), len(b)] of (y1, x1, y2, x2) boxes, pixel-inclusive
    with `plus_one`."""
    o = 1.0 if plus_one else 0.0
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    area = lambda x: (x[:, 2] - x[:, 0] + o) * (x[:, 3] - x[:, 1] + o)  # noqa
    hh = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]) + o, 0, None)
    ww = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]) + o, 0, None)
    inter = hh * ww
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def pair(boxes_a, cls_a, boxes_b, cls_b) -> List[Tuple[int, int]]:
    """One-to-one pairs (i, j) of the same class at IoU >= PAIR_IOU,
    greedily by IoU; pixel-inclusive, as the detector's NMS counts it, so
    that a box clipped flat against the frame's edge pairs too."""
    if not len(boxes_a) or not len(boxes_b):
        return []
    ov = box_iou(boxes_a, boxes_b, plus_one=True)
    ov[np.asarray(cls_a)[:, None] != np.asarray(cls_b)[None, :]] = -1.0
    ov = np.nan_to_num(ov, nan=-1.0)
    out, used_a, used_b = [], set(), set()
    for flat in np.argsort(-ov, axis=None, kind="stable"):
        i, j = divmod(int(flat), ov.shape[1])
        if ov[i, j] < PAIR_IOU:
            break
        if i not in used_a and j not in used_b:
            out.append((i, j))
            used_a.add(i)
            used_b.add(j)
    return out


def cap(cfg: Dict, class_ids, masks, rois):
    """The derenderer's slot cap (geometric/scripts/main.py:812-818):
    the max_objects largest masks."""
    m = int(cfg["max_objects"])
    if len(class_ids) > m:
        keep = np.argsort(-masks[:, 0].sum((1, 2)))[:m]
        return class_ids[keep], masks[keep], rois[keep]
    return class_ids, masks, rois


def own_dets(cfg: Dict, det: Dict, image: np.ndarray):
    """A reference-side detection record unmolded and capped as the
    timed chain does it: (class_ids, masks, rois)."""
    return cap(cfg, *R.unmold(
        det["boxes"].cpu().numpy(), det["class_ids"].cpu().numpy(),
        det["masks"].cpu().numpy(), det["window"], det["scale"],
        image.shape[:2]))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _proposal_ties(got, want, dim: float, thr: float
                   ) -> Tuple[int, int]:
    """(unpaired, admitted) proposals: a proposal pairs with an equal one
    on the other side; an unpaired one is admitted where its IoU with a
    proposal the other side kept lies within IOU_TIE of `thr`, and so
    are the other side's unpaired ones at the tail of the list, which
    such a flip shifts past the cut."""
    g, w = _np(got).reshape(-1, 4), _np(want).reshape(-1, 4)
    gs = {tuple(b) for b in g.tolist()}
    ws = {tuple(b) for b in w.tolist()}
    lone_g = [i for i, b in enumerate(g.tolist()) if tuple(b) not in ws]
    lone_w = [i for i, b in enumerate(w.tolist()) if tuple(b) not in gs]
    ties = 0
    for lone, mine, other in ((lone_g, g, w), (lone_w, w, g)):
        if lone and len(other):
            ov = box_iou(mine[lone] * dim, other * dim, plus_one=True)
            ties += int((np.abs(ov - thr) <= IOU_TIE).any(1).sum())
    # a flip shifts every later proposal by one place: as many of each
    # list's last proposals may lose their partner at the cut
    shifted = (sum(1 for i in lone_g if i >= len(g) - ties)
               + sum(1 for i in lone_w if i >= len(w) - ties))
    lone = len(lone_g) + len(lone_w)
    return lone, min(lone, ties + shifted)


def _detection_ties(cfg: Dict, got: Dict, want: Dict, pairs, rpn_tie: bool
                    ) -> Tuple[int, Dict[str, int]]:
    """(unpaired detections, admitted by kind)."""
    kinds = dict.fromkeys(TIES, 0)
    pg = {i for i, _ in pairs}
    pw = {j for _, j in pairs}
    lone = [(got, i, want) for i in range(len(got["class_ids"]))
            if i not in pg]
    lone += [(want, j, got) for j in range(len(want["class_ids"]))
             if j not in pw]
    floor = float(cfg["detection_min_confidence"])
    thr = float(cfg["detection_nms_threshold"])
    for mine, i, other in lone:
        score = float(_np(mine["scores"])[i])
        if abs(score - floor) <= SCORE_TIE:
            kinds["score_tie"] += 1
            continue
        same = ((_np(other["class_ids"]) == _np(mine["class_ids"])[i])
                & (_np(other["scores"]) >= score))
        if same.any():
            ov = box_iou(_np(mine["boxes"])[i], _np(other["boxes"])[same],
                         plus_one=True)
            if (np.abs(ov - thr) <= IOU_TIE).any():
                kinds["nms_tie"] += 1
                continue
        if rpn_tie:
            kinds["rpn_tie"] += 1
    return len(lone), kinds


def _object_ties(used, ref, pairs, cap_n: int) -> Tuple[int, int]:
    """(unpaired objects, admitted at the cap) of the timed path's objects
    against the reference's, given their pairs: an unpaired object is
    admitted only where its side's cap cut (cap_n objects kept) and its
    area equals the smallest area the other side kept."""
    areas = [d[1][:, 0].sum((1, 2)) if len(d[0]) else np.zeros(0)
             for d in (used, ref)]
    paired = [{i for i, _ in pairs}, {j for _, j in pairs}]
    lone = admitted = 0
    for side in (0, 1):
        other = areas[1 - side]
        for i, area in enumerate(areas[side]):
            if i in paired[side]:
                continue
            lone += 1
            if (len(areas[side]) == cap_n and len(other)
                    and area == other.min()):
                admitted += 1
    return lone, admitted


def readings(cfg: Dict, items: List[Dict], program: Dict[int, Dict],
             ref: Dict[int, Dict]) -> Dict[str, float]:
    """The numbers of the module's docstring, the worst over `items`
    (records of the timed requests: image_rgb and the dets the chain
    used), `program` and `ref` holding each frame's stage record by the
    id of its image."""
    dc = detector_config(cfg)
    dim = float(dc["image_max_dim"])
    out = dict.fromkeys(CHECKS, 0.0)
    out.update(dict.fromkeys(TIES, 0))
    out["detections"] = 0
    for key, want in ref.items():
        got = program[key]
        lv = [tensor_gap(g, w) for g, w in
              zip(got["pyramid"], want["pyramid"])]
        if len(got["pyramid"]) != len(want["pyramid"]):
            lv.append(1.0)
        out["det_pyramid_gap"] = max(out["det_pyramid_gap"], *lv)
        out["det_rpn_gap"] = max(
            out["det_rpn_gap"], tensor_gap(got["rpn_logits"],
                                           want["rpn_logits"]),
            tensor_gap(got["rpn_deltas"], want["rpn_deltas"]))
        lone_p, tied_p = _proposal_ties(got["proposals"], want["proposals"],
                                        dim, float(dc["rpn_nms_threshold"]))
        out["rpn_tie"] += tied_p
        out["det_proposal_unpaired"] = max(out["det_proposal_unpaired"],
                                           lone_p - tied_p)
        pairs = pair(_np(got["boxes"]), _np(got["class_ids"]),
                     _np(want["boxes"]), _np(want["class_ids"]))
        lone_d, kinds = _detection_ties(dc, got, want, pairs, tied_p > 0)
        for k, n in kinds.items():
            out[k] += n
        out["det_unpaired"] = max(out["det_unpaired"],
                                  lone_d - sum(kinds.values()))
        out["detections"] = max(out["detections"], len(want["class_ids"]))
        for i, j in pairs:
            out["det_score_gap"] = max(out["det_score_gap"], abs(
                float(_np(got["scores"])[i]) - float(_np(want["scores"])[j])))
            out["det_mask_gap"] = max(out["det_mask_gap"], float(np.abs(
                _np(got["masks"])[i] - _np(want["masks"])[j]).max()))
    for it in items:
        want = ref[id(it["image_rgb"])]["own"]
        used = it["dets"]
        pairs = pair(used[2], used[0], want[2], want[0])
        bad = sum(int(np.count_nonzero(used[1][i] != want[1][j]))
                  for i, j in pairs)
        lone, tied = _object_ties(used, want, pairs,
                                  int(cfg["max_objects"]))
        out["cap_tie"] += tied
        out["dets_unpaired"] = max(out["dets_unpaired"], lone - tied)
        union = sum(int(np.count_nonzero((used[1][i] > 0)
                                         | (want[1][j] > 0)))
                    for i, j in pairs)
        out["dets_mask_mismatch"] = max(out["dets_mask_mismatch"],
                                        bad / union if union else 0.0)
        out["objects_min"] = min(out.get("objects_min", 1 << 30),
                                 len(used[0]))
    return out


def detect_all(cfg: Dict, sd, items: List[Dict], device) -> Dict[int, Dict]:
    """The reference's record of each distinct frame of `items`, with its
    objects unmolded and capped (`own`)."""
    dc = detector_config(cfg)
    out = {}
    for it in items:
        key = id(it["image_rgb"])
        if key not in out:
            det = R.detect(sd, dc, it["image_rgb"], device)
            det["own"] = own_dets(cfg, det, it["image_rgb"])
            out[key] = det
    return out


def judge(cfg: Dict, seed: int, device, items: List[Dict],
          program: Dict[int, Dict], control: bool = False
          ) -> Dict[str, object]:
    """{"checks": {name: (reading, limit)}, "readings", "correct", and
    with `control` the control's readings}."""
    sd = weights(cfg, device)
    R.no_tf32()
    ref = detect_all(cfg, sd, items, device)
    got = readings(cfg, items, program, ref)
    lim = limits(cfg["name"])
    checks = {k: (got[k], lim[k]) for k in lim}
    out = {"checks": checks, "readings": got,
           "correct": all(v <= lim_ for v, lim_ in checks.values())}
    if control:
        R.no_tf32(True)
        try:
            ctl = detect_all(cfg, sd, items, device)
        finally:
            R.no_tf32()
        ctl_items = [dict(it, dets=ctl[id(it["image_rgb"])]["own"])
                     for it in items]
        out["control"] = readings(cfg, ctl_items, ctl, ref)
    return out


def flops(cfg: Dict) -> float:
    """FLOPs of one frame's detector at the program's fixed shapes:
    post_nms_rois_inference RoIs in the box head and
    detection_max_instances in the mask head (maskrcnn_ref.flops)."""
    dc = detector_config(cfg)
    return R.flops(dc, int(dc["post_nms_rois_inference"]),
                   int(dc["detection_max_instances"]))

