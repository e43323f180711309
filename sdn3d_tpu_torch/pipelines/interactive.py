"""Interactive editing operations on textural conditioning state
(PyTorch port of sdn3d_tpu/pipelines/interactive.py; the state and its
operations are host numpy, the generation is injected).

Capability-equivalent of textural/models/ui_model.py (the Cityscapes demo
model): change region labels, remove/add objects, transfer per-instance
texture ("style") codes, click-driven label swaps (ui_model.py:119-151),
square-brush strokes (:153-190), click-anchored object pastes (:192-216),
multi-style previews over a crop region (:225-283), and a single-level
undo/reset history (:94-106, :285-290).

Design note: the reference mutates a dense per-pixel feat_map in place;
here instance style lives in `feat_codes` (inst id -> [feat_num]) and is
splatted to a map once per generation (to_batch) — same conditioning
tensor, one scatter instead of per-op feature-map surgery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class EditState:
    """Mutable conditioning state for a single image."""
    label: np.ndarray               # [H, W] int32
    inst: np.ndarray                # [H, W] int32
    feat_codes: Dict[int, np.ndarray]   # inst id -> [feat_num]
    pose: Optional[np.ndarray] = None   # [H, W] int32 bins
    normal: Optional[np.ndarray] = None  # [H, W, 3]

    def copy(self) -> "EditState":
        return EditState(self.label.copy(), self.inst.copy(),
                         {k: v.copy() for k, v in self.feat_codes.items()},
                         None if self.pose is None else self.pose.copy(),
                         None if self.normal is None else self.normal.copy())


def change_label(state: EditState, region: np.ndarray,
                 new_label: int) -> EditState:
    """ui_model 'change label' brush: region [H, W] bool."""
    out = state.copy()
    out.label = np.where(region, np.int32(new_label), out.label)
    out.inst = np.where(region & (out.inst < 1000), np.int32(new_label),
                        out.inst)
    return out


def remove_object(state: EditState, inst_id: int,
                  fill_label: int = 5) -> EditState:
    """Delete an instance; exposed pixels become `fill_label` (road)."""
    out = state.copy()
    sel = out.inst == inst_id
    out.label = np.where(sel, np.int32(fill_label), out.label)
    out.inst = np.where(sel, np.int32(fill_label), out.inst)
    out.feat_codes.pop(inst_id, None)
    if out.pose is not None:
        out.pose = np.where(sel, 0, out.pose)
    return out


def add_object(state: EditState, mask: np.ndarray, inst_id: int,
               label: int, code: np.ndarray,
               pose_bin: int = 0) -> EditState:
    """Paste a new instance (ui_model 'add object')."""
    out = state.copy()
    out.label = np.where(mask, np.int32(label), out.label)
    out.inst = np.where(mask, np.int32(inst_id), out.inst)
    out.feat_codes[inst_id] = np.asarray(code, np.float32)
    if out.pose is not None and pose_bin:
        out.pose = np.where(mask, np.int32(pose_bin), out.pose)
    return out


def transfer_style(state: EditState, inst_id: int,
                   code: np.ndarray) -> EditState:
    """ui_model 'style brush': swap an instance's texture code."""
    out = state.copy()
    out.feat_codes[inst_id] = np.asarray(code, np.float32)
    return out


def load_state(label: np.ndarray, inst: np.ndarray,
               features_clustered: Dict[int, np.ndarray],
               pose: Optional[np.ndarray] = None,
               normal: Optional[np.ndarray] = None) -> EditState:
    """Build an EditState from label/inst maps + a per-class style-cluster
    table (ui_model.py:74-87): every instance draws one cluster row from
    its class's table, with the reference's deterministic per-instance
    seed (np.random.seed(i + 1))."""
    label = np.asarray(label, np.int32)
    inst = np.asarray(inst, np.int32)
    codes: Dict[int, np.ndarray] = {}
    for i in np.unique(inst):
        i = int(i)
        cls = i if i < 1000 else i // 1000
        if cls in features_clustered:
            feat = np.asarray(features_clustered[cls], np.float32)
            rs = np.random.RandomState(i + 1)
            codes[i] = feat[rs.randint(0, feat.shape[0])].copy()
    return EditState(label.copy(), inst.copy(), codes,
                     None if pose is None else np.asarray(pose, np.int32),
                     None if normal is None else np.asarray(normal))


class EditSession:
    """Undoable edit session (ui_model.py reset/undo/backup_current_state,
    :94-106, :285-290): single-level undo + reset-to-original, matching
    the reference's *_prev / *_original clones."""

    def __init__(self, state: EditState):
        self._original = state.copy()
        self._prev = state.copy()
        self.state = state.copy()

    def apply(self, fn: Callable[..., EditState], *args, **kwargs
              ) -> EditState:
        self._prev = self.state
        self.state = fn(self.state, *args, **kwargs)
        return self.state

    def undo(self) -> EditState:
        self.state = self._prev
        return self.state

    def reset(self) -> EditState:
        self.state = self._prev = self._original.copy()
        return self.state


def _new_instance_id(inst: np.ndarray, label_tgt: int) -> int:
    """Allocate a fresh instance id within label_tgt's 1000-band
    (ui_model.py:138-142)."""
    band = (inst > label_tgt * 1000) & (inst < (label_tgt + 1) * 1000)
    return (int(inst[band].max()) + 1) if band.any() \
        else label_tgt * 1000 + 1


def change_labels_click(state: EditState, click_src: Tuple[int, int],
                        click_tgt: Tuple[int, int]) -> EditState:
    """Click-driven label swap (ui_model.py:119-151): the whole instance
    under click_src takes the label of click_tgt; instanced targets get a
    freshly allocated id; the moved region keeps its own texture code (the
    reference's copy_features reads the pre-update feat_map at the first
    target pixel, i.e. the source's features)."""
    out = state.copy()
    ys, xs = click_src
    yt, xt = click_tgt
    inst_src = int(out.inst[ys, xs])
    label_tgt = int(out.label[yt, xt])
    inst_tgt = int(out.inst[yt, xt])
    sel = out.inst == inst_src
    # >= 1000: instance ids are k*1000-banded with k >= 1, so id exactly
    # 1000 (object index 1) is instanced too — same test as load_state /
    # change_label's `inst < 1000` uninstanced check.
    if inst_tgt >= 1000:
        inst_tgt = _new_instance_id(out.inst, label_tgt)
    out.label = np.where(sel, np.int32(label_tgt), out.label)
    out.inst = np.where(sel, np.int32(inst_tgt), out.inst)
    if inst_tgt not in out.feat_codes and inst_src in out.feat_codes:
        out.feat_codes[inst_tgt] = out.feat_codes[inst_src].copy()
    if not (out.inst == inst_src).any():
        out.feat_codes.pop(inst_src, None)
    return out


def stroke_region(shape: Tuple[int, int], click: Tuple[int, int],
                  brush_width: int) -> np.ndarray:
    """Square brush footprint, edge-clamped (ui_model.py:155-163)."""
    H, W = shape
    y, x = click
    region = np.zeros((H, W), bool)
    y0 = min(H - 1, max(0, y - brush_width // 2))
    x0 = min(W - 1, max(0, x - brush_width // 2))
    region[y0:min(H, y0 + brush_width), x0:min(W, x0 + brush_width)] = True
    return region


def add_strokes(state: EditState, click: Tuple[int, int], label_tgt: int,
                brush_width: int,
                features_clustered: Optional[Dict[int, np.ndarray]] = None,
                cluster_idx: int = 0) -> EditState:
    """Brush-paint label_tgt over a bw x bw square (ui_model.py:153-190);
    painted pixels join the class-level instance label_tgt, which takes
    the class's cluster_idx style row when a table is given."""
    out = state.copy()
    region = stroke_region(out.label.shape, click, brush_width)
    out.label = np.where(region, np.int32(label_tgt), out.label)
    out.inst = np.where(region, np.int32(label_tgt), out.inst)
    if features_clustered and label_tgt in features_clustered:
        feat = np.asarray(features_clustered[label_tgt], np.float32)
        out.feat_codes[label_tgt] = feat[cluster_idx].copy()
    return out


def add_objects_click(state: EditState, click: Tuple[int, int],
                      label_tgt: int, mask: np.ndarray,
                      features_clustered: Dict[int, np.ndarray],
                      style_id: int = 0) -> EditState:
    """Paste an object template at a click point with a selected class
    style (ui_model.py:192-216).  mask: [h, w] bool template anchored at
    the click's top-left."""
    out = state.copy()
    H, W = out.label.shape
    y, x = click
    mh = min(mask.shape[0], H - y)
    mw = min(mask.shape[1], W - x)
    region = np.zeros((H, W), bool)
    region[y:y + mh, x:x + mw] = np.asarray(mask, bool)[:mh, :mw]
    out.label = np.where(region, np.int32(label_tgt), out.label)
    out.inst = np.where(region, np.int32(label_tgt), out.inst)
    feat = np.asarray(features_clustered[label_tgt], np.float32)
    out.feat_codes[label_tgt] = feat[style_id].copy()
    return out


def get_crop_region(mask: np.ndarray, crop_min: int = 128
                    ) -> Tuple[int, int, int, int]:
    """(min_y, min_x, max_y, max_x) around a mask, padded to at least
    crop_min per side (ui_model.py:292-305).  The maxes are EXCLUSIVE
    slice bounds — img[min_y:max_y, min_x:max_x] covers the whole mask."""
    H, W = mask.shape
    ys, xs = np.nonzero(mask)
    min_y, max_y = int(ys.min()), int(ys.max()) + 1
    min_x, max_x = int(xs.min()), int(xs.max()) + 1
    if max_y - min_y < crop_min:
        min_y = max(0, (max_y + min_y) // 2 - crop_min // 2)
        max_y = min(H, min_y + crop_min)
    if max_x - min_x < crop_min:
        min_x = max(0, (max_x + min_x) // 2 - crop_min // 2)
        max_x = min(W, min_x + crop_min)
    return (min_y, min_x, max_y, max_x)


def style_forward(state: EditState, click_pt: Tuple[int, int],
                  features_clustered: Dict[int, np.ndarray],
                  generate: Callable[[EditState], np.ndarray],
                  style_id: int = -1, multiple_output: int = 4,
                  crop_min: int = 128
                  ) -> Tuple[List[np.ndarray], EditState,
                             Tuple[int, int, int, int]]:
    """Style preview / selection (ui_model.py:225-283).

    style_id == -1: regenerate the clicked instance under each of the
    first `multiple_output` class style rows and return the previews
    cropped to the instance's region.  Otherwise: commit that style row
    and return the single full-frame regeneration.

    `generate` maps an EditState to an image array (e.g.
    `textural_generate`: the port's TexturalTrainer.fake_inference over
    to_batch) — injected so this op stays free of model plumbing."""
    inst_id = int(state.inst[click_pt[0], click_pt[1]])
    cls = inst_id if inst_id < 1000 else inst_id // 1000
    feat = np.asarray(features_clustered[cls], np.float32)
    mask = state.inst == inst_id
    crop = get_crop_region(mask, crop_min)
    min_y, min_x, max_y, max_x = crop
    if style_id == -1:
        previews = []
        for cluster_idx in range(min(multiple_output, feat.shape[0])):
            s = transfer_style(state, inst_id, feat[cluster_idx])
            img = np.asarray(generate(s))
            previews.append(img[min_y:max_y, min_x:max_x])
        return previews, state, crop
    s = transfer_style(state, inst_id, feat[style_id])
    return [np.asarray(generate(s))], s, crop


def to_batch(state: EditState, max_instances: int = 64) -> Dict[str, np.ndarray]:
    """Conditioning state -> a fake_inference batch (+ splatted feat map)."""
    from sdn3d_tpu_torch.data.textural_data import (
        dense_instance_slots, splat_feat_codes)

    slots, _ = dense_instance_slots(state.inst, max_instances)
    feat_num = (len(next(iter(state.feat_codes.values())))
                if state.feat_codes else 5)
    feat = splat_feat_codes(state.inst, state.feat_codes, feat_num)
    batch = {
        "label": state.label[None],
        "inst": state.inst[None],
        "inst_slots": slots[None],
        "feat_map": feat[None],
    }
    if state.pose is not None:
        batch["pose"] = state.pose[None]
    if state.normal is not None:
        batch["normal"] = state.normal[None].astype(np.float32)
    return batch


def textural_generate(trainer, max_instances: Optional[int] = None
                      ) -> Callable[[EditState], np.ndarray]:
    """`generate` for style_forward: an EditState through `to_batch` and
    the port's TexturalTrainer.fake_inference (pipelines/textural.py) on
    the trainer's device, with the state's splatted feat map; returns the
    fake [H, W, 3] float32 in [-1, 1] on the host."""
    import torch

    n = trainer.cfg.max_instances if max_instances is None else max_instances

    def generate(state: EditState) -> np.ndarray:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in to_batch(state, n).items()}
        feat = batch.pop("feat_map")
        return trainer.fake_inference(batch, feat)[0].cpu().numpy()

    return generate
