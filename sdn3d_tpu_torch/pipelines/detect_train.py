"""Mask R-CNN training with staged layer freezing, PyTorch port.

Counterpart of sdn3d_tpu/pipelines/detect_train.py (maskrcnn/model.py:
1823-1911 train_model: the layer-regex freezing of 'heads' -> '4+' ->
'all', SGD with momentum 0.9, clipnorm 5; the 4-stage VKITTI transfer
schedule, maskrcnn/vkitti.py:211-243).  Each parameter carries a label of
its stage ("train", "transfer", "freeze", `layer_labels`, read off the
port's module tree), and the optimizer is optax.multi_transform's over
those labels written as one flat update a group (`sgd_group_step`): the
group's gradients clipped by their own global norm, weight decay 1e-4 added
after the clip, then SGD's momentum trace t = g + 0.9 t and the update
-lr t.  "transfer" runs at lr 1e-2, "freeze" is never touched (no
gradient, no decay).  A frozen parameter does not require a gradient, so
the backward stops where the trained layers do.

The step runs under pipelines/derender.deterministic_cudnn, and the RoI
crops' backward sums in a fixed order (ops/roi_align.GatherRows): two
runs of a step give the same bits on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.models.layers import BatchNorm2d
from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                             generate_pyramid_anchors,
                                             init_weights)
from sdn3d_tpu_torch.models.maskrcnn_train import LOSS_NAMES, train_losses
from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn
from sdn3d_tpu_torch.pipelines.semantic import sgd_step

STAGES = ("transfer", "heads", "4+", "all")
GROUPS = ("train", "transfer")          # the groups the optimizer moves


def _layer_label(name: str, is_bn: bool, stage: str) -> str:
    """The label of parameter `name` of the port's MaskRCNN (reference
    state_dict names) in `stage` (model.py:1836-1848; JAX _layer_label).
    BatchNorm scales and biases are frozen in every stage (model.py:
    1477-1484 set_bn_fix); a BatchNorm is known by its module, since the
    reference's names do not all say so (the stem's fpn.C1.1, a
    downsample's downsample.1)."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: one of {STAGES}")
    if is_bn:
        return "freeze"
    parts = name.split(".")
    top, sub = parts[0], parts[1]
    in_resnet = top == "fpn" and sub in ("C1", "C2", "C3", "C4", "C5")
    is_head = top in ("rpn", "classifier", "mask") or (
        top == "fpn" and not in_resnet)
    if stage == "transfer":
        # the stage-0 class-count transfer (model.py:1861-1887): the class
        # dependent output layers in their own lr 1e-2 group, the other
        # heads at the stage's rate
        if (top == "mask" and sub == "conv5") or (
                top == "classifier" and sub in ("linear_class",
                                                "linear_bbox")):
            return "transfer"
        return "train" if is_head else "freeze"
    if stage == "heads":
        return "train" if is_head else "freeze"
    if stage == "4+":
        return "train" if is_head or sub in ("C4", "C5") else "freeze"
    return "train"                       # "all"


def layer_labels(model: torch.nn.Module, stage: str) -> Dict[str, str]:
    """{parameter name: "train" | "transfer" | "freeze"} of `model` in
    `stage`, in named_parameters() order."""
    bn = {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
          if isinstance(m, BatchNorm2d)
          for p_name, _ in m.named_parameters(recurse=False)}
    return {n: _layer_label(n, n in bn, stage)
            for n, _ in model.named_parameters()}


# The 4-stage VKITTI COCO-transfer schedule (vkitti.py:211-243); epochs are
# cumulative (the reference's train_model trains until `epochs`).
VKITTI_TRANSFER_SCHEDULE = (
    ("transfer", 1e-5, 10),
    ("heads", 1e-3, 40),
    ("4+", 1e-3 / 2, 70),
    ("all", 1e-3 / 5, 100),
)


def transfer_schedule(include_transfer: bool = True,
                      base_lr: float = 1e-3):
    """(stage, lr, until_epoch) of the reference schedule, scaled to
    `base_lr` (config.LEARNING_RATE)."""
    sched = []
    for stage, lr, until in VKITTI_TRANSFER_SCHEDULE:
        if stage == "transfer":
            if include_transfer:
                sched.append((stage, lr, until))
        else:
            sched.append((stage, base_lr * lr / 1e-3, until))
    return sched


def run_schedule(make_trainer, state, epochs_run: int = 0,
                 include_transfer: bool = True, base_lr: float = 1e-3,
                 epoch_fn=None):
    """Drive the staged schedule: a trainer (and its freezing optimizer)
    per stage, the model carried across stages and the optimizer state
    reset at each (the reference re-instantiates its optimizer per
    train_model call, model.py:1867-1874).

    make_trainer(stage=, learning_rate=) -> MaskRCNNTrainer;
    epoch_fn(trainer, state, epoch) -> state runs one epoch."""
    for stage, lr, until in transfer_schedule(include_transfer, base_lr):
        if epochs_run >= until:
            continue
        trainer = make_trainer(stage=stage, learning_rate=lr)
        state = trainer.init_opt(state)
        while epochs_run < until:
            state = epoch_fn(trainer, state, epochs_run)
            epochs_run += 1
    return state


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on a group's flat gradient: kept below
    max_norm, else (g / norm) * max_norm."""
    norm = torch.sqrt(torch.sum(g * g))
    return torch.where(norm < max_norm, g, g / norm * max_norm)


@torch.no_grad()
def sgd_group_step(params: List[torch.Tensor], grads: List[torch.Tensor],
                   trace: torch.Tensor, lr: float, weight_decay: float,
                   momentum: float, clipnorm: float) -> torch.Tensor:
    """One step of optax.chain(clip_by_global_norm(clipnorm),
    add_decayed_weights(weight_decay), sgd(lr, momentum)) over one
    label group, as one flat buffer: the parameters updated in place;
    returns the new flat trace."""
    g = clip_by_global_norm(torch.cat([x.reshape(-1) for x in grads]),
                            clipnorm)
    p = torch.cat([x.reshape(-1) for x in params])
    trace = sgd_step([p], [g], [trace], lr, weight_decay, momentum)[0]
    torch._foreach_copy_(params, [c.view(x.shape) for c, x in zip(
        p.split([x.numel() for x in params]), params)])
    return trace


@dataclasses.dataclass
class DetectTrainState:
    """The trainer's state (JAX: {"params", "batch_stats", "opt_state",
    "step"}): the step, the model (parameters and BatchNorm running
    statistics), the label of every parameter (the optimizer's stage) and
    each moved group's flat momentum trace, in the order of the group's
    parameters in named_parameters()."""
    step: int
    model: MaskRCNN
    labels: Dict[str, str]
    trace: Dict[str, torch.Tensor]

    def names(self, group: str) -> List[str]:
        return [n for n, lab in self.labels.items() if lab == group]

    def fields(self) -> Dict[str, object]:
        """The checkpoint fields of a train-state step (core/checkpoint):
        "maskrcnn" (the state_dict geometric_main and edit_chain
        --maskrcnn_ckpt read), "opt_state" ({"labels": {name: label},
        "trace": {group: {name: tensor}}}) and "step"."""
        sizes = dict((n, p.shape) for n, p in
                     self.model.named_parameters())
        trace = {}
        for group, flat in self.trace.items():
            names = self.names(group)
            trace[group] = {n: c.view(sizes[n]) for n, c in zip(
                names, flat.split([int(np.prod(sizes[n])) for n in names]))}
        return {"maskrcnn": self.model.state_dict(),
                "opt_state": {"labels": dict(self.labels), "trace": trace},
                "step": torch.tensor(self.step)}

    @classmethod
    def from_fields(cls, fields: Dict[str, object],
                    model: MaskRCNN) -> "DetectTrainState":
        """The state of `fields` (a restored step, or utils/port.
        maskrcnn_train_state_from_jax) with `model` loaded from its
        "maskrcnn" state_dict; the traces go to the model's device."""
        model.load_state_dict(fields["maskrcnn"])
        dev = next(model.parameters()).device
        given = fields["opt_state"]["labels"]
        labels = {n: given[n] for n, _ in model.named_parameters()}
        state = cls(step=int(fields["step"]), model=model, labels=labels,
                    trace={})
        for group, named in fields["opt_state"]["trace"].items():
            if not state.names(group):
                continue
            state.trace[group] = torch.cat(
                [named[n].reshape(-1).float() for n in state.names(group)]
            ).to(dev)
        return state


@dataclasses.dataclass
class MaskRCNNTrainer:
    """The train step of Mask R-CNN in one freezing `stage` (JAX
    MaskRCNNTrainer): train_forward of one frame, the five losses summed,
    their gradients in the stage's trained parameters, one SGD step a
    group.  `train_bn` False keeps BatchNorm in eval mode (the reference's
    set_bn_eval, which assumes COCO running statistics; from random
    weights the RPN's NLL starts near 216 and turns NaN within ten
    steps); True normalises each frame by its own statistics and moves the
    running ones (flax's rule)."""

    config: MaskRCNNConfig = MaskRCNNConfig()
    learning_rate: float = 1e-3          # config.py LEARNING_RATE
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clipnorm: float = 5.0
    stage: str = "heads"                 # "transfer"|"heads"|"4+"|"all"
    transfer_lr: float = 1e-2            # model.py:1866, the transfer group
    train_bn: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.stage not in STAGES:
            raise ValueError(f"stage {self.stage!r}: one of {STAGES}")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device")
        self.anchors = torch.from_numpy(
            generate_pyramid_anchors(self.config)).to(dev)

    def init(self, seed: int = 0, model: Optional[MaskRCNN] = None
             ) -> DetectTrainState:
        """Step 0: `model`, or the model at self.config with random weights
        from `seed` (models/maskrcnn.init_weights) on the trainer's
        device, with zero traces."""
        if model is None:
            model = init_weights(MaskRCNN(self.config), seed).to(self.device)
        return self.init_opt(DetectTrainState(step=0, model=model,
                                              labels={}, trace={}))

    def init_opt(self, state: DetectTrainState) -> DetectTrainState:
        """The optimizer state of this trainer's stage (JAX tx.init): the
        stage's labels and zero traces; the model and step are kept."""
        state.labels = layer_labels(state.model, self.stage)
        params = dict(state.model.named_parameters())
        state.trace = {}
        for group in GROUPS:
            n = sum(params[k].numel() for k in state.names(group))
            if n:
                state.trace[group] = torch.zeros(
                    n, device=next(state.model.parameters()).device)
        return state

    def _losses(self, model: MaskRCNN, images, rpn_match, rpn_target_bbox,
                gt_class_ids, gt_boxes, gt_masks, draws, anchors):
        out = model.train_forward(images, anchors, gt_class_ids, gt_boxes,
                                  gt_masks, draws, train_bn=self.train_bn)
        return train_losses(out, rpn_match, rpn_target_bbox)

    def _grads(self, state: DetectTrainState, total: torch.Tensor,
               params: Dict[str, torch.Tensor]
               ) -> Dict[str, List[torch.Tensor]]:
        """The total's gradients by moved group, in the groups' orders."""
        names = [n for g in GROUPS for n in state.names(g)]
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        by_name = {n: torch.zeros_like(params[n]) if g is None else g
                   for n, g in zip(names, grads)}
        return {g: [by_name[n] for n in state.names(g)] for g in GROUPS}

    def _requires_grad(self, state: DetectTrainState):
        params = dict(state.model.named_parameters())
        for n, p in params.items():
            p.requires_grad_(state.labels[n] != "freeze")
        return params

    def gradients(self, state: DetectTrainState, images: torch.Tensor,
                  rpn_match: torch.Tensor, rpn_target_bbox: torch.Tensor,
                  gt_class_ids: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_masks: torch.Tensor, draws, anchors=None
                  ) -> Tuple[Dict[str, List[torch.Tensor]],
                             Dict[str, torch.Tensor]]:
        """The summed losses' gradients by moved group and the loss dict
        (LOSS_NAMES) of one frame, under deterministic_cudnn."""
        anchors = self.anchors if anchors is None else anchors
        params = self._requires_grad(state)
        with deterministic_cudnn():
            losses = self._losses(state.model, images, rpn_match,
                                  rpn_target_bbox, gt_class_ids, gt_boxes,
                                  gt_masks, draws, anchors)
            grads = self._grads(state, sum(losses.values()), params)
        return grads, {k: v.detach() for k, v in losses.items()}

    def apply_gradients(self, state: DetectTrainState,
                        grads: Dict[str, List[torch.Tensor]]
                        ) -> DetectTrainState:
        """One SGD step of each moved group, in place; the step advances."""
        params = dict(state.model.named_parameters())
        for group, trace in state.trace.items():
            lr = (self.transfer_lr if group == "transfer"
                  else self.learning_rate)
            state.trace[group] = sgd_group_step(
                [params[n] for n in state.names(group)], grads[group], trace,
                lr, self.weight_decay, self.momentum, self.clipnorm)
        state.step += 1
        return state

    def train_step(self, state: DetectTrainState, images: torch.Tensor,
                   rpn_match: torch.Tensor, rpn_target_bbox: torch.Tensor,
                   gt_class_ids: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_masks: torch.Tensor, draws, anchors=None
                   ) -> Tuple[DetectTrainState, Dict[str, torch.Tensor]]:
        """One step on one frame: images [1, 3, H, W] mean-subtracted,
        rpn_match [A], rpn_target_bbox [R, 4], gt_class_ids [G], gt_boxes
        [G, 4] normalised, gt_masks [G, mh, mw]; `draws` the detection
        targets' (a torch.Generator on the device, or the two uniform
        draws).  Updates the state in place; returns it with the losses
        (device scalars)."""
        grads, losses = self.gradients(state, images, rpn_match,
                                       rpn_target_bbox, gt_class_ids,
                                       gt_boxes, gt_masks, draws, anchors)
        return self.apply_gradients(state, grads), losses

    def make_train_step(self):
        """train_step(state, images, rpn_match, rpn_target_bbox,
        gt_class_ids, gt_boxes, gt_masks, draws[, anchors])."""
        return self.train_step

    def gradients_batched(self, state: DetectTrainState, images, rpn_match,
                          rpn_target_bbox, gt_class_ids, gt_boxes, gt_masks,
                          draws: Sequence, anchors=None):
        """B frames (each argument with a leading [B] axis, `draws` one
        per frame) through the one-frame graph: the losses meaned over the
        frames, their gradients by group, and with train_bn each frame
        normalised by its own statistics and the running statistics the
        mean of the frames' updated ones (JAX vmaps the one-frame graph,
        make_train_step_batched)."""
        anchors = self.anchors if anchors is None else anchors
        params = self._requires_grad(state)
        model = state.model
        running = {n: b for n, b in model.named_buffers()
                   if self.train_bn
                   and n.endswith(("running_mean", "running_var"))}
        start = {n: b.clone() for n, b in running.items()}
        moved = {n: [] for n in running}
        per = {k: [] for k in LOSS_NAMES}
        with deterministic_cudnn():
            for b in range(images.shape[0]):
                with torch.no_grad():
                    for n, buf in running.items():
                        buf.copy_(start[n])
                out = self._losses(model, images[b:b + 1], rpn_match[b],
                                   rpn_target_bbox[b], gt_class_ids[b],
                                   gt_boxes[b], gt_masks[b], draws[b],
                                   anchors)
                for k in LOSS_NAMES:
                    per[k].append(out[k])
                for n, buf in running.items():
                    moved[n].append(buf.clone())
            losses = {k: torch.stack(v).mean() for k, v in per.items()}
            grads = self._grads(state, sum(losses.values()), params)
        with torch.no_grad():
            for n, buf in running.items():
                buf.copy_(torch.stack(moved[n]).mean(0))
        return grads, {k: v.detach() for k, v in losses.items()}

    def train_step_batched(self, state: DetectTrainState, images, rpn_match,
                           rpn_target_bbox, gt_class_ids, gt_boxes,
                           gt_masks, draws: Sequence, anchors=None):
        """gradients_batched, then ONE optimizer step (the reference
        accumulated B batch-1 backward passes, model.py:1958-1963)."""
        grads, losses = self.gradients_batched(
            state, images, rpn_match, rpn_target_bbox, gt_class_ids,
            gt_boxes, gt_masks, draws, anchors)
        return self.apply_gradients(state, grads), losses

    def make_train_step_batched(self):
        """train_step_batched(state, images [B, 3, H, W], ... [B, ...],
        draws (one per frame)[, anchors])."""
        return self.train_step_batched
