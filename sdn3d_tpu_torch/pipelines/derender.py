"""Derenderer training and eval steps.

PyTorch counterpart of sdn3d_tpu/pipelines/derender.py, itself the
geometric branch's training harness (geometric/scripts/main.py:114-154,
the losses; geometric/bulb/bulb/net.py, the epoch engine).  The optimizer
is optax's chain add_decayed_weights(weight_decay) -> scale_by_adam() ->
scale_by_learning_rate(exponential_decay(lr, lr_decay_steps,
lr_decay_rate, staircase=True)) in optax's arithmetic order: the decay
goes on every parameter (BatchNorm scales and every bias included) and on
no running statistic, the schedule is read at the count before the
increment (step 1 uses lr), the bias correction at the count after it.
The parameters and both moments are updated as one flat float32 buffer
(`pipelines/derender_infer.adam_step`), elementwise, so the order of the
arithmetic is the per-tensor one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch import parallel
from sdn3d_tpu_torch.models.derenderer import (
    Derenderer, DeviceMeshBank, TargetType, derender_forward)
from sdn3d_tpu_torch.pipelines.derender_infer import adam_step
from sdn3d_tpu_torch.utils import phases


def masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Mean of per-sample values x [B] over selected samples m [B] bool;
    0 when none is selected (BaseNet.partial, main.py:96-112).  Under a
    process group the count is the global batch's (parallel.global_count),
    so this is the rank's part of the global mean, whatever number of
    samples each rank selects."""
    m = m.to(x.dtype)
    return torch.sum(x * m) / torch.clamp_min(
        parallel.global_count(torch.sum(m)), 1.0)


def masked_mse(pred: torch.Tensor, gt: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """MSE over the selected samples: F.mse_loss(pred[idx], gt[idx]),
    which averages over all elements of the selected rows."""
    per_sample = torch.mean((pred - gt) ** 2, dim=tuple(range(1, pred.dim())))
    return masked_mean(per_sample, m)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, without autotuning, for the span of
    a train step; the flags found are restored after.  Its convolution
    backward otherwise adds with atomics, and two runs of a step differ in
    the last bits; under REINFORCE a moved bit can flip a later class
    draw."""
    c = torch.backends.cudnn
    found = c.deterministic, c.benchmark
    c.deterministic, c.benchmark = True, False
    try:
        yield
    finally:
        c.deterministic, c.benchmark = found


@dataclasses.dataclass
class TrainState:
    """The trainer's state: the step, the model (parameters and BatchNorm
    running statistics) and Adam's state, its count and the first and
    second moments as flat float32 buffers in the order of
    `model.named_parameters()`."""
    step: int
    model: Derenderer
    count: int
    mu: torch.Tensor
    nu: torch.Tensor

    def moments(self) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """(mu, nu) by parameter name, views of the flat buffers."""
        names, shapes = zip(*[(n, p.shape)
                              for n, p in self.model.named_parameters()])
        sizes = [int(np.prod(s)) for s in shapes]
        return tuple({n: c.view(s) for n, c, s in zip(names, buf.split(sizes),
                                                      shapes)}
                     for buf in (self.mu, self.nu))

    def fields(self) -> Dict[str, object]:
        """The checkpoint fields of a train-state step (core/checkpoint):
        "derenderer" (the state_dict that geometric_main --ckpt_dir
        reads), "opt_state" ({"count", "mu", "nu"}, the moments by
        parameter name) and "step"."""
        mu, nu = self.moments()
        return {"derenderer": self.model.state_dict(),
                "opt_state": {"count": torch.tensor(self.count),
                              "mu": mu, "nu": nu},
                "step": torch.tensor(self.step)}

    @classmethod
    def from_fields(cls, fields: Dict[str, object],
                    model: Derenderer) -> "TrainState":
        """The state of `fields` (a restored step, or
        utils/port.derender_train_state_from_jax) with `model` loaded
        from its "derenderer" state_dict; the moments go to the model's
        device."""
        model.load_state_dict(fields["derenderer"])
        opt = fields["opt_state"]
        dev = next(model.parameters()).device
        names = [n for n, _ in model.named_parameters()]
        mu, nu = (torch.cat([opt[k][n].reshape(-1).float() for n in names]
                            ).to(dev) for k in ("mu", "nu"))
        return cls(step=int(fields["step"]), model=model,
                   count=int(opt["count"]), mu=mu, nu=nu)


@dataclasses.dataclass
class DerenderTrainer:
    """Train and eval steps for the derenderer (JAX DerenderTrainer).

    The train step renders the silhouettes only: under the extend mode
    JAX's step also asks for the normal and depth maps, which no loss
    reads and jit drops as dead code; the port computes eagerly, so it
    does not ask (render_blob called directly still returns them).
    The forward and backward run under `deterministic_cudnn`."""

    model: Derenderer
    bank: Optional[DeviceMeshBank]
    mode: int
    image_size: int = 256
    render_size: int = 384
    mask_weight: float = 0.1
    ffd_coeff_reg: float = 1.0
    lr: float = 1e-3
    weight_decay: float = 1e-3
    lr_decay_steps: int = 10_000
    lr_decay_rate: float = 0.5

    def init(self) -> TrainState:
        """Step 0 with the model's current weights and zero moments."""
        p = torch.cat([q.detach().reshape(-1)
                       for q in self.model.parameters()])
        return TrainState(step=0, model=self.model, count=0,
                          mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def learning_rate(self, count: int) -> float:
        """optax.exponential_decay(lr, lr_decay_steps, lr_decay_rate,
        staircase=True) at `count`, in float32 as optax computes it."""
        if count <= 0:
            return float(np.float32(self.lr))
        p = np.floor(np.float32(count) / np.float32(self.lr_decay_steps))
        return float(np.float32(self.lr)
                     * np.power(np.float32(self.lr_decay_rate), p))

    def losses(self, blob: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Loss dict (main.py:114-154).  batch carries the GT tensors and
        the per-sample `targets` bitmask.  A loss family runs only where
        the batch has its targets: the geometry family needs "thetas", the
        reprojection family "masks" (a single-source dataset carries only
        its own family's targets; the hybrids' zero-fill collate gives
        both)."""
        targets = batch["targets"]
        loss = {}
        if self.mode & TargetType.geometry and "thetas" in batch:
            is_geo = (targets & TargetType.pretrain) > 0
            theta_deltas_gt = torch.cat([torch.cos(batch["thetas"]),
                                         torch.sin(batch["thetas"])], dim=1)
            loss["theta_delta_loss"] = masked_mse(
                blob["_theta_deltas"], theta_deltas_gt, is_geo)
            loss["translation2d_loss"] = masked_mse(
                blob["_translation2ds"], batch["translation2ds"], is_geo)
            loss["scale_loss"] = masked_mse(
                blob["_log_scales"], batch["log_scales"], is_geo)
            loss["depth_loss"] = masked_mse(
                blob["_log_depths"], batch["log_depths"], is_geo)
        if self.mode & TargetType.reproject and "masks" in batch:
            is_rep = (targets & TargetType.finetune) > 0
            ml = (1 - batch["ignores"]) \
                * (blob["_masks"] - batch["masks"]) ** 2
            mask_losses = self.mask_weight * ml.mean(dim=(1, 2, 3))  # [B]
            loss["class_reward"] = masked_mean(
                blob["_class_log_probs"] * mask_losses.detach(), is_rep)
            loss["mask_loss"] = masked_mean(mask_losses, is_rep)
            loss["ffd_coeff_reg"] = self.ffd_coeff_reg \
                * parallel.global_mean(blob["_ffd_coeffs"] ** 2)
        return loss

    def _forward(self, model: Derenderer, batch, training: bool,
                 generator=None) -> Dict[str, torch.Tensor]:
        mode = self.mode
        if training:
            mode &= ~(TargetType.normal | TargetType.depth)
        return derender_forward(
            model, batch["images"], batch["roi_norms"], batch["focals"],
            self.bank, mode, self.image_size, self.render_size,
            training=training, generator=generator)

    def gradients(self, state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator]
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """The loss's gradients in the parameters (in the order of
        `named_parameters()`) and the loss dict, from one training forward
        (which updates the BatchNorm running statistics), under
        `deterministic_cudnn`.  Under a process group the gradients and
        the losses are summed over the ranks (each one flat collective):
        the global batch's.  The forward and the losses are a
        `train.forward` span, the gradients a `train.backward` span and the
        sums a `train.optimizer` span (utils/phases)."""
        params = list(state.model.parameters())
        with deterministic_cudnn():
            with phases.phase("train.forward"):
                blob = self._forward(state.model, batch, True, generator)
                loss = self.losses(blob, batch)
                total = sum(loss.values())
            with phases.phase("train.backward"):
                grads = torch.autograd.grad(total, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
        with phases.phase("train.optimizer"):
            return (parallel.sum_across_ranks(grads),
                    parallel.sum_values({k: v.detach()
                                         for k, v in loss.items()}))

    @torch.no_grad()
    def apply_gradients(self, state: TrainState,
                        grads: List[torch.Tensor]) -> TrainState:
        """One optimizer step on the parameters, in place; count and step
        advance by one."""
        params = list(state.model.parameters())
        g = torch.cat([x.reshape(-1) for x in grads])
        p = torch.cat([x.reshape(-1) for x in params])
        lr = self.learning_rate(state.count)
        state.count += 1
        p, state.mu, state.nu = adam_step(p, g, state.mu, state.nu,
                                          state.count, lr,
                                          weight_decay=self.weight_decay)
        torch._foreach_copy_(params, [c.view(x.shape) for c, x in zip(
            p.split([x.numel() for x in params]), params)])
        state.step += 1
        return state

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step: forward in train mode (class draws from `generator`),
        the losses, their gradients, the optimizer.  Updates the state in
        place and returns it with the loss dict.  The step is a
        `train.step` span of id `state.count` (utils/phases) over the spans
        of `gradients` and a second `train.optimizer` span, Adam and the
        copy back."""
        with phases.phase("train.step", state.count):
            grads, loss = self.gradients(state, batch, generator)
            with phases.phase("train.optimizer"):
                state = self.apply_gradients(state, grads)
        return state, loss

    def make_train_step(self):
        """train_step(state, batch, generator) -> (state, losses)."""
        return self.train_step

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The losses under the inference camera (the argmax class, one
        render_targets rasterization of the mode's targets) with the
        running statistics."""
        return self.losses(self._forward(state.model, batch, False), batch)

    def make_eval_step(self):
        """eval_step(state, batch) -> losses."""
        return self.eval_step
