"""Semantic branch pipeline: training, multi-scale inference, metrics.

PyTorch counterpart of sdn3d_tpu/pipelines/semantic.py (semantic/
vkitti_{train,eval,test}.py):
  - SemanticTrainer: two SGD optimizers with momentum, one for the encoder
    and one for the decoder (vkitti_train.py:93-117), each optax's
    chain(add_decayed_weights(1e-4), sgd(poly schedule, momentum 0.9)),
    written as a plain function over the parameter lists (`sgd_step`);
    the loss is the NLL plus 0.4 times the deep-supervision head's
    (vkitti_train.py:225-226);
  - multi-scale averaged-softmax inference (vkitti_eval.py:50-107): one
    device pass per frame over the raw uint8 RGB frame (BGR flip, mean/std
    normalisation with true division, the float32 operations JAX's
    callers apply on the host before multiscale_inference /
    multiscale_labels; a resize to each scale's size rounded up to x8,
    the model, the sum of the softmaxes, the division by the scale count,
    a uint8 argmax) and one uint8 fetch;
  - mIoU and pixel accuracy (semantic/utils.py:146-173), host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch import parallel
from sdn3d_tpu_torch.data.semantic_data import (
    IMG_MAX_SIZE_EVAL, MEAN_BGR, STD_BGR, round2nearest_multiple)
from sdn3d_tpu_torch.models.semantic import (
    SemanticModel, pixel_accuracy, resize_bilinear, segmentation_loss)
from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn
from sdn3d_tpu_torch.utils.transfer import HostFetch, constant, to_device

EVAL_SCALES = (100, 150, 200, 300, 375)   # short-edge sizes


@torch.no_grad()
def sgd_step(params: List[torch.Tensor], grads: List[torch.Tensor],
             traces: List[torch.Tensor], lr: float, weight_decay: float,
             momentum: float) -> List[torch.Tensor]:
    """One step of optax.chain(add_decayed_weights(weight_decay),
    sgd(lr, momentum)) in optax's order: g + weight_decay * p, then the
    trace g + momentum * trace, then p + (-lr) * trace, each a multiply-add
    (fused, as XLA compiles optax's).  The parameters are updated in
    place; returns the new traces."""
    g = torch._foreach_add(grads, params, alpha=weight_decay)
    traces = torch._foreach_add(g, traces, alpha=momentum)
    torch._foreach_add_(params, traces, alpha=-lr)
    return traces


@dataclasses.dataclass
class SemanticTrainState:
    """The trainer's state (JAX SemanticTrainState): the step, the model
    (parameters and BatchNorm running statistics) and each optimizer's
    schedule count and momentum traces, in the order of
    `encoder.parameters()` / `decoder.parameters()`."""
    step: int
    model: SemanticModel
    count_enc: int
    count_dec: int
    trace_enc: List[torch.Tensor]
    trace_dec: List[torch.Tensor]

    def fields(self) -> Dict[str, object]:
        """The checkpoint fields of a train-state step (core/checkpoint):
        "encoder" and "decoder" (the state_dicts semantic_test --ckpt_dir
        reads), "opt_enc" and "opt_dec" ({"count", "trace"}, the traces by
        parameter name) and "step"."""
        out = {"encoder": self.model.encoder.state_dict(),
               "decoder": self.model.decoder.state_dict()}
        for key, net, count, trace in (
                ("opt_enc", self.model.encoder, self.count_enc,
                 self.trace_enc),
                ("opt_dec", self.model.decoder, self.count_dec,
                 self.trace_dec)):
            names = [n for n, _ in net.named_parameters()]
            out[key] = {"count": torch.tensor(count),
                        "trace": dict(zip(names, trace))}
        out["step"] = torch.tensor(self.step)
        return out

    @classmethod
    def from_fields(cls, fields: Dict[str, object],
                    model: SemanticModel) -> "SemanticTrainState":
        """The state of `fields` (a restored step, or utils/port.
        semantic_train_state_from_jax) with `model` loaded from its
        "encoder" and "decoder" state_dicts; the traces go to the model's
        device."""
        model.encoder.load_state_dict(fields["encoder"])
        model.decoder.load_state_dict(fields["decoder"])
        dev = next(model.parameters()).device
        traces = [[fields[key]["trace"][n].float().to(dev)
                   for n, _ in net.named_parameters()]
                  for key, net in (("opt_enc", model.encoder),
                                   ("opt_dec", model.decoder))]
        return cls(step=int(fields["step"]), model=model,
                   count_enc=int(fields["opt_enc"]["count"]),
                   count_dec=int(fields["opt_dec"]["count"]),
                   trace_enc=traces[0], trace_dec=traces[1])


@dataclasses.dataclass
class SemanticTrainer:
    """The train step of the semantic model (JAX SemanticTrainer): the
    forward in train mode (BatchNorm on the batch's statistics, dropout
    with the step's draws), the loss, its gradients under
    `deterministic_cudnn`, and one SGD step of each optimizer with the
    learning rate of its count before the step."""

    model: SemanticModel
    lr_encoder: float = 2e-2
    lr_decoder: float = 2e-2
    momentum: float = 0.9        # beta1
    weight_decay: float = 1e-4
    max_iters: int = 100_000
    lr_pow: float = 0.9
    deep_sup_scale: float = 0.4

    def init(self) -> SemanticTrainState:
        """Step 0 with the model's current weights and zero traces."""
        return SemanticTrainState(
            step=0, model=self.model, count_enc=0, count_dec=0,
            trace_enc=[torch.zeros_like(p)
                       for p in self.model.encoder.parameters()],
            trace_dec=[torch.zeros_like(p)
                       for p in self.model.decoder.parameters()])

    def learning_rate(self, base: float, count: int) -> float:
        """The poly schedule base * max(0, 1 - count / max_iters) ** lr_pow
        in float32 as XLA compiles jnp's expression in the JAX step: the
        division by the constant max_iters is a product with its float32
        reciprocal, fused with the subtraction into one rounding (so at
        count == max_iters the rate is a few 1e-9, not 0), and the power
        rounded once from float64; clamped at 0
        past max_iters (a negative base under a fractional power is
        NaN)."""
        f32 = np.float32
        recip = f32(1.0) / f32(self.max_iters)
        # the product of two float32 is exact in float64, and so is 1 - it
        frac = f32(1.0 - np.float64(f32(count)) * np.float64(recip))
        frac = np.maximum(f32(0.0), frac)
        # XLA's float32 pow rounds the float64 power once (numpy's powf is
        # 1 ulp off it on ~10% of counts)
        power = f32(np.float64(frac) ** np.float64(f32(self.lr_pow)))
        return float(f32(base) * power)

    def objective(self, out, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the loss, the pixel accuracy) of the training branch's outputs
        (log_p, log_d): NLL(log_p) + deep_sup_scale * NLL(log_d); a
        decoder without deep supervision gives log_p alone."""
        log_p, log_d = out if isinstance(out, tuple) else (out, None)
        total = segmentation_loss(log_p, labels)
        if log_d is not None:
            total = total + self.deep_sup_scale * segmentation_loss(log_d,
                                                                    labels)
        return total, pixel_accuracy(log_p, labels)

    def gradients(self, state: SemanticTrainState, images: torch.Tensor,
                  labels: torch.Tensor, dropout=None
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                             Dict[str, torch.Tensor]]:
        """The loss's gradients in the encoder's and the decoder's
        parameters and {"loss", "acc"}, from one training forward (which
        moves the BatchNorm running statistics) with `dropout`'s draws
        (models/semantic.SemanticModel.forward).  Under a process group
        the gradients (one flat collective over both halves) and the
        metrics are summed over the ranks: the global batch's."""
        model = state.model.train()
        enc = list(model.encoder.parameters())
        dec = list(model.decoder.parameters())
        with deterministic_cudnn():
            total, acc = self.objective(model(images, dropout=dropout),
                                        labels)
            grads = torch.autograd.grad(total, enc + dec, allow_unused=True)
        grads = parallel.sum_across_ranks(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(enc + dec, grads)])
        return (grads[:len(enc)], grads[len(enc):], parallel.sum_values(
            {"loss": total.detach(), "acc": acc.detach()}))

    def apply_gradients(self, state: SemanticTrainState,
                        g_enc: List[torch.Tensor], g_dec: List[torch.Tensor]
                        ) -> SemanticTrainState:
        """One SGD step of each optimizer, in place; the counts and the
        step advance by one."""
        model = state.model
        state.trace_enc = sgd_step(
            list(model.encoder.parameters()), g_enc, state.trace_enc,
            self.learning_rate(self.lr_encoder, state.count_enc),
            self.weight_decay, self.momentum)
        state.trace_dec = sgd_step(
            list(model.decoder.parameters()), g_dec, state.trace_dec,
            self.learning_rate(self.lr_decoder, state.count_dec),
            self.weight_decay, self.momentum)
        state.count_enc += 1
        state.count_dec += 1
        state.step += 1
        return state

    def train_step(self, state: SemanticTrainState, images: torch.Tensor,
                   labels: torch.Tensor, dropout=None
                   ) -> Tuple[SemanticTrainState, Dict[str, torch.Tensor]]:
        """One step on images [B, 3, H, W] float32 and labels [B, H/8, W/8]
        int (-1 ignored); dropout draws from `dropout` (a torch.Generator
        or the decoder's keep masks).  Updates the state in place and
        returns it with {"loss", "acc"} (device scalars)."""
        g_enc, g_dec, metrics = self.gradients(state, images, labels,
                                               dropout)
        return self.apply_gradients(state, g_enc, g_dec), metrics

    def make_train_step(self):
        """train_step(state, images, labels, dropout) -> (state, metrics)."""
        return self.train_step


def pad_to_multiple(image: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Pad H, W up to a multiple (semantic/vkitti_dataset.py padding)."""
    h, w = image.shape[:2]
    ph = -h % multiple
    pw = -w % multiple
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw)) + ((0, 0),) * (image.ndim - 2))
    return image


def scale_sizes(height: int, width: int,
                scales: Sequence[int] = EVAL_SCALES) -> List[Tuple[int, int]]:
    """Per-scale (h, w) of the reference eval protocol
    (vkitti_dataset.py:213-221): short edge to the scale, long-edge cap,
    both dims rounded UP to a multiple of 8 (the image is resized to
    them, not padded)."""
    sizes = []
    for s in scales:
        scale = min(s / min(height, width), IMG_MAX_SIZE_EVAL / max(height, width))
        sizes.append((round2nearest_multiple(int(height * scale), 8),
                      round2nearest_multiple(int(width * scale), 8)))
    return sizes


@torch.no_grad()
def _scales_mean(model: SemanticModel, x: torch.Tensor,
                 scales: Sequence[int]) -> torch.Tensor:
    """The mean over the scales of the softmax [C, H, W] of x [1, 3, H, W]
    resized to each scale's size (JAX multiscale_probs_device)."""
    H, W = x.shape[2], x.shape[3]
    total = None
    sizes = scale_sizes(H, W, scales)
    for hw in sizes:
        p = model(resize_bilinear(x, hw), seg_size=(H, W))[0]
        total = p if total is None else total + p
    return total / len(sizes)


def multiscale_probs_device(model: SemanticModel, image_rgb_u8: np.ndarray,
                            scales: Sequence[int] = EVAL_SCALES,
                            device="cuda") -> torch.Tensor:
    """Averaged multi-scale softmax [C, H, W] on the device, from the raw
    uint8 RGB frame [H, W, 3]: one upload of the frame, normalised on the
    device with the JAX program's float32 operations."""
    dev = torch.device(device)
    img = to_device(np.asarray(image_rgb_u8, np.uint8), dev)
    mean = constant(tuple(MEAN_BGR), torch.float32, dev)
    std = constant(tuple(STD_BGR), torch.float32, dev)
    with torch.no_grad():
        x = img.to(torch.float32).flip(-1)                  # BGR
        x = torch.div(x - mean, std)                        # true division
        return _scales_mean(model, x.permute(2, 0, 1)[None], scales)


def multiscale_labels_device(model: SemanticModel, image_rgb_u8: np.ndarray,
                             scales: Sequence[int] = EVAL_SCALES,
                             device="cuda") -> torch.Tensor:
    """Argmax labels [H, W] uint8 as a device tensor (one pass)."""
    probs = multiscale_probs_device(model, image_rgb_u8, scales, device)
    return torch.argmax(probs, dim=0).to(torch.uint8)


def multiscale_labels_begin(model: SemanticModel, image_rgb_u8: np.ndarray,
                            scales: Sequence[int] = EVAL_SCALES,
                            device="cuda") -> HostFetch:
    """multiscale_labels_fused with its copy left in flight: the labels'
    HostFetch, whose result() is the uint8 [H, W] map.  The pipelined
    chain enqueues a chunk's frames this way before it waits for any."""
    return HostFetch(multiscale_labels_device(model, image_rgb_u8, scales,
                                              device))


def multiscale_labels_fused(model: SemanticModel, image_rgb_u8: np.ndarray,
                            scales: Sequence[int] = EVAL_SCALES,
                            device="cuda") -> np.ndarray:
    """Argmax labels [H, W] uint8 from the raw uint8 RGB frame: one device
    pass and one 1-byte/pixel fetch."""
    return multiscale_labels_device(model, image_rgb_u8, scales,
                                    device).cpu().numpy()


def intersection_and_union(pred: np.ndarray, label: np.ndarray,
                           num_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class intersection and union areas (semantic/utils.py:146-173;
    labels < 0 ignored)."""
    pred = pred.astype(np.int64)
    label = label.astype(np.int64)
    pred = np.where(label >= 0, pred, -1)
    inter = pred[pred == label]
    area_inter, _ = np.histogram(inter, bins=num_class,
                                 range=(0, num_class - 1))
    area_pred, _ = np.histogram(pred, bins=num_class,
                                range=(0, num_class - 1))
    area_lab, _ = np.histogram(label, bins=num_class,
                               range=(0, num_class - 1))
    return area_inter, area_pred + area_lab - area_inter


def accuracy(pred: np.ndarray, label: np.ndarray) -> Tuple[float, int]:
    """(pixel accuracy over labels >= 0, their count)."""
    valid = label >= 0
    acc_sum = (valid & (pred == label)).sum()
    pixel_sum = valid.sum()
    return float(acc_sum) / (pixel_sum + 1e-10), int(pixel_sum)
