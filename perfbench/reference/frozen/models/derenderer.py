# Frozen copy of sdn3d_tpu_torch/models/derenderer.py at commit 48e7a10, the package name
# rewritten; part of the benchmark's plain reference.  One edit:
# strict_fp32 reads ALLOW_TF32.
"""3D de-renderer: per-object pose/shape/class inference + re-rendering.

PyTorch counterpart of sdn3d_tpu/models/derenderer.py: the encoder is a
resnet18 trunk + FC heads (derender3d/models/derenderer.py:7-65);
`render_blob` gathers each slot's mesh from a padded MeshBank, deforms it
(FFD) and renders every slot in one rasterization, either for inference
(no gradient, argmax class) or, with `training=True`, as differentiable
renders under the training camera, the class drawn for REINFORCE
(`select_class(sample=True)`) unless `force_no_sample`.
`derender_forward` is the whole Derenderer3d.forward: ROI features,
encoder, reprojection.
Module names follow the reference state_dict (`net.conv1`,
`net.layerI.J.*`, `net.fc`, `fc1`, `fc2`, `_fc3`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perfbench.reference.frozen import parallel
from perfbench.reference.frozen.geometry import ffd as ffd_mod
from perfbench.reference.frozen.geometry.transforms import perspective_transform
from perfbench.reference.frozen.models.resnet import ResNetClassifier
from perfbench.reference.frozen.render.renderer import RenderType, render, render_targets


class TargetType:
    """Bitmask (geometric/derender3d/__init__.py:1-10)."""
    geometry = 1 << 0
    reproject = 1 << 1
    normal = 1 << 2
    depth = 1 << 3

    pretrain = geometry
    finetune = reproject
    full = geometry | reproject
    extend = geometry | reproject | normal | depth

    BY_NAME: Dict[str, int] = {}


TargetType.BY_NAME = {
    "pretrain": TargetType.pretrain,
    "finetune": TargetType.finetune,
    "full": TargetType.full,
    "extend": TargetType.extend,
}


# The benchmark's control sets this True to compute the reference in TF32
# (the one edit of this frozen copy).
ALLOW_TF32 = False


def strict_fp32() -> None:
    """Keep float32 convolutions and products in full float32 on the card
    (in TF32 where the control sets ALLOW_TF32)."""
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32


class Derenderer(nn.Module):
    """Encoder net (derenderer.py:7-65): resnet18 -> 256 feats, concat
    [feat ‖ mroi ‖ droi] -> fc1 -> fc2 -> heads.  `dtype` is the compute
    dtype of the resnet18 trunk and its fc (JAX models/derenderer.py:
    57-59); the heads compute and return float32."""

    def __init__(self, num_classes: int = 8, grid_size: int = 4,
                 hidden_size: int = 256, dtype="float32"):
        super().__init__()
        self.num_classes = num_classes
        self.grid_size = grid_size
        g3 = grid_size ** 3
        self.out_sizes = {
            "_theta_deltas": 2,
            "_translation2ds": 2,
            "_log_scales": 3,
            "_log_depths": 1,
            "_class_probs": num_classes,
            "_ffd_coeffs": num_classes * g3 * 3,
        }
        self.net = ResNetClassifier(num_outputs=hidden_size, dtype=dtype)
        self.fc1 = nn.Linear(hidden_size + 4, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)
        self._fc3 = nn.Linear(hidden_size, sum(self.out_sizes.values()))

    def forward(self, images: torch.Tensor, mroi_norms: torch.Tensor,
                droi_norms: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] (NHWC, the JAX layout), mroi/droi [B, 2]."""
        if images.is_cuda:
            strict_fp32()
        x = self.net(images.permute(0, 3, 1, 2))
        x = torch.relu(x)
        x = torch.cat([x, mroi_norms, droi_norms], dim=1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        x = self._fc3(x)
        (theta_deltas, translation2ds, log_scales, log_depths, class_logits,
         ffd_coeffs) = torch.split(x, list(self.out_sizes.values()), dim=1)
        theta_deltas = theta_deltas / torch.linalg.norm(
            theta_deltas, dim=1, keepdim=True)
        return {
            "_theta_deltas": theta_deltas,
            "_translation2ds": translation2ds,
            "_log_scales": log_scales,
            "_log_depths": log_depths,
            "_class_probs": torch.softmax(class_logits, dim=1),
            "_ffd_coeffs": ffd_coeffs.reshape(-1, self.num_classes,
                                              self.grid_size ** 3 * 3),
        }


@dataclasses.dataclass
class DeviceMeshBank:
    """MeshBank moved to a device as tensors (see geometry/assets.py)."""
    vertices: torch.Tensor    # [M, V, 3]
    faces: torch.Tensor       # [M, F, 3] int32
    face_valid: torch.Tensor  # [M, F] bool
    ffd_B: torch.Tensor       # [M, V, G, G, G]
    ffd_P0: torch.Tensor      # [3, G, G, G]
    adjacency: torch.Tensor   # [M, V, D] int32 (face*4+corner, -1 padded)

    @classmethod
    def from_host(cls, bank, device="cuda") -> "DeviceMeshBank":
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        return cls(vertices=t(bank.vertices), faces=t(bank.faces),
                   face_valid=t(bank.face_valid), ffd_B=t(bank.ffd_B),
                   ffd_P0=t(bank.ffd_P0), adjacency=t(bank.adjacency))


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as one IEEE division (a Python number over a tensor is
    otherwise computed as c * (1 / t), which rounds twice)."""
    return torch.full_like(t, c) / t


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.mod for floats: fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def pose_from_blob(blob: Dict[str, torch.Tensor], image_size: int,
                   render_size: int, training: bool) -> Dict[str, torch.Tensor]:
    """Convert encoder outputs to 3D pose quantities
    (derender3d/models/__init__.py:94-155), batched."""
    mroi = blob["_mroi_norms"]
    droi = blob["_droi_norms"]
    focals = blob["_focals"]                  # [B, 1]
    theta_deltas = blob["_theta_deltas"]

    thetas = torch.atan2(theta_deltas[:, 1], theta_deltas[:, 0])[:, None]
    rotations = torch.cat([torch.cos(thetas / 2), torch.zeros_like(thetas),
                           torch.sin(thetas / 2), torch.zeros_like(thetas)],
                          dim=1)
    areas = (droi[:, 0] * droi[:, 1])[:, None]
    scales = torch.exp(blob["_log_scales"])
    depths = torch.sqrt(torch.exp(blob["_log_depths"]) / areas)

    center2ds = mroi + blob["_translation2ds"] * droi
    tu = torch.stack([center2ds[:, 1], -center2ds[:, 0],
                      -torch.ones_like(center2ds[:, 0])], dim=1)
    tu = tu / torch.linalg.norm(tu, dim=1, keepdim=True)
    translations = depths * tu

    alphas = -(thetas - torch.atan(translations[:, 0:1] / translations[:, 2:3]))
    alphas = _mod(alphas + math.pi, 2 * math.pi) - math.pi

    out = {
        "_thetas": thetas,
        "_rotations": rotations,
        "_scales": scales,
        "_depths": depths,
        "_center2ds": center2ds,
        "_translations": translations,
        "_alphas": alphas,
    }
    if training:
        ptu = torch.stack([mroi[:, 1], -mroi[:, 0],
                           -torch.ones_like(mroi[:, 0])], dim=1)
        ptu = ptu / torch.linalg.norm(ptu, dim=1, keepdim=True)
        out["_perspective_translations"] = depths * ptu
        # NOTE: image_size (the encoder crop), NOT render_size, scales the
        # training zoom even though rasterization runs at render_size —
        # faithful to the reference (__init__.py:150 vs :65,202).
        out["_zooms"] = rdiv(image_size, focals) / torch.amax(
            droi, dim=1, keepdim=True)
    else:
        out["_zoom_tos"] = rdiv(render_size, 2.0 * focals)
    return out


def select_class(class_probs: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 sample: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Categorical draw (training, REINFORCE) or argmax (eval)
    (__init__.py:131-140).  Returns (class_idx [B] int32, log_prob [B]).

    The draw is jax.random.categorical's: the argmax of log(p + 1e-20)
    plus Gumbel noise -log(-log(u)), u uniform in [tiny, 1) from
    `generator` (a torch.Generator on the tensor's device, or a
    parallel.BatchDraw: this rank's rows of the global batch's draw);
    log_prob is log(p[idx] + 1e-20), differentiable in class_probs."""
    if sample:
        if generator is None:
            raise ValueError("select_class(sample=True) needs a generator")
        u = parallel.rand_rows(class_probs.shape, generator,
                               dtype=class_probs.dtype,
                               device=class_probs.device)
        u = torch.clamp_min(u, torch.finfo(class_probs.dtype).tiny)
        gumbel = -torch.log(-torch.log(u))
        idx = torch.argmax(torch.log(class_probs.detach() + 1e-20) + gumbel,
                           dim=1)
        logp = torch.log(torch.gather(class_probs, 1, idx[:, None])[:, 0]
                         + 1e-20)
    else:
        idx = torch.argmax(class_probs, dim=1)
        logp = torch.log(torch.amax(class_probs, dim=1))
    return idx.to(torch.int32), logp


def render_blob(
    blob: Dict[str, torch.Tensor],
    bank: DeviceMeshBank,
    mode: int,
    image_size: int = 256,
    render_size: int = 384,
    obj_valid: Optional[torch.Tensor] = None,
    training: bool = False,
    force_no_sample: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Batched re-rendering of all object slots (replaces
    __init__.py:94-250).

    blob must contain encoder outputs plus _mroi_norms/_droi_norms/_focals.
    Returns the render dict (_masks, _normals, _depth_maps, poses, ...).
    training=False: the inference camera (zoom solved from `_zoom_tos`),
    the argmax class, one non-differentiable rasterization of the mode's
    targets.
    training=True: the training camera (`_zooms` from the ROI), the class
    drawn from `_class_probs` with `generator` (REINFORCE; the argmax with
    `force_no_sample`), `_masks` differentiable silhouettes (the walk
    window is 64 for render_size > 128, else exact) carrying gradients to
    the pose and FFD entries of the blob, and, where the mode asks for
    them, `_normals` and `_depth_maps` through render() (no loss reads
    them).
    """
    pose = pose_from_blob(blob, image_size, render_size, training=training)
    class_probs = blob["_class_probs"]
    B = class_probs.shape[0]
    cls, logp = select_class(class_probs, generator,
                             sample=training and not force_no_sample)
    cls_l = cls.long()

    # Gather per-object mesh + FFD basis and deform (batched FFD).
    Bmat = bank.ffd_B[cls_l]                       # [B, V, G, G, G]
    faces = bank.faces[cls_l]                      # [B, F, 3]
    face_valid = bank.face_valid[cls_l]            # [B, F]
    if obj_valid is not None:
        # padded object slots contribute no faces
        face_valid = face_valid & obj_valid[:, None]
    ffd_coeff = torch.gather(
        blob["_ffd_coeffs"], 1,
        cls_l[:, None, None].expand(B, 1, blob["_ffd_coeffs"].shape[2]))[:, 0]
    vertices = ffd_mod.deform(Bmat, bank.ffd_P0, ffd_coeff,
                              num_grids=bank.ffd_P0.shape[1])  # [B, V, 3]

    if training:
        verts_cam = perspective_transform(
            vertices,
            scales=pose["_scales"],
            rotations=pose["_rotations"],
            translations=pose["_translations"],
            perspective_translations=pose["_perspective_translations"],
            zooms=pose["_zooms"],
        )
        zooms = pose["_zooms"]
    else:
        verts_cam, zooms = perspective_transform(
            vertices,
            scales=pose["_scales"],
            rotations=pose["_rotations"],
            translations=pose["_translations"],
            perspective_translations=pose["_translations"],
            zoom_tos=pose["_zoom_tos"],
        )

    # Per-object viewing angle (main loop __init__.py:202):
    # atan(render_size / (2 * focal)) in degrees.
    focals = blob["_focals"].reshape(B)
    viewing_angle = torch.atan(rdiv(render_size, 2.0 * focals)) \
        / math.pi * 180.0

    out = dict(pose)
    out["_class_samples"] = cls
    out["_class_log_probs"] = logp
    out["_zooms"] = zooms

    if training:
        # windowed silhouette gradient for large renders: the exact out-walk
        # spans the whole image; contributions decay as 1/dist
        gw = 0 if render_size <= 128 else 64
        adj = bank.adjacency[cls_l]
        out["_masks"] = render(verts_cam, faces, RenderType.Silhouette,
                               face_valid, image_size=render_size,
                               viewing_angle=viewing_angle, grad_walk=gw,
                               vertex_adjacency=adj)
        # (JAX gathers these two renders' faces without the adjacency; the
        # sums of the gather's backward then run in another order)
        if mode & TargetType.normal:
            out["_normals"] = render(verts_cam, faces, RenderType.Normal,
                                     face_valid, image_size=render_size,
                                     viewing_angle=viewing_angle,
                                     vertex_adjacency=adj)
        if mode & TargetType.depth:
            out["_depth_maps"] = render(verts_cam, faces, RenderType.Depth,
                                        face_valid, image_size=render_size,
                                        viewing_angle=viewing_angle,
                                        vertex_adjacency=adj)
        return out

    targets = ["silhouette"]
    if mode & TargetType.normal:
        targets.append("normal")
    if mode & TargetType.depth:
        targets.append("depth")
    maps = render_targets(verts_cam, faces, tuple(targets), face_valid,
                          image_size=render_size,
                          viewing_angle=viewing_angle)
    out["_masks"] = maps["silhouette"]
    if "normal" in maps:
        out["_normals"] = maps["normal"]
    if "depth" in maps:
        out["_depth_maps"] = maps["depth"]
    return out


def roi_features(roi_norms: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mroi, droi) of roi_norms [B, 4] (__init__.py:70-77): the ROI's
    centre ((r2 + r0)/2, (r3 + r1)/2) and size (r2 - r0, r3 - r1)."""
    mroi = torch.stack([roi_norms[:, 2] + roi_norms[:, 0],
                        roi_norms[:, 3] + roi_norms[:, 1]], dim=1) / 2.0
    droi = torch.stack([roi_norms[:, 2] - roi_norms[:, 0],
                        roi_norms[:, 3] - roi_norms[:, 1]], dim=1)
    return mroi, droi


def derender_forward(
    model: Derenderer,
    images: torch.Tensor,
    roi_norms: torch.Tensor,
    focals: torch.Tensor,
    bank: Optional[DeviceMeshBank],
    mode: int,
    image_size: int = 256,
    render_size: int = 384,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Full Derenderer3d.forward (__init__.py:67-92): ROI features, the
    encoder, and the reprojection when the mode has it.  training=True
    puts the model in train mode, so its BatchNorm layers normalise with
    the batch statistics and update their running statistics (flax's
    rule, models/layers.BatchNorm2d); training=False puts it in eval
    mode."""
    mroi, droi = roi_features(roi_norms)
    blob = {
        "_roi_norms": roi_norms,
        "_mroi_norms": mroi,
        "_droi_norms": droi,
        "_focals": focals,
    }
    model.train(training)
    blob.update(model(images, mroi, droi))
    if mode & TargetType.reproject:
        if bank is None:
            raise ValueError("the reprojection needs a mesh bank")
        blob.update(render_blob(blob, bank, mode, image_size, render_size,
                                training=training, generator=generator))
    return blob
