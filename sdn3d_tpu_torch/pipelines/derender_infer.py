"""Geometric-branch inference: detections -> de-render -> (optional
silhouette refinement) -> edit ops -> batched re-render -> composite ->
one packed host copy per frame.

PyTorch counterpart of the serving path of
sdn3d_tpu/pipelines/derender_infer.py (geometric/scripts/main.py:_test,
:325-622).  Objects are padded to `max_objects` slots; every per-object
loop of the reference is a batched device computation.  The packed host
contract comes in two shapes: the full-resolution planes of the file
contract, or (`small_plan`) the instance and normal planes downsized on
the device to the textural conditioning resolution (ops/pil_resize).
The batched API (derender_encode_batch_*, derender_render_begin/finish,
derender_images_batch) renders N frames' slots in one rasterization and
fetches each chunk in one asynchronous copy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.data import vkitti as VK
from sdn3d_tpu_torch.models.derenderer import (
    Derenderer, DeviceMeshBank, TargetType, render_blob, roi_features)
from sdn3d_tpu_torch.ops import pil_resize
from sdn3d_tpu_torch.pipelines import edit as edit_mod
from sdn3d_tpu_torch.utils import phases
from sdn3d_tpu_torch.utils.transfer import HostFetch, to_device


@dataclasses.dataclass
class DerenderInferConfig:
    image_size: int = 256
    render_size: int = 384
    max_objects: int = 16
    num_opts: int = 0
    opt_lr: float = 3e-2          # main.py:438
    ffd_opt_reg: float = 100.0    # main.py:445
    mode: int = TargetType.extend


def prepare_objects(image_rgb: np.ndarray, rois: np.ndarray,
                    image_masks: np.ndarray, class_ids: np.ndarray,
                    cfg: DerenderInferConfig,
                    with_masks: bool = False) -> Dict[str, np.ndarray]:
    """Host-side packing of per-object crops to padded slots
    (main.py:344-392).  image_masks [N, 1, H, W]; rois [N, 4] pixel.

    Crops are uint8 (VK.transform_rgb_u8); the encoder dequantizes them on
    the device.  `with_masks` also makes the render_size mask crops
    ("masks" [M, 1, R, R]), which only the silhouette refinement
    (num_opts > 0) reads."""
    n = len(class_ids)
    M = cfg.max_objects
    if n > M:
        raise ValueError(f"{n} objects for {M} slots")

    rgbs = np.zeros((M, cfg.image_size, cfg.image_size, 3), np.uint8)
    masks = (np.zeros((M, cfg.render_size, cfg.render_size), np.float32)
             if with_masks else None)
    rois_pad = np.zeros((M, 4), np.float32)
    valid = np.zeros((M,), bool)
    image_f = np.asarray(image_rgb, np.float32) / 255.0
    for i in range(n):
        rgbs[i] = VK.transform_rgb_u8(image_f, rois[i], cfg.image_size,
                                      prescaled=True)
        if with_masks:
            masks[i] = VK.transform_mask(
                np.asarray(image_masks[i, 0], np.float32), rois[i],
                cfg.render_size)
        rois_pad[i] = rois[i]
        valid[i] = True

    mask_areas = image_masks[:, 0].sum(axis=(1, 2))
    interests = np.zeros((M,), np.uint8)
    interests[:n] = edit_mod.compute_interests(class_ids, mask_areas)

    roi_norms = VK.roi_norms_from_rois(rois_pad)
    objs = {
        "rgbs": rgbs,
        "roi_norms": roi_norms,
        "focals": np.full((M, 1), VK.Camera.focal, np.float32),
        "valid": valid,
        "interests": interests,
        "class_ids": np.pad(class_ids.astype(np.int32), (0, M - n)),
        "num_objs": n,
    }
    if with_masks:
        objs["masks"] = masks[:, None]                    # [M, 1, R, R]
    return objs


# byte -> normalized-f32 lookup table ((x/255 - 0.5)/0.25 computed in
# host f32): indexing it on the device gives EXACTLY the host values on
# any device (inline arithmetic may turn /255 into a reciprocal-multiply).
_U8_NORM_TABLE = ((np.arange(256, dtype=np.float32) / np.float32(255.0)
                   - np.float32(0.5)) / np.float32(0.25))


@functools.lru_cache(maxsize=None)
def _norm_table(device: torch.device) -> torch.Tensor:
    return to_device(_U8_NORM_TABLE, device)


def _packed_f32(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate float32 tensors into one flat byte buffer (one host copy)."""
    flat = torch.cat([t.to(torch.float32).reshape(-1) for t in tensors])
    return flat.view(torch.uint8)


def encode_objects(model: Derenderer, objs: Dict[str, np.ndarray],
                   device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Run the derenderer encoder over all object slots (main.py:385-402).

    Only the n real uint8 crops are uploaded; they are zero-padded to the
    slot count, dequantized through `_U8_NORM_TABLE` and normalized on the
    device.  Returns (device blob, packed bytes of the blob in sorted key
    order)."""
    rgbs = objs["rgbs"]
    n = int(objs.get("num_objs", rgbs.shape[0]))
    dev = torch.device(device)
    rgbs_dev = torch.zeros(rgbs.shape, dtype=torch.uint8, device=dev)
    if n:
        rgbs_dev[:n] = to_device(rgbs[:n], dev)
    images = _norm_table(dev)[rgbs_dev.long()]             # [M, H, W, 3]
    roi_norms = to_device(objs["roi_norms"], dev)
    focals = to_device(objs["focals"], dev)
    mroi, droi = roi_features(roi_norms)
    blob = {"_roi_norms": roi_norms, "_mroi_norms": mroi,
            "_droi_norms": droi, "_focals": focals}
    with torch.no_grad():
        blob.update(model(images, mroi, droi))
    return blob, _packed_f32([blob[k] for k in sorted(blob)])


def _unpack_f32(packed_np: np.ndarray, like: Dict[str, torch.Tensor],
                keys) -> Dict[str, np.ndarray]:
    """Host inverse of `_packed_f32` (shapes from the device tensors'
    metadata, no per-tensor transfer)."""
    out = {}
    buf = packed_np.tobytes()
    off = 0
    for k in keys:
        shape = tuple(like[k].shape)
        n = int(np.prod(shape))
        out[k] = np.frombuffer(buf, np.float32, count=n,
                               offset=off).reshape(shape).copy()
        off += 4 * n
    return out


def keep_largest_detections(cfg: DerenderInferConfig, class_ids, masks,
                            rois):
    """Keep the <= max_objects largest masks (scripts/main.py:812-818)."""
    if len(class_ids) > cfg.max_objects:
        areas = masks[:, 0].sum((1, 2))
        keep = np.argsort(-areas)[:cfg.max_objects]
        return class_ids[keep], masks[keep], rois[keep]
    return class_ids, masks, rois


def build_default_ignores(image_masks: np.ndarray, log_depths: np.ndarray,
                          droi_norms: np.ndarray) -> np.ndarray:
    """Occlusion ignore maps from predicted depth ordering
    (main.py:405-414): each object ignores pixels covered by any
    nearer-sorted object."""
    depths = log_depths[:, 0] - np.log(droi_norms).sum(axis=1)
    index = np.argsort(depths)
    sorted_masks = np.concatenate(
        [np.zeros_like(image_masks[:1]), image_masks[index]], axis=0)[:-1]
    cum = np.clip(np.cumsum(sorted_masks, axis=0), 0, 1)
    out = np.zeros_like(image_masks)
    out[index] = cum
    return out


_OPT_KEYS = ("_theta_deltas", "_translation2ds", "_log_scales",
             "_ffd_coeffs")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it, on the host.
    torch's float32 pow agrees with XLA's CPU pow on this value for every
    count below 31 (decay 0.9) and 168 (decay 0.999); the two pow
    implementations round differently beyond."""
    d = torch.tensor(decay, dtype=torch.float32)
    return float(1 - torch.pow(d, torch.tensor(float(count))))


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8    # optax.adam defaults


def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, count: int, lr: float,
              weight_decay: float = 0.0):
    """One step of optax.adam(lr) (scale_by_adam, then scale by -lr, then
    apply_updates), in optax's arithmetic order; with `weight_decay`,
    optax.add_decayed_weights first (g + weight_decay * p).  count is the
    step number, from 1.  Returns (p, mu, nu)."""
    b1, b2 = _ADAM_B1, _ADAM_B2
    if weight_decay:
        g = g + weight_decay * p
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    mu_hat = mu / torch.full((), _bias_correction(b1, count), device=mu.device)
    nu_hat = nu / torch.full((), _bias_correction(b2, count), device=nu.device)
    update = mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)
    return p + (-lr) * update, mu, nu


def refine_silhouettes(blob: Dict[str, torch.Tensor], bank: DeviceMeshBank,
                       masks: torch.Tensor, ignores: torch.Tensor,
                       cfg: DerenderInferConfig,
                       trace: Optional[list] = None
                       ) -> Dict[str, torch.Tensor]:
    """Test-time optimization of pose/shape against detected masks
    (main.py:420-459; JAX derender_infer.py:341-398): `cfg.num_opts` Adam
    steps (lr cfg.opt_lr) over theta / translation2d / log_scale / ffd,
    argmax class, training camera, loss mean((mask - target)^2 +
    ffd_opt_reg * mean(ffd^2)) times (1 - ignores).

    Parity with the JAX package, kept on purpose: the reg term is added
    per pixel BEFORE the ignore multiply, and padded slots are rendered
    (no obj_valid) and count in the mean.  A padded slot's pose is not
    finite, so from the second step on its entries, and the loss, are NaN
    (in the JAX package too); real slots are unaffected.

    `trace`, when given, receives each step's per-slot shares of the loss:
    a [2, M] tensor, row 0 the data term of the slot's pixels, row 1 the
    reg term of the slot's coefficients, whose sum is the loss; a caller
    can follow the loss of the real slots.  Returns the blob with the
    refined entries (no gradient)."""
    params = {k: blob[k].detach().clone().requires_grad_(True)
              for k in _OPT_KEYS}
    frozen = {k: v.detach() for k, v in blob.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in range(1, cfg.num_opts + 1):
        b = dict(frozen)
        b.update(params)
        # model.train() + _force_no_sample=True during refinement
        # (main.py:424-425): training-mode projection, argmax class
        out = render_blob(b, bank, TargetType.reproject, cfg.image_size,
                          cfg.render_size, training=True,
                          force_no_sample=True)
        keep = 1 - ignores
        l = ((out["_masks"] - masks) ** 2 + cfg.ffd_opt_reg * torch.mean(
            params["_ffd_coeffs"] ** 2)) * keep
        loss = torch.mean(l)
        grads = torch.autograd.grad(loss, [params[k] for k in _OPT_KEYS])
        if trace is not None:
            with torch.no_grad():
                data = ((out["_masks"] - masks) ** 2 * keep).flatten(1).sum(1)
                ffd = params["_ffd_coeffs"]
                reg = (cfg.ffd_opt_reg * keep.mean() / ffd.numel()
                       * (ffd ** 2).flatten(1).sum(1))
                trace.append(torch.stack([data / l.numel(), reg]))
        with torch.no_grad():
            for k, g in zip(_OPT_KEYS, grads):
                p, mu[k], nu[k] = adam_step(params[k], g, mu[k], nu[k], step,
                                            cfg.opt_lr)
                params[k] = p.requires_grad_(True)
    out = dict(frozen)
    out.update({k: v.detach() for k, v in params.items()})
    return out


def derender_encode(
    model: Derenderer,
    image_rgb: np.ndarray,
    class_ids: np.ndarray,
    image_masks: np.ndarray,
    rois: np.ndarray,
    cfg: Optional[DerenderInferConfig] = None,
    device="cuda",
    bank: Optional[DeviceMeshBank] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Phase 1 of derender_image: object prep + encoder + optional
    silhouette refinement (main.py:344-459).  Returns (objs, host blob):
    the encoder (or refined) outputs come back in ONE packed
    device-to-host copy.  The refinement (cfg.num_opts > 0) needs `bank`;
    its ignore maps come from `build_default_ignores`."""
    cfg = cfg or DerenderInferConfig()
    if cfg.num_opts and bank is None:
        raise ValueError("silhouette refinement (num_opts > 0) needs the "
                         "mesh bank")
    with phases.phase("geo.prep"):
        objs = prepare_objects(image_rgb, rois, image_masks, class_ids, cfg,
                               with_masks=cfg.num_opts > 0)
        phases.add_bytes("geo.prep", objs["rgbs"][:objs["num_objs"]])
    with phases.phase("geo.encode"):
        blob, packed = phases.block(encode_objects(model, objs, device))
    if cfg.num_opts:
        with phases.phase("geo.refine"):
            n = len(rois)
            enc = _unpack_f32(packed.cpu().numpy(), blob, sorted(blob))
            image_ignores = build_default_ignores(
                image_masks, enc["_log_depths"][:n], enc["_droi_norms"][:n])
            rs = cfg.render_size
            ign = np.zeros((cfg.max_objects, 1, rs, rs), np.float32)
            for i in range(n):
                ign[i, 0] = VK.transform_mask(
                    np.asarray(image_ignores[i, 0], np.float32), rois[i], rs)
            dev = torch.device(device)
            phases.add_bytes("geo.refine", objs["masks"], ign)
            blob = phases.block(refine_silhouettes(
                blob, bank, torch.from_numpy(objs["masks"]).to(dev),
                torch.from_numpy(ign).to(dev), cfg))
            packed = _packed_f32([blob[k] for k in sorted(blob)])
    with phases.phase("geo.encode_fetch"):
        packed_np = packed.cpu().numpy()
        phases.add_bytes("geo.encode_fetch", packed_np)
        host = _unpack_f32(packed_np, blob, sorted(blob))
    return objs, host


def derender_encode_batch_begin(
    model: Derenderer,
    frames: List[Dict[str, object]],
    cfg: DerenderInferConfig,
    device="cuda",
):
    """Enqueue the encoder for N frames back to back, each frame's packed
    blob on its way to the host (HostFetch) before the next is prepared.

    Each frame runs the same per-frame encode as derender_encode, not one
    fused [N*M]-slot encode: convolutions over another batch size may
    choose other algorithms and move the last bits, which would fork the
    byte contract (the JAX package measured a 1-ulp drift,
    derender_infer.py:486-491).  num_opts == 0 only (refinement keeps
    the per-frame path).  Returns a pending handle for
    derender_encode_batch_finish."""
    if cfg.num_opts:
        raise ValueError("the batched encode has no refinement path; "
                         "use derender_encode")
    pendings = []
    for fr in frames:
        with phases.phase("geo.prep"):
            objs = prepare_objects(fr["image_rgb"], fr["rois"],
                                   fr["image_masks"], fr["class_ids"], cfg)
            phases.add_bytes("geo.prep", objs["rgbs"][:objs["num_objs"]])
        with phases.phase("geo.encode"):
            blob, packed = phases.block(encode_objects(model, objs, device))
            fetch = HostFetch(packed)
        pendings.append((objs, blob, fetch))
    return pendings


def derender_encode_batch_finish(pendings) -> List[
        Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Wait for a derender_encode_batch_begin handle's copies.  Returns
    [(objs, host blob)] in frame order, each equal to derender_encode's
    result for its frame."""
    out = []
    for objs, blob, fetch in pendings:
        with phases.phase("geo.encode_fetch"):
            packed_np = fetch.result()
            phases.add_bytes("geo.encode_fetch", packed_np)
            out.append((objs, _unpack_f32(packed_np, blob, sorted(blob))))
    return out


def derender_encode_batch(model: Derenderer, frames: List[Dict[str, object]],
                          cfg: DerenderInferConfig, device="cuda"):
    """Multi-frame encode with overlapped copies (begin + finish)."""
    return derender_encode_batch_finish(
        derender_encode_batch_begin(model, frames, cfg, device))


def _edited_blob(objs, blob, operations: Optional[List[dict]]
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Apply edit operations to an encoded host blob (host-side op
    matching + pose rewrites, main.py:461-514) and return the blob plus
    the per-slot interests after deletes."""
    interests = objs["interests"].copy()
    interests = interests * objs["valid"]
    if operations:
        n = objs["num_objs"]
        pairs = edit_mod.match_operations(
            np.asarray(blob["_mroi_norms"])[:n], operations)
        blob, interests_n = edit_mod.apply_operations(
            blob, interests[:n], operations, pairs)
        interests = np.concatenate(
            [interests_n, interests[n:]]).astype(np.uint8)
    blob_t = {k: v for k, v in blob.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    return blob_t, interests


_SMALL_KEYS = ("_depths", "_alphas", "_scales", "_rotations",
               "_translations", "_zooms", "_class_samples")


def _smalls_tail(out, width: int, channels: int) -> torch.Tensor:
    """The per-object small tensors (_SMALL_KEYS) as float32 bytes, in
    rows of the packed buffer's shape [k, width, channels]."""
    sv = _packed_f32([out[k] for k in _SMALL_KEYS])
    row = width * channels
    k = -(-sv.numel() // row)
    tail = torch.nn.functional.pad(sv, (0, k * row - sv.numel()))
    return tail.reshape(k, width, channels)


def _pack_frame_device(out, inst, nrm, dep, small=None) -> torch.Tensor:
    """Pack one frame's host contract into a single uint8 buffer on the
    device, so a frame needs ONE device-to-host copy.

    `small=None` (the file contract): [H + k, W, 6] — the first H rows
    carry the quantized 2.5D maps with `save_outputs`' exact math
    (instance uint8; normal RGB uint8; depth uint16 split into lo/hi
    byte planes); the k tail rows carry the per-object small tensors.

    `small=TransformPlan` (the serving contract): [th + k, tw, 4] — the
    instance plane (nearest) and the normal plane (bicubic) downsized on
    the device to the textural conditioning resolution with
    ops/pil_resize, byte-equal to the PIL transform the host would apply;
    no depth plane (the edit conditioning does not read it).  2.79 MB a
    375x1242 frame becomes 0.48 MB."""
    inst_u8 = inst.to(torch.uint8)
    nrm_u8 = torch.clamp(nrm * 255, 0, 255).to(torch.uint8).permute(1, 2, 0)
    if small is not None:
        inst_s = pil_resize.apply_plan_u8(inst_u8, small, nearest=True)
        nrm_s = pil_resize.apply_plan_u8(nrm_u8, small)
        body = torch.cat([inst_s[..., None], nrm_s], dim=-1)
        return torch.cat([body, _smalls_tail(out, small.out_w, 4)], dim=0)
    dep_u16 = (torch.clamp(dep, 0, 1) * 65535).to(torch.int32)
    dep_lo = (dep_u16 & 0xFF).to(torch.uint8)[..., None]
    dep_hi = (dep_u16 >> 8).to(torch.uint8)[..., None]
    png = torch.cat([inst_u8[..., None], nrm_u8, dep_lo, dep_hi], dim=-1)
    return torch.cat([png, _smalls_tail(out, inst.shape[1], 6)], dim=0)


def _render_composite_batch(blob_b, bank, interests, obj_valid, cfg, height,
                            width, small=None):
    """The JAX package's `_render_composite_batch_jit`
    (derender_infer.py:693-726): the N frames' M padded slots flattened
    into ONE [N*M]-object render (one forward-rasterizer launch for the
    chunk), then each frame's composite and packed buffer.  blob_b
    {key: [N, M, ...]}, interests and obj_valid [N, M].  Returns (render
    dict over the N*M slots, per-frame instance / normal / depth maps,
    packed buffers [N, rows, cols, C])."""
    N, M = obj_valid.shape
    flat = {k: v.reshape((N * M,) + v.shape[2:]) for k, v in blob_b.items()}
    with torch.no_grad():
        out = render_blob(flat, bank, cfg.mode, cfg.image_size,
                          cfg.render_size, obj_valid=obj_valid.reshape(-1))
        insts, nrms, deps, packs = [], [], [], []
        for i in range(N):
            o = {k: v[i * M:(i + 1) * M] for k, v in out.items()}
            masks = o["_masks"]
            inst, nrm, dep = edit_mod.composite_objects(
                masks,
                o.get("_normals", torch.zeros_like(masks.repeat(1, 3, 1, 1))),
                o.get("_depth_maps", torch.ones_like(masks) * 100.0),
                o["_center2ds"], o["_zooms"], o["_depths"],
                interests[i], height=height, width=width,
                render_size=cfg.render_size)
            insts.append(inst)
            nrms.append(nrm)
            deps.append(dep)
            packs.append(_pack_frame_device(o, inst, nrm, dep, small=small))
    return out, insts, nrms, deps, torch.stack(packs)


def _unpack_packed(packed_np: np.ndarray, out, height: int):
    """Host inverse of _pack_frame_device: (body [height, W, C] uint8,
    {key: np array in the original dtype/shape}).  `height` is the body's
    row count: the frame's H for the file contract, plan.out_h for the
    serving contract."""
    png = packed_np[:height]
    tail = packed_np[height:].tobytes()
    smalls = {}
    off = 0
    for k in _SMALL_KEYS:
        shape = tuple(out[k].shape)
        n = int(np.prod(shape))
        arr = np.frombuffer(tail, np.float32, count=n,
                            offset=off).reshape(shape)
        smalls[k] = arr.astype(np.int32 if out[k].dtype == torch.int32
                               else np.float32)
        off += n * 4
    return png, smalls


_STATE_KEYS = ("_scales", "_rotations", "_translations", "_zooms",
               "_class_samples")


def _package_frame(objs, rois, interests, out, inst, nrm, dep,
                   packed_np, small_plan=None) -> Dict[str, object]:
    """Host-side packaging of one frame's render outputs into the
    derender_image contract (instance/normal/depth maps + per-object JSON
    + 3D state pkl equivalent, main.py:530-622).  Everything the host
    needs comes out of `packed_np`; the float maps stay on the device
    under `normal_map`/`depth_map`.  With `small_plan` the buffer holds
    the serving planes: `instance_small` [th, tw] and `normal_small`
    [th, tw, 3] replace the full-resolution `*_png` keys, and
    `instance_map` stays on the device too."""
    height = int(inst.shape[0]) if small_plan is None else small_plan.out_h
    png, smalls = _unpack_packed(packed_np, out, height)

    json_obj = {}
    depths_np = smalls["_depths"].astype(np.float32)
    alphas_np = smalls["_alphas"].astype(np.float32)
    for i in range(objs["num_objs"]):
        if interests[i]:
            entry = {
                "class_id": int(objs["class_ids"][i]),
                "depth": float(depths_np[i, 0]),
                "alpha": float(alphas_np[i, 0]),
            }
            json_obj[i + 1] = entry

    state = {"num_objs": objs["num_objs"], "rois": rois,
             "interests": interests}
    state.update({k: smalls[k] for k in _STATE_KEYS})
    result = {
        "instance_map": inst,
        "normal_map": nrm,
        "depth_map": dep,
        "json_obj": json_obj,
        "state": state,
        "interests": interests,
    }
    if small_plan is None:
        result["instance_map"] = png[..., 0].astype(np.int32)
        result["instance_png"] = np.ascontiguousarray(png[..., 0])
        result["normal_png"] = np.ascontiguousarray(png[..., 1:4])
        result["depth_png"] = (png[..., 4].astype(np.uint16)
                               | (png[..., 5].astype(np.uint16) << 8))
    else:
        result["instance_small"] = np.ascontiguousarray(png[..., 0])
        result["normal_small"] = np.ascontiguousarray(png[..., 1:4])
    return result


def derender_render_begin(
    model: Derenderer,
    bank: DeviceMeshBank,
    frames: List[Dict[str, object]],
    cfg: Optional[DerenderInferConfig] = None,
    small_plan=None,
    device="cuda",
):
    """First half of derender_images_batch: the host edit ops, one upload
    and ONE render of every frame's slots, with the chunk's packed buffer
    on its way to the host (HostFetch).  Returns a pending handle for
    derender_render_finish, so a caller can do host work while the card
    renders and copies."""
    cfg = cfg or DerenderInferConfig()
    H, W = frames[0]["image_rgb"].shape[:2]
    per = []
    for fr in frames:
        if fr["image_rgb"].shape[:2] != (H, W):
            raise ValueError("batched frames must share the full-frame size")
        encoded = fr.get("encoded")
        if encoded is None:
            encoded = derender_encode(model, fr["image_rgb"], fr["class_ids"],
                                      fr["image_masks"], fr["rois"], cfg,
                                      device=device, bank=bank)
        objs, blob = encoded
        with phases.phase("geo.edit"):
            blob_t, interests = _edited_blob(objs, blob,
                                             fr.get("operations"))
        per.append((objs, blob_t, interests))

    dev = torch.device(device)
    up = lambda arrays: to_device(  # noqa: E731
        np.stack([np.asarray(a) for a in arrays]), dev)
    with phases.phase("geo.render"):
        blob_b = {k: up([p[1][k] for p in per]) for k in sorted(per[0][1])}
        out, insts, nrms, deps, packed = phases.block(_render_composite_batch(
            blob_b, bank, up([p[2] for p in per]),
            up([p[0]["valid"] for p in per]), cfg, H, W, small=small_plan))
        fetch = HostFetch(packed)
    return per, frames, out, insts, nrms, deps, fetch, small_plan


def derender_render_finish(pending) -> List[Dict[str, object]]:
    """Second half of derender_images_batch: wait for the chunk's packed
    copy and build each frame's host contract."""
    per, frames, out, insts, nrms, deps, fetch, small_plan = pending
    M = len(per[0][0]["valid"])
    with phases.phase("geo.package"):
        packed_np = fetch.result()     # ONE device-to-host copy a chunk
        phases.add_bytes("geo.package", packed_np)
        results = []
        for i, (objs, _, interests) in enumerate(per):
            out_i = {k: v[i * M:(i + 1) * M] for k, v in out.items()}
            results.append(_package_frame(
                objs, frames[i]["rois"], interests, out_i, insts[i],
                nrms[i], deps[i], packed_np[i], small_plan=small_plan))
    return results


def derender_images_batch(
    model: Derenderer,
    bank: DeviceMeshBank,
    frames: List[Dict[str, object]],
    cfg: Optional[DerenderInferConfig] = None,
    small_plan=None,
    device="cuda",
) -> List[Dict[str, object]]:
    """Batched multi-frame geometric inference.  frames[i] holds
    `image_rgb`, `class_ids`, `image_masks`, `rois` and optional
    `operations` / `encoded`, the arguments of derender_image; all frames
    share the full-frame size.  Returns one derender_image result per
    frame, equal to derender_image's: the render gains a batch dimension,
    and every slot and frame is computed as it is alone."""
    return derender_render_finish(derender_render_begin(
        model, bank, frames, cfg, small_plan=small_plan, device=device))


def derender_image(
    model: Derenderer,
    bank: DeviceMeshBank,
    image_rgb: np.ndarray,
    class_ids: np.ndarray,
    image_masks: np.ndarray,
    rois: np.ndarray,
    cfg: Optional[DerenderInferConfig] = None,
    operations: Optional[List[dict]] = None,
    encoded: Optional[Tuple[Dict[str, np.ndarray],
                            Dict[str, np.ndarray]]] = None,
    device="cuda",
    small_plan=None,
) -> Dict[str, object]:
    """Full single-image geometric inference (main.py:325-622).

    Returns dict with: instance_map [H, W] int32, normal_map [3, H, W]
    and depth_map [H, W] (device tensors), the quantized planes
    instance_png / normal_png / depth_png, json_obj (per-object
    class/depth/alpha), state (3D pkl equivalent), interests.  `encoded`
    optionally carries a cached derender_encode result for this frame;
    with cfg.num_opts > 0 the encoder's blob is refined against the masks
    first.  `small_plan` (a pil_resize.TransformPlan) switches to the
    serving contract: `instance_small` / `normal_small` at the textural
    conditioning resolution replace the `*_png` planes."""
    frame = {"image_rgb": image_rgb, "class_ids": class_ids,
             "image_masks": image_masks, "rois": rois,
             "operations": operations, "encoded": encoded}
    return derender_images_batch(model, bank, [frame], cfg,
                                 small_plan=small_plan, device=device)[0]
