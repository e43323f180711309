"""Geometric-branch inference: detections -> de-render -> edit ops ->
batched re-render -> composite -> one packed host copy per frame.

PyTorch counterpart of the serving path of
sdn3d_tpu/pipelines/derender_infer.py (geometric/scripts/main.py:_test,
:325-622).  Objects are padded to `max_objects` slots; every per-object
loop of the reference is a batched device computation.  Silhouette
refinement (num_opts > 0), the batched multi-frame API and the small
serving plan wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.data import vkitti as VK
from sdn3d_tpu_torch.models.derenderer import (
    Derenderer, DeviceMeshBank, TargetType, render_blob)
from sdn3d_tpu_torch.pipelines import edit as edit_mod
from sdn3d_tpu_torch.utils import phases


@dataclasses.dataclass
class DerenderInferConfig:
    image_size: int = 256
    render_size: int = 384
    max_objects: int = 16
    num_opts: int = 0
    mode: int = TargetType.extend


def prepare_objects(image_rgb: np.ndarray, rois: np.ndarray,
                    image_masks: np.ndarray, class_ids: np.ndarray,
                    cfg: DerenderInferConfig) -> Dict[str, np.ndarray]:
    """Host-side packing of per-object crops to padded slots
    (main.py:344-392).  image_masks [N, 1, H, W]; rois [N, 4] pixel.

    Crops are uint8 (VK.transform_rgb_u8); the encoder dequantizes them on
    the device.  The render_size mask crops of the reference are not made:
    only the silhouette refinement (num_opts > 0) reads them."""
    n = len(class_ids)
    M = cfg.max_objects
    if n > M:
        raise ValueError(f"{n} objects for {M} slots")

    rgbs = np.zeros((M, cfg.image_size, cfg.image_size, 3), np.uint8)
    rois_pad = np.zeros((M, 4), np.float32)
    valid = np.zeros((M,), bool)
    image_f = np.asarray(image_rgb, np.float32) / 255.0
    for i in range(n):
        rgbs[i] = VK.transform_rgb_u8(image_f, rois[i], cfg.image_size,
                                      prescaled=True)
        rois_pad[i] = rois[i]
        valid[i] = True

    mask_areas = image_masks[:, 0].sum(axis=(1, 2))
    interests = np.zeros((M,), np.uint8)
    interests[:n] = edit_mod.compute_interests(class_ids, mask_areas)

    roi_norms = VK.roi_norms_from_rois(rois_pad)
    return {
        "rgbs": rgbs,
        "roi_norms": roi_norms,
        "focals": np.full((M, 1), VK.Camera.focal, np.float32),
        "valid": valid,
        "interests": interests,
        "class_ids": np.pad(class_ids.astype(np.int32), (0, M - n)),
        "num_objs": n,
    }


# byte -> normalized-f32 lookup table ((x/255 - 0.5)/0.25 computed in
# host f32): indexing it on the device gives EXACTLY the host values on
# any device (inline arithmetic may turn /255 into a reciprocal-multiply).
_U8_NORM_TABLE = ((np.arange(256, dtype=np.float32) / np.float32(255.0)
                   - np.float32(0.5)) / np.float32(0.25))


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
        rgbs_dev[:n] = torch.from_numpy(np.ascontiguousarray(rgbs[:n])).to(dev)
    table = torch.from_numpy(_U8_NORM_TABLE).to(dev)
    images = table[rgbs_dev.long()]                        # [M, H, W, 3]
    roi_norms = torch.from_numpy(objs["roi_norms"]).to(dev)
    focals = torch.from_numpy(objs["focals"]).to(dev)
    mroi = torch.stack([roi_norms[:, 2] + roi_norms[:, 0],
                        roi_norms[:, 3] + roi_norms[:, 1]], dim=1) / 2.0
    droi = torch.stack([roi_norms[:, 2] - roi_norms[:, 0],
                        roi_norms[:, 3] - roi_norms[:, 1]], dim=1)
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


def derender_encode(
    model: Derenderer,
    image_rgb: np.ndarray,
    class_ids: np.ndarray,
    image_masks: np.ndarray,
    rois: np.ndarray,
    cfg: Optional[DerenderInferConfig] = None,
    device="cuda",
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Phase 1 of derender_image: object prep + encoder (main.py:344-402).
    Returns (objs, host blob): the encoder outputs come back in ONE packed
    device-to-host copy."""
    cfg = cfg or DerenderInferConfig()
    if cfg.num_opts:
        raise NotImplementedError(
            "silhouette refinement (num_opts > 0) is not ported yet")
    with phases.phase("geo.prep"):
        objs = prepare_objects(image_rgb, rois, image_masks, class_ids, cfg)
        phases.add_bytes("geo.prep", objs["rgbs"][:objs["num_objs"]])
    with phases.phase("geo.encode"):
        blob, packed = phases.block(encode_objects(model, objs, device))
    with phases.phase("geo.encode_fetch"):
        packed_np = packed.cpu().numpy()
        phases.add_bytes("geo.encode_fetch", packed_np)
        host = _unpack_f32(packed_np, blob, sorted(blob))
    return objs, host


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


def _pack_frame_device(out, inst, nrm, dep) -> torch.Tensor:
    """Pack one frame's host contract into a single uint8 buffer
    [H + k, W, 6] on the device: the first H rows carry the quantized
    2.5D maps with `save_outputs`' exact math (instance uint8; normal RGB
    uint8; depth uint16 split into lo/hi byte planes); the k tail rows
    carry the per-object small tensors (_SMALL_KEYS) as float32 bytes.
    One buffer means ONE device-to-host copy per frame."""
    inst_u8 = inst.to(torch.uint8)
    nrm_u8 = torch.clamp(nrm * 255, 0, 255).to(torch.uint8).permute(1, 2, 0)
    dep_u16 = (torch.clamp(dep, 0, 1) * 65535).to(torch.int32)
    dep_lo = (dep_u16 & 0xFF).to(torch.uint8)[..., None]
    dep_hi = (dep_u16 >> 8).to(torch.uint8)[..., None]
    png = torch.cat([inst_u8[..., None], nrm_u8, dep_lo, dep_hi], dim=-1)
    W = inst.shape[1]
    sv = _packed_f32([out[k] for k in _SMALL_KEYS])
    row = W * 6
    k = -(-sv.numel() // row)
    tail = torch.nn.functional.pad(sv, (0, k * row - sv.numel()))
    return torch.cat([png, tail.reshape(k, W, 6)], dim=0)


def _render_composite(blob_t, bank, interests, obj_valid, cfg, height,
                      width, device):
    """Body of the JAX package's `_render_composite_jit`
    (derender_infer.py:269-285): render every slot, composite, pack."""
    dev = torch.device(device)
    blob_d = {k: torch.as_tensor(np.asarray(v)).to(dev)
              for k, v in blob_t.items()}
    with torch.no_grad():
        out = render_blob(blob_d, bank, cfg.mode, cfg.image_size,
                          cfg.render_size, obj_valid=obj_valid)
        masks = out["_masks"]
        inst, nrm, dep = edit_mod.composite_objects(
            masks,
            out.get("_normals", torch.zeros_like(masks.repeat(1, 3, 1, 1))),
            out.get("_depth_maps", torch.ones_like(masks) * 100.0),
            out["_center2ds"], out["_zooms"], out["_depths"],
            interests, height=height, width=width,
            render_size=cfg.render_size)
        packed = _pack_frame_device(out, inst, nrm, dep)
    return out, inst, nrm, dep, packed


def _unpack_packed(packed_np: np.ndarray, out, height: int):
    """Host inverse of _pack_frame_device: (body [H, W, 6] uint8,
    {key: np array in the original dtype/shape})."""
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
                   packed_np) -> Dict[str, object]:
    """Host-side packaging of one frame's render outputs into the
    derender_image contract (instance/normal/depth maps + per-object JSON
    + 3D state pkl equivalent, main.py:530-622).  Everything the host
    needs comes out of `packed_np`; the float maps stay on the device
    under `normal_map`/`depth_map`."""
    png, smalls = _unpack_packed(packed_np, out, int(inst.shape[0]))

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
    return {
        "instance_map": png[..., 0].astype(np.int32),
        "normal_map": nrm,
        "depth_map": dep,
        "json_obj": json_obj,
        "state": state,
        "interests": interests,
        "instance_png": np.ascontiguousarray(png[..., 0]),
        "normal_png": np.ascontiguousarray(png[..., 1:4]),
        "depth_png": (png[..., 4].astype(np.uint16)
                      | (png[..., 5].astype(np.uint16) << 8)),
    }


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
) -> Dict[str, object]:
    """Full single-image geometric inference (main.py:325-622).

    Returns dict with: instance_map [H, W] int32, normal_map [3, H, W]
    and depth_map [H, W] (device tensors), the quantized planes
    instance_png / normal_png / depth_png, json_obj (per-object
    class/depth/alpha), state (3D pkl equivalent), interests.  `encoded`
    optionally carries a cached derender_encode result for this frame."""
    cfg = cfg or DerenderInferConfig()
    H, W = image_rgb.shape[:2]
    if encoded is None:
        encoded = derender_encode(model, image_rgb, class_ids, image_masks,
                                  rois, cfg, device=device)
    objs, blob = encoded
    with phases.phase("geo.edit"):
        blob_t, interests = _edited_blob(objs, blob, operations)
    dev = torch.device(device)
    with phases.phase("geo.render"):
        out, inst, nrm, dep, packed = phases.block(_render_composite(
            blob_t, bank, torch.from_numpy(interests).to(dev),
            torch.from_numpy(objs["valid"]).to(dev), cfg, H, W, dev))
    with phases.phase("geo.package"):
        packed_np = packed.cpu().numpy()     # the ONE d2h copy per frame
        phases.add_bytes("geo.package", packed_np)
        return _package_frame(objs, rois, interests, out, inst, nrm, dep,
                              packed_np)
