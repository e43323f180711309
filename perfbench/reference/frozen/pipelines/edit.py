# Frozen copy of sdn3d_tpu_torch/pipelines/edit.py at commit 48e7a10, the package name
# rewritten; part of the benchmark's plain reference.  Do not edit.
"""Edit engine: JSON edit ops on the de-rendered state + depth-sorted
full-frame compositing of the per-object renders.

PyTorch counterpart of sdn3d_tpu/pipelines/edit.py
(geometric/scripts/main.py:461-622):
  * operation->object matching by nearest projected center (:461-479)
  * modify/delete semantics (:488-514)
  * depth-sorted full-frame compositing (:541-622), as one batched
    bilinear resample + over-composite on the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.frozen.data.vkitti import Camera
from perfbench.reference.frozen.models.derenderer import rdiv


def match_operations(mroi_norms: np.ndarray, operations: List[dict],
                     camera=Camera) -> List[Tuple[int, int]]:
    """Pair detected objects with edit operations by nearest projected
    center (main.py:468-479).  Returns [(index_obj, index_op)].

    All detections participate — including interests==0 ones — exactly
    as the reference matches against every `_mroi_norms` row."""
    if not operations:
        return []
    op_centers = np.asarray([
        [(float(op["from"]["v"]) - camera.v0) / camera.focal,
         (float(op["from"]["u"]) - camera.u0) / camera.focal]
        for op in operations], np.float32)
    diffs = ((mroi_norms[:, None, :] - op_centers[None, :, :]) ** 2).sum(2)
    if len(mroi_norms) < len(op_centers):
        index_ops = diffs.argmin(axis=1)
        return [(i_obj, int(i_op)) for i_obj, i_op in enumerate(index_ops)]
    index_objs = diffs.argmin(axis=0)
    return [(int(i_obj), i_op) for i_op, i_obj in enumerate(index_objs)]


def apply_operations(blob: Dict[str, np.ndarray], interests: np.ndarray,
                     operations: List[dict],
                     pairs: List[Tuple[int, int]],
                     camera=Camera) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Apply modify/delete ops to the de-rendered state (main.py:485-514).

    Pure host numpy over the host copy of the encoder blob.  Returns
    (updated blob, updated interests)."""
    theta_deltas = np.array(blob["_theta_deltas"])
    translation2ds = np.array(blob["_translation2ds"])
    log_depths = np.array(blob["_log_depths"])
    mroi = np.asarray(blob["_mroi_norms"])
    droi = np.asarray(blob["_droi_norms"])
    interests = interests.copy()

    for index_obj, index_op in pairs:
        op = operations[index_op]
        u = float(op["from"]["u"])
        v = float(op["from"]["v"])
        if op["type"] == "delete":
            interests[index_obj] = 0
        elif op["type"] == "modify":
            u = float(op["to"].get("u", u))
            v = float(op["to"].get("v", v))
            zoom = float(op["zoom"])
            ry = float(op["ry"])

            center = np.asarray([(v - camera.v0) / camera.focal,
                                 (u - camera.u0) / camera.focal],
                                np.float32)
            t2d = (center - mroi[index_obj]) / droi[index_obj]
            ld = log_depths[index_obj] - 2.0 * np.log(zoom)

            cos_r, sin_r = np.cos(-ry), np.sin(-ry)
            tc, ts = theta_deltas[index_obj, 0], theta_deltas[index_obj, 1]
            # in-place row assignment casts back to the blob's dtype
            theta_deltas[index_obj] = np.stack([tc * cos_r - ts * sin_r,
                                                ts * cos_r + tc * sin_r])
            translation2ds[index_obj] = t2d
            log_depths[index_obj] = ld

    out = dict(blob)
    out["_theta_deltas"] = theta_deltas
    out["_translation2ds"] = translation2ds
    out["_log_depths"] = log_depths
    return out, interests


def _interp_matrix(s: torch.Tensor, R: int) -> torch.Tensor:
    """1-D bilinear interpolation weights [len(s), R].

    Row i carries (1-w) at floor(s_i) and w at floor(s_i)+1 (indices
    clipped to the border like _bilinear_sample) and is zeroed outside
    the valid source range, so `W_y @ img @ W_x^T` equals the 2-D
    gather-based bilinear sample."""
    valid = (s >= -0.5) & (s <= R - 0.5)
    s0 = torch.floor(s)
    w = s - s0
    i0 = torch.clamp(s0.to(torch.int32), 0, R - 1)
    i1 = torch.clamp(i0 + 1, 0, R - 1)
    r = torch.arange(R, dtype=torch.int32, device=s.device)[None, :]
    mat = ((r == i0[:, None]) * (1.0 - w)[:, None]
           + (r == i1[:, None]) * w[:, None])
    return torch.where(valid[:, None], mat, torch.zeros_like(mat))


def _bilinear_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                     ) -> torch.Tensor:
    """img [C, R, R]; sy/sx [H, W] source coords -> [C, H, W]; zero outside."""
    R = img.shape[1]
    valid = (sy >= -0.5) & (sy <= R - 0.5) & (sx >= -0.5) & (sx <= R - 0.5)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    y0i = torch.clamp(y0.long(), 0, R - 1)
    x0i = torch.clamp(x0.long(), 0, R - 1)
    y1i = torch.clamp(y0i + 1, 0, R - 1)
    x1i = torch.clamp(x0i + 1, 0, R - 1)

    def g(yy, xx):
        return img[:, yy, xx]                       # [C, H, W]

    top = g(y0i, x0i) * (1 - wx) + g(y0i, x1i) * wx
    bot = g(y1i, x0i) * (1 - wx) + g(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(valid[None], out, torch.zeros_like(out))


def _paste_geometry(k, center2ds, zooms, render_size, focal, u0, v0):
    """Paste box of object k: (top, left, scale = R / size)."""
    size = torch.floor(rdiv(render_size, zooms[k, 0]))
    cu = center2ds[k, 1] * focal + u0
    cv = center2ds[k, 0] * focal + v0
    left = torch.floor(cu - torch.floor(size / 2))  # int() trunc
    top = torch.floor(cv - torch.floor(size / 2))
    return top, left, size


def composite_objects(
    masks: torch.Tensor,        # [N, 1, R, R]
    normals: torch.Tensor,      # [N, 3, R, R]
    depth_maps: torch.Tensor,   # [N, 1, R, R]
    center2ds: torch.Tensor,    # [N, 2] (v_norm, u_norm)
    zooms: torch.Tensor,        # [N, 1]
    depths: torch.Tensor,       # [N, 1]
    interests: torch.Tensor,    # [N] bool/int
    height: int = Camera.height,
    width: int = Camera.width,
    render_size: int = 384,
    focal: float = Camera.focal,
    u0: float = Camera.u0,
    v0: float = Camera.v0,
    method: str = "matmul",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth-sorted full-frame composite (main.py:541-622).

    Returns (instance_map [H, W] int32 (0 = bg, i+1 = object i),
             normal_map [3, H, W] (bg 0.5),
             depth_map [H, W] in [0, 1] (bg 1.0)).

    method="matmul" (default): every object's paste is sampled with
    separable bilinear interpolation as two dense products
    (`_interp_matrix`); masks are binarized (round), so the far-to-near
    overwrite is "the last pasted object with m == 1 wins", an argmax
    over paste rank.  method="loop": the gather-based sequential paste,
    the associativity-exact reference path.
    """
    N = masks.shape[0]
    dev = masks.device
    # far to near; stable so equal depths keep slot order like jnp.argsort
    order = torch.argsort(-depths[:, 0], stable=True)
    R = masks.shape[-1]          # actual render resolution
    f32 = torch.float32

    if method == "loop":
        yy = torch.arange(height, dtype=f32, device=dev)[:, None].expand(
            height, width)
        xx = torch.arange(width, dtype=f32, device=dev)[None, :].expand(
            height, width)
        inst = torch.zeros((height, width), dtype=f32, device=dev)
        nrm = torch.full((3, height, width), 0.5, dtype=f32, device=dev)
        dep = torch.ones((1, height, width), dtype=f32, device=dev)
        for i in range(N):
            k = order[i]
            top, left, size = _paste_geometry(k, center2ds, zooms,
                                              render_size, focal, u0, v0)
            scale = rdiv(R, size)
            sy = (yy - top + 0.5) * scale - 0.5
            sx = (xx - left + 0.5) * scale - 0.5
            m = torch.round(_bilinear_sample(masks[k], sy, sx))    # [1, H, W]
            m = m * (interests[k] > 0)
            n = _bilinear_sample(normals[k] / 2.0 + 0.5, sy, sx)
            d = _bilinear_sample(
                torch.clamp_max(depth_maps[k] * zooms[k, 0] / 100.0, 1.0),
                sy, sx)
            inst = (1 - m[0]) * inst + m[0] * (k + 1).to(f32)
            nrm = (1 - m) * nrm + m * n
            dep = (1 - m) * dep + m * d
        return inst.to(torch.int32), nrm, dep[0]

    yy1 = torch.arange(height, dtype=f32, device=dev)
    xx1 = torch.arange(width, dtype=f32, device=dev)
    m_all, n_all, d_all = [], [], []
    for k in range(N):
        top, left, size = _paste_geometry(k, center2ds, zooms, render_size,
                                          focal, u0, v0)
        scale = rdiv(R, size)
        sy = (yy1 - top + 0.5) * scale - 0.5            # [H]
        sx = (xx1 - left + 0.5) * scale - 0.5           # [W]
        wy = _interp_matrix(sy, R)                      # [H, R]
        wx = _interp_matrix(sx, R)                      # [W, R]
        planes = torch.cat([
            masks[k],
            normals[k] / 2.0 + 0.5,
            torch.clamp_max(depth_maps[k] * zooms[k, 0] / 100.0, 1.0),
        ], dim=0)                                        # [5, R, R]
        s = torch.matmul(torch.matmul(wy, planes), wx.T)   # [5, H, W]
        m_all.append(torch.round(s[0]) * (interests[k] > 0))
        n_all.append(s[1:4])
        d_all.append(s[4])
    m_all = torch.stack(m_all)                           # [N, H, W]
    n_all = torch.stack(n_all)                           # [N, 3, H, W]
    d_all = torch.stack(d_all)                           # [N, H, W]

    # sequential far->near overwrite with binary masks == per pixel,
    # the LAST pasted (nearest) object with m == 1 wins
    m_ord = m_all[order]
    rank = torch.arange(1, N + 1, dtype=m_ord.dtype, device=dev)[:, None, None]
    score = m_ord * rank
    best = torch.argmax(score, dim=0)                    # [H, W]
    has = torch.amax(score, dim=0) > 0
    slot = order[best]                                   # original index
    inst = torch.where(has, slot + 1, torch.zeros_like(slot)).to(torch.int32)
    nrm_sel = torch.gather(n_all, 0, slot[None, None].expand(1, 3, *slot.shape))[0]
    dep_sel = torch.gather(d_all, 0, slot[None])[0]
    nrm = torch.where(has[None], nrm_sel, torch.full_like(nrm_sel, 0.5))
    dep = torch.where(has, dep_sel, torch.ones_like(dep_sel))
    return inst, nrm, dep


def compute_interests(class_ids: np.ndarray,
                      mask_areas: np.ndarray) -> np.ndarray:
    """Which detections take part in the 3D path (main.py:344-352):
    car/van classes with mask area > 16*16."""
    sel = np.isin(class_ids, [1, 2]) & (mask_areas > 16 * 16)
    return sel.astype(np.uint8)
