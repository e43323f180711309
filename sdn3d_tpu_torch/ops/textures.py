"""Texture-cube sampling, lighting, and texture loading — the RGB half of
the neural mesh renderer (PyTorch port of sdn3d_tpu/ops/textures.py).

NR-3 (per-pixel depth-corrected trilinear sampling from per-face texture
cubes, neural_renderer/rasterize.py:362-435), NR-5 (its backward: the
gather's, summed in a fixed order), lighting (neural_renderer/
lighting.py:8-52) and NR-8 texture baking (neural_renderer/
load_obj.py:11-92).  The 3D-SDN edit path does not use them (silhouette,
normal and depth only); `render()` of the RGB type does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.ops.rasterize import segment_sum_sorted


class _TexelGather(torch.autograd.Function):
    """rows[b, n] = table[b, index[b, n]] for a texel table [B, R, 3] and
    index [B, N].  The backward sums each texel's rows after a stable
    sort by (image, texel) with `segment_sum_sorted`: the same bits on
    every run on the card (torch.gather's backward is a scatter_add with
    float atomics)."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.rows = table.shape[1]
        B, N = index.shape
        return torch.gather(table, 1, index[..., None].expand(
            B, N, table.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        B, N, C = g.shape
        R = ctx.rows
        seg = index + torch.arange(B, device=index.device)[:, None] * R
        sums = segment_sum_sorted(g.reshape(B * N, C), seg.reshape(-1),
                                  B * R)
        return sums.reshape(B, R, C), None


def sample_textures(
    faces: torch.Tensor,        # [B, F, 3, 3] camera-space (z used)
    textures: torch.Tensor,     # [B, F, ts, ts, ts, 3]
    face_index: torch.Tensor,   # [B, H, W]
    weight: torch.Tensor,       # [B, H, W, 3]
    depth: torch.Tensor,        # [B, H, W]
    eps: float = 1e-4,
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> torch.Tensor:
    """Per-pixel trilinear texture-cube sampling (rasterize.py:377-424).

    texture_index_float[k] = w_k * (ts - 1 - eps) * depth / z_k; the 8
    cube corners are blended with trilinear weights.  Differentiable in
    `textures` (NR-5): the 8 corners of every pixel are one gather, whose
    backward sorts the corner-pixel rows by (face, cell) and sums them in
    order.  Returns rgb [B, H, W, 3]."""
    B, F, ts = textures.shape[0], textures.shape[1], textures.shape[2]
    H, W = face_index.shape[1:]
    P = H * W
    T = ts * ts * ts

    fi = face_index.reshape(B, P)
    hit = fi >= 0
    fi_c = torch.where(hit, fi, torch.zeros_like(fi)).long()

    # per-pixel face vertex z [B, P, 3]
    z = torch.gather(faces[..., 2], 1, fi_c[..., None].expand(B, P, 3))
    w = weight.reshape(B, P, 3)
    d = depth.reshape(B, P)

    tif = w * (ts - 1 - eps) * (d[..., None] / z)              # [B, P, 3]
    t0f = torch.floor(tif)
    frac = tif - t0f
    t0 = torch.clamp(t0f.to(torch.int64), 0, ts - 1)
    t1 = torch.clamp(t0 + 1, 0, ts - 1)

    cells, wgts = [], []
    for corner in range(8):
        idx = []
        wgt = torch.ones((B, P), dtype=textures.dtype, device=textures.device)
        for k in range(3):
            if (corner >> k) % 2 == 0:
                idx.append(t0[..., k])
                wgt = wgt * (1.0 - frac[..., k])
            else:
                idx.append(t1[..., k])
                wgt = wgt * frac[..., k]
        cells.append((idx[0] * ts + idx[1]) * ts + idx[2])     # [B, P]
        wgts.append(wgt)
    index = fi_c[:, None] * T + torch.stack(cells, 1)          # [B, 8, P]
    texels = _TexelGather.apply(textures.reshape(B, F * T, 3),
                                index.reshape(B, 8 * P)).reshape(B, 8, P, 3)
    rgb = torch.zeros((B, P, 3), dtype=textures.dtype, device=textures.device)
    for corner in range(8):
        rgb = rgb + wgts[corner][..., None] * texels[:, corner]

    bg = torch.tensor(background, dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(hit[..., None], rgb, bg)
    return rgb.reshape(B, H, W, 3)


def lighting(faces: torch.Tensor, textures: torch.Tensor,
             intensity_ambient: float = 0.5,
             intensity_directional: float = 0.5,
             color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
             direction=(0, 1, 0)) -> torch.Tensor:
    """Ambient + directional lighting baked into per-face textures
    (neural_renderer/lighting.py:8-52); faces [B, F, 3, 3], textures
    [B, F, ts, ts, ts, 3]."""
    B, F = faces.shape[:2]
    dt, dev = faces.dtype, faces.device
    ca = torch.tensor(color_ambient, dtype=dt, device=dev).expand(B, 3)
    cd = torch.tensor(color_directional, dtype=dt, device=dev).expand(B, 3)
    dirn = torch.tensor(direction, dtype=dt, device=dev).expand(B, 3)

    light = torch.zeros((B, F, 3), dtype=dt, device=dev)
    if intensity_ambient != 0:
        light = light + intensity_ambient * ca[:, None, :]
    if intensity_directional != 0:
        v10 = faces[:, :, 0] - faces[:, :, 1]
        v12 = faces[:, :, 2] - faces[:, :, 1]
        n = torch.cross(v10, v12, dim=-1)
        n = n / torch.clamp_min(torch.sqrt(torch.sum(n * n, dim=-1,
                                                     keepdim=True)), 1e-12)
        cos = torch.relu(torch.sum(n * dirn[:, None, :], dim=2))
        light = light + (intensity_directional * cd[:, None, :]
                         * cos[:, :, None])
    return textures * light[:, :, None, None, None, :]


def load_textures(filename_obj: str, filename_texture: str,
                  texture_size: int = 4) -> np.ndarray:
    """Bake a texture image into per-face texture cubes
    (load_obj.py:11-92, host numpy).  Returns [F, ts, ts, ts, 3]."""
    from PIL import Image

    vts, faces_vt = [], []
    for line in open(filename_obj):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "vt":
            vts.append([float(v) for v in parts[1:3]])
        elif parts[0] == "f":
            vs = parts[1:]
            v0 = int(vs[0].split("/")[1])
            for i in range(len(vs) - 2):
                v1 = int(vs[i + 1].split("/")[1])
                v2 = int(vs[i + 2].split("/")[1])
                faces_vt.append((v0, v1, v2))
    vts = np.asarray(vts, np.float32)
    fuv = vts[np.asarray(faces_vt, np.int64) - 1] % 1.0     # [F, 3, 2]

    image = np.asarray(Image.open(filename_texture).convert("RGB"),
                       np.float32) / 255.0
    image = image[::-1]
    ih, iw = image.shape[:2]
    ts = texture_size

    g = np.arange(ts) / (ts - 1.0)
    d0, d1, d2 = np.meshgrid(g, g, g, indexing="ij")
    s = d0 + d1 + d2
    scale = np.where(s > 1, 1.0 / np.maximum(s, 1e-12), 1.0)
    d0, d1, d2 = d0 * scale, d1 * scale, d2 * scale         # [ts, ts, ts]

    # pos = sum_k d_k * uv_k, bilinear sample (truncation semantics of the
    # reference kernel: int() floor + +1 neighbor unclamped modulo wrap-free)
    pos_x = (fuv[:, None, None, None, 0, 0] * d0
             + fuv[:, None, None, None, 1, 0] * d1
             + fuv[:, None, None, None, 2, 0] * d2) * (iw - 1)
    pos_y = (fuv[:, None, None, None, 0, 1] * d0
             + fuv[:, None, None, None, 1, 1] * d1
             + fuv[:, None, None, None, 2, 1] * d2) * (ih - 1)
    x0 = np.clip(pos_x.astype(np.int64), 0, iw - 1)
    y0 = np.clip(pos_y.astype(np.int64), 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    wx = pos_x - x0
    wy = pos_y - y0
    out = (image[y0, x0] * ((1 - wx) * (1 - wy))[..., None]
           + image[y1, x0] * ((1 - wx) * wy)[..., None]
           + image[y0, x1] * (wx * (1 - wy))[..., None]
           + image[y1, x1] * (wx * wy)[..., None])
    return out.astype(np.float32)
