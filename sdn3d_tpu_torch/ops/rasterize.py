"""Forward triangle rasterizer: the plain PyTorch version.

Counterpart of the forward half of sdn3d_tpu/ops/rasterize.py
(`rasterize_face_maps(impl="xla")`, `_rasterize_sorted`'s non-TPU branch,
`_gather_face_colors`), itself NR-2 "safe" per-pixel semantics of
geometric/neural_renderer/rasterize.py:238-360.

Conventions (identical to the reference):
  faces [B, F, 3, 3] with screen x, y in [-1, 1] and z in camera units;
  pixel centers at xp = (2*xi + 1 - is) / is; pixel-space vertex coords
  p = (v * is + is - 1) / 2; back faces culled when
  (y2-y0)*(x1-x0) < (y1-y0)*(x2-x0).

For each image and pixel, the winner is the lowest-index face that is
front-facing, valid, non-degenerate, covers the pixel (all three edge
functions >= 0) and has the least interpolated depth strictly inside
(near, far).  Background is face index -1 and depth `far`.

`rasterize_face_maps` is the reference the CUDA kernel
(csrc/rasterize.cu, wrapper ops/rasterize_cuda.py) is held against, and
what that wrapper runs for tensors on the CPU.  Its per-pixel arithmetic
is written one IEEE operation at a time, in the order the kernel repeats,
so that on the card the two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_EPS = 1e-4


def _frontface(faces: torch.Tensor) -> torch.Tensor:
    """faces [..., 3, 3] -> bool [...]; True when NOT backface-culled
    (rasterize.py:307)."""
    x0, y0 = faces[..., 0, 0], faces[..., 0, 1]
    x1, y1 = faces[..., 1, 0], faces[..., 1, 1]
    x2, y2 = faces[..., 2, 0], faces[..., 2, 1]
    return (y2 - y0) * (x1 - x0) >= (y1 - y0) * (x2 - x0)


def _face_inv(faces: torch.Tensor, image_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barycentric inverse matrices in pixel coordinates (rasterize.py:255-272).

    faces [..., 3, 3] -> (face_inv [..., 3, 3], nondegenerate [...]).
    """
    p = 0.5 * (faces[..., :2] * image_size + image_size - 1)  # [..., 3, 2]
    p0x, p0y = p[..., 0, 0], p[..., 0, 1]
    p1x, p1y = p[..., 1, 0], p[..., 1, 1]
    p2x, p2y = p[..., 2, 0], p[..., 2, 1]
    inv = torch.stack([
        torch.stack([p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y], dim=-1),
        torch.stack([p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y], dim=-1),
        torch.stack([p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], dim=-1),
    ], dim=-2)
    denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y))
    ok = denom != 0
    denom = torch.where(ok, denom, torch.ones_like(denom))
    return inv / denom[..., None, None], ok


def face_setup(faces: torch.Tensor, face_valid: Optional[torch.Tensor],
               image_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-face quantities shared by the plain version and the kernel.

    Returns (faces f32 [B, F, 3, 3], face_inv [B, F, 3, 3],
    ok_face [B, F] = front-facing & non-degenerate & valid)."""
    faces = faces.float()
    inv, nondeg = _face_inv(faces, image_size)
    ok = _frontface(faces) & nondeg
    if face_valid is not None:
        ok = ok & face_valid.to(torch.bool)
    return faces, inv, ok


def pixel_centers(image_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre coordinates xp[i] = (2 i + 1 - is) / is, rounded once
    (IEEE division in float32, as the kernel computes them), and the
    pixel indices as float32.  Returns (xp [is], xi [is])."""
    i = np.arange(image_size, dtype=np.float32)
    xp = (np.float32(2.0) * i + np.float32(1.0) - np.float32(image_size)) \
        / np.float32(image_size)
    return (torch.from_numpy(xp).to(device),
            torch.from_numpy(i).to(device))


def _pick_chunk(num_faces: int, batch: int, pixels: int,
                budget: int = 1 << 22) -> int:
    """Face-chunk size so B*C*P intermediates stay ~`budget` elements."""
    c = max(1, budget // max(1, batch * pixels))
    return max(1, min(c, num_faces))


def rasterize_face_maps(
    faces: torch.Tensor,
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = DEFAULT_IMAGE_SIZE,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    budget: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward rasterization: a loop over face chunks, each
    reduced with argmin (ties to the lowest face index); a later chunk
    wins only when its depth is strictly less.

    faces: [B, F, 3, 3]; face_valid: [B, F] bool or None.
    Returns (face_index [B, H, W] int32 (-1 = background),
             depth      [B, H, W] float32 (background = far)).
    `budget` bounds the [B, chunk, H*W] intermediates (default 2^22
    elements on the CPU, 2^26 on a card); it changes the loop's step,
    never the result.
    """
    if budget is None:
        budget = 1 << (26 if faces.is_cuda else 22)
    rasterize_face_maps.calls += 1
    B, F = faces.shape[:2]
    dev = faces.device
    S = image_size
    P = S * S
    faces, inv_all, ok_face = face_setup(faces, face_valid, S)
    xp1, xi1 = pixel_centers(S, dev)
    XP = xp1.repeat(S)[None, None, :]                  # [1, 1, P], p = y*S + x
    YP = xp1.repeat_interleave(S)[None, None, :]
    XI = xi1.repeat(S)[None, None, :]
    YI = xi1.repeat_interleave(S)[None, None, :]

    depth_min = torch.full((B, P), far, dtype=torch.float32, device=dev)
    idx_min = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    C = _pick_chunk(F, B, P, budget)
    for c0 in range(0, F, C):
        v = faces[:, c0:c0 + C]                                 # [B, C, 3, 3]
        inv = inv_all[:, c0:c0 + C]
        e = lambda a: a[..., None]                              # noqa: E731
        x0, y0, z0 = e(v[..., 0, 0]), e(v[..., 0, 1]), e(v[..., 0, 2])
        x1, y1, z1 = e(v[..., 1, 0]), e(v[..., 1, 1]), e(v[..., 1, 2])
        x2, y2, z2 = e(v[..., 2, 0]), e(v[..., 2, 1]), e(v[..., 2, 2])
        inside = (((YP - y0) * (x1 - x0) >= (XP - x0) * (y1 - y0))
                  & ((YP - y1) * (x2 - x1) >= (XP - x1) * (y2 - y1))
                  & ((YP - y2) * (x0 - x2) >= (XP - x2) * (y0 - y2)))

        def bary(r):
            w = e(inv[..., r, 0]) * XI + e(inv[..., r, 1]) * YI
            return torch.clamp(w + e(inv[..., r, 2]), 0.0, 1.0)

        w0, w1, w2 = bary(0), bary(1), bary(2)
        w_sum = torch.clamp_min(w0 + w1 + w2, 1e-12)
        w0, w1, w2 = w0 / w_sum, w1 / w_sum, w2 / w_sum
        zp = torch.reciprocal(w0 / z0 + w1 / z1 + w2 / z2)     # [B, C, P]
        ok = inside & e(ok_face[:, c0:c0 + C]) & (zp > near) & (zp < far)
        zp = torch.where(ok, zp, torch.full_like(zp, far))

        best = torch.argmin(zp, dim=1, keepdim=True)            # first min
        z_best = torch.gather(zp, 1, best)[:, 0]
        ok_best = torch.gather(ok, 1, best)[:, 0]
        take = ok_best & (z_best < depth_min)
        depth_min = torch.where(take, z_best, depth_min)
        idx_min = torch.where(take, (best[:, 0] + c0).to(torch.int32),
                              idx_min)
    return idx_min.reshape(B, S, S), depth_min.reshape(B, S, S)


rasterize_face_maps.calls = 0


def _gather_face_colors(fi: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Portable colors[face_index] gather -> [B, H, W, 3]; background 0."""
    B, H, W = fi.shape
    hit = fi >= 0
    fi_c = torch.where(hit, fi, torch.zeros_like(fi)).long()
    idx = fi_c.reshape(B, H * W, 1).expand(B, H * W, 3)
    rgb = torch.gather(colors, 1, idx).reshape(B, H, W, 3)
    return torch.where(hit[..., None], rgb, torch.zeros_like(rgb))


def _rasterize_sorted(faces, face_valid, image_size: int, near: float,
                      far: float, colors: Optional[torch.Tensor] = None):
    """(face index, depth, perm[, rgb planar [B, 3, H, W]]) in original
    face order: the port does not Morton-sort faces (a TPU scheduling
    device), so `perm` is always None.  Dispatches on the device of
    `faces` through the kernel's wrapper."""
    from sdn3d_tpu_torch.ops.rasterize_cuda import rasterize_face_index
    out = rasterize_face_index(faces, face_valid, image_size, near, far,
                               colors=colors)
    if colors is not None:
        return out[0], out[1], None, out[2]
    return out[0], out[1], None
