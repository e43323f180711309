"""Stand-in for sdn3d_tpu_torch/ops/rasterize_cuda: plain PyTorch on any
device, no kernel.

`rasterize_face_index` computes what the port's plain
`rasterize_face_maps` computes, the same IEEE operations per (face,
pixel) pair, but only over the pairs inside each face's pixel box (with
a one-pixel margin), so that it takes seconds a frame on a card where
the dense version takes ~3.5 s an image.  The winner of a pixel is the
least depth and, among equal depths, the lowest face index: one
`scatter_reduce` of (depth bits << 32 | face) keys, which orders as
(depth, face) because every depth that can win is a positive float.
The walk and the reduction are the frozen plain versions."""

from __future__ import annotations

from typing import Optional

import torch

from perfbench.reference.frozen.ops import rasterize as R

PAIR_BUDGET = 1 << 24          # (face, pixel) pairs a chunk
# while COUNTING[0], each call appends (images, image size, faces, face
# pixel-box pairs, hit pixels) to COUNTS: what the kernels' bounds count
COUNTING = [False]
COUNTS = []


def _face_boxes(faces: torch.Tensor, ok: torch.Tensor, S: int):
    """Inclusive pixel boxes (x0, y0, x1, y1) [B, F] of each face, one
    pixel wider on each side than its vertices' pixel coordinates, clamped
    to the image; empty (x1 < x0) for faces that cannot win."""
    pix = ((faces[..., :2].double() + 1.0) * S - 1.0) * 0.5   # [B, F, 3, 2]
    lo = torch.ceil(pix.amin(2)) - 1
    hi = torch.floor(pix.amax(2)) + 1
    finite = torch.isfinite(pix).all(-1).all(-1)
    lo = torch.clamp(torch.nan_to_num(lo), 0, S)
    hi = torch.clamp(torch.nan_to_num(hi), -1, S - 1)
    hi = torch.where((ok & finite)[..., None], hi, lo - 1)
    return lo.long(), hi.long()


def rasterize_face_maps_boxed(faces: torch.Tensor,
                              face_valid: Optional[torch.Tensor],
                              image_size: int, near: float = R.DEFAULT_NEAR,
                              far: float = R.DEFAULT_FAR,
                              pair_budget: int = PAIR_BUDGET):
    """(face_index [B, S, S] int32, -1 background; depth [B, S, S]
    float32, `far` background), equal to R.rasterize_face_maps."""
    B, F = faces.shape[:2]
    S = int(image_size)
    dev = faces.device
    faces, inv_all, ok_face = R.face_setup(faces, face_valid, S)
    xp1, xi1 = R.pixel_centers(S, dev)
    lo, hi = _face_boxes(faces, ok_face, S)
    w = (hi[..., 0] - lo[..., 0] + 1).clamp(min=0)
    h = (hi[..., 1] - lo[..., 1] + 1).clamp(min=0)
    n = (w * h).reshape(-1)                                  # [B*F]
    sentinel = torch.iinfo(torch.int64).max
    best = torch.full((B * S * S,), sentinel, dtype=torch.int64, device=dev)
    fv = faces.reshape(B * F, 3, 3)
    inv = inv_all.reshape(B * F, 3, 3)
    lo_f, w_f = lo.reshape(B * F, 2), w.reshape(-1)
    ends = torch.cumsum(n, 0)
    total = int(ends[-1]) if n.numel() else 0
    # face ranges of at most ~pair_budget pairs each
    cuts = (torch.searchsorted(ends, torch.arange(
        pair_budget, total, pair_budget, device=dev)).tolist()
        if total > pair_budget else [])
    starts = [0] + [c + 1 for c in cuts]
    stops = [c + 1 for c in cuts] + [B * F]
    for a, b in zip(starts, stops):
        if b <= a:
            continue
        cnt = n[a:b]
        m = int(cnt.sum())
        if m == 0:
            continue
        face = torch.repeat_interleave(torch.arange(a, b, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(m, device=dev) - torch.repeat_interleave(first, cnt)
        px = lo_f[face, 0] + k % w_f[face]
        py = lo_f[face, 1] + k // w_f[face]
        v = fv[face]
        XP, YP = xp1[px], xp1[py]
        XI, YI = xi1[px], xi1[py]
        x0, y0, z0 = v[:, 0, 0], v[:, 0, 1], v[:, 0, 2]
        x1, y1, z1 = v[:, 1, 0], v[:, 1, 1], v[:, 1, 2]
        x2, y2, z2 = v[:, 2, 0], v[:, 2, 1], v[:, 2, 2]
        inside = (((YP - y0) * (x1 - x0) >= (XP - x0) * (y1 - y0))
                  & ((YP - y1) * (x2 - x1) >= (XP - x1) * (y2 - y1))
                  & ((YP - y2) * (x0 - x2) >= (XP - x2) * (y0 - y2)))
        iv = inv[face]

        def bary(r):
            wr = iv[:, r, 0] * XI + iv[:, r, 1] * YI
            return torch.clamp(wr + iv[:, r, 2], 0.0, 1.0)

        w0, w1, w2 = bary(0), bary(1), bary(2)
        w_sum = torch.clamp_min(w0 + w1 + w2, 1e-12)
        w0, w1, w2 = w0 / w_sum, w1 / w_sum, w2 / w_sum
        zp = torch.reciprocal(w0 / z0 + w1 / z1 + w2 / z2)
        take = inside & (zp > near) & (zp < far)
        bimg = face[take] // F
        key = ((zp[take].view(torch.int32).to(torch.int64) << 32)
               | (face[take] % F))
        pix = bimg * (S * S) + py[take] * S + px[take]
        best.scatter_reduce_(0, pix, key, "amin")
    hit = best != sentinel
    if COUNTING[0]:
        from perfbench.kernels.counts import face_box_pairs
        COUNTS.append((B, S, F, face_box_pairs(faces, ok_face, S),
                       int(hit.sum())))
    fi = torch.where(hit, best & 0xFFFFFFFF, torch.full_like(best, -1))
    depth = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                        torch.full((B * S * S,), far, dtype=torch.float32,
                                   device=dev))
    return (fi.to(torch.int32).reshape(B, S, S),
            depth.reshape(B, S, S))


def rasterize_face_index(faces: torch.Tensor,
                         face_valid: Optional[torch.Tensor],
                         image_size: int,
                         near: float = R.DEFAULT_NEAR,
                         far: float = R.DEFAULT_FAR,
                         colors: Optional[torch.Tensor] = None):
    """(face_index, depth[, rgb planar [B, 3, S, S]]), as the port's
    wrapper returns them."""
    out = rasterize_face_maps_boxed(faces, face_valid, image_size, near, far)
    if colors is not None:
        rgb = R._gather_face_colors(out[0], colors.float()).permute(0, 3, 1, 2)
        out = out + (rgb.contiguous(),)
    return out


def walk_grads(alpha: torch.Tensor, grad_alpha: torch.Tensor,
               pp: torch.Tensor, face_index: torch.Tensor, n_steps: int,
               eps: float) -> torch.Tensor:
    """Walk accumulators of both axes [2, B, 3, S, S], axis 0 first."""
    return torch.stack([R.walk_grads_faces_plain(
        alpha, grad_alpha, pp, face_index, n_steps, eps, axis)
        for axis in (0, 1)])


def segment_face_grads(acc_x: torch.Tensor, acc_y: torch.Tensor,
                       face_index: torch.Tensor,
                       num_faces: int) -> torch.Tensor:
    """Pixel->face reduction [B, F, 6]."""
    return R.segment_face_grads_plain(acc_x, acc_y, face_index, num_faces)
