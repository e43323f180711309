"""Triangle rasterizer and its silhouette gradient: the plain PyTorch
versions, and the differentiable silhouette built on the kernels.

Counterpart of sdn3d_tpu/ops/rasterize.py: the forward half
(`rasterize_face_maps(impl="xla")`, `_rasterize_sorted`'s non-TPU branch,
`_gather_face_colors`), itself NR-2 "safe" per-pixel semantics of
geometric/neural_renderer/rasterize.py:238-360; the NR-4 silhouette
VJP (`_edge_invariants`, `_silhouette_grad_pixelwise`,
`_reduce_pixel_grads`, `_make_silhouette_fn`, `rasterize_silhouettes`);
and the depth and flat-colour renders of `render()` (`_depth_grad`,
`_make_depth_fn`, `rasterize_depth`, `rasterize_face_colors`), whose
per-face sums are order-fixed (`segment_sum_sorted`).

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


def segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment sums of the rows of values [N, C] (segment ids seg [N],
    in [0, num_segments)) -> [num_segments, C], each segment's rows added
    one after another in their order in `values`: a stable sort by
    segment, then one sequential reduction per segment.  XLA's
    segment_sum adds in that order on the CPU; on the card index_add_ and
    scatter_add_ add with float atomics, whose order (and last bits)
    change from run to run."""
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0, unsafe=True)


class _FaceRowGather(torch.autograd.Function):
    """rows[b, n] = table[b, index[b, n]] for table [B, F, C] and index
    [B, N] (torch.gather along the face axis); the backward sums each
    face's rows with `segment_sum_sorted`, so it gives the same bits on
    every run on the card (torch.gather's backward is a scatter_add)."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.num_faces = table.shape[1]
        B, N = index.shape
        C = table.shape[2]
        return torch.gather(table, 1, index[..., None].expand(B, N, C))

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        B, N, C = g.shape
        F = ctx.num_faces
        seg = index + torch.arange(B, device=index.device)[:, None] * F
        sums = segment_sum_sorted(g.reshape(B * N, C), seg.reshape(-1),
                                  B * F)
        return sums.reshape(B, F, C), None


def _gather_face_colors(fi: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Portable colors[face_index] gather -> [B, H, W, 3]; background 0.
    Differentiable in `colors` (order-fixed backward, `_FaceRowGather`)."""
    B, H, W = fi.shape
    hit = fi >= 0
    fi_c = torch.where(hit, fi, torch.zeros_like(fi)).long()
    rgb = _FaceRowGather.apply(colors, fi_c.reshape(B, H * W))
    rgb = rgb.reshape(B, H, W, colors.shape[2])
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


# ---------------------------------------------------------------------------
# NR-4: approximate silhouette gradient, pixel-parallel
# ---------------------------------------------------------------------------

def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as one IEEE division on every device (a Python number as the
    divisor is a reciprocal multiply on a card)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _edge_invariants(u_all, v_all, d0, d1, hit, isz: int, axis: int,
                     e: int) -> dict:
    """Per-edge loop-invariant terms of the pixel-parallel NMR edge walk
    (JAX rasterize.py:257-317, same operations in the same order).

    u_all/v_all [B, S, L, 3]: the pixel's face's vertex coordinates along
    the d0 (cross) / d1 (walk) directions; d0/d1 the pixel coordinate
    grids, broadcastable to [B, S, L]."""
    i0, i1, i2 = e, (e + 1) % 3, (e + 2) % 3
    Au, Bu, Cu = u_all[..., i0], u_all[..., i1], u_all[..., i2]
    Av, Bv, Cv = v_all[..., i0], v_all[..., i1], v_all[..., i2]
    one = torch.ones_like(Au)
    zero = torch.zeros_like(Au)

    nonvert = Bu != Au
    slope = (Bv - Av) / torch.where(nonvert, Bu - Au, one)
    d1_cross = slope * (d0 - Au) + Av
    if axis == 0:
        direction = torch.where(Au < Bu, -one, one)
    else:
        direction = torch.where(Au < Bu, one, -one)
    d1_in = torch.where(direction > 0, torch.floor(d1_cross),
                        torch.ceil(d1_cross))
    d1_out = d1_in + direction

    col_ok = (hit & nonvert
              & (d0 >= torch.ceil(torch.minimum(Au, Bu)))
              & (d0 <= torch.maximum(Au, Bu))
              & (d1_in >= 0) & (d1_in <= isz - 1)
              & (d1_out >= 0) & (d1_out <= isz - 1))

    # distance factors with validity folded in as exact zeros
    # (kA = 0 <=> the reference's dist == 0 skip)
    base_k = _div((Bu - Au) * 2.0, float(isz))
    kA = torch.where(Bu != d0, base_k / torch.where(Bu != d0, Bu - d0, one),
                     zero)
    kB = torch.where(Au != d0, base_k / torch.where(Au != d0, d0 - Au, one),
                     zero)

    # IN-pass range (the walked span inside the face)
    use_ac = (d0 - Au) * (d0 - Cu) < 0
    slope_ac = (Cv - Av) / torch.where(Cu != Au, Cu - Au, one)
    slope_bc = (Bv - Cv) / torch.where(Bu != Cu, Bu - Cu, one)
    d0_cross2 = torch.where(use_ac, slope_ac * (d0 - Au) + Av,
                            slope_bc * (d0 - Cu) + Cv)
    d1_lim_in = torch.where(direction > 0, torch.ceil(d0_cross2),
                            torch.floor(d0_cross2))
    lo_in = torch.clamp_min(torch.minimum(d1_in, d1_lim_in), 0.0)
    hi_in = torch.clamp_max(torch.maximum(d1_in, d1_lim_in), isz - 1.0)
    in_range = col_ok & (d1 >= lo_in) & (d1 <= hi_in)
    # the pixel's walk distance to its in-boundary; -1 = not in range
    j_gate = torch.where(in_range, (d1_in - d1) * direction, -one)
    is_in_pixel = col_ok & (d1_in == d1)
    return dict(d1_cross=d1_cross, direction=direction, kA=kA, kB=kB,
                j_gate=j_gate, is_in_pixel=is_in_pixel)


def face_pixel_table(faces: torch.Tensor, isz: int) -> torch.Tensor:
    """Pixel-space vertex coordinates of every face, [B, F, 6] (x0 y0 x1 y1
    x2 y2): the face table the walk kernel gathers from."""
    B, F = faces.shape[:2]
    pp = 0.5 * (faces[..., :2] * isz + isz - 1)               # [B, F, 3, 2]
    return pp.reshape(B, F, 6).contiguous()


def _gather_pixel_faces(pp: torch.Tensor,
                        face_index: torch.Tensor) -> torch.Tensor:
    """Rows of the face table pp [B, F, 6] for each pixel's face,
    [B, S, S, 3, 2] (face 0's where the pixel is background)."""
    B, H, W = face_index.shape
    hit = face_index >= 0
    fi_c = torch.where(hit, face_index, torch.zeros_like(face_index)).long()
    return torch.gather(pp, 1, fi_c.reshape(B, H * W, 1).expand(B, H * W, 6)
                        ).reshape(B, H, W, 3, 2)


def face_pixel_coords(faces: torch.Tensor, face_index: torch.Tensor,
                      isz: int) -> torch.Tensor:
    """Pixel-space vertex coordinates of each pixel's face, [B, S, S, 3, 2]
    (face 0's where the pixel is background): the gather that feeds
    `edge_invariant_stack`."""
    face_pixel_coords.calls += 1
    return _gather_pixel_faces(face_pixel_table(faces, isz), face_index)


face_pixel_coords.calls = 0


def edge_invariant_stack(pp_px: torch.Tensor, hit: torch.Tensor, isz: int,
                         axis: int) -> torch.Tensor:
    """The walk's 18 invariant planes [B, 18, S, S] for one axis, in image
    layout: axis 0 walks along rows (d1 = y, d0 = x), axis 1 along
    columns (d1 = x, d0 = y), as the JAX package's XLA loop does.  Per
    edge e, planes 6e..6e+5 hold d1_cross, direction, kA, kB, j_gate and
    is_in_pixel (f32 0/1), the layout walk_grads_pallas takes.

    pp_px [B, S, S, 3, 2]: pixel-space vertex coordinates of each pixel's
    face; hit [B, S, S] bool."""
    edge_invariant_stack.calls += 1
    idx = torch.arange(isz, dtype=torch.float32, device=pp_px.device)
    yi, xi = idx[None, :, None], idx[None, None, :]
    if axis == 0:
        u_all, v_all, d0, d1 = pp_px[..., 0], pp_px[..., 1], xi, yi
    else:
        u_all, v_all, d0, d1 = pp_px[..., 1], pp_px[..., 0], yi, xi
    planes = []
    for e in range(3):
        E = _edge_invariants(u_all, v_all, d0, d1, hit, isz, axis, e)
        planes += [E["d1_cross"], E["direction"], E["kA"], E["kB"],
                   E["j_gate"], E["is_in_pixel"].to(torch.float32)]
    return torch.stack(planes, dim=1).contiguous()


edge_invariant_stack.calls = 0


def _dist_terms(kA, kB, d1_cross, d1_at, diff, gate, eps: float):
    """Gated diff/dist of one edge's two endpoints (JAX rasterize.py:481-488)."""
    dA = kA * (d1_at - d1_cross)
    dA = torch.where(dA > 0, dA + eps, dA - eps)
    dB = kB * (d1_at - d1_cross)
    dB = torch.where(dB > 0, dB + eps, dB - eps)
    gA = torch.where(gate & (kA != 0), diff / dA, 0.0)
    gB = torch.where(gate & (kB != 0), diff / dB, 0.0)
    return gA, gB


def walk_grads_plain(alpha: torch.Tensor, grad_alpha: torch.Tensor,
                     inv: torch.Tensor, n_steps: int, eps: float,
                     axis: int) -> torch.Tensor:
    """Silhouette walk accumulators for one axis from an invariant stack:
    the walk half of the fused walk kernel's plain version
    (`walk_grads_faces_plain`), the JAX package's fori+roll loop
    (rasterize.py:462-531) written one IEEE operation at a time in the
    order the kernel repeats.

    alpha, grad_alpha [B, H, W]; inv [B, 18, H, W] from
    `edge_invariant_stack` for the same axis.  Axis 0 walks along rows,
    axis 1 along columns.  Returns [B, 3, H, W] per-vertex accumulators
    (the d1 component of each of the pixel's face's three vertices).

    Shifted reads wrap around (torch.roll); the gates discard every read
    that falls outside the image, so the kernel's zero halo gives the same
    sums."""
    walk_grads_plain.calls += 1
    dim = 1 if axis == 0 else 2
    size = alpha.shape[dim]
    shape = (1, size, 1) if axis == 0 else (1, 1, size)
    d1 = torch.arange(size, dtype=torch.float32,
                      device=alpha.device).reshape(shape)
    last = float(size - 1)
    planes = inv.unbind(1)
    zero = torch.zeros_like(alpha)
    accs = [zero, zero, zero]
    for k in range(1, n_steps + 1):
        kf = float(k)
        a_fwd = torch.roll(alpha, -k, dims=dim)
        a_bwd = torch.roll(alpha, k, dims=dim)
        g_fwd = torch.roll(grad_alpha, -k, dims=dim)
        g_bwd = torch.roll(grad_alpha, k, dims=dim)
        for e in range(3):
            d1_cross, direction, kA, kB, j_gate, is_in = planes[6 * e:6 * e + 6]
            pos = direction > 0
            a_k = torch.where(pos, a_fwd, a_bwd)
            # OUT: contributions land at the in-boundary pixel, reading
            # alpha/grad at distance k
            d1k = d1 + direction * kf
            in_seg = (d1k >= 0.0) & (d1k <= last)
            g_k = torch.where(pos, g_fwd, g_bwd)
            diff = (a_k - alpha) * g_k
            gate = (is_in > 0) & in_seg & (diff > 0)
            gA, gB = _dist_terms(kA, kB, d1_cross, d1k, diff, gate, eps)
            # IN: pixels at walk distance j = k-1 read their alpha_out (= a_k)
            diff_in = (alpha - a_k) * grad_alpha
            gate_in = (j_gate == kf - 1.0) & (diff_in > 0)
            gA_in, gB_in = _dist_terms(kA, kB, d1_cross, d1, diff_in,
                                       gate_in, eps)
            i0, i1 = e, (e + 1) % 3
            accs[i0] = accs[i0] + gA + gA_in
            accs[i1] = accs[i1] + gB + gB_in
    return torch.stack(accs, dim=1)


walk_grads_plain.calls = 0


def walk_grads_faces_plain(alpha: torch.Tensor, grad_alpha: torch.Tensor,
                           pp: torch.Tensor, face_index: torch.Tensor,
                           n_steps: int, eps: float,
                           axis: int) -> torch.Tensor:
    """The plain version of the fused walk kernel (csrc/silhouette_walk.cu):
    the invariant stack of each pixel's face (`edge_invariant_stack` over
    the face table pp [B, F, 6] gathered by face_index [B, S, S]), then
    `walk_grads_plain`.  Returns [B, 3, S, S] for one axis."""
    isz = face_index.shape[1]
    inv = edge_invariant_stack(_gather_pixel_faces(pp, face_index),
                               face_index >= 0, isz, axis)
    return walk_grads_plain(alpha, grad_alpha, inv, n_steps, eps, axis)


def segment_face_grads_plain(acc_x: torch.Tensor, acc_y: torch.Tensor,
                             face_index: torch.Tensor,
                             num_faces: int) -> torch.Tensor:
    """Pixel->face reduction: the plain version of the CUDA reduction
    kernel (csrc/segment_face_grads.cu), the JAX package's six scalar
    segment sums (rasterize.py:338-346).

    acc_x / acc_y [B, 3, H, W]: per-vertex x / y accumulators of the walk
    (axis 1 / axis 0); face_index [B, H, W].  Returns [B, F, 6] with
    planes (v0x, v0y, v1x, v1y, v2x, v2y) = -sum over the face's pixels."""
    segment_face_grads_plain.calls += 1
    B = face_index.shape[0]
    F = num_faces
    hit = face_index >= 0
    fi_c = torch.where(hit, face_index, torch.zeros_like(face_index)).long()
    seg = (fi_c + torch.arange(B, device=fi_c.device)[:, None, None] * F
           ).reshape(-1)
    sums = []
    for v in range(3):
        for acc in (acc_x, acc_y):
            vals = torch.where(hit, -acc[:, v], 0.0).reshape(-1)
            sums.append(torch.zeros(B * F, dtype=vals.dtype,
                                    device=vals.device).index_add_(0, seg, vals))
    return torch.stack(sums, dim=-1).reshape(B, F, 6)


segment_face_grads_plain.calls = 0


def won_pixel_boxes(face_index: torch.Tensor, num_faces: int) -> torch.Tensor:
    """Each face's box of the pixels it won: the plain version of the
    reduction's box pass (csrc/segment_face_grads.cu `won_box_kernel`).

    face_index [B, H, W].  Returns [B, F, 4] int32 (x_lo, x_hi, y_lo,
    y_hi), inclusive; (S, -1, S, -1) with S = max(H, W) for a face that
    won no pixel."""
    B, H, W = face_index.shape
    F = num_faces
    dev = face_index.device
    hit = (face_index >= 0).reshape(-1)
    seg = (face_index.long() + torch.arange(B, device=dev)[:, None, None] * F
           ).reshape(-1)[hit]
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    coords = [c.expand(B, H, W).reshape(-1)[hit] for c in (xs, ys)]
    cols = []
    for c in coords:
        for init, how in ((max(H, W), "amin"), (-1, "amax")):
            cols.append(torch.full((B * F,), init, dtype=torch.long,
                                   device=dev).scatter_reduce_(0, seg, c, how))
    return torch.stack(cols, -1).reshape(B, F, 4).to(torch.int32)


def silhouette_grad_pixelwise(
    faces: torch.Tensor,          # [B, F, 3, 3]
    face_index: torch.Tensor,     # [B, H, W] int32
    alpha: torch.Tensor,          # [B, H, W]
    grad_alpha: torch.Tensor,     # [B, H, W]
    image_size: int,
    eps: float,
    walk: int = 0,
) -> torch.Tensor:
    """NMR edge gradient (reference rasterize.py:514-745), pixel-parallel,
    as JAX's `_silhouette_grad_pixelwise` (rasterize.py:350-534).

    Every contribution of the reference's per-face edge walks belongs to
    a pixel whose own face is the walking face, so the backward is: per
    axis, a `walk`-step shifted accumulation from each pixel's edge
    invariants (the walk kernel computes them from the face table; its
    plain version builds `edge_invariant_stack`), and a pixel->face
    reduction (reduction kernels, over the boxes of each face's won
    pixels).  Each kernel is dispatched on the device of its input, as the
    forward is.

    walk: max walk length; 0 = image_size (exact reference semantics).
    Returns grad_faces [B, F, 3, 3] (z component 0)."""
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC

    B, F = faces.shape[:2]
    isz = image_size
    W = isz if walk <= 0 else min(walk, isz)
    pp = face_pixel_table(faces.float(), isz)
    alpha = alpha.float().contiguous()
    grad_alpha = grad_alpha.float().contiguous()
    # axis 0 walks along y and yields the y components, axis 1 the x ones
    acc_y, acc_x = TC.walk_grads(alpha, grad_alpha, pp, face_index, W, eps)
    g = TC.segment_face_grads(acc_x, acc_y, face_index, F)
    g = g.reshape(B, F, 3, 2)
    return torch.cat([g, torch.zeros_like(g[..., :1])], dim=-1)


class SilhouetteFn(torch.autograd.Function):
    """Differentiable silhouette (JAX `_make_silhouette_fn`,
    rasterize.py:828-866): the forward is the rasterizer (kernel on the
    card), alpha = face index >= 0; the backward is
    `silhouette_grad_pixelwise` on the saved face index.  The port
    rasterizes in original face order, so there is no permutation."""

    @staticmethod
    def forward(ctx, faces, face_valid, image_size, near, far, eps, walk):
        from sdn3d_tpu_torch.ops.rasterize_cuda import rasterize_face_index
        fi, _ = rasterize_face_index(faces.detach(), face_valid, image_size,
                                     near, far)
        alpha = (fi >= 0).to(torch.float32)
        ctx.save_for_backward(faces, fi, alpha)
        ctx.cfg = (image_size, eps, walk)
        return alpha

    @staticmethod
    def backward(ctx, g):
        faces, fi, alpha = ctx.saved_tensors
        image_size, eps, walk = ctx.cfg
        # alpha is the forward's output: detach it from the graph
        gf = silhouette_grad_pixelwise(faces.detach(), fi, alpha.detach(), g,
                                       image_size, eps, walk=walk)
        return gf.to(faces.dtype), None, None, None, None, None, None


def _flip_rows(img: torch.Tensor, spatial_dim: int) -> torch.Tensor:
    return torch.flip(img, dims=(spatial_dim,))


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool on the last two dims."""
    s = img.shape
    r = img.reshape(s[:-2] + (s[-2] // 2, 2, s[-1] // 2, 2))
    return r.mean(dim=(-3, -1))


def rasterize_silhouettes(
    faces: torch.Tensor,
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = DEFAULT_IMAGE_SIZE,
    anti_aliasing: bool = DEFAULT_ANTI_ALIASING,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    eps: float = DEFAULT_EPS,
    grad_walk: int = 0,
) -> torch.Tensor:
    """Alpha maps [B, H, W] (reference rasterize.py:1008-1031): 2x
    supersampled when anti_aliasing, vertically flipped, average-pooled;
    differentiable in `faces`.

    grad_walk: walk window of the approximate gradient; 0 = exact
    reference semantics (walk to the border)."""
    size = image_size * 2 if anti_aliasing else image_size
    if face_valid is None:
        face_valid = torch.ones(faces.shape[:2], dtype=torch.bool,
                                device=faces.device)
    alpha = SilhouetteFn.apply(faces, face_valid, size, near, far, eps,
                               grad_walk)
    alpha = _flip_rows(alpha, 1)
    if anti_aliasing:
        alpha = _avg_pool2(alpha)
    return alpha


# ---------------------------------------------------------------------------
# NR-6: analytic depth gradient, and the depth and flat-colour renders
# ---------------------------------------------------------------------------

def pixel_attributes(faces: torch.Tensor, face_index: torch.Tensor,
                     pixels: torch.Tensor, image_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Barycentric weights and inverse matrices of the given hit pixels,
    recomputed from the face index as JAX's recompute_pixel_attributes
    (rasterize_pallas.py:766-797) does, with the forward's operations.

    faces [B, F, 3, 3]; face_index [B, S, S]; pixels [N] flat indices
    b * S * S + y * S + x of hit pixels.  Returns (face verts [N, 3, 3],
    weight [N, 3], face_inv [N, 3, 3])."""
    B, F = faces.shape[:2]
    S = image_size
    P = S * S
    b, p = pixels // P, pixels % P
    fv = faces.reshape(B * F, 3, 3)[b * F + face_index.reshape(-1)[pixels]]
    inv, _ = _face_inv(fv, S)
    xi, yi = (p % S).to(fv.dtype), (p // S).to(fv.dtype)
    w = inv[..., 0] * xi[:, None] + inv[..., 1] * yi[:, None] + inv[..., 2]
    w = torch.clamp(w, 0.0, 1.0)
    w_sum = torch.clamp_min(w[:, 0] + w[:, 1] + w[:, 2], 1e-12)
    return fv, w / w_sum[:, None], inv


def _depth_grad(faces: torch.Tensor, face_index: torch.Tensor,
                depth: torch.Tensor, grad_depth: torch.Tensor,
                image_size: int) -> torch.Tensor:
    """Analytic depth gradient (reference rasterize.py:791-844; JAX
    `_depth_grad`, rasterize.py:722-766) over the hit pixels, summed per
    face with `segment_sum_sorted` (JAX: segment_sum).

    faces [B, F, 3, 3]; face_index, depth, grad_depth [B, S, S].
    Returns grad_faces [B, F, 3, 3]."""
    B, F = faces.shape[:2]
    pix = torch.nonzero((face_index >= 0).reshape(-1)).squeeze(1)
    fv, w, inv = pixel_attributes(faces, face_index, pix, image_size)
    d = depth.reshape(-1)[pix]
    gd = grad_depth.reshape(-1)[pix]
    z = fv[..., 2]                                           # [N, 3]
    d2 = d * d
    # dz/dz_k = w_k * depth^2 / z_k^2
    gz = gd[:, None] * w * d2[:, None] / (z * z)
    # dz/d(x,y)_k = -grad * tmp_l * w_k * depth^2 * is/2,
    # tmp_l = -sum_m inv[m, l] / z_m
    rz = 1.0 / z
    tmp = -(inv[:, 0] * rz[:, 0:1] + inv[:, 1] * rz[:, 1:2]
            + inv[:, 2] * rz[:, 2:3])                        # [N, 3]
    gxy = (-gd[:, None, None] * tmp[:, None, :2] * w[..., None]
           * d2[:, None, None] * (image_size / 2.0))         # [N, 3, 2]
    g = torch.cat([gxy, gz[..., None]], dim=-1)              # [N, 3, 3]
    seg = (pix // (image_size * image_size)) * F \
        + face_index.reshape(-1)[pix].long()
    return segment_sum_sorted(g.reshape(-1, 9), seg, B * F
                              ).reshape(B, F, 3, 3)


class DepthFn(torch.autograd.Function):
    """Differentiable depth map (JAX `_make_depth_fn`, rasterize.py:
    870-889): the forward is the rasterizer (kernel on the card), the
    backward `_depth_grad` on the saved face index and depth."""

    @staticmethod
    def forward(ctx, faces, face_valid, image_size, near, far):
        from sdn3d_tpu_torch.ops.rasterize_cuda import rasterize_face_index
        fi, depth = rasterize_face_index(faces.detach(), face_valid,
                                         image_size, near, far)
        ctx.save_for_backward(faces, fi, depth)
        ctx.image_size = image_size
        return depth

    @staticmethod
    def backward(ctx, g):
        faces, fi, depth = ctx.saved_tensors
        gf = _depth_grad(faces.detach().float(), fi, depth.detach(),
                         g.float(), ctx.image_size)
        return gf.to(faces.dtype), None, None, None, None


def rasterize_depth(
    faces: torch.Tensor,
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = DEFAULT_IMAGE_SIZE,
    anti_aliasing: bool = DEFAULT_ANTI_ALIASING,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
) -> torch.Tensor:
    """Depth maps [B, H, W]; background = far (reference
    rasterize.py:1034-1057); differentiable in `faces`."""
    size = image_size * 2 if anti_aliasing else image_size
    if face_valid is None:
        face_valid = torch.ones(faces.shape[:2], dtype=torch.bool,
                                device=faces.device)
    d = DepthFn.apply(faces, face_valid, size, near, far)
    d = _flip_rows(d, 1)
    if anti_aliasing:
        d = _avg_pool2(d)
    return d


def rasterize_face_colors(
    faces: torch.Tensor,
    colors: torch.Tensor,
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = DEFAULT_IMAGE_SIZE,
    anti_aliasing: bool = DEFAULT_ANTI_ALIASING,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> torch.Tensor:
    """Flat-shaded RGB render [B, 3, H, W] from per-face colors [B, F, 3]
    (JAX rasterize.py:1006-1043, the reference's constant texture-cube
    path for normal maps).  Differentiable in `colors` (the gather's
    backward is order-fixed); the geometry is not differentiated."""
    from sdn3d_tpu_torch.ops.rasterize_cuda import rasterize_face_index

    size = image_size * 2 if anti_aliasing else image_size
    if face_valid is None:
        face_valid = torch.ones(faces.shape[:2], dtype=torch.bool,
                                device=faces.device)
    fi, _ = rasterize_face_index(faces.detach(), face_valid, size, near, far)
    bg = torch.tensor(background, dtype=colors.dtype, device=colors.device)
    rgb = torch.where((fi >= 0)[..., None], _gather_face_colors(fi, colors),
                      bg)
    rgb = rgb.permute(0, 3, 1, 2)                            # [B, 3, H, W]
    rgb = _flip_rows(rgb, 2)
    if anti_aliasing:
        rgb = _avg_pool2(rgb)
    return rgb
