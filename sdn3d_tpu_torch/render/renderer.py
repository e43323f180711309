"""Mesh renderer: camera orchestration + rasterization.

PyTorch counterpart of sdn3d_tpu/render/renderer.py: `render_targets`
(the inference path, one rasterization for silhouette, normal and depth)
and the differentiable `render()` for the Silhouette, Depth and Normal
types.  `render()` of the RGB type (texture sampling and lighting,
ops/textures.py) waits for ROADMAP A9.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from sdn3d_tpu_torch.geometry import camera
from sdn3d_tpu_torch.ops import rasterize as R
from sdn3d_tpu_torch.utils.transfer import constant


class RenderType(enum.IntEnum):
    """derender3d/models/renderer.py:12-16."""
    RGB = 0
    Silhouette = 1
    Depth = 2
    Normal = 3


def render(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    render_type: RenderType = RenderType.Silhouette,
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = 256,
    viewing_angle=30.0,
    anti_aliasing: bool = True,
    fill_back: bool = True,
    near: float = R.DEFAULT_NEAR,
    far: float = R.DEFAULT_FAR,
    eps: float = R.DEFAULT_EPS,
    grad_walk: int = 0,
    vertex_adjacency: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render [B, V, 3] vertices + [B, F, 3] int faces to 2.5D maps,
    differentiable in `vertices` (JAX renderer.py:39-144): [B, 1, H, W]
    for Silhouette and Depth, [B, 3, H, W] for Normal.

    The camera is the fixed derender3d camera (eye at the origin, looking
    along -z, up +y, renderer.py:226-229) after the reference's x-flip fix
    (renderer.py:241-243); `viewing_angle` may be per-batch [B].  fill_back
    is the winding fold: a face that is back-facing is rasterized with
    its winding reversed (and, for Normal, its normal negated).  Normal
    colours each face by its normal from the pre-camera vertices (NMR
    texture-cube convention, renderer.py:60-77) and negates x at the end
    (renderer.py:268-271).  `vertex_adjacency` [B, V, D] routes the face
    gathers' backward through the mesh's adjacency (deterministic)."""
    if render_type not in (RenderType.Silhouette, RenderType.Depth,
                           RenderType.Normal):
        raise NotImplementedError(
            f"render() of type {RenderType(render_type).name} is not ported "
            "yet: texture sampling and lighting (ops/textures.py) are "
            "ROADMAP A9")
    dt = vertices.dtype
    dev = vertices.device

    def gather(v):
        if vertex_adjacency is not None:
            return camera.vertices_to_faces_adj(v, faces, vertex_adjacency)
        return camera.vertices_to_faces(v, faces)

    # x-flip fix (renderer.py:241-243)
    vertices = vertices * constant((-1.0, 1.0, 1.0), dt, dev)
    if render_type == RenderType.Normal:
        colors = camera.face_normals(gather(vertices))           # [B, F, 3]
    B = vertices.shape[0]
    eye = torch.zeros((B, 3), dtype=dt, device=dev)
    direction = constant((0.0, 0.0, -1.0), dt, dev).expand(B, 3)
    up = constant((0.0, 1.0, 0.0), dt, dev).expand(B, 3)
    vertices = camera.look(vertices, eye, direction, up)
    vertices = camera.perspective_divide(vertices, viewing_angle)
    face_verts = gather(vertices)
    if fill_back:
        ccw = R._frontface(face_verts)                          # [B, F]
        face_verts = torch.where(ccw[..., None, None], face_verts,
                                 face_verts.flip(2))
        if render_type == RenderType.Normal:
            colors = torch.where(ccw[..., None], colors, -colors)
    if render_type == RenderType.Silhouette:
        a = R.rasterize_silhouettes(face_verts, face_valid, image_size,
                                    anti_aliasing, near, far, eps,
                                    grad_walk=grad_walk)
        return a[:, None]
    if render_type == RenderType.Depth:
        d = R.rasterize_depth(face_verts, face_valid, image_size,
                              anti_aliasing, near, far)
        return d[:, None]
    rgb = R.rasterize_face_colors(face_verts, colors, face_valid, image_size,
                                  anti_aliasing, near, far)
    return rgb * constant((-1.0, 1.0, 1.0), rgb.dtype,
                          dev)[None, :, None, None]


def project_faces(vertices: torch.Tensor, faces: torch.Tensor,
                  viewing_angle=30.0, fill_back: bool = True,
                  normals: bool = True):
    """The camera half of `render_targets`: raw vertices [B, V, 3] and
    faces [B, F, 3] int -> (face_verts [B, F, 3, 3] in screen space, as
    the rasterizer takes them, and flat normal colours [B, F, 3] or None).
    """
    dt = vertices.dtype
    dev = vertices.device
    # The derender3d camera is FIXED (eye 0, direction -z, up +y,
    # renderer.py:226-229), so `look` is the rotation diag(-1, 1, -1);
    # composed with the x-flip fix that is diag(1, 1, -1) on the raw
    # vertices.  Normals come from the looked faces rotated back.
    vlook = vertices * constant((1.0, 1.0, -1.0), dt, dev)
    fvl = camera.vertices_to_faces(vlook, faces)               # [B, F, 3, 3]
    colors = None
    if normals:
        colors = camera.face_normals(fvl) * constant(
            (-1.0, 1.0, -1.0), dt, dev)                        # [B, F, 3]

    # perspective_divide, elementwise on face verts (perspective.py:5-19)
    angle = torch.as_tensor(viewing_angle, dtype=dt, device=dev) \
        / 180.0 * camera._REFERENCE_PI
    width = torch.tan(angle).reshape(-1, 1, 1).expand(fvl.shape[:3])
    z = fvl[..., 2]
    face_verts = torch.stack([fvl[..., 0] / z / width,
                              fvl[..., 1] / z / width, z], dim=-1)

    if fill_back:
        # Orientation fold instead of the 2F concat: a (non-degenerate)
        # face is front-facing in exactly one winding, so fill_back ==
        # "flip the winding of back-facing faces" (back copies carry
        # negated normals, nr renderer.py:99 convention).
        ccw = R._frontface(face_verts)                         # [B, F]
        face_verts = torch.where(ccw[..., None, None], face_verts,
                                 face_verts.flip(2))
        if normals:
            colors = torch.where(ccw[..., None], colors, -colors)
    return face_verts, colors


def render_targets(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    targets=("silhouette", "normal", "depth"),
    face_valid: Optional[torch.Tensor] = None,
    image_size: int = 256,
    viewing_angle=30.0,
    anti_aliasing: bool = True,
    fill_back: bool = True,
    near: float = R.DEFAULT_NEAR,
    far: float = R.DEFAULT_FAR,
) -> dict:
    """Render several 2.5D targets from ONE rasterization.

    vertices [B, V, 3], faces [B, F, 3] int.  Silhouette, normal and
    depth all derive from a single face-index/depth map (and the flat
    normal colours the rasterizer writes in the same pass).  Returns
    {"silhouette": [B, 1, H, W], "normal": [B, 3, H, W],
    "depth": [B, 1, H, W]} for the requested targets.
    """
    dev = vertices.device
    face_verts, colors = project_faces(vertices, faces, viewing_angle,
                                       fill_back, "normal" in targets)
    size = image_size * 2 if anti_aliasing else image_size
    if face_valid is None:
        face_valid = torch.ones(face_verts.shape[:2], dtype=torch.bool,
                                device=dev)
    with torch.no_grad():
        if colors is not None:
            fi, depth, _, rgb = R._rasterize_sorted(
                face_verts.detach(), face_valid, size, near, far,
                colors=colors.detach().contiguous())
        else:
            fi, depth, _ = R._rasterize_sorted(
                face_verts.detach(), face_valid, size, near, far)

    def finish(img, spatial_dim):
        img = torch.flip(img, dims=(spatial_dim,))
        if anti_aliasing:
            s = img.shape
            img = img.reshape(s[:-2] + (s[-2] // 2, 2, s[-1] // 2, 2))
            img = img.mean(dim=(-3, -1))
        return img

    out = {}
    if "silhouette" in targets:
        out["silhouette"] = finish((fi >= 0).to(torch.float32), 1)[:, None]
    if "depth" in targets:
        out["depth"] = finish(depth, 1)[:, None]
    if "normal" in targets:
        rgb = finish(rgb, 2)
        out["normal"] = rgb * constant(
            (-1.0, 1.0, 1.0), rgb.dtype, dev)[None, :, None, None]
    return out
