# Frozen copy of sdn3d_tpu_torch/geometry/camera.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Camera transforms: look / look_at / perspective divide / face gathers
(one with a gather-based backward over the mesh's adjacency) / camera
positions from angles.

PyTorch counterpart of sdn3d_tpu/geometry/camera.py
(geometric/neural_renderer/{look,look_at,perspective,vertices_to_faces,
get_points_from_angles}.py).
"""

from __future__ import annotations

from typing import Optional

import torch

# The reference uses a truncated pi in the perspective transform
# (neural_renderer/perspective.py:10: `angle / 180. * 3.1416`).  Kept for
# bit-parity of the projection.
_REFERENCE_PI = 3.1416


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=dim, keepdim=True), eps)


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 1 else x


def look(vertices: torch.Tensor,
         eye: torch.Tensor,
         direction: Optional[torch.Tensor] = None,
         up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'Look' transformation (neural_renderer/look.py:7-45).

    vertices [B, V, 3]; eye [3] or [B, 3]; direction/up likewise.
    """
    kw = dict(dtype=vertices.dtype, device=vertices.device)
    if direction is None:
        direction = torch.tensor([0.0, 0.0, 1.0], **kw)
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], **kw)
    eye, direction, up = _atleast_2d(eye), _atleast_2d(direction), _atleast_2d(up)
    z_axis = _normalize(direction)
    x_axis = _normalize(torch.linalg.cross(up.expand_as(z_axis), z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack([x_axis, y_axis, z_axis], dim=1)          # [B, 3, 3] rows
    vertices = vertices - eye[:, None, :]
    return torch.matmul(vertices, r.transpose(1, 2))


def perspective_divide(vertices: torch.Tensor, angle_deg) -> torch.Tensor:
    """Perspective projection (neural_renderer/perspective.py:5-19).

    x,y are divided by z * tan(angle); z passes through.  `angle_deg` is a
    scalar or [B] tensor in degrees.
    """
    angle = torch.as_tensor(angle_deg, dtype=vertices.dtype,
                            device=vertices.device) / 180.0 * _REFERENCE_PI
    width = torch.tan(angle).reshape(-1, 1).expand(vertices.shape[:2])
    z = vertices[..., 2]
    x = vertices[..., 0] / z / width
    y = vertices[..., 1] / z / width
    return torch.stack([x, y, z], dim=2)


def vertices_to_faces(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Gather per-face vertex triplets (neural_renderer/vertices_to_faces.py).

    vertices [B, V, 3], faces [B, F, 3] int -> [B, F, 3, 3].
    """
    B, F = faces.shape[:2]
    idx = faces.long().reshape(B, F * 3, 1).expand(B, F * 3, 3)
    return torch.gather(vertices, 1, idx).reshape(B, F, 3, 3)


class _VerticesToFacesAdj(torch.autograd.Function):
    """vertices_to_faces whose backward is a gather over the mesh's
    vertex->(face, corner) adjacency plus a masked sum (JAX
    camera.py:111-143), instead of autograd's scatter-add with atomics:
    deterministic on every device."""

    @staticmethod
    def forward(ctx, vertices, faces, adjacency, fill_back):
        ctx.save_for_backward(faces, adjacency)
        ctx.fill_back = fill_back
        return vertices_to_faces(vertices, faces)

    @staticmethod
    def backward(ctx, g):
        faces, adjacency = ctx.saved_tensors
        F = faces.shape[1]
        if ctx.fill_back:
            # back copies are the front faces with reversed winding: the
            # grad of face f+F0 corner c belongs to front face f corner 2-c
            F0 = F // 2
            h = g[:, :F0] + g[:, F0:].flip(2)
        else:
            h = g
        B, V, D = adjacency.shape
        valid = adjacency >= 0
        zero = torch.zeros_like(adjacency)
        af = torch.where(valid, adjacency >> 2, zero).long()
        ac = torch.where(valid, adjacency & 3, zero).long()
        rows = (af * 3 + ac).reshape(B, V * D, 1).expand(B, V * D, 3)
        picked = torch.gather(h.reshape(B, -1, 3), 1, rows).reshape(B, V, D, 3)
        dv = torch.where(valid[..., None], picked, 0.0).sum(dim=2)
        return dv, None, None, None


def vertices_to_faces_adj(vertices: torch.Tensor, faces: torch.Tensor,
                          adjacency: torch.Tensor,
                          fill_back: bool = False) -> torch.Tensor:
    """vertices_to_faces with a gather-based backward (JAX camera.py:146-161).

    adjacency [B, V, D] int32: entries face*4 + corner of every face
    corner that uses the vertex, -1 padded (assets._vertex_adjacency).
    When `fill_back` is True, `faces` holds [front ‖ reversed-back] copies
    and `adjacency` describes only the front half."""
    return _VerticesToFacesAdj.apply(vertices, faces, adjacency, fill_back)


def face_normals(face_vertices: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-face unit normals, NMR convention (derender3d renderer.py:66-73):
    normalize(cross(v0 - v1, v2 - v1)).  face_vertices [B, F, 3, 3] -> [B, F, 3].
    """
    v10 = face_vertices[:, :, 0] - face_vertices[:, :, 1]
    v12 = face_vertices[:, :, 2] - face_vertices[:, :, 1]
    n = torch.linalg.cross(v10, v12)
    return n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), eps)
