# Frozen copy of sdn3d_tpu_torch/geometry/transforms.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Object-to-camera transforms.

PyTorch counterpart of sdn3d_tpu/geometry/transforms.py
(geometric/derender3d/models/transforms.py:102-158).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (a, b, c, d) -> rotation matrix [..., 3, 3] (transforms.py:117-129)."""
    a, b, c, d = torch.movedim(q, -1, 0)
    row0 = torch.stack([a * a + b * b - c * c - d * d,
                        2 * b * c - 2 * a * d,
                        2 * b * d + 2 * a * c], dim=-1)
    row1 = torch.stack([2 * b * c + 2 * a * d,
                        a * a - b * b + c * c - d * d,
                        2 * c * d - 2 * a * b], dim=-1)
    row2 = torch.stack([2 * b * d - 2 * a * c,
                        2 * c * d + 2 * a * b,
                        a * a - b * b - c * c + d * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def perspective_transform(
    vertices: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    translations: Optional[torch.Tensor] = None,
    perspective_translations: Optional[torch.Tensor] = None,
    zooms: Optional[torch.Tensor] = None,
    zoom_tos: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Scale -> quaternion-rotate -> translate -> perspective shear -> zoom.

    vertices: [B, V, 3].  scales [B, 3], rotations [B, 4] quaternion,
    translations [B, 3], zooms [B, 1].  When `zoom_tos` [B, 1] is given the
    zoom is solved so the object fills the view and (vertices, zooms) is
    returned (transforms.py:102-158).
    """
    if scales is not None:
        vertices = vertices * scales[:, None, :]

    if rotations is not None:
        T = quaternion_to_matrix(rotations)                # [B, 3, 3]
        vertices = torch.matmul(vertices, T.transpose(1, 2))

    if translations is not None:
        vertices = vertices + translations[:, None, :]

    if perspective_translations is None:
        perspective_translations = translations
    pt = perspective_translations[:, None, :]              # [B, 1, 3]

    x, y, z = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    x0, y0, z0 = pt[..., 0], pt[..., 1], pt[..., 2]

    # Object-centric perspective shear (transforms.py:145-146).
    x = x - x0 / z0 * z
    y = y - y0 / z0 * z

    if zoom_tos is not None:
        # Solve the zoom that makes the object exactly fill the view
        # (transforms.py:148-149), in the JAX package's form
        # zoom_to / max(m/|z|) (equal to the reference's
        # min(|z|/m) * zoom_to up to 2 ulp).
        inv = torch.maximum(torch.abs(x), torch.abs(y)) / torch.abs(z)
        zooms = zoom_tos / torch.amax(inv, dim=1, keepdim=True)

    z = z / zooms

    vertices = torch.stack([x, y, z], dim=2)
    if zoom_tos is None:
        return vertices
    return vertices, zooms
