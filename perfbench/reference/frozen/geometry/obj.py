# Frozen copy of sdn3d_tpu_torch/geometry/obj.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Wavefront OBJ load/save (host-side, numpy).

Behavior matches geometric/neural_renderer/load_obj.py:95-141 (vertex +
triangle-fan face parsing, unit-cube normalization) and save_obj.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str, normalization: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Parse 'v' and 'f' records; triangulate polygon fans.

    Returns (vertices [V, 3] float32, faces [F, 3] int32, 0-indexed).
    """
    vertices = []
    faces = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                vs = parts[1:]
                v0 = int(vs[0].split("/")[0])
                for i in range(len(vs) - 2):
                    v1 = int(vs[i + 1].split("/")[0])
                    v2 = int(vs[i + 2].split("/")[0])
                    faces.append((v0, v1, v2))
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32) - 1

    if normalization:
        # load_obj.py:131-136: shift to min 0, scale max |v| to 1, double,
        # center so each axis range is symmetric about 0.
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    return vertices, faces


def shapenet_normalize(vertices: np.ndarray) -> np.ndarray:
    """ShapeNet car post-processing (derender3d/models/__init__.py:30-31):
    per-axis range -> 1, axes permuted [z, y, x], x negated."""
    vertices = vertices / np.ptp(vertices, axis=0)
    return vertices[:, [2, 1, 0]] * np.asarray([-1, 1, 1], dtype=np.float32)
