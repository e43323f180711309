"""Synthetic meshes for tests, smoke runs and benchmarks."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_sphere_mesh(n_theta: int = 12, n_phi: int = 24,
                     radius: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """UV sphere with ~2*n_theta*n_phi triangles, verts in [-r, r]."""
    verts = []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.cos(th),
                          radius * np.sin(th) * np.sin(ph)])
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)
