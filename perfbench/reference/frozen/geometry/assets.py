# Frozen copy of sdn3d_tpu_torch/geometry/assets.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""ShapeNet mesh registry for the de-renderer.

Counterpart of sdn3d_tpu/geometry/assets.py.  The reference loads 8
meshes and loops over per-object torch Modules
(derender3d/models/__init__.py:50-63,161-224).  Here all meshes are
padded to a common (V_max, F_max) and stacked so the batched render path
gathers the selected mesh per object slot.

Padding scheme: vertices padded with zeros; faces padded with (0, 0, 0)
and a per-face validity mask carried alongside (invalid faces are culled
inside the rasterizer — degenerate index-0 triangles must NOT reach the
inside test).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from perfbench.reference.frozen.geometry.ffd import make_ffd_basis
from perfbench.reference.frozen.geometry.obj import load_obj, shapenet_normalize

# (class_id, obj_id) in the exact order of derender3d/models/__init__.py:50-59;
# the order defines the meaning of the class logits.
SHAPENET_CARS: Tuple[Tuple[str, str], ...] = (
    ("02958343", "137f67657cdc9da5f985cd98f7d73e9a"),
    ("02958343", "5343e944a7753108aa69dfdc5532bb13"),
    ("02958343", "3776e4d1e2587fd3253c03b7df20edd5"),
    ("02958343", "3ba5bce1b29f0be725f689444c7effe2"),
    ("02958343", "53a031dd120e81dc3aa562f24645e326"),
    ("02924116", "7905d83af08a0ca6dafc1d33c05cbcf8"),
    ("02958343", "a0fe4aac120d5f8a5145cad7315443b3"),
    ("02958343", "cd7feedd6041209131ac5fb37e6c8324"),
)

# Meshes known to be missing from some ShapeNet copies, substituted by the
# listed donor index when their .obj file is absent.
MISSING_SUBSTITUTES = {
    "5343e944a7753108aa69dfdc5532bb13": 0,   # -> 137f67...
    "3ba5bce1b29f0be725f689444c7effe2": 2,   # -> 3776e4...
}


@dataclasses.dataclass
class MeshBank:
    """Stacked, padded mesh set (host numpy; move to device once per run)."""

    vertices: np.ndarray      # [M, V_max, 3] float32, zero-padded
    faces: np.ndarray         # [M, F_max, 3] int32, padded with 0
    face_valid: np.ndarray    # [M, F_max] bool
    vert_valid: np.ndarray    # [M, V_max] bool
    num_vertices: np.ndarray  # [M] int32
    num_faces: np.ndarray     # [M] int32
    ffd_B: np.ndarray         # [M, V_max, G, G, G] float32 (zero on padding)
    ffd_P0: np.ndarray        # [3, G, G, G]
    # Static vertex->(face, corner) adjacency, padded to the bank-wide max
    # degree: adj[m, v, d] = face*4 + corner for every faces[m, face,
    # corner] == v, or -1.  Kept for the training slice's gather-based
    # vertices_to_faces gradient.
    adjacency: np.ndarray     # [M, V_max, D] int32, -1 padded


def _pad_to(arr: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, n - arr.shape[axis])
    return np.pad(arr, pad)


def _vertex_adjacency(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """[F, 3] int faces -> [num_vertices, D] int32 of (face*4 + corner),
    -1 padded, D = max vertex degree."""
    order = np.argsort(faces.reshape(-1), kind="stable")
    v_sorted = faces.reshape(-1)[order]
    counts = np.bincount(v_sorted, minlength=num_vertices)
    D = int(counts.max()) if counts.size else 1
    adj = np.full((num_vertices, max(D, 1)), -1, np.int32)
    slot = np.concatenate([np.arange(c) for c in counts]) if counts.sum() \
        else np.zeros(0, np.int64)
    f_idx = (order // 3).astype(np.int32)
    c_idx = (order % 3).astype(np.int32)
    adj[v_sorted, slot] = f_idx * 4 + c_idx
    return adj


def build_mesh_bank(meshes: Sequence[Tuple[np.ndarray, np.ndarray]],
                    num_grids: int = 4,
                    v_pad: Optional[int] = None,
                    f_pad: Optional[int] = None) -> MeshBank:
    """meshes: list of (vertices [V,3] in [-0.5,0.5], faces [F,3] int)."""
    v_max = max(v.shape[0] for v, _ in meshes)
    f_max = max(f.shape[0] for _, f in meshes)
    if v_pad is not None:
        v_max = max(v_max, v_pad)
    if f_pad is not None:
        f_max = max(f_max, f_pad)

    V, F, FV, VV, NV, NF, BS, ADJ = [], [], [], [], [], [], [], []
    P0 = None
    for verts, faces in meshes:
        nv, nf = verts.shape[0], faces.shape[0]
        B, P0 = make_ffd_basis(verts, num_grids)
        V.append(_pad_to(verts.astype(np.float32), v_max))
        F.append(_pad_to(faces.astype(np.int32), f_max))
        FV.append(_pad_to(np.ones(nf, bool), f_max))
        VV.append(_pad_to(np.ones(nv, bool), v_max))
        NV.append(nv)
        NF.append(nf)
        BS.append(_pad_to(B, v_max))
        ADJ.append(_vertex_adjacency(faces.astype(np.int64), nv))

    d_max = max(a.shape[1] for a in ADJ)
    ADJ = [np.pad(_pad_to(a, v_max), ((0, 0), (0, d_max - a.shape[1])),
                  constant_values=-1) for a in ADJ]
    # _pad_to pads new vertex rows with 0; mark them empty instead.
    for a, nv in zip(ADJ, NV):
        a[nv:] = -1

    return MeshBank(
        vertices=np.stack(V),
        faces=np.stack(F),
        face_valid=np.stack(FV),
        vert_valid=np.stack(VV),
        num_vertices=np.asarray(NV, np.int32),
        num_faces=np.asarray(NF, np.int32),
        ffd_B=np.stack(BS),
        ffd_P0=P0,
        adjacency=np.stack(ADJ),
    )


def load_shapenet_bank(root_dir: Optional[str] = None,
                       num_grids: int = 4) -> MeshBank:
    """Load the 8 ShapeNet car meshes (with substitutes for missing blobs)
    from `root_dir/<class_id>/<obj_id>/models/model_normalized.obj`."""
    root_dir = root_dir or os.environ.get("SHAPENET_ROOT_DIR", "")
    raw: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
    for class_id, obj_id in SHAPENET_CARS:
        path = os.path.join(root_dir, class_id, obj_id, "models",
                            "model_normalized.obj")
        if os.path.exists(path):
            verts, faces = load_obj(path, normalization=True)
            raw.append((shapenet_normalize(verts), faces))
        else:
            raw.append(None)
    for i, ((_, obj_id), entry) in enumerate(zip(SHAPENET_CARS, raw)):
        if entry is None:
            donor = MISSING_SUBSTITUTES.get(obj_id)
            if donor is None or raw[donor] is None:
                raise FileNotFoundError(
                    f"mesh {obj_id} missing and no donor available")
            raw[i] = raw[donor]
    return build_mesh_bank(raw, num_grids=num_grids)
