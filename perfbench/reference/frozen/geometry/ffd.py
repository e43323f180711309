# Frozen copy of sdn3d_tpu_torch/geometry/ffd.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Free-form deformation with Bernstein basis.

PyTorch counterpart of sdn3d_tpu/geometry/ffd.py (itself a re-expression
of geometric/derender3d/models/transforms.py:10-99).  The basis is
precomputed on the host in numpy; `deform` is a batched tensor function
so padded object slots deform in one product, and `FFD` is the
reference's one-mesh object over it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
from scipy import special


@dataclasses.dataclass(frozen=True)
class Constraint:
    """FFD control-point constraint (transforms.py:11-35).

    kind: "symmetry" (mirror control grid along `axis`, negating the z
    displacement component) or "homogeneity" (tie the non-`axis`
    displacement components of grid slices `index` along `axis` to their
    mean).
    """

    kind: str
    axis: int
    index: Tuple[int, ...] = ()

    @staticmethod
    def symmetry(axis: int) -> "Constraint":
        return Constraint(kind="symmetry", axis=axis)

    @staticmethod
    def homogeneity(axis: int, index: Sequence[int]) -> "Constraint":
        return Constraint(kind="homogeneity", axis=axis, index=tuple(index))


# The constraint set used by Derenderer3d for all car meshes
# (derender3d/models/__init__.py:60-63).
CAR_CONSTRAINTS = (
    Constraint.symmetry(axis=2),
    Constraint.homogeneity(axis=1, index=(0, 1)),
)


def make_ffd_basis(vertices: np.ndarray, num_grids: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute the Bernstein tensor-product basis.

    vertices: [V, 3] in [-0.5, 0.5] per axis (ShapeNet post-normalization).
    Returns (B [V, G, G, G], P0 [3, G, G, G]); transforms.py:51-66.
    """
    assert num_grids % 2 == 0
    grids = np.arange(num_grids)
    binoms = special.binom(num_grids - 1, grids).astype(np.float32)  # [G]
    v = vertices.astype(np.float32)  # [V, 3]
    # coeff[v, axis, g] = C(G-1,g) (0.5+x)^g (0.5-x)^(G-1-g)
    coeff = (
        binoms[None, None, :]
        * np.power(0.5 + v[:, :, None], grids[None, None, :])
        * np.power(0.5 - v[:, :, None], num_grids - 1 - grids[None, None, :])
    )
    B = np.einsum("ni,nj,nk->nijk", coeff[:, 0], coeff[:, 1], coeff[:, 2])
    mesh = np.stack(np.meshgrid(grids, grids, grids, indexing="ij"), axis=0)
    P0 = (mesh / (num_grids - 1) - 0.5).astype(np.float32)  # [3, G, G, G]
    return B.astype(np.float32), P0


def apply_constraints(dP: torch.Tensor,
                      constraints: Sequence[Constraint]) -> torch.Tensor:
    """Project control-point displacements onto the constraint set.

    dP: [..., 3, G, G, G] (component, gx, gy, gz); transforms.py:68-95.
    """
    for c in constraints:
        grid_dim = dP.dim() - 3 + c.axis
        if c.kind == "symmetry":
            # the reference negates the z COMPONENT for every symmetry
            # axis (models/transforms.py:73-77), not the mirrored one
            flipped = torch.flip(dP, dims=(grid_dim,)).clone()
            flipped[..., 2, :, :, :] *= -1.0
            dP = (dP + flipped) / 2.0
        elif c.kind == "homogeneity":
            moved = torch.movedim(dP, grid_dim, 0)        # [G, ..., 3, G, G]
            mean = torch.stack([moved[i] for i in c.index], 0).mean(0)
            slices = []
            for i in range(dP.shape[grid_dim]):
                if i in c.index:
                    s = mean.clone()
                    s[..., c.axis, :, :] = moved[i][..., c.axis, :, :]
                else:
                    s = moved[i]
                slices.append(s)
            dP = torch.movedim(torch.stack(slices, 0), 0, grid_dim)
        else:
            raise ValueError(f"unknown constraint kind {c.kind}")
    return dP


def deform(B: torch.Tensor, P0: torch.Tensor, ffd_coeff: torch.Tensor,
           num_grids: int = 4,
           constraints: Sequence[Constraint] = CAR_CONSTRAINTS) -> torch.Tensor:
    """FFD: B [..., V, G, G, G], P0 [3, G, G, G], ffd_coeff [..., 3*G^3]
    -> deformed vertices [..., V, 3].

    Leading dimensions batch (the padded object slots of render_blob).
    """
    G = num_grids
    lead = ffd_coeff.shape[:-1]
    dP = apply_constraints(ffd_coeff.reshape(lead + (3, G, G, G)),
                           constraints)
    P = (P0 + dP).reshape(lead + (3, G ** 3))                 # [..., 3, G^3]
    Bf = B.reshape(B.shape[:-3] + (G ** 3,))                   # [..., V, G^3]
    return torch.matmul(Bf, P.transpose(-1, -2))
