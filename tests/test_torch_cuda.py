"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import rasterize_cuda as TC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _faces(seed, batch, num_faces):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1.2, 1.2, size=(batch, num_faces, 3, 2))
    z = rng.uniform(1.5, 6.0, size=(batch, num_faces, 3, 1))
    faces = np.concatenate([xy, z], axis=-1).astype(np.float32)
    faces[:, 3] = faces[:, 1]                 # exact depth tie
    faces[:, 4] = faces[:, 4, ::-1]           # back-face
    valid = np.ones((batch, num_faces), bool)
    valid[:, 2] = False
    colors = rng.uniform(-1, 1, (batch, num_faces, 3)).astype(np.float32)
    return faces, valid, colors


@pytest.mark.cuda
@pytest.mark.parametrize("isz", [128, 100])
def test_rasterize_kernel_matches_plain(cuda, isz):
    """Face index, depth and colours bit-equal to the plain version on the
    same card (100^2 has a ragged tile edge)."""
    faces, valid, colors = (torch.from_numpy(a).to(cuda)
                            for a in _faces(isz, 2, 37))
    fi, depth, rgb = TC.rasterize_face_index(faces, valid, isz,
                                             colors=colors)
    fi_p, depth_p = TR.rasterize_face_maps(faces, valid, isz)
    rgb_p = TR._gather_face_colors(fi_p, colors).permute(0, 3, 1, 2)
    assert torch.equal(fi, fi_p)
    assert torch.equal(depth, depth_p)
    assert torch.equal(rgb, rgb_p)
