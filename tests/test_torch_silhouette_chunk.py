"""The port's face-chunk silhouette gradient (sdn3d_tpu_torch.ops.rasterize.
silhouette_grad_chunked) against JAX's `_silhouette_grad`
(rasterize.py:541-720) and against the port's pixelwise gradient
(walk kernel + reduction, their plain versions on the CPU), on the same
faces, face index and cotangent."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_rasterize import random_faces
from sdn3d_tpu.ops import rasterize as JR
from sdn3d_tpu_torch.ops import rasterize as TR

# Against JAX: the same arithmetic, elementwise then summed per face in
# another order (XLA's reduce), relative to the largest entry.
JAX_RTOL = 1e-5
# Against the pixelwise path: the two forms sum the same terms in other
# orders (tests/test_rasterize.py's 1e-3 for JAX's two forms).
PIXELWISE_TOL = 1e-3


def _case(seed, B, F, isz, invalid=()):
    faces = random_faces(np.random.RandomState(seed), batch=B, num_faces=F)
    valid = np.ones((B, F), bool)
    for b, f in invalid:
        valid[b, f] = False
    fi, _ = TR.rasterize_face_maps(torch.from_numpy(faces),
                                   torch.from_numpy(valid), isz)
    cot = np.random.RandomState(seed + 1).randn(B, isz, isz).astype(np.float32)
    return faces, valid, fi.numpy(), cot


@pytest.mark.parametrize("seed,B,F,isz,invalid", [
    (17, 2, 7, 20, ()), (3, 2, 37, 32, ((0, 2), (1, 5))), (9, 1, 4, 24, ())])
def test_chunked_gradient_matches_jax(seed, B, F, isz, invalid):
    """The face-chunk gradient within JAX_RTOL of JAX's `_silhouette_grad`
    on the same face index (the port's forward equals JAX's)."""
    faces, valid, fi, cot = _case(seed, B, F, isz, invalid)
    fi_j = JR.rasterize_face_maps(jnp.asarray(faces), jnp.asarray(valid), isz,
                                  impl="xla")[0]
    np.testing.assert_array_equal(fi, np.asarray(fi_j))
    alpha = (fi >= 0).astype(np.float32)
    want = np.asarray(JR._silhouette_grad(
        jnp.asarray(faces), jnp.asarray(valid), jnp.asarray(fi),
        jnp.asarray(alpha), jnp.asarray(cot), isz, JR.DEFAULT_EPS))
    got = TR.silhouette_grad_chunked(
        torch.from_numpy(faces), torch.from_numpy(valid), torch.from_numpy(fi),
        torch.from_numpy(alpha), torch.from_numpy(cot), isz, TR.DEFAULT_EPS)
    assert got.shape == (B, F, 3, 3) and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=JAX_RTOL * np.abs(want).max())
    assert (got[..., 2] == 0).all()


@pytest.mark.parametrize("seed,B,F,isz", [(17, 2, 7, 20), (3, 2, 37, 32)])
def test_chunked_gradient_matches_the_pixelwise_path(seed, B, F, isz):
    """The face-chunk gradient against the port's pixelwise gradient
    walking to the border (walk 0), as tests/test_rasterize.py holds JAX's
    two forms: within PIXELWISE_TOL (relative and absolute)."""
    faces, valid, fi, cot = _case(seed, B, F, isz)
    t = torch.from_numpy
    alpha = (t(fi) >= 0).float()
    chunk = TR.silhouette_grad_chunked(t(faces), t(valid), t(fi), alpha,
                                       t(cot), isz, TR.DEFAULT_EPS)
    pix = TR.silhouette_grad_pixelwise(t(faces), t(fi), alpha, t(cot), isz,
                                       TR.DEFAULT_EPS, walk=0)
    np.testing.assert_allclose(pix.numpy(), chunk.numpy(),
                               rtol=PIXELWISE_TOL, atol=PIXELWISE_TOL)
