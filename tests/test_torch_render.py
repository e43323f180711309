"""The port's render_targets (sdn3d_tpu_torch.render) against the JAX
package's on the same vertices."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.render import render_targets as j_render_targets
from sdn3d_tpu_torch.render.renderer import render_targets


def _scene(seed, batch=3):
    """Posed, scaled spheres in front of the camera; some faces invalid."""
    rng = np.random.RandomState(seed)
    v, f = make_sphere_mesh(5, 9)
    verts = np.stack([v * rng.uniform(1.0, 2.0, 3) + [rng.uniform(-.3, .3),
                                                      rng.uniform(-.3, .3),
                                                      -rng.uniform(2.2, 3)]
                      for _ in range(batch)]).astype(np.float32)
    faces = np.repeat(f[None], batch, 0)
    valid = np.ones(faces.shape[:2], bool)
    valid[1, ::5] = False
    return verts, faces, valid


@pytest.mark.parametrize("aa,fill_back", [(True, True), (False, True),
                                          (True, False)])
def test_render_targets_matches_jax(aa, fill_back):
    """Silhouette equal on >= 99.9% of pixels (exactly equal here), depth
    and normal to rtol 1e-5 / atol 1e-4 where the silhouettes agree.  The
    face setup (perspective, winding fold, normals) is the same float32
    arithmetic on both sides, up to XLA's CPU FMA contraction (an ulp)."""
    verts, faces, valid = _scene(0)
    ang = np.asarray([28.0, 30.0, 33.0], np.float32)
    kw = dict(image_size=48, anti_aliasing=aa, fill_back=fill_back)
    want = j_render_targets(jnp.asarray(verts), jnp.asarray(faces),
                            ("silhouette", "normal", "depth"),
                            jnp.asarray(valid), viewing_angle=jnp.asarray(ang),
                            **kw)
    got = render_targets(torch.from_numpy(verts), torch.from_numpy(faces),
                         ("silhouette", "normal", "depth"),
                         torch.from_numpy(valid),
                         viewing_angle=torch.from_numpy(ang), **kw)
    sil_t, sil_j = got["silhouette"].numpy(), np.asarray(want["silhouette"])
    assert sil_t.shape == sil_j.shape == (3, 1, 48, 48)
    assert 0.05 < sil_t.mean() < 0.95
    same = sil_t == sil_j
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(want["depth"])[same],
                               rtol=1e-5, atol=1e-4)
    same3 = np.repeat(same, 3, 1)
    np.testing.assert_allclose(got["normal"].numpy()[same3],
                               np.asarray(want["normal"])[same3],
                               rtol=1e-5, atol=1e-4)
    bg = sil_t == 0
    assert (got["depth"].numpy()[bg] == 100.0).all()


def test_render_targets_silhouette_only():
    verts, faces, valid = _scene(1, batch=2)
    got = render_targets(torch.from_numpy(verts), torch.from_numpy(faces),
                         ("silhouette",), image_size=32)
    want = j_render_targets(jnp.asarray(verts), jnp.asarray(faces),
                            ("silhouette",), image_size=32)
    assert set(got) == {"silhouette"}
    np.testing.assert_array_equal(got["silhouette"].numpy(),
                                  np.asarray(want["silhouette"]))
