"""The port's RGB half of the renderer (sdn3d_tpu_torch.ops.textures,
ops/rasterize.rasterize_rgbad, render() of RenderType.RGB) against the JAX
package's, on the CPU, from the same numpy inputs."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_rasterize import random_faces
from sdn3d_tpu.ops import rasterize as JR
from sdn3d_tpu.ops import textures as JT
from sdn3d_tpu.render import RenderType as JRT
from sdn3d_tpu.render import render as j_render
from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import textures as TT
from sdn3d_tpu_torch.render.renderer import RenderType, render

# RGB against JAX from the same faces: the barycentrics agree to a few ulp
# (XLA's CPU backend contracts multiply-adds), and a texture index that
# sits on an integer moves a corner weight by as much; measured 6e-8.
RGB_ATOL = 1e-5
# The texture gradient (summed in another order than XLA's scatter) and
# the vertex gradient through the lighting, relative to their largest
# entry.
GRAD_RTOL = 1e-5
LIGHTS = [{}, {"intensity_ambient": 0.3, "intensity_directional": 0.9,
               "color_ambient": (1.0, 0.5, 0.2),
               "color_directional": (0.2, 0.4, 1.0),
               "direction": (0.3, 0.8, -0.5)},
          {"intensity_ambient": 0.0}, {"intensity_directional": 0.0}]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def test_sample_textures_matches_jax():
    """From JAX's face index, barycentrics and depth: the port's sampling
    within RGB_ATOL, the background colour where no face is hit."""
    rng = np.random.RandomState(0)
    faces = random_faces(rng, batch=2, num_faces=9, z_range=(2.0, 4.0))
    tex = rng.rand(2, 9, 4, 4, 4, 3).astype(np.float32)
    fi, w, d, _ = JR.rasterize_face_maps(jnp.asarray(faces), None, 24,
                                         return_face_inv=False)
    bg = (0.1, 0.2, 0.3)
    want = JT.sample_textures(jnp.asarray(faces), jnp.asarray(tex), fi, w, d,
                              1e-4, bg)
    got = TT.sample_textures(_t(faces), _t(tex), _t(fi), _t(w), _t(d), 1e-4,
                             bg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=RGB_ATOL)
    miss = np.asarray(fi) < 0
    assert miss.any() and (~miss).any()
    np.testing.assert_array_equal(_np(got)[miss],
                                  np.broadcast_to(np.float32(bg),
                                                  _np(got)[miss].shape))


@pytest.mark.parametrize("kw", LIGHTS)
def test_lighting_matches_jax(kw):
    rng = np.random.RandomState(1)
    faces = rng.randn(2, 7, 3, 3).astype(np.float32)
    tex = rng.rand(2, 7, 2, 2, 2, 3).astype(np.float32)
    want = JT.lighting(jnp.asarray(faces), jnp.asarray(tex), **kw)
    got = TT.lighting(_t(faces), _t(tex), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_load_textures_matches_jax(tmp_path):
    """An OBJ with texture coordinates (a quad and a pentagon, fanned) and
    a PNG: the baked cubes byte-equal to JAX's."""
    obj = tmp_path / "m.obj"
    rng = np.random.RandomState(2)
    lines = [f"v {a} {b} {c}" for a, b, c in rng.rand(6, 3)]
    lines += [f"vt {u} {v}" for u, v in rng.uniform(-0.5, 1.5, (7, 2))]
    lines += ["f 1/1 2/2 3/3 4/4", "", "f 2/5/1 3/6/1 4/7/1 5/1/1 6/2/1",
              "f 1/3 5/4 6/5"]
    obj.write_text("\n".join(lines) + "\n")
    png = tmp_path / "t.png"
    Image.fromarray(rng.randint(0, 256, (9, 13, 3), np.uint8)).save(png)
    for ts in (2, 4):
        want = JT.load_textures(str(obj), str(png), ts)
        got = TT.load_textures(str(obj), str(png), ts)
        assert got.shape == (6, ts, ts, ts, 3) and got.dtype == np.float32
        assert got.tobytes() == want.tobytes()


def test_rasterize_rgbad_matches_jax():
    """rgb, alpha and depth of rasterize_rgbad (2x supersampled, flipped,
    pooled): the face index under them equal, rgb within RGB_ATOL, alpha
    and depth within 1e-6."""
    rng = np.random.RandomState(3)
    faces = random_faces(rng, batch=2, num_faces=11, z_range=(2.0, 5.0))
    tex = rng.rand(2, 11, 3, 3, 3, 3).astype(np.float32)
    valid = np.ones((2, 11), bool)
    valid[1, 4] = False
    fi_j = JR.rasterize_face_maps(jnp.asarray(faces), jnp.asarray(valid), 32,
                                  return_face_inv=False)[0]
    fi_t, _ = TR.rasterize_face_maps(_t(faces), _t(valid), 32)
    np.testing.assert_array_equal(_np(fi_t), np.asarray(fi_j))
    want = JR.rasterize_rgbad(jnp.asarray(faces), jnp.asarray(tex), 16,
                              face_valid=jnp.asarray(valid),
                              background_color=(0.0, 0.5, 1.0))
    got = TR.rasterize_rgbad(_t(faces), _t(tex), 16, face_valid=_t(valid),
                             background_color=(0.0, 0.5, 1.0))
    assert got["rgb"].shape == (2, 3, 16, 16)
    np.testing.assert_allclose(_np(got["rgb"]), np.asarray(want["rgb"]),
                               rtol=0, atol=RGB_ATOL)
    for k in ("alpha", "depth"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _mesh(seed, B=2, V=10, F=12):
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-0.5, 0.5, (B, V, 3)).astype(np.float32)
    verts[..., 2] -= 4.0
    faces = np.stack([rng.permutation(V)[:3] for _ in range(B * F)]
                     ).reshape(B, F, 3).astype(np.int32)
    tex = rng.rand(B, F, 4, 4, 4, 3).astype(np.float32)
    return verts, faces, tex


@pytest.mark.parametrize("fill_back", [True, False])
def test_render_rgb_matches_jax(fill_back):
    """render() of the RGB type with lighting, per-image viewing angles
    and padded faces: within RGB_ATOL of JAX's (fill_back the 2F
    concatenation with transposed back cubes)."""
    verts, faces, tex = _mesh(4)
    valid = np.ones(faces.shape[:2], bool)
    valid[0, -2:] = False
    kw = dict(image_size=24, viewing_angle=np.asarray([30.0, 24.0],
                                                      np.float32),
              fill_back=fill_back, light_kwargs=LIGHTS[1])
    want = j_render(jnp.asarray(verts), jnp.asarray(faces), JRT.RGB,
                    jnp.asarray(valid), textures=jnp.asarray(tex),
                    **dict(kw, viewing_angle=jnp.asarray(kw["viewing_angle"])))
    got = render(_t(verts), _t(faces), RenderType.RGB, _t(valid),
                 textures=_t(tex),
                 **dict(kw, viewing_angle=_t(kw["viewing_angle"])))
    assert got.shape == (2, 3, 24, 24)
    assert float(got.abs().sum()) > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=RGB_ATOL)


def test_render_rgb_needs_textures():
    verts, faces, _ = _mesh(5)
    with pytest.raises(ValueError, match="textures"):
        render(_t(verts), _t(faces), RenderType.RGB, image_size=8)


def test_texture_and_vertex_gradients_match_jax_autodiff():
    """The gradient of <render(RGB), cot> in the texture cubes (the
    gather's backward as a sorted, ordered sum) and in the vertices
    (through the lighting) against JAX's autodiff, within GRAD_RTOL of
    their largest entries; the texture gradient the same bits on two
    runs and equal to torch.gather's own backward within 1e-6."""
    verts, faces, tex = _mesh(6)
    cot = np.random.RandomState(7).randn(2, 3, 16, 16).astype(np.float32)

    def j_loss(v, t):
        rgb = j_render(v, jnp.asarray(faces), JRT.RGB, image_size=16,
                       textures=t)
        return jnp.sum(rgb * cot)

    gv_j, gt_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(verts),
                                                  jnp.asarray(tex))

    def t_grads():
        v = _t(verts).requires_grad_(True)
        t = _t(tex).requires_grad_(True)
        rgb = render(v, _t(faces), RenderType.RGB, image_size=16, textures=t)
        return torch.autograd.grad((rgb * _t(cot)).sum(), [v, t])

    gv, gt = t_grads()
    for got, want in ((gt, gt_j), (gv, gv_j)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())
    assert torch.equal(t_grads()[1], gt)


def test_texel_gather_backward_matches_gather():
    rng = np.random.RandomState(8)
    table = _t(rng.randn(2, 50, 3).astype(np.float32)).requires_grad_(True)
    index = _t(rng.randint(0, 50, (2, 400)))
    g = _t(rng.randn(2, 400, 3).astype(np.float32))
    (got,) = torch.autograd.grad(TT._TexelGather.apply(table, index), table, g)
    (want,) = torch.autograd.grad(torch.gather(
        table, 1, index[..., None].expand(2, 400, 3)), table, g)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
