"""The port's camera (look_at, get_points_from_angles), FFD class,
Renderer, cube mesh and package exports against the JAX package's, on
the same seeded inputs.

Tolerances: look_at, get_points_from_angles and FFD within 1e-6 (rtol
and atol): both sides evaluate the same float32 formulas, up to XLA's CPU
FMA contraction and summation order (an ulp or two).  Renderer as
tests/test_torch_render.py: silhouettes equal on >= 99.9% of pixels,
depth and normal to rtol 1e-5 / atol 1e-4 where they agree.  The cube
mesh byte-equal."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data.synthetic import make_cube_mesh as j_cube
from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.geometry import camera as JC
from sdn3d_tpu.geometry import ffd as JF
from sdn3d_tpu.render import Renderer as JRenderer
from sdn3d_tpu.render import RenderType as JType
from sdn3d_tpu_torch.data.synthetic import make_cube_mesh as t_cube
from sdn3d_tpu_torch.geometry import FFD, Constraint, look_at
from sdn3d_tpu_torch.geometry.camera import get_points_from_angles
from sdn3d_tpu_torch.render import Renderer, RenderType, render

RTOL, ATOL = 1e-6, 1e-6


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["defaults", "batched_eye", "at_up"])
def test_look_at_matches_jax(case):
    rng = np.random.RandomState(3)
    v = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    eye = rng.uniform(-3, 3, (2, 3) if case != "defaults" else (3,)
                      ).astype(np.float32)
    kw_t, kw_j = {}, {}
    if case == "at_up":
        at = rng.uniform(-.5, .5, (2, 3)).astype(np.float32)
        up = rng.uniform(-1, 1, (3,)).astype(np.float32)
        kw_t = dict(at=torch.from_numpy(at), up=torch.from_numpy(up))
        kw_j = dict(at=jnp.asarray(at), up=jnp.asarray(up))
    got = look_at(torch.from_numpy(v), torch.from_numpy(eye), **kw_t)
    want = JC.look_at(jnp.asarray(v), jnp.asarray(eye), **kw_j)
    assert got.dtype == torch.float32 and got.shape == (2, 40, 3)
    close(got, want)


@pytest.mark.parametrize("degrees", [True, False])
def test_get_points_from_angles_matches_jax(degrees):
    rng = np.random.RandomState(4)
    scale = 180.0 if degrees else np.pi
    d = rng.uniform(1, 3, 5).astype(np.float32)
    el = rng.uniform(-.5, .5, 5).astype(np.float32) * scale
    az = rng.uniform(-1, 1, 5).astype(np.float32) * scale
    for args in ((2.0, 30.0, 45.0), (2.7, el[0], az[0]),
                 (torch.from_numpy(d), torch.from_numpy(el),
                  torch.from_numpy(az))):
        got = get_points_from_angles(*args, degrees=degrees)
        want = JC.get_points_from_angles(
            *(np.asarray(a) for a in args), degrees=degrees)
        assert got.dtype == torch.float32
        assert got.shape == np.asarray(want).shape
        close(got, want)


@pytest.mark.parametrize("constraints", [
    (), JF.CAR_CONSTRAINTS, (JF.Constraint.homogeneity(axis=1, index=(0, 1)),)])
def test_ffd_class_matches_jax(constraints):
    """FFD.from_vertices(...)(coeff) against JAX's, one coefficient vector
    and a batch of them (the port's FFD is batched over leading dims)."""
    rng = np.random.RandomState(5)
    verts = rng.uniform(-0.5, 0.5, (60, 3)).astype(np.float32)
    coeff = (rng.randn(3, 3 * 64) * 0.1).astype(np.float32)
    t_cons = tuple(Constraint(c.kind, c.axis, c.index) for c in constraints)
    tf = FFD.from_vertices(verts, num_grids=4, constraints=t_cons,
                           device="cpu")
    jf = JF.FFD.from_vertices(verts, num_grids=4, constraints=constraints)
    assert tf.B.device.type == "cpu" and tf.num_grids == 4
    got = tf(torch.from_numpy(coeff))
    assert got.shape == (3, 60, 3)
    for i in range(3):
        close(got[i], jf(jnp.asarray(coeff[i])))
    close(tf(torch.zeros(3 * 64)), verts)


def _scene(seed, batch=2):
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


@pytest.mark.parametrize("kind", ["Silhouette", "Depth", "Normal"])
@pytest.mark.parametrize("aa,angle", [(True, None), (False, 33.0)])
def test_renderer_matches_jax(kind, aa, angle):
    """Renderer(image_size, viewing_angle, anti_aliasing) on the plain
    path against JAX's Renderer, with its own angle and with a
    per-call one."""
    verts, faces, valid = _scene(0)
    tr = Renderer(image_size=32, viewing_angle=28.0, anti_aliasing=aa)
    jr = JRenderer(image_size=32, viewing_angle=28.0, anti_aliasing=aa)
    got = tr(torch.from_numpy(verts), torch.from_numpy(faces),
             RenderType[kind], torch.from_numpy(valid), viewing_angle=angle)
    want = np.asarray(jr(jnp.asarray(verts), jnp.asarray(faces),
                         JType[kind], jnp.asarray(valid),
                         viewing_angle=angle))
    assert got.shape == want.shape
    sil_t = tr(torch.from_numpy(verts), torch.from_numpy(faces),
               RenderType.Silhouette, torch.from_numpy(valid),
               viewing_angle=angle).numpy()
    sil_j = np.asarray(jr(jnp.asarray(verts), jnp.asarray(faces),
                          JType.Silhouette, jnp.asarray(valid),
                          viewing_angle=angle))
    same = sil_t == sil_j
    assert same.mean() >= 0.999 and 0.05 < sil_t.mean() < 0.95
    if kind == "Silhouette":
        return
    same = np.repeat(same, got.shape[1], 1)
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=1e-5,
                               atol=1e-4)


def test_renderer_is_render():
    """Renderer's silhouette and vertex gradient are render()'s bits with
    the same arguments (what chip_smoke.py 16d checks on the card)."""
    verts, faces, valid = _scene(1)
    cot = torch.from_numpy(np.random.RandomState(2).randn(2, 1, 32, 32)
                           .astype(np.float32))
    outs = []
    for fn in (lambda v: Renderer(32, 31.0)(v, torch.from_numpy(faces),
                                            face_valid=torch.from_numpy(valid)),
               lambda v: render(v, torch.from_numpy(faces),
                                RenderType.Silhouette,
                                torch.from_numpy(valid), image_size=32,
                                viewing_angle=31.0)):
        v = torch.from_numpy(verts).requires_grad_(True)
        sil = fn(v)
        g, = torch.autograd.grad((sil * cot).sum(), v)
        outs.append((sil.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][1].abs().max() > 0


def test_cube_mesh_matches_jax():
    for scale in (0.5, 1.25):
        v, f = t_cube(scale)
        vj, fj = j_cube(scale)
        assert v.dtype == vj.dtype and f.dtype == fj.dtype
        assert v.tobytes() == vj.tobytes() and f.tobytes() == fj.tobytes()


def test_package_exports_import_no_jax_and_no_card():
    """The JAX package's subpackage exports, from the port's subpackages,
    in a fresh interpreter: no jax, flax or sdn3d_tpu, no matplotlib, no
    CUDA initialised, no kernel built."""
    code = """
import sys
from sdn3d_tpu_torch.render import render, RenderType, render_targets, Renderer
from sdn3d_tpu_torch.geometry import (FFD, Constraint, make_ffd_basis,
    perspective_transform, quaternion_to_matrix, y_rotation_quaternion, look,
    look_at, perspective_divide, load_obj, save_obj)
from sdn3d_tpu_torch.ops import (rasterize_face_maps, rasterize_silhouettes,
    rasterize_depth, rasterize_face_colors)
import torch
from sdn3d_tpu_torch.ops import rasterize_cuda
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "sdn3d_tpu", "matplotlib"))
assert not bad, bad
assert not torch.cuda.is_initialized()
assert not rasterize_cuda._libs, rasterize_cuda._libs
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
