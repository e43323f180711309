"""The port's geometry (sdn3d_tpu_torch.geometry) against the JAX
package's on the same seeded inputs.  Cases follow tests/test_geometry.py.

Tolerance: f32 rtol 1e-6 (atol 1e-6 near zero).  Both sides evaluate the
same formulas in float32; they differ only where XLA's CPU backend
contracts a*b+c into an FMA or sums a small product in another order,
which moves results by an ulp or two."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.geometry import assets as JA
from sdn3d_tpu.geometry import camera as JC
from sdn3d_tpu.geometry import ffd as JF
from sdn3d_tpu.geometry import obj as JO
from sdn3d_tpu.geometry import transforms as JT
from sdn3d_tpu.data.synthetic import make_sphere_mesh as j_sphere
from sdn3d_tpu_torch.geometry import assets as TA
from sdn3d_tpu_torch.geometry import camera as TCm
from sdn3d_tpu_torch.geometry import ffd as TF
from sdn3d_tpu_torch.geometry import obj as TO
from sdn3d_tpu_torch.geometry import transforms as TT
from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh as t_sphere

RTOL, ATOL = 1e-6, 1e-6


def close(t, j):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=RTOL, atol=ATOL)


def test_sphere_mesh_and_obj_roundtrip(tmp_path):
    v, f = t_sphere(4, 8)
    vj, fj = j_sphere(4, 8)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    TO.save_obj(str(tmp_path / "m.obj"), v * 3 + 1, f)
    for norm in (False, True):
        vt, ft = TO.load_obj(str(tmp_path / "m.obj"), normalization=norm)
        vj2, fj2 = JO.load_obj(str(tmp_path / "m.obj"), normalization=norm)
        np.testing.assert_array_equal(vt, vj2)
        np.testing.assert_array_equal(ft, fj2)
    np.testing.assert_array_equal(TO.shapenet_normalize(vt),
                                  JO.shapenet_normalize(vt))


@pytest.mark.parametrize("constraints", [
    JF.CAR_CONSTRAINTS, (JF.Constraint.homogeneity(axis=1, index=(0, 1)),),
    (JF.Constraint.symmetry(axis=0),)])
def test_ffd_deform(constraints):
    """make_ffd_basis is a numpy copy (bit-equal); deform with the car
    constraints and single constraints, batched over slots."""
    rng = np.random.RandomState(1)
    verts = rng.uniform(-0.5, 0.5, size=(50, 3)).astype(np.float32)
    Bt, P0t = TF.make_ffd_basis(verts, 4)
    Bj, P0j = JF.make_ffd_basis(verts, 4)
    np.testing.assert_array_equal(Bt, Bj)
    np.testing.assert_array_equal(P0t, P0j)
    coeff = (rng.randn(3, 3 * 64) * 0.1).astype(np.float32)
    tcons = tuple(TF.Constraint(c.kind, c.axis, c.index) for c in constraints)
    got = TF.deform(torch.from_numpy(np.stack([Bt] * 3)), torch.from_numpy(P0t),
                    torch.from_numpy(coeff), 4, tcons)
    for k in range(3):
        want = JF.deform(jnp.asarray(Bj), jnp.asarray(P0j),
                         jnp.asarray(coeff[k]), 4, constraints)
        close(got[k], want)
    dP = rng.randn(2, 3, 4, 4, 4).astype(np.float32)
    got = TF.apply_constraints(torch.from_numpy(dP), tcons)
    for k in range(2):
        close(got[k], JF.apply_constraints(jnp.asarray(dP[k]), constraints))


def test_transforms_and_zoom_solve():
    rng = np.random.RandomState(3)
    v = rng.uniform(-0.5, 0.5, size=(2, 30, 3)).astype(np.float32)
    t = np.asarray([[0.1, 0.0, -5.0], [0.0, 0.2, -6.0]], np.float32)
    s = rng.uniform(0.5, 2, (2, 3)).astype(np.float32)
    th = np.asarray([0.5, -2.0], np.float32)
    qt = TT.y_rotation_quaternion(torch.from_numpy(th))
    qj = JT.y_rotation_quaternion(jnp.asarray(th))
    close(qt, qj)
    close(TT.quaternion_to_matrix(qt), JT.quaternion_to_matrix(qj))
    zt = np.full((2, 1), 0.5, np.float32)
    out_t, zooms_t = TT.perspective_transform(
        torch.from_numpy(v), torch.from_numpy(s), qt, torch.from_numpy(t),
        torch.from_numpy(t), zoom_tos=torch.from_numpy(zt))
    out_j, zooms_j = JT.perspective_transform(
        jnp.asarray(v), jnp.asarray(s), qj, jnp.asarray(t), jnp.asarray(t),
        zoom_tos=jnp.asarray(zt))
    close(zooms_t, zooms_j)
    close(out_t, out_j)
    out_t = TT.perspective_transform(torch.from_numpy(v), translations=torch.from_numpy(t),
                                     zooms=torch.full((2, 1), 2.0))
    out_j = JT.perspective_transform(jnp.asarray(v), translations=jnp.asarray(t),
                                     zooms=jnp.full((2, 1), 2.0))
    close(out_t, out_j)


def test_camera():
    rng = np.random.RandomState(4)
    v = rng.uniform(-1, 1, (2, 12, 3)).astype(np.float32)
    v[..., 2] += 4.0
    eye = np.zeros(3, np.float32)
    d = np.asarray([0.0, 0.0, -1.0], np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    close(TCm.look(torch.from_numpy(v), torch.from_numpy(eye),
                   torch.from_numpy(d), torch.from_numpy(up)),
          JC.look(jnp.asarray(v), jnp.asarray(eye), jnp.asarray(d),
                  jnp.asarray(up)))
    ang = np.asarray([30.0, 45.0], np.float32)
    close(TCm.perspective_divide(torch.from_numpy(v), torch.from_numpy(ang)),
          JC.perspective_divide(jnp.asarray(v), jnp.asarray(ang)))
    assert TCm._REFERENCE_PI == JC._REFERENCE_PI == 3.1416
    faces = rng.randint(0, 12, (2, 7, 3)).astype(np.int32)
    fv_t = TCm.vertices_to_faces(torch.from_numpy(v), torch.from_numpy(faces))
    fv_j = JC.vertices_to_faces(jnp.asarray(v), jnp.asarray(faces))
    np.testing.assert_array_equal(fv_t.numpy(), np.asarray(fv_j))
    close(TCm.face_normals(fv_t), JC.face_normals(fv_j))


def test_mesh_bank_padding_and_adjacency():
    """build_mesh_bank (padding, validity, FFD basis) and the vertex
    adjacency are numpy copies: bit-equal, including padded rows."""
    rng = np.random.RandomState(5)
    meshes = [t_sphere(4, 8), t_sphere(3, 6),
              (rng.uniform(-0.5, 0.5, (7, 3)).astype(np.float32),
               np.array([[0, 1, 2], [2, 3, 4]], np.int32))]
    bt = TA.build_mesh_bank(meshes, f_pad=64)
    bj = JA.build_mesh_bank(meshes, f_pad=64)
    for field in ("vertices", "faces", "face_valid", "vert_valid",
                  "num_vertices", "num_faces", "ffd_B", "ffd_P0",
                  "adjacency"):
        np.testing.assert_array_equal(getattr(bt, field), getattr(bj, field),
                                      err_msg=field)
    assert bt.faces.shape[1] == 64 and bt.face_valid[2].sum() == 2
    nv = len(meshes[0][0])
    np.testing.assert_array_equal(
        TA._vertex_adjacency(meshes[0][1].astype(np.int64), nv),
        JA._vertex_adjacency(meshes[0][1].astype(np.int64), nv))


def test_load_shapenet_bank_with_substitutes(tmp_path):
    """The 8-mesh ShapeNet layout, with the two known-missing meshes
    substituted by their donors, loads to the same bank."""
    v, f = t_sphere(3, 5)
    for i, (cls, obj) in enumerate(TA.SHAPENET_CARS):
        if obj in TA.MISSING_SUBSTITUTES:
            continue
        d = tmp_path / cls / obj / "models"
        d.mkdir(parents=True)
        TO.save_obj(str(d / "model_normalized.obj"), v * (1 + 0.1 * i), f)
    bt = TA.load_shapenet_bank(str(tmp_path))
    bj = JA.load_shapenet_bank(str(tmp_path))
    assert bt.num_meshes == 8
    np.testing.assert_array_equal(bt.vertices, bj.vertices)
    np.testing.assert_array_equal(bt.vertices[1], bt.vertices[0])
    np.testing.assert_array_equal(bt.ffd_B, bj.ffd_B)
