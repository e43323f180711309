"""The port's derenderer (sdn3d_tpu_torch.models / utils.port) against
the JAX package's: weight conversion, encoder outputs and render_blob."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.utils.port import port_derenderer
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank as t_build_bank
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.utils.port import derenderer_state_dict_from_jax

NUM_CLASSES = 2
ISZ = 64


@pytest.fixture(scope="module")
def variables():
    """Random flax variables with non-trivial BatchNorm statistics (numpy)."""
    model = JD.Derenderer(num_classes=NUM_CLASSES)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, ISZ, ISZ, 3)),
                   jnp.zeros((1, 2)), jnp.zeros((1, 2)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    rng = np.random.RandomState(0)

    def perturb(tree):
        for k, a in tree.items():
            if isinstance(a, dict):
                perturb(a)
            elif k in ("var", "scale"):
                tree[k] = (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
            elif k in ("mean", "bias"):
                tree[k] = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    perturb(v["batch_stats"])
    perturb(v["params"])
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _torch_model(variables):
    m = TD.Derenderer(num_classes=NUM_CLASSES)
    m.load_state_dict(derenderer_state_dict_from_jax(variables), strict=True)
    return m.eval()


def test_state_dict_round_trip(variables):
    """derenderer_state_dict_from_jax is the exact inverse of
    sdn3d_tpu.utils.port.port_derenderer: the round trip gives back the
    same arrays, and every key of the port's module is covered."""
    sd = derenderer_state_dict_from_jax(variables)
    assert set(sd) == set(TD.Derenderer(num_classes=NUM_CLASSES).state_dict())
    back = port_derenderer(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a,
                                      err_msg=str(path))


def _inputs(seed=1, n=3):
    rng = np.random.RandomState(seed)
    images = rng.normal(0, 1, (n, ISZ, ISZ, 3)).astype(np.float32)
    roi = np.sort(rng.uniform(-0.4, 0.4, (n, 2, 2)), axis=1)
    roi_norms = np.concatenate([roi[:, 0], roi[:, 1]], 1).astype(np.float32)
    mroi = np.stack([roi_norms[:, 2] + roi_norms[:, 0],
                     roi_norms[:, 3] + roi_norms[:, 1]], 1) / np.float32(2)
    droi = np.stack([roi_norms[:, 2] - roi_norms[:, 0],
                     roi_norms[:, 3] - roi_norms[:, 1]], 1)
    return images, roi_norms, mroi.astype(np.float32), droi.astype(np.float32)


def test_encoder_matches_jax(variables):
    """Encoder heads on NHWC input.  Tolerance rtol 1e-4 / atol 1e-5: the
    convolution sums are reassociated (XLA vs oneDNN/ATen tiling)."""
    images, _, mroi, droi = _inputs()
    want = JD.Derenderer(num_classes=NUM_CLASSES).apply(
        variables, jnp.asarray(images), jnp.asarray(mroi), jnp.asarray(droi),
        train=False)
    with torch.no_grad():
        got = _torch_model(variables)(torch.from_numpy(images),
                                      torch.from_numpy(mroi),
                                      torch.from_numpy(droi))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_render_blob_matches_jax(variables):
    """render_blob (inference branch) on the SAME blob: JAX's encoder
    outputs handed to both packages as numpy, 4 slots with one padded.

    Tolerances: poses rtol 1e-5 (a few ulps through exp/sqrt/atan2 and
    the zoom solve); silhouettes agree on all but 0.5% of pixels and
    depth/normal maps to atol 1e-3 where the silhouettes agree.  The
    projected vertices differ from JAX by ulps (XLA contracts FMAs in the
    FFD product and the perspective shear), which can move an edge across
    a pixel centre at 128^2 rasterization."""
    images, roi_norms, mroi, droi = _inputs(seed=2, n=4)
    enc = JD.Derenderer(num_classes=NUM_CLASSES).apply(
        variables, jnp.asarray(images), jnp.asarray(mroi), jnp.asarray(droi),
        train=False)
    blob = {k: np.asarray(v) for k, v in enc.items()}
    blob.update(_roi_norms=roi_norms, _mroi_norms=mroi, _droi_norms=droi,
                _focals=np.full((4, 1), 725.0, np.float32))
    valid = np.asarray([True, True, True, False])
    meshes = [make_sphere_mesh(4, 8), make_sphere_mesh(5, 7)]
    j_bank = JD.DeviceMeshBank.from_host(build_mesh_bank(meshes))
    t_bank = TD.DeviceMeshBank.from_host(t_build_bank(meshes), device="cpu")
    want = JD.render_blob({k: jnp.asarray(v) for k, v in blob.items()},
                          j_bank, JD.TargetType.extend, image_size=ISZ,
                          render_size=ISZ, obj_valid=jnp.asarray(valid))
    got = TD.render_blob({k: torch.from_numpy(v.copy()) for k, v in blob.items()},
                         t_bank, TD.TargetType.extend, image_size=ISZ,
                         render_size=ISZ, obj_valid=torch.from_numpy(valid))
    for k in ("_thetas", "_rotations", "_scales", "_depths", "_center2ds",
              "_translations", "_alphas", "_zooms", "_class_log_probs"):
        w, g = np.asarray(want[k])[:3], got[k].numpy()[:3]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["_class_samples"].numpy(),
                                  np.asarray(want["_class_samples"]))
    m_t, m_j = got["_masks"].numpy(), np.asarray(want["_masks"])
    assert m_t.shape == m_j.shape == (4, 1, ISZ, ISZ)
    assert (m_t[:3] > 0).any() and (m_t[3] == 0).all()
    same = m_t == m_j
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_allclose(got["_depth_maps"].numpy()[same],
                               np.asarray(want["_depth_maps"])[same],
                               atol=1e-3)
    same3 = np.repeat(same, 3, axis=1)
    np.testing.assert_allclose(got["_normals"].numpy()[same3],
                               np.asarray(want["_normals"])[same3], atol=1e-3)


def test_geometric_main_loads_converted_state_dict(tmp_path):
    """--ckpt_dir: a state_dict file written from the JAX derenderer's
    variables (8 classes, the CLI's width) loads into the CLI's model
    unchanged, in eval mode, on the requested device."""
    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    v = JD.Derenderer(num_classes=8).init(
        jax.random.PRNGKey(1), jnp.zeros((1, ISZ, ISZ, 3)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), train=False)
    sd = derenderer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v))
    torch.save(sd, tmp_path / "derenderer.pt")
    verts, faces = make_sphere_mesh(3, 6)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True)
        save_obj(str(d / "model_normalized.obj"), verts, faces)
    args = geometric_main.build_argparser().parse_args([
        "--source", "gt", "--device", "cpu",
        "--ckpt_dir", str(tmp_path / "derenderer.pt"),
        "--shapenet_root", str(tmp_path / "shapenet")])
    model, bank = geometric_main.load_derenderer(args)
    assert not model.training and bank.vertices.shape[0] == 8
    got = model.state_dict()
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
