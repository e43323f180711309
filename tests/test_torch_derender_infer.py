"""The port's geometric serving path (sdn3d_tpu_torch.pipelines /
cli.geometric_main) against the JAX package's, on the CPU, at the small
shapes of tests/test_derender_infer.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.pipelines import derender_infer as JI
from sdn3d_tpu.pipelines import edit as JE
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank as t_build_bank
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.pipelines import derender_infer as TI
from sdn3d_tpu_torch.pipelines import edit as TE
from sdn3d_tpu_torch.utils.port import derenderer_state_dict_from_jax

MESHES = [make_sphere_mesh(4, 8)] * 2


@pytest.fixture(scope="module")
def setup():
    model = JD.Derenderer(num_classes=2)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = TD.Derenderer(num_classes=2)
    tmodel.load_state_dict(derenderer_state_dict_from_jax(variables))
    j_bank = JD.DeviceMeshBank.from_host(build_mesh_bank(MESHES))
    t_bank = TD.DeviceMeshBank.from_host(t_build_bank(MESHES), device="cpu")
    j_cfg = JI.DerenderInferConfig(image_size=64, render_size=64,
                                   max_objects=4)
    t_cfg = TI.DerenderInferConfig(image_size=64, render_size=64,
                                   max_objects=4)
    return (model, variables, j_bank, j_cfg), (tmodel.eval(), t_bank, t_cfg)


def fake_scene(h=96, w=160, n=2):
    rng = np.random.RandomState(0)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)[:n]
    masks = np.zeros((n, 1, h, w), np.float32)
    for i, r in enumerate(rois):
        masks[i, 0, int(r[0]) + 5:int(r[2]) - 5, int(r[1]) + 5:int(r[3]) - 5] = 1
    class_ids = np.asarray([1, 2][:n])
    return image, rois, masks, class_ids


def edit_ops(rois):
    """tests/test_derender_infer.py:55-70: delete object 0, modify 1."""
    return [{"type": "delete",
             "from": {"u": str((rois[0, 1] + rois[0, 3]) / 2),
                      "v": str((rois[0, 0] + rois[0, 2]) / 2)}},
            {"type": "modify",
             "from": {"u": str((rois[1, 1] + rois[1, 3]) / 2),
                      "v": str((rois[1, 0] + rois[1, 2]) / 2)},
             "to": {}, "zoom": "1.5", "ry": "0.3"}]


@pytest.mark.parametrize("method", ["matmul", "loop"])
def test_composite_objects(method):
    """composite_objects on the same per-object renders; normal/depth to
    atol 1e-5 where the instance maps agree.

    method="matmul": instance map equal.  method="loop": equal on >= 99.5%
    of pixels.  Binary masks sampled halfway between two texels give
    exactly 0.5 before round(); XLA's CPU backend computes the sample
    coordinate (y - top + 0.5) * scale - 0.5 as one FMA, the port in two
    roundings, so such a pixel may round to the other side (9 of 3840 here).
    """
    rng = np.random.RandomState(3)
    N, R = 4, 32
    masks = (rng.rand(N, 1, R, R) > 0.4).astype(np.float32)
    normals = rng.uniform(-1, 1, (N, 3, R, R)).astype(np.float32)
    depth_maps = rng.uniform(3, 20, (N, 1, R, R)).astype(np.float32)
    c2d = rng.uniform(-0.1, 0.1, (N, 2)).astype(np.float32)
    zooms = rng.uniform(0.6, 1.5, (N, 1)).astype(np.float32)
    depths = rng.uniform(5, 30, (N, 1)).astype(np.float32)
    interests = np.asarray([1, 1, 0, 1], np.uint8)
    args = (masks, normals, depth_maps, c2d, zooms, depths, interests)
    kw = dict(height=48, width=80, render_size=R, method=method,
              focal=100.0, u0=40.0, v0=24.0)
    ij, nj, dj = JE.composite_objects(*map(jnp.asarray, args), **kw)
    it, nt, dt = TE.composite_objects(*map(torch.from_numpy, args), **kw)
    same = it.numpy() == np.asarray(ij)
    assert same.all() if method == "matmul" else same.mean() >= 0.995
    assert (it.numpy() > 0).any() and not (it.numpy() == 3).any()
    np.testing.assert_allclose(nt.numpy()[:, same], np.asarray(nj)[:, same],
                               atol=1e-5)
    np.testing.assert_allclose(dt.numpy()[same], np.asarray(dj)[same],
                               atol=1e-5)


def test_composite_methods_agree():
    rng = np.random.RandomState(4)
    N, R = 3, 24
    args = [torch.from_numpy(a) for a in (
        (rng.rand(N, 1, R, R) > 0.5).astype(np.float32),
        rng.uniform(-1, 1, (N, 3, R, R)).astype(np.float32),
        rng.uniform(3, 20, (N, 1, R, R)).astype(np.float32),
        rng.uniform(-0.05, 0.05, (N, 2)).astype(np.float32),
        rng.uniform(0.8, 1.2, (N, 1)).astype(np.float32),
        rng.uniform(5, 30, (N, 1)).astype(np.float32),
        np.ones(N, np.uint8))]
    kw = dict(height=40, width=64, render_size=R, focal=100.0, u0=32.0,
              v0=20.0)
    a = TE.composite_objects(*args, **kw)
    b = TE.composite_objects(*args, method="loop", **kw)
    assert (a[0] > 0).any()
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(a[2], b[2], atol=1e-5, rtol=0)


def test_match_and_apply_operations():
    """Host-side op matching and pose rewrites are numpy copies: equal."""
    rng = np.random.RandomState(5)
    blob = {k: rng.normal(0, 0.2, (3, d)).astype(np.float32) for k, d in
            (("_theta_deltas", 2), ("_translation2ds", 2), ("_log_depths", 1),
             ("_mroi_norms", 2))}
    blob["_droi_norms"] = rng.uniform(0.1, 0.3, (3, 2)).astype(np.float32)
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)
    ops = edit_ops(rois)
    pj = JE.match_operations(blob["_mroi_norms"], ops)
    pt = TE.match_operations(blob["_mroi_norms"], ops)
    assert pj == pt
    interests = np.ones(3, np.uint8)
    bj, ij = JE.apply_operations(blob, interests, ops, pj)
    bt, it = TE.apply_operations(blob, interests, ops, pt)
    np.testing.assert_array_equal(it, ij)
    for k in bj:
        np.testing.assert_array_equal(bt[k], np.asarray(bj[k]), err_msg=k)


@pytest.mark.parametrize("with_ops", [False, True])
def test_derender_image_given_jax_blob(setup, with_ops):
    """Given JAX's encoded blob: the instance plane is byte-equal; the
    normal (uint8) and depth (uint16) planes are byte-equal but for at
    most 0.1% of values, each off by one; the per-object JSON / state
    agree to rtol 1e-6.

    Why not every byte: the two packages' float maps differ by ulps from
    the first product on (XLA's CPU backend contracts a*b+c into FMAs and
    sums the 64-term FFD product in another order: measured 71 of 126
    deformed vertex coordinates 1 ulp apart).  A quantized byte flips only
    where its float lies within that distance of a rounding boundary."""
    (jm, jv, jb, jc), (tm, tb, tc) = setup
    image, rois, masks, class_ids = fake_scene()
    ops = edit_ops(rois) if with_ops else None
    encoded = JI.derender_encode(jv, jm, jb, image, class_ids, masks, rois,
                                 jc)
    want = JI.derender_image(jv, jm, jb, image, class_ids, masks, rois, jc,
                             operations=ops, encoded=encoded)
    got = TI.derender_image(tm, tb, image, class_ids, masks, rois, tc,
                            operations=ops, encoded=encoded, device="cpu")
    for k in ("instance_png", "normal_png", "depth_png"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    np.testing.assert_array_equal(got["instance_png"], want["instance_png"])
    for k in ("normal_png", "depth_png"):
        diff = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (k, diff.sum())
    np.testing.assert_array_equal(got["instance_map"], want["instance_map"])
    assert got["json_obj"].keys() == want["json_obj"].keys()
    if with_ops:
        assert 1 not in got["json_obj"]
        assert not (got["instance_map"] == 1).any()
    for k in got["json_obj"]:
        for f in ("depth", "alpha"):
            np.testing.assert_allclose(got["json_obj"][k][f],
                                       want["json_obj"][k][f], rtol=1e-6)
    for k in ("_scales", "_rotations", "_translations", "_zooms"):
        n = got["state"]["num_objs"]
        np.testing.assert_allclose(got["state"][k][:n],
                                   want["state"][k][:n], rtol=1e-6)
    np.testing.assert_array_equal(got["state"]["_class_samples"],
                                  want["state"]["_class_samples"])
    np.testing.assert_array_equal(got["interests"], want["interests"])


@pytest.mark.parametrize("with_ops", [False, True])
def test_derender_image_end_to_end(setup, with_ops):
    """From the raw frame: the port's own crops and encoder.  Instance
    maps agree on >= 99.9% of pixels; JSON depth/alpha and state to rtol
    1e-4 (encoder sums reassociated; crops may differ by one LSB where the
    JAX side resizes through its native host library)."""
    (jm, jv, jb, jc), (tm, tb, tc) = setup
    image, rois, masks, class_ids = fake_scene()
    ops = edit_ops(rois) if with_ops else None
    want = JI.derender_image(jv, jm, jb, image, class_ids, masks, rois, jc,
                             operations=ops)
    got = TI.derender_image(tm, tb, image, class_ids, masks, rois, tc,
                            operations=ops, device="cpu")
    assert (got["instance_map"] == want["instance_map"]).mean() >= 0.999
    assert got["json_obj"].keys() == want["json_obj"].keys()
    for k in got["json_obj"]:
        for f in ("depth", "alpha"):
            np.testing.assert_allclose(got["json_obj"][k][f],
                                       want["json_obj"][k][f], rtol=1e-4)
    n = got["state"]["num_objs"]
    for k in ("_scales", "_rotations", "_translations", "_zooms"):
        np.testing.assert_allclose(got["state"][k][:n],
                                   want["state"][k][:n], rtol=1e-4,
                                   atol=1e-6)
    assert torch.isfinite(got["normal_map"]).all()
    assert 0 <= float(got["depth_map"].min()) <= float(
        got["depth_map"].max()) <= 1


def test_geometric_main_writes_contract(tmp_path):
    """cli.geometric_main --source gt --device cpu over two frames (one
    with a two-item edit JSON) writes the five-file contract per item."""
    import json
    import os

    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    v, f = make_sphere_mesh(3, 6)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True)
        save_obj(str(d / "model_normalized.obj"), v, f)
    image, rois, masks, class_ids = fake_scene()
    Image.fromarray(image).save(tmp_path / "frame.png")
    np.savez(tmp_path / "gt.npz", rois=rois, masks=masks,
             class_ids=class_ids)
    with open(tmp_path / "edit.json", "w") as fh:
        json.dump([{"world": "0001", "topic": "clone", "source": "00000",
                    "target": f"t{i}", "operations": edit_ops(rois)[i:]}
                   for i in range(2)], fh)
    common = ["--source", "gt", "--input_image", str(tmp_path / "frame.png"),
              "--input_masks", str(tmp_path / "gt.npz"),
              "--shapenet_root", str(tmp_path / "shapenet"),
              "--image_size", "32", "--render_size", "16", "--device", "cpu"]
    geometric_main.main(common + ["--output_dir", str(tmp_path / "a")])
    geometric_main.main(common + ["--output_dir", str(tmp_path / "b"),
                                  "--edit_json", str(tmp_path / "edit.json")])
    for out_dir, names in (("a", ["frame"]), ("b", ["00000", "00001"])):
        for name in names:
            for suffix in (".png", "-normal.png", "-depth.png", ".json",
                           ".pkl"):
                assert os.path.exists(tmp_path / out_dir / (name + suffix))
            inst = np.asarray(Image.open(tmp_path / out_dir / f"{name}.png"))
            assert inst.shape == image.shape[:2] and inst.max() <= 2
