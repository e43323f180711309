"""The port's host data layer (sdn3d_tpu_torch.data: vkitti, native,
vkitti_derender) against the JAX package's, and the import isolation of
the whole port."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sdn3d_tpu.data import native
from sdn3d_tpu.data import vkitti as JV
from sdn3d_tpu_torch.data import native as TN
from sdn3d_tpu_torch.data import vkitti as TV

ROIS = [(20, 30, 60, 80), (40, 90, 85, 150), (-10, -20, 30, 40),
        (80, 140, 120, 190)]


@pytest.fixture(autouse=True, scope="module")
def same_crop_path():
    """The port crops through the path the JAX package takes in this
    process.  Each package builds the native library at first use (the
    port into its _build/, JAX by `make` into native/); a JAX worker that
    loads native/libsdn3d_host.so while another worker's make is writing
    it keeps its numpy path for the rest of the process, and the port
    then takes its numpy path too."""
    saved = dict(TN._state)
    if not native.available():
        TN._state.update(tried=True, lib=None)
    yield
    TN._state.update(saved)


def _frame():
    return (np.random.RandomState(0).rand(96, 160, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("size", [64, 256])
def test_transform_rgb_u8(size):
    """uint8 and float crops.  Both packages crop through the native host
    library (the same source and flags) where it is built, through PIL
    otherwise: equal bytes and floats either way."""
    image = _frame()
    assert TN.available() == native.available()
    for roi in ROIS:
        got = TV.transform_rgb_u8(image, roi, size)
        want = JV.transform_rgb_u8(image, roi, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TV.transform_rgb(image, roi, size, mean=(0.4, 0.5, 0.6),
                             std=(0.2, 0.3, 0.25)),
            JV.transform_rgb(image, roi, size, mean=(0.4, 0.5, 0.6),
                             std=(0.2, 0.3, 0.25)))
    # prescaled float input gives the same bytes
    np.testing.assert_array_equal(
        TV.transform_rgb_u8(np.asarray(image, np.float32) / 255.0, ROIS[0],
                            size, prescaled=True),
        TV.transform_rgb_u8(image, ROIS[0], size))


def test_crops_masks_rois_and_camera():
    image = _frame()
    mask = (np.random.RandomState(1).rand(96, 160) > 0.5).astype(np.float32)
    for roi in ROIS:
        np.testing.assert_array_equal(TV.crop_square(image, roi, 7),
                                      JV.crop_square(image, roi, 7))
        np.testing.assert_array_equal(TV.transform_mask(mask, roi, 48),
                                      JV.transform_mask(mask, roi, 48))
    np.testing.assert_array_equal(TV.resize_bilinear_np(image, 33),
                                  JV.resize_bilinear_np(image, 33))
    rois = np.asarray(ROIS, np.float32)
    np.testing.assert_array_equal(TV.roi_norms_from_rois(rois),
                                  JV.roi_norms_from_rois(rois))
    for k in ("width", "height", "focal", "u0", "v0"):
        assert getattr(TV.Camera, k) == getattr(JV.Camera, k)


def test_load_edit_json(tmp_path):
    items = [{"world": "0001", "topic": "clone", "source": "00005",
              "target": "00007", "operations": [{"type": "delete"}]},
             {"world": "0020", "topic": "fog", "source": "00001",
              "target": "00002"}]
    p = tmp_path / "e.json"
    p.write_text(json.dumps(items))
    got, want = TV.load_edit_json(str(p)), JV.load_edit_json(str(p))
    assert [(i.source_name, i.target_name, i.operations) for i in got] == \
        [(i.source_name, i.target_name, i.operations) for i in want]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of sdn3d_tpu_torch (in a fresh interpreter),
    the semantic and textural branches, the chain and the file-contract
    CLIs among them, pulls in neither jax/flax/optax/orbax, pandas nor
    sdn3d_tpu."""
    code = """
import importlib, pkgutil, sys
import sdn3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sdn3d_tpu_torch.__path__,
                                               "sdn3d_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "pandas", "sdn3d_tpu"))
need = {"sdn3d_tpu_torch." + n for n in (
    "models.semantic", "models.pix2pixhd", "data.semantic_data",
    "data.textural_data", "pipelines.semantic", "pipelines.textural",
    "pipelines.chain", "cli.semantic_test", "cli.edit_vkitti",
    "cli.edit_chain", "utils.visualizer", "utils.metrics", "ops.pil_resize",
    "models.layers", "models.lpips", "utils.transfer", "core.checkpoint",
    "data.native", "data.vkitti_derender", "cli.edit_benchmark",
    "cli.textural_test")}
print(len(names), bad, sorted(need - set(names)))
assert len(names) >= 30 and need <= set(names) and not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_split_lists_match_jax():
    assert TV.SPLIT_RANGES == JV.SPLIT_RANGES
    for opt in ("train", "test", "all"):
        assert TV.get_lists(opt) == JV.get_lists(opt)


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    y, x = rng.randint(-20, 80, (2, n))
    return np.stack([y, x, y + rng.randint(1, 60, n),
                     x + rng.randint(1, 90, n)], 1).astype(np.float32)


def test_native_bindings_match_jax(monkeypatch):
    """The port's ctypes bindings (its own build of native/sdn3d_host.cpp
    into sdn3d_tpu_torch/_build) against the JAX package's on the same
    inputs: scenegt_decode, crop_square_resize and nms_cpu bit-equal; then
    the numpy paths (a machine without g++) of both packages: equal."""
    rng = np.random.RandomState(4)
    img = rng.randint(0, 4, (40, 70, 3)).astype(np.uint8) * 60
    codes = np.unique((img[..., 0].astype(np.uint32) << 16)
                      | (img[..., 1].astype(np.uint32) << 8) | img[..., 2])
    keys = np.sort(rng.choice(codes, len(codes) // 2, replace=False)
                   ).astype(np.uint32)
    vals = rng.randint(0, 90000, len(keys)).astype(np.int32)
    frame = rng.rand(50, 90, 3).astype(np.float32)
    crops = [(roi, size, fill, mean, std)
             for roi in ROIS + [(5, 5, 6, 80)]
             for size, fill in ((24, 0.5), (64, 0.0))
             for mean, std in (((0.5,) * 3, (0.25,) * 3),
                               ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))]
    boxes = _boxes(60, 5)

    def run(mod, np_path):
        if np_path:
            out = [mod.scenegt_decode_np(img, keys, vals)]
            out += [mod.crop_square_resize_np(frame, *c) for c in crops]
        else:
            out = [mod.scenegt_decode(img, keys, vals)]
            out += [mod.crop_square_resize(frame, *c) for c in crops]
        return out + [mod.nms_cpu(boxes, 0.3), mod.nms_cpu(boxes, 0.7)]

    def jax_np_path(*args):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        return None

    if TN.available():               # and so native's (same_crop_path)
        for got, want in zip(run(TN, False), run(native, False)):
            np.testing.assert_array_equal(got, want)
    monkeypatch.setitem(TN._state, "tried", True)
    monkeypatch.setitem(TN._state, "lib", None)
    jax_np_path()
    want = [native.scenegt_decode(img, keys, vals)]
    want += [native.crop_square_resize(frame, *c) for c in crops]
    want += [native.nms_cpu(boxes, 0.3), native.nms_cpu(boxes, 0.7)]
    assert not TN.available()
    for got, w in zip(run(TN, True), want):
        np.testing.assert_array_equal(got, w)
    for got, w in zip(run(TN, False), want):
        np.testing.assert_array_equal(got, w)


# a hand-written motgt table: frames out of order, one frame of the train
# range, and columns whose type depends on the other table (truncr is
# integer-valued here and float in write_vkitti_root's)
_TABLE = """frame tid label truncated occluded alpha l t r b w3d h3d l3d x3d y3d z3d ry rx rz truncr occupr orig_label moving model color
40 3 Car 0 0 -1.5 10 20 60 50 1.8 1.5 4.2 1.0 1.6 12.5 0.3 0 0 0 0.9 Car True SUV Red
12 1 Van 0 1 -1.2 30 25 95 70 2.0 2.1 5.0 -2.0 1.6 20.0 -0.4 0 0 1 0.4 Van False Van Blue
40 1 Van 0 1 -1.2 30 25 95 70 2.0 2.1 5.0 -2.0 1.6 20.0 -0.4 0 0 0 0.5 Van False Van Blue

150 2 Car 0 0 0.1 5 5 9 9 1.8 1.5 4.2 3.0 1.6 40.0 0.2 0 0 0 0.1 Car True Sedan Red
"""


@pytest.fixture(scope="module")
def motgt_root(tmp_path_factory):
    """A root of data/synthetic.write_vkitti_root (frames of world 0001,
    with motgt) plus the table above for 0002/fog (train range only)."""
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root

    root = str(tmp_path_factory.mktemp("motgt"))
    frames = {("0001", "clone", "00400"): [(180, 300, 260, 440),
                                           (200, 700, 300, 900),
                                           (190, 380, 250, 480)],
              ("0001", "clone", "00360"): [(150, 20, 200, 90),
                                           (160, 60, 230, 190)],
              ("0001", "clone", "00361"): [],
              ("0001", "fog", "00100"): [(170, 500, 240, 620)]}
    write_vkitti_root(root, frames, seed=2, height=300, width=1000)
    with open(os.path.join(root, "vkitti_1.3.1_motgt", "0002_fog.txt"),
              "w") as fh:
        fh.write(_TABLE)
    return root, frames


def test_motgt_tables_match_pandas(motgt_root):
    """VKittiMotgt without pandas against the JAX package's (pandas):
    frames(split) in the same order, objects() with the same keys, values
    and Python types, the written boxes and tracks back."""
    from sdn3d_tpu.data.vkitti_derender import VKittiMotgt as JM
    from sdn3d_tpu_torch.data.vkitti_derender import VKittiMotgt as TM

    root, frames = motgt_root
    got, want = TM(root), JM(root)
    for split in ("train", "test", "all"):
        assert got.frames(split) == want.frames(split), split
    assert got.frames("test") == [("0001", "clone", 360),
                                  ("0001", "clone", 400)]
    assert got.frames("train") == [("0001", "fog", 100), ("0002", "fog", 40),
                                   ("0002", "fog", 12), ("0002", "fog", 150)]
    for world, topic, frame in got.frames("train") + got.frames("test"):
        a, b = got.objects(world, topic, frame), want.objects(world, topic,
                                                              frame)
        assert [{k: (type(v), v) for k, v in r.items()} for r in a] == \
            [{k: (type(v), v) for k, v in r.items()} for r in b]
    rows = got.objects("0001", "clone", 400)
    assert [r["tid"] for r in rows] == [2, 3, 4]
    assert [(r["t"], r["l"], r["b"], r["r"]) for r in rows] == \
        frames[("0001", "clone", "00400")]
    with pytest.raises(KeyError):
        got.objects("0001", "clone", 361)


def test_derender_dataset_items_match_jax(motgt_root):
    """VKittiDerenderDataset(is_train=False) over the test split: the same
    items, each item's targets, crops, masks and occlusion ignores equal
    to the JAX package's."""
    from sdn3d_tpu.data import vkitti_derender as JD
    from sdn3d_tpu_torch.data import vkitti_derender as TD

    root, _ = motgt_root
    for evaluate in (False, True):
        got = TD.VKittiDerenderDataset(root, is_train=False,
                                       is_evaluate=evaluate, image_size=64,
                                       render_size=48)
        want = JD.VKittiDerenderDataset(root, is_train=False,
                                        is_evaluate=evaluate, image_size=64,
                                        render_size=48)
        assert [i[:3] for i in got.items] == [i[:3] for i in want.items]
        assert len(got) == 5
        for k in range(len(got)):
            a, b = got[k], want[k]
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert evaluate or a["ignores"].shape == (1, 48, 48)
    for name in ("training_row_filter", "object_depth_sq"):
        for row in TD.VKittiMotgt(root).objects("0001", "clone", 400):
            assert getattr(TD, name)(row) == getattr(JD, name)(row)
