"""The port's Mask R-CNN training data (sdn3d_tpu_torch.data.detect_data)
against the JAX package's (sdn3d_tpu/data/detect_data.py) on the CPU, at
the JAX tests' small configuration (tests/test_detect_data.py:23): the
same numpy inputs and the same global numpy seed through both, every
output byte-equal, the numpy draws consumed call for call."""

import json
import os
import sys

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data import detect_data as JD
from sdn3d_tpu.models.maskrcnn import MaskRCNNConfig as JConfig
from sdn3d_tpu_torch.data import detect_data as TD
from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig as TConfig
from sdn3d_tpu_torch.models.maskrcnn import generate_pyramid_anchors

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

SMALL = dict(image_min_dim=128, image_max_dim=128, num_classes=3,
             stage_sizes=(1, 1, 1, 1), fpn_channels=32, pre_nms_limit=100,
             post_nms_rois_training=40, train_rois_per_image=12,
             mask_shape=(14, 14), mask_pool_size=7,
             rpn_train_anchors_per_image=32)
JCFG, TCFG = JConfig(**SMALL), TConfig(**SMALL)
ANCHORS = generate_pyramid_anchors(TCFG)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _both(fn_t, fn_j, seed=3):
    """fn_t() and fn_j() from the same global numpy state; the draws they
    consume must be the same too."""
    np.random.seed(seed)
    want = fn_j()
    after = np.random.rand()
    np.random.seed(seed)
    got = fn_t()
    assert np.random.rand() == after
    return got, want


@pytest.mark.parametrize("case", ["blobs", "half-plane", "empty box"])
def test_minimize_mask_byte_equal(case):
    """minimize_mask (PIL bilinear resize, threshold at >= 128) byte-equal
    to JAX's."""
    rs = np.random.RandomState(1)
    m = np.zeros((90, 120), np.float32)
    box = [10, 15, 70, 101]
    if case == "blobs":
        for _ in range(6):
            y, x = rs.randint(0, 80, 2)
            m[y:y + rs.randint(3, 25), x:x + rs.randint(3, 40)] = 1.0
    elif case == "half-plane":
        yy, xx = np.mgrid[:90, :120]
        m[yy + xx < 100] = 1.0
    else:
        box = [40, 40, 40, 60]
    for shape in ((56, 56), (28, 14)):
        want = JD.minimize_mask(m, box, shape)
        got = TD.minimize_mask(m, box, shape)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _instances(rs, n, hw):
    H, W = hw
    masks, ids = [], []
    for _ in range(n):
        y, x = rs.randint(0, H - 20), rs.randint(0, W - 20)
        m = np.zeros((H, W), np.float32)
        m[y:y + rs.randint(8, H - y), x:x + rs.randint(8, W - x)] = 1.0
        masks.append(m)
        ids.append(rs.randint(1, 3))
    masks.append(np.zeros((H, W), np.float32))      # an empty instance
    ids.append(1)
    return np.asarray(ids, np.int32), np.stack(masks)


@pytest.mark.parametrize("hw,n,max_gt,own_rng", [
    ((64, 128), 3, 4, False),      # padded, no subsample
    ((100, 300), 7, 4, False),     # resized, max_gt subsample (global)
    ((128, 128), 5, 2, True),      # subsample from a given RandomState
])
def test_mold_gt_example_byte_equal(hw, n, max_gt, own_rng):
    """mold_gt_example under the same global seed: the molded image, the
    RPN targets (from the FULL GT set, before the max_gt subsample), the
    padded head arrays byte-equal to JAX's."""
    rs = np.random.RandomState(n)
    image = (rs.rand(*hw, 3) * 255).astype(np.uint8)
    ids, masks = _instances(rs, n, hw)

    def run(pkg, cfg):
        rng = np.random.RandomState(9) if own_rng else None
        return pkg.mold_gt_example(image, ids, masks, cfg, ANCHORS,
                                   mini_shape=(28, 28), max_gt=max_gt,
                                   rng=rng)
    got, want = _both(lambda: run(TD, TCFG), lambda: run(JD, JCFG))
    _same(got, want)
    assert (want["gt_class_ids"] > 0).sum() == min(n, max_gt)
    assert (want["rpn_match"] == 1).sum() >= 1


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_detect_example_byte_equal(seed):
    """synthetic_detect_example(seed) under the same global seed."""
    got, want = _both(
        lambda: TD.synthetic_detect_example(TCFG, ANCHORS, seed=seed),
        lambda: JD.synthetic_detect_example(JCFG, ANCHORS, seed=seed))
    _same(got, want)
    assert want["gt_masks"].shape == (TCFG.max_gt_instances, 56, 56)


def test_vkitti_detect_dataset_byte_equal(tmp_path):
    """VKittiDetectDataset on the VKITTI fixture (scripts/
    make_vkitti_fixture.py, the JAX test's): the same frames, each item
    byte-equal to JAX's under the same global seed."""
    from make_vkitti_fixture import build_fixture

    root = str(tmp_path / "vk")
    os.makedirs(root)
    # a car per modify / delete operation, on the source frame
    ops = [{"type": "modify", "from": {"u": "750.9", "v": "213.9"},
            "to": {"u": "804.4", "v": "227.1", "roi": [194, 756, 269, 865]},
            "zoom": "1.338", "ry": "0.007"},
           {"type": "delete", "from": {"u": "300.0", "v": "200.0"},
            "to": None, "zoom": None, "ry": None}]
    items = [{"world": "0006", "topic": "fog", "source": "00055",
              "target": "00050", "operations": ops},
             {"world": "0001", "topic": "clone", "source": "00035",
              "target": "00040", "operations": ops[1:]}]
    ej = os.path.join(root, "edit.json")
    with open(ej, "w") as f:
        json.dump(items, f)
    build_fixture(root, ej)
    want_ds = JD.VKittiDetectDataset(root, JCFG, ANCHORS, split="test")
    got_ds = TD.VKittiDetectDataset(root, TCFG, ANCHORS, split="test")
    assert got_ds.frames == want_ds.frames and len(got_ds) >= 2
    for i in range(len(got_ds)):
        got, want = _both(lambda: got_ds[i], lambda: want_ds[i], seed=i)
        _same(got, want)
    assert any((got_ds[i]["gt_class_ids"] > 0).any()
               for i in range(len(got_ds)))


def _cityscapes_root(root):
    """leftImg8bit / gtFine instanceIds of two cities, three frames: cars
    (26000 + k), a car of 40 px (dropped, <= 50), a person, and a frame
    without cars."""
    from PIL import Image

    rs = np.random.RandomState(4)
    frames = [("aachen", "000000_000019", [(20, 30, 60, 90), (70, 100, 76,
                                                               106)]),
              ("aachen", "000001_000019", []),
              ("bremen", "000002_000019", [(5, 5, 50, 40), (40, 60, 90,
                                                           120)])]
    for city, stem, cars in frames:
        img_dir = os.path.join(root, "leftImg8bit", "train", city)
        gt_dir = os.path.join(root, "gtFine", "train", city)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        inst = np.zeros((96, 160), np.int32)
        inst[80:95, 130:150] = 24000                # a person
        for k, (y1, x1, y2, x2) in enumerate(cars):
            inst[y1:y2, x1:x2] = 26000 + k
        Image.fromarray((rs.rand(96, 160, 3) * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{city}_{stem}_leftImg8bit.png"))
        Image.fromarray(inst.astype(np.uint16)).save(
            os.path.join(gt_dir, f"{city}_{stem}_gtFine_instanceIds.png"))


def test_cityscapes_detect_dataset_byte_equal(tmp_path):
    """CityscapesDetectDataset (cars only, area > 50 px, class 1) on a
    small Cityscapes layout: the same items, each byte-equal to JAX's
    under the same global seed (a frame without cars included)."""
    root = str(tmp_path / "cs")
    _cityscapes_root(root)
    cfg_kw = dict(SMALL, num_classes=2)
    want_ds = JD.CityscapesDetectDataset(root, JConfig(**cfg_kw), ANCHORS)
    got_ds = TD.CityscapesDetectDataset(root, TConfig(**cfg_kw), ANCHORS)
    assert got_ds.items == want_ds.items and len(got_ds) == 3
    counts = []
    for i in range(len(got_ds)):
        got, want = _both(lambda: got_ds[i], lambda: want_ds[i], seed=i)
        _same(got, want)
        counts.append(int((got["gt_class_ids"] > 0).sum()))
    assert counts == [1, 0, 2]
