"""The port's host data layer (sdn3d_tpu_torch.data.vkitti) against the
JAX package's, and the import isolation of the whole port."""

import json
import subprocess
import sys

import numpy as np
import pytest

from sdn3d_tpu.data import native
from sdn3d_tpu.data import vkitti as JV
from sdn3d_tpu_torch.data import vkitti as TV

ROIS = [(20, 30, 60, 80), (40, 90, 85, 150), (-10, -20, 30, 40),
        (80, 140, 120, 190)]


def _frame():
    return (np.random.RandomState(0).rand(96, 160, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("size", [64, 256])
def test_transform_rgb_u8(size):
    """uint8 crops.  The port resizes through PIL; the JAX package through
    its native host library when built (data/native.py:83-101), whose
    float crops match PIL only to 1e-5 (tests/test_native.py:48).  So a
    byte may differ by one where the float crop sits within 1e-5 of a
    rounding boundary: at most 0.1% of bytes, each by at most 1.  Without
    the native library both sides take the PIL path and are equal."""
    image = _frame()
    for roi in ROIS:
        got = TV.transform_rgb_u8(image, roi, size)
        want = JV.transform_rgb_u8(image, roi, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        if native.available():
            assert (diff > 0).mean() <= 1e-3
        else:
            assert diff.max() == 0
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
    """Importing every module of sdn3d_tpu_torch (in a fresh interpreter)
    pulls in neither jax/flax/optax nor sdn3d_tpu."""
    code = """
import importlib, pkgutil, sys
import sdn3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sdn3d_tpu_torch.__path__,
                                               "sdn3d_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "sdn3d_tpu"))
print(len(names), bad)
assert len(names) >= 20 and not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
