"""The port's Pillow-convention uint8 resize (sdn3d_tpu_torch.ops.
pil_resize) against Pillow itself and against the JAX package's
(sdn3d_tpu.ops.pil_resize), on the CPU: byte for byte, at the shapes of
tests/test_pil_resize.py, the VKITTI serving geometry 1242x375 -> 624x192
among them."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.ops import pil_resize as JR
from sdn3d_tpu_torch.ops import pil_resize as TR

SHAPES = [
    ((375, 1242), (624, 192)),     # the VKITTI serving geometry
    ((100, 300), (50, 20)),        # strong downscale
    ((64, 64), (128, 128)),        # upscale
    ((37, 111), (23, 9)),          # awkward ratios
    ((192, 624), (624, 192)),      # width no-op, height change
    ((200, 700), (178, 200)),      # NEAREST's accumulated-position flip
]


@pytest.mark.parametrize("shape,out_wh", SHAPES)
def test_bicubic_rgb_matches_pillow_and_jax(shape, out_wh):
    h, w = shape
    ow, oh = out_wh
    img = np.random.RandomState(0).randint(0, 256, (h, w, 3), np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
    got = TR.resize_u8(torch.from_numpy(img), ow, oh, "bicubic")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.resize_u8(jnp.asarray(img), ow, oh)))


@pytest.mark.parametrize("shape,out_wh", SHAPES)
def test_nearest_l_matches_pillow_and_jax(shape, out_wh):
    h, w = shape
    ow, oh = out_wh
    img = np.random.RandomState(1).randint(0, 256, (h, w), np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.NEAREST))
    got = TR.resize_nearest_u8(torch.from_numpy(img), ow, oh).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(JR.resize_nearest_u8(jnp.asarray(img), ow, oh)))


def test_bilinear_and_coefficients_match():
    """BILINEAR at the serving geometry; the coefficient tables equal the
    JAX package's; the int32 sums cannot overflow (sum |k| * 255 < 2^31,
    the bound ops/pil_resize.py states) on a grid of size pairs up to
    1300."""
    img = np.random.RandomState(2).randint(0, 256, (375, 1242, 3), np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((624, 192), Image.BILINEAR))
    got = TR.resize_u8(torch.from_numpy(img), 624, 192, "bilinear").numpy()
    np.testing.assert_array_equal(got, ref)
    worst = 0.0
    for a in list(range(1, 1300, 61)) + [375, 1242]:
        for b in list(range(1, 1300, 67)) + [192, 624]:
            idx, ki = TR.coeffs_u8(a, b)
            jidx, jki = JR.coeffs_u8(a, b)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(ki, jki)
            worst = max(worst, float(np.abs(ki.astype(np.int64)).sum(1).max()))
        np.testing.assert_array_equal(TR.nearest_indices(a, 624),
                                      JR.nearest_indices(a, 624))
    assert worst * 255 < 2 ** 31 and worst / 2 ** TR.PRECISION_BITS <= 1.27


def test_transform_plan_matches_transform_image_and_jax():
    """apply_plan_u8 == the host transform_image (scale_width, the
    188 -> 192 rule, centre crop) for both filters, byte for byte, and the
    plans equal the JAX package's."""
    from sdn3d_tpu_torch.data.textural_data import transform_image

    rng = np.random.RandomState(3)
    for (h, w), load, fine in [((375, 1242), 624, (624, 192)),
                               ((200, 700), 624, (624, 160)),
                               ((192, 624), 624, (624, 192)),
                               ((375, 1242), 160, (128, 32))]:
        plan = TR.transform_plan((w, h), load, fine)
        assert plan is not None, (h, w)
        assert (plan.out_w, plan.out_h) == fine
        assert dataclasses.astuple(plan) == dataclasses.astuple(
            JR.transform_plan((w, h), load, fine))
        rgb = rng.randint(0, 256, (h, w, 3), np.uint8)
        host = (np.asarray(transform_image(
            Image.fromarray(rgb), load, fine, normalize=False))
            * 255.0).astype(np.uint8)
        dev = TR.apply_plan_u8(torch.from_numpy(rgb), plan).numpy()
        np.testing.assert_array_equal(dev, host)
        lbl = rng.randint(0, 17, (h, w), np.uint8)
        host_l = (np.asarray(transform_image(
            Image.fromarray(lbl), load, fine, nearest=True,
            normalize=False))[..., 0] * 255.0).astype(np.uint8)
        dev_l = TR.apply_plan_u8(torch.from_numpy(lbl), plan,
                                 nearest=True).numpy()
        np.testing.assert_array_equal(dev_l, host_l)


@pytest.mark.parametrize("src_wh,load,fine", [
    ((624, 100), 624, (624, 192)),     # shorter than the crop
    ((500, 375), 624, (700, 192)),     # narrower than the crop
    ((1242, 375), 160, (160, 96)),     # the chain tests' 160x96 shapes
])
def test_transform_plan_is_none_where_pil_pads(src_wh, load, fine):
    """Where PIL would zero-pad, no plan: the chain takes the full fetch
    and the host path, as the JAX package does."""
    assert TR.transform_plan(src_wh, load, fine) is None
    assert JR.transform_plan(src_wh, load, fine) is None
