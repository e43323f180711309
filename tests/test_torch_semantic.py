"""The port's semantic branch (sdn3d_tpu_torch.models.semantic,
pipelines.semantic, cli.semantic_test) against the JAX package's, on the
CPU: the same numpy inputs and the same weights (JAX's random init,
converted with utils/port.semantic_state_dicts_from_jax) through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data.semantic_data import MEAN_BGR, STD_BGR
from sdn3d_tpu.models import semantic as JS
from sdn3d_tpu.pipelines import semantic as JP
from sdn3d_tpu.utils.port import port_semantic
from sdn3d_tpu_torch.models import semantic as TS
from sdn3d_tpu_torch.pipelines import semantic as TP
from sdn3d_tpu_torch.utils.port import semantic_state_dicts_from_jax

# Softmax probabilities: the two packages sum the ResNet-50's products in
# different orders, so the logits agree to float32 rounding.  On a
# unit-scale input the probabilities then agree to 2e-6.  The raw-frame
# pass normalises with stds in 0..1 scale (inputs up to ~670), its logits
# reach hundreds and the softmax saturates, so a probability moves by up
# to ~6e-5 there (measured 2.9e-5 .. 5.7e-5); its tolerance is 1e-4.
PROB_ATOL = 2e-6
PROB_ATOL_RAW = 1e-4


@pytest.fixture(scope="module")
def models():
    """JAX SemanticModel at full width (num_class 14, resnet50 dilated8,
    ppm_bilinear_deepsup), its variables, and the port's model with the
    converted weights."""
    jm = JS.SemanticModel(num_class=14)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = TS.SemanticModel(num_class=14)
    enc, dec = semantic_state_dicts_from_jax(variables)
    tm.encoder.load_state_dict(enc)
    tm.decoder.load_state_dict(dec)
    return jm, variables, tm.eval()


def _jax_resize(x, hw):
    return np.asarray(jax.image.resize(
        jnp.asarray(x), (x.shape[0], hw[0], hw[1], x.shape[3]),
        method="bilinear"))


# every scale size of a 375x1242 frame (shrinks, and the slight
# enlargement 376x1248), the PPM's 1/2/3/6 -> stride-8 enlargements, and
# a mixed case (rows shrink, columns grow)
RESIZE_CASES = ([((1, 375, 1242, 3), hw) for hw in TP.scale_sizes(375, 1242)]
                + [((1, s, s, 4), hw) for s in (1, 2, 3, 6)
                   for hw in ((13, 41), (47, 156))]
                + [((2, 40, 30, 3), (17, 77))])


@pytest.mark.parametrize("shape,hw", RESIZE_CASES)
def test_resize_bilinear_matches_jax_image_resize(shape, hw):
    """The port's resize_bilinear against jax.image.resize(method=
    "bilinear") on the same input: within 1e-6 of the input's largest
    magnitude (the weights are JAX's own, as XLA compiles them; the
    products sum in another order)."""
    x = np.random.RandomState(sum(shape) + sum(hw)).rand(*shape).astype(
        np.float32) * 255
    want = _jax_resize(x, hw)
    got = TS.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                             hw).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(x).max()))


def test_scale_sizes_match_jax():
    """The per-scale sizes, as JAX's multiscale_labels_device computes
    them (short edge to the scale, long-edge cap, both rounded up to x8)."""
    from sdn3d_tpu.data.semantic_data import (IMG_MAX_SIZE_EVAL,
                                              round2nearest_multiple)

    for (H, W), scales in (((375, 1242), JP.EVAL_SCALES),
                           ((64, 96), (64, 100)), ((1300, 900), (375,))):
        want = []
        for s in scales:
            f = min(s / min(H, W), IMG_MAX_SIZE_EVAL / max(H, W))
            want.append((round2nearest_multiple(int(H * f), 8),
                         round2nearest_multiple(int(W * f), 8)))
        assert TP.scale_sizes(H, W, scales) == want
    assert TP.scale_sizes(375, 1242) == [(104, 336), (152, 496), (200, 664),
                                         (304, 1000), (376, 1248)]


@pytest.mark.parametrize("scale", [1, 2, 3, 6])
def test_adaptive_avg_pool2d_matches_jax(scale):
    x = np.random.RandomState(scale).randn(2, 13, 41, 5).astype(np.float32)
    want = np.asarray(JS.adaptive_avg_pool2d(jnp.asarray(x), (scale, scale)))
    got = TS.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 (scale, scale)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_semantic_model_probs_match_jax(models):
    """SemanticModel at full width on a 64x96 image, seg_size 64x96: the
    softmax probabilities within PROB_ATOL."""
    jm, variables, tm = models
    x = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), seg_size=(64, 96),
                               train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 seg_size=(64, 96)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_multiscale_labels_match_jax(models):
    """One-pass multi-scale labels over two scales of a raw uint8 64x96
    frame: the averaged probabilities within PROB_ATOL_RAW of JAX's; the
    uint8 labels equal wherever JAX's top two classes are further apart
    than PROB_ATOL_RAW.  Where they are closer, ulp differences may flip
    the argmax; such flips are counted and printed (0 of 6144 pixels
    here) and must stay below 1% of pixels."""
    jm, variables, tm = models
    scales = (64, 100)
    img = (np.random.RandomState(1).rand(64, 96, 3) * 255).astype(np.uint8)
    norm = (img.astype(np.float32)[:, :, ::-1]
            - np.asarray(MEAN_BGR, np.float32)) / np.asarray(STD_BGR,
                                                             np.float32)
    want_p = np.asarray(JP.multiscale_probs_device(variables, jm, norm,
                                                   scales))
    want_l = JP.multiscale_labels_fused(variables, jm, img, scales)
    got_p = TP.multiscale_probs_device(tm, img, scales, device="cpu")
    got_l = TP.multiscale_labels_fused(tm, img, scales, device="cpu")
    got_p = got_p.permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROB_ATOL_RAW)
    assert got_l.dtype == np.uint8 and got_l.shape == (64, 96)
    assert got_l.max() < 14
    top2 = np.sort(want_p, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= PROB_ATOL_RAW
    flips = got_l != want_l
    print(f"label flips {int(flips.sum())} of {flips.size} pixels, "
          f"near-ties {int(near_tie.sum())}")
    assert not (flips & ~near_tie).any()
    assert flips.mean() < 0.01


def test_semantic_converter_round_trip(models):
    """semantic_state_dicts_from_jax fed back through JAX's port_semantic
    gives back the original flax tree exactly: the key layout is the
    reference's."""
    _, variables, _ = models
    enc, dec = semantic_state_dicts_from_jax(variables)
    back = port_semantic(enc, dec)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_semantic_cli_writes_labels(tmp_path, models):
    """cli.semantic_test --device cpu, single-image and benchmark modes:
    the label PNGs hold the multi-scale labels of the loaded weights."""
    import json

    from PIL import Image

    from sdn3d_tpu_torch.cli import semantic_test

    _, variables, tm = models
    enc, dec = semantic_state_dicts_from_jax(variables)
    ckpt = tmp_path / "sem.pt"
    torch.save({"encoder": enc, "decoder": dec}, ckpt)
    img = (np.random.RandomState(2).rand(48, 80, 3) * 255).astype(np.uint8)
    root = tmp_path / "vk"
    d = root / "vkitti_1.3.1_rgb" / "0001" / "clone"
    d.mkdir(parents=True)
    Image.fromarray(img).save(d / "00003.png")
    Image.fromarray(img).save(tmp_path / "frame.png")
    edit = tmp_path / "edit.json"
    edit.write_text(json.dumps([
        {"world": "0001", "topic": "clone", "source": "00003",
         "target": "00004", "operations": []},
        {"world": "0001", "topic": "clone", "source": "00003",
         "target": "00003", "operations": []}]))
    common = ["--device", "cpu", "--scales", "48", "--ckpt_dir", str(ckpt)]
    semantic_test.main(["--test_img", str(tmp_path / "frame.png"),
                        "--result", str(tmp_path / "single")] + common)
    semantic_test.main(["--test_img", "benchmark", "--edit_json", str(edit),
                        "--data_root", str(root),
                        "--result", str(tmp_path / "bench")] + common)
    want = TP.multiscale_labels_fused(tm, img, (48,), device="cpu")
    for path in (tmp_path / "single" / "frame.png",
                 tmp_path / "bench" / "0001_clone_00003.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    assert (tmp_path / "single" / "frame_color.png").exists()
