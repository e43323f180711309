"""The port's Mask R-CNN detection (sdn3d_tpu_torch.ops.nms, ops.roi_align,
models.maskrcnn, pipelines.detect, utils.port.maskrcnn_state_dict_from_jax)
against the JAX package's, on the CPU, at the JAX tests' small
configuration (128^2 molded frame, stage_sizes (1, 1, 1, 1), anchors
8..128, pre-NMS 200, 50 proposals, 10 detections, min confidence 0.0;
tests/test_detection_ops.py:129): the same numpy inputs and JAX's random
weights, converted, through both.

Two sets of weights: "raw", JAX's init as it is (its activations reach
hundreds, so the RPN's and the classifier's softmaxes saturate to exact
ties at 1.0 and exp of the box deltas gives boxes of zero width: the tie
orders and the degenerate boxes are what is tested), and "tamed", the same
init with the RPN's and the classifier's class and box kernels scaled by
1e-3 and the class bias set to (0, 2, 2.05), so that scores spread, boxes
keep their size and both foreground classes are detected.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import maskrcnn as JM
from sdn3d_tpu.ops import nms as JN
from sdn3d_tpu.ops.roi_align import crop_and_resize as j_crop
from sdn3d_tpu.pipelines import detect as JD
from sdn3d_tpu.utils.port import port_maskrcnn
from sdn3d_tpu_torch.models import maskrcnn as TM
from sdn3d_tpu_torch.ops import nms as TN
from sdn3d_tpu_torch.ops.roi_align import crop_and_resize as t_crop
from sdn3d_tpu_torch.pipelines import detect as TD
from sdn3d_tpu_torch.utils.port import maskrcnn_state_dict_from_jax

SMALL = dict(num_classes=3, image_min_dim=128, image_max_dim=128,
             rpn_anchor_scales=(8, 16, 32, 64, 128), pre_nms_limit=200,
             post_nms_rois_inference=50, detection_min_confidence=0.0,
             detection_max_instances=10, stage_sizes=(1, 1, 1, 1))

# Float32 stages fed the JAX stage's inputs: the two packages sum the
# convolutions' products in other orders, and XLA's CPU exp, log2 and sqrt
# differ from torch's in the last bit (a third of exp's outputs), so each
# float output agrees to a tolerance; measured over 4 frames in brackets
# (raw / tamed weights).  Relative to the output's largest magnitude:
PYRAMID_RTOL = 1e-5        # P2..P6 [1.1e-6 / 1.1e-6]
RPN_RTOL = 1e-5            # RPN logits and deltas [1.6e-6 / 1.6e-6]
CLASSIFIER_RTOL = 1e-5     # class probabilities and deltas [3.8e-6 / 1.1e-6]
# Absolute: the RPN's softmax of raw logits in the hundreds moves by up to
# ~6e-5 where a probability is not saturated [5.7e-5 / 1.5e-7]
PROB_ATOL = 1e-4
PROPOSAL_ATOL = 1e-6       # normalised proposals [6e-8 / 3e-8]
MASK_ATOL = 5e-5           # sigmoid masks [1.1e-5 / 1.9e-5]
# refined boxes are rounded to whole pixels: a box edge that lands within
# an ulp of .5 may round the other way, so one pixel is allowed [0 / 0]
BOX_ATOL = 1.0
SCORE_ATOL = 1e-5          # [0 / 0]
# End to end (each package on its own stages), the packed buffer: the
# detections' validity and classes equal, boxes within BOX_ATOL, scores
# within SCORE_ATOL, mask planes within E2E_MASK_ATOL (the proposals and
# boxes that feed the heads carry the ulp differences above).  Unmolded,
# a mask pixel flips only where PIL's resized byte sits at the 0.5
# threshold's neighbour: at most MASK_FLIPS of a frame's mask pixels.
E2E_MASK_ATOL = 1e-4
MASK_FLIPS = 1e-3
# bfloat16 against JAX's bfloat16 (both round each convolution's output
# to bfloat16, after sums in other orders): one output in a few thousand
# lands on the neighbouring bfloat16, 2^-8 relative, and the next layers
# carry it on.
BF16_PYRAMID_RTOL = 2e-2


def _small_cfg(pkg, **kw):
    return pkg.MaskRCNNConfig(**dict(SMALL, **kw))


def tame(variables):
    """The "tamed" weights of the module docstring, from JAX variables."""
    v = copy.deepcopy(variables)
    for head, names in (("rpn", ("conv_class", "conv_bbox")),
                        ("classifier", ("linear_class", "linear_bbox"))):
        for n in names:
            v["params"][head][n]["kernel"] = (
                v["params"][head][n]["kernel"] * np.float32(1e-3))
    v["params"]["classifier"]["linear_class"]["bias"] = np.asarray(
        [0.0, 2.0, 2.05], np.float32)
    return v


def _frame(seed, h=96, w=128):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img[25:70, 30:95] = [205, 55, 45 + 35 * (seed % 3)]
    img[60:90, 90:120] = [30, 160, 200]
    return img


@pytest.fixture(scope="module")
def nets():
    """{"raw": (variables, port detector), "tamed": (...)} at SMALL, the
    JAX model, and its jitted stage function."""
    cfg = _small_cfg(JM)
    jm = JM.MaskRCNN(cfg)
    anchors = jnp.asarray(JM.generate_pyramid_anchors(cfg))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                         anchors, jnp.asarray([0.0, 0.0, 128.0, 128.0]))
    raw = jax.tree_util.tree_map(np.asarray, v)
    out = {}
    for name, variables in (("raw", raw), ("tamed", tame(raw))):
        det = TD.MaskRCNNDetector(_small_cfg(TM), device="cpu")
        det.load_state_dict(maskrcnn_state_dict_from_jax(variables))
        out[name] = (variables, det)
    return out, jm, jax.jit(lambda v, x, a, w: jm.apply(
        v, x, a, w, method=_jax_stages))


def _jax_stages(m, images, anchors, window):
    """Every stage's output of the JAX MaskRCNN (its __call__, unrolled)."""
    cfg = m.config
    pyr = m.fpn(images)
    logits, probs, bbox = m._rpn_forward(pyr)
    props, pv = JM.proposal_layer(probs[0], bbox[0], anchors, cfg,
                                  cfg.post_nms_rois_inference)
    _, cprobs, cbbox = m.classifier(pyr[:4], props)
    dets, dv = JM.refine_detections(props, cprobs, cbbox, window, pv, cfg)
    h, w = cfg.image_shape[:2]
    masks = m.mask(pyr[:4], dets[:, :4] / jnp.asarray([h, w, h, w],
                                                      jnp.float32))
    return dict(pyramid=pyr, logits=logits, probs=probs, bbox=bbox,
                props=props, props_valid=pv, cprobs=cprobs, cbbox=cbbox,
                dets=dets, dets_valid=dv, masks=masks)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_config_and_anchors_match_jax():
    """MaskRCNNConfig: the same fields, defaults, image_shape and
    backbone_shapes; the pyramid anchors equal (261,888 at full width)."""
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(
        TM.MaskRCNNConfig)] == [(f.name, f.default) for f in
                                dataclasses.fields(JM.MaskRCNNConfig)])
    for kw in ({}, SMALL):
        tc, jc = TM.MaskRCNNConfig(**kw), JM.MaskRCNNConfig(**kw)
        assert tc.image_shape == jc.image_shape
        np.testing.assert_array_equal(tc.backbone_shapes, jc.backbone_shapes)
        a = TM.generate_pyramid_anchors(tc)
        np.testing.assert_array_equal(a, JM.generate_pyramid_anchors(jc))
        if not kw:
            assert a.shape == (261888, 4)
    with pytest.raises(ValueError):
        TM.MaskRCNNConfig(image_max_dim=100)


def test_state_dict_round_trips_through_port_maskrcnn(nets):
    """port_maskrcnn(maskrcnn_state_dict_from_jax(v)) equals v bit for bit,
    and the port's MaskRCNN loads exactly those keys."""
    (by_name, _, _) = nets
    for variables, det in by_name.values():
        sd = maskrcnn_state_dict_from_jax(variables)
        assert set(sd) == set(det.model.state_dict())
        back = port_maskrcnn(sd, stage_sizes=SMALL["stage_sizes"])
        a = jax.tree_util.tree_flatten_with_path(variables)[0]
        b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_full_width_state_dict_layout():
    """At MaskRCNNConfig() (ResNet-101): the state_dict written from JAX's
    variable shapes has the port model's keys and shapes (the reference
    layout: fpn.C1.0, fpn.C4.22.conv3, fpn.P2_conv2.1, mask.deconv ...).
    Shapes only: jax.eval_shape, zeros, and a model on the meta device."""
    cfg = JM.MaskRCNNConfig()
    shapes = jax.eval_shape(
        JM.MaskRCNN(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((12, 4)), jnp.zeros(4))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    sd = maskrcnn_state_dict_from_jax(zeros)
    with torch.device("meta"):
        model = TM.MaskRCNN(TM.MaskRCNNConfig())
    want = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in sd.items()} == want
    for k in ("fpn.C1.0.weight", "fpn.C4.22.conv3.bias",
              "fpn.C5.0.downsample.1.running_var", "fpn.P2_conv2.1.weight",
              "rpn.conv_shared.weight", "classifier.linear_bbox.weight",
              "mask.deconv.weight"):
        assert k in sd
    assert want["mask.deconv.weight"] == (256, 256, 2, 2)     # [in, out]


def _nms_case(seed):
    """Boxes [64, 4] (every third on whole pixels, as refined boxes are),
    scores with exact ties (and ties at -1.0, as refine_detections fills
    them), an invalid third, and a NaN box in the later seeds."""
    rng = np.random.RandomState(seed)
    n = 64
    lo = rng.uniform(0, 80, (n, 2))
    hi = lo + rng.uniform(1, 40, (n, 2))
    boxes = np.concatenate([lo, hi], 1).astype(np.float32)
    boxes[::3] = np.round(boxes[::3])
    boxes[5::7] = boxes[4::7][:len(boxes[5::7])]          # duplicates
    scores = rng.choice([0.2, 0.5, 0.7, 0.9, -1.0], n).astype(np.float32)
    scores[::5] = rng.rand(len(scores[::5]))
    valid = rng.rand(n) > 0.3
    if seed >= 3:
        boxes[7] = np.nan
        scores[9] = np.nan
    return boxes, scores, valid


@pytest.mark.parametrize("seed", range(6))
def test_nms_matches_jax(seed):
    """nms (score-sorted boxes) and nms_padded (its own stable sort, max_out
    below and above the kept count) against the JAX package's, with and
    without a valid mask: keep masks and indices equal exactly; the batched
    form equals row by row."""
    boxes, scores, valid = _nms_case(seed)
    for thr in (0.3, 0.7):
        for v in (None, valid):
            jv = None if v is None else jnp.asarray(v)
            tv = None if v is None else torch.from_numpy(v)
            want = np.asarray(JN.nms(jnp.asarray(boxes), thr, jv))
            got = TN.nms(torch.from_numpy(boxes), thr, tv).numpy()
            np.testing.assert_array_equal(got, want)
            for max_out in (5, 64):
                wi, wv = JN.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                                       thr, max_out, jv)
                gi, gv = TN.nms_padded(torch.from_numpy(boxes),
                                       torch.from_numpy(scores), thr, max_out,
                                       tv)
                np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
                np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    b2 = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()]))
    k2 = TN.nms(b2, 0.5)
    for i in range(2):
        np.testing.assert_array_equal(k2[i].numpy(),
                                      TN.nms(b2[i], 0.5).numpy())


def test_nms_steps_do_not_grow_with_boxes():
    """The fixed-point NMS runs (longest suppression chain + 1) steps,
    rounded up to NMS_STEPS_PER_CHECK, whatever the number of boxes:
    disjoint boxes take one check at 64 and at 4096 boxes; a chain of
    boxes each overlapping the next takes more, and still gives the greedy
    answer (every other box)."""
    k = TN.NMS_STEPS_PER_CHECK
    for n in (64, 4096):
        x = np.arange(n, dtype=np.float32)[:, None] * 10
        boxes = np.concatenate([x, x, x + 5, x + 5], 1)
        stats = {}
        keep = TN.nms(torch.from_numpy(boxes), 0.5, stats=stats)
        assert bool(keep.all()) and stats["steps"] == k
    x = np.arange(12, dtype=np.float32)[:, None] * 3
    chain = np.concatenate([np.zeros_like(x), x, np.full_like(x, 9), x + 6], 1)
    stats = {}
    keep = TN.nms(torch.from_numpy(chain), 0.3, stats=stats).numpy()
    np.testing.assert_array_equal(keep, np.asarray(JN.nms(jnp.asarray(chain),
                                                          0.3)))
    np.testing.assert_array_equal(keep, np.arange(12) % 2 == 0)
    assert k < stats["steps"] <= -(-(12 + 1) // k) * k


def test_top_k_matches_lax_top_k():
    """top_k against lax.top_k: +NaN first, -NaN last, ties by index,
    -0 below +0, on rows with exact ties."""
    x = np.array([1.0, 0.5, 0.0, 1.0, 0.0, 0.5, np.inf, -np.inf, 1.0, -0.0,
                  0.0, -1.0], np.float32)
    x.view(np.uint32)[2] = 0x7FC00000
    x.view(np.uint32)[4] = 0xFFC00000
    rows = np.stack([x, x[::-1].copy(), np.where(np.isnan(x), 0.25, x)])
    for k in (1, 5, 12):
        wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
        gv, gi = TM.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy().view(np.uint32),
                                      np.asarray(wv).view(np.uint32))


@pytest.mark.parametrize("crop", [(7, 7), (14, 14), (1, 3)])
def test_crop_and_resize_matches_jax(crop):
    """crop_and_resize against the JAX package's, compiled as the model
    compiles it, on boxes inside, across and outside the image, inverted,
    with NaN / inf coordinates (zero there, as JAX's clamped gather gives)
    and ending on the far edge (the sample positions are XLA's fused
    multiply-adds): within 1e-6 (the lerps may contract differently)."""
    rng = np.random.RandomState(3)
    image = rng.rand(2, 13, 17, 5).astype(np.float32)
    boxes = np.array([[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 1.0],
                      [-0.2, 0.3, 0.5, 1.2], [0.6, 0.5, 0.3, 0.4],
                      [np.nan, 0.0, np.inf, 1.0],
                      [-np.inf, 0.1, 0.5, np.inf], [0.3, 0.0, 1.0, 0.7],
                      [0.0, 0.123, 1.0, 1.0]], np.float32)
    box_idx = np.array([0, 1, 0, 1, 0, 1, 0, 1], np.int32)
    want = np.asarray(jax.jit(j_crop, static_argnums=3)(
        jnp.asarray(image), jnp.asarray(boxes), jnp.asarray(box_idx), crop))
    got = t_crop(torch.from_numpy(image), torch.from_numpy(boxes),
                 torch.from_numpy(box_idx), crop).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _molded(cfg, seed):
    molded, window, _ = TD.resize_image(_frame(seed), cfg.image_min_dim,
                                        cfg.image_max_dim)
    return molded, window


@pytest.mark.parametrize("weights", ["raw", "tamed"])
def test_stages_match_jax(nets, weights):
    """Stage by stage, each port stage fed the JAX stage's inputs: the
    pyramid, the RPN, the classifier and the mask head within their
    stated tolerances; the proposal layer's validity exact and its boxes
    within PROPOSAL_ATOL; refine_detections' kept set, class ids and
    validity exact, boxes within BOX_ATOL, scores within SCORE_ATOL."""
    by_name, jm, stages = nets
    variables, det = by_name[weights]
    cfg = det.config
    molded, window = _molded(cfg, 0)
    x = molded.astype(np.float32) - np.asarray(cfg.mean_pixel, np.float32)
    anchors = torch.from_numpy(det.anchors)
    j = jax.tree_util.tree_map(np.asarray, stages(
        variables, jnp.asarray(x[None]), jnp.asarray(det.anchors),
        jnp.asarray(window, jnp.float32)))
    m = det.model
    with torch.no_grad():
        pyr = m.fpn(torch.from_numpy(x).permute(2, 0, 1)[None])
        for got, want in zip(pyr, j["pyramid"]):
            assert _rel(got.permute(0, 2, 3, 1), want) <= PYRAMID_RTOL
        jpyr = [_nchw(p) for p in j["pyramid"]]
        logits, probs, bbox = m.rpn_forward(jpyr)
        for got, k in ((logits, "logits"), (bbox, "bbox")):
            assert _rel(got, j[k]) <= RPN_RTOL, k
        np.testing.assert_allclose(probs.numpy(), j["probs"], rtol=0,
                                   atol=PROB_ATOL)

        props, pv = TM.proposal_layer(
            torch.from_numpy(j["probs"]), torch.from_numpy(j["bbox"]),
            anchors, cfg, cfg.post_nms_rois_inference)
        np.testing.assert_array_equal(pv[0].numpy(), j["props_valid"])
        np.testing.assert_allclose(props[0].numpy(), j["props"], rtol=0,
                                   atol=PROPOSAL_ATOL)

        feats = TM.RoiFeatures(jpyr[:4])
        jprops = torch.from_numpy(j["props"])[None]
        _, cprobs, cbbox = m.classifier(feats, jprops)
        assert _rel(cprobs[0], j["cprobs"]) <= CLASSIFIER_RTOL
        assert _rel(cbbox[0], j["cbbox"]) <= CLASSIFIER_RTOL

        dets, dv = TM.refine_detections(
            jprops, torch.from_numpy(j["cprobs"])[None],
            torch.from_numpy(j["cbbox"])[None],
            torch.tensor([window], dtype=torch.float32),
            torch.from_numpy(j["props_valid"])[None], cfg)
        dets, dv = dets[0].numpy(), dv[0].numpy()
        np.testing.assert_array_equal(dv, j["dets_valid"])
        np.testing.assert_array_equal(dets[:, 4], j["dets"][:, 4])
        np.testing.assert_allclose(dets[:, :4], j["dets"][:, :4], rtol=0,
                                   atol=BOX_ATOL)
        np.testing.assert_allclose(dets[:, 5], j["dets"][:, 5], rtol=0,
                                   atol=SCORE_ATOL)

        jboxes = torch.from_numpy(j["dets"][:, :4] / 128.0)[None]
        masks = m.mask(feats, jboxes)[0].permute(0, 2, 3, 1)
        np.testing.assert_allclose(masks.numpy(), j["masks"], rtol=0,
                                   atol=MASK_ATOL)
    if weights == "tamed":
        # the case the weights were tamed for: detections of both classes
        assert set(j["dets"][j["dets_valid"], 4].tolist()) == {1.0, 2.0}


@pytest.mark.parametrize("weights", ["raw", "tamed"])
def test_packed_buffer_matches_jax(nets, weights):
    """End to end, each package on its own stages: the JAX detector's
    packed serving program against the port's pack_outputs on the same
    uint8 frame (validity and classes equal, boxes within BOX_ATOL, scores
    within SCORE_ATOL, own-class mask planes within E2E_MASK_ATOL), and
    the unmolded objects: the same classes and rois, mask pixels flipped
    on at most MASK_FLIPS of them."""
    by_name, _, _ = nets
    variables, det = by_name[weights]
    cfg = det.config
    jdet = JD.MaskRCNNDetector(config=_small_cfg(JM))
    D, (mh, mw) = cfg.detection_max_instances, cfg.mask_shape
    for seed in (0, 1):
        frame = _frame(seed)
        molded, window = _molded(cfg, seed)
        want = np.asarray(jdet._detect_packed(
            variables, jnp.asarray(molded), jnp.asarray(jdet.anchors),
            jnp.asarray(window, jnp.float32)))
        got = det._packed([molded], [window])[0].numpy()
        assert got.shape == want.shape == (D * 7 + D * mh * mw,)
        gd, wd = got[:D * 6].reshape(D, 6), want[:D * 6].reshape(D, 6)
        np.testing.assert_array_equal(got[D * 6:D * 7], want[D * 6:D * 7])
        np.testing.assert_array_equal(gd[:, 4], wd[:, 4])
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0,
                                   atol=BOX_ATOL)
        np.testing.assert_allclose(gd[:, 5], wd[:, 5], rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(got[D * 7:], want[D * 7:], rtol=0,
                                   atol=E2E_MASK_ATOL)

        gc, gm, gr = det.detect(frame)
        wc, wm, wr = jdet.detect(variables, frame)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gr, wr, rtol=0, atol=BOX_ATOL)
        assert gm.shape == wm.shape
        flips = float((gm != wm).mean()) if gm.size else 0.0
        print(f"{weights} frame {seed}: {len(gc)} objects, mask pixels "
              f"flipped {flips:.2e}")
        assert flips <= MASK_FLIPS
        if weights == "tamed":
            assert len(gc) > 0 and gm.any()


def test_detector_split_batch_and_padding(nets):
    """detect_begin/detect_finish (every frame enqueued before any is
    unmolded) equal detect; one batched pass over 3 frames agrees with the
    per-frame passes within 5e-4 (JAX's test_detect_batch_matches_single),
    and its unmolded objects are the per-frame ones; pad_to=4 returns 3
    results equal to the unpadded; N == 1 is detect's; no frames give an
    empty list (the JAX package raises IndexError there)."""
    by_name, _, _ = nets
    _, det = by_name["tamed"]
    frames = [_frame(s) for s in (2, 3, 4)]
    sync = [det.detect(f) for f in frames]
    pend = [det.detect_begin(f) for f in frames]
    for a, b in zip(sync, [det.detect_finish(p) for p in pend]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    singles = [det._packed(*[[v] for v in _molded(det.config, s)])[0]
               for s in (2, 3, 4)]
    pending = det.detect_begin_batch(frames)
    assert pending[0] == "batch"
    batched = torch.from_numpy(pending[1].result())
    assert batched.shape == (3, singles[0].shape[0])
    for s, b in zip(singles, batched):
        np.testing.assert_allclose(b.numpy(), s.numpy(), rtol=0, atol=5e-4)
    outs = det.detect_finish_batch(pending)
    outs4 = det.detect_finish_batch(det.detect_begin_batch(frames, pad_to=4))
    assert len(outs) == len(outs4) == 3
    for a, b, c in zip(outs, outs4, sync):
        np.testing.assert_array_equal(a[0], c[0])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        det.detect_begin_batch(frames, pad_to=2)
    one = det.detect_batch(frames[:1])
    for x, y in zip(one[0], sync[0]):
        np.testing.assert_array_equal(x, y)
    assert det.detect_batch([]) == []
    assert det.detect_finish_batch(det.detect_begin_batch([], pad_to=4)) == []


def test_bfloat16_matches_jax_bfloat16(nets):
    """compute_dtype bfloat16 against the JAX package's bfloat16 on the
    same weights: the pyramid (bfloat16, BatchNorm in float32 between the
    convolutions) within BF16_PYRAMID_RTOL of its largest magnitude, the
    RPN's float32 logits from it likewise, and the detector end to end
    finite with the same number of valid detections."""
    by_name, _, _ = nets
    variables, _ = by_name["tamed"]
    jcfg = _small_cfg(JM, compute_dtype="bfloat16")
    jm = JM.MaskRCNN(jcfg)
    det = TD.MaskRCNNDetector(_small_cfg(TM, compute_dtype="bfloat16"),
                              device="cpu")
    det.load_state_dict(maskrcnn_state_dict_from_jax(variables))
    molded, window = _molded(det.config, 0)
    x = molded.astype(np.float32) - np.asarray(jcfg.mean_pixel, np.float32)

    def jstage(v, x):
        def f(m, x):
            pyr = m.fpn(x)
            return pyr, m._rpn_forward(pyr)[0]
        return jm.apply(v, x, method=f)
    jpyr, jlogits = jax.jit(jstage)(variables, jnp.asarray(x[None]))
    with torch.no_grad():
        pyr = det.model.fpn(torch.from_numpy(x).permute(2, 0, 1)[None])
        logits = det.model.rpn_forward(pyr)[0]
    for got, want in zip(pyr, jpyr):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(got.float().permute(0, 2, 3, 1),
                    np.asarray(want, np.float32)) <= BF16_PYRAMID_RTOL
    assert logits.dtype == torch.float32
    assert _rel(logits, np.asarray(jlogits)) <= BF16_PYRAMID_RTOL
    packed = det._packed([molded], [window])[0].numpy()
    assert np.isfinite(packed).all()
    jdet = JD.MaskRCNNDetector(config=jcfg)
    want = np.asarray(jdet._detect_packed(
        variables, jnp.asarray(molded), jnp.asarray(jdet.anchors),
        jnp.asarray(window, jnp.float32)))
    D = jcfg.detection_max_instances
    assert packed[D * 6:D * 7].sum() == want[D * 6:D * 7].sum()
