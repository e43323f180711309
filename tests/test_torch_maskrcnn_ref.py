"""The port's Mask R-CNN detector (sdn3d_tpu_torch.models.maskrcnn,
pipelines.detect) against the benchmark's plain reference
(perfbench/reference/maskrcnn_ref.py), on the CPU, at the small
configuration of tests/test_torch_detect.py (128^2 molded frame, stage
sizes (1, 1, 1, 1), anchors 8..128, pre-NMS 200, 50 proposals, 10
detections, min confidence 0.0), with the port's random weights
(models/maskrcnn.init_weights) "raw" and "tamed" as the benchmark tames
them (perfbench/harness/detect_weights.tame: the RPN's and the
classifier's class and box kernels 1e-3 times, the class bias (0, 2,
2.05)).

Tolerances.  Up to the mask head the reference runs the port's float32
operations in the port's order (its departures, in its docstring, are
there for that), so the pyramid, the RPN, the proposals, the classifier
and the refinement agree exactly, NaN boxes of the raw weights included.
The mask head differs in two sums: the reference's transposed
convolution is torch's, where the port convolves the dilated input, and
it runs on the valid detections, where the port runs on all of its
slots; so its planes agree to MASK_ATOL (measured max |diff| 2.0e-6).
Unmolded, a mask pixel can then flip only where PIL's resized byte sits
at the 0.5 threshold: at most MASK_FLIPS of a frame's mask pixels
(measured 0)."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import detect_weights as DW
from perfbench.reference import maskrcnn_ref as R
from sdn3d_tpu_torch.models import maskrcnn as TM
from sdn3d_tpu_torch.pipelines import detect as TD
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(num_classes=3, image_min_dim=128, image_max_dim=128,
             rpn_anchor_scales=(8, 16, 32, 64, 128), pre_nms_limit=200,
             post_nms_rois_inference=50, detection_min_confidence=0.0,
             detection_max_instances=10, stage_sizes=(1, 1, 1, 1))
TAMED_BIAS = (0.0, 2.0, 2.05)
MASK_ATOL = 1e-5
MASK_FLIPS = 1e-3
FRAMES = (0, 1, 2)


def _frame(seed, h=96, w=128):
    """tests/test_torch_detect.py's frame: noise and two flat boxes."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img[25:70, 30:95] = [205, 55, 45 + 35 * (seed % 3)]
    img[60:90, 90:120] = [30, 160, 200]
    return img


@pytest.fixture(scope="module")
def detectors():
    """{"raw" | "tamed": (port detector, its state_dict)} at SMALL."""
    out = {}
    cfg = TM.MaskRCNNConfig(**SMALL)
    for name in ("raw", "tamed"):
        det = TD.MaskRCNNDetector(cfg, device="cpu").init(0)
        sd = det.model.state_dict()
        if name == "tamed":
            sd = DW.tame(sd, TAMED_BIAS)
            det.load_state_dict(sd)
        out[name] = (det, sd)
    return out


def _cfg(**kw):
    return dataclasses.asdict(TM.MaskRCNNConfig(**dict(SMALL, **kw)))


def _port_input(det, image):
    cfg = det.config
    molded, window, _ = TD.resize_image(image, cfg.image_min_dim,
                                        cfg.image_max_dim)
    x = (torch.from_numpy(molded[None]).float()
         - torch.tensor(cfg.mean_pixel)).permute(0, 3, 1, 2).contiguous()
    return x, torch.tensor([window], dtype=torch.float32), window


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["published", "small"])
def test_layout_and_anchors_are_the_ports(kw):
    """The reference's state_dict layout is the port model's, key for key
    and in order (on the meta device at the published ResNet-101), and
    its anchors equal the port's."""
    cfg = TM.MaskRCNNConfig(**kw)
    with torch.device("meta"):
        model = TM.MaskRCNN(cfg)
    want = [(k, tuple(t.shape), t.dtype)
            for k, t in model.state_dict().items()]
    got = [(k, s, d) for k, (s, d) in R.layout(dataclasses.asdict(cfg))
           .items()]
    assert got == want
    np.testing.assert_array_equal(R.anchors(dataclasses.asdict(cfg)),
                                  TM.generate_pyramid_anchors(cfg))


def test_flops_of_the_published_detector():
    """One 1024^2 frame with 1,000 RoIs in the box head and 100
    detections in the mask head: 0.77 TFLOP (backbone, FPN, RPN and the
    heads)."""
    f = R.flops(dataclasses.asdict(TM.MaskRCNNConfig()), 1000, 100)
    assert 0.7e12 < f < 0.8e12


@pytest.mark.parametrize("weights", ["raw", "tamed"])
@pytest.mark.parametrize("seed", FRAMES)
def test_stages_match_the_reference(detectors, weights, seed):
    """Stage by stage, each reference stage fed the port stage's inputs:
    the pyramid, the RPN, the proposals, the classifier and the
    refinement exactly; the mask head to MASK_ATOL."""
    det, sd = detectors[weights]
    cfg, c = det.config, _cfg()
    x, win, window = _port_input(det, _frame(seed))
    anchors = torch.from_numpy(det.anchors)
    with torch.no_grad():
        pyr = det.model.fpn(x)
        ref_pyr = R.backbone(sd, c, x)
        assert len(pyr) == len(ref_pyr) == 5
        for a, b in zip(pyr, ref_pyr):
            assert torch.equal(a, b)
        logits, probs, deltas = det.model.rpn_forward(pyr)
        r_logits, r_probs, r_deltas = R.rpn(sd, pyr)
        assert torch.equal(logits[0], r_logits)
        assert torch.equal(probs[0], r_probs)
        assert torch.equal(deltas[0], r_deltas)

        props, valid = TM.proposal_layer(probs, deltas, anchors, cfg,
                                         cfg.post_nms_rois_inference)
        r_props, _, _ = R.proposals(c, probs[0], deltas[0], anchors)
        assert torch.equal(props[0][valid[0]], r_props)
        assert not valid[0][len(r_props):].any()

        feats = TM.RoiFeatures(pyr[:4])
        _, cprobs, cdeltas = det.model.classifier(feats, props)
        n = len(r_props)
        crops = R.roi_align(pyr[:4], props[0][:n], cfg.pool_size, c)
        _, r_cprobs, r_cdeltas = R.classifier_head(sd, crops)
        assert torch.equal(cprobs[0][:n], r_cprobs)
        assert torch.equal(cdeltas[0][:n], r_cdeltas)

        dets, dvalid = TM.refine_detections(props, cprobs, cdeltas, win,
                                            valid, cfg)
        boxes, cls, scores = R.refine(c, props[0][:n], cprobs[0][:n],
                                      cdeltas[0][:n], window)
        d = dets[0][dvalid[0]]
        assert torch.equal(d[:, :4], boxes)
        assert torch.equal(d[:, 4].long(), cls)
        assert torch.equal(d[:, 5], scores)

        masks = det.model.mask(feats, dets[..., :4] / cfg.image_max_dim)
        r_masks = R.mask_head(sd, R.roi_align(
            pyr[:4], boxes / cfg.image_max_dim, cfg.mask_pool_size, c))
        got = masks[0][:len(boxes)]
        assert got.shape == r_masks.shape
        assert float((got - r_masks).abs().max()) <= MASK_ATOL


def _packed(det, image):
    """The port's packed buffer of one frame, split: (detections [n, 6],
    own-class planes [n, mh, mw]) of its valid slots."""
    x, win, _ = _port_input(det, image)
    cfg = det.config
    D, (mh, mw) = cfg.detection_max_instances, cfg.mask_shape
    with torch.no_grad():
        packed = TD.pack_outputs(det.model(
            x, torch.from_numpy(det.anchors), win))[0].numpy()
    valid = packed[D * 6:D * 7] > 0.5
    return (packed[:D * 6].reshape(D, 6)[valid],
            packed[D * 7:].reshape(D, mh, mw)[valid])


@pytest.mark.parametrize("weights", ["raw", "tamed"])
@pytest.mark.parametrize("seed", FRAMES)
def test_end_to_end_matches_the_reference(detectors, weights, seed):
    """Each on its own stages: the port's packed buffer against the
    reference's detections (boxes, classes and scores exactly, own-class
    planes to MASK_ATOL), and the port's unmolded objects (detect)
    against the reference's unmold (classes and rois exactly, masks to
    MASK_FLIPS)."""
    det, sd = detectors[weights]
    image = _frame(seed)
    ref = R.detect(sd, _cfg(), image, "cpu")
    dets, planes = _packed(det, image)
    assert len(dets) == len(ref["boxes"])
    np.testing.assert_array_equal(dets[:, :4], ref["boxes"].numpy())
    np.testing.assert_array_equal(dets[:, 4], ref["class_ids"].numpy())
    np.testing.assert_array_equal(dets[:, 5], ref["scores"].numpy())
    assert np.abs(planes - ref["masks"].numpy()).max() <= MASK_ATOL

    got = det.detect(image)
    want = R.unmold(ref["boxes"].numpy(), ref["class_ids"].numpy(),
                    ref["masks"].numpy(), ref["window"], ref["scale"],
                    image.shape[:2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].shape == want[1].shape
    assert (got[1] != want[1]).mean() <= MASK_FLIPS if got[1].size else True
    if weights == "tamed":
        assert len(got[0]) > 0


def test_planted_fault_fails(detectors):
    """The RPN's NMS at 0.5 in the port (the reference at the
    configuration's 0.7), every NMS survivor kept on both sides: the
    stage comparison that holds the proposals fails.  (The benchmark
    plants 0.6; at this size the tamed proposals are their anchors within
    a fraction of a pixel, and no two of those overlap by an IoU in
    (0.6, 0.7], while one anchor's ratios overlap by 0.58.)"""
    det, sd = detectors["tamed"]
    cfg = det.config
    x, _, _ = _port_input(det, _frame(0))
    every = cfg.pre_nms_limit
    with torch.no_grad():
        _, probs, deltas = det.model.rpn_forward(det.model.fpn(x))
        props, valid = TM.proposal_layer(
            probs, deltas, torch.from_numpy(det.anchors),
            dataclasses.replace(cfg, rpn_nms_threshold=0.5), every)
        r_props, _, _ = R.proposals(_cfg(post_nms_rois_inference=every),
                                    probs[0], deltas[0],
                                    torch.from_numpy(det.anchors))
    got = props[0][valid[0]]
    assert got.shape != r_props.shape or not torch.equal(got, r_props)


@pytest.mark.parametrize("max_objects", [1, 5, 16, 40])
def test_capped_unmold_keeps_the_largest(max_objects):
    """The cap before the paste (derender_infer.keep_largest_unmolded, the
    chain's and geometric_main's detector path) equals the full unmold
    followed by derender_infer.keep_largest_detections, bit for bit and
    in its order, on 30 detections of the published configuration's
    buffer with boxes of repeated sizes (areas that tie), a flat box and
    one outside the window."""
    from types import SimpleNamespace

    from sdn3d_tpu_torch.pipelines.derender_infer import (
        keep_largest_detections, keep_largest_unmolded)
    cfg = TM.MaskRCNNConfig()
    det = TD.MaskRCNNDetector(cfg, device="cpu")
    D, (mh, mw) = cfg.detection_max_instances, cfg.mask_shape
    rng = np.random.RandomState(max_objects)
    dets = np.zeros((D, 6), np.float32)
    n = 30
    side = rng.choice([40.0, 80.0, 80.0, 160.0], n)
    y1 = np.round(rng.uniform(357, 600, n))
    x1 = np.round(rng.uniform(0, 800, n))
    dets[:n] = np.stack([y1, x1, y1 + side, x1 + side,
                         rng.choice([1.0, 2.0], n), rng.rand(n)], 1)
    dets[3, 2] = dets[3, 0]                      # flat: dropped
    dets[4, :4] = [10, 10, 50, 50]               # above the window
    valid = np.zeros(D, np.float32)
    valid[:n] = 1.0
    planes = rng.rand(D, mh, mw).astype(np.float32)
    planes[5] = planes[6]                        # two equal masks
    packed = np.concatenate([dets.ravel(), valid, planes.ravel()])
    args = (packed, (357, 0, 666, 1024), 1024 / 1242, (375, 1242))
    cap = SimpleNamespace(max_objects=max_objects)
    want = keep_largest_detections(cap, *det._unmold_packed(*args).paste())
    got = keep_largest_unmolded(cap, det._unmold_packed(*args))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == min(max_objects, n - 2)
