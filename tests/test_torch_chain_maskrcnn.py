"""The edit chain and the geometric CLI with Mask R-CNN as the source of
objects (sdn3d_tpu_torch.pipelines.chain with a detector, cli.edit_chain
--source maskrcnn, cli.geometric_main at its default --source maskrcnn)
against the JAX package's, on the CPU: the chains of
tests/test_torch_chain.py (the same fixture, shapes and converted weights)
with the small detector of tests/test_torch_detect.py (its "tamed" JAX
weights, converted) keeping 50 detections, not 10: on the fixture's wide
frames (a 39x128 window of the 128^2 molded frame) the ten best are
proposals clipped flat to the window's edge, which unmolding drops, and
each source frame should give objects."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_chain import (  # noqa: F401 (fixtures)
    FAKE_E2E_MAX, FAKE_E2E_MEAN, SMALL, _port_chain, _requests, chains, env)
from tests.test_torch_detect import MASK_FLIPS
from tests.test_torch_detect import SMALL as DET_SMALL
from tests.test_torch_detect import tame

DET_CHAIN = dict(DET_SMALL, detection_max_instances=50)
# Unmolded detections of one frame from the two packages' detectors: the
# same classes, rois within one molded pixel (refined boxes round to whole
# pixels; the fixture's 1242-wide frames are molded at 128/1242), mask
# pixels flipped on at most MASK_FLIPS of them (tests/test_torch_detect.py)
ROI_ATOL = 1242 / 128


@pytest.fixture(scope="module")
def detectors():
    """(JAX MaskRCNNDetector, its tamed variables, the port's detector with
    them converted, a state_dict file of them) at DET_CHAIN."""
    import tempfile

    from sdn3d_tpu.models import maskrcnn as JM
    from sdn3d_tpu.pipelines import detect as JD
    from sdn3d_tpu_torch.models import maskrcnn as TM
    from sdn3d_tpu_torch.pipelines import detect as TD
    from sdn3d_tpu_torch.utils.port import maskrcnn_state_dict_from_jax

    jdet = JD.MaskRCNNDetector(config=JM.MaskRCNNConfig(**DET_CHAIN))
    v = jax.jit(jdet.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
        jnp.asarray(jdet.anchors), jnp.asarray([0.0, 0.0, 128.0, 128.0]))
    variables = tame(jax.tree_util.tree_map(np.asarray, v))
    sd = maskrcnn_state_dict_from_jax(variables)
    tdet = TD.MaskRCNNDetector(TM.MaskRCNNConfig(**DET_CHAIN), device="cpu")
    tdet.load_state_dict(sd)
    ckpt = os.path.join(tempfile.mkdtemp(prefix="mrcnn_"), "mrcnn.pth")
    torch.save(sd, ckpt)
    return jdet, variables, tdet, ckpt


def _det_requests(root, edit_json):
    """The chain test's pairs without their GT dets."""
    return [{"image_rgb": image, "operations": item.operations,
             "cache_key": item.source_name}
            for item, image, _ in _requests(root, edit_json)]


def _same_dets(got, want):
    (gc, gm, gr), (wc, wm, wr) = got, want
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gr, wr, rtol=0, atol=ROI_ATOL)
    assert gm.shape == wm.shape
    assert (gm != wm).mean() <= MASK_FLIPS if gm.size else True


def test_edit_frame_with_detector_matches_jax(env, chains, detectors):
    """EditChain.edit_frame without dets (its detector runs) on the first
    pair, against the JAX package's chain with the same detector: the
    chain's detections (capped to the 16 slots) within ROI_ATOL and
    MASK_FLIPS, and, end to end on JAX's label, the instance planes on
    >= 99.9% of pixels and the fake within test_torch_chain.py's
    FAKE_E2E_MAX / FAKE_E2E_MEAN; the port's edit_frame without dets
    equals edit_frame with dets=chain.detect(image) bit for bit."""
    _, root, edit_json, _ = env
    jchain, tchain, _, _ = chains
    jdet, variables, tdet, _ = detectors
    jchain.detector = (jdet, variables)
    port = _port_chain(tchain, small_fetch=False, **SMALL)
    port.detector = tdet
    for r in _det_requests(root, edit_json)[:1]:
        image, key = r["image_rgb"], r["cache_key"]
        want = jchain.edit_frame(image, operations=r["operations"],
                                 cache_key=key)
        dets = port.detect(image)
        _same_dets(dets, jchain.detect(image))
        assert len(dets[0]) > 0
        got = port.edit_frame(image, operations=r["operations"],
                              label=want["label"], cache_key=key)
        agree = (got["geo"]["instance_png"]
                 == want["geo"]["instance_png"]).mean()
        d = np.abs(got["fake"] - want["fake"])
        print(f"{key}: {len(dets[0])} objects; instance agreement "
              f"{agree:.6f}, fake max |diff| {d.max():.3g}, mean "
              f"{d.mean():.3g}")
        assert agree >= 0.999
        assert (got["geo"]["instance_png"] > 0).any()
        assert d.max() <= FAKE_E2E_MAX and d.mean() <= FAKE_E2E_MEAN
        same = _port_chain(tchain, small_fetch=False, **SMALL).edit_frame(
            image, operations=r["operations"], label=want["label"],
            dets=dets)
        for k in ("instance_png", "normal_png", "depth_png"):
            np.testing.assert_array_equal(same["geo"][k], got["geo"][k])
        np.testing.assert_array_equal(same["fake"], got["fake"])


def test_detect_missing_batches_one_dispatch(chains, detectors):
    """detect_missing puts every det-less request of a chunk through
    ONE batched detection padded to the chunk's size, leaves preset dets
    untouched and does nothing when none is missing (the JAX package's
    test_detect_missing_batches_one_dispatch); a chain without a detector
    raises for a det-less request."""
    _, tchain, _, _ = chains
    _, _, tdet, _ = detectors
    port = _port_chain(tchain, **SMALL)
    calls = []
    orig = tdet.detect_begin_batch

    def counting(images, pad_to=None):
        calls.append((len(images), pad_to))
        return orig(images, pad_to=pad_to)

    port.detector = tdet
    tdet.detect_begin_batch = counting
    try:
        rng = np.random.RandomState(0)
        frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
                  for _ in range(3)]
        preset = ("ids", "masks", "rois")
        requests = [{"image_rgb": frames[0], "dets": preset},
                    {"image_rgb": frames[1]}, {"image_rgb": frames[2]}]
        dets_list = port.detect_missing(requests,
                                        [r.get("dets") for r in requests])
        assert calls == [(2, 3)]
        assert dets_list[0] is preset
        for d in dets_list[1:]:
            assert isinstance(d, tuple) and len(d) == 3
        assert port.detect_missing(requests, [preset] * 3) == [preset] * 3
        assert calls == [(2, 3)]
    finally:
        del tdet.detect_begin_batch
    with pytest.raises(ValueError, match="without a detector"):
        _port_chain(tchain, **SMALL).detect(frames[0])


def test_batched_and_pipelined_chains_detect(env, chains, detectors):
    """edit_frames and edit_frames_pipelined with det-less requests (one
    batched detection a chunk): pipelined equals batched bit for bit; the
    batched chain's pairs agree with edit_frame's (one frame a pass) in
    their classes and to the end-to-end tolerances (a batch may move a
    convolution's last bits on the CPU)."""
    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    _, _, tdet, _ = detectors
    requests = _det_requests(root, edit_json)

    def chain():
        c = _port_chain(tchain, **dict(SMALL, fine_height=48))
        c.detector = tdet
        return c

    batched = chain().edit_frames(requests)
    piped = next(iter(chain().edit_frames_pipelined([requests])))
    serial = [chain().edit_frame(r["image_rgb"], operations=r["operations"],
                                 cache_key=r["cache_key"]) for r in requests]
    for a, b, s in zip(batched, piped, serial):
        np.testing.assert_array_equal(a["label"], b["label"])
        for k in ("instance_small", "normal_small"):
            np.testing.assert_array_equal(a["geo"][k], b["geo"][k])
        np.testing.assert_array_equal(a["fake"], b["fake"])
        assert a["geo"]["json_obj"].keys() == s["geo"]["json_obj"].keys()
        agree = (a["geo"]["instance_small"]
                 == s["geo"]["instance_small"]).mean()
        d = np.abs(a["fake"] - s["fake"])
        assert agree >= 0.999
        assert d.max() <= FAKE_E2E_MAX and d.mean() <= FAKE_E2E_MEAN


def _small_detector_cli(monkeypatch):
    """The CLIs build MaskRCNNConfig(compute_dtype=...) at full width
    (ResNet-101 at 1024^2, too large for the CPU tests): here they build
    DET_CHAIN."""
    from sdn3d_tpu_torch.models import maskrcnn as TM
    monkeypatch.setattr(TM, "MaskRCNNConfig",
                        functools.partial(TM.MaskRCNNConfig, **DET_CHAIN))


def test_geometric_main_maskrcnn_writes_contract(env, detectors, tmp_path,
                                                  monkeypatch):
    """cli.geometric_main at its default --source maskrcnn, --device cpu,
    one fixture frame with a two-item edit JSON and --maskrcnn_ckpt (the
    tamed weights): the five-file contract per item, objects in the
    instance map and the JSON, and both items from one detection of the
    source (the CLI's cache); without a checkpoint (random weights from
    --seed) it runs too."""
    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.pipelines import detect as TD

    _, root, _, shapenet = env
    _, _, _, ckpt = detectors
    _small_detector_cli(monkeypatch)
    frame = os.path.join(root, "vkitti_1.3.1_rgb", "0006", "fog",
                         "00055.png")
    with open(tmp_path / "edit.json", "w") as fh:
        json.dump([{"world": "0006", "topic": "fog", "source": "00055",
                    "target": f"t{i}", "operations": []} for i in range(2)],
                  fh)
    runs = []
    orig = TD.MaskRCNNDetector.detect_begin
    monkeypatch.setattr(TD.MaskRCNNDetector, "detect_begin",
                        lambda self, *a, **kw: runs.append(1) or orig(
                            self, *a, **kw))
    common = ["--input_image", frame, "--shapenet_root", shapenet,
              "--image_size", "64", "--render_size", "64", "--device", "cpu"]
    geometric_main.main(common + ["--maskrcnn_ckpt", ckpt, "--edit_json",
                                  str(tmp_path / "edit.json"),
                                  "--output_dir", str(tmp_path / "a")])
    assert len(runs) == 1
    for name in ("00000", "00001"):
        for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
            assert os.path.exists(tmp_path / "a" / (name + suffix))
        inst = np.asarray(Image.open(tmp_path / "a" / f"{name}.png"))
        assert inst.shape == (375, 1242) and inst.max() >= 1
        with open(tmp_path / "a" / f"{name}.json") as fh:
            assert len(json.load(fh)) >= 1
    geometric_main.main(common + ["--output_dir", str(tmp_path / "b")])
    assert os.path.exists(tmp_path / "b" / "00055.json")


def test_edit_chain_cli_maskrcnn(env, detectors, tmp_path, monkeypatch):
    """cli.edit_chain --source maskrcnn --device cpu at the small shapes,
    with --maskrcnn_ckpt: benchmark.json with the pairs and finite
    metrics, serially and with --batch_pairs 2 --pipeline (the same
    detections in one batched pass a chunk)."""
    from sdn3d_tpu_torch.cli import edit_chain

    _, root, edit_json, shapenet = env
    _, _, _, ckpt = detectors
    _small_detector_cli(monkeypatch)
    common = ["--edit_json", edit_json, "--data_root", root,
              "--shapenet_root", shapenet, "--scales", "100",
              "--image_size", "64", "--render_size", "64",
              "--load_size", "160", "--fine_width", "160",
              "--fine_height", "48", "--device", "cpu", "--source",
              "maskrcnn", "--maskrcnn_ckpt", ckpt]
    for extra in ([], ["--batch_pairs", "2", "--pipeline"]):
        out = str(tmp_path / f"out{len(extra)}")
        res = edit_chain.main(common + ["--results_dir", out] + extra)
        with open(os.path.join(out, "benchmark.json")) as f:
            saved = json.load(f)
        assert saved["pairs"] == res["pairs"] == 2
        for k in ("mean_L1", "mean_LPIPS", "mean_SSIM", "mean_PSNR"):
            assert np.isfinite(saved[k]), k


DET_SPANS = ("stage.detect", "det.detect", "det.mold", "det.net",
             "det.unmold")
DET_COUNTS = ("count.det.nms_steps", "count.det.valid", "count.det.kept")


@pytest.mark.parametrize("mode", ["serial", "pipelined"])
def test_detection_spans_counters_and_dets(env, chains, detectors, mode):
    """Det-less requests, serially (edit_frame) and as one pipelined
    chunk: the detection's spans (`stage.detect` over `det.detect` over
    `det.mold`, `det.net`, `det.unmold`; in the chunk `stage.detect` sits
    inside stage A's `stage.geometric`) and counters (NMS steps, valid
    and kept detections, kept = the objects handed on), stage_s["detect"]
    the sum of its spans, and each result's "dets" what the chain
    detected.  Fed those dets back, a fresh chain records none of the
    detection's spans or counters, and gives the same result."""
    from tests.test_torch_chain import (SMALL48, _assert_same_pair,
                                        _profiled_log)

    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    _, _, tdet, _ = detectors
    requests = _det_requests(root, edit_json)

    def chain():
        c = _port_chain(tchain, **SMALL48)
        c.detector = tdet
        return c

    port = chain()
    outs = []
    if mode == "serial":
        log = _profiled_log(lambda: outs.extend(port.edit_frame(
            r["image_rgb"], operations=r["operations"],
            cache_key=r["cache_key"]) for r in requests))
        want = [chain().detect(r["image_rgb"]) for r in requests]
    else:
        log = _profiled_log(lambda: outs.extend(next(iter(
            port.edit_frames_pipelined([requests])))))
        want = chain().detect_missing(requests, [None] * len(requests))
    assert log["dropped"] == 0
    spans = log["spans"]
    by_sid = {s.sid: s for s in spans}
    assert set(DET_SPANS) <= {s.name for s in spans}
    for s in spans:
        if s.name in DET_SPANS[2:]:
            assert by_sid[s.parent].name == "det.detect", s
        elif s.name == "det.detect":
            assert by_sid[s.parent].name == "stage.detect", s
        elif s.name == "stage.detect":
            assert by_sid[s.parent].name == ("chain.request"
                                             if mode == "serial" else
                                             "stage.geometric"), s
    summed = sum(s.end_ns - s.start_ns for s in spans
                 if s.name == "stage.detect") / 1e9
    assert abs(port.stage_s["detect"] - summed) < 1e-3
    counts = log["counts"]
    assert all(counts.get(k, 0) > 0 for k in DET_COUNTS), counts
    assert counts["count.det.kept"] == sum(len(o["dets"][0]) for o in outs)
    assert counts["count.det.valid"] >= counts["count.det.kept"]
    for out, w in zip(outs, want):
        for a, b in zip(out["dets"], w):
            np.testing.assert_array_equal(a, b)

    again = chain()
    r = requests[0]
    log = _profiled_log(lambda: outs.append(again.edit_frame(
        r["image_rgb"], operations=r["operations"], dets=outs[0]["dets"],
        cache_key=r["cache_key"])))
    assert not {s.name for s in log["spans"]} & set(DET_SPANS)
    assert not [k for k in log["counts"] if k.startswith("count.det.")]
    assert "detect" not in again.stage_s
    assert outs[-1]["dets"] is outs[0]["dets"]
    _assert_same_pair(outs[-1], outs[0])
