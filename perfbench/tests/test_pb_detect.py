"""The detector's cell, chain_maskrcnn.fresh: its four readers on planted
spans and counters; its driver and check (detect_ref) through whole runs
at tiny sizes on the CPU (the detector at tests/test_torch_detect.py's
small configuration, keeping 50 detections as
tests/test_torch_chain_maskrcnn.py does, so that frames give objects),
which read 0 where the program runs as it is and
`correct` false under planted faults; on a card, at the cell's own size,
the TF32 control and every planted fault; and the plain reference's
imports."""

import ast
import copy
import os
import time

import pytest

from perfbench.harness import discovery
from perfbench.tests import tiny
from perfbench.tests.test_pb_spans import DEVICE, SPANS, log
from sdn3d_tpu_torch.utils.phases import Span

CELL = "chain_maskrcnn.fresh"
TINY_DETECTOR = dict(image_min_dim=128, image_max_dim=128,
                     rpn_anchor_scales=[8, 16, 32, 64, 128],
                     pre_nms_limit=200, post_nms_rois_inference=50,
                     detection_min_confidence=0.0,
                     detection_max_instances=50, stage_sizes=[1, 1, 1, 1])
# the planted stage.detect spans: idle [10, 12) and [20, 25) of DEVICE's
# gaps fall under them, inside stage.semantic (8, 25)
DETECT = [Span("stage.detect", 10, 12, 7, 2, 1),
          Span("stage.detect", 20, 25, 8, 2, 1)]
DET_COUNTS = {"count.det.nms_steps": 24, "count.det.valid": 30,
              "count.det.kept": 14}


def _reader(name):
    return discovery.metric_reader(name)


def _trace(counts=DET_COUNTS, spans=SPANS + DETECT, phases=None):
    from perfbench.harness import spans as S
    t = {"device_events": DEVICE, "units_prof": 2, "units_phase": 4,
         "phases": phases or {}}
    lg = log(spans)
    lg["counts"].update(counts)
    S.idle(t, lg)
    return t


def test_readers_on_planted_spans_and_counters():
    """Two pairs: idle 2 + 5 ns under stage.detect (the innermost span),
    24 NMS steps, 14 kept objects; the phase slice's det.detect seconds
    over its 4 pairs (the inner det.* phases not added again)."""
    phases = {"det.detect": {"s": 0.4, "calls": 4},
              "det.mold": {"s": 0.1, "calls": 4},
              "det.net": {"s": 0.1, "calls": 4},
              "det.unmold": {"s": 0.2, "calls": 4},
              "sem.infer": {"s": 1.0, "calls": 4}}
    t = _trace(phases=phases)
    assert _reader("detect_idle_ms.edit").read(t) == pytest.approx(7 / 2e6)
    assert _reader("nms_steps.edit").read(t) == 12.0
    assert _reader("detections_per_frame.edit").read(t) == 7.0
    assert _reader("detect_ms.edit").read(t) == pytest.approx(100.0)
    assert _reader("semantic_idle_ms.edit").read(t) == pytest.approx(0.0)


@pytest.mark.parametrize("name", ["detect_idle_ms.edit", "nms_steps.edit",
                                  "detections_per_frame.edit",
                                  "detect_ms.edit"])
def test_readers_report_nothing_without_a_detection(name):
    """A program that brought its objects (chain_gt), or one without the
    spans and counters: no value, no error."""
    t = _trace(counts={}, spans=SPANS)
    assert _reader(name).read(t) is None


def tiny_cell(device="cpu", shrink=True):
    """The cell at tiny.cell's sizes, its detector at TINY_DETECTOR
    (unless `shrink` is false)."""
    c = copy.deepcopy(tiny.cell(CELL, device=device, shrink=shrink))
    if shrink:
        c["config"]["detector"].update(TINY_DETECTOR)
    return c


def _run(cell, seed=2**31 + 7, control=False):
    drv = discovery.driver(cell["config"]["driver"])
    return drv.run(cell, seed=seed, seconds=1.0, trace=False,
                   t_start=time.perf_counter(), control=control)


def test_cell_reads_zero():
    """The program against the reference at tiny sizes on the CPU: every
    number but the mask head's reads 0 (maskrcnn_ref's docstring says
    why that one may not), and every request handed on objects."""
    out = _run(tiny_cell())
    assert out["attempted"] > 0
    assert out["correct"], out["checks"]
    for k, (v, _) in out["checks"].items():
        if k not in ("det_mask_gap", "dets_mask_mismatch"):
            assert v == 0.0, (k, v)
    assert out["readings"]["objects_min"] > 0


@pytest.mark.parametrize("fault,number", [
    ("level_dropped", "det_pyramid_gap"),
    ("plane_swapped", "det_mask_gap")])
def test_fault_makes_the_run_incorrect(fault, number):
    """Faults planted in the program's detector underneath a run
    (perfbench/calibrate_detect.py): `correct` false, by the number that
    holds the stage.  (The RPN's NMS at 0.6 moves no proposal at this
    size: tests/test_torch_maskrcnn_ref.py; the card test below plants
    it at the cell's own size.)"""
    from perfbench.calibrate_detect import FAULTS
    with FAULTS[fault]():
        out = _run(tiny_cell())
    assert not out["correct"], out["checks"]
    value, limit = out["checks"][number]
    assert value > limit


def test_a_program_without_dets_stops_at_once():
    """A program whose edit_frame hands back no "dets" (a port older
    than this cell) stops at the warm-up's first request."""
    from sdn3d_tpu_torch.pipelines.chain import EditChain
    real = EditChain.edit_frame

    def edit_frame(self, *a, **kw):
        out = real(self, *a, **kw)
        out.pop("dets")
        return out

    EditChain.edit_frame = edit_frame
    try:
        with pytest.raises(RuntimeError, match="no 'dets'"):
            _run(tiny_cell())
    finally:
        EditChain.edit_frame = real


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "level_dropped", "rpn_nms_loose",
                                   "plane_swapped"])
def test_control_and_faults_fail_on_a_card(fault):
    """At the cell's own size on a card: the TF32 control fails at least
    one detector number while the program passes all (fault None), and
    each planted fault makes the run incorrect by a detector number.
    The card is looked for inside the test; without one it skips."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.calibrate_detect import FAULTS
    from perfbench.reference import detect_ref
    cell = tiny_cell(device="cuda", shrink=False)
    if fault is None:
        out = _run(cell, seed=101, control=True)
        assert out["correct"], out["checks"]
        assert any(out["control"][k] > lim
                   for k, (_, lim) in out["checks"].items()
                   if k in detect_ref.CHECKS), out["control"]
        return
    with FAULTS[fault]():
        out = _run(cell, seed=101)
    assert any(v > lim for k, (v, lim) in out["checks"].items()
               if k in detect_ref.CHECKS), out["checks"]


def test_reference_imports_nothing_of_the_packages():
    """maskrcnn_ref.py imports no module of sdn3d_tpu, sdn3d_tpu_torch or
    JAX (top-level names compared whole), and turns TF32 off."""
    import torch

    from perfbench.reference import maskrcnn_ref
    path = maskrcnn_ref.__file__
    tops = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"sdn3d_tpu", "sdn3d_tpu_torch", "jax", "jaxlib",
                       "flax"}, tops
    assert os.path.dirname(path).endswith(os.path.join("perfbench",
                                                       "reference"))
    maskrcnn_ref.no_tf32(True)
    maskrcnn_ref.no_tf32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _dets(boxes, cls, scores):
    import numpy as np
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "class_ids": np.asarray(cls), "scores": np.asarray(scores,
                                                              np.float32)}


A = [10, 10, 50, 50]
B = [100, 100, 140, 180]
# IoU (pixel-inclusive) of [10, 10, 50, 50] and [10, 10, 50, 50 + w]: 41 *
# 41 / (41 * (41 + w)) = 41 / (41 + w); at w = 95.667 it is 0.3
NEAR_03 = [10, 10, 50, 50 + 41 / 0.3 - 41]


@pytest.mark.parametrize("got,want,lone,kinds", [
    (_dets([A, B], [1, 1], [0.9, 0.8]), _dets([A, B], [1, 1], [0.9, 0.8]),
     0, {}),
    (_dets([A, B], [1, 1], [0.9, 0.700001]), _dets([A], [1], [0.9]),
     1, {"score_tie": 1}),
    (_dets([A, NEAR_03], [1, 1], [0.9, 0.8]), _dets([A], [1], [0.9]),
     1, {"nms_tie": 1}),
    (_dets([A, B], [1, 1], [0.9, 0.8]), _dets([A], [1], [0.9]), 1, {}),
    (_dets([A, B], [1, 2], [0.9, 0.8]), _dets([A, B], [1, 1], [0.9, 0.8]),
     2, {})], ids=["equal", "score tie", "nms tie", "no tie", "class"])
def test_detection_ties(got, want, lone, kinds):
    """Unpaired detections, and those detect_ref admits by the tie that
    explains them: a score at the 0.7 floor, an IoU at the NMS's 0.3
    with a higher-scoring detection of the class on the other side."""
    from perfbench.reference import detect_ref as D
    cfg = {"detection_min_confidence": 0.7, "detection_nms_threshold": 0.3}
    pairs = D.pair(got["boxes"], got["class_ids"], want["boxes"],
                   want["class_ids"])
    n, found = D._detection_ties(cfg, got, want, pairs, rpn_tie=False)
    assert n == lone
    assert {k: v for k, v in found.items() if v} == kinds


def test_proposal_ties():
    """An RPN flip at an IoU of 0.7 is admitted, with the proposal it
    pushes past the cut at the other list's tail; a proposal that no tie
    explains is not."""
    import numpy as np

    from perfbench.reference import detect_ref as D
    dim = 100.0
    # [0, 0, 40, 40 + w] against [0, 0, 40, 40]: 41 / (41 + w) = 0.7
    tie = [0, 0, 40, 40 + 41 / 0.7 - 41]
    far = [[60, 60, 70, 70], [80, 80, 90, 90]]
    want = np.asarray([[0, 0, 40, 40], far[0]]) / dim
    got = np.asarray([[0, 0, 40, 40], tie]) / dim
    assert D._proposal_ties(got, want, dim, 0.7) == (2, 2)
    got = np.asarray([[0, 0, 40, 40], far[1]]) / dim
    assert D._proposal_ties(got, want, dim, 0.7) == (2, 0)


def _objects(areas):
    """(class_ids, masks [N, 1, 1, 64], rois) of objects whose masks set
    `areas` pixels each."""
    import numpy as np
    masks = np.zeros((len(areas), 1, 1, 64), np.float32)
    for m, a in zip(masks, areas):
        m[0, 0, :a] = 1.0
    return np.ones(len(areas), np.int32), masks, np.zeros((len(areas), 4))


@pytest.mark.parametrize("used,ref,cap_n,want", [
    ([9, 7, 5], [9, 7, 5], 3, (0, 0)),
    ([9, 7, 5], [9, 7, 4], 3, (2, 0)),
    ([9, 7, 5], [9, 7, 5], 4, (2, 0)),
    ([9, 7, 5], [9, 7, 5], 3, (2, 2))],
    ids=["paired", "areas differ", "cap did not cut", "exact tie"])
def test_object_ties(used, ref, cap_n, want):
    """An unpaired object is admitted at the cap only where its side's cap
    cut (cap_n objects kept) and its area equals the smallest the other
    side kept; the pairs are given (the last object of each side unpaired
    in every case but the first), so the masks' mismatch plays no part."""
    from perfbench.reference import detect_ref as D
    pairs = [(0, 0), (1, 1)] + ([(2, 2)] if want == (0, 0) else [])
    assert D._object_ties(_objects(used), _objects(ref), pairs,
                          cap_n) == want
