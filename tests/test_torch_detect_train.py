"""The port's Mask R-CNN training (sdn3d_tpu_torch.models.maskrcnn_train,
MaskRCNN.train_forward, pipelines.detect_train, cli.detect_train,
utils.port.maskrcnn_train_state_from_jax, utils.flops) against the JAX
package's, on the CPU, at the JAX tests' small configuration (128^2,
stage_sizes (1, 1, 1, 1), FPN 32, 100 -> 40 proposals, 12 RoIs, 14x14
masks; tests/test_detect_train.py:15): the same numpy inputs, JAX's
random weights converted, and JAX's uniform draws.

The weights are JAX's init with the last layers of the RPN, the
classifier and the mask head scaled by 1e-3 ("tamed"), so that no softmax
or sigmoid saturates and every loss has a gradient; the GT boxes are
three of JAX's own proposals, so that the sampled RoIs hold positives.
The JAX step is composed as its jitted train_step composes it: the
gradient of the summed losses (MaskRCNN.train_forward and the five
losses), then tx.update and apply_updates jitted together.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import maskrcnn as JM
from sdn3d_tpu.models import maskrcnn_train as JMT
from sdn3d_tpu.pipelines import detect_train as JDT
from sdn3d_tpu_torch.models import maskrcnn as TM
from sdn3d_tpu_torch.models import maskrcnn_train as TMT
from sdn3d_tpu_torch.pipelines import detect_train as TDT
from sdn3d_tpu_torch.utils.port import (maskrcnn_state_dict_from_jax,
                                        maskrcnn_train_state_from_jax)

SMALL = dict(image_min_dim=128, image_max_dim=128, num_classes=3,
             stage_sizes=(1, 1, 1, 1), fpn_channels=32, pre_nms_limit=100,
             post_nms_rois_training=40, train_rois_per_image=12,
             mask_shape=(14, 14), mask_pool_size=7,
             rpn_train_anchors_per_image=32)
JCFG = JM.MaskRCNNConfig(**SMALL)
TCFG = TM.MaskRCNNConfig(**SMALL)
G = 4                      # GT slots, three real
STAGES = ("transfer", "heads", "4+", "all")
TAMED = (("rpn", "conv_class"), ("rpn", "conv_bbox"),
         ("classifier", "linear_class"), ("classifier", "linear_bbox"),
         ("mask", "conv5"))

# Tolerances, measured values in brackets.  The training forward from the
# same inputs and weights, each package on its own stages (sums of the
# convolutions in other orders): relative to each output's largest entry
FORWARD_RTOL = 1e-5        # RPN logits / deltas, head logits / deltas [1.7e-6]
# with train_bn: BatchNorm on one frame's statistics (4x4 values a channel
# at C5) magnifies the convolutions' ulps
FORWARD_RTOL_BN = 1e-4     # [2.2e-5]
MASK_ATOL = 1e-5           # sigmoid masks [6e-8]
LOSS_RTOL = 1e-5           # each of the five losses [6e-7]
TARGET_DELTA_ATOL = 1e-5   # detection targets' deltas (normalised units)
# the sampled RoIs from each package's own proposals (normalised; the
# proposals' ulps, tests/test_torch_detect.py)
PROPOSAL_ATOL = 1e-6       # [6e-8]
# Gradients by label group, each group as one vector, error relative to
# its largest entry, against a float64 run of the port from the same
# inputs and targets: JAX's float32 at most GRAD_JAX_TOL off (the two
# packages compute the same function), the port's float32 at most
# GRAD_PORT_FACTOR x JAX's distance (or GRAD_FLOOR)
GRAD_JAX_TOL = 1e-4        # [5.5e-7; 3.4e-5 with train_bn]
GRAD_PORT_FACTOR = 3.0
GRAD_FLOOR = 1e-6          # port [4.4e-7; 6.3e-6 with train_bn]
# One / two steps of a stage from the same converted state, the port fed
# JAX's targets: each group's parameter update within UPDATE_RTOL of its
# largest entry, the traces alike; the frozen parameters bit-unchanged
UPDATE_RTOL = 1e-4         # [1.0e-5 update, 1.1e-6 trace]
# SGD (clip, decay, momentum) on equal gradients: parameters and traces
# within this many float32 ulps of optax's (of the largest operand of each
# update), without and with the clip (whose global norm the port sums over
# the group's flat gradient, XLA leaf by leaf)
SGD_ULPS = 2               # [0]
SGD_CLIP_ULPS = 6          # [4]


def _tame(v):
    v = jax.tree_util.tree_map(np.array, v)
    for head, name in TAMED:
        v["params"][head][name]["kernel"] *= np.float32(1e-3)
    return v


def _jax_loss(m, params, batch_stats, images, match, tb, gids, gb, gm, key,
              anchors, train_bn):
    """The JAX train step's loss_fn (pipelines/detect_train.py:137-177)."""
    variables = {"params": params, "batch_stats": batch_stats}
    if train_bn:
        out, mut = m.apply(variables, images, anchors, gids, gb, gm, key,
                           train_bn=True, method=JM.MaskRCNN.train_forward,
                           mutable=["batch_stats"])
        stats = mut["batch_stats"]
    else:
        out = m.apply(variables, images, anchors, gids, gb, gm, key,
                      method=JM.MaskRCNN.train_forward)
        stats = batch_stats
    tgt = out["targets"]
    losses = {
        "rpn_class_loss": JMT.rpn_class_loss(match, out["rpn_class_logits"]),
        "rpn_bbox_loss": JMT.rpn_bbox_loss(tb, match, out["rpn_bbox"]),
        "mrcnn_class_loss": JMT.mrcnn_class_loss(
            tgt["class_ids"], tgt["roi_valid"], out["mrcnn_class_logits"]),
        "mrcnn_bbox_loss": JMT.mrcnn_bbox_loss(
            tgt["deltas"], tgt["class_ids"], tgt["is_pos"],
            out["mrcnn_bbox"]),
        "mrcnn_mask_loss": JMT.mrcnn_mask_loss(
            tgt["masks"], tgt["class_ids"], tgt["is_pos"],
            out["mrcnn_masks"]),
    }
    return sum(losses.values()), (losses, stats, out)


def _draws(key, n):
    """detection_targets' two uniform draws from the step's key."""
    kp, kn = jax.random.split(key)
    return (np.array(jax.random.uniform(kp, (n,))),
            np.array(jax.random.uniform(kn, (n,))))


@pytest.fixture(scope="module")
def env():
    """JAX's tamed variables, the model, its jitted pieces, and one
    frame's inputs with three of its own proposals as the GT boxes."""
    m = JM.MaskRCNN(JCFG)
    anchors = np.asarray(JM.generate_pyramid_anchors(JCFG))
    v = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                        jnp.asarray(anchors), (0.0, 0.0, 128.0, 128.0))
    v = _tame(v)
    rs = np.random.RandomState(0)
    images = (rs.rand(2, 128, 128, 3) * 255 - 120).astype(np.float32)

    def props(mm, x, a):
        pyr = mm.fpn(x)
        _, probs, bbox = mm._rpn_forward(pyr)
        return JM.proposal_layer(probs[0], bbox[0], a, JCFG,
                                 JCFG.post_nms_rois_training)
    p, pv = jax.jit(lambda vv, x: m.apply(vv, x, jnp.asarray(anchors),
                                          method=props))(v, images[:1])
    p, pv = np.asarray(p), np.asarray(pv)
    assert pv.sum() >= 10
    pick = np.flatnonzero(pv)[[0, 4, 9]]
    gb = np.zeros((G, 4), np.float32)
    gb[:3] = p[pick]
    gids = np.asarray([1, 2, 1, 0], np.int32)
    gm = np.zeros((G, 28, 28), np.float32)
    for g in range(3):
        y0, x0 = rs.randint(0, 10, 2)
        gm[g, y0:y0 + 16, x0:x0 + 18] = 1.0
    np.random.seed(5)
    match, tb = JMT.build_rpn_targets(anchors, gb[:3] * 128.0, JCFG)
    grad = jax.jit(jax.grad(functools.partial(_jax_loss, m), has_aux=True),
                   static_argnames=("train_bn",))
    return dict(m=m, v=v, anchors=anchors, images=images, gids=gids, gb=gb,
                gm=gm, match=match, tb=tb, grad=grad)


def _jax_grads(env, params, batch_stats, key, train_bn=False, frame=0):
    e = env
    return e["grad"](params, batch_stats, e["images"][frame:frame + 1],
                     e["match"], e["tb"], e["gids"], e["gb"], e["gm"], key,
                     jnp.asarray(e["anchors"]), train_bn=train_bn)


def _port_inputs(env, frame=0, dtype=torch.float32):
    e = env
    x = torch.from_numpy(e["images"][frame:frame + 1]).permute(0, 3, 1, 2)
    return (x.to(dtype).contiguous(), torch.from_numpy(e["match"]),
            torch.from_numpy(e["tb"]).to(dtype), torch.from_numpy(e["gids"]),
            torch.from_numpy(e["gb"]), torch.from_numpy(e["gm"]))


def _port_model(variables):
    model = TM.MaskRCNN(TCFG)
    model.load_state_dict(maskrcnn_state_dict_from_jax(variables))
    return model


def _targets_np(tgt):
    return {k: np.asarray(v) for k, v in tgt.items()}


def _inject(monkeypatch, targets, dtype=torch.float32):
    """models.maskrcnn_train.detection_targets returns `targets` (JAX's,
    numpy), whatever it is given."""
    def given(*args, **kw):
        return {k: (torch.from_numpy(np.array(v)).to(dtype)
                    if np.asarray(v).dtype.kind == "f"
                    else torch.from_numpy(np.array(v)).long()
                    if np.asarray(v).dtype.kind in "iu"
                    else torch.from_numpy(np.array(v)))
                for k, v in targets.items()}
    monkeypatch.setattr(TMT, "detection_targets", given)


def _rel(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


# -- host targets and the detection targets ----------------------------------

@pytest.mark.parametrize("n_gt", [0, 3])
def test_build_rpn_targets_byte_equal(n_gt):
    """build_rpn_targets under the same global numpy seed: rpn_match and
    rpn_bbox byte-equal to JAX's (the balance draws included), with and
    without GT boxes."""
    anchors = np.asarray(JM.generate_pyramid_anchors(JCFG))
    rs = np.random.RandomState(n_gt)
    y, x = rs.randint(0, 90, (2, n_gt))
    gt = np.stack([y, x, y + rs.randint(8, 40, n_gt),
                   x + rs.randint(8, 40, n_gt)], 1).astype(np.float32)
    np.random.seed(11)
    want = JMT.build_rpn_targets(anchors, gt, JCFG)
    after = np.random.rand()
    np.random.seed(11)
    got = TMT.build_rpn_targets(anchors, gt, TCFG)
    assert np.random.rand() == after          # the same draws consumed
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if n_gt:
        assert (got[0] == 1).sum() >= 1


def _target_case(case):
    """(proposals, valid, gt_ids, gt_boxes, gt_masks, config kw) of a
    detection_targets case: "small" (JAX's test at T = 12), "33 positives"
    (T = 200, where the negatives' cap floor(33 / 0.33) is 67 in XLA's
    reciprocal product and 66 by true division), "no positives"."""
    rs = np.random.RandomState(7)
    P = 300
    props = np.zeros((P, 4), np.float32)
    # background proposals below the GT boxes
    y, x = 0.82 + rs.rand(P) * 0.1, rs.rand(P) * 0.9
    props[:] = np.stack([y, x, y + 0.02 + rs.rand(P) * 0.05,
                         x + 0.02 + rs.rand(P) * 0.08], 1)
    gt = np.asarray([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.8, 0.8],
                     [0, 0, 0, 0]], np.float32)
    ids = np.asarray([1, 2, 0], np.int32)
    kw = {}
    if case == "small":
        props[:5] = gt[0] + rs.uniform(-0.01, 0.01, (5, 4))
        props[5:10] = gt[1] + rs.uniform(-0.01, 0.01, (5, 4))
        kw = dict(train_rois_per_image=12, mask_shape=(8, 8))
    elif case == "33 positives":
        props[:33] = gt[np.arange(33) % 2] + rs.uniform(-0.01, 0.01, (33, 4))
        kw = dict(train_rois_per_image=200, mask_shape=(28, 28))
    else:
        gt[:2] = [[0.0, 0.0, 0.05, 0.05], [0.0, 0.5, 0.04, 0.6]]
        kw = dict(train_rois_per_image=12, mask_shape=(8, 8))
    valid = rs.rand(P) > 0.05
    if case == "33 positives":
        valid[:33] = True
    masks = (rs.rand(3, 16, 16) > 0.4).astype(np.float32)
    return props, valid, ids, gt, masks, kw


@pytest.mark.parametrize("case", ["small", "33 positives", "no positives"])
def test_detection_targets_on_jax_draws(case):
    """detection_targets given JAX's two uniform draws: rois, validity,
    positives and class ids equal to JAX's jitted targets; deltas within
    TARGET_DELTA_ATOL; the mask targets (rounded crops) equal."""
    props, valid, ids, gt, masks, kw = _target_case(case)
    jcfg = JM.MaskRCNNConfig(**kw)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *a: JMT.detection_targets(*a, key, jcfg))(
        props, valid, ids, gt, masks)
    want = _targets_np(want)
    got = TMT.detection_targets(
        torch.from_numpy(props), torch.from_numpy(valid),
        torch.from_numpy(ids), torch.from_numpy(gt), torch.from_numpy(masks),
        tuple(map(torch.from_numpy, _draws(key, len(props)))),
        TM.MaskRCNNConfig(**kw))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("rois", "roi_valid", "is_pos", "class_ids", "masks"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["deltas"], want["deltas"], rtol=0,
                               atol=TARGET_DELTA_ATOL)
    n_pos, n_ok = int(want["is_pos"].sum()), int(want["roi_valid"].sum())
    if case == "33 positives":
        assert (n_pos, n_ok) == (33, 100)    # 67 negatives, as XLA caps
    if case == "no positives":
        assert n_pos == 0 and n_ok == 0


def test_losses_match_jax():
    """The five losses on the same random inputs within LOSS_RTOL."""
    rs = np.random.RandomState(2)
    A, K, T, C = 500, 32, 12, 3
    match = rs.choice([-1, 0, 1], A, p=[0.3, 0.6, 0.1]).astype(np.int32)
    logits = rs.randn(A, 2).astype(np.float32) * 3
    pred = rs.randn(A, 4).astype(np.float32)
    tb = rs.randn(K, 4).astype(np.float32)
    cls = rs.randint(0, C, T).astype(np.int32)
    is_pos = (cls > 0) & (rs.rand(T) > 0.3)
    valid = is_pos | (rs.rand(T) > 0.5)
    clog = rs.randn(T, C).astype(np.float32) * 2
    deltas = rs.randn(T, 4).astype(np.float32)
    bbox = rs.randn(T, C, 4).astype(np.float32) * 2
    tmask = (rs.rand(T, 14, 14) > 0.5).astype(np.float32)
    pmask = rs.rand(T, C, 14, 14).astype(np.float32)
    want = [JMT.rpn_class_loss(match, logits),
            JMT.rpn_bbox_loss(tb, match, pred),
            JMT.mrcnn_class_loss(cls, valid, clog),
            JMT.mrcnn_bbox_loss(deltas, cls, is_pos, bbox),
            JMT.mrcnn_mask_loss(tmask, cls, is_pos,
                                np.moveaxis(pmask, 1, -1))]
    t = torch.from_numpy
    got = [TMT.rpn_class_loss(t(match), t(logits)),
           TMT.rpn_bbox_loss(t(tb), t(match), t(pred)),
           TMT.mrcnn_class_loss(t(cls), t(valid), t(clog)),
           TMT.mrcnn_bbox_loss(t(deltas), t(cls), t(is_pos), t(bbox)),
           TMT.mrcnn_mask_loss(t(tmask), t(cls), t(is_pos), t(pmask))]
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=LOSS_RTOL)


# -- the training forward -----------------------------------------------------

@pytest.mark.parametrize("train_bn", [False, True])
def test_train_forward_matches_jax(env, train_bn):
    """MaskRCNN.train_forward from the converted weights with JAX's draws:
    the sampled targets' rois, validity, positives, classes and masks
    equal to JAX's (deltas within TARGET_DELTA_ATOL), the RPN's and the
    heads' outputs within FORWARD_RTOL / MASK_ATOL, the losses within
    LOSS_RTOL; with train_bn the running statistics move as JAX's."""
    e = env
    key = jax.random.PRNGKey(1)
    (_, (losses, stats, out)) = _jax_grads(e, e["v"]["params"],
                                           e["v"]["batch_stats"], key,
                                           train_bn)
    model = _port_model(e["v"])
    x, match, tb, gids, gb, gm = _port_inputs(e)
    draws = tuple(map(torch.from_numpy, _draws(key, 40)))
    with torch.no_grad():
        got = model.train_forward(x, torch.from_numpy(e["anchors"]), gids,
                                  gb, gm, draws, train_bn=train_bn)
        got_losses = TMT.train_losses(got, match, tb)
    want_t = _targets_np(out["targets"])
    assert want_t["is_pos"].sum() >= (1 if train_bn else 3)
    for k in ("roi_valid", "is_pos", "class_ids", "masks"):
        np.testing.assert_array_equal(got["targets"][k].numpy(), want_t[k],
                                      err_msg=k)
    np.testing.assert_allclose(got["targets"]["rois"].numpy(),
                               want_t["rois"], rtol=0, atol=PROPOSAL_ATOL)
    np.testing.assert_allclose(got["targets"]["deltas"].numpy(),
                               want_t["deltas"], atol=TARGET_DELTA_ATOL)
    rtol = FORWARD_RTOL_BN if train_bn else FORWARD_RTOL
    for k, w in (("rpn_class_logits", out["rpn_class_logits"]),
                 ("rpn_bbox", out["rpn_bbox"]),
                 ("mrcnn_class_logits", out["mrcnn_class_logits"]),
                 ("mrcnn_bbox", out["mrcnn_bbox"])):
        assert _rel(got[k].numpy(), np.asarray(w)) <= rtol, k
    np.testing.assert_allclose(
        got["mrcnn_masks"].numpy(),
        np.moveaxis(np.asarray(out["mrcnn_masks"]), -1, 1), atol=MASK_ATOL)
    for k, w in losses.items():
        assert float(got_losses[k]) == pytest.approx(float(w),
                                                     rel=LOSS_RTOL), k
    sd = model.state_dict()
    want_sd = maskrcnn_state_dict_from_jax({"params": e["v"]["params"],
                                            "batch_stats": jax.tree_util.
                                            tree_map(np.asarray, stats)})
    for n in sd:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[n].numpy(), want_sd[n].numpy(),
                                       rtol=rtol, atol=1e-6, err_msg=n)


# -- labels ------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_layer_labels_match_jax(env, stage):
    """The label of every port parameter in `stage` is JAX _layer_label's
    of the parameter the converter maps it from (each JAX leaf filled
    with its own index, so the converted tensor names its source)."""
    flat = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: flat.setdefault(tuple(k.key for k in p), x),
        env["v"]["params"])
    paths = list(flat)
    ids = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, paths.index(tuple(k.key for k in p)),
                             np.float32), env["v"]["params"])
    sd = maskrcnn_state_dict_from_jax({"params": ids,
                                       "batch_stats": env["v"]["batch_stats"]})
    labels = TDT.layer_labels(TM.MaskRCNN(TCFG), stage)
    assert len(labels) == len(paths)
    seen = set()
    for name, label in labels.items():
        src = paths[int(sd[name].reshape(-1)[0])]
        seen.add(src)
        assert label == JDT._layer_label(src, stage), (name, src)
    assert len(seen) == len(paths)
    assert {"freeze", "train"} <= set(labels.values())


# -- gradients and steps ------------------------------------------------------

def _group_vectors(labels, named, groups=TDT.GROUPS):
    return {g: np.concatenate([np.asarray(named[n], np.float64).reshape(-1)
                               for n, lab in labels.items() if lab == g])
            for g in groups if g in labels.values()}


def _port_grads(env, variables, stage, targets, monkeypatch, dtype,
                train_bn=False):
    model = _port_model(variables).to(dtype)
    trainer = TDT.MaskRCNNTrainer(config=TCFG, stage=stage, device="cpu",
                                  train_bn=train_bn)
    state = trainer.init(model=model)
    _inject(monkeypatch, targets, dtype)
    x, match, tb, gids, gb, gm = _port_inputs(env, dtype=dtype)
    grads, losses = trainer.gradients(state, x, match, tb, gids, gb, gm,
                                      None, trainer.anchors.to(dtype))
    named = {n: g.numpy() for grp in TDT.GROUPS
             for n, g in zip(state.names(grp), grads[grp])}
    return state.labels, named, losses


@pytest.mark.parametrize("stage", ["transfer", "all"])
@pytest.mark.parametrize("train_bn", [False, True])
def test_gradients_by_group_against_float64(env, monkeypatch, train_bn,
                                            stage):
    """The summed losses' gradients in `stage` ("transfer": the heads'
    "train" group and the class layers' "transfer" group; "all": every
    parameter but the BatchNorms'), from the same inputs and JAX's
    targets, by label group: JAX's float32 within GRAD_JAX_TOL of a
    float64 run of the port, the port's float32 within GRAD_PORT_FACTOR x
    JAX's distance."""
    e = env
    grads, (_, _, out) = _jax_grads(e, e["v"]["params"],
                                    e["v"]["batch_stats"],
                                    jax.random.PRNGKey(1), train_bn)
    targets = _targets_np(out["targets"])
    jg = maskrcnn_state_dict_from_jax({
        "params": jax.tree_util.tree_map(np.asarray, grads),
        "batch_stats": e["v"]["batch_stats"]})
    labels, g64, _ = _port_grads(e, e["v"], stage, targets, monkeypatch,
                                 torch.float64, train_bn)
    _, g32, _ = _port_grads(e, e["v"], stage, targets, monkeypatch,
                            torch.float32, train_bn)
    ref = _group_vectors(labels, g64)
    for group, want in ref.items():
        err_jax = _rel(_group_vectors(labels, jg)[group], want)
        err_port = _rel(_group_vectors(labels, g32)[group], want)
        print(f"{stage} train_bn {train_bn} {group}: |g| max "
              f"{np.abs(want).max():.3e}, JAX float32 {err_jax:.3e}, port "
              f"float32 {err_port:.3e}")
        assert err_jax <= GRAD_JAX_TOL
        assert err_port <= max(GRAD_PORT_FACTOR * err_jax, GRAD_FLOOR)


def _optax_update(trainer):
    def upd(grads, opt_state, params):
        u, opt_state = trainer.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, u), opt_state
    return jax.jit(upd)


def _within_ulps(got, want, start):
    """The largest difference of got from want in float32 ulps of the
    largest operand of each element's update (the start, the result,
    their difference)."""
    got, want, start = (np.asarray(x, np.float64) for x in (got, want,
                                                              start))
    scale = np.maximum(np.maximum(np.abs(start), np.abs(want)),
                       np.abs(want - start)).astype(np.float32)
    return float(np.max(np.abs(got - want) / np.spacing(scale)))


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("stage", STAGES)
def test_sgd_update_matches_optax(env, stage, clipped):
    """apply_gradients on JAX's gradients against the JAX trainer's
    optax.multi_transform (per-group clip at 5, decay 1e-4 after it, SGD
    momentum 0.9; transfer at 1e-2; freeze untouched), two steps from a
    converted state: each parameter within SGD_ULPS ulps of the largest
    operand of its update, each trace within SGD_ULPS ulps of its group's
    largest entry, when no group clips (the gradients scaled by 1e-4);
    within SGD_CLIP_ULPS when every group clips (the group's global norm
    sums in another order); the frozen parameters bit-unchanged; labels
    equal."""
    e = env
    jt = JDT.MaskRCNNTrainer(config=JCFG, stage=stage)
    params = e["v"]["params"]
    opt = jt.tx.init(params)
    grads, _ = _jax_grads(e, params, e["v"]["batch_stats"],
                          jax.random.PRNGKey(1))
    upd = _optax_update(jt)
    fields = maskrcnn_train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": e["v"]["batch_stats"],
                     "opt_state": opt, "step": 0}))
    p0 = {k: v.clone() for k, v in fields["maskrcnn"].items()}
    model = TM.MaskRCNN(TCFG)
    tstate = TDT.DetectTrainState.from_fields(fields, model)
    trainer = TDT.MaskRCNNTrainer(config=TCFG, stage=stage, device="cpu")
    assert tstate.labels == TDT.layer_labels(model, stage)
    p = params
    for k in range(2):
        g = jax.tree_util.tree_map(
            lambda x: x * ((1.0 + k) * (1.0 if clipped else 1e-4)), grads)
        p, opt = upd(g, opt, p)
        named = maskrcnn_state_dict_from_jax({
            "params": jax.tree_util.tree_map(np.asarray, g),
            "batch_stats": e["v"]["batch_stats"]})
        tg = {grp: [named[n] for n in tstate.names(grp)]
              for grp in TDT.GROUPS}
        trainer.apply_gradients(tstate, tg)
    want = maskrcnn_train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": p, "batch_stats": e["v"]["batch_stats"],
                     "opt_state": opt, "step": 2}))
    got = tstate.fields()
    ulps = SGD_CLIP_ULPS if clipped else SGD_ULPS
    worst = 0.0
    for n, lab in tstate.labels.items():
        a, b = got["maskrcnn"][n].numpy(), want["maskrcnn"][n].numpy()
        if lab == "freeze":
            assert torch.equal(got["maskrcnn"][n], p0[n]), n
            continue
        worst = max(worst, _within_ulps(a, b, p0[n].numpy()))
    for group, want_t in want["opt_state"]["trace"].items():
        if not want_t:
            continue
        # a trace element is a sum of three terms that may cancel: its
        # ulps are the group's largest trace entry's
        t_got = np.concatenate([got["opt_state"]["trace"][group][n].numpy()
                                .reshape(-1) for n in want_t])
        t_want = np.concatenate([v.numpy().reshape(-1)
                                 for v in want_t.values()])
        worst = max(worst, float(np.abs(t_got - t_want).max()
                                 / np.spacing(np.abs(t_want).max())))
    print(f"{stage} clipped {clipped}: worst {worst:.2f} ulps")
    assert worst <= ulps
    assert got["opt_state"]["labels"] == want["opt_state"]["labels"]


@pytest.mark.parametrize("stage", STAGES)
def test_steps_match_jax(env, monkeypatch, stage):
    """One and two train steps of `stage` from a converted JAX state (the
    port fed JAX's targets of each step): the losses within LOSS_RTOL,
    each group's parameter update and trace within UPDATE_RTOL of their
    largest entries, the frozen parameters and the running statistics
    bit-unchanged."""
    e = env
    jt = JDT.MaskRCNNTrainer(config=JCFG, stage=stage)
    upd = _optax_update(jt)
    params, stats = e["v"]["params"], e["v"]["batch_stats"]
    opt = jt.tx.init(params)
    fields = maskrcnn_train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats,
                     "opt_state": opt, "step": 0}))
    p0 = {k: v.clone() for k, v in fields["maskrcnn"].items()}
    tstate = TDT.DetectTrainState.from_fields(fields, TM.MaskRCNN(TCFG))
    trainer = TDT.MaskRCNNTrainer(config=TCFG, stage=stage, device="cpu")
    x, match, tb, gids, gb, gm = _port_inputs(e)
    p = params
    for k in range(2):
        key = jax.random.PRNGKey(10 + k)
        grads, (losses, _, out) = _jax_grads(e, p, stats, key)
        p, opt = upd(grads, opt, p)
        _inject(monkeypatch, _targets_np(out["targets"]))
        tstate, got_losses = trainer.train_step(tstate, x, match, tb, gids,
                                                gb, gm, None)
        for name, w in losses.items():
            assert float(got_losses[name]) == pytest.approx(
                float(w), rel=LOSS_RTOL), (k, name)
        want = maskrcnn_train_state_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": p, "batch_stats": stats,
                         "opt_state": opt, "step": k + 1}))
        got = tstate.fields()
        assert int(got["step"]) == k + 1
        for group in want["opt_state"]["trace"]:
            names = tstate.names(group)
            if not names:
                continue
            d_got = np.concatenate([(got["maskrcnn"][n] - p0[n]).numpy()
                                    .reshape(-1) for n in names])
            d_want = np.concatenate([(want["maskrcnn"][n] - p0[n]).numpy()
                                     .reshape(-1) for n in names])
            t_got = np.concatenate([got["opt_state"]["trace"][group][n]
                                    .numpy().reshape(-1) for n in names])
            t_want = np.concatenate([want["opt_state"]["trace"][group][n]
                                     .numpy().reshape(-1) for n in names])
            print(f"{stage} step {k + 1} {group}: update "
                  f"{_rel(d_got, d_want):.3e}, trace "
                  f"{_rel(t_got, t_want):.3e}")
            assert _rel(d_got, d_want) <= UPDATE_RTOL
            assert _rel(t_got, t_want) <= UPDATE_RTOL
        for n, lab in tstate.labels.items():
            if lab == "freeze":
                assert torch.equal(got["maskrcnn"][n], p0[n]), n
        for n in got["maskrcnn"]:
            if n.endswith(("running_mean", "running_var")):
                assert torch.equal(got["maskrcnn"][n], p0[n]), n


def test_batched_step_per_frame_statistics(env):
    """train_step_batched with train_bn over two frames against the JAX
    batched step's semantics (make_train_step_batched vmaps the one-frame
    graph: each frame normalised by its own statistics, the losses and
    the running statistics meaned over the frames), composed from JAX's
    one-frame gradient: losses within LOSS_RTOL, running statistics within
    FORWARD_RTOL; normalising over the batch would move them further."""
    e = env
    stats = e["v"]["batch_stats"]
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    per_loss, per_stats = [], []
    draws = []
    for b in range(2):
        _, (losses, st, _) = _jax_grads(e, e["v"]["params"], stats, keys[b],
                                        train_bn=True, frame=b)
        per_loss.append(losses)
        per_stats.append(jax.tree_util.tree_map(np.asarray, st))
        draws.append(tuple(map(torch.from_numpy, _draws(keys[b], 40))))
    want_stats = jax.tree_util.tree_map(lambda *s: np.mean(np.stack(s), 0),
                                        *per_stats)
    model = _port_model(e["v"])
    trainer = TDT.MaskRCNNTrainer(config=TCFG, stage="heads", device="cpu",
                                  train_bn=True)
    state = trainer.init(model=model)
    ins = [_port_inputs(e, frame=b) for b in range(2)]
    x = torch.cat([i[0] for i in ins])
    rest = [torch.stack([i[k] for i in ins]) for k in range(1, 6)]
    state, losses = trainer.train_step_batched(state, x, *rest, draws)
    for k in per_loss[0]:
        want = np.mean([float(pl[k]) for pl in per_loss])
        assert float(losses[k]) == pytest.approx(want, rel=LOSS_RTOL), k
    want_sd = maskrcnn_state_dict_from_jax({"params": e["v"]["params"],
                                            "batch_stats": want_stats})
    sd = state.model.state_dict()
    both = _port_model(e["v"])
    with torch.no_grad(), TM.bn_mode(both, True):
        both.fpn(x)
    worst = 0.0
    for n in sd:
        if n.endswith(("running_mean", "running_var")) and n.startswith(
                "fpn"):
            np.testing.assert_allclose(sd[n].numpy(), want_sd[n].numpy(),
                                       rtol=FORWARD_RTOL, atol=1e-6,
                                       err_msg=n)
            worst = max(worst, _rel(both.state_dict()[n].numpy(),
                                    want_sd[n].numpy()))
    assert worst > 100 * FORWARD_RTOL


# -- schedule, state, CLI -----------------------------------------------------

def test_transfer_schedule_and_driver():
    """transfer_schedule equals JAX's; run_schedule drives the stages in
    order from epoch 38 with cumulative epochs and resets the optimizer
    state at each stage (JAX tests/test_detect_train.py's case)."""
    for inc in (True, False):
        assert TDT.transfer_schedule(inc, 2e-3) == JDT.transfer_schedule(
            inc, 2e-3)
    seen, resets = [], []

    @dataclasses.dataclass
    class Fake:
        stage: str
        learning_rate: float

        def init_opt(self, state):
            resets.append(self.stage)
            return state

    TDT.run_schedule(lambda stage, learning_rate: Fake(stage, learning_rate),
                     {}, epochs_run=38, include_transfer=True,
                     epoch_fn=lambda t, s, ep: seen.append((t.stage, ep))
                     or s)
    assert resets == ["heads", "4+", "all"]
    assert seen[0] == ("heads", 38) and seen[1] == ("heads", 39)
    assert seen[2] == ("4+", 40) and seen[31] == ("4+", 69)
    assert seen[32] == ("all", 70) and seen[-1] == ("all", 99)


def test_cli_final_save_and_no_steps(tmp_path):
    """cli.detect_train on the CPU (--small): the final save lands at the
    true epoch count (2 with --save_every 5), --num_iters 0 saves epoch 1
    without a step; the step's fields restore into a DetectTrainState
    whose labels are the stage's."""
    from sdn3d_tpu_torch.cli.detect_train import main
    from sdn3d_tpu_torch.core.checkpoint import latest_step, restore_checkpoint

    d = str(tmp_path / "ck")
    state = main(["--dataset", "synthetic", "--small", "--stage", "heads",
                  "--num_epochs", "2", "--num_iters", "1", "--save_every",
                  "5", "--ckpt_dir", d, "--device", "cpu"])
    assert latest_step(d) == 2 and state.step == 2
    fields, _ = restore_checkpoint(d)
    assert sorted(fields) == ["maskrcnn", "opt_state", "step"]
    back = TDT.DetectTrainState.from_fields(fields, TM.MaskRCNN(
        TM.MaskRCNNConfig(**SMALL)))
    assert back.labels == TDT.layer_labels(back.model, "heads")
    assert torch.equal(back.trace["train"], state.trace["train"])
    d0 = str(tmp_path / "ck0")
    state = main(["--dataset", "synthetic", "--small", "--stage", "heads",
                  "--num_epochs", "1", "--num_iters", "0", "--ckpt_dir", d0,
                  "--device", "cpu"])
    assert latest_step(d0) == 1 and state.step == 0


def _tamed_port_checkpoint(path, num_classes=3):
    """A reference-layout state_dict at the CLI's --small shapes with the
    RPN's, classifier's and mask head's last layers scaled by 1e-3."""
    model = TM.init_weights(TM.MaskRCNN(TM.MaskRCNNConfig(
        **dict(SMALL, num_classes=num_classes))), 0)
    sd = model.state_dict()
    for head, name in TAMED:
        sd[f"{head}.{name}.weight"] = sd[f"{head}.{name}.weight"] * 1e-3
    torch.save(sd, path)
    return path


def test_coco_ckpt_class_count(tmp_path, monkeypatch):
    """A checkpoint whose class layers have 81 classes (COCO's) and
    --num_classes 3: the port's CLI raises ValueError naming the class
    layers before any step; JAX's CLI loads it and raises flax's shape
    error at the first step (utils/port.port_maskrcnn given the --small
    stage sizes, which JAX's CLI does not pass)."""
    import flax

    from sdn3d_tpu.cli import detect_train as JCLI
    from sdn3d_tpu.utils import port as JP
    from sdn3d_tpu_torch.cli.detect_train import main

    ck = _tamed_port_checkpoint(str(tmp_path / "coco.pth"), num_classes=81)
    argv = ["--dataset", "synthetic", "--small", "--stage", "heads",
            "--num_iters", "1", "--num_epochs", "1", "--coco_ckpt", ck,
            "--ckpt_dir", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="81 classes"):
        main(argv + ["--device", "cpu"])
    monkeypatch.setattr(JP, "port_maskrcnn", functools.partial(
        JP.port_maskrcnn, stage_sizes=(1, 1, 1, 1)))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        JCLI.main(argv)


def test_trained_step_served_by_geometric_main(tmp_path, monkeypatch):
    """A step that cli.detect_train writes (--small, from a tamed
    --coco_ckpt, two steps of "heads") is served by cli.geometric_main
    --source maskrcnn --maskrcnn_ckpt on the CPU (MaskRCNNConfig at the
    CLI's --small shapes): the five-file contract of each item."""
    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.cli.detect_train import main
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    ck = str(tmp_path / "ck")
    main(["--dataset", "synthetic", "--small", "--stage", "heads",
          "--num_iters", "2", "--num_epochs", "1", "--coco_ckpt",
          _tamed_port_checkpoint(str(tmp_path / "start.pth")),
          "--ckpt_dir", ck, "--device", "cpu", "--lr", "1e-5"])
    v, f = make_sphere_mesh(6, 12)
    shapenet = str(tmp_path / "shapenet")
    for cls, obj in SHAPENET_CARS:
        d = os.path.join(shapenet, cls, obj, "models")
        os.makedirs(d)
        save_obj(os.path.join(d, "model_normalized.obj"), v, f)
    img = str(tmp_path / "frame.png")
    Image.fromarray((np.random.RandomState(0).rand(96, 128, 3) * 255)
                    .astype(np.uint8)).save(img)
    monkeypatch.setattr(TM, "MaskRCNNConfig", functools.partial(
        TM.MaskRCNNConfig, **dict(SMALL, detection_min_confidence=0.0,
                                  post_nms_rois_inference=50,
                                  detection_max_instances=10)))
    out = tmp_path / "out"
    geometric_main.main(["--input_image", img, "--shapenet_root", shapenet,
                         "--maskrcnn_ckpt", ck, "--output_dir", str(out),
                         "--image_size", "64", "--render_size", "64",
                         "--device", "cpu"])
    for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
        assert os.path.exists(out / f"frame{suffix}")
    inst = np.asarray(Image.open(out / "frame.png"))
    assert inst.shape == (96, 128)


# -- the deterministic crop backward and utils/flops --------------------------

def test_gather_rows_backward_in_order():
    """ops/roi_align.GatherRows: the gradient equals index_put_'s
    sequential CPU accumulation bit for bit, and float64 gradcheck."""
    from sdn3d_tpu_torch.ops.roi_align import GatherRows
    gather_rows = GatherRows.apply

    g = torch.Generator().manual_seed(0)
    table = torch.randn(40, 6, generator=g, requires_grad=True)
    idx = torch.randint(0, 40, (9, 5, 3), generator=g)
    cot = torch.randn(9, 5, 3, 6, generator=g)
    got, = torch.autograd.grad(gather_rows(table, idx), table, cot)
    want, = torch.autograd.grad(table[idx], table, cot)
    assert torch.equal(got, want)
    t64 = table.detach().double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx), (t64,))


def test_flops_peaks_by_name():
    """utils/flops: the card's own entry first, then the longest prefix
    (a PCIe card is not given the SXM part's peaks), None for another
    card; mfu_row's floor and share."""
    from sdn3d_tpu_torch.utils import flops

    sxm = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    assert sxm["float32"] == 67e12 and sxm["bfloat16"] == 989e12
    assert flops.peaks_for("NVIDIA H100 80GB HBM3") is sxm
    assert flops.peaks_for("NVIDIA H100 80GB HBM3 MIG 7g.80gb") is sxm
    assert flops.peaks_for("NVIDIA H100 PCIe") is flops.PEAKS[
        "NVIDIA H100 PCIe"]
    assert flops.peaks_for("NVIDIA A100-SXM4-80GB") is None
    assert flops.device_peaks() is None            # no card here
    row = flops.mfu_row(6.7e12, None, 0.5, peaks=sxm)
    assert row["floor_ms"] == pytest.approx(100.0)
    assert row["pct_peak_flops"] == pytest.approx(20.0)
    assert "pct_peak_flops" not in flops.mfu_row(1e9, None, 1.0)
    total, top = flops.count_flops(
        lambda: torch.ones(8, 16) @ torch.ones(16, 4))
    assert total == 2 * 8 * 16 * 4 and top[0][1] == total


def test_nan_roi_crops_match_jax():
    """pyramid_roi_align on boxes with a NaN coordinate (exp of a random
    delta overflowed, as from untrained weights at full width): zeros, as
    in the JAX package (whose NaN level selects no level); the other
    boxes' crops within 1e-6 of JAX's."""
    rs = np.random.RandomState(6)
    maps = [rs.randn(1, s, s, 8).astype(np.float32) for s in (32, 16, 8, 4)]
    y, x = rs.rand(2, 6) * 0.5
    boxes = np.stack([y, x, y + 0.05 + rs.rand(6) * 0.4,
                      x + 0.05 + rs.rand(6) * 0.4], 1).astype(np.float32)
    boxes[1, 2] = boxes[3] = boxes[4, 0] = np.nan
    want = np.moveaxis(np.asarray(jax.jit(
        lambda b, ms: JM.pyramid_roi_align(b, ms, 7, (128, 128, 3)))(
            boxes, maps)), -1, 1)
    feats = TM.RoiFeatures([torch.from_numpy(m).permute(0, 3, 1, 2)
                            for m in maps])
    got = TM.pyramid_roi_align(torch.from_numpy(boxes)[None], feats, 7,
                               (128, 128, 3)).numpy()
    assert (got[[1, 3, 4]] == 0).all() and (want[[1, 3, 4]] == 0).all()
    assert np.abs(got[[0, 2, 5]]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
