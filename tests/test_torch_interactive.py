"""The port's editing library against the JAX package's, on the CPU:
pipelines/ablations (the 2D / 2D+ baselines), data/textural_cityscapes
(the ui_model demo's dataset), pipelines/interactive (every edit op, the
undo session, to_batch and style_forward through the port's generator),
utils/metrics_log and core/config."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_textural_cityscapes import H, W, make_fixture
from sdn3d_tpu import core as JC
from sdn3d_tpu.data import textural_cityscapes as JCS
from sdn3d_tpu.pipelines import ablations as JA
from sdn3d_tpu.pipelines import interactive as JI
from sdn3d_tpu.pipelines import textural as JT
from sdn3d_tpu.utils.metrics_log import MetricsLogger as JLogger
from sdn3d_tpu_torch import core as TC
from sdn3d_tpu_torch.data import textural_cityscapes as TCS
from sdn3d_tpu_torch.pipelines import ablations as TA
from sdn3d_tpu_torch.pipelines import interactive as TI
from sdn3d_tpu_torch.pipelines import textural as TT
from sdn3d_tpu_torch.utils.metrics_log import MetricsLogger as TLogger
from sdn3d_tpu_torch.utils.port import (encoder_state_dict_from_jax,
                                        global_generator_state_dict_from_jax)

# The pix2pixHD generator at the small widths from identical conditioning
# (ROADMAP's pix2pixHD bound).
GEN_ATOL = 1.7e-4


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _same_state(a, b):
    for f in ("label", "inst", "pose", "normal"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert sorted(a.feat_codes) == sorted(b.feat_codes)
    for k in a.feat_codes:
        assert a.feat_codes[k].tobytes() == b.feat_codes[k].tobytes(), k


def _ablation_case(seed, n, ops):
    rng = np.random.RandomState(seed)
    Hh, Ww = 60, 90
    rois = np.stack([rng.randint(0, 30, n), rng.randint(0, 50, n)], 1)
    rois = np.concatenate([rois, rois + rng.randint(8, 25, (n, 2))], 1)
    masks = (rng.rand(n, 1, Hh, Ww) > 0.4).astype(np.float32)
    c = (rois[:, :2] + rois[:, 2:]) / 2
    operations = []
    for i, kind in ops:
        op = {"type": kind, "from": {"u": str(c[i, 1] + 1.5),
                                     "v": str(c[i, 0] - 0.5)}}
        if kind == "modify":
            op.update({"to": {"u": str(c[i, 1] + 7)}, "zoom": "1.4",
                       "ry": str(0.3 * (i + 1))})
        operations.append(op)
    return (Hh, Ww), rng.randint(1, 3, n), masks, rois.astype(np.float32), \
        operations


@pytest.mark.parametrize("seed,n,ops", [
    (0, 3, [(0, "modify"), (2, "delete")]),
    (1, 2, [(0, "modify"), (1, "modify"), (0, "delete")]),
    (2, 4, [])])
def test_ablations_are_byte_equal(seed, n, ops):
    """edit_2d and edit_2d_plus: the instance map, the JSON and the
    interests byte-equal to JAX's (PIL bilinear masks), with more
    objects than operations, more operations than objects, and none."""
    args = _ablation_case(seed, n, ops)
    for j_fn, t_fn in ((JA.edit_2d, TA.edit_2d),
                       (JA.edit_2d_plus, TA.edit_2d_plus)):
        want, got = j_fn(*args), t_fn(*args)
        assert got["instance_map"].tobytes() == want["instance_map"].tobytes()
        assert got["interests"].tobytes() == want["interests"].tobytes()
        assert json.dumps(got["json_obj"]) == json.dumps(want["json_obj"])
    assert got["instance_map"].dtype == np.int32


@pytest.mark.parametrize("precomputed", [False, True])
def test_textural_cityscapes_items_are_byte_equal(tmp_path, precomputed):
    """The seeded-shuffle lists, every item (train crops and flips under
    several seeds, the val centre crop), the missing-instance fallback and
    `batch` byte-equal to JAX's on tests/test_textural_cityscapes.py's
    fixture."""
    root = str(tmp_path)
    make_fixture(root, precomputed=precomputed)
    kw = dict(load_size=W, fine_wh=(W, H))
    if precomputed:
        kw.update(segm_precomputed=os.path.join(root, "segm"),
                  inst_precomputed=os.path.join(root, "geo"),
                  pose_dir=os.path.join(root, "geo"),
                  normal_dir=os.path.join(root, "geo"))
    assert TCS.get_cityscapes_lists(root, "train") == \
        JCS.get_cityscapes_lists(root, "train")
    for load_size in (W, 96):
        kw["load_size"] = load_size
        jd, td = (m.TexturalCityscapesDataset(root, "train", **kw)
                  for m in (JCS, TCS))
        assert len(td) == len(jd) == 2
        for i in range(len(td)):
            for seed in (0, 1, 3):
                _same_item(td.__getitem__(i, np.random.RandomState(seed)),
                           jd.__getitem__(i, np.random.RandomState(seed)))
        _same_item(td.batch(np.random.RandomState(4), 2),
                   jd.batch(np.random.RandomState(4), 2))
        td.train = jd.train = False
        _same_item(td[1], jd[1])
    if precomputed:
        for name in os.listdir(os.path.join(root, "geo", "darmstadt")):
            if name.endswith(".png") and "normal" not in name:
                os.remove(os.path.join(root, "geo", "darmstadt", name))
        kw.pop("pose_dir")
        jd, td = (m.TexturalCityscapesDataset(root, "train", **kw)
                  for m in (JCS, TCS))
        _same_item(td.__getitem__(0, np.random.RandomState(0)),
                   jd.__getitem__(0, np.random.RandomState(0)))
    ids = np.arange(-1, 40).reshape(1, -1)
    assert TCS.ids_to_train_ids_shifted(ids).tobytes() == \
        JCS.ids_to_train_ids_shifted(ids).tobytes()
    assert TCS.pose_bins(12).tobytes() == JCS.pose_bins(12).tobytes()


def _edit_state(mod, seed=0, feat_num=5):
    """A load_state over a label / inst layout with two cars (band 3),
    class-level instances and a cluster table per class."""
    rng = np.random.RandomState(seed)
    label = rng.randint(1, 3, (48, 80)).astype(np.int32)
    label[:, 60:] = 4
    inst = label.copy()
    label[10:25, 10:35] = 3
    inst[10:25, 10:35] = 3001
    label[30:44, 40:70] = 3
    inst[30:44, 40:70] = 3002
    clusters = {c: rng.uniform(-1, 1, (5, feat_num)).astype(np.float32)
                for c in (1, 2, 3, 4)}
    pose = rng.randint(0, 25, (48, 80)).astype(np.int32)
    normal = rng.uniform(-1, 1, (48, 80, 3)).astype(np.float32)
    return mod.load_state(label, inst, clusters, pose=pose,
                          normal=normal), clusters


def test_every_interactive_op_matches_jax():
    """load_state, change_label, remove_object, add_object,
    transfer_style, the click label swap (to an instanced and to a
    class-level target), strokes (with and without a table), the object
    paste, the crop region, and the session's apply / undo / reset:
    every state byte-equal to JAX's; to_batch byte-equal."""
    js, clusters = _edit_state(JI)
    ts, _ = _edit_state(TI)
    _same_state(ts, js)
    region = np.zeros((48, 80), bool)
    region[5:15, 50:75] = True
    mask = np.zeros((12, 9), bool)
    mask[2:10, 1:8] = True
    ops = [("change_label", (region, 2), {}),
           ("remove_object", (3001,), {}),
           ("remove_object", (3002, 1), {}),
           ("add_object", (np.pad(mask, ((0, 36), (0, 71))), 3005, 3,
                           clusters[3][1]), {"pose_bin": 7}),
           ("transfer_style", (3002, clusters[3][4]), {}),
           ("change_labels_click", ((12, 12), (35, 50)), {}),
           ("change_labels_click", ((12, 12), (2, 2)), {}),
           ("add_strokes", ((3, 78), 4, 9), {}),
           ("add_strokes", ((46, 1), 2, 6),
            {"features_clustered": clusters, "cluster_idx": 3}),
           ("add_objects_click", ((40, 74), 3, mask, clusters),
            {"style_id": 2})]
    for name, args, kw in ops:
        _same_state(getattr(TI, name)(ts, *args, **kw),
                    getattr(JI, name)(js, *args, **kw))
    assert TI.stroke_region((48, 80), (47, 79), 7).tobytes() == \
        JI.stroke_region((48, 80), (47, 79), 7).tobytes()
    for m in (region, mask):
        assert TI.get_crop_region(m, 16) == JI.get_crop_region(m, 16)
    sessions = [mod.EditSession(s) for mod, s in ((TI, ts), (JI, js))]
    for sess, mod in zip(sessions, (TI, JI)):
        sess.apply(mod.change_labels_click, (12, 12), (35, 50))
        sess.apply(mod.add_strokes, (20, 20), 1, 5)
    _same_state(sessions[0].state, sessions[1].state)
    for op in ("undo", "reset"):
        for sess in sessions:
            getattr(sess, op)()
        _same_state(sessions[0].state, sessions[1].state)
    _same_state(sessions[0].state, ts)
    _same_item(TI.to_batch(ts, 8), JI.to_batch(js, 8))
    _same_item(TI.to_batch(TI.EditState(ts.label, ts.inst, {})),
               JI.to_batch(JI.EditState(js.label, js.inst, {})))


@pytest.fixture(scope="module")
def generators():
    """JAX's TexturalTrainer nets at SMALL_NET_OVERRIDES and the port's
    with the converted weights (tests/test_torch_textural.py's)."""
    cfg = JT.TexturalConfig(**JT.SMALL_NET_OVERRIDES)
    jt = JT.TexturalTrainer(cfg)
    pg = jax.tree_util.tree_map(np.asarray, jt.netG.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 48, 80, cfg.netG_input_nc))
    )["params"])
    pe = jax.tree_util.tree_map(np.asarray, jt.netE.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 48, 80, 3)))["params"])
    tt = TT.TexturalTrainer(TT.TexturalConfig(**TT.SMALL_NET_OVERRIDES))
    tt.load_state_dicts(
        global_generator_state_dict_from_jax(pg, cfg.n_downsample_global,
                                             cfg.n_blocks_global),
        encoder_state_dict_from_jax(pe, cfg.n_downsample_e))
    state = JT.TexturalState(step=jnp.zeros((), jnp.int32), params_g=pg,
                             params_d={}, params_e=pe, vgg={}, opt_g={},
                             opt_d={}, params_ge={})

    def j_generate(s):
        b = JI.to_batch(s, cfg.max_instances)
        feat = b.pop("feat_map")
        return np.asarray(jt.fake_inference_jit(
            state, {k: jnp.asarray(v) for k, v in b.items()},
            jnp.asarray(feat)))[0]

    return j_generate, TI.textural_generate(tt.to("cpu"))


def test_style_forward_matches_jax(generators):
    """style_forward's previews (4 style rows of the clicked car, cropped)
    and its commit (one full frame and the new state) through the port's
    generator, within GEN_ATOL of JAX's through its own."""
    j_gen, t_gen = generators
    js, clusters = _edit_state(JI, seed=1)
    ts, _ = _edit_state(TI, seed=1)
    want, j_state, j_crop = JI.style_forward(js, (15, 20), clusters, j_gen,
                                             crop_min=24)
    got, t_state, t_crop = TI.style_forward(ts, (15, 20), clusters, t_gen,
                                            crop_min=24)
    assert t_crop == j_crop and len(got) == len(want) == 4
    _same_state(t_state, j_state)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[2] == 3
        np.testing.assert_allclose(g, w, rtol=0, atol=GEN_ATOL)
    assert np.abs(got[0] - got[1]).max() > 1e-3      # the styles differ
    want, j_state, _ = JI.style_forward(js, (35, 50), clusters, j_gen,
                                        style_id=2)
    got, t_state, _ = TI.style_forward(ts, (35, 50), clusters, t_gen,
                                       style_id=2)
    _same_state(t_state, j_state)
    assert got[0].shape == (48, 80, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=GEN_ATOL)


def test_metrics_logger_and_configs_match_jax(tmp_path):
    """MetricsLogger's JSONL records (all but the wall time) equal to
    JAX's, no file without a log_dir; the config dataclasses' fields and
    defaults equal to JAX's and exported from core."""
    logs = []
    for cls, sub in ((TLogger, "t"), (JLogger, "j")):
        lg = cls(str(tmp_path / sub), name="train")
        lg.log(0, {"loss": np.float32(0.5), "acc": 1})
        lg.log(7, {"loss": torch.tensor(0.25)} if cls is TLogger
               else {"loss": 0.25})
        logs.append([{k: v for k, v in r.items() if k != "t"}
                     for r in lg.read_all()])
        assert os.path.basename(lg.path) == "train_metrics.jsonl"
        assert cls().read_all() == [] and cls().path is None
    assert logs[0] == logs[1] and len(logs[0]) == 2
    for name in ("RasterizerConfig", "RenderConfig", "DerenderConfig"):
        t, j = getattr(TC, name)(), getattr(JC, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)]
        with pytest.raises(dataclasses.FrozenInstanceError):
            t.image_size = 1
