"""The port's KITTI and Cityscapes derender datasets (sdn3d_tpu_torch.
data.kitti, data.cityscapes, data.cityscapes_derender), their selection
by (dataset, mode) (data.select) and the dataset-root writers of
data.synthetic, against the JAX package's on the fixtures of
tests/test_geometric_datasets.py, and geometric_train over them on the
CPU.  Items are byte-equal: both packages crop through their native host
libraries (the same C++ source) and PIL, and draw ROI jitter from one
random.Random(seed) per selection."""

import os

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_geometric_datasets import (make_cityscapes_derender_fixture,
                                           make_kitti_object_fixture,
                                           make_kitti_semantics_fixture)
from sdn3d_tpu.data import cityscapes as JC
from sdn3d_tpu.data import kitti as JK
from sdn3d_tpu.data.select import select_derender_dataset as j_select
from sdn3d_tpu.models.derenderer import TargetType as JT
from sdn3d_tpu_torch.data import cityscapes as TCS
from sdn3d_tpu_torch.data import kitti as TK
from sdn3d_tpu_torch.data import synthetic as TSYN
from sdn3d_tpu_torch.data.loader import HybridDataset, WeightedSampler
from sdn3d_tpu_torch.data.select import select_derender_dataset as t_select
from sdn3d_tpu_torch.models.derenderer import TargetType

SIZES = dict(image_size=64, render_size=64)


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The JAX tests' fixtures (kitti object, kitti semantics, cityscapes)
    and a VKITTI root of data/synthetic.write_vkitti_root with two train
    frames of one car each, for the cityscapes-full hybrid."""
    d = tmp_path_factory.mktemp("roots")
    out = {k: str(d / k) for k in ("kitti", "ksem", "cs", "vk")}
    make_kitti_object_fixture(out["kitti"])
    make_kitti_semantics_fixture(out["ksem"])
    make_cityscapes_derender_fixture(out["cs"])
    TSYN.write_vkitti_root(out["vk"], {
        ("0001", "clone", "00000"): [(150, 300, 260, 480)],
        ("0001", "clone", "00001"): [(160, 600, 250, 760)]}, seed=0)
    return out


def _tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, root)] = f.read()
    return files


@pytest.mark.parametrize("writer,fixture", [
    (TSYN.write_kitti_object_root, make_kitti_object_fixture),
    (TSYN.write_kitti_semantics_root, make_kitti_semantics_fixture),
    (TSYN.write_cityscapes_derender_root, make_cityscapes_derender_fixture)])
def test_writers_write_the_fixtures_bytes(tmp_path, writer, fixture):
    """Each data/synthetic writer writes the same files, byte for byte,
    as the fixture of tests/test_geometric_datasets.py it stands for on
    the card (which has no JAX)."""
    writer(str(tmp_path / "port"))
    fixture(str(tmp_path / "jax"))
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and got == want


def test_label_calibration_and_targets_match_jax(roots):
    """label_2 and calib parsing and the pretrain targets of a KITTI
    object row; the Cityscapes label helpers."""
    path = os.path.join(roots["kitti"], "training", "label_2", "000000.txt")
    rows = TK.parse_label_file(path)
    assert rows == JK.parse_label_file(path)
    cal = os.path.join(roots["kitti"], "training", "calib", "000000.txt")
    cam = TK.parse_calib_file(cal)
    assert cam == JK.parse_calib_file(cal)
    _same_item(TK.kitti_targets(rows[0], cam), JK.kitti_targets(rows[0], cam))
    assert TK.semantics_instance_cat(6601) == JK.semantics_instance_cat(6601)
    ids = np.asarray([[26001, 24000], [26002, 7]])
    assert TCS.car_instances(ids) == JC.car_instances(ids) == [26001, 26002]
    np.testing.assert_array_equal(TCS.id_map_to_train_ids(ids % 1000 + 7),
                                  JC.id_map_to_train_ids(ids % 1000 + 7))
    np.testing.assert_array_equal(TCS.color_map(), JC.color_map())
    disp = np.random.RandomState(0).rand(16, 16).astype(np.float32)
    mask = (disp > 0.5).astype(np.float32)
    np.testing.assert_array_equal(TCS.disparity_ignore(disp, mask),
                                  JC.disparity_ignore(disp, mask))


@pytest.mark.parametrize("dataset,mode", [
    ("kitti", "pretrain"), ("kitti", "extend"), ("kitti", "finetune"),
    ("kitti", "full"), ("cityscapes", "full"), ("cityscapes", "extend")])
def test_select_rows_give_jax_items_in_jax_order(roots, tmp_path, dataset,
                                                 mode):
    """Every row of data/select.py that JAX's table has: the same dataset
    kinds, lengths and items, byte-equal, read in the same order (an
    interleaved order for the hybrids, so the one shared random.Random
    of the ROI jitter is drawn by both sources in turn), and for
    kitti-full the same weighted sampler stream.  Each package reads its
    own copy of the roots (the datasets write their per-frame caches
    beside the data)."""
    import shutil
    copies = {}
    for side in ("jax", "port"):
        copies[side] = {}
        for k, src in roots.items():
            dst = str(tmp_path / side / k)
            shutil.copytree(src, dst)
            copies[side][k] = dst

    def kw(side):
        r = copies[side]
        return dict(vkitti_root=r["vk"], kitti_object_root=r["kitti"],
                    kitti_semantics_root=r["ksem"], cityscapes_root=r["cs"],
                    seed=3, **SIZES)
    j_ds, j_smp = j_select(dataset, JT.BY_NAME[mode], **kw("jax"))
    t_ds, t_smp = t_select(dataset, TargetType.BY_NAME[mode], **kw("port"))
    assert len(t_ds) == len(j_ds) > 0
    assert isinstance(t_ds, HybridDataset) == (mode == "full")
    assert (t_smp is None) == (j_smp is None)
    n = len(t_ds)
    order = [i for pair in zip(range(n), reversed(range(n))) for i in pair]
    for i in order + order:
        _same_item(t_ds[i], j_ds[i])
    if t_smp is not None:
        assert isinstance(t_smp, WeightedSampler)
        np.testing.assert_array_equal(t_ds.get_weights(), j_ds.get_weights())
        a, b = iter(t_smp), iter(j_smp)
        assert [next(a) for _ in range(40)] == [next(b) for _ in range(40)]
    if dataset == "cityscapes" and mode == "full":
        np.testing.assert_array_equal(t_ds.get_weights(), j_ds.get_weights())


def test_select_refuses_rows_jax_lacks(roots):
    """A mode the table has no row for raises ValueError, as in JAX."""
    with pytest.raises(ValueError):
        t_select("kitti", TargetType.normal,
                 kitti_object_root=roots["kitti"])
    with pytest.raises(ValueError):
        t_select("cityscapes", TargetType.pretrain,
                 cityscapes_root=roots["cs"])
    with pytest.raises(ValueError):
        t_select("kitti", TargetType.extend)


@pytest.mark.parametrize("dataset,mode,flags", [
    ("kitti", "extend", ["--kitti_object_root"]),
    ("cityscapes", "extend", ["--cityscapes_root"]),
    ("kitti", "full", ["--kitti_object_root", "--kitti_semantics_root"])])
def test_geometric_train_runs_on_the_datasets(roots, tmp_path, dataset, mode,
                                              flags):
    """cli/geometric_train for 2 steps on the CPU over each dataset (the
    extend rows, and kitti-full's weighted hybrid): finite losses and a
    step written that holds the derenderer."""
    from sdn3d_tpu_torch.cli.geometric_train import main
    from sdn3d_tpu_torch.core.checkpoint import latest_step, restore_variables

    where = {"--kitti_object_root": "kitti", "--kitti_semantics_root": "ksem",
             "--cityscapes_root": "cs"}
    argv = ["--mode", mode, "--dataset", dataset, "--batch_size", "2",
            "--image_size", "64", "--render_size", "64", "--num_iters", "2",
            "--num_workers", "1", "--save_every", "2", "--device", "cpu",
            "--ckpt_dir", str(tmp_path / "ck")]
    for f in flags:
        argv += [f, roots[where[f]]]
    state = main(argv)
    assert state.step == 2 and latest_step(str(tmp_path / "ck")) == 2
    nets, _ = restore_variables(str(tmp_path / "ck"), ["derenderer"])
    assert all(np.isfinite(v.numpy()).all() for v in nets["derenderer"].values()
               if v.is_floating_point())
