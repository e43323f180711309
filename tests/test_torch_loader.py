"""The port's host loader and derender dataset selection
(sdn3d_tpu_torch.data.loader, data.select) against the JAX package's, on
the CPU: the same batches in the same order for one dataset and seed,
hybrid zero-fill, worker errors, shutdown, and the VKITTI training items
through select_derender_dataset and geometric_train --dataset vkitti."""

import threading
from itertools import islice

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data import loader as JL
from sdn3d_tpu.data import select as JS
from sdn3d_tpu_torch.data import loader as TL
from sdn3d_tpu_torch.data import select as TS
from sdn3d_tpu_torch.models.derenderer import TargetType


class _DS:
    def __init__(self, n, keys=("idx", "img"), fail_at=None):
        self.n, self.keys, self.fail_at = n, keys, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad item {i}")
        item = {"idx": np.asarray([i], np.int64),
                "img": np.full((4, 4), float(i), np.float32),
                "extra": np.full((2,), i + 0.5, np.float32)}
        return {k: item[k] for k in self.keys}


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == b[k].dtype, k


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batches_and_order_match_jax(shuffle, drop_last):
    """Three epochs of one loader (each reshuffled with seed + epoch),
    three workers: the batches and their order are JAX's."""
    kw = dict(batch_size=3, num_workers=3, shuffle=shuffle, seed=4,
              drop_last=drop_last)
    t, j = TL.PrefetchLoader(_DS(11), **kw), JL.PrefetchLoader(_DS(11), **kw)
    for _ in range(3):
        _same(list(t), list(j))


def test_hybrid_weighted_stream_zero_fills_like_jax():
    """A hybrid of two datasets with different key sets under its
    weighted sampler: the same weights (JAX data/kitti.hybrid_weights),
    the same index stream and the same zero-filled batches."""
    parts = [_DS(5, ("idx", "img")), _DS(3, ("idx", "extra"))]
    t_ds = TL.HybridDataset(parts, weights=[0.75, 0.25])
    j_ds = JL.HybridDataset(parts, weights=[0.75, 0.25])
    np.testing.assert_array_equal(t_ds.get_weights(), j_ds.get_weights())
    assert len(t_ds) == 8 and t_ds[6]["idx"][0] == 1
    t = TL.PrefetchLoader(t_ds, 4, sampler=TL.WeightedSampler(
        t_ds.get_weights(), seed=2), num_workers=2)
    j = JL.PrefetchLoader(j_ds, 4, sampler=JL.WeightedSampler(
        j_ds.get_weights(), seed=2), num_workers=2)
    got, want = list(islice(iter(t), 6)), list(islice(iter(j), 6))
    _same(got, want)
    # a row of the second part has "extra" > 0 and a zero-filled "img";
    # a row of the first part a zero-filled "extra"
    rows = [(b["extra"][r], b["img"][r]) for b in got if len(b) == 3
            for r in range(4)]
    second = [img for extra, img in rows if (extra > 0).all()]
    assert second and len(second) < len(rows)
    assert all(not img.any() for img in second)
    assert all(not extra.any() for extra, _ in rows if not (extra > 0).all())


def test_device_batches_are_the_host_batches():
    """device="cpu": the same batches as tensors (pinned host tensors and
    non-blocking copies are for a CUDA device)."""
    t = TL.PrefetchLoader(_DS(9), 3, num_workers=2, seed=1, device="cpu")
    h = TL.PrefetchLoader(_DS(9), 3, num_workers=2, seed=1)
    for a, b in zip(t, h):
        assert all(isinstance(v, torch.Tensor) for v in a.values())
        _same([{k: v.numpy() for k, v in a.items()}], [b])
    assert t.wait_s >= 0.0


def test_worker_error_is_raised_and_threads_end():
    """A worker's exception reaches the consumer (as JAX's: RuntimeError
    from the item's error) and every loader thread ends."""
    before = set(threading.enumerate())
    loader = TL.PrefetchLoader(_DS(12, fail_at=7), 2, num_workers=3,
                               shuffle=False)
    with pytest.raises(RuntimeError) as err:
        list(loader)
    assert isinstance(err.value.__cause__, ValueError)
    assert not set(threading.enumerate()) - before


def test_early_break_shuts_down():
    """Breaking out of an endless weighted stream after two batches joins
    the feeder, the workers and the orderer."""
    before = set(threading.enumerate())
    loader = TL.PrefetchLoader(_DS(6), 2, num_workers=3,
                               sampler=TL.WeightedSampler(np.ones(6)))
    for k, _ in enumerate(loader):
        if k == 1:
            break
    assert not set(threading.enumerate()) - before


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """A VKITTI root of data/synthetic.write_vkitti_root with frames in
    the train range of world 0001 (motgt rows that pass
    training_row_filter)."""
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root

    root = str(tmp_path_factory.mktemp("vk_train"))
    frames = {("0001", "clone", "00010"): [(180, 300, 260, 440),
                                           (200, 700, 300, 900)],
              ("0001", "clone", "00011"): [(150, 20, 220, 190)],
              ("0001", "fog", "00040"): [(170, 500, 240, 620),
                                         (160, 80, 230, 200)]}
    write_vkitti_root(root, frames, seed=5, height=300, width=1000)
    return root


def test_vkitti_branch_batches_match_jax(train_root):
    """select_derender_dataset("vkitti", full) of both packages on the
    same root: the same items, and one epoch through PrefetchLoader
    (batch 2, one worker: the ROI jitter draws from one random.Random in
    item order) gives equal batches, crops, masks, ignores and targets."""
    kw = dict(vkitti_root=train_root, is_train=True, image_size=64,
              render_size=48, seed=3)
    t_ds, t_s = TS.select_derender_dataset("vkitti", TargetType.full, **kw)
    j_ds, j_s = JS.select_derender_dataset("vkitti", TargetType.full, **kw)
    assert t_s is None and j_s is None and len(t_ds) == len(j_ds) == 5
    got = list(TL.PrefetchLoader(t_ds, 2, num_workers=1, seed=0))
    want = list(JL.PrefetchLoader(j_ds, 2, num_workers=1, seed=0))
    _same(got, want)
    assert got[0]["images"].shape == (2, 64, 64, 3)
    assert got[0]["masks"].shape == (2, 1, 48, 48)


def test_other_datasets_name_their_roadmap_item():
    """kitti and cityscapes (ported, ROADMAP A2): every mode the
    reference selects a dataset for asks for its root by flag when none
    is given; other combinations raise ValueError as in JAX."""
    for name, modes, flag in (
            ("kitti", ("pretrain", "extend"), "--kitti_object_root"),
            ("kitti", ("finetune",), "--kitti_semantics_root"),
            ("kitti", ("full",), "--kitti_object_root"),
            ("cityscapes", ("extend",), "--cityscapes_root"),
            ("cityscapes", ("full",), "--vkitti_root")):
        for m in modes:
            with pytest.raises(ValueError, match=flag):
                TS.select_derender_dataset(name, TargetType.BY_NAME[m])
    with pytest.raises(ValueError):
        TS.select_derender_dataset("cityscapes", TargetType.pretrain)
    with pytest.raises(ValueError):
        TS.select_derender_dataset("nuscenes", TargetType.full)
    with pytest.raises(ValueError):
        TS.select_derender_dataset("vkitti", TargetType.full)


def test_geometric_train_on_vkitti_items(train_root, tmp_path):
    """geometric_train --dataset vkitti --vkitti_root through the prefetch
    loader, 3 iterations of batch 2 over 5 items (a second loader epoch)
    in pretrain and full mode: finite losses, a step written; --dataset
    kitti on a root without labels raises (an epoch of no whole batch)
    instead of asking for epochs forever."""
    from sdn3d_tpu_torch.cli import geometric_train

    for mode in ("pretrain", "full"):
        state = geometric_train.main([
            "--dataset", "vkitti", "--vkitti_root", train_root, "--mode",
            mode, "--num_iters", "3", "--batch_size", "2", "--image_size",
            "32", "--render_size", "32", "--num_workers", "2", "--device",
            "cpu", "--ckpt_dir", str(tmp_path / mode)])
        assert state.step == 3
        assert torch.isfinite(state.mu).all() and state.nu.max() > 0
    with pytest.raises(ValueError, match="holds 0 items"):
        geometric_train.main(["--dataset", "kitti", "--kitti_object_root",
                              str(tmp_path), "--mode", "extend",
                              "--num_iters", "1",
                              "--device", "cpu",
                              "--ckpt_dir", str(tmp_path / "k")])
