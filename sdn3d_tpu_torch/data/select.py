"""Derenderer training dataset selection by (dataset, mode).

PyTorch counterpart of sdn3d_tpu/data/select.py, itself a re-expression
of geometric/derender3d/data_loader.py:43-82: the reference's DataLoader
picks the dataset class (and, for kitti-full, a WeightedRandomSampler
over the hybrid concat) from the --dataset flag and the TargetType mode.
Returns (dataset, sampler-or-None); feed both to data.loader.
PrefetchLoader (whose zero-fill collate handles the hybrid datasets'
heterogeneous key sets, data_loader.py:17-40).
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

from sdn3d_tpu_torch.data.loader import HybridDataset, WeightedSampler
from sdn3d_tpu_torch.models.derenderer import TargetType


def select_derender_dataset(
    dataset: str,
    mode: int,
    vkitti_root: Optional[str] = None,
    kitti_object_root: Optional[str] = None,
    kitti_semantics_root: Optional[str] = None,
    cityscapes_root: Optional[str] = None,
    is_train: bool = True,
    image_size: int = 224,
    render_size: int = 256,
    seed: int = 0,
) -> Tuple[object, Optional[WeightedSampler]]:
    """(dataset name, TargetType mode) -> (dataset, sampler).

    The selection of data_loader.py:43-82:
      vkitti, any mode          -> VKitti
      kitti, pretrain | extend  -> KittiObject
      kitti, finetune           -> KittiSemantics
      kitti, full               -> KittiObject + KittiSemantics hybrid,
                                   WeightedRandomSampler over get_weights()
      cityscapes, full          -> VKitti + CityscapesSemantics hybrid
                                   (weights 0.75 / 0.25, datasets.py:1115-1123)
      cityscapes, extend        -> CityscapesSemantics
    Every dataset of one call draws its ROI jitter from one
    random.Random(seed), in the order their items are read (JAX
    data/select.py:44); a mode the table has no row for raises
    ValueError.
    """
    jit_rng = random.Random(seed)

    def need(root, flag):
        if not root:
            raise ValueError(f"{flag} required")

    def vkitti():
        from sdn3d_tpu_torch.data.vkitti_derender import VKittiDerenderDataset
        need(vkitti_root, "--vkitti_root")
        return VKittiDerenderDataset(vkitti_root, is_train=is_train,
                                     image_size=image_size,
                                     render_size=render_size,
                                     jitter_rng=jit_rng)

    def kitti_object():
        from sdn3d_tpu_torch.data.kitti import KittiObjectDataset
        need(kitti_object_root, "--kitti_object_root")
        return KittiObjectDataset(kitti_object_root, is_train=is_train,
                                  image_size=image_size)

    def kitti_semantics():
        from sdn3d_tpu_torch.data.kitti import KittiSemanticsDataset
        need(kitti_semantics_root, "--kitti_semantics_root")
        return KittiSemanticsDataset(kitti_semantics_root,
                                     is_train=is_train,
                                     image_size=image_size,
                                     render_size=render_size,
                                     jitter_rng=jit_rng)

    def cityscapes_semantics():
        from sdn3d_tpu_torch.data.cityscapes_derender import \
            CityscapesSemanticsDataset
        need(cityscapes_root, "--cityscapes_root")
        return CityscapesSemanticsDataset(cityscapes_root,
                                          is_train=is_train,
                                          image_size=image_size,
                                          render_size=render_size,
                                          jitter_rng=jit_rng)

    if dataset == "vkitti":
        return vkitti(), None
    if dataset == "kitti":
        if mode in (TargetType.pretrain, TargetType.extend):
            return kitti_object(), None
        if mode == TargetType.finetune:
            return kitti_semantics(), None
        if mode == TargetType.full:
            ds = HybridDataset([kitti_object(), kitti_semantics()])
            return ds, WeightedSampler(ds.get_weights(), seed=seed)
        raise ValueError(f"kitti has no dataset for mode {mode}")
    if dataset == "cityscapes":
        if mode == TargetType.full:
            return HybridDataset([vkitti(), cityscapes_semantics()],
                                 weights=[0.75, 0.25]), None
        if mode == TargetType.extend:
            return cityscapes_semantics(), None
        raise ValueError(f"cityscapes has no dataset for mode {mode}")
    raise ValueError(f"unknown dataset {dataset!r}")
