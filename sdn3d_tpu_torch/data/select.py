"""Derenderer training dataset selection by (dataset, mode).

PyTorch counterpart of sdn3d_tpu/data/select.py, itself a re-expression
of geometric/derender3d/data_loader.py:43-82: the reference's DataLoader
picks the dataset class (and, for kitti-full, a WeightedRandomSampler
over the hybrid concat) from the --dataset flag and the TargetType mode.
Returns (dataset, sampler-or-None); feed both to data.loader.
PrefetchLoader.  The VKITTI branch is ported; the KITTI and Cityscapes
datasets (JAX data/kitti.py, data/cityscapes_derender.py) are ROADMAP A9,
and their branches raise NotImplementedError.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

from sdn3d_tpu_torch.data.loader import WeightedSampler
from sdn3d_tpu_torch.models.derenderer import TargetType


def _not_ported(name: str):
    raise NotImplementedError(
        f"the {name} derender dataset is not ported yet (ROADMAP A9: "
        "data/kitti.py, data/cityscapes_derender.py)")


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
      vkitti, any mode          -> VKitti (ROI jitter from
                                   random.Random(seed))
      kitti, pretrain | extend  -> KittiObject
      kitti, finetune           -> KittiSemantics
      kitti, full               -> KittiObject + KittiSemantics hybrid,
                                   WeightedRandomSampler over get_weights()
      cityscapes, full          -> VKitti + CityscapesSemantics hybrid
                                   (weights 0.75 / 0.25, datasets.py:1115-1123)
      cityscapes, extend        -> CityscapesSemantics
    The kitti and cityscapes rows raise NotImplementedError (A9); a mode
    the table has no row for raises ValueError, as in JAX.
    """
    if dataset == "vkitti":
        from sdn3d_tpu_torch.data.vkitti_derender import VKittiDerenderDataset
        if not vkitti_root:
            raise ValueError("--vkitti_root required")
        return VKittiDerenderDataset(vkitti_root, is_train=is_train,
                                     image_size=image_size,
                                     render_size=render_size,
                                     jitter_rng=random.Random(seed)), None
    if dataset == "kitti":
        if mode in (TargetType.pretrain, TargetType.extend,
                    TargetType.finetune, TargetType.full):
            _not_ported("kitti")
        raise ValueError(f"kitti has no dataset for mode {mode}")
    if dataset == "cityscapes":
        if mode in (TargetType.full, TargetType.extend):
            _not_ported("cityscapes")
        raise ValueError(f"cityscapes has no dataset for mode {mode}")
    raise ValueError(f"unknown dataset {dataset!r}")
