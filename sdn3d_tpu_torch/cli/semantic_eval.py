"""Semantic branch evaluation CLI, PyTorch port (mirrors
semantic/vkitti_eval.py; JAX cli/semantic_eval.py): multi-scale inference
over the VKITTI test split, reporting per-class IoU, mean IoU and pixel
accuracy (vkitti_eval.py:50-107).  --ckpt_dir takes what semantic_test
--ckpt_dir takes (a core/checkpoint step directory, semantic_train's
included, or a torch file of the encoder's and decoder's state_dicts);
without it the weights are random, drawn from --seed.  The model computes
in float32 (the JAX parser has no --compute_dtype).  Runs on --device
(default cuda).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"),
                   required=False)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--num_class", type=int, default=14)
    p.add_argument("--scales", type=int, nargs="+",
                   default=[100, 150, 200, 300, 375])
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate at most N frames (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --ckpt_dir "
                        "is not given")
    return p


def main(argv=None):
    """Prints each frame's accuracy, then the per-class IoU, mean IoU and
    accuracy; returns {"iou", "mean_iou", "accuracy"} (accuracy in %)."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.semantic_test import load_model
    from sdn3d_tpu_torch.data import vkitti
    from sdn3d_tpu_torch.pipelines.semantic import (
        accuracy, intersection_and_union, multiscale_labels_fused)
    from sdn3d_tpu_torch.utils.profiling import AverageMeter

    args = build_argparser().parse_args(argv)
    if not args.data_root:
        raise ValueError("VKITTI_ROOT_DIR or --data_root required")
    model = load_model(args)
    device = next(model.parameters()).device

    table = vkitti.get_tables("segm", args.data_root)
    files = vkitti.get_lists("test")
    if args.limit:
        files = files[:args.limit]

    acc_meter = AverageMeter()
    inter_sum = np.zeros(args.num_class)
    union_sum = np.zeros(args.num_class)

    for i, f in enumerate(files):
        world, scene, _ = f.split("/")
        rgb = np.asarray(Image.open(os.path.join(
            args.data_root, "vkitti_1.3.1_rgb", f)).convert("RGB"))
        gt = vkitti.decode_scenegt(np.asarray(Image.open(os.path.join(
            args.data_root, "vkitti_1.3.1_scenegt", f)).convert("RGB")),
            world, scene, table)

        # JAX normalises on the host; the device pass applies the same
        # float32 operations to the uint8 frame
        pred = multiscale_labels_fused(model, rgb, scales=tuple(args.scales),
                                       device=device)
        acc, pix = accuracy(pred, gt)
        inter, union = intersection_and_union(pred, gt, args.num_class)
        acc_meter.update(acc, pix)
        inter_sum += inter
        union_sum += union
        print(f"[{i + 1}/{len(files)}] {f}: acc={acc:.4f}", flush=True)

    iou = inter_sum / (union_sum + 1e-10)
    for c, v in enumerate(iou):
        print(f"class [{c}], IoU: {v:.4f}")
    print(f"[Eval Summary]:\nMean IoU: {iou.mean():.4f}, "
          f"Accuracy: {acc_meter.average * 100:.2f}%")
    return {"iou": iou, "mean_iou": float(iou.mean()),
            "accuracy": acc_meter.average * 100}


if __name__ == "__main__":
    main()
