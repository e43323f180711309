"""Mask R-CNN training CLI, PyTorch port (mirrors maskrcnn/vkitti.py train /
maskrcnn/cityscapes.py train; JAX cli/detect_train.py).

Drives the 4-stage COCO transfer schedule (vkitti.py:211-243): the stage-0
class-count transfer at lr 1e-5 (with --coco_ckpt; the class-dependent
output layers at 1e-2), then heads / 4+ / all with the reference's LR
ladder; `--stage` trains a single stage instead.  Examples are synthetic
(--dataset synthetic, or no --data_root), VKITTI or Cityscapes frames
(data/detect_data), the frames picked by numpy RandomState(0) and the RPN
targets' balance drawn from the global np.random, as in the JAX CLI.
Initial weights are drawn by torch from --seed, or read from --coco_ckpt (a
local .pth in the reference layout; nothing is fetched); each step's
detection-target draws come from a torch.Generator seeded from (--seed,
epoch * 100003 + iteration) (JAX: PRNGKey of that number).  Every
--save_every epochs and at the end, at the true epoch count, the state is
saved as a core/checkpoint step (fields "maskrcnn", "opt_state", "step";
the arguments as the manifest's meta), whose "maskrcnn" geometric_main and
edit_chain --maskrcnn_ckpt serve.  Runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["vkitti", "cityscapes",
                                         "synthetic"], default="vkitti")
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--coco_ckpt", default=None,
                   help="a local reference-layout Mask R-CNN .pth to start "
                        "from (its class layers must have --num_classes)")
    p.add_argument("--ckpt_dir", default="./maskrcnn_ckpt")
    p.add_argument("--stage", default=None,
                   choices=[None, "transfer", "heads", "4+", "all"],
                   help="train one freezing stage only; default runs the "
                        "full cumulative schedule")
    p.add_argument("--lr", type=float, default=1e-3,
                   help="base LR (config.py LEARNING_RATE); stage LRs are "
                        "scaled from it per the reference ladder")
    p.add_argument("--num_iters", type=int, default=50,
                   help="steps per epoch (reference: full dataset)")
    p.add_argument("--num_epochs", type=int, default=None,
                   help="cap on total epochs (default: schedule's 100)")
    p.add_argument("--image_dim", type=int, default=None,
                   help="override image_min_dim/image_max_dim (smoke runs)")
    p.add_argument("--num_classes", type=int, default=None,
                   help="default: 3 for vkitti (bg/car/van), 2 for "
                        "cityscapes (bg/car)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--save_every", type=int, default=5,
                   help="epochs between checkpoints (model.py:1907: 5)")
    p.add_argument("--small", action="store_true",
                   help="tiny backbone/ROI config for smoke runs/tests")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights and of each "
                        "step's detection-target draws")
    return p


def build_config(args):
    """The MaskRCNNConfig of the arguments (JAX main's cfg_kw)."""
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig

    num_classes = args.num_classes or (2 if args.dataset == "cityscapes"
                                       else 3)
    cfg_kw = dict(num_classes=num_classes, compute_dtype=args.compute_dtype)
    if args.small:
        cfg_kw.update(stage_sizes=(1, 1, 1, 1), fpn_channels=32,
                      pre_nms_limit=100, post_nms_rois_training=40,
                      train_rois_per_image=12, mask_shape=(14, 14),
                      mask_pool_size=7, rpn_train_anchors_per_image=32)
        args.image_dim = args.image_dim or 128
    if args.image_dim:
        cfg_kw.update(image_min_dim=args.image_dim,
                      image_max_dim=args.image_dim)
    return MaskRCNNConfig(**cfg_kw)


def load_coco(path: str, config, device):
    """The model at `config` with the reference-layout state_dict at `path`
    (a bare state_dict or {"state_dict": ...}).  Raises ValueError when the
    checkpoint's class layers do not have config.num_classes classes (a
    COCO checkpoint has 81)."""
    import torch

    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNN

    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    n = sd["classifier.linear_class.weight"].shape[0]
    if n != config.num_classes:
        raise ValueError(
            f"--coco_ckpt {path}: its class layers (classifier.linear_class,"
            f" linear_bbox, mask.conv5) have {n} classes, the model "
            f"{config.num_classes} (--num_classes); no layer is dropped or "
            f"re-drawn to make them fit")
    model = MaskRCNN(config)
    model.load_state_dict(sd)
    return model.to(device)


def to_example(ex, device):
    """A mold_gt_example dict on `device`: (images [1, 3, H, W], rpn_match,
    rpn_bbox, gt_class_ids, gt_boxes, gt_masks)."""
    from sdn3d_tpu_torch.utils.transfer import to_device

    image = to_device(ex["image"], device).permute(2, 0, 1)[None]
    return (image.contiguous(),) + tuple(
        to_device(ex[k], device) for k in ("rpn_match", "rpn_bbox",
                                           "gt_class_ids", "gt_boxes",
                                           "gt_masks"))


def main(argv=None):
    """Returns the trainer's state after the last epoch."""
    import torch

    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint
    from sdn3d_tpu_torch.data.detect_data import (
        CityscapesDetectDataset, VKittiDetectDataset,
        synthetic_detect_example)
    from sdn3d_tpu_torch.models.maskrcnn import generate_pyramid_anchors
    from sdn3d_tpu_torch.pipelines.detect_train import (MaskRCNNTrainer,
                                                        run_schedule)

    args = build_argparser().parse_args(argv)
    config = build_config(args)
    anchors_np = generate_pyramid_anchors(config)
    device = torch.device(args.device)

    if args.dataset == "vkitti" and args.data_root:
        ds = VKittiDetectDataset(args.data_root, config, anchors_np)
        print(f"VKITTI detect dataset: {len(ds)} frames")
    elif args.dataset == "cityscapes" and args.data_root:
        ds = CityscapesDetectDataset(args.data_root, config, anchors_np)
        print(f"Cityscapes detect dataset: {len(ds)} frames")
    else:
        ds = None
        print("synthetic detect examples (smoke mode)")

    def make_trainer(stage, learning_rate):
        return MaskRCNNTrainer(config=config, stage=stage,
                               learning_rate=learning_rate,
                               device=args.device)

    trainer0 = make_trainer("heads", args.lr)
    model = None
    if args.coco_ckpt:
        model = load_coco(args.coco_ckpt, config, device)
        print(f"weights from {args.coco_ckpt}")
    state = trainer0.init(args.seed, model)

    order = np.random.RandomState(0)

    def example(i):
        if ds is None:
            return synthetic_detect_example(config, anchors_np, seed=i)
        return ds[int(order.randint(len(ds)))]

    epochs_done = 0

    def epoch_fn(trainer, state, epoch):
        nonlocal epochs_done
        step = trainer.make_train_step()
        losses = {}
        for it in range(args.num_iters):
            batch = to_example(example(epoch * args.num_iters + it), device)
            state, losses = step(state, *batch, step_generator(
                args.seed, epoch * 100003 + it, device))
        epochs_done = max(epochs_done, epoch + 1)
        if losses:
            msg = " ".join(f"{k}={float(v):.4f}" for k, v in losses.items())
            print(f"[{trainer.stage}] epoch {epoch}: {msg}", flush=True)
        if (epoch + 1) % args.save_every == 0:
            save_checkpoint(args.ckpt_dir, epoch + 1, state.fields(),
                            meta=vars(args))
        return state

    if args.stage:
        trainer = make_trainer(args.stage, args.lr)
        state = trainer.init_opt(state)
        for epoch in range(args.num_epochs or 1):
            state = epoch_fn(trainer, state, epoch)
    else:
        cap = args.num_epochs

        def capped_epoch_fn(trainer, state, epoch):
            if cap is not None and epoch >= cap:
                return state
            return epoch_fn(trainer, state, epoch)

        state = run_schedule(make_trainer, state,
                             include_transfer=args.coco_ckpt is not None,
                             base_lr=args.lr, epoch_fn=capped_epoch_fn)

    # the final state at the TRUE epoch count, so that latest_step()
    # resolves to it; skipped when the last epoch saved itself
    if epochs_done == 0 or epochs_done % args.save_every != 0:
        save_checkpoint(args.ckpt_dir, epochs_done, state.fields(),
                        meta=vars(args))
    print("done")
    return state


if __name__ == "__main__":
    main()
