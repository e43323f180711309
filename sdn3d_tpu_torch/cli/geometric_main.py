"""Geometric branch CLI (mirrors geometric/scripts/main.py), PyTorch port.

--do test --mode extend --source maskrcnn|gt: per-image de-render + edit +
re-render, writing {name}.png (instance map), {name}.json,
{name}-normal.png, {name}-depth.png, {name}.pkl — the inter-branch
filesystem contract (scripts/main.py:530-622).  Runs on `--device`
(default cuda).  Three modes, as scripts/main.py test():
  * --input_image FRAME [--edit_json E]: one frame, once per edit item
    (outputs {i:05d}) or once (outputs named by the frame);
  * --vkitti_root ROOT --edit_json E: each edit item's own source frame,
    outputs named by the item's target_name;
  * --vkitti_root ROOT: every frame of --split in the motgt tables
    (data/vkitti_derender.VKittiMotgt), outputs {world}_{topic}_{frame}.
The objects come from a GT npz (--input_masks), from the VKITTI scenegt
(--source gt in dataset mode) or, at the default --source maskrcnn, from
the Mask R-CNN detector (pipelines/detect.py), built once and run once
per source frame.  --num_opts N refines each object's pose and shape
against its mask with N Adam steps through the differentiable silhouette
before the edits.  --ckpt_dir and --maskrcnn_ckpt take a checkpoint
directory (core/checkpoint: the newest step's "derenderer" or "maskrcnn"
state_dict) or a torch state_dict file written from JAX variables by
sdn3d_tpu_torch.utils.port.derenderer_state_dict_from_jax and
maskrcnn_state_dict_from_jax.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--do", choices=["test"], default="test")
    p.add_argument("--mode", choices=["pretrain", "full", "finetune",
                                      "extend"], default="extend")
    p.add_argument("--source", choices=["gt", "maskrcnn"], default="maskrcnn")
    p.add_argument("--num_opts", type=int, default=0,
                   help="Adam steps of silhouette refinement per frame")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--render_size", type=int, default=384)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "state_dict file of the derenderer "
                        "(utils/port.derenderer_state_dict_from_jax)")
    p.add_argument("--maskrcnn_ckpt", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "state_dict file of the Mask R-CNN "
                        "(utils/port.maskrcnn_state_dict_from_jax)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of Mask R-CNN's convolutions and of "
                        "the derenderer's resnet18 trunk (heads, BatchNorm "
                        "and box math stay float32)")
    p.add_argument("--shapenet_root",
                   default=os.environ.get("SHAPENET_ROOT_DIR"))
    p.add_argument("--edit_json", default=None)
    p.add_argument("--input_image", default=None,
                   help="single-image mode: path to the RGB frame")
    p.add_argument("--input_masks", default=None,
                   help="npz with rois [N,4], masks [N,1,H,W], class_ids [N]"
                        " (gt source)")
    p.add_argument("--vkitti_root",
                   default=os.environ.get("VKITTI_ROOT_DIR"),
                   help="dataset mode: iterate VKITTI frames (edit_json "
                        "sources, or the whole --split)")
    p.add_argument("--split", choices=["train", "test", "all"],
                   default="test")
    p.add_argument("--output_dir", default="./geometric_out")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random derenderer and detector "
                        "weights used where no checkpoint is given")
    return p


def load_derenderer(args):
    """(model, bank) on args.device, the trunk computing in
    args.compute_dtype (default float32).  Random weights from args.seed
    (inside torch.random.fork_rng) unless --ckpt_dir names a checkpoint
    directory or a torch state_dict file."""
    import torch

    from sdn3d_tpu_torch.core.checkpoint import load_state_dicts
    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    # drawn inside fork_rng: the caller's global generator is untouched
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(getattr(args, "seed", 0))
        model = Derenderer(num_classes=8, dtype=getattr(
            args, "compute_dtype", "float32"))
    if args.ckpt_dir:
        model.load_state_dict(load_state_dicts(
            args.ckpt_dir, ["derenderer"])["derenderer"])
    else:
        print("WARNING: no --ckpt_dir; random derenderer weights")
    model = model.to(device).eval()
    bank = DeviceMeshBank.from_host(load_shapenet_bank(args.shapenet_root),
                                    device=device)
    return model, bank


def make_detector(args):
    """The Mask R-CNN detector on args.device, built once and reused for
    every frame of the run, computing in args.compute_dtype: random
    weights from args.seed, or args.maskrcnn_ckpt (a checkpoint directory
    or a torch state_dict file, in the reference layout)."""
    from sdn3d_tpu_torch.core.checkpoint import load_state_dicts
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig
    from sdn3d_tpu_torch.pipelines.detect import MaskRCNNDetector

    det = MaskRCNNDetector(MaskRCNNConfig(
        compute_dtype=getattr(args, "compute_dtype", "float32")),
        device=args.device)
    if args.maskrcnn_ckpt:
        det.load_state_dict(load_state_dicts(
            args.maskrcnn_ckpt, ["maskrcnn"])["maskrcnn"])
    else:
        det.init(getattr(args, "seed", 0))
        print("WARNING: no --maskrcnn_ckpt; random detector weights")
    return det


def detect_objects(args, image_rgb: np.ndarray, cfg, detector=None):
    """Objects kept to cfg's slots (scripts/main.py:812-818): from a GT
    npz (rois/masks/class_ids) or from Mask R-CNN, whose objects are kept
    before their masks are pasted.  `detector` is make_detector's; when
    None a throwaway one is built (single-shot callers)."""
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        keep_largest_detections, keep_largest_unmolded)
    if args.source == "gt" or args.input_masks:
        data = np.load(args.input_masks)
        return keep_largest_detections(cfg, data["class_ids"], data["masks"],
                                       data["rois"])
    if detector is None:
        detector = make_detector(args)
    return keep_largest_unmolded(
        cfg, detector.unmold(detector.detect_begin(image_rgb)))


def quantize_instance_map(inst: np.ndarray) -> np.ndarray:
    """[H, W] object indices -> the uint8 written to `{name}.png`."""
    return inst.astype(np.uint8)


def quantize_normal_map(nrm: np.ndarray) -> np.ndarray:
    """[3, H, W] float normals -> the uint8 RGB written to
    `{name}-normal.png`."""
    return np.clip(nrm.transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)


def quantize_depth_map(dep: np.ndarray) -> np.ndarray:
    """[H, W] depth in [0, 1] -> the uint16 written to `{name}-depth.png`."""
    return (np.clip(dep, 0, 1) * 65535).astype(np.uint16)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def save_outputs(out: dict, output_dir: str, name: str) -> None:
    """The inter-branch filesystem contract (scripts/main.py:530-622).

    derender_image quantizes ON THE DEVICE with this exact math and ships
    the bytes in one packed copy (`*_png` keys); producers that only carry
    the float maps are quantized here."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    inst_png = out.get("instance_png")
    if inst_png is None:
        inst_png = quantize_instance_map(_host(out["instance_map"]))
    nrm_png = out.get("normal_png")
    if nrm_png is None:
        nrm_png = quantize_normal_map(_host(out["normal_map"]))
    dep_png = out.get("depth_png")
    if dep_png is None:
        dep_png = quantize_depth_map(_host(out["depth_map"]))
    Image.fromarray(inst_png).save(
        os.path.join(output_dir, f"{name}.png"))
    Image.fromarray(nrm_png).save(
        os.path.join(output_dir, f"{name}-normal.png"))
    Image.fromarray(dep_png).save(      # uint16 -> I;16 (PIL infers)
        os.path.join(output_dir, f"{name}-depth.png"))
    with open(os.path.join(output_dir, f"{name}.json"), "w") as f:
        json.dump(out["json_obj"], f, indent=4)
    with open(os.path.join(output_dir, f"{name}.pkl"), "wb") as f:
        pickle.dump(out["state"], f)


def _keep_largest(cfg, class_ids, masks, rois):
    """keep <=16 largest masks (scripts/main.py:812-818)."""
    from sdn3d_tpu_torch.pipelines.derender_infer import \
        keep_largest_detections
    return keep_largest_detections(cfg, class_ids, masks, rois)


def _iter_work(args):
    """Yield (name, src_key, image_rgb, gt_or_None, operations) items.
    `src_key` identifies the SOURCE frame: the detection cache key, so
    items sharing a source reuse its objects.

    Three modes, as scripts/main.py test():
      * --input_image: one frame (repeated per edit item);
      * --vkitti_root + --edit_json: each edit item's own source frame;
      * --vkitti_root alone: the whole --split.
    """
    from PIL import Image

    from sdn3d_tpu_torch.data import vkitti as VK

    if args.input_image:
        image = np.asarray(Image.open(args.input_image).convert("RGB"))
        if args.edit_json:
            for i, item in enumerate(VK.load_edit_json(args.edit_json)):
                yield (f"{i:05d}", args.input_image, image, None,
                       item.operations)
        else:
            name = os.path.splitext(os.path.basename(args.input_image))[0]
            yield name, args.input_image, image, None, None
        return

    if not args.vkitti_root:
        raise ValueError("provide --input_image or --vkitti_root "
                         "(dataset mode)")
    table_inst = (VK.get_tables("inst", args.vkitti_root)
                  if args.source == "gt" else None)

    def read(world, topic, frame):
        image = np.asarray(Image.open(VK.rgb_path(
            args.vkitti_root, world, topic, frame)).convert("RGB"))
        gt = (None if table_inst is None else
              VK.gt_objects(args.vkitti_root, world, topic, frame,
                            table_inst))
        return image, gt

    if args.edit_json:
        for item in VK.load_edit_json(args.edit_json):
            image, gt = read(item.world, item.topic, int(item.source))
            yield (item.target_name, item.source_name, image, gt,
                   item.operations)
    else:
        from sdn3d_tpu_torch.data.vkitti_derender import VKittiMotgt
        for world, topic, frame in VKittiMotgt(
                args.vkitti_root).frames(args.split):
            name = f"{world}_{topic}_{frame:05d}"
            image, gt = read(world, topic, frame)
            yield name, name, image, gt, None


def main(argv=None):
    from sdn3d_tpu_torch.models.derenderer import TargetType
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, keep_largest_detections)
    from sdn3d_tpu_torch.utils.locks import crash_guard, try_claim

    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.source == "gt" and args.input_image and not args.input_masks:
        parser.error("--source gt with --input_image requires "
                     "--input_masks (npz with rois/masks/class_ids)")
    model, bank = load_derenderer(args)
    cfg = DerenderInferConfig(
        image_size=args.image_size, render_size=args.render_size,
        num_opts=args.num_opts, mode=TargetType.BY_NAME[args.mode])

    detector = None      # built lazily, once, for the maskrcnn source
    cached = {}
    for name, src_key, image, gt, ops in _iter_work(args):
        # lock-file skip/claim for concurrent or resumed runs
        # (scripts/main.py:707-716)
        if not try_claim(args.output_dir, name):
            print(f"skip {name} (locked)")
            continue
        with crash_guard(name):
            if src_key not in cached:
                if gt is not None:
                    dets = keep_largest_detections(cfg, *gt)
                else:
                    if detector is None and not (
                            args.source == "gt" or args.input_masks):
                        detector = make_detector(args)
                    dets = detect_objects(args, image, cfg, detector)
                # keep the last source only (masks are large)
                cached = {src_key: dets}
            class_ids, masks, rois = cached[src_key]
            out = derender_image(model, bank, image, class_ids, masks, rois,
                                 cfg, operations=ops, device=args.device)
            save_outputs(out, args.output_dir, name)
            print(f"wrote {name} ({len(ops or [])} ops)")


if __name__ == "__main__":
    main()
