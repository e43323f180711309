"""Geometric branch CLI (mirrors geometric/scripts/main.py), PyTorch port.

--do test --mode extend --source gt --input_image ... --input_masks ...
[--edit_json ...]: per-image de-render + edit + re-render, writing
{name}.png (instance map), {name}.json, {name}-normal.png,
{name}-depth.png, {name}.pkl — the inter-branch filesystem contract
(scripts/main.py:530-622).  Runs on `--device` (default cuda).
--num_opts N refines each object's pose and shape against its mask with
N Adam steps through the differentiable silhouette before the edits.

Not ported yet: --source maskrcnn (Mask R-CNN), --vkitti_root dataset
mode, and orbax checkpoints:
--ckpt_dir takes a torch state_dict file written from JAX variables by
sdn3d_tpu_torch.utils.port.derenderer_state_dict_from_jax.
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
                   help="torch state_dict file of the derenderer "
                        "(utils/port.derenderer_state_dict_from_jax)")
    p.add_argument("--maskrcnn_ckpt", default=None)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32"],
                   help="derenderer compute dtype (float32 only so far)")
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
                   help="dataset mode (not ported yet)")
    p.add_argument("--split", choices=["train", "test", "all"],
                   default="test")
    p.add_argument("--output_dir", default="./geometric_out")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random derenderer weights used when "
                        "--ckpt_dir is not given")
    return p


def load_derenderer(args):
    """(model, bank) on args.device.  Random weights from args.seed unless
    --ckpt_dir names a torch state_dict."""
    import torch

    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    torch.manual_seed(getattr(args, "seed", 0))
    model = Derenderer(num_classes=8)
    if args.ckpt_dir:
        sd = torch.load(args.ckpt_dir, map_location="cpu")
        model.load_state_dict(sd)
        print(f"restored derenderer state_dict {args.ckpt_dir}")
    else:
        print("WARNING: no --ckpt_dir; random derenderer weights")
    model = model.to(device).eval()
    bank = DeviceMeshBank.from_host(load_shapenet_bank(args.shapenet_root),
                                    device=device)
    return model, bank


def detect_objects(args, image_rgb: np.ndarray):
    """Object proposals from a GT npz (rois/masks/class_ids)."""
    if args.source == "gt" or args.input_masks:
        data = np.load(args.input_masks)
        return data["class_ids"], data["masks"], data["rois"]
    raise NotImplementedError("Mask R-CNN is not ported yet")


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


def _iter_work(args):
    """Yield (name, src_key, image_rgb, gt_or_None, operations) items.

    --input_image mode: one frame, repeated per edit item when
    --edit_json is given.  --vkitti_root dataset mode is not ported yet.
    """
    from PIL import Image

    if not args.input_image:
        if args.vkitti_root:
            raise NotImplementedError(
                "--vkitti_root dataset mode is not ported yet")
        raise ValueError("provide --input_image")
    image = np.asarray(Image.open(args.input_image).convert("RGB"))
    if args.edit_json:
        from sdn3d_tpu_torch.data.vkitti import load_edit_json
        for i, item in enumerate(load_edit_json(args.edit_json)):
            yield f"{i:05d}", args.input_image, image, None, item.operations
    else:
        name = os.path.splitext(os.path.basename(args.input_image))[0]
        yield name, args.input_image, image, None, None


def main(argv=None):
    from sdn3d_tpu_torch.models.derenderer import TargetType
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, keep_largest_detections)
    from sdn3d_tpu_torch.utils.locks import crash_guard, try_claim

    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.source == "maskrcnn" and not args.input_masks:
        raise NotImplementedError("Mask R-CNN is not ported yet")
    if args.source == "gt" and args.input_image and not args.input_masks:
        parser.error("--source gt with --input_image requires "
                     "--input_masks (npz with rois/masks/class_ids)")
    model, bank = load_derenderer(args)
    cfg = DerenderInferConfig(
        image_size=args.image_size, render_size=args.render_size,
        num_opts=args.num_opts, mode=TargetType.BY_NAME[args.mode])

    cached = {}
    for name, src_key, image, gt, ops in _iter_work(args):
        # lock-file skip/claim for concurrent or resumed runs
        # (scripts/main.py:707-716)
        if not try_claim(args.output_dir, name):
            print(f"skip {name} (locked)")
            continue
        with crash_guard(name):
            if src_key not in cached:
                dets = gt if gt is not None else detect_objects(args, image)
                # keep the last source only (masks are large)
                cached = {src_key: keep_largest_detections(cfg, *dets)}
            class_ids, masks, rois = cached[src_key]
            out = derender_image(model, bank, image, class_ids, masks, rois,
                                 cfg, operations=ops, device=args.device)
            save_outputs(out, args.output_dir, name)
            print(f"wrote {name} ({len(ops or [])} ops)")


if __name__ == "__main__":
    main()
