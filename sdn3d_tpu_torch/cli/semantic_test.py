"""Semantic branch inference CLI (mirrors semantic/vkitti_test.py),
PyTorch port.

Modes: single image (--test_img path/to.png) or the whole benchmark list
(--test_img benchmark with --edit_json and --data_root).  Writes raw
label PNGs consumed by the downstream branches (vkitti_test.py:21-27,
46-79) plus colorized previews.  Runs on `--device` (default cuda).
--ckpt_dir takes a checkpoint directory (core/checkpoint: the newest
step's "encoder" and "decoder" state_dicts) or a torch file {"encoder":
state_dict, "decoder": state_dict} written from JAX variables by
sdn3d_tpu_torch.utils.port.semantic_state_dicts_from_jax; without it the
weights are random, drawn from --seed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test_img", required=True,
                   help="image path, or 'benchmark'")
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--edit_json", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "file {encoder, decoder} of state_dicts "
                        "(utils/port.semantic_state_dicts_from_jax)")
    p.add_argument("--result", default="./semantic_out")
    p.add_argument("--num_class", type=int, default=14)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="convolution compute dtype (BatchNorm, logits and "
                        "the softmax stay float32)")
    p.add_argument("--scales", type=int, nargs="+",
                   default=[100, 150, 200, 300, 375])
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --ckpt_dir "
                        "is not given")
    return p


def load_model(args):
    """SemanticModel in eval mode on args.device, computing in
    args.compute_dtype (default float32).  Random weights from
    args.seed (drawn inside torch.random.fork_rng, so the caller's global
    generator is untouched) unless --ckpt_dir names a checkpoint directory
    or a torch file of the encoder's and decoder's state_dicts."""
    import torch

    from sdn3d_tpu_torch.core.checkpoint import load_state_dicts
    from sdn3d_tpu_torch.models.semantic import SemanticModel

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(getattr(args, "seed", 0))
        model = SemanticModel(num_class=args.num_class,
                              dtype=getattr(args, "compute_dtype", "float32"))
    if args.ckpt_dir:
        sd = load_state_dicts(args.ckpt_dir, ["encoder", "decoder"])
        model.encoder.load_state_dict(sd["encoder"])
        model.decoder.load_state_dict(sd["decoder"])
    else:
        print("WARNING: no --ckpt_dir; running with random weights")
    return model.to(device).eval()


def infer_image(model, image_rgb: np.ndarray, args) -> np.ndarray:
    """uint8 RGB frame -> uint8 label map.  The reference normalization
    (vkitti_dataset.py:43-44,152: BGR order, ImageNet means x255, stds in
    0..1 scale) happens on the device, in the one multi-scale pass."""
    from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_fused

    device = next(model.parameters()).device
    return multiscale_labels_fused(model, np.ascontiguousarray(image_rgb),
                                   scales=tuple(args.scales), device=device)


def main(argv=None):
    from PIL import Image

    from sdn3d_tpu_torch.utils.visualizer import tensor2label

    args = build_argparser().parse_args(argv)
    model = load_model(args)
    os.makedirs(args.result, exist_ok=True)

    if args.test_img == "benchmark":
        from sdn3d_tpu_torch.data.vkitti import benchmark_split, load_edit_json
        if not (args.edit_json and args.data_root):
            raise ValueError("--test_img benchmark needs --edit_json and "
                             "--data_root")
        items = benchmark_split(load_edit_json(args.edit_json))
        # output stem = item.source_name (world_topic_frame): what the
        # downstream edit CLIs look up
        work = sorted({
            (i.source_name,
             os.path.join(args.data_root, "vkitti_1.3.1_rgb", i.world,
                          i.topic, f"{i.source}.png")) for i in items})
    else:
        stem = os.path.splitext(os.path.basename(args.test_img))[0]
        work = [(stem, args.test_img)]

    for stem, path in work:
        image = np.asarray(Image.open(path).convert("RGB"))
        pred = infer_image(model, image, args)
        Image.fromarray(pred).save(os.path.join(args.result, f"{stem}.png"))
        Image.fromarray(tensor2label(pred, args.num_class)).save(
            os.path.join(args.result, f"{stem}_color.png"))
        print(f"wrote {stem}.png")


if __name__ == "__main__":
    main()
