"""Textural branch reconstruction test CLI (mirrors textural/test.py),
PyTorch port: regenerate each test-split frame (data/vkitti.get_lists) from
its own conditioning, the labels of --segm_dir and the geometric outputs of
--geo_dir (what geometric_main --vkitti_root --split test writes, named
{world}_{topic}_{frame}), and print the average L1 against the real image
('avg:', test.py:67,75-77).  Frames whose label or instance PNG is missing
are skipped.  The nets are rebuilt from the checkpoint's training meta
(cli/edit_vkitti.load_trainer), the global encoder's included, which reads
the real image (its posterior mean).  Runs on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--segm_dir", required=True)
    p.add_argument("--geo_dir", required=True,
                   help="geometric outputs named {world}_{topic}_{frame}.*")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "file {netG, netE} of state_dicts")
    p.add_argument("--results_dir", default="./textural_test_out")
    p.add_argument("--load_size", type=int, default=624)
    p.add_argument("--fine_width", type=int, default=624)
    p.add_argument("--fine_height", type=int, default=192)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --ckpt_dir "
                        "is not given")
    return p


def main(argv=None):
    """Run the test; returns {frame name: L1} in test-list order."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.edit_vkitti import load_trainer
    from sdn3d_tpu_torch.data.textural_data import (
        assemble_condition_maps, dense_instance_slots, transform_image)
    from sdn3d_tpu_torch.data.vkitti import get_lists
    from sdn3d_tpu_torch.utils.transfer import to_device
    from sdn3d_tpu_torch.utils.visualizer import HTMLGallery, tensor2im

    args = build_argparser().parse_args(argv)
    args.no_vgg = True
    trainer = load_trainer(args)
    dev = trainer.device
    wh = (args.fine_width, args.fine_height)

    files = get_lists("test")
    if args.limit:
        files = files[:args.limit]

    gallery = HTMLGallery(args.results_dir, "reconstruction test")
    l1s = {}
    for f in files:
        world, scene, frame_png = f.split("/")
        name = f"{world}_{scene}_{os.path.splitext(frame_png)[0]}"
        segm_path = os.path.join(args.segm_dir, f"{name}.png")
        inst_path = os.path.join(args.geo_dir, f"{name}.png")
        json_path = os.path.join(args.geo_dir, f"{name}.json")
        if not (os.path.exists(segm_path) and os.path.exists(inst_path)):
            continue
        image = transform_image(Image.open(os.path.join(
            args.data_root, "vkitti_1.3.1_rgb", f)).convert("RGB"),
            args.load_size, wh)
        segm = (np.asarray(transform_image(
            Image.open(segm_path), args.load_size, wh, nearest=True,
            normalize=False)) * 255.0).astype(np.int32)[..., 0]
        inst = (np.asarray(transform_image(
            Image.open(inst_path), args.load_size, wh, nearest=True,
            normalize=False)) * 255.0).astype(np.int32)[..., 0]
        with open(json_path) as fh:
            json_obj = json.load(fh)
        normal_path = os.path.join(args.geo_dir, f"{name}-normal.png")
        normal = None
        if os.path.exists(normal_path):
            normal = np.asarray(transform_image(
                Image.open(normal_path).convert("RGB"), args.load_size, wh,
                normalize=False)) * 255.0
        maps = assemble_condition_maps(segm, inst, json_obj, normal)
        if "normal" not in maps:
            maps["normal"] = np.zeros(image.shape, np.float32)
        slots, _ = dense_instance_slots(maps["inst"],
                                        trainer.cfg.max_instances)
        batch = {k: to_device(np.ascontiguousarray(v[None]), dev) for k, v in (
            ("label", maps["label"]), ("inst", maps["inst"]),
            ("inst_slots", slots), ("pose", maps["pose"]),
            ("normal", maps["normal"].astype(np.float32)))}
        if trainer.cfg.use_global_encoder:
            # the global encoder reads the real image, as in JAX
            batch["image"] = to_device(image[None], dev)
        # the codes of the frame's own instances (netE on the real image,
        # averaged per instance), expanded through inst_slots
        feats = trainer.encode_feat_means(to_device(image[None], dev),
                                          batch["inst_slots"])
        fake = trainer.fake_inference(batch, feats)[0].cpu().numpy()
        l1 = float(np.abs(fake - image).mean())
        l1s[name] = l1
        gallery.add_images({"synthesized": tensor2im(fake),
                            "real": tensor2im(image)}, name)
        print(f"{name}: L1={l1:.4f} avg: {np.mean(list(l1s.values())):.4f}",
              flush=True)

    print(f"avg: {np.mean(list(l1s.values())):.4f} over {len(l1s)} frames")
    gallery.save()
    return l1s


if __name__ == "__main__":
    main()
