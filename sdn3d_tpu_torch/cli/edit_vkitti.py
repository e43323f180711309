"""Textural edit CLI (mirrors textural/edit_vkitti.py), PyTorch port.

Reads: the source RGB (--edit_source), its label PNG (--segm_path, what
semantic_test writes), and a directory of geometric outputs (--edit_dir
with {i:05d}.png / .json / -normal.png, what geometric_main --input_image
--edit_json writes).  Extracts per-instance texture codes from the SOURCE
image, rebuilds the conditioning per edit frame, generates, and writes an
HTML gallery (edit_vkitti.py:41-124).  Runs on `--device` (default cuda).
The source preparation and the generation are the edit chain's textural
stage (pipelines/textural_edit), imported here under the JAX package's
names.

`load_trainer` reads `args.ckpt_dir`: a checkpoint directory
(core/checkpoint: the newest step's "netG" and "netE" state_dicts, and
"netGlobalE" when the manifest's training meta says use_global_encoder;
the nets rebuilt from that meta as the JAX package does, a step of
cli/textural_train included) or a torch file {"netG": state_dict, "netE":
state_dict} written from JAX parameters by sdn3d_tpu_torch.utils.port
(global_generator_state_dict_from_jax, encoder_state_dict_from_jax);
without it the weights are random, drawn from `args.seed`.
"""

from __future__ import annotations

import argparse
import json
import os

# the textural stage, under the JAX package's module's names
from sdn3d_tpu_torch.pipelines.textural_edit import (  # noqa: F401
    EditMaps, SourceInputs, generate_edit_batch, generate_edit_from_images,
    prepare_source_begin, prepare_source_finish, prepare_source_inputs)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--edit_source", required=True)
    p.add_argument("--segm_path", required=True)
    p.add_argument("--edit_dir", required=True)
    p.add_argument("--edit_num", type=int, default=1)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "file {netG, netE} of state_dicts")
    p.add_argument("--results_dir", default="./edit_out")
    p.add_argument("--load_size", type=int, default=624)
    p.add_argument("--fine_width", type=int, default=624)
    p.add_argument("--fine_height", type=int, default=192)
    p.add_argument("--no_vgg", action="store_true")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --ckpt_dir "
                        "is not given")
    return p


def load_trainer(args, cfg=None):
    """TexturalTrainer (netG, netE) in eval mode on args.device.  Its
    config is `cfg` when given; else, for a checkpoint directory, the one
    its manifest's training meta describes
    (pipelines/textural.config_from_train_meta, as the JAX package rebuilds
    the nets a checkpoint was trained with), else TexturalConfig(); at
    args.compute_dtype (float32 when args has none).  Random weights from
    args.seed (drawn inside torch.random.fork_rng, so the caller's global
    generator is untouched) unless args.ckpt_dir names a checkpoint
    directory or a torch file {"netG": ..., "netE": ...}."""
    import torch

    from sdn3d_tpu_torch.core.checkpoint import load_meta, load_state_dicts
    from sdn3d_tpu_torch.pipelines.textural import (TexturalTrainer,
                                                    config_from_train_meta)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    if cfg is None:
        meta = {}
        if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
            try:
                meta = load_meta(args.ckpt_dir).get("meta", {})
            except (OSError, ValueError):     # no or unreadable manifest
                pass
        overrides = {"compute_dtype": getattr(args, "compute_dtype",
                                              "float32")}
        if hasattr(args, "no_vgg"):
            overrides["use_vgg_loss"] = not args.no_vgg
        cfg = config_from_train_meta(meta, **overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        trainer = TexturalTrainer(cfg)
    if args.ckpt_dir:
        names = ["netG", "netE"] + (["netGlobalE"]
                                    if cfg.use_global_encoder else [])
        sd = load_state_dicts(args.ckpt_dir, names)
        trainer.load_state_dicts(sd["netG"], sd["netE"], sd.get("netGlobalE"))
    else:
        print("WARNING: no --ckpt_dir; random generator weights")
    return trainer.to(device)


def generate_edit_frame(trainer, base_img_t, base_label, edit_dir, index,
                        wh, args, feats=None, source=None):
    """Read one edit frame's geometric outputs from `edit_dir`, assemble
    its conditioning and generate (edit_vkitti.py:63-107).  `index` is the
    output stem: an int (zero-padded, what geometric_main --input_image
    --edit_json writes) or a string (a benchmark target_name)."""
    from PIL import Image

    stem = f"{index:05d}" if isinstance(index, int) else index
    inst_img = Image.open(os.path.join(edit_dir, f"{stem}.png"))
    with open(os.path.join(edit_dir, f"{stem}.json")) as f:
        json_obj = json.load(f)
    normal_path = os.path.join(edit_dir, f"{stem}-normal.png")
    normal_img = (Image.open(normal_path) if os.path.exists(normal_path)
                  else None)
    return generate_edit_from_images(trainer, base_img_t, base_label,
                                     inst_img, json_obj, normal_img, wh,
                                     args, feats=feats, source=source)


def main(argv=None):
    """Generate --edit_num edit frames and write the gallery.  Returns the
    fakes ([H, W, 3] in [-1, 1]) in frame order."""
    from PIL import Image

    from sdn3d_tpu_torch.utils.visualizer import (HTMLGallery, tensor2im,
                                                  tensor2label)

    args = build_argparser().parse_args(argv)
    trainer = load_trainer(args)
    wh = (args.fine_width, args.fine_height)

    src = prepare_source_inputs(
        trainer, Image.open(args.edit_source), Image.open(args.segm_path),
        args.load_size, wh)

    gallery = HTMLGallery(args.results_dir, "sdn3d_tpu edit results")
    fakes = []
    for i in range(args.edit_num):
        fake, maps = generate_edit_frame(trainer, src.image, src.label,
                                         args.edit_dir, i, wh, args,
                                         feats=src.feats, source=src.table)
        fakes.append(fake)
        gallery.add_images({
            "input_label": tensor2label(maps["label"], 14),
            "synthesized_image": tensor2im(fake),
            "real_image": tensor2im(src.image),
        }, f"{i:05d}")
        print(f"generated edit frame {i:05d}")
    out = gallery.save()
    print(f"gallery: {out}")
    return fakes


if __name__ == "__main__":
    main()
