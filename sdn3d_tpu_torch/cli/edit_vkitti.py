"""Textural edit CLI (mirrors textural/edit_vkitti.py), PyTorch port.

Reads: the source RGB (--edit_source), its label PNG (--segm_path, what
semantic_test writes), and a directory of geometric outputs (--edit_dir
with {i:05d}.png / .json / -normal.png, what geometric_main --input_image
--edit_json writes).  Extracts per-instance texture codes from the SOURCE
image, rebuilds the conditioning per edit frame, generates, and writes an
HTML gallery (edit_vkitti.py:41-124).  Runs on `--device` (default cuda).
The functions below are also the textural stage of the fused edit chain
(pipelines/chain.py) and of cli/edit_benchmark.

`load_trainer` reads `args.ckpt_dir`: a checkpoint directory
(core/checkpoint: the newest step's "netG" and "netE" state_dicts, the
nets rebuilt from the manifest's training meta as the JAX package does)
or a torch file {"netG": state_dict, "netE": state_dict} written from JAX
parameters by sdn3d_tpu_torch.utils.port
(global_generator_state_dict_from_jax, encoder_state_dict_from_jax);
without it the weights are random, drawn from `args.seed`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


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
        sd = load_state_dicts(args.ckpt_dir, ["netG", "netE"])
        trainer.load_state_dicts(sd["netG"], sd["netE"])
    else:
        print("WARNING: no --ckpt_dir; random generator weights")
    return trainer.to(device)


def prepare_source_begin(trainer, src_img, label_img, load_size, wh):
    """Host transforms + the netE feature-means pass for one source frame,
    the (tiny) table on its way to the host (HostFetch).  Returns a pending
    handle for prepare_source_finish; a chunked caller (the pipelined
    chain's stage B) enqueues every source before it waits for any."""
    from sdn3d_tpu_torch.data.textural_data import (dense_instance_slots,
                                                    transform_image)
    from sdn3d_tpu_torch.utils.transfer import HostFetch, to_device

    base_img_t = transform_image(src_img.convert("RGB"), load_size, wh)
    base_label = (np.asarray(transform_image(
        label_img, load_size, wh, nearest=True,
        normalize=False)) * 255.0).astype(np.int32)[..., 0]
    src_slots, _ = dense_instance_slots(base_label,
                                        trainer.cfg.max_instances)
    dev = trainer.device
    feat_means_dev = trainer.encode_feat_means(
        to_device(base_img_t[None], dev),
        to_device(src_slots[None], dev))             # [1, max_inst, feat]
    return base_img_t, base_label, HostFetch(feat_means_dev)


def prepare_source_finish(pending):
    base_img_t, base_label, fetch = pending
    return base_img_t, base_label, fetch.result()[0]


def prepare_source_inputs(trainer, src_img, label_img, load_size, wh):
    """Source-side textural inputs from PIL images: the transformed RGB in
    [-1, 1], the int32 label map at target resolution, and the per-slot
    source feature-code table [max_instances, feat] (netE + instance means
    in one device pass; its slot order is dense_instance_slots(base_label)).
    Exactly prepare_source_finish(prepare_source_begin(...))."""
    return prepare_source_finish(prepare_source_begin(
        trainer, src_img, label_img, load_size, wh))


def assemble_edit_conditioning(trainer, base_img_t, base_label, inst_img,
                               json_obj, normal_img, wh, args, feats=None,
                               inst_small=None, normal_small=None):
    """Host-side conditioning for one edit frame (edit_vkitti.py:62-107):
    transformed maps + instance slots + the per-slot source-code table, as
    numpy.  Returns (maps, slots, feat_table, normal_u8, inst_raw):
    `feat_table` [max_instances, feat] holds each target slot's source code
    (zeros where the source has no instance of that id); `normal_u8` the
    resized normal PNG bytes (None without a normal map); `inst_raw` the
    resized raw instance plane (uint8).

    `inst_small` / `normal_small` optionally carry the geometric stage's
    planes already downsized on the device to `wh` (uint8; the chain's
    serving contract, derender_infer small_plan), byte-equal to the PIL
    transform this function would apply: the full-resolution PIL path is
    skipped, and its float round trip is kept (u8 / 255 * 255 is exact in
    float32)."""
    from sdn3d_tpu_torch.data.textural_data import (
        assemble_condition_maps, dense_instance_slots, transform_image)

    if inst_small is not None:
        inst_png = ((np.asarray(inst_small).astype(np.float32) / 255.0)
                    * 255.0).astype(np.int32)
    else:
        inst_png = np.asarray(transform_image(
            inst_img, args.load_size, wh, nearest=True, normalize=False)
            * 255.0).astype(np.int32)[..., 0]
    normal_png = None
    if normal_small is not None:
        normal_png = (np.asarray(normal_small).astype(np.float32)
                      / 255.0) * 255.0
    elif normal_img is not None:
        normal_png = np.asarray(transform_image(
            normal_img.convert("RGB"), args.load_size, wh,
            normalize=False)) * 255.0

    maps = assemble_condition_maps(base_label, inst_png, json_obj,
                                   normal_png)
    if normal_png is not None:
        # PIL resizes uint8 images in uint8, so these floats are
        # integer-valued: the uint8 cast is lossless
        normal_u8 = normal_png.astype(np.uint8)
    else:
        # no normal map (the reference's 'no cars' frame,
        # edit_vkitti.py:88-95): the generator must see exact 0.0, which
        # fake_inference applies through normal_valid
        maps["normal"] = np.zeros(base_img_t.shape, np.float32)
        normal_u8 = None

    cfg = trainer.cfg
    slots, mapping = dense_instance_slots(maps["inst"], cfg.max_instances)
    src_slots, src_mapping = dense_instance_slots(
        np.asarray(base_label), cfg.max_instances)
    if feats is None:
        import torch
        dev = trainer.device
        feats = trainer.encode_feat_means(
            torch.from_numpy(base_img_t[None]).to(dev),
            torch.from_numpy(src_slots[None]).to(dev)).cpu().numpy()[0]
    means_np = np.asarray(feats, np.float32)     # [max_instances, feat]
    # codes are looked up by matching instance ids between source and
    # target (edit_vkitti.py:57,99-105): same k*1000 id = same object
    feat_table = np.zeros((cfg.max_instances, cfg.feat_num), np.float32)
    for inst_id, slot in mapping.items():
        src_slot = src_mapping.get(inst_id)
        if src_slot is not None:
            feat_table[slot] = means_np[src_slot]
    inst_raw = inst_png.astype(np.uint8)
    return maps, slots, feat_table, normal_u8, inst_raw


def generate_edit_batch(trainer, items, wh, args):
    """Assemble each frame's conditioning on the host, then ONE
    fake_inference over the stacked [N, H, W] batch.  Each items[i] needs
    base_img_t, base_label, json_obj, and either inst_img (with optional
    normal_img) or the device-downsized inst_small / normal_small; feats
    is optional.  Returns (list of [H, W, 3] fakes, list of condition-map
    dicts)."""
    from sdn3d_tpu_torch.utils import phases
    from sdn3d_tpu_torch.utils.transfer import to_device

    with phases.phase("tex.assemble"):
        assembled = [
            assemble_edit_conditioning(
                trainer, it["base_img_t"], it["base_label"],
                it.get("inst_img"), it["json_obj"], it.get("normal_img"),
                wh, args, feats=it.get("feats"),
                inst_small=it.get("inst_small"),
                normal_small=it.get("normal_small"))
            for it in items]
    dev = trainer.device
    with phases.phase("tex.upload"):
        # the smallest lossless dtypes: label ids <= 14, pose bins <= 24,
        # slots < max_instances, raw instance and normal PNG bytes
        host = {
            "label": np.stack([m["label"] for m, *_ in assembled]
                              ).astype(np.uint8),
            "inst": np.stack([a[4] for a in assembled]),
            "inst_slots": np.stack([a[1] for a in assembled]
                                   ).astype(np.uint8),
            "pose": np.stack([m["pose"] for m, *_ in assembled]
                             ).astype(np.uint8),
            "normal": np.stack([
                a[3] if a[3] is not None
                else np.zeros(items[i]["base_img_t"].shape, np.uint8)
                for i, a in enumerate(assembled)]),
            "normal_valid": np.asarray([a[3] is not None for a in assembled],
                                       np.float32),
        }
        feat_tables = np.stack([a[2] for a in assembled])
        batch = {k: to_device(v, dev) for k, v in host.items()}
        feat_dev = to_device(feat_tables, dev)
        phases.block(batch)
        phases.add_bytes("tex.upload", feat_tables, *host.values())
    with phases.phase("tex.generate"):
        fakes = trainer.fake_inference(batch, feat_dev).cpu().numpy()
        phases.add_bytes("tex.generate", fakes)
    return list(fakes), [a[0] for a in assembled]


def generate_edit_from_images(trainer, base_img_t, base_label, inst_img,
                              json_obj, normal_img, wh, args, feats=None,
                              inst_small=None, normal_small=None):
    """The textural edit step from in-memory PIL images (the fused chain's
    entry point, pipelines/chain.py).  `inst_img` is the full-resolution
    instance map (L mode), `normal_img` an RGB image or None; `feats`
    optionally carries the source's per-slot code table so callers can
    cache it across pairs sharing a source; `inst_small` / `normal_small`
    the device-downsized planes in place of the two images."""
    fakes, maps_list = generate_edit_batch(
        trainer,
        [{"base_img_t": base_img_t, "base_label": base_label,
          "inst_img": inst_img, "json_obj": json_obj,
          "normal_img": normal_img, "feats": feats,
          "inst_small": inst_small, "normal_small": normal_small}],
        wh, args)
    return fakes[0], maps_list[0]


def generate_edit_frame(trainer, base_img_t, base_label, edit_dir, index,
                        wh, args, feats=None):
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
                                     args, feats=feats)


def main(argv=None):
    """Generate --edit_num edit frames and write the gallery.  Returns the
    fakes ([H, W, 3] in [-1, 1]) in frame order."""
    from PIL import Image

    from sdn3d_tpu_torch.utils.visualizer import (HTMLGallery, tensor2im,
                                                  tensor2label)

    args = build_argparser().parse_args(argv)
    trainer = load_trainer(args)
    wh = (args.fine_width, args.fine_height)

    base_img_t, base_label, feats = prepare_source_inputs(
        trainer, Image.open(args.edit_source), Image.open(args.segm_path),
        args.load_size, wh)

    gallery = HTMLGallery(args.results_dir, "sdn3d_tpu edit results")
    fakes = []
    for i in range(args.edit_num):
        fake, maps = generate_edit_frame(trainer, base_img_t, base_label,
                                         args.edit_dir, i, wh, args,
                                         feats=feats)
        fakes.append(fake)
        gallery.add_images({
            "input_label": tensor2label(maps["label"], 14),
            "synthesized_image": tensor2im(fake),
            "real_image": tensor2im(base_img_t),
        }, f"{i:05d}")
        print(f"generated edit frame {i:05d}")
    out = gallery.save()
    print(f"gallery: {out}")
    return fakes


if __name__ == "__main__":
    main()
