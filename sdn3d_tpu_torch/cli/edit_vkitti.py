"""Textural edit CLI (mirrors textural/edit_vkitti.py), PyTorch port.

Reads: the source RGB (--edit_source), its label PNG (--segm_path, what
semantic_test writes), and a directory of geometric outputs (--edit_dir
with {i:05d}.png / .json / -normal.png, what geometric_main --input_image
--edit_json writes).  Extracts per-instance texture codes from the SOURCE
image, rebuilds the conditioning per edit frame, generates, and writes an
HTML gallery (edit_vkitti.py:41-124).  Runs on `--device` (default cuda).
The functions below are also the textural stage of the fused edit chain
(pipelines/chain.py) and of cli/edit_benchmark.  The conditioning of a
batch of edit frames is built on the device (ops/edit_conditioning, one
kernel launch on the card) where the JAX package assembles it on the host
(its assemble_edit_conditioning, which the tests hold it to).

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
from collections.abc import Mapping
from typing import NamedTuple

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
        names = ["netG", "netE"] + (["netGlobalE"]
                                    if cfg.use_global_encoder else [])
        sd = load_state_dicts(args.ckpt_dir, names)
        trainer.load_state_dicts(sd["netG"], sd["netE"], sd.get("netGlobalE"))
    else:
        print("WARNING: no --ckpt_dir; random generator weights")
    return trainer.to(device)


class SourceInputs(NamedTuple):
    """One source frame's textural inputs: the transformed RGB [H, W, 3]
    in [-1, 1], the int32 label map at target resolution, the per-slot
    feature-code table [max_instances, feat] as numpy (netE + instance
    means in one device pass; its slot order is
    dense_instance_slots(label)), and the source's side of the device
    conditioning (ops/edit_conditioning.SourceTable: the label plane and
    the codes by label value, on the trainer's device)."""
    image: np.ndarray
    label: np.ndarray
    feats: np.ndarray
    table: object


def _source_side(trainer, base_img_t, base_label, feats=None):
    """(SourceTable, the per-slot feature means on the device) of a source
    from its transformed image and label map: dense_instance_slots of the
    label map, then netE + instance means in one device pass unless `feats`
    (the host code table) is given."""
    from sdn3d_tpu_torch.data.textural_data import dense_instance_slots
    from sdn3d_tpu_torch.ops.edit_conditioning import source_table
    from sdn3d_tpu_torch.utils.transfer import to_device

    src_slots, mapping = dense_instance_slots(base_label,
                                              trainer.cfg.max_instances)
    dev = trainer.device
    if feats is None:
        feats = trainer.encode_feat_means(
            to_device(base_img_t[None], dev),
            to_device(src_slots[None], dev))[0]      # [max_inst, feat]
    else:
        feats = to_device(np.asarray(feats, np.float32), dev)
    return source_table(base_label, mapping, feats), feats


def prepare_source_begin(trainer, src_img, label_img, load_size, wh):
    """Host transforms + the netE feature-means pass for one source frame,
    the (tiny) table on its way to the host (HostFetch), and the source's
    SourceTable gathered on the device from the means.  Returns a pending
    handle for prepare_source_finish; a chunked caller (the pipelined
    chain's stage B) enqueues every source before it waits for any."""
    from sdn3d_tpu_torch.data.textural_data import transform_image
    from sdn3d_tpu_torch.utils.transfer import HostFetch

    base_img_t = transform_image(src_img.convert("RGB"), load_size, wh)
    base_label = (np.asarray(transform_image(
        label_img, load_size, wh, nearest=True,
        normalize=False)) * 255.0).astype(np.int32)[..., 0]
    table, means = _source_side(trainer, base_img_t, base_label)
    return base_img_t, base_label, table, HostFetch(means)


def prepare_source_finish(pending) -> SourceInputs:
    base_img_t, base_label, table, fetch = pending
    return SourceInputs(base_img_t, base_label, fetch.result(), table)


def prepare_source_inputs(trainer, src_img, label_img, load_size,
                          wh) -> SourceInputs:
    """Source-side textural inputs from PIL images (SourceInputs).
    Exactly prepare_source_finish(prepare_source_begin(...))."""
    return prepare_source_finish(prepare_source_begin(
        trainer, src_img, label_img, load_size, wh))


def _edit_planes(item, load_size, wh):
    """One edit frame's planes at `wh` as uint8: the raw instance plane
    [H, W] and the normal PNG bytes [H, W, 3] (None without a normal map).
    The geometric stage's device-downsized planes (`inst_small` /
    `normal_small`, derender_infer small_plan: byte-equal to the PIL
    transform) are taken as they are; otherwise the full-resolution PIL
    images (`inst_img`, L mode, and `normal_img`) go through the host
    transform.  PIL resizes uint8 images in uint8 and u8 / 255 * 255 is
    exact in float32, so the casts to uint8 are lossless."""
    from sdn3d_tpu_torch.data.textural_data import transform_image

    if item.get("inst_small") is not None:
        inst = np.asarray(item["inst_small"], np.uint8)
    else:
        inst = (np.asarray(transform_image(
            item["inst_img"], load_size, wh, nearest=True, normalize=False))
            * 255.0).astype(np.int32)[..., 0].astype(np.uint8)
    normal = None
    if item.get("normal_small") is not None:
        normal = np.asarray(item["normal_small"], np.uint8)
    elif item.get("normal_img") is not None:
        normal = (np.asarray(transform_image(
            item["normal_img"].convert("RGB"), load_size, wh,
            normalize=False)) * 255.0).astype(np.uint8)
    return inst, normal


class EditMaps(Mapping):
    """One frame's condition maps (label, inst, pose [H, W] int32; normal
    [H, W, 3] float32, zeros without a normal map), computed on first
    access by assemble_condition_maps from the host inputs the frame's
    conditioning was built from: serving computes and fetches nothing for
    them, and a kept result holds no device memory."""

    _KEYS = ("label", "inst", "pose", "normal")

    def __init__(self, base_label, inst_raw, json_obj, normal_u8, shape):
        self._src = (base_label, inst_raw, json_obj, normal_u8, shape)
        self._maps = None

    def _computed(self):
        if self._maps is None:
            from sdn3d_tpu_torch.data.textural_data import \
                assemble_condition_maps
            base_label, inst_raw, json_obj, normal_u8, shape = self._src
            self._maps = assemble_condition_maps(
                np.asarray(base_label), inst_raw, json_obj, normal_u8)
            if normal_u8 is None:
                # no normal map (the reference's 'no cars' frame,
                # edit_vkitti.py:88-95): the generator sees exact 0.0
                self._maps["normal"] = np.zeros(shape, np.float32)
            self._src = None
        return self._maps

    def __getitem__(self, key):
        return self._computed()[key]

    def __contains__(self, key):
        return key in self._KEYS

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)


def generate_edit_batch(trainer, items, wh, args):
    """The batch's conditioning built on the trainer's device, then ONE
    fake_inference over the stacked [N, H, W] batch.  Each items[i] needs
    base_img_t, base_label, json_obj, and either inst_img (with optional
    normal_img) or the device-downsized inst_small / normal_small; `source`
    (SourceInputs.table) carries the source's side, else it is built here
    from base_label and the optional `feats`.

    On the host only each frame's object table (ops/edit_conditioning.
    frame_table) and its uint8 planes; one upload, and one
    ops/edit_conditioning launch for the batch (the kernel on the card,
    its plain twin on the CPU, counted in `count.tex.assemble.device` and
    `.host` by frames) writes the label, slot and pose planes and the
    per-slot code tables that the generator reads with the raw instance
    plane: the integers and rows of the host assembly
    (assemble_condition_maps, dense_instance_slots and the source codes
    matched by id).  The frames' distinct-id counts come back in the
    fakes' one copy; a frame with more ids than max_instances warns as
    dense_instance_slots does.  Returns (list of [H, W, 3] fakes, list of
    EditMaps)."""
    import warnings

    import torch

    from sdn3d_tpu_torch.ops.edit_conditioning import (edit_conditioning,
                                                       frame_table)
    from sdn3d_tpu_torch.utils import phases
    from sdn3d_tpu_torch.utils.transfer import to_device_packed

    cfg = trainer.cfg
    dev = trainer.device
    N = len(items)
    with phases.phase("tex.assemble"):
        planes = [_edit_planes(it, args.load_size, wh) for it in items]
        sources, src_index, seen = [], [], {}
        for it in items:
            table = it.get("source")
            key = id(table if table is not None else it["base_label"])
            if key not in seen:
                seen[key] = len(sources)
                sources.append(table if table is not None else _source_side(
                    trainer, it["base_img_t"], np.asarray(it["base_label"]),
                    it.get("feats"))[0])
            src_index.append(seen[key])
        host = [np.stack([inst for inst, _ in planes]),
                np.stack([normal if normal is not None
                          else np.zeros(it["base_img_t"].shape, np.uint8)
                          for (_, normal), it in zip(planes, items)]),
                np.stack([frame_table(it["json_obj"]) for it in items]),
                np.asarray(src_index, np.int32),
                np.asarray([normal is not None for _, normal in planes],
                           np.float32)]
        if cfg.use_global_encoder:
            # the global encoder reads the source image (JAX
            # cli/edit_vkitti.py:280-282); the codes come from the table
            host.append(np.stack([it["base_img_t"] for it in items]))
        inst, normal_dev, tables, src_dev, normal_valid, *image = \
            to_device_packed(host, dev)
        phases.add_bytes("tex.assemble", *host)

        def stacked(ts):
            return ts[0][None] if len(ts) == 1 else torch.stack(ts)
        cond = edit_conditioning(
            inst, stacked([s.label for s in sources]), src_dev, tables,
            stacked([s.codes for s in sources]), cfg.max_instances)
        phases.count("count.tex.assemble."
                     + ("device" if inst.is_cuda else "host"), N)
        phases.block(cond)
    with phases.phase("tex.generate"):
        batch = {"label": cond.label, "inst": inst,
                 "inst_slots": cond.slots, "pose": cond.pose,
                 "normal": normal_dev, "normal_valid": normal_valid}
        if image:
            batch["image"] = image[0]
        fake = trainer.fake_inference(batch, cond.feat)
        # the frames' id counts travel in the fakes' one copy
        out = torch.cat([fake.reshape(N, -1),
                         cond.nids.to(fake.dtype)[:, None]], 1).cpu().numpy()
        phases.add_bytes("tex.generate", out)
    fakes = out[:, :-1].reshape(fake.shape)
    for nids in out[:, -1]:
        if nids < 0:
            raise RuntimeError("edit conditioning: a frame's source index "
                               "lies outside the batch's sources")
        if nids > cfg.max_instances:
            warnings.warn(
                f"{int(nids)} unique instance ids > {cfg.max_instances} "
                "slots; overflow ids share slot 0", stacklevel=2)
    return list(fakes), [
        EditMaps(it["base_label"], inst_raw, it["json_obj"], normal,
                 it["base_img_t"].shape)
        for (inst_raw, normal), it in zip(planes, items)]


def generate_edit_from_images(trainer, base_img_t, base_label, inst_img,
                              json_obj, normal_img, wh, args, feats=None,
                              inst_small=None, normal_small=None,
                              source=None):
    """The textural edit step from in-memory PIL images (the fused chain's
    entry point, pipelines/chain.py).  `inst_img` is the full-resolution
    instance map (L mode), `normal_img` an RGB image or None; `feats`
    optionally carries the source's per-slot code table and `source` its
    SourceTable (SourceInputs.table), so callers can prepare a source once
    for every pair that shares it; `inst_small` / `normal_small` the
    device-downsized planes in place of the two images."""
    fakes, maps_list = generate_edit_batch(
        trainer,
        [{"base_img_t": base_img_t, "base_label": base_label,
          "inst_img": inst_img, "json_obj": json_obj,
          "normal_img": normal_img, "feats": feats, "source": source,
          "inst_small": inst_small, "normal_small": normal_small}],
        wh, args)
    return fakes[0], maps_list[0]


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
