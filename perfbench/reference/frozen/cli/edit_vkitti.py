# Frozen copy of sdn3d_tpu_torch/cli/edit_vkitti.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""The textural edit CLI's generation (mirrors textural/edit_vkitti.py):
per-instance texture codes from the SOURCE image, the conditioning
rebuilt per edit frame, and the generator (edit_vkitti.py:41-124).  The
frozen copy keeps only these functions, the textural stage of the fused
edit chain (pipelines/chain.py); the CLI and its loaders are taken out.
"""

from __future__ import annotations


import numpy as np


def prepare_source_begin(trainer, src_img, label_img, load_size, wh):
    """Host transforms + the netE feature-means pass for one source frame,
    the (tiny) table on its way to the host (HostFetch).  Returns a pending
    handle for prepare_source_finish; a chunked caller (the pipelined
    chain's stage B) enqueues every source before it waits for any."""
    from perfbench.reference.frozen.data.textural_data import (dense_instance_slots,
                                                    transform_image)
    from perfbench.reference.frozen.utils.transfer import HostFetch, to_device

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
    from perfbench.reference.frozen.data.textural_data import (
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
    from perfbench.reference.frozen.utils import phases
    from perfbench.reference.frozen.utils.transfer import to_device

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
        if trainer.cfg.use_global_encoder:
            # the global encoder reads the source image (JAX
            # cli/edit_vkitti.py:280-282); the codes come from the table
            host["image"] = np.stack([it["base_img_t"] for it in items])
        feat_tables = np.stack([a[2] for a in assembled])
        batch = {k: to_device(v, dev) for k, v in host.items()}
        feat_dev = to_device(feat_tables, dev)
        phases.block(batch)
        phases.add_bytes("tex.upload", feat_tables, *host.values())
    with phases.phase("tex.generate"):
        fakes = trainer.fake_inference(batch, feat_dev).cpu().numpy()
        phases.add_bytes("tex.generate", fakes)
    return list(fakes), [a[0] for a in assembled]
