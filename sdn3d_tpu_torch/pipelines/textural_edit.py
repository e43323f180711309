"""The edit chain's textural stage (textural/edit_vkitti.py:41-124): a
source frame's textural inputs, and the generation of a batch of edit
frames from them.  The JAX package keeps these functions in its
cli/edit_vkitti.py; pipelines/chain.py, cli/edit_vkitti and
cli/edit_benchmark call them here.  The conditioning of a batch of edit
frames is built on the device (ops/edit_conditioning, one kernel launch
on the card) where the JAX package assembles it on the host (its
assemble_edit_conditioning, which the tests hold it to).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np


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
