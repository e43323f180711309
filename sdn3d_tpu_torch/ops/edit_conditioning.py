"""The textural stage's edit-time conditioning on the device.

Counterpart of the host assembly in cli/edit_vkitti.assemble_edit_conditioning
(data/textural_data.assemble_condition_maps, then dense_instance_slots and
the per-slot code table, textural/edit_vkitti.py:62-107), computed from
lookup tables: a frame's object table (`frame_table`, from its JSON) and
its source's code table (`source_table`, once a source).

`edit_conditioning` runs on the device of its inputs: the kernel
csrc/edit_conditioning.cu (one launch for the whole batch, one block a
frame) for CUDA tensors, `edit_conditioning_plain` for CPU tensors.  The
two agree bit for bit; both give the generator the integers and code rows
that the host assembly gave it (the label as uint8, as it was uploaded).
`edit_conditioning_cuda.launches` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from sdn3d_tpu_torch.data.textural_data import CLASS_LABEL, POSE_BINS
from sdn3d_tpu_torch.utils.transfer import to_device

TABLE = 256          # object-table entries a frame: the uint8 plane's values
CODES = 256          # code-table rows a source: its uint8 label values
ID_BITS = 512        # label values 1..256, then k * 1000 at 256 + k


class SourceTable(NamedTuple):
    """One source frame's side of the conditioning, on the device."""
    label: torch.Tensor      # [H, W] uint8: the transformed label plane
    codes: torch.Tensor      # [CODES, feat_num] float32: by raw label value


class Conditioning(NamedTuple):
    """A batch's generator conditioning, [N, H, W] planes on the device;
    with the raw instance plane, the generator's whole integer input."""
    label: torch.Tensor      # uint8: +1 shift, car/van removed, objects set
    pose: torch.Tensor       # uint8: pose bin at object pixels, else 0
    slots: torch.Tensor      # uint8: dense slot of each pixel's id
    feat: torch.Tensor       # [N, max_instances, feat_num] float32
    nids: torch.Tensor       # [N] int32: distinct ids of each frame


def frame_table(json_obj: Mapping) -> np.ndarray:
    """A frame's object table [2, TABLE] uint8 from its per-object JSON:
    row 0 each instance index's label override (2 car, 12 van; 0 none),
    row 1 its pose bin, np.digitize(alpha / pi, POSE_BINS) in float64.
    Later entries of one index win, as assemble_condition_maps' loop
    leaves them; an index outside the uint8 plane's values marks no
    pixel."""
    keys, labels, alphas = [], [], []
    for k_str, v in json_obj.items():
        keys.append(int(k_str))
        labels.append(CLASS_LABEL.get(int(v["class_id"]), 2))
        alphas.append(float(v["alpha"]))
    table = np.zeros((2, TABLE), np.uint8)
    bins = np.digitize(np.asarray(alphas, np.float64) / np.pi, POSE_BINS)
    for k, lab, b in zip(keys, labels, bins):
        if 0 <= k < TABLE:
            table[0, k] = lab
            table[1, k] = b
    return table


def source_table(base_label: np.ndarray, mapping: Dict[int, int],
                 feats: torch.Tensor) -> SourceTable:
    """The source's table from its transformed label map [H, W] (raw ids
    0..255), dense_instance_slots' id -> slot map of it and its feature
    means [max_instances, feat_num] on the device: the label plane as
    uint8, and per raw label value the means row of its slot (zeros for a
    value without one).  Uploads the plane and a 256-entry index; the rows
    are gathered on the device, so nothing waits for the feature pass."""
    label = np.asarray(base_label)
    if label.size and (label.min() < 0 or label.max() >= CODES):
        raise ValueError(f"source label values must lie in [0, {CODES}), "
                         f"got [{label.min()}, {label.max()}]")
    M = feats.shape[0]
    index = np.full(CODES, M, np.int64)
    for value, slot in mapping.items():
        index[value] = slot
    rows = torch.cat([feats.float(), feats.new_zeros(1, feats.shape[1],
                                                     dtype=torch.float32)])
    dev = feats.device
    return SourceTable(to_device(label.astype(np.uint8), dev),
                       rows[to_device(index, dev)])


def _check(inst, src_labels, src_index, tables, codes, max_instances):
    N = inst.shape[0]
    S = src_labels.shape[0]
    if inst.dim() != 3 or src_labels.shape[1:] != inst.shape[1:]:
        raise ValueError(f"inst [N, H, W] and src_labels [S, H, W] must "
                         f"share H, W: {tuple(inst.shape)}, "
                         f"{tuple(src_labels.shape)}")
    if codes.dim() != 3 or codes.shape[:2] != (S, CODES):
        raise ValueError(f"codes must be [S, {CODES}, F], got "
                         f"{tuple(codes.shape)}")
    want = {"inst": (inst, torch.uint8, None),
            "src_labels": (src_labels, torch.uint8, None),
            "src_index": (src_index, torch.int32, (N,)),
            "tables": (tables, torch.uint8, (N, 2, TABLE)),
            "codes": (codes, torch.float32, None)}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or t.device != inst.device \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{inst.device}" + (f" of shape {shape}"
                                                 if shape else "")
                             + f", got {t.dtype} {tuple(t.shape)} on "
                               f"{t.device}")
    if not 0 < max_instances <= 256:
        raise ValueError(f"max_instances must lie in (0, 256] (uint8 "
                         f"slots), got {max_instances}")
    if N == 0:
        raise ValueError("empty batch")


def edit_conditioning_plain(inst: torch.Tensor, src_labels: torch.Tensor,
                            src_index: torch.Tensor, tables: torch.Tensor,
                            codes: torch.Tensor,
                            max_instances: int) -> Conditioning:
    """The kernel's twin in PyTorch: the same outputs from table lookups,
    a presence scatter over the 512 ids and its cumulative sum.  inst
    [N, H, W] uint8 (instance index k, 0 = background); src_labels
    [S, H, W] uint8 (raw ids); src_index [N] int32, each frame's source;
    tables [N, 2, 256] uint8 (`frame_table`); codes [S, 256, F] float32
    (`source_table`).  Runs on the device of its inputs."""
    _check(inst, src_labels, src_index, tables, codes, max_instances)
    N, H, W = inst.shape
    M, F = max_instances, codes.shape[2]
    dev = inst.device
    k = inst.long().reshape(N, -1)
    segm = src_labels.long().reshape(src_labels.shape[0], -1)[
        src_index.long()] + 1
    segm = torch.where((segm == 2) | (segm == 12), 5, segm)
    over = torch.gather(tables[:, 0].long(), 1, k)
    label = torch.where(over != 0, over, segm)           # 1..256
    pose = torch.gather(tables[:, 1], 1, k)
    bit = torch.where(k != 0, 256 + k, label)
    present = torch.zeros((N, ID_BITS), dtype=torch.bool, device=dev)
    present.scatter_(1, bit, True)
    rank = present.long().cumsum(1) - 1                # rank of present ids
    slot_of = torch.where(rank < M, rank, 0)
    slots = torch.gather(slot_of, 1, bit)
    rows = torch.cat([codes, codes.new_zeros(codes.shape[0],
                                             ID_BITS - CODES, F)], 1)
    keep = present & (rank < M)
    feat = torch.zeros((N * M, F), dtype=torch.float32, device=dev)
    frame = torch.arange(N, device=dev)[:, None].expand(N, ID_BITS)
    feat[(frame * M + rank)[keep]] = rows[src_index.long()][keep]
    shape = (N, H, W)
    # the label as the generator reads it: uint8, so 256 is 0
    return Conditioning((label & 255).to(torch.uint8).reshape(shape),
                        pose.reshape(shape),
                        slots.to(torch.uint8).reshape(shape),
                        feat.reshape(N, M, F),
                        present.sum(1).to(torch.int32))


def edit_conditioning_cuda(inst: torch.Tensor, src_labels: torch.Tensor,
                           src_index: torch.Tensor, tables: torch.Tensor,
                           codes: torch.Tensor,
                           max_instances: int) -> Conditioning:
    """Launch csrc/edit_conditioning.cu once for the batch, one block a
    frame; the arguments of `edit_conditioning_plain`, on the card.  A
    frame whose src_index lies outside [0, S) comes back with nids -1."""
    from sdn3d_tpu_torch.ops.rasterize_cuda import _launch, _stream

    if not inst.is_cuda:
        raise ValueError("edit_conditioning_cuda needs CUDA tensors")
    _check(inst, src_labels, src_index, tables, codes, max_instances)
    N, H, W = inst.shape
    S, F = src_labels.shape[0], codes.shape[2]
    dev = inst.device
    u8 = dict(dtype=torch.uint8, device=dev)
    out = Conditioning(torch.empty((N, H, W), **u8),
                       torch.empty((N, H, W), **u8),
                       torch.empty((N, H, W), **u8),
                       torch.empty((N, max_instances, F),
                                   dtype=torch.float32, device=dev),
                       torch.empty((N,), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        _launch("edit_conditioning", "sdn3d_edit_conditioning",
                inst.data_ptr(), src_labels.data_ptr(), src_index.data_ptr(),
                tables.data_ptr(), codes.data_ptr(), N, S, H * W,
                int(max_instances), F, out.label.data_ptr(),
                out.pose.data_ptr(), out.slots.data_ptr(),
                out.feat.data_ptr(), out.nids.data_ptr(), _stream(dev))
    edit_conditioning_cuda.launches += 1
    return out


edit_conditioning_cuda.launches = 0


def edit_conditioning(inst: torch.Tensor, src_labels: torch.Tensor,
                      src_index: torch.Tensor, tables: torch.Tensor,
                      codes: torch.Tensor,
                      max_instances: int) -> Conditioning:
    """The batch's conditioning on the device of `inst`: the kernel for a
    CUDA tensor, the plain twin for a CPU one."""
    if inst.is_cuda:
        return edit_conditioning_cuda(inst, src_labels, src_index, tables,
                                      codes, max_instances)
    if inst.device.type != "cpu":
        raise ValueError(f"no edit conditioning for device {inst.device}")
    return edit_conditioning_plain(inst, src_labels, src_index, tables,
                                   codes, max_instances)
