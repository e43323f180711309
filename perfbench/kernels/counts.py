"""Bytes and operations of the port's three hand-written kernels, counted
from their shapes and data, and the cards' peaks; copies of the formulas
of the port's bring-up script (chip_smoke.py: B1 at its phase 5,
walk_bound for B3, B2's reduction bound) and of utils/flops.PEAKS.

Each bound is the least time the card could take: the larger of the
bytes over the HBM peak and the operations over the float32 peak.  Bytes
count each input read once and each output written once.  Where only
bytes are counted (B3, whose operations depend on the walk's data), the
bound is a floor of the kernel's least time, so a share of it is a floor
too."""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheets, dense: float32 outside the tensor cores, bfloat16
# on them, HBM bytes/s; at the card's full power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "hbm": 3.35e12},            # SXM5, 700 W
    "NVIDIA H100 PCIe": {"float32": 51e12, "bfloat16": 756e12,
                         "hbm": 2.0e12},
    "NVIDIA H100 NVL": {"float32": 60e12, "bfloat16": 835e12,
                        "hbm": 3.9e12},
}

EDGE_TEST_FLOPS = 15        # 3 edge functions: 6 sub, 6 mul, 3 cmp
REDUCE_FLOPS = 6            # one add per plane for a won pixel


def peaks_for(name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named `name`, or of the longest entry its
    name starts with; None for a card not listed."""
    if name in PEAKS:
        return PEAKS[name]
    prefixes = [k for k in PEAKS if name.startswith(k)]
    return PEAKS[max(prefixes, key=len)] if prefixes else None


def face_box_pairs(faces, ok, S: int) -> int:
    """(face, pixel) pairs inside the pixel boxes of the faces that can
    win: the edge tests B1 needs.  faces [B, F, 3, 3] screen space."""
    import torch
    pix = ((faces[..., :2].double() + 1.0) * S - 1.0) * 0.5
    ok = ok & torch.isfinite(pix).all(-1).all(-1)
    pix = torch.nan_to_num(pix)
    lo = torch.clamp(torch.ceil(pix.amin(2)), 0, S)
    hi = torch.clamp(torch.floor(pix.amax(2)), -1, S - 1)
    area = torch.clamp(hi - lo + 1, min=0).prod(-1) * ok
    return int(area.sum())


def b1_bytes(B: int, F: int, S: int, colours: bool = True) -> int:
    """Forward rasterizer: the faces (36 B) and their valid flag (1 B)
    read, face index and depth (4 + 4 B) of every pixel written; with
    `colours` (the normal colours a render of normal maps passes) also
    their colours (12 B a face) read and RGB (12 B a pixel) written.  A
    silhouette render, as in a training step, passes none."""
    face, pixel = 36 + 1, 4 + 4
    if colours:
        face, pixel = face + 12, pixel + 12
    return B * F * face + B * S * S * pixel


def b1_ops(pairs: float) -> float:
    return pairs * EDGE_TEST_FLOPS


def b3_bytes(B: int, F: int, S: int) -> int:
    """The walk, both axes: alpha, its gradient and the face index read
    (3 planes of 4 B), the face pixel table [B, F, 6] read, 3 planes
    written per axis."""
    return 3 * 4 * B * S * S + B * F * 6 * 4 + 2 * 3 * 4 * B * S * S


def b2_bytes(B: int, F: int, S: int, won: int) -> int:
    """The pixel-to-face reduction: the face index of every pixel, the
    six planes of the won pixels, the sums written once per face."""
    return B * S * S * 4 + won * 6 * 4 + B * F * 6 * 4


def b2_ops(won: int) -> float:
    return float(won) * REDUCE_FLOPS


def bound_s(nbytes: float, ops: float, peaks: Dict[str, float]) -> float:
    return max(nbytes / peaks["hbm"], ops / peaks["float32"])
