"""Fixed-shape non-maximum suppression, PyTorch port.

PyTorch counterpart of sdn3d_tpu/ops/nms.py (the Faster R-CNN CUDA NMS,
geometric/maskrcnn/nms/src/cuda/nms_kernel.cu): a dense IoU matrix with
pixel-inclusive areas (x2 - x1 + 1) and greedy suppression over boxes
already sorted by descending score.  Every function takes an optional
leading batch axis ([B, N, 4]), which the batched detector uses.

The JAX package runs the greedy pass as N steps of `lax.fori_loop`.  On the
card N steps would be N rounds of launches (6000 boxes a frame at the RPN),
so the port iterates

    keep <- valid & ~any_j(keep[j] & over[j, i] & j < i)

as one masked product a step until it stops changing.  Row i depends only
on rows j < i, so the greedy keep mask is the map's unique fixed point, and
it is reached after (longest chain of suppressions + 1) steps, whatever N
is.  `NMS_STEPS_PER_CHECK` steps run between two checks for the fixed
point; each check reads one flag on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NMS_STEPS_PER_CHECK = 4


def iou_matrix(boxes: torch.Tensor, plus_one: bool = True) -> torch.Tensor:
    """Pairwise IoU [..., N, N]; boxes [..., N, 4] as (y1, x1, y2, x2) or
    any consistent (lo0, lo1, hi0, hi1) layout.  The JAX package's
    operations in its order."""
    off = 1.0 if plus_one else 0.0
    lo, hi = boxes[..., :2], boxes[..., 2:]
    area = (hi[..., 0] - lo[..., 0] + off) * (hi[..., 1] - lo[..., 1] + off)

    def side(k):
        top = torch.minimum(hi[..., :, None, k], hi[..., None, :, k])
        bot = torch.maximum(lo[..., :, None, k], lo[..., None, :, k])
        return (top - bot + off).clamp(min=0.0)

    inter = side(0) * side(1)
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def nms(boxes: torch.Tensor, threshold: float,
        valid: Optional[torch.Tensor] = None,
        stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes [..., N, 4] -> keep mask [..., N]
    bool: box i is kept iff it is valid and no earlier kept box overlaps
    it with IoU > threshold (NaN IoUs suppress nothing).  `stats`, when
    given, receives the number of fixed-point steps run ("steps")."""
    batched = boxes.dim() == 3
    b = boxes if batched else boxes[None]
    over = iou_matrix(b.float()) > threshold               # [B, N(j), N(i)]
    v = (torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
         if valid is None else (valid if batched else valid[None]))
    over &= v[:, :, None] & v[:, None, :]
    # only an earlier box (j < i) suppresses a later one
    sup = torch.triu(over, diagonal=1).float()
    keep = v
    steps = 0
    while True:
        for _ in range(NMS_STEPS_PER_CHECK):
            hit = torch.bmm(keep.float()[:, None], sup)[:, 0]
            prev, keep = keep, v & (hit == 0)
        steps += NMS_STEPS_PER_CHECK
        if torch.equal(prev, keep):
            break
    if stats is not None:
        stats["steps"] = steps
    return keep if batched else keep[0]


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
               max_out: int, valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort by score (stable, NaNs last, as jnp.argsort), suppress, return
    (indices [..., max_out] into the input order, valid [..., max_out]):
    the surviving boxes' indices compacted to the front in score order,
    padded with 0s."""
    batched = boxes.dim() == 3
    b = boxes if batched else boxes[None]
    s = scores if batched else scores[None]
    order = torch.argsort(-s, dim=1, stable=True)
    sorted_boxes = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    sorted_valid = None
    if valid is not None:
        sorted_valid = torch.gather(valid if batched else valid[None], 1,
                                    order)
    keep = nms(sorted_boxes, threshold, sorted_valid)

    # stable-compact the kept indices to the front: slot max_out is a
    # dump for the suppressed boxes and those past max_out
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep, rank, max_out).clamp(max=max_out)
    out = torch.zeros(b.shape[0], max_out + 1, dtype=order.dtype,
                      device=b.device)
    out.scatter_(1, slot, order)
    n_keep = keep.sum(1, keepdim=True)
    out_valid = (torch.arange(max_out, device=b.device)[None]
                 < n_keep.clamp(max=max_out))
    out = out[:, :max_out]
    return (out, out_valid) if batched else (out[0], out_valid[0])
