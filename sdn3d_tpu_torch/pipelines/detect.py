"""Mask R-CNN detection: mold -> network -> unmold, PyTorch port.

PyTorch counterpart of sdn3d_tpu/pipelines/detect.py (maskrcnn/model.py:
1610-1654 detect, :2046-2082 mold_inputs, :2084-2128 unmold_detections).
The molded frame goes to the device as uint8 (the mean is subtracted
there), and ONE packed float32 buffer per frame comes back: the
detections [D, 6], their validity [D] and each detection's own-class mask
plane [D, mh, mw] (the host never reads the other classes' planes).  The
copy to the host is started without waiting (utils/transfer.HostFetch), so
a caller can enqueue several frames before it unmolds any.

Each entry point records the spans `det.mold` (the host resize and pad),
`det.net` (the enqueue of the network and of the packed copy) and
`det.unmold` (the wait for the copy and the host unmold: the masks'
resizes in `unmold`, their pastes in `Unmolded.paste`), and the counter
`count.det.valid` (the detections the network marked valid) (utils/phases).

The detector holds its model on `device`; every entry point runs there.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                             generate_pyramid_anchors,
                                             init_weights)
from sdn3d_tpu_torch.utils import phases
from sdn3d_tpu_torch.utils.transfer import HostFetch, constant, to_device


def resize_image(image: np.ndarray, min_dim: int, max_dim: int
                 ) -> Tuple[np.ndarray, Tuple[int, int, int, int], float]:
    """maskrcnn/utils.py:272-335: scale so the short side is >= min_dim and
    the long side <= max_dim (PIL bilinear), then pad to (max_dim,
    max_dim).  Returns (molded, window, scale)."""
    from PIL import Image as PILImage

    h, w = image.shape[:2]
    scale = max(1.0, min_dim / min(h, w))
    if round(max(h, w) * scale) > max_dim:
        scale = max_dim / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = np.asarray(PILImage.fromarray(image).resize((nw, nh),
                                                      PILImage.BILINEAR))
    top = (max_dim - nh) // 2
    left = (max_dim - nw) // 2
    out = np.zeros((max_dim, max_dim, 3), image.dtype)
    out[top:top + nh, left:left + nw] = img
    window = (top, left, top + nh, left + nw)
    return out, window, scale


def pack_outputs(out) -> torch.Tensor:
    """The network's outputs -> [F, D * 6 + D + D * mh * mw] float32:
    detections, validity and each detection's own-class mask plane."""
    dets = out["detections"].float()                       # [F, D, 6]
    valid = out["det_valid"].float()                       # [F, D]
    masks = out["masks"]                                   # [F, D, C, mh, mw]
    cid = dets[..., 4].long().clamp(0, masks.shape[2] - 1)
    own = torch.gather(masks, 2, cid[..., None, None, None].expand(
        -1, -1, 1, *masks.shape[3:]))[:, :, 0]
    Fr = dets.shape[0]
    return torch.cat([dets.reshape(Fr, -1), valid,
                      own.float().reshape(Fr, -1)], dim=1)


class MaskRCNNDetector:
    """The Mask R-CNN serving path on one device.  Build, then `init(seed)`
    (random weights) or `load_state_dict(sd)` (the reference layout, e.g.
    utils/port.maskrcnn_state_dict_from_jax)."""

    def __init__(self, config: MaskRCNNConfig = MaskRCNNConfig(),
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device")
        self.model = MaskRCNN(config).eval()
        self.anchors = generate_pyramid_anchors(config)
        self._anchors_dev = None

    def init(self, seed: int) -> "MaskRCNNDetector":
        """Random weights from `seed` (models/maskrcnn.init_weights: a
        torch.Generator of its own, drawn on the CPU), on the device."""
        init_weights(self.model, seed)
        self.model.to(self.device)
        return self

    def load_state_dict(self, sd) -> "MaskRCNNDetector":
        self.model.load_state_dict(sd)
        self.model.to(self.device)
        return self

    def _packed(self, molded: Sequence[np.ndarray],
                windows: Sequence[Tuple[int, int, int, int]]) -> torch.Tensor:
        """uint8 molded frames -> packed buffers [F, P] on the device."""
        dev = self.device
        if self._anchors_dev is None:
            self._anchors_dev = to_device(self.anchors, dev)
        imgs = to_device(np.stack(molded), dev)
        wins = to_device(np.asarray(windows, np.float32), dev)
        mean = constant(tuple(self.config.mean_pixel), torch.float32, dev)
        with torch.no_grad():
            x = (imgs.float() - mean).permute(0, 3, 1, 2).contiguous()
            return pack_outputs(self.model(x, self._anchors_dev, wins))

    def detect_begin(self, image_rgb: np.ndarray):
        """Enqueue one frame's detection with its copy to the host started;
        returns the pending handle for detect_finish."""
        cfg = self.config
        with phases.phase("det.mold"):
            molded, window, scale = resize_image(
                image_rgb, cfg.image_min_dim, cfg.image_max_dim)
        with phases.phase("det.net"):
            fetch = phases.block(HostFetch(
                self._packed([molded], [window])[0]))
        phases.add_bytes("det.detect", molded, fetch)
        return (fetch, window, scale, image_rgb.shape[:2])

    def unmold(self, pending, mask_threshold: float = 0.5) -> "Unmolded":
        """detect_begin's packed copy unmolded to the original frame, its
        masks not yet pasted (Unmolded)."""
        fetch, window, scale, hw = pending
        with phases.phase("det.unmold"):
            return self._unmold_packed(fetch.result(), window, scale, hw,
                                       mask_threshold)

    def detect_finish(self, pending, mask_threshold: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """detect_begin's packed copy unmolded to (class_ids [N], masks
        [N, 1, H, W], rois [N, 4] original-frame pixels)."""
        return self.unmold(pending, mask_threshold).paste()

    def detect(self, image_rgb: np.ndarray, mask_threshold: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image_rgb [H, W, 3] uint8 -> (class_ids [N], masks [N, 1, H, W],
        rois [N, 4] pixels of the original frame): detect_finish of
        detect_begin."""
        return self.detect_finish(self.detect_begin(image_rgb),
                                  mask_threshold)

    def detect_begin_batch(self, images_rgb: Sequence[np.ndarray],
                           pad_to: int = None):
        """One batched pass for N frames (its copy started); `pad_to` >= N
        repeats the last frame so that every chunk of a chained run has
        the same batch, and detect_finish_batch drops the padding.  N == 1
        without padding is detect_begin.  No frames: an empty result (the
        JAX package raises IndexError there)."""
        n = len(images_rgb)
        if n == 0:
            return ("batch", None, [])
        pad_to = pad_to or n
        if pad_to < n:
            raise ValueError(f"pad_to {pad_to} < {n} frames")
        if pad_to == 1:
            return ("one", self.detect_begin(images_rgb[0]))
        cfg = self.config
        molded_l, metas = [], []
        with phases.phase("det.mold"):
            for img in images_rgb:
                molded, window, scale = resize_image(
                    img, cfg.image_min_dim, cfg.image_max_dim)
                molded_l.append(molded)
                metas.append((window, scale, img.shape[:2]))
        molded_l += [molded_l[-1]] * (pad_to - n)
        windows = [m[0] for m in metas] + [metas[-1][0]] * (pad_to - n)
        with phases.phase("det.net"):
            fetch = phases.block(HostFetch(self._packed(molded_l, windows)))
        phases.add_bytes("det.detect", *molded_l, fetch)
        return ("batch", fetch, metas)

    def unmold_batch(self, pending, mask_threshold: float = 0.5
                     ) -> List["Unmolded"]:
        """-> one Unmolded per real frame of detect_begin_batch's copy."""
        if pending[0] == "one":
            return [self.unmold(pending[1], mask_threshold)]
        _, fetch, metas = pending
        if not metas:
            return []
        with phases.phase("det.unmold"):
            packed = fetch.result()
            return [self._unmold_packed(packed[i], window, scale, hw,
                                        mask_threshold)
                    for i, (window, scale, hw) in enumerate(metas)]

    def detect_finish_batch(self, pending, mask_threshold: float = 0.5
                            ) -> List[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
        """-> one (class_ids, masks, rois) per real frame."""
        return [u.paste() for u in self.unmold_batch(pending,
                                                     mask_threshold)]

    def detect_batch(self, images_rgb: Sequence[np.ndarray],
                     mask_threshold: float = 0.5):
        """N frames -> list of (class_ids, masks, rois) from one pass."""
        return self.detect_finish_batch(self.detect_begin_batch(images_rgb),
                                        mask_threshold)

    def _unmold_packed(self, packed: np.ndarray, window, scale, hw,
                       mask_threshold: float = 0.5) -> "Unmolded":
        """Host unmold of one frame's packed buffer (model.py:2084-2128),
        up to the paste."""
        from PIL import Image as PILImage

        cfg = self.config
        D = cfg.detection_max_instances
        mh, mw = cfg.mask_shape
        H, W = hw
        dets = packed[:D * 6].reshape(D, 6)           # pixels (molded)
        valid = packed[D * 6:D * 7] > 0.5
        own_masks = packed[D * 7:].reshape(D, mh, mw)
        phases.count("count.det.valid", int(valid.sum()))

        # a resized byte b is mask where float32(b) / 255 >= threshold,
        # which grows with b: where b >= the first byte that passes
        first = int(np.searchsorted(np.arange(256, dtype=np.float32) / 255.0
                                    >= mask_threshold, True))
        class_ids, crops, rois = [], [], []
        for i in range(len(dets)):
            if not valid[i]:
                continue
            y1, x1, y2, x2, cid, _ = dets[i]
            cid = int(cid)
            if cid <= 0:
                continue
            if not np.isfinite([y1, x1, y2, x2]).all():
                continue
            if y2 <= y1 or x2 <= x1:
                continue
            # back to original-image pixels (utils.py:410-419)
            oy1 = (y1 - window[0]) / scale
            ox1 = (x1 - window[1]) / scale
            oy2 = (y2 - window[0]) / scale
            ox2 = (x2 - window[1]) / scale
            oy1, oy2 = np.clip([oy1, oy2], 0, H)
            ox1, ox2 = np.clip([ox1, ox2], 0, W)
            if oy2 - oy1 < 1 or ox2 - ox1 < 1:
                continue
            class_ids.append(cid)
            crops.append(np.asarray(PILImage.fromarray(
                (own_masks[i] * 255).astype(np.uint8)).resize(
                (int(ox2 - ox1), int(oy2 - oy1)), PILImage.BILINEAR))
                >= first)
            rois.append([oy1, ox1, oy2, ox2])
        return Unmolded(np.asarray(class_ids, np.int32), crops,
                        np.asarray(rois, np.float32).reshape(-1, 4), hw)


class Unmolded(NamedTuple):
    """One frame's detections on the original frame before their masks
    are pasted: class_ids [N] int32, crops (N bool masks, each the size
    of its box), rois [N, 4] float32 (y1, x1, y2, x2) pixels, hw the
    frame's (H, W).  A cap picks from them by `areas()` and pastes only
    what it keeps (pipelines/derender_infer.keep_largest_unmolded)."""
    class_ids: np.ndarray
    crops: List[np.ndarray]
    rois: np.ndarray
    hw: Tuple[int, int]

    def areas(self) -> np.ndarray:
        """Each mask's pixel count, float32: what the float32 sum of its
        pasted plane gives (a count, exact in float32)."""
        return np.asarray([c.sum() for c in self.crops], np.float32)

    def paste(self, keep: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(class_ids [K], masks [K, 1, H, W] float32, rois [K, 4]) of the
        detections `keep` (indices, in their order; every one when None),
        each mask pasted into its full-frame plane of one array."""
        if keep is None:
            keep = np.arange(len(self.crops))
        H, W = self.hw
        rois = self.rois[keep]
        with phases.phase("det.unmold"):
            masks = np.zeros((len(keep), 1, H, W), np.float32)
            for full, k, (top, left, _, _) in zip(masks, keep, rois):
                m = self.crops[k]
                full[0, int(top):int(top) + m.shape[0],
                     int(left):int(left) + m.shape[1]] = m
        return self.class_ids[keep], masks, rois
