"""Image-quality metrics of the edit benchmark (textural/util/util2.py:
48-59): l2, PSNR, SSIM and DSSIM (host-side numpy) and LPIPS
(models/lpips.py, on a torch device).

Counterparts of sdn3d_tpu/utils/metrics.py.  ssim re-implements
skimage's structural_similarity with its defaults (7x7 uniform windows,
K1=0.01, K2=0.03, per-channel mean) so no skimage dependency is needed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def l2(p0: np.ndarray, p1: np.ndarray, value_range: float = 255.0) -> float:
    """Half mean squared error on [0, 1]-scaled inputs (util2.py:48-49)."""
    return float(0.5 * np.mean((p0 / value_range - p1 / value_range) ** 2))


def psnr(p0: np.ndarray, p1: np.ndarray, peak: float = 255.0) -> float:
    """(util2.py:52-53)."""
    mse = np.mean((1.0 * p0 - 1.0 * p1) ** 2)
    return float(10 * np.log10(peak ** 2 / mse))


def _uniform_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Valid-mode win x win box filter via a 2D cumulative sum."""
    c = np.cumsum(np.cumsum(img, axis=0, dtype=np.float64), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win])
    return s / (win * win)


def ssim(p0: np.ndarray, p1: np.ndarray, data_range: float = 255.0,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM, skimage-default semantics (uniform windows, per-channel
    mean over valid positions)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    if p0.ndim == 2:
        p0, p1 = p0[..., None], p1[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # sample (unbiased) covariance normalization, matching skimage
    np_ = win * win
    cov_norm = np_ / (np_ - 1)
    vals = []
    for ch in range(p0.shape[2]):
        a, b = p0[..., ch], p1[..., ch]
        ux = _uniform_filter(a, win)
        uy = _uniform_filter(b, win)
        uxx = _uniform_filter(a * a, win)
        uyy = _uniform_filter(b * b, win)
        uxy = _uniform_filter(a * b, win)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def dssim(p0: np.ndarray, p1: np.ndarray,
          value_range: float = 255.0) -> float:
    """(1 - multichannel SSIM) / 2 (util2.py:56-58)."""
    return (1.0 - ssim(p0, p1, data_range=value_range)) / 2.0


def load_lpips(path: str, device="cuda"):
    """An official-`lpips`-layout checkpoint (.pth: `net.slice{s}.{i}.*`
    vgg16 convs, `lin{k}.model.1.weight`; the layout JAX utils/port.py
    port_lpips reads) as an LPIPS module in eval mode on `device`.  Every
    conv and lin weight must be there; the scaling layer's constants may
    be missing (they are the official values either way)."""
    import torch

    from sdn3d_tpu_torch.models.lpips import LPIPS

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = LPIPS()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith("scaling_layer.")]
    if missing or unexpected:
        raise KeyError(f"{path}: not an official LPIPS (vgg) checkpoint; "
                       f"missing {missing}, unexpected {unexpected}")
    return model.to(device).eval()


_LPIPS_MODELS: Dict[str, object] = {}


def lpips(p0: np.ndarray, p1: np.ndarray, value_range: float = 255.0,
          model=None, device="cuda") -> float:
    """LPIPS perceptual distance (models/lpips.py; VGG16 variant).

    p0/p1: [H, W, 3] (or [B, H, W, 3]) in [0, value_range].  Pass a
    loaded model (load_lpips) for the calibrated metric; without one a
    process-wide random-init backbone from seed 0 on `device` is used
    (init_lpips): a deterministic multi-scale perceptual distance that is
    not calibrated to human judgments, and not the JAX package's random
    backbone (ROADMAP.md C)."""
    import torch

    from sdn3d_tpu_torch.models.lpips import init_lpips, lpips as lpips_fn

    if model is None:
        key = str(torch.device(device))
        if key not in _LPIPS_MODELS:
            _LPIPS_MODELS[key] = init_lpips(0, device)
        model = _LPIPS_MODELS[key]
    dev = next(model.parameters()).device
    x = np.asarray(p0, np.float32) / value_range * 2.0 - 1.0
    y = np.asarray(p1, np.float32) / value_range * 2.0 - 1.0
    if x.ndim == 3:
        x, y = x[None], y[None]
    d = lpips_fn(model, torch.from_numpy(x).to(dev),
                 torch.from_numpy(y).to(dev))
    return float(d.mean())
