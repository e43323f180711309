"""Image-quality metrics of the edit benchmark (textural/util/util2.py:
48-59), host-side numpy: PSNR and SSIM.

Copy of those two in sdn3d_tpu/utils/metrics.py; LPIPS waits for
models/lpips.py.  ssim re-implements skimage's structural_similarity with
its defaults (7x7 uniform windows, K1=0.01, K2=0.03, per-channel mean) so
no skimage dependency is needed.
"""

from __future__ import annotations

import numpy as np


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
