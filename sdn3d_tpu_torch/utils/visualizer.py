"""Result visualization: label colormaps, image conversion, HTML galleries,
instance overlays and loss plots (host-side numpy).

Copy of sdn3d_tpu/utils/visualizer.py (textural/util/util.py:12-117
tensor2im/tensor2label + the N-class colormap, textural/util/html.py
galleries with plain string templates, maskrcnn/visualize.py's
display_instances and plot_loss).  plot_loss needs matplotlib, which it
imports when called; nothing on a card path calls it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _uint8_colormap(n: int) -> np.ndarray:
    """Bit-reversal colormap (util/util.py:71-101 labelcolormap)."""
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r = r | (bitget(c, 0) << (7 - j))
            g = g | (bitget(c, 1) << (7 - j))
            b = b | (bitget(c, 2) << (7 - j))
            c = c >> 3
        cmap[i] = (r, g, b)
    return cmap


def tensor2im(image: np.ndarray) -> np.ndarray:
    """[-1,1] float [H, W, 3] -> uint8 (util/util.py:12-21)."""
    img = (np.asarray(image) + 1.0) / 2.0 * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def tensor2label(label: np.ndarray, n_label: int) -> np.ndarray:
    """int label map [H, W] -> colorized uint8 [H, W, 3]
    (util/util.py:25-41)."""
    cmap = _uint8_colormap(max(n_label + 1, int(label.max()) + 2))
    return cmap[np.clip(label.astype(np.int64), 0, len(cmap) - 1)]


class HTMLGallery:
    """Minimal HTML image-gallery writer (util/html.py:6-63 semantics)."""

    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.rows: List[Tuple[List[str], List[str]]] = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_images(self, visuals: Dict[str, np.ndarray], name: str) -> None:
        from PIL import Image

        paths, labels = [], []
        for key, img in visuals.items():
            fname = f"{name}_{key}.png"
            Image.fromarray(np.asarray(img)).save(
                os.path.join(self.img_dir, fname))
            paths.append(f"images/{fname}")
            labels.append(key)
        self.rows.append((paths, labels))

    def save(self) -> str:
        rows_html = []
        for paths, labels in self.rows:
            cells = "".join(
                f'<td><p>{lab}</p><img src="{p}" style="max-width:256px"/>'
                f"</td>" for p, lab in zip(paths, labels))
            rows_html.append(f"<tr>{cells}</tr>")
        html = (f"<html><head><title>{self.title}</title></head><body>"
                f"<h1>{self.title}</h1><table border='1'>"
                + "".join(rows_html) + "</table></body></html>")
        out = os.path.join(self.web_dir, "index.html")
        with open(out, "w") as f:
            f.write(html)
        return out


def display_instances(image: np.ndarray, boxes: np.ndarray,
                      masks: np.ndarray, class_ids: np.ndarray,
                      class_names: Sequence[str],
                      scores: Optional[np.ndarray] = None,
                      alpha: float = 0.5) -> np.ndarray:
    """Instance overlay (maskrcnn/visualize.py display_instances): colored
    masks + box outlines burned into the image.  Returns uint8."""
    out = np.asarray(image).astype(np.float32).copy()
    cmap = _uint8_colormap(max(len(boxes) + 1, 8)).astype(np.float32)
    for i in range(len(boxes)):
        color = cmap[i + 1]
        m = masks[i, 0] if masks.ndim == 4 else masks[i]
        sel = m > 0.5
        out[sel] = out[sel] * (1 - alpha) + color * alpha
        y1, x1, y2, x2 = [int(v) for v in boxes[i]]
        y1, y2 = np.clip([y1, y2], 0, out.shape[0] - 1)
        x1, x2 = np.clip([x1, x2], 0, out.shape[1] - 1)
        out[y1, x1:x2] = color
        out[y2, x1:x2] = color
        out[y1:y2, x1] = color
        out[y1:y2, x2] = color
    return np.clip(out, 0, 255).astype(np.uint8)


def plot_loss(records: Sequence[Dict[str, float]], out_path: str,
              keys: Optional[Sequence[str]] = None,
              step_key: str = "step") -> str:
    """Loss curves from metric records to a PNG
    (maskrcnn/visualize.py:405-421 plot_loss, without the interactive
    matplotlib backend).  `records` is e.g. MetricsLogger.read_all()."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if keys is None:
        keys = sorted({k for r in records for k in r
                       if k != step_key and isinstance(r[k], (int, float))})
    steps = [r.get(step_key, i) for i, r in enumerate(records)]
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        xs = [s for s, r in zip(steps, records) if k in r]
        ys = [r[k] for r in records if k in r]
        ax.plot(xs, ys, label=k)
    ax.set_xlabel(step_key)
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
