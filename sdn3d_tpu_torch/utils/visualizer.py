"""Result visualization: label colormaps, image conversion, HTML galleries
(host-side numpy).

Copy of the corresponding part of sdn3d_tpu/utils/visualizer.py
(textural/util/util.py:12-117 tensor2im/tensor2label + the N-class
colormap, textural/util/html.py galleries with plain string templates).
The instance overlay and loss plots wait for the detection slice.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

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
