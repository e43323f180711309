"""Synthetic meshes and a synthetic Virtual KITTI root for tests, smoke
runs and benchmarks."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_sphere_mesh(n_theta: int = 12, n_phi: int = 24,
                     radius: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """UV sphere with ~2*n_theta*n_phi triangles, verts in [-r, r]."""
    verts = []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.cos(th),
                          radius * np.sin(th) * np.sin(ph)])
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)


_BG_COLORS = {"Sky": (90, 200, 255), "Road": (100, 60, 100)}


def _car_color(j: int) -> Tuple[int, int, int]:
    """The scenegt colour of a scene's j-th car (distinct for j < 20)."""
    if j >= 20:
        raise ValueError("at most 20 cars per (world, topic)")
    return 200, 20 + 12 * j, 40 + 7 * j


def write_vkitti_root(root: str, frames, seed: int = 0,
                      height: int = 375, width: int = 1242) -> None:
    """A Virtual KITTI 1.3.1 layout under `root` for the data layer
    (data/vkitti.py): for each (world, topic, frame) -> list of car boxes
    (y1, x1, y2, x2) in `frames`, the RGB frame (sky and road gradient with
    noise, each car a shaded rectangle) and the scenegt PNG (one colour per
    car instance), and the scenegt encoding txt of every world x topic (the
    lookup tables read all 50).  A frame with no boxes is background
    only."""
    import os

    from PIL import Image

    from sdn3d_tpu_torch.data.vkitti import SCENE_IDS, WORLD_IDS

    rng = np.random.RandomState(seed)
    cars = {}                      # (world, topic) -> number of cars
    for (world, topic, frame), boxes in sorted(frames.items()):
        horizon = height // 3
        rgb = np.zeros((height, width, 3), np.float32)
        rgb[:horizon] = (135, 196, 235)
        rgb[horizon:] = np.linspace(90, 40, height - horizon)[:, None, None]
        rgb += rng.rand(height, width, 3) * 24
        gt = np.zeros((height, width, 3), np.uint8)
        gt[:horizon] = _BG_COLORS["Sky"]
        gt[horizon:] = _BG_COLORS["Road"]
        for (y1, x1, y2, x2) in boxes:
            j = cars.get((world, topic), 0)
            cars[(world, topic)] = j + 1
            color = np.asarray(_car_color(j), np.float32)
            rgb[y1:y2, x1:x2] = color
            rgb[y1:y2, x1:x2, 0] = np.linspace(color[0] - 40, color[0] + 40,
                                               x2 - x1)[None]
            gt[y1:y2, x1:x2] = _car_color(j)
        for sub, img in (("rgb", rgb), ("scenegt", gt)):
            d = os.path.join(root, f"vkitti_1.3.1_{sub}", world, topic)
            os.makedirs(d, exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{frame}.png"))
    gt_dir = os.path.join(root, "vkitti_1.3.1_scenegt")
    for world in WORLD_IDS:
        for scene in SCENE_IDS:
            lines = ["Category(:id) r g b"]
            lines += [f"{c} {r} {g} {b}" for c, (r, g, b) in _BG_COLORS.items()]
            lines += ["Car:{:03d} {} {} {}".format(j + 1, *_car_color(j))
                      for j in range(cars.get((world, scene), 0))]
            with open(os.path.join(
                    gt_dir, f"{world}_{scene}_scenegt_rgb_encoding.txt"),
                    "w") as f:
                f.write("\n".join(lines) + "\n")
