"""Synthetic meshes, derenderer training batches and a synthetic Virtual
KITTI root for tests, smoke runs and benchmarks."""

from __future__ import annotations

from typing import Dict, Tuple

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


def make_derender_batch(batch_size: int, image_size: int = 224,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Random batch with the GT fields the derenderer losses consume
    (geometric/derender3d/datasets.py:366-391 target structure); the JAX
    package's data/synthetic.make_derender_batch, draw for draw."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-0.8, 0.0, (batch_size, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.6, (batch_size, 2)).astype(np.float32)
    roi = np.concatenate([x0, x0 + wh], axis=1)
    return {
        "images": rng.rand(batch_size, image_size, image_size, 3
                           ).astype(np.float32),
        "roi_norms": roi,
        "focals": np.full((batch_size, 1), 725.0, np.float32),
        "targets": np.full((batch_size,), 3, np.int32),  # geometry|reproject
        "thetas": rng.uniform(-np.pi, np.pi, (batch_size, 1)
                              ).astype(np.float32),
        "translation2ds": rng.randn(batch_size, 2).astype(np.float32) * 0.1,
        "log_scales": rng.randn(batch_size, 3).astype(np.float32) * 0.1,
        "log_depths": rng.randn(batch_size, 1).astype(np.float32) * 0.1,
    }


def centred_square_masks(batch_size: int, render_size: int
                         ) -> Dict[str, np.ndarray]:
    """The synthetic training batches' reprojection targets (JAX
    cli/geometric_train.py:98-108): "masks" [B, 1, R, R], one on the
    centred square from R // 4 to -R // 4, and "ignores" all zero."""
    r = render_size
    masks = np.zeros((batch_size, 1, r, r), np.float32)
    masks[:, :, r // 4:-r // 4, r // 4:-r // 4] = 1.0
    return {"masks": masks, "ignores": np.zeros_like(masks)}


_BG_COLORS = {"Sky": (90, 200, 255), "Road": (100, 60, 100)}


def _car_color(j: int) -> Tuple[int, int, int]:
    """The scenegt colour of a scene's j-th car (distinct for j < 20)."""
    if j >= 20:
        raise ValueError("at most 20 cars per (world, topic)")
    return 200, 20 + 12 * j, 40 + 7 * j


MOTGT_HEADER = ("frame tid label truncated occluded alpha l t r b w3d h3d "
                "l3d x3d y3d z3d ry rx rz truncr occupr orig_label moving "
                "model color")


def _motgt_row(frame: int, tid: int, box, ry: float) -> str:
    """A motgt line for a car of 1.5 x 1.8 x 4.2 m whose 2D box is `box`:
    the depth that makes its height span the box, its bottom on the box's
    bottom edge (the VKITTI intrinsics of data/vkitti.Camera)."""
    from sdn3d_tpu_torch.data.vkitti import Camera

    y1, x1, y2, x2 = box
    z = Camera.focal * 1.5 / max(y2 - y1, 1)
    x = ((x1 + x2) / 2 - Camera.u0) * z / Camera.focal
    y = (y2 - Camera.v0) * z / Camera.focal
    return (f"{frame} {tid} Car 0 0 {ry - np.arctan2(x, z):.4f} {x1} {y1} "
            f"{x2} {y2} 1.8 1.5 4.2 {x:.4f} {y:.4f} {z:.4f} {ry:.4f} 0 0 "
            f"0 0.95 Car True Sedan4Door Black")


def write_vkitti_root(root: str, frames, seed: int = 0,
                      height: int = 375, width: int = 1242) -> None:
    """A Virtual KITTI 1.3.1 layout under `root` for the data layer
    (data/vkitti.py, data/vkitti_derender.py): for each (world, topic,
    frame) -> list of car boxes (y1, x1, y2, x2) in `frames`, the RGB frame
    (sky and road gradient with noise, each car a shaded rectangle) and the
    scenegt PNG (one colour per car instance), the scenegt encoding txt of
    every world x topic (the lookup tables read all 50), and a motgt table
    per (world, topic) with frames (one row per car: track id j for the
    topic's j-th box, its box, a 3D pose that projects onto it and a yaw
    drawn from `seed`).  A frame with no boxes is background only."""
    import os

    from PIL import Image

    from sdn3d_tpu_torch.data.vkitti import SCENE_IDS, WORLD_IDS

    rng = np.random.RandomState(seed)
    yaw = np.random.RandomState(seed + 1)
    cars = {}                      # (world, topic) -> number of cars
    motgt = {}                     # (world, topic) -> motgt lines
    for (world, topic, frame), boxes in sorted(frames.items()):
        motgt.setdefault((world, topic), [])
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
            motgt[(world, topic)].append(_motgt_row(
                int(frame), j, (y1, x1, y2, x2), yaw.uniform(-np.pi, np.pi)))
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
            lines += ["Car:{} {} {} {}".format(j, *_car_color(j))
                      for j in range(cars.get((world, scene), 0))]
            with open(os.path.join(
                    gt_dir, f"{world}_{scene}_scenegt_rgb_encoding.txt"),
                    "w") as f:
                f.write("\n".join(lines) + "\n")
    mot_dir = os.path.join(root, "vkitti_1.3.1_motgt")
    os.makedirs(mot_dir, exist_ok=True)
    for (world, topic), rows in motgt.items():
        with open(os.path.join(mot_dir, f"{world}_{topic}.txt"), "w") as f:
            f.write("\n".join([MOTGT_HEADER] + rows) + "\n")
