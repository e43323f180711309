"""The benchmark's one general traffic generator.

A traffic mix is a JSON file of parameters under perfbench/traffic/; the
functions here turn it and a seed into inputs: car meshes (written as OBJ
files in the ShapeNet layout, where the port's mesh loader reads them),
a pool of street frames with their ground-truth objects, the stream of
edit requests, and the pool of training batches.  The same seed gives the
same inputs; every seed gives the same multiset of frame sizes (cars per
frame) in another order, so the seed changes which work comes when, not
how much there is.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

# the ShapeNet (synset, model) ids the port's mesh loader reads, in its
# order: <root>/<synset>/<model>/models/model_normalized.obj
SHAPENET_CARS = (
    ("02958343", "137f67657cdc9da5f985cd98f7d73e9a"),
    ("02958343", "5343e944a7753108aa69dfdc5532bb13"),
    ("02958343", "3776e4d1e2587fd3253c03b7df20edd5"),
    ("02958343", "3ba5bce1b29f0be725f689444c7effe2"),
    ("02958343", "53a031dd120e81dc3aa562f24645e326"),
    ("02924116", "7905d83af08a0ca6dafc1d33c05cbcf8"),
    ("02958343", "a0fe4aac120d5f8a5145cad7315443b3"),
    ("02958343", "cd7feedd6041209131ac5fb37e6c8324"),
)


def seed_words(seed: int, *tags: int) -> List[int]:
    """Non-negative words for np.random.SeedSequence from any integer
    seed (negative ones and those past 64 bits included)."""
    s = int(seed)
    words = []
    for _ in range(3):
        words.append(s & 0xFFFFFFFF)
        s >>= 32
    words.append(1 if int(seed) < 0 else 0)
    return words + [int(t) for t in tags]


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, *tags)))


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for torch.Generator.manual_seed."""
    return int(np.random.SeedSequence(seed_words(seed, *tags))
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


# -- meshes -------------------------------------------------------------

def sphere_mesh(n_theta: int, n_phi: int, radius: float = 0.5):
    """A UV sphere of 2 * n_phi * (n_theta - 1) outward-wound triangles:
    n_theta + 1 rings of n_phi vertices (the poles repeated)."""
    th = np.pi * np.arange(n_theta + 1) / n_theta
    ph = 2 * np.pi * np.arange(n_phi) / n_phi
    t, p = th[:, None], ph[None, :]
    verts = np.stack([radius * np.sin(t) * np.cos(p),
                      radius * np.cos(t) * np.ones_like(p),
                      radius * np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = i * n_phi + j
    b = i * n_phi + (j + 1) % n_phi
    c, d = a + n_phi, b + n_phi
    upper = np.stack([a, c, b], -1)[1:]          # rings 1..n_theta-1
    lower = np.stack([b, c, d], -1)[:-1]         # rings 0..n_theta-2
    # the row order of the loop (i, j): ring i's upper face, then its lower
    faces = np.full((n_theta, n_phi, 2, 3), -1, np.int64)
    faces[1:, :, 0] = upper
    faces[:-1, :, 1] = lower
    faces = faces.reshape(-1, 3)
    return verts.astype(np.float32), faces[faces[:, 0] >= 0]


def car_mesh(seed: int, index: int, n_theta: int, n_phi: int):
    """A car-proportioned, bumpy closed mesh from a UV sphere."""
    v, f = sphere_mesh(n_theta, n_phi)
    r = rng(seed, 1, index)
    v = v * np.asarray([2.2, 0.8, 1.0], np.float32)
    v = v * (1.0 + 0.08 * np.sin(v[:, :1] * r.uniform(3, 6)))
    v = v + r.normal(0, 0.004, v.shape)
    return v.astype(np.float32), f


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    text = (("v %.6f %.6f %.6f\n" * len(vertices))
            % tuple(vertices.ravel().tolist())
            + ("f %d %d %d\n" * len(faces))
            % tuple((faces + 1).ravel().tolist()))
    with open(path, "w") as fh:
        fh.write(text)


def write_meshes(root: str, seed: int, meshes: Dict[str, int]) -> str:
    """meshes["count"] car meshes of meshes["n_theta"] x meshes["n_phi"]
    under `root` in the ShapeNet layout.  Returns `root`."""
    for i in range(int(meshes["count"])):
        synset, model = SHAPENET_CARS[i]
        d = os.path.join(root, synset, model, "models")
        os.makedirs(d, exist_ok=True)
        write_obj(os.path.join(d, "model_normalized.obj"),
                  *car_mesh(seed, i, int(meshes["n_theta"]),
                            int(meshes["n_phi"])))
    return root


# -- frames -------------------------------------------------------------

def car_counts(mix: Dict, n_frames: int) -> List[int]:
    """Cars a frame, spread evenly over [cars_min, cars_max]: the same
    multiset for every seed."""
    lo, hi = mix["cars"]
    return [lo + (i * (hi - lo + 1)) // n_frames for i in range(n_frames)]


def car_boxes(r: np.random.Generator, n: int, H: int, W: int):
    """n car boxes (y1, x1, y2, x2) in an H x W frame, on the lower part
    of the frame, 40-130 px high (at 375 rows) and 1.2-2.2 times wider."""
    k = H / 375.0
    hh = np.maximum(4, (r.integers(40, 130, n) * k).astype(int))
    ww = np.minimum((hh * r.uniform(1.2, 2.2, n)).astype(int), W - 2)
    yc = r.integers(int(150 * k), max(int(150 * k) + 1, H - int(20 * k)), n)
    y1 = np.clip(yc - hh // 2, 0, H - 2)
    x1 = r.integers(0, np.maximum(1, W - ww))
    return [(int(a), int(b), int(min(a + h, H)), int(min(b + w, W)))
            for a, b, h, w in zip(y1, x1, hh, ww)]


def frame_pool(seed: int, mix: Dict, frame: Dict[str, int]) -> List[Dict]:
    """mix["pool_frames"] frames: `image` [H, W, 3] uint8, and the ground
    truth the chain takes as `dets`: `class_ids` [n] int32 (1 or 2, car or
    van), `masks` [n, 1, H, W] bool (an ellipse in each box) and `rois`
    [n, 4] float32 (y1, x1, y2, x2)."""
    H, W = int(frame["height"]), int(frame["width"])
    n_frames = int(mix["pool_frames"])
    counts = car_counts(mix, n_frames)
    order = rng(seed, 2).permutation(n_frames)
    pool = []
    for slot in range(n_frames):
        n = counts[order[slot]]
        r = rng(seed, 3, slot)
        img = (r.random((H, W, 3), np.float32) * 64
               + np.linspace(0, 160, W, dtype=np.float32)[None, :, None])
        boxes = car_boxes(r, n, H, W)
        masks = np.zeros((n, 1, H, W), bool)
        for i, (a, b, c, d) in enumerate(boxes):
            yy, xx = np.mgrid[a:c, b:d]
            cy, cx = (a + c - 1) / 2, (b + d - 1) / 2
            ry, rx = max((c - a) / 2, 1), max((d - b) / 2, 1)
            masks[i, 0, a:c, b:d] = (((yy - cy) / ry) ** 2
                                     + ((xx - cx) / rx) ** 2) <= 1
        pool.append({"image": img.astype(np.uint8),
                     "class_ids": r.choice([1, 2], n).astype(np.int32),
                     "masks": masks,
                     "rois": np.asarray(boxes, np.float32).reshape(n, 4),
                     "n": n})
    return pool


# -- edit requests ------------------------------------------------------

def _num(x: float) -> str:
    return repr(float(x))


def edit_operations(r: np.random.Generator, rois: np.ndarray, H: int,
                    W: int, ops: Dict) -> List[Dict]:
    """The edit JSON's operation records of one request: with
    probability ops["p_delete"] one `delete`, and ops["modify"]
    `modify`s on average (the whole part always, one more with the
    chance of the fraction; at most the cars left), each of its own car
    (zoom, turn and a move within ops["move_px"] pixels), the modified
    cars and the deleted one all different."""
    n = len(rois)

    def center(i):
        y1, x1, y2, x2 = rois[i]
        return (x1 + x2) / 2, (y1 + y2) / 2

    m = float(ops["modify"])
    deletes = int(n > 1 and r.random() < float(ops["p_delete"]))
    k = int(math.floor(m)) + int(r.random() < m - math.floor(m))
    k = max(1, min(k, n - deletes))
    cars = r.permutation(n)
    move = float(ops["move_px"])
    out = []
    for j in cars[:k]:
        u, v = center(int(j))
        to_u = float(np.clip(u + r.uniform(-move, move), 0, W - 1))
        to_v = float(np.clip(v + r.uniform(-move, move), 0, H - 1))
        out.append({"type": "modify", "from": {"u": _num(u), "v": _num(v)},
                    "to": {"u": _num(to_u), "v": _num(to_v)},
                    "zoom": _num(r.uniform(*ops["zoom"])),
                    "ry": _num(r.uniform(*ops["ry"]))})
    if deletes:
        du, dv = center(int(cars[k]))
        out.append({"type": "delete", "from": {"u": _num(du), "v": _num(dv)}})
    return out


def edit_requests(seed: int, mix: Dict, pool: Sequence[Dict],
                  stream: int = 0, prefix: str = "s") -> Iterator[Dict]:
    """The endless request stream: sessions of mix["session_len"]
    requests on one frame of the pool under one cache key (a key no
    other session uses), each request with new operations.  Sessions
    visit the pool in a seeded order, every frame once a round.
    `stream` 0 is the measured stream, other values (warm-up) give other
    keys and draws.  Each request: image_rgb, dets, operations,
    cache_key, and `first` (the session's first request) and `cars`."""
    n_pool = len(pool)
    per = int(mix["session_len"])
    s = 0
    while True:
        order = rng(seed, 4, stream, s // n_pool).permutation(n_pool)
        fr = pool[int(order[s % n_pool])]
        H, W = fr["image"].shape[:2]
        key = f"{prefix}{stream}-{s}"
        for k in range(per):
            r = rng(seed, 5, stream, s, k)
            yield {"image_rgb": fr["image"],
                   "dets": (fr["class_ids"], fr["masks"], fr["rois"]),
                   "operations": edit_operations(r, fr["rois"], H, W,
                                                 mix["ops"]),
                   "cache_key": key, "first": k == 0, "cars": fr["n"]}
        s += 1


# -- training batches ---------------------------------------------------

def train_batches(seed: int, mix: Dict, shapes: Dict, device) -> List[Dict]:
    """mix["pool_batches"] synthetic derenderer batches made on `device`
    from the seed (the fields of the geometric_train CLI's synthetic
    batches: crops, ROIs, focal, pose targets, and the centred-square
    reprojection masks); every row of every batch differs."""
    import torch

    B, S, R = (int(shapes["batch_size"]), int(shapes["image_size"]),
               int(shapes["render_size"]))
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 6))
    n = int(mix["pool_batches"])
    u = lambda *shape: torch.rand(shape, generator=g,  # noqa: E731
                                  device=device)
    nrm = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                     device=device)
    images = u(n, B, S, S, 3)
    x0 = u(n, B, 2) * 0.8 - 0.8
    wh = u(n, B, 2) * 0.4 + 0.2
    thetas = (u(n, B, 1) * 2 - 1) * math.pi
    t2d, ls, ld = nrm(n, B, 2) * 0.1, nrm(n, B, 3) * 0.1, nrm(n, B, 1) * 0.1
    masks = torch.zeros((B, 1, R, R), device=device)
    masks[:, :, R // 4:-(R // 4), R // 4:-(R // 4)] = 1.0
    out = []
    for i in range(n):
        out.append({
            "images": images[i], "roi_norms": torch.cat([x0[i], x0[i]
                                                         + wh[i]], 1),
            "focals": torch.full((B, 1), 725.0, device=device),
            "targets": torch.full((B,), 3, dtype=torch.int32, device=device),
            "thetas": thetas[i], "translation2ds": t2d[i],
            "log_scales": ls[i], "log_depths": ld[i],
            "masks": masks, "ignores": torch.zeros_like(masks)})
    return out
