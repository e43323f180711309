#!/usr/bin/env python3
"""Drive the PyTorch port (sdn3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (any failure exits non-zero):
  1. the card: requires torch.cuda; prints nvidia-smi's name and power limit;
  2. build: compiles the CUDA rasterizer (csrc/rasterize.cu) from source;
  3. kernel vs plain: the kernel against its plain PyTorch version on the
     card (2 x 37 random faces at 128^2; 2 images at 768^2 of a ~4k-face
     mesh, with and without colours): face index and colours equal, depth
     bit-equal;
  4. main path: cli/geometric_main.main --source gt over three synthetic
     375x1242 frames (5, 11, 16 cars) with a two-item edit JSON, at the CLI
     defaults (16 slots, render_size 384 -> 768^2 rasterization) with
     random derenderer weights and 8 synthetic ~40k-face meshes in the
     ShapeNet directory layout; checks the five output files per item, the
     kernel's launch count and that the plain rasterizer never ran; prints
     steady-state per-phase times;
  5. kernel vs plain at the main path's own shapes (the last frame's
     rasterizer inputs), with kernel and plain times and the kernel's bound;
  6. profile: one 16-car frame's wall time, device busy time and idle
     share, and its device time by kernel (torch.profiler);
  7. reference: the port's CUDA path against its CPU path on a small input.
The line before last is the card's name and power limit, the line before
that the kernels' JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H100_HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
H100_FP32_FLOPS = 67e12               # H100 SXM, fp32 outside tensor cores
EDGE_TEST_FLOPS = 15                  # 3 edge functions: 6 sub, 6 mul, 3 cmp


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def compare(TC, TR, faces, valid, isz, colors):
    """Kernel vs plain on the same card inputs.  Fails unless face index
    and colours are equal and depth bit-equal.  Returns (max |depth
    diff|, covered pixels, the plain version's ms on the card)."""
    import torch
    got = TC.rasterize_face_index(faces, valid, isz, colors=colors)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fi_p, d_p = TR.rasterize_face_maps(faces, valid, isz)
    rgb_p = (None if colors is None else
             TR._gather_face_colors(fi_p, colors).permute(0, 3, 1, 2))
    t1.record()
    torch.cuda.synchronize()
    n_bad = int((got[0] != fi_p).sum())
    err = float((got[1] - d_p).abs().max())
    if n_bad or err != 0.0:
        raise AssertionError(f"kernel != plain at {tuple(faces.shape)} "
                             f"{isz}^2: {n_bad} face-index mismatches, "
                             f"max depth diff {err}")
    if colors is not None and not torch.equal(got[2], rgb_p):
        raise AssertionError("kernel colours != plain gather")
    return err, int((fi_p >= 0).sum()), t0.elapsed_time(t1)


def car_mesh(seed: int, n_theta: int, n_phi: int):
    """A car-proportioned, bumpy closed mesh from a UV sphere."""
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    v, f = make_sphere_mesh(n_theta, n_phi)
    rng = np.random.RandomState(seed)
    v = v * np.asarray([2.2, 0.8, 1.0], np.float32)
    v = v * (1.0 + 0.08 * np.sin(v[:, :1] * rng.uniform(3, 6)))
    v = v + rng.normal(0, 0.004, v.shape).astype(np.float32)
    return v.astype(np.float32), f


def write_assets(root: str, seed: int):
    """8 ~40k-face meshes in the ShapeNet layout, three 375x1242 frames
    with 5 / 11 / 16 GT cars, and a two-item edit JSON per frame."""
    from PIL import Image

    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    shapenet = os.path.join(root, "shapenet")
    for i, (cls, obj) in enumerate(SHAPENET_CARS):
        d = os.path.join(shapenet, cls, obj, "models")
        os.makedirs(d)
        save_obj(os.path.join(d, "model_normalized.obj"),
                 *car_mesh(seed + i, 100, 200))          # 39,600 faces
    rng = np.random.RandomState(seed)
    H, W = 375, 1242
    frames = []
    for k, n in enumerate((5, 11, 16)):
        img = (rng.rand(H, W, 3) * 64 + np.linspace(0, 160, W)[None, :, None])
        img_path = os.path.join(root, f"frame{k}.png")
        Image.fromarray(img.astype(np.uint8)).save(img_path)
        hh = rng.randint(40, 130, n)
        ww = (hh * rng.uniform(1.2, 2.2, n)).astype(int)
        y1 = rng.randint(150, H - 20, n) - hh // 2
        x1 = rng.randint(0, W - 60, n)
        rois = np.stack([np.clip(y1, 0, H - 2), x1,
                         np.clip(y1 + hh, 0, H), np.clip(x1 + ww, 0, W)],
                        1).astype(np.float32)
        masks = np.zeros((n, 1, H, W), np.float32)
        yy, xx = np.mgrid[:H, :W]
        for i, (a, b, c, d) in enumerate(rois):
            cy, cx, ry, rx = (a + c) / 2, (b + d) / 2, (c - a) / 2, (d - b) / 2
            masks[i, 0] = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1
        masks_path = os.path.join(root, f"frame{k}.npz")
        np.savez(masks_path, rois=rois, masks=masks,
                 class_ids=rng.choice([1, 2], n).astype(np.int32))

        def center(i):
            return {"u": str((rois[i, 1] + rois[i, 3]) / 2),
                    "v": str((rois[i, 0] + rois[i, 2]) / 2)}
        items = [{"world": "0001", "topic": "clone", "source": f"{k:05d}",
                  "target": f"{k:05d}_{j}", "operations": [
                      {"type": "modify", "from": center(j), "to": {},
                       "zoom": "1.3", "ry": "0.4"},
                      {"type": "delete", "from": center(n - 1 - j)}]}
                 for j in range(2)]
        edit_path = os.path.join(root, f"frame{k}_edit.json")
        with open(edit_path, "w") as fh:
            json.dump(items, fh)
        frames.append((img_path, masks_path, edit_path, n))
    return shapenet, frames


def check_outputs(out_dir: str, n_cars: int):
    from PIL import Image
    for name in ("00000", "00001"):
        paths = [os.path.join(out_dir, name + s) for s in
                 (".png", "-normal.png", "-depth.png", ".json", ".pkl")]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise AssertionError(f"missing outputs: {missing}")
        inst = np.asarray(Image.open(paths[0]))
        nrm = np.asarray(Image.open(paths[1]))
        dep = np.asarray(Image.open(paths[2]))
        if inst.shape != (375, 1242) or nrm.shape != (375, 1242, 3) \
                or dep.shape != (375, 1242):
            raise AssertionError(f"bad map shapes {inst.shape} {nrm.shape} "
                                 f"{dep.shape}")
        if inst.max() > n_cars or not (inst > 0).any():
            raise AssertionError(f"instance ids out of range / empty: "
                                 f"max {inst.max()} for {n_cars} cars")
        with open(paths[3]) as fh:
            objs = json.load(fh)
        with open(paths[4], "rb") as fh:
            state = pickle.load(fh)
        vals = [v for o in objs.values() for v in (o["depth"], o["alpha"])]
        n_obj = state["num_objs"]      # padded slots past it carry inf/nan
        vals += [float(x) for k in ("_scales", "_rotations", "_translations",
                                    "_zooms") for x in np.ravel(state[k][:n_obj])]
        if not objs or not np.isfinite(vals).all():
            raise AssertionError("json/pkl values empty or not finite")


def profile_frame(frame, shapenet: str, seed: int, card: str) -> None:
    """Where one serving frame's time goes on the card: derender_image on
    the given frame (its first edit item), host wall per frame without the
    profiler, then device time by kernel under torch.profiler."""
    import torch
    from PIL import Image
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.data.vkitti import load_edit_json
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, keep_largest_detections)

    img, npz, edit, n_cars = frame
    args = geometric_main.build_argparser().parse_args(
        ["--source", "gt", "--shapenet_root", shapenet, "--seed", str(seed)])
    model, bank = geometric_main.load_derenderer(args)
    cfg = DerenderInferConfig()
    image = np.asarray(Image.open(img).convert("RGB"))
    with np.load(npz) as d:
        dets = keep_largest_detections(cfg, d["class_ids"], d["masks"],
                                       d["rois"])
    ops = load_edit_json(edit)[0].operations

    def run():
        derender_image(model, bank, image, *dets, cfg, operations=ops,
                       device="cuda")
        torch.cuda.synchronize()

    run()
    run()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3 / n
            rec[1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    if busy_ms == 0.0:
        log(f"[profile] {n_cars}-car frame: wall {wall_ms:.3f} ms/frame; "
            f"device time not measured (the profiler saw no device events)")
        return
    log(f"[profile] {n_cars}-car frame: wall {wall_ms:.3f} ms/frame, device "
        f"busy {busy_ms:.3f} ms/frame, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f} ({card})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, count) in top:
        log(f"[profile]   {ms:9.4f} ms/frame  {count // n:4d} launches/frame"
            f"  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is false; this needs a card")
        return 2
    if not os.path.isdir(os.path.join(REPO, "sdn3d_tpu_torch")):
        log(f"FAILED: no sdn3d_tpu_torch package beside {__file__}")
        return 2
    card = card_line()
    log(f"[card] {card}")
    sys.path.insert(0, REPO)
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    TC._load()
    log(f"[build] rasterize.cu built+loaded in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {TC.build_seconds if TC.build_seconds is not None else 'cached'})")
    for line in TC.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 3. kernel vs plain at the issue's sizes ----------------------------
    from sdn3d_tpu_torch.geometry.transforms import perspective_transform
    from sdn3d_tpu_torch.render.renderer import project_faces
    max_err = 0.0
    rng = np.random.RandomState(args.seed)
    xy = rng.uniform(-1.2, 1.2, (2, 37, 3, 2))
    z = rng.uniform(1.5, 6.0, (2, 37, 3, 1))
    faces = torch.from_numpy(np.concatenate([xy, z], -1).astype(np.float32))
    faces[:, 3] = faces[:, 1]
    faces[:, 4] = faces[:, 4].flip(1)
    valid = torch.ones(2, 37, dtype=torch.bool)
    valid[:, 2] = False
    colors = torch.from_numpy(rng.uniform(-1, 1, (2, 37, 3)).astype(np.float32))
    err, _, _ = compare(TC, TR, faces.to(dev), valid.to(dev), 128,
                        colors.to(dev))
    max_err = max(max_err, err)
    log("[kernel] 2x37 random faces @128^2: equal")

    v, f = car_mesh(args.seed, 32, 64)                     # 3,968 faces
    verts = torch.from_numpy(np.stack([v, v[:, [0, 1, 2]] * 0.9]))
    fidx = torch.from_numpy(np.stack([f, f]))
    th = torch.tensor([0.4, 2.0])
    rot = torch.stack([torch.cos(th / 2), 0 * th, torch.sin(th / 2), 0 * th], 1)
    trans = torch.tensor([[0.5, -0.3, -9.0], [-1.0, 0.2, -14.0]])
    vc, _ = perspective_transform(verts, scales=torch.ones(2, 3) * 1.5,
                                  rotations=rot, translations=trans,
                                  perspective_translations=trans,
                                  zoom_tos=torch.full((2, 1), 384 / 1450.0))
    fv, cols = project_faces(vc.to(dev), fidx.to(dev),
                             torch.full((2,), 29.6, device=dev))
    fvalid = torch.ones(fv.shape[:2], dtype=torch.bool, device=dev)
    for c in (None, cols.contiguous()):
        err, hits, _ = compare(TC, TR, fv, fvalid, 768, c)
        max_err = max(max_err, err)
        log(f"[kernel] 2 x {fv.shape[1]} faces @768^2 "
            f"{'with' if c is not None else 'without'} colours: equal "
            f"({hits} covered pixels)")

    # -- 4. main path -------------------------------------------------------
    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.utils import phases

    # keep a copy of the rasterizer's inputs on the main path (the
    # dispatching wrapper is looked up at call time by _rasterize_sorted)
    captured = {}
    launch = TC.rasterize_face_index_cuda
    dispatch = TC.rasterize_face_index

    def recording(faces, face_valid, image_size, near=TR.DEFAULT_NEAR,
                  far=TR.DEFAULT_FAR, colors=None):
        captured.update(faces=faces.clone(), valid=face_valid.clone(),
                        size=image_size,
                        colors=None if colors is None else colors.clone())
        return dispatch(faces, face_valid, image_size, near, far, colors)

    with tempfile.TemporaryDirectory(prefix="sdn3d_smoke_") as tmp:
        t0 = time.perf_counter()
        shapenet, frames = write_assets(tmp, args.seed)
        log(f"[main] wrote assets in {time.perf_counter() - t0:.1f} s")
        TC.rasterize_face_index = recording
        phases.reset(True)
        launch.launches = 0
        TR.rasterize_face_maps.calls = 0
        t0 = time.perf_counter()
        for k, (img, npz, edit, n) in enumerate(frames):
            out_dir = os.path.join(tmp, f"out{k}")
            geometric_main.main([
                "--source", "gt", "--input_image", img, "--input_masks", npz,
                "--edit_json", edit, "--shapenet_root", shapenet,
                "--output_dir", out_dir, "--seed", str(args.seed)])
            check_outputs(out_dir, n)
            log(f"[main] frame {k} ({n} cars, 2 edit items): outputs ok")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = launch.launches, TR.rasterize_face_maps.calls
        TC.rasterize_face_index = dispatch
        snap = phases.snapshot()
        phases.reset(False)
        # -- 6. where one frame's time goes (after the counts were read) --
        profile_frame(frames[-1], shapenet, args.seed, card)
    if launches < len(frames) * 2 or plain_calls != 0:
        raise AssertionError(f"main path: {launches} kernel launches, "
                             f"{plain_calls} plain rasterizer calls")
    log(f"[main] {len(frames)} frames x 2 items in {wall:.2f} s; kernel "
        f"launches {launches}, plain rasterizer calls {plain_calls}")
    for name, rec in snap.items():
        log(f"[phases] {name}: calls {rec['calls']} first_s {rec.get('first_s', rec['s'])}"
            f" steady_avg_s {rec.get('steady_avg_s', 'n/a')} MB {rec['MB']}"
            f" ({card})")

    # -- 5. kernel vs plain at the main path's shapes -------------------------
    cf, cv, cs, cc = (captured["faces"], captured["valid"], captured["size"],
                      captured["colors"])
    err, hits, plain_ms = compare(TC, TR, cf, cv, cs, cc)
    max_err = max(max_err, err)
    log(f"[kernel] main-path inputs {tuple(cf.shape)} @{cs}^2: equal "
        f"({hits} covered pixels)")
    ms = cuda_ms(lambda: launch(cf, cv, cs, colors=cc), iters=20, warmup=3)
    # bound: bytes (inputs read once, outputs written once) and the edge
    # tests of every (face, pixel) pair inside the faces' pixel boxes
    B, F = cf.shape[:2]
    nbytes = B * F * (36 + 1 + 12) + B * cs * cs * (4 + 4 + 12)
    _, ok = TR.face_setup(cf, cv, cs)[1:]
    pix = ((cf[..., :2] + 1.0) * cs - 1.0) * 0.5
    lo = torch.clamp(torch.ceil(pix.amin(2)), 0, cs)
    hi = torch.clamp(torch.floor(pix.amax(2)), -1, cs - 1)
    area = torch.clamp(hi - lo + 1, min=0).prod(-1) * ok
    pairs = float(area.sum())
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = pairs * EDGE_TEST_FLOPS / H100_FP32_FLOPS * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    log(f"[kernel] {ms:.4f} ms/launch, plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {pairs:.0f} "
        f"face-pixel box pairs) ({card})")

    # -- 7. reference: CUDA path vs CPU path on a small input ---------------
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image)
    torch.manual_seed(args.seed)
    model = Derenderer(num_classes=2).eval()
    host_bank = build_mesh_bank([make_sphere_mesh(12, 24)] * 2)
    cfg = DerenderInferConfig(image_size=64, render_size=64, max_objects=4)
    image = (rng.rand(96, 160, 3) * 255).astype(np.uint8)
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)
    masks = np.zeros((2, 1, 96, 160), np.float32)
    for i, r in enumerate(rois.astype(int)):
        masks[i, 0, r[0] + 5:r[2] - 5, r[1] + 5:r[3] - 5] = 1
    outs = {}
    for d in ("cpu", "cuda"):
        outs[d] = derender_image(model.to(d), DeviceMeshBank.from_host(
            host_bank, device=d), image, np.asarray([1, 2]), masks, rois, cfg,
            device=d)
    agree = float((outs["cpu"]["instance_map"]
                   == outs["cuda"]["instance_map"]).mean())
    nrm_diff = int(np.abs(outs["cpu"]["normal_png"].astype(int)
                          - outs["cuda"]["normal_png"].astype(int)).max())
    d_cpu = [o["depth"] for o in outs["cpu"]["json_obj"].values()]
    d_gpu = [o["depth"] for o in outs["cuda"]["json_obj"].values()]
    if agree < 0.999 or nrm_diff > 1 or not np.allclose(d_cpu, d_gpu,
                                                        rtol=1e-4):
        raise AssertionError(f"cuda vs cpu: instance agreement {agree}, "
                             f"normal byte diff {nrm_diff}, depths {d_cpu} "
                             f"vs {d_gpu}")
    log(f"[reference] cuda vs cpu path on 96x160: instance agreement {agree}, "
        f"max normal byte diff {nrm_diff}")

    kernels = [{
        "name": "rasterize_forward",
        "route": "cuda",
        "source": "sdn3d_tpu_torch/csrc/rasterize.cu",
        "replaces": "sdn3d_tpu/ops/rasterize_pallas.py:662",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
