#!/usr/bin/env python3
"""Drive the PyTorch port (sdn3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (any failure exits non-zero):
  1. the card: requires torch.cuda; prints nvidia-smi's name and power limit;
  2. build: compiles the three CUDA kernels (csrc/rasterize.cu,
     silhouette_walk.cu, segment_face_grads.cu) from source, one nvcc each,
     all started together;
  3. kernels vs plain: the forward rasterizer against its plain PyTorch
     version on the card (2 x 37 random faces at 128^2, and at 144^2 with
     a whole-image sliver on the wide list; 2 images at 768^2 of a
     ~4k-face mesh, with and without colours): face index and colours
     equal, depth bit-equal; the bin kernels' boxes equal pack_faces'
     boxes and their lists, as sets, the plain bin lists; then the
     silhouette VJP of the 128^2 faces: the fused walk's accumulators
     (invariants computed in the kernel) bit-equal to its plain version
     (invariant stack + plain walk), both axes of one launch (windows
     24, 64 and 128; 128 reads global memory), the
     reduction's boxes equal to won_pixel_boxes, its sums within 1e-5 of
     |terms| of a float64 sum and bit-equal across two launches;
  4. main path: cli/geometric_main.main --source gt over three synthetic
     375x1242 frames (5, 11, 16 cars) with a two-item edit JSON, at the CLI
     defaults (16 slots, render_size 384 -> 768^2 rasterization) with
     random derenderer weights and 8 synthetic ~40k-face meshes in the
     ShapeNet directory layout; checks the five output files per item, the
     forward's launch counts (bin and raster kernels) and that the plain
     rasterizer never ran; prints steady-state per-phase times;
  4b. refinement path: the same with --num_opts 10 (silhouette refinement,
     walk window 64): the kernels' launch counts (>= num_opts per refined
     item; the reduction's box pass with each reduction), no plain version
     run and no invariant stack built (edge_invariant_stack and
     face_pixel_coords called 0 times), the refine loss of the real
     objects (silhouette and reg terms) at the first and last step (the
     silhouette term's mean over items must fall), and the steady-state
     geo.refine time;
  5. kernels vs plain at the main paths' own inputs (the last forward of
     phase 4, the last refine step's backward of 4b): equality as in 3, the
     kernels' and plain versions' times, each kernel's bound; for the walk
     its time per backward (one launch, both axes), the hit pixels that
     walk at all, and the same source built without staging
     (global-memory scans), timed in turns with it; for the
     forward the pre-pass, bin and raster times beside the wrapper's, the
     face-tile pairs, the longest tile list and the wide lists; for the
     reduction the box pass's time, box pixels per won pixel, and the time
     of one index_add_ computing the same sums;
  6. profile: one 16-car frame, unrefined and refined: wall time, device
     busy time and idle share, PyTorch's elementwise kernels (device time
     and launches), and device time by kernel (torch.profiler);
  7. reference: the port's CUDA path against its CPU path on a small input,
     unrefined and with 2 refinement steps.
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
# walk, per (pixel, edge) and step: where alpha there equals the pixel's,
# the compare that rules the step out; where it differs, an OUT step of an
# edge inside the image (d1k, 2 bounds, diff, gate: 7 ops) plus, when
# gated, two distance terms (sub, mul, cmp, add, div) and two adds, and an
# IN term (diff, gate, two divisions, two adds) with its two distances
# (sub, mul, cmp, add each)
WALK_SKIP_FLOPS = 1
WALK_OUT_STEP_FLOPS = 19
WALK_IN_TERM_FLOPS = 15
# one edge's invariants: the elementwise operations of
# ops/rasterize._edge_invariants, each counted once (nonvert 1, slope 4,
# d1_cross 3, direction 2, d1_in 4, d1_out 1, col_ok 16, base_k 3, kA 5,
# kB 5, use_ac 3, slope_ac 5, slope_bc 5, d0_cross2 5, d1_lim_in 3, lo_in 2,
# hi_in 2, in_range 4, j_gate 3, is_in_pixel 2)
EDGE_INVARIANT_FLOPS = 78
REDUCE_FLOPS = 6                      # one add per plane for a won pixel
NUM_OPTS = 10


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
    got = TC.rasterize_face_index_cuda(faces, valid, isz, colors=colors)
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


def whole_image_sliver(TC, isz: int):
    """xy [3, 2] of a front-facing, non-degenerate sliver across the image
    whose pack_faces box is the whole image (its cross product's lower
    bound is <= 0)."""
    import torch
    a = torch.tensor([-0.9, -0.8])
    c = torch.tensor([0.9, 0.85])
    whole = torch.tensor([0, isz - 1, 0, isz - 1], dtype=torch.int32)
    for off in (1e-7, 2e-7, 4e-7, 8e-7):
        m = (a + c) / 2 + off
        for tri in ((a, m, c), (a, c, m)):
            xy = torch.stack(tri)
            face = torch.cat([xy, torch.full((3, 1), 3.0)], 1)[None, None]
            if torch.equal(TC.pack_faces(face, None, isz)[1][0, 0], whole):
                return xy
    raise AssertionError("no whole-image sliver found")


def check_bins(TC, faces, valid, isz: int, lists: bool):
    """The bin kernels against pack_faces' boxes (exact) and, with
    `lists`, against the plain bin lists read as sets.  Returns the
    kernel's Bins."""
    import torch
    rec, box = TC.pack_faces(faces, valid, isz)
    got = TC.bin_faces_cuda(rec, isz)
    torch.cuda.synchronize()
    if not torch.equal(got.box, box):
        raise AssertionError(f"bin kernel boxes != pack_faces boxes at "
                             f"{tuple(faces.shape)} {isz}^2: "
                             f"{int((got.box != box).any(-1).sum())} faces")
    if lists:
        want = TC.bin_faces_plain(box, isz)
        if not torch.equal(got.tile_off, want.tile_off) \
                or not torch.equal(got.wide_n, want.wide_n):
            raise AssertionError("bin kernel list lengths != plain")
        F = faces.shape[1]
        for b in range(faces.shape[0]):
            off = got.tile_off[b].long()
            tid = torch.repeat_interleave(
                torch.arange(len(off) - 1, device=off.device),
                off[1:] - off[:-1])
            n, w = int(off[-1]), int(got.wide_n[b])
            # the plain lists run by (tile, face): sort the kernel's so
            key = torch.sort(tid * F + got.tile_faces[b, :n].long())[0]
            wide = torch.sort(got.wide_faces[b, :w])[0]
            if not torch.equal(key, tid * F + want.tile_faces[b, :n].long()) \
                    or not torch.equal(wide, want.wide_faces[b, :w]):
                raise AssertionError(f"bin kernel lists != plain lists "
                                     f"(image {b})")
    return got


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


def profile_frame(frame, shapenet: str, seed: int, card: str,
                  num_opts: int = 0) -> None:
    """Where one serving frame's time goes on the card: derender_image on
    the given frame (its first edit item), with `num_opts` refinement
    steps, host wall per frame without the profiler, then device time by
    kernel under torch.profiler."""
    import torch
    from PIL import Image
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.data.vkitti import load_edit_json
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, keep_largest_detections)
    from sdn3d_tpu_torch.utils import phases

    img, npz, edit, n_cars = frame
    args = geometric_main.build_argparser().parse_args(
        ["--source", "gt", "--shapenet_root", shapenet, "--seed", str(seed)])
    model, bank = geometric_main.load_derenderer(args)
    cfg = DerenderInferConfig(num_opts=num_opts)
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
    if num_opts:
        # geo.refine, with the card synchronised at each phase's end
        phases.reset(True)
        for _ in range(n):
            run()
        rec = phases.snapshot()["geo.refine"]
        phases.reset(False)
        log(f"[profile] {n_cars}-car frame, num_opts {num_opts}: geo.refine "
            f"steady {rec['steady_avg_s']:.4f} s/item ({card})")
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
    what = f"{n_cars}-car frame, num_opts {num_opts}"
    if busy_ms == 0.0:
        log(f"[profile] {what}: wall {wall_ms:.3f} ms/frame; device time "
            f"not measured (the profiler saw no device events)")
        return
    log(f"[profile] {what}: wall {wall_ms:.3f} ms/frame, device busy "
        f"{busy_ms:.3f} ms/frame, idle share {1.0 - busy_ms / wall_ms:.4f} "
        f"({card})")
    elem = [v for k, v in by_name.items() if "elementwise_kernel" in k]
    log(f"[profile] {what}: PyTorch elementwise kernels "
        f"{sum(v[0] for v in elem):.4f} ms/frame, "
        f"{sum(v[1] for v in elem) // n} launches/frame ({card})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, count) in top:
        log(f"[profile]   {ms:9.4f} ms/frame  {count // n:4d} launches/frame"
            f"  {name[:90]}")


def check_walk(TC, TR, alpha, cot, pp, fi, walk: int, eps: float) -> float:
    """The fused walk kernel against its plain version, both axes of one
    launch: bit-equal or the run fails.  Returns the max |kernel - plain|
    (0.0)."""
    import torch
    both = TC.walk_grads_cuda(alpha, cot, pp, fi, walk, eps)
    err = 0.0
    for axis in (0, 1):
        want = TR.walk_grads_faces_plain(alpha, cot, pp, fi, walk, eps, axis)
        torch.cuda.synchronize()
        e = float((both[axis] - want).abs().max())
        if not torch.equal(both[axis], want):
            raise AssertionError(f"walk kernel != plain (axis {axis}, walk "
                                 f"{walk}, {tuple(alpha.shape)}): max diff "
                                 f"{e}, {int((both[axis] != want).sum())} "
                                 f"values")
        err = max(err, e)
    return err


def check_reduction(TC, TR, acc_x, acc_y, fi, F: int) -> float:
    """The reduction kernels against their plain versions: the box pass
    equal to won_pixel_boxes, the sums against a float64 segment sum of
    the same planes, |err| <= 1e-5 * sum of |terms| per face, and
    bit-equal across two launches.  Returns the max |kernel - float64|."""
    import torch
    box = TC.won_pixel_boxes_cuda(fi, F)
    got = TC.segment_face_grads_cuda(acc_x, acc_y, fi, F)
    again = TC.segment_face_grads_cuda(acc_x, acc_y, fi, F)
    ref = TR.segment_face_grads_plain(acc_x.double(), acc_y.double(), fi, F)
    mag = TR.segment_face_grads_plain(acc_x.double().abs(),
                                      acc_y.double().abs(), fi, F).abs()
    box_p = TR.won_pixel_boxes(fi, F)
    torch.cuda.synchronize()
    err = (got.double() - ref).abs()
    if not torch.equal(box, box_p):
        raise AssertionError(f"box pass != won_pixel_boxes: "
                             f"{int((box != box_p).any(-1).sum())} faces")
    if not torch.equal(got, again):
        raise AssertionError("reduction kernel differs between two launches")
    if not (err <= 1e-5 * mag + 1e-30).all():
        raise AssertionError(f"reduction kernel vs float64: max err "
                             f"{float(err.max())}, worst ratio "
                             f"{float((err / (mag + 1e-30)).max())}")
    return float(err.max())


def walk_variant_ms(TC, alpha, cot, pp, fi, walk: int, eps: float):
    """The walk kernel as built (alpha and grad staged in shared memory
    with run masks for windows up to 64) against the same source built
    with -DSDN3D_WALK_MAX_STAGED_STEPS=-1 (global-memory reads and
    step-by-step scans at every window), both axes a launch: bit-equal or
    the run fails; then each one's ms per launch, timed staged, global,
    global, staged.  Returns (staged, global) lists of ms."""
    import ctypes

    import torch
    B, S, _ = alpha.shape
    F = pp.shape[1]
    with tempfile.TemporaryDirectory(prefix="sdn3d_walk_") as tmp:
        lib = os.path.join(tmp, "libwalk_global.so")
        subprocess.run([TC._nvcc(), *TC.NVCC_FLAGS,
                        "-DSDN3D_WALK_MAX_STAGED_STEPS=-1", "-o", lib,
                        os.path.join(TC.CSRC_DIR, "silhouette_walk.cu")],
                       check=True, capture_output=True, timeout=300)
        fn = ctypes.CDLL(lib).sdn3d_walk_faces
    fn.argtypes = TC._ENTRY["silhouette_walk"]["sdn3d_walk_faces"]
    fn.restype = ctypes.c_int

    def run(variant):
        if variant == "staged":
            return TC.walk_grads_cuda(alpha, cot, pp, fi, walk, eps)
        out = torch.empty((2, B, 3, S, S), device=alpha.device)
        err = fn(alpha.data_ptr(), cot.data_ptr(), fi.data_ptr(),
                 pp.data_ptr(), out.data_ptr(), B, S, F, walk, eps,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"global-memory walk launch failed: {err}")
        return out

    if not torch.equal(run("staged"), run("global")):
        raise AssertionError("walk variants differ")
    ms = {"staged": [], "global": []}
    for variant in ("staged", "global", "global", "staged"):
        ms[variant].append(cuda_ms(lambda: run(variant), iters=10, warmup=2))
    return ms["staged"], ms["global"]


def walk_bound(TR, alpha, pp, fi, walk: int):
    """(bytes, operations, walking) of the fused walk over both axes, as
    one launch on the main path computes it.  Bytes: alpha, grad, the face
    index and the face table read once, 3 planes written per axis.
    Operations this data needs: the invariants of the three edges of each
    hit pixel that walks at all (some alpha within the window along the
    walk differs from its own, counting the zero halo past the image as
    the kernel does); for each in-boundary (pixel, edge), every in-image
    OUT step within the window, a compare where alpha there equals the
    pixel's and the full step where it differs; for each (pixel, edge)
    whose IN step lies in the window, a compare or, where alpha there
    differs, the full IN term.  walking: the share of hit pixels that walk,
    [axis 0, axis 1] (alpha is binary on the main path)."""
    import torch
    import torch.nn.functional as Fn
    B, S, _ = alpha.shape
    hit = fi >= 0
    n_hit = int(hit.sum())
    nbytes = 3 * 4 * B * S * S + pp.numel() * 4 + 2 * 3 * 4 * B * S * S
    ops = 0.0
    walking = []
    idx = torch.arange(S, device=alpha.device, dtype=torch.float32)
    for axis in (0, 1):
        dim = 1 if axis == 0 else 2              # the walk's dimension
        d1 = idx[None, :, None] if axis == 0 else idx[None, None, :]
        # in-image steps within the window whose alpha differs from the
        # pixel's, forwards and backwards
        differ_f = torch.zeros_like(alpha)
        differ_b = torch.zeros_like(alpha)
        for k in range(1, min(walk, S - 1) + 1):
            ne = (alpha.narrow(dim, k, S - k)
                  != alpha.narrow(dim, 0, S - k)).float()
            differ_f.narrow(dim, 0, S - k).add_(ne)
            differ_b.narrow(dim, k, S - k).add_(ne)
        inv = TR.edge_invariant_stack(TR._gather_pixel_faces(pp, fi), hit,
                                      S, axis)
        for e in range(3):
            direction, j_gate = inv[:, 6 * e + 1], inv[:, 6 * e + 4]
            is_in = inv[:, 6 * e + 5] > 0
            fwd = direction > 0
            border = torch.where(fwd, S - 1 - d1, d1)
            steps = torch.clamp(border, max=float(walk)) * is_in
            differ = torch.where(fwd, differ_f, differ_b) * is_in
            n_steps, n_differ = float(steps.sum()), float(differ.sum())
            ops += (n_differ * WALK_OUT_STEP_FLOPS
                    + (n_steps - n_differ) * WALK_SKIP_FLOPS)
            # the IN step, k = j_gate + 1 along the walk (zero past the
            # image)
            in_win = (j_gate >= 0) & (j_gate + 1 <= walk)
            pos = d1 + direction * (j_gate + 1)
            inside = (pos >= 0) & (pos <= S - 1)
            a_k = torch.gather(alpha, dim, pos.clamp(0, S - 1).long())
            a_k = torch.where(inside, a_k, torch.zeros_like(a_k))
            n_in = int(in_win.sum())
            n_in_differ = int((in_win & (a_k != alpha)).sum())
            ops += (n_in_differ * WALK_IN_TERM_FLOPS
                    + (n_in - n_in_differ) * WALK_SKIP_FLOPS)
        # binary alpha: a pixel walks unless the window's max equals its min
        lines = alpha if axis == 1 else alpha.transpose(1, 2)
        lines = lines.reshape(B * S, 1, S)
        hi = Fn.max_pool1d(Fn.pad(lines, (walk, walk)), 2 * walk + 1, 1)
        lo = -Fn.max_pool1d(Fn.pad(-lines, (walk, walk)), 2 * walk + 1, 1)
        moves = (hi != lo).reshape(B, S, S)
        if axis == 0:
            moves = moves.transpose(1, 2)
        n_walk = int((moves & hit).sum())
        ops += n_walk * 3 * EDGE_INVARIANT_FLOPS
        walking.append(n_walk / max(n_hit, 1))
    return nbytes, ops, walking


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
    from sdn3d_tpu_torch.pipelines import derender_infer as TI
    dev = torch.device("cuda")
    eps = TR.DEFAULT_EPS

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    TC.build(TC.SOURCES)
    for name in TC.SOURCES:
        TC._load(name)
    log(f"[build] {', '.join(TC.SOURCES)} built+loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, in parallel: "
        f"{ {k: round(v, 2) for k, v in TC.build_seconds.items()} or 'cached'})")
    for name, text in TC.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. kernels vs plain at small sizes ----------------------------------
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
    # the wide list: at 144^2 (9 x 9 tiles, more than K = 64) a
    # whole-image sliver in face 6 and the largest random faces go there
    wfaces = faces.clone()
    wfaces[:, 6, :, :2] = whole_image_sliver(TC, 144)
    wfaces, wvalid = wfaces.to(dev), valid.to(dev)
    err, _, _ = compare(TC, TR, wfaces, wvalid, 144, colors.to(dev))
    max_err = max(max_err, err)
    bins = check_bins(TC, wfaces, wvalid, 144, lists=True)
    n_wide, n_listed = int(bins.wide_n.sum()), int(bins.tile_off[:, -1].sum())
    sliver_wide = all(6 in bins.wide_faces[b, :int(bins.wide_n[b])].tolist()
                      for b in range(2))
    if not sliver_wide or n_listed == 0:
        raise AssertionError(f"wide-list case: sliver on the wide lists "
                             f"{sliver_wide}, {n_listed} tile entries")
    log(f"[kernel] 2x37 faces with a whole-image sliver @144^2: "
        f"equal; bin boxes == pack_faces boxes, lists == plain lists as "
        f"sets ({n_wide} wide faces, {n_listed} tile entries)")

    # the silhouette VJP of the same faces, kernels against plain versions
    sf, sv = faces.to(dev), valid.to(dev)
    sfi, _ = TC.rasterize_face_index(sf, sv, 128)
    salpha = (sfi >= 0).float()
    scot = torch.from_numpy(rng.randn(2, 128, 128).astype(np.float32)).to(dev)
    spp = TR.face_pixel_table(sf, 128)
    walk_err = max(check_walk(TC, TR, salpha, scot, spp, sfi, w, eps)
                   for w in (24, 64, 128))
    sacc = TC.walk_grads_cuda(salpha, scot, spp, sfi, 24, eps)
    red_err = check_reduction(TC, TR, sacc[1], sacc[0], sfi, sf.shape[1])
    g_k = TR.silhouette_grad_pixelwise(sf, sfi, salpha, scot, 128, eps,
                                       walk=24)[..., :2]
    # the plain versions composed as silhouette_grad_pixelwise composes
    # the kernels
    pacc = [TR.walk_grads_faces_plain(salpha, scot, spp, sfi, 24, eps, a)
            for a in (1, 0)]
    g_p = TR.segment_face_grads_plain(pacc[0], pacc[1], sfi,
                                      sf.shape[1]).reshape(g_k.shape)
    g_err = float((g_k - g_p).abs().max())
    if not g_err <= 1e-5 * float(g_p.abs().max()) or not torch.isfinite(
            g_k).all():
        raise AssertionError(f"silhouette VJP kernels vs plain: {g_err}")
    log(f"[kernel] silhouette VJP of 2x37 faces @128^2: walk bit-equal "
        f"(windows 24, 64, 128; both axes of one launch); "
        f"reduction boxes == won_pixel_boxes, max err vs float64 "
        f"{red_err:.3e}; "
        f"face grads max diff {g_err:.3e} (max |g| "
        f"{float(g_p.abs().max()):.4g})")

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
    bins = check_bins(TC, fv, fvalid, 768, lists=True)
    log(f"[kernel] 2 x {fv.shape[1]} faces @768^2: bin boxes == pack_faces "
        f"boxes, lists == plain lists as sets "
        f"({int(bins.tile_off[:, -1].sum())} face-tile pairs, "
        f"{int(bins.wide_n.sum())} wide faces)")

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

    # the refine path's last backward inputs: references, not copies (each
    # call's tensors are fresh and never written after)
    bw = {}
    walk_dispatch, seg_dispatch = TC.walk_grads, TC.segment_face_grads
    refine = TI.refine_silhouettes
    traces = []

    def walk_recording(alpha, grad_alpha, pp, face_index, n_steps, eps_):
        # face_index is the reduction's too: seg_recording keeps it
        bw.update(pp=pp, alpha=alpha, cot=grad_alpha, walk=n_steps)
        return walk_dispatch(alpha, grad_alpha, pp, face_index, n_steps,
                             eps_)

    def seg_recording(acc_x, acc_y, face_index, num_faces):
        bw.update(acc_x=acc_x, acc_y=acc_y, fi=face_index, F=num_faces)
        return seg_dispatch(acc_x, acc_y, face_index, num_faces)

    def refine_recording(blob, bank, masks, ignores, cfg, trace=None):
        steps = []
        out = refine(blob, bank, masks, ignores, cfg, trace=steps)
        real = (blob["_droi_norms"] > 0).all(1)
        traces.append(np.asarray([t[:, real].sum(1).tolist() for t in steps]))
        return out

    # the plain versions, and the invariant stack and its gather, which
    # only the walk's plain version builds
    plain_fns = (TR.rasterize_face_maps, TR.walk_grads_plain,
                 TR.segment_face_grads_plain, TR.edge_invariant_stack,
                 TR.face_pixel_coords)

    def plain_counts():
        return tuple(fn.calls for fn in plain_fns)

    # the forward's two kernels and the reduction's box pass, which their
    # wrappers launch with each forward and each reduction
    inner = (TC.bin_faces_cuda, TC.raster_binned_cuda, TC.won_pixel_boxes_cuda)

    def kernel_counts():
        return (launch.launches, TC.walk_grads_cuda.launches,
                TC.segment_face_grads_cuda.launches)

    def inner_counts():
        return tuple(fn.launches for fn in inner)

    def drive(frames, shapenet, tmp, extra, tag):
        """geometric_main over the frames; counts set to 0 just before and
        read just after.  Returns (kernel launches, plain calls, wall s,
        phase snapshot)."""
        phases.reset(True)
        launch.launches = 0
        TC.walk_grads_cuda.launches = 0
        TC.segment_face_grads_cuda.launches = 0
        for fn in inner:
            fn.launches = 0
        for fn in plain_fns:
            fn.calls = 0
        t0 = time.perf_counter()
        for k, (img, npz, edit, n) in enumerate(frames):
            out_dir = os.path.join(tmp, f"{tag}{k}")
            geometric_main.main([
                "--source", "gt", "--input_image", img, "--input_masks", npz,
                "--edit_json", edit, "--shapenet_root", shapenet,
                "--output_dir", out_dir, "--seed", str(args.seed)] + extra)
            check_outputs(out_dir, n)
            log(f"[{tag}] frame {k} ({n} cars, 2 edit items): outputs ok")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = kernel_counts(), plain_counts()
        if inner_counts() != (counts[0], counts[0], counts[2]):
            raise AssertionError(f"{tag}: bin / raster / box-pass launches "
                                 f"{inner_counts()} for {counts[0]} forwards "
                                 f"and {counts[2]} reductions")
        snap = phases.snapshot()
        phases.reset(False)
        for name, rec in snap.items():
            log(f"[phases] {tag} {name}: calls {rec['calls']} first_s "
                f"{rec.get('first_s', rec['s'])} steady_avg_s "
                f"{rec.get('steady_avg_s', 'n/a')} MB {rec['MB']} ({card})")
        return counts, plain, wall, snap

    with tempfile.TemporaryDirectory(prefix="sdn3d_smoke_") as tmp:
        t0 = time.perf_counter()
        shapenet, frames = write_assets(tmp, args.seed)
        log(f"[main] wrote assets in {time.perf_counter() - t0:.1f} s")
        TC.rasterize_face_index = recording
        counts, plain, wall, _ = drive(frames, shapenet, tmp, [], "main")
        TC.rasterize_face_index = dispatch
        launches = counts[0]
        if launches < len(frames) * 2 or any(plain):
            raise AssertionError(f"main path: kernel launches {counts}, "
                                 f"plain calls {plain}")
        log(f"[main] {len(frames)} frames x 2 items in {wall:.2f} s; kernel "
            f"launches {launches}; plain calls (rasterizer, walk, reduction, "
            f"edge_invariant_stack, face_pixel_coords) {plain}")

        # -- 4b. refinement path ----------------------------------------------
        TC.walk_grads, TC.segment_face_grads = walk_recording, seg_recording
        TI.refine_silhouettes = refine_recording
        r_counts, r_plain, r_wall, r_snap = drive(
            frames, shapenet, tmp, ["--num_opts", str(NUM_OPTS)], "refine")
        TC.walk_grads, TC.segment_face_grads = walk_dispatch, seg_dispatch
        TI.refine_silhouettes = refine
        items = len(frames) * 2
        need = (items * (NUM_OPTS + 1), items * NUM_OPTS, items * NUM_OPTS)
        if any(c < n for c, n in zip(r_counts, need)) or any(r_plain):
            raise AssertionError(f"refine path: kernel launches {r_counts} "
                                 f"(need >= {need}), plain calls {r_plain}")
        # traces[i][step] = (silhouette term, reg term) of the real objects
        for i, t in enumerate(traces):
            log(f"[refine] item {i}: loss of the real objects (silhouette "
                f"+ reg) step 1 {t[0, 0]:.6f} + {t[0, 1]:.6f}, step "
                f"{len(t)} {t[-1, 0]:.6f} + {t[-1, 1]:.6f}")
        firsts = np.asarray([t[0] for t in traces])
        lasts = np.asarray([t[-1] for t in traces])
        # the silhouette term is what the kernels' gradient drives down;
        # from the small FFD coefficients of random weights the reg term
        # rises (Adam moves every coefficient by ~lr a step), and so may
        # the total: the JAX package's refinement does the same
        # (tests/test_torch_refine.py::test_refine_losses_follow_jax_over_
        # ten_steps)
        if len(traces) != items or not np.isfinite(firsts).all() \
                or not np.isfinite(lasts).all() \
                or not lasts[:, 0].mean() < firsts[:, 0].mean():
            raise AssertionError(f"refine silhouette loss did not fall: "
                                 f"{[t.tolist() for t in traces]}")
        refine_s = r_snap["geo.refine"].get("steady_avg_s",
                                            r_snap["geo.refine"]["s"])
        log(f"[refine] {len(frames)} frames x 2 items x {NUM_OPTS} steps in "
            f"{r_wall:.2f} s; launches forward {r_counts[0]}, walk "
            f"{r_counts[1]}, reduction {r_counts[2]}; plain calls "
            f"(rasterizer, walk, reduction, edge_invariant_stack, "
            f"face_pixel_coords) {r_plain}; "
            f"mean silhouette loss {firsts[:, 0].mean():.6f} -> "
            f"{lasts[:, 0].mean():.6f}, mean loss {firsts.sum(1).mean():.6f} "
            f"-> {lasts.sum(1).mean():.6f}; "
            f"geo.refine steady {refine_s:.4f} s/item ({card})")

        # -- 6. where one frame's time goes (after the counts were read) --
        profile_frame(frames[-1], shapenet, args.seed, card)
        profile_frame(frames[-1], shapenet, args.seed, card,
                      num_opts=NUM_OPTS)

    # -- 5. kernels vs plain at the main paths' shapes ------------------------
    cf, cv, cs, cc = (captured["faces"], captured["valid"], captured["size"],
                      captured["colors"])
    err, hits, plain_ms = compare(TC, TR, cf, cv, cs, cc)
    max_err = max(max_err, err)
    bins = check_bins(TC, cf, cv, cs, lists=False)
    log(f"[kernel] main-path inputs {tuple(cf.shape)} @{cs}^2: equal "
        f"({hits} covered pixels); bin boxes == pack_faces boxes")
    # the wrapper (pre-pass, bin, raster) and its parts
    rec = TC.face_records(cf, cv, cs)
    ms = cuda_ms(lambda: launch(cf, cv, cs, colors=cc), iters=20, warmup=3)
    # the host's time to enqueue one wrapper call: at or above the device
    # time, the wrapper is bound by its launches on the host
    t0 = time.perf_counter()
    for _ in range(20):
        launch(cf, cv, cs, colors=cc)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    pre_ms = cuda_ms(lambda: TC.face_records(cf, cv, cs), iters=20, warmup=3)
    bin_ms = cuda_ms(lambda: TC.bin_faces_cuda(rec, cs), iters=20, warmup=3)
    raster_ms = cuda_ms(lambda: TC.raster_binned_cuda(rec, bins, cs,
                                                      colors=cc),
                        iters=20, warmup=3)
    lens = bins.tile_off[:, 1:] - bins.tile_off[:, :-1]
    log(f"[kernel] forward parts: pre-pass (face_records) {pre_ms:.4f} ms, "
        f"bin {bin_ms:.4f} ms, raster {raster_ms:.4f} ms, wrapper {ms:.4f} "
        f"ms (host enqueue {host_ms:.4f} ms a call); {int(bins.tile_off[:, -1].sum())} face-tile pairs, longest "
        f"tile list {int(lens.max())}, mean non-empty list "
        f"{float(lens[lens > 0].float().mean()):.1f}, wide faces "
        f"{int(bins.wide_n.sum())} (most in one image "
        f"{int(bins.wide_n.max())}), K = {TC.MAX_TILES} ({card})")
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

    # the last refine step's backward: walk (both axes) and reduction
    alpha, cot, W = bw["alpha"], bw["cot"], bw["walk"]
    wpp, wfi = bw["pp"], bw["fi"]
    walk_err = max(walk_err, check_walk(TC, TR, alpha, cot, wpp, wfi, W, eps))
    path_err = check_reduction(TC, TR, bw["acc_x"], bw["acc_y"], bw["fi"],
                               bw["F"])
    red_err = max(red_err, path_err)
    log(f"[kernel] refine-path backward {tuple(alpha.shape)}, "
        f"{wpp.shape[1]} faces, walk {W}: walk bit-equal (both axes of one "
        f"launch); reduction boxes == won_pixel_boxes, sums "
        f"within 1e-5 of |terms| of float64, max err {path_err:.3e}, "
        f"bit-equal across launches")

    # why the walk keeps its shared-memory staging: the same kernel built
    # to read alpha and grad from global memory, at the same inputs, in
    # turns; the main path's launch is the staged one
    stag_ms, glob_ms = walk_variant_ms(TC, alpha, cot, wpp, wfi, W, eps)
    walk_ms = sum(stag_ms) / 2
    walk_plain_ms = sum(cuda_ms(lambda: TR.walk_grads_faces_plain(
        alpha, cot, wpp, wfi, W, eps, a), iters=1, warmup=0)
        for a in (0, 1))
    w_bytes, w_ops, walking = walk_bound(TR, alpha, wpp, wfi, W)
    walk_bound_ms, walk_bound_by = max(
        (w_bytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"),
        (w_ops / H100_FP32_FLOPS * 1e3, "operations"))
    log(f"[kernel] walk: {walk_ms:.4f} ms/launch (one backward: both axes "
        f"in one launch); plain {walk_plain_ms:.1f} ms (both axes); bound "
        f"{walk_bound_ms:.4f} ms by {walk_bound_by} ({w_bytes:.0f} B, "
        f"{w_ops:.0f} operations, both axes); hit pixels that walk: axis 0 "
        f"{walking[0]:.4f}, axis 1 {walking[1]:.4f} ({card})")
    log(f"[kernel] walk variants at {tuple(alpha.shape)}, window {W}, "
        f"bit-equal, ms per launch (staged, global, global, staged): staged "
        f"{stag_ms}, global-memory {glob_ms} ({card})")

    ax, ay, sfi_m, Fm = bw["acc_x"], bw["acc_y"], bw["fi"], bw["F"]
    Bm = sfi_m.shape[0]
    red_plain_ms = cuda_ms(lambda: TR.segment_face_grads_plain(
        ax, ay, sfi_m, Fm), iters=3, warmup=1)
    hit = sfi_m >= 0
    seg = (torch.where(hit, sfi_m, torch.zeros_like(sfi_m)).long()
           + torch.arange(Bm, device=dev)[:, None, None] * Fm).reshape(-1)
    rows = torch.where(hit[:, None], -torch.stack(
        [p for v in range(3) for p in (ax[:, v], ay[:, v])], 1), 0.0)
    rows = rows.permute(0, 2, 3, 1).reshape(-1, 6).contiguous()
    # the kernels (box pass included) and index_add_ in turns
    runs = {"kernel": [], "index_add_": []}
    for which in ("kernel", "index_add_", "index_add_", "kernel"):
        fn = ((lambda: TC.segment_face_grads_cuda(ax, ay, sfi_m, Fm))
              if which == "kernel" else
              (lambda: torch.zeros(Bm * Fm, 6, device=dev).index_add_(
                  0, seg, rows)))
        runs[which].append(cuda_ms(fn, iters=20, warmup=3))
    red_ms = sum(runs["kernel"]) / 2
    lib_ms = sum(runs["index_add_"]) / 2
    box_ms = cuda_ms(lambda: TC.won_pixel_boxes_cuda(sfi_m, Fm), iters=20,
                     warmup=3)
    # bytes the function needs: the face index of every pixel, the six
    # planes of the won pixels only, the sums written once per face
    n_won = int(hit.sum())
    r_bytes = sfi_m.numel() * 4 + n_won * 6 * 4 + Bm * Fm * 6 * 4
    r_ops = float(n_won) * REDUCE_FLOPS
    red_bound_ms, red_bound_by = max(
        (r_bytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"),
        (r_ops / H100_FP32_FLOPS * 1e3, "operations"))
    box = TC.won_pixel_boxes_cuda(sfi_m, Fm).float()
    box_px = float(((box[..., 1] - box[..., 0] + 1).clamp(min=0)
                    * (box[..., 3] - box[..., 2] + 1).clamp(min=0)).sum())
    log(f"[kernel] reduction: {red_ms:.4f} ms/launch with its box pass "
        f"({box_ms:.4f} ms), in turns with index_add_ (kernel, index_add_, "
        f"index_add_, kernel: {runs['kernel'][0]:.4f}, "
        f"{runs['index_add_'][0]:.4f}, {runs['index_add_'][1]:.4f}, "
        f"{runs['kernel'][1]:.4f} ms), faster than index_add_: "
        f"{red_ms < lib_ms}; plain {red_plain_ms:.3f} ms; bound "
        f"{red_bound_ms:.4f} ms by {red_bound_by} ({r_bytes} B); pixels in "
        f"the won-pixel boxes {box_px:.0f}, won pixels {n_won}, "
        f"{box_px / max(n_won, 1):.3f} box pixels per won pixel ({card})")

    # -- 7. reference: CUDA path vs CPU path on a small input ---------------
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image)
    torch.manual_seed(args.seed)
    model = Derenderer(num_classes=2).eval()
    host_bank = build_mesh_bank([make_sphere_mesh(12, 24)] * 2)
    image = (rng.rand(96, 160, 3) * 255).astype(np.uint8)
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)
    masks = np.zeros((2, 1, 96, 160), np.float32)
    for i, r in enumerate(rois.astype(int)):
        masks[i, 0, r[0] + 5:r[2] - 5, r[1] + 5:r[3] - 5] = 1
    for num_opts, min_agree in ((0, 0.999), (2, 0.98)):
        cfg = DerenderInferConfig(image_size=64, render_size=64,
                                  max_objects=4, num_opts=num_opts)
        outs = {}
        for d in ("cpu", "cuda"):
            outs[d] = derender_image(model.to(d), DeviceMeshBank.from_host(
                host_bank, device=d), image, np.asarray([1, 2]), masks, rois,
                cfg, device=d)
        agree = float((outs["cpu"]["instance_map"]
                       == outs["cuda"]["instance_map"]).mean())
        nrm_diff = int(np.abs(outs["cpu"]["normal_png"].astype(int)
                              - outs["cuda"]["normal_png"].astype(int)).max())
        d_cpu = [o["depth"] for o in outs["cpu"]["json_obj"].values()]
        d_gpu = [o["depth"] for o in outs["cuda"]["json_obj"].values()]
        a_gpu = [o["alpha"] for o in outs["cuda"]["json_obj"].values()]
        if agree < min_agree or not np.allclose(d_cpu, d_gpu, rtol=1e-4) \
                or not np.isfinite(a_gpu).all() \
                or (num_opts == 0 and nrm_diff > 1):
            raise AssertionError(f"cuda vs cpu, num_opts {num_opts}: "
                                 f"instance agreement {agree}, normal byte "
                                 f"diff {nrm_diff}, depths {d_cpu} vs {d_gpu}")
        log(f"[reference] cuda vs cpu path on 96x160, num_opts {num_opts}: "
            f"instance agreement {agree}, max normal byte diff {nrm_diff}")

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
    }, {
        "name": "silhouette_walk",
        "route": "cuda",
        "source": "sdn3d_tpu_torch/csrc/silhouette_walk.cu",
        "replaces": "sdn3d_tpu/ops/rasterize_pallas.py:1071",
        "launches": r_counts[1],
        "max_abs_err": walk_err,
        "ms": walk_ms,
        "plain_ms": walk_plain_ms,
        "bound_ms": walk_bound_ms,
        "bound_by": walk_bound_by,
        "library_ms": None,
    }, {
        "name": "segment_face_grads",
        "route": "cuda",
        "source": "sdn3d_tpu_torch/csrc/segment_face_grads.cu",
        "replaces": "sdn3d_tpu/ops/rasterize_pallas.py:941",
        "launches": r_counts[2],
        "max_abs_err": red_err,
        "ms": red_ms,
        "plain_ms": red_plain_ms,
        "bound_ms": red_bound_ms,
        "bound_by": red_bound_by,
        "library_ms": lib_ms,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
