#!/usr/bin/env python3
"""Drive the PyTorch port (sdn3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (any failure exits non-zero):
  1. the card: requires torch.cuda; prints nvidia-smi's name and power limit;
  2. build: compiles the three CUDA kernels (csrc/rasterize.cu,
     silhouette_walk.cu, segment_face_grads.cu) from source, one nvcc each,
     all started together, and the native host library
     (native/sdn3d_host.cpp, g++; data/native.py), which must load;
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
     unrefined and with 2 refinement steps;
  8. chain: cli/edit_chain.main --source gt at the full-width defaults
     (semantic ResNet-50 at 5 scales of a 375x1242 frame, the geometric
     path of phase 4, the pix2pixHD generator and encoder at 192x624,
     small_fetch on) with random weights from --seed, on a synthetic VKITTI
     root (3 source frames with 5, 11, 16 cars, two edit pairs per source
     and their reconstruction twins); checks benchmark.json (pairs, finite
     L1 / LPIPS / SSIM / PSNR), each fake ([192, 624, 3], finite, in
     [-1, 1]), the labels (< 14), one forward-kernel launch per pair at 16
     images and no plain forward; then the serving modes on the same root:
     8a. --full_fetch: instance_small / normal_small byte-equal to the PIL
         transform of the full planes, the fakes, labels, JSON and
         full-resolution maps bit-equal, geo.package bytes a pair of each;
     8b. --batch_pairs 4 (chunks of 4 and of 2 padded to 4): one forward
         launch per chunk at 64 images, no plain forward, every output
         equal to the serial run pair by pair (the fake within
         FAKE_BATCH_BOUND, its max |diff| printed); the generator frame by
         frame against one batched pass (time, max |diff|);
     8c. --batch_pairs 4 --pipeline: every output bit-equal to 8b;
     8d. --compute_dtype bfloat16: finite fakes in [-1, 1], the labels'
         agreement with float32, sem.infer / tex.generate / geo.encode
         steady times beside float32, and the semantic pass's and the
         generator's time (CUDA events) and device busy in both dtypes;
     8e. --lpips_ckpt (an official-layout checkpoint written from --seed):
         a finite mean_LPIPS, lpips_backbone "ported";
     then steady wall per pair of the serial, batched and pipelined chains
     over the edit set in turns, with each one's device idle share, and
     uncached and cached pairs apart, serial against batched; the per-pair
     profile (uncached and cached walls, device busy, top kernels); the
     chain's CUDA path against its CPU path on small shapes;
  9. detection as the serving source (Mask R-CNN, MaskRCNNConfig(): a
     ResNet-101 FPN at 1024^2, 6000 -> 1000 proposals, 100 detections):
     its FLOP count; 9a. the detector with the CLIs' random weights from
     --seed on the 16-car frame of phase 4, card against CPU stage by
     stage (each card stage fed the CPU's inputs; DET_* tolerances,
     validity and classes equal), the card's packed buffer bit-equal on
     two runs; 9b. the RPN NMS at 6000 boxes: card keep equal to the
     CPU's, its fixed-point steps, launches and time; 9c. the forward's
     time a frame at batch 1 and 4 and detect's wall a frame, in float32
     and bfloat16, with device busy and idle share; 9d.
     cli/geometric_main.main at its defaults (--source maskrcnn) over the
     three frames with a detector checkpoint written from --seed
     (detector_checkpoint: the random weights' box and class layers scaled
     so that objects reach the derenderer), one forward-kernel launch per
     item, no plain forward, and once without the checkpoint; 9e. (in
     phase 8's run) cli/edit_chain.main --source maskrcnn with that
     checkpoint, serial, --batch_pairs 4 and --batch_pairs 4 --pipeline:
     one forward launch per pair or chunk, no plain forward, pipelined
     bit-equal to batched; then the three modes' wall per pair on one
     stream;
 10. the per-stage file contract at the chain's full widths, the weights
     from --seed written once as core/checkpoint step directories: 10a.
     semantic_test --test_img benchmark -> geometric_main --vkitti_root
     --edit_json --source gt -> edit_benchmark --chain_times on a root of
     phase 8's (write_chain_root), then edit_chain --dump_dirs with the
     same step directories: the dumped label and contract files (.png,
     -normal.png, -depth.png, .json) byte-equal to the per-stage CLIs',
     mean L1 / SSIM / PSNR
     within 1e-6, one forward launch per geometric item and no plain
     forward; each stage's wall, textural_steady_s_per_pair and
     edits_per_sec; 10b. geometric_main --vkitti_root --split test over a
     root with motgt tables and frames in the test ranges, then
     textural_test: every frame written, a finite avg; 10c.
     geometric_main --input_image --edit_json --input_masks (stems 00000,
     00001) -> edit_vkitti --edit_num 2: one launch an item, finite
     fakes, the gallery; and geo.prep's crops through the native library
     against the numpy + PIL path (host wall, in turns);
 11. derenderer training at full width (batch 16, image 256, render 384 ->
     768^2, walk window 64, phase 4's eight 39.6k-face meshes, random
     weights from --seed): 11a. cli/geometric_train.main --mode full
     (synthetic batches) for TRAIN_STEPS iterations: every loss finite,
     B1, B3 and B2 launched once a step (no plain version, no invariant
     stack), the train-state step written, then geometric_main --ckpt_dir
     serving phase 4's frames from it (one launch an item); 11c. the last
     step's forward (TRAIN_PLAIN_IMAGES of its images), walk and reduction
     against their plain versions as in phase 5; 11b. DESCENT_STEPS steps
     (lr 3e-3, mask_weight 1.0) on one batch: the mask loss descends;
     11d. one step on a small shape, the card against the CPU (losses,
     running statistics, the gradient's two halves) within the CPU tests'
     bounds; 11e. two runs of a step give the same bits; ms a step
     (CUDA events, TIME_STEPS a run) for full float32 with cuDNN's
     deterministic algorithms on and off (TIME_TURNS runs each, in turns,
     and device busy of each under the profiler), full bfloat16 and
     pretrain; device busy and idle share, the three kernels' ms and the
     top kernels in a step; --dataset vkitti through the prefetch loader
     on a root of LOADER_TOPICS x 5 topics (450 objects, one loader
     epoch): the fill, then steps/s and the wait for a batch over steps
     after LOADER_WARM, and one item's decode against its whole cost.
The line before last is the card's name and power limit, the line before
that the kernels' JSON (launches: phase 11a's training run); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
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
H100_BF16_FLOPS = 989e12              # H100 SXM, dense bf16 tensor cores
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
# the chain's modes (phase 8): pairs a chunk of the batched and pipelined
# chains, and the planes a pair's outputs are compared by
BATCH_PAIRS = 4
PLANES = ("instance_png", "normal_png", "depth_png", "instance_small",
          "normal_small")
# the chain phase's textural shapes: the CLI defaults
CHAIN_SHAPES = {"load_size": 624, "fine_width": 624, "fine_height": 192}
# the batched and pipelined fakes against the serial ones: bit-equal is
# expected (the generator runs frame by frame); a difference is printed,
# and anything above this bound fails
FAKE_BATCH_BOUND = 1e-5
# phase 9: the detector's card stages against the CPU's, each card stage
# fed the CPU's inputs (cuDNN and oneDNN sum in other orders; CUDA's exp
# differs from the CPU's in the last bit): relative to the output's
# largest magnitude (the pyramid, the RPN's and the classifier's logits
# and deltas), absolute (scores, normalised proposals, sigmoid masks),
# and refined boxes, which round to whole pixels (an edge within an ulp
# of .5 may round the other way); validity and classes equal.  A
# softmax's slope is at most 1/4 and a difference of two logits moves by
# at most twice either's error, so the probabilities are held to
# DET_PROB_ATOL or half their logits' max |diff|, whichever is larger
# (random weights put the logits near 1e3, where 5e-5 relative is 0.05)
DET_RTOL = 5e-5
DET_PROB_ATOL = 1e-4
DET_PROPOSAL_ATOL = 1e-6
DET_MASK_ATOL = 1e-4
DET_BOX_ATOL = 1.0
# the detector checkpoint of phase 9's CLI runs (detector_checkpoint)
DET_TAME = 1e-3
DET_CLASS_BIAS = (0.0, 3.0, 0.0)


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


def write_meshes(shapenet: str, seed: int, n_theta: int = 100,
                 n_phi: int = 200) -> str:
    """8 car meshes in the ShapeNet layout under `shapenet` (39,600 faces
    each at the default 100 x 200)."""
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    for i, (cls, obj) in enumerate(SHAPENET_CARS):
        d = os.path.join(shapenet, cls, obj, "models")
        os.makedirs(d)
        save_obj(os.path.join(d, "model_normalized.obj"),
                 *car_mesh(seed + i, n_theta, n_phi))
    return shapenet


def write_assets(root: str, seed: int):
    """8 ~40k-face meshes in the ShapeNet layout, three 375x1242 frames
    with 5 / 11 / 16 GT cars, and a two-item edit JSON per frame."""
    from PIL import Image

    shapenet = write_meshes(os.path.join(root, "shapenet"), seed)
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


def check_outputs(out_dir: str, n_cars: int, names=("00000", "00001"),
                  min_objs: int = 1) -> int:
    """The five files of each item: present, maps 375x1242, instance ids
    <= n_cars, at least `min_objs` objects (with pixels when there are
    any), finite JSON / pkl values.  Returns the first item's number of
    objects."""
    from PIL import Image
    counts = []
    for name in names:
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
        with open(paths[3]) as fh:
            objs = json.load(fh)
        with open(paths[4], "rb") as fh:
            state = pickle.load(fh)
        if inst.max() > n_cars or len(objs) < min_objs \
                or (objs and not (inst > 0).any()):
            raise AssertionError(f"instance ids out of range / empty: "
                                 f"max {inst.max()} for {n_cars} cars, "
                                 f"{len(objs)} objects")
        vals = [v for o in objs.values() for v in (o["depth"], o["alpha"])]
        n_obj = state["num_objs"]      # padded slots past it carry inf/nan
        vals += [float(x) for k in ("_scales", "_rotations", "_translations",
                                    "_zooms") for x in np.ravel(state[k][:n_obj])]
        if not np.isfinite(vals).all():
            raise AssertionError("json/pkl values not finite")
        counts.append(len(objs))
    return counts[0]


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


def car_boxes(rng, n: int, H: int = 375, W: int = 1242):
    """n car boxes (y1, x1, y2, x2) in a HxW frame, sized and placed as
    write_assets places them."""
    hh = rng.randint(40, 130, n)
    ww = (hh * rng.uniform(1.2, 2.2, n)).astype(int)
    y1 = np.clip(rng.randint(150, H - 20, n) - hh // 2, 0, H - 2)
    x1 = rng.randint(0, W - 60, n)
    return [(int(a), int(b), int(min(a + h, H)), int(min(b + w, W)))
            for a, b, h, w in zip(y1, x1, hh, ww)]


def write_chain_root(root: str, seed: int):
    """A VKITTI-layout root for the chain: three 375x1242 source frames
    (5, 11 and 16 cars, sized and placed as write_assets places them), each
    in a topic of its own, background-only target frames, and an edit JSON
    with two edit pairs per source (modify car j, delete car n-1-j) and
    their reconstruction twins.  Returns the edit JSON's path and the
    number of edit pairs."""
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root

    rng = np.random.RandomState(seed + 1)
    frames, pairs, twins = {}, [], []
    for k, (topic, n) in enumerate((("clone", 5), ("fog", 11), ("rain", 16))):
        boxes = car_boxes(rng, n)
        src = f"{10 * k:05d}"
        frames[("0001", topic, src)] = boxes

        def center(i):
            y1_, x1_, y2_, x2_ = boxes[i]
            return {"u": str((x1_ + x2_) / 2), "v": str((y1_ + y2_) / 2)}
        for j in range(2):
            tgt = f"{10 * k + 1 + j:05d}"
            frames[("0001", topic, tgt)] = []
            pairs.append({"world": "0001", "topic": topic, "source": src,
                          "target": tgt, "operations": [
                              {"type": "modify", "from": center(j), "to": {},
                               "zoom": "1.3", "ry": "0.4"},
                              {"type": "delete", "from": center(n - 1 - j)}]})
            twins.append({"world": "0001", "topic": topic, "source": src,
                          "target": src, "operations": []})
    write_vkitti_root(root, frames, seed=seed)
    edit_json = os.path.join(root, "chain_edit.json")
    with open(edit_json, "w") as fh:
        json.dump(pairs + twins, fh)
    return edit_json, len(pairs)


def pair_record(out) -> dict:
    """What two runs of a chain pair are compared by: host copies of the
    fake, the labels, the JSON, the quantized planes, and the
    full-resolution instance / normal / depth maps (device tensors in the
    serving contract, the instance map as numpy in the file contract)."""
    import torch
    g = out["geo"]
    rec = {"fake": np.array(out["fake"]), "label": np.array(out["label"]),
           "json": g["json_obj"]}
    rec.update({k: np.array(g[k]) for k in PLANES if k in g})
    for k in ("instance_map", "normal_map", "depth_map"):
        rec[k] = torch.as_tensor(g[k]).cpu()
    return rec


def check_chain_run(tag: str, saved: dict, records, n_pairs: int,
                    card: str) -> None:
    """A chain run's benchmark.json and fakes: every pair, finite metrics,
    each fake [192, 624, 3] (CHAIN_SHAPES), finite, in [-1, 1], labels
    < 14."""
    shape = (CHAIN_SHAPES["fine_height"], CHAIN_SHAPES["fine_width"], 3)
    bad = [i for i, r in enumerate(records)
           if r["fake"].shape != shape
           or not np.isfinite(r["fake"]).all()
           or np.abs(r["fake"]).max() > 1.0 or r["label"].max() >= 14]
    metrics_ok = all(np.isfinite(saved[k]) for k in
                     ("mean_L1", "mean_LPIPS", "mean_SSIM", "mean_PSNR"))
    if saved["pairs"] != n_pairs or len(records) != n_pairs or bad \
            or not metrics_ok:
        raise AssertionError(f"{tag}: pairs {saved['pairs']} of {n_pairs}, "
                             f"{len(records)} records, bad fakes at {bad}, "
                             f"metrics {saved}")
    log(f"[{tag}] benchmark.json: mean_L1 {saved['mean_L1']:.6f}, "
        f"mean_LPIPS {saved['mean_LPIPS']:.6f}, mean_SSIM "
        f"{saved['mean_SSIM']:.6f}, mean_PSNR {saved['mean_PSNR']:.4f}, "
        f"batch_pairs {saved['batch_pairs']}, pipelined "
        f"{saved['pipelined']}, chain_s {saved['chain_s']:.4f}, "
        f"steady_s_per_pair {saved.get('steady_s_per_pair', float('nan')):.4f}"
        f", edits_per_sec {saved['edits_per_sec']:.4f}, stage_s "
        f"{saved['stage_s']} ({card})")


def log_phases(tag: str, saved: dict, n_pairs: int, card: str) -> None:
    """Steady wall per stage and per pair: a stage's steady per-call time
    times its calls over the pairs (the cached stages run once per
    source); the first call of each phase carries one-time set-up."""
    for name, rec in sorted(saved["phase_breakdown"].items()):
        steady = rec.get("steady_avg_s")
        per_pair = ("n/a" if steady is None else
                    f"{steady * rec['calls'] / n_pairs:.6f}")
        log(f"[{tag}] phase {name}: calls {rec['calls']} first_s "
            f"{rec.get('first_s', rec['s']):.6f} steady_avg_s "
            f"{steady if steady is not None else 'n/a'} steady s/pair "
            f"{per_pair} MB {rec['MB']:.3f} ({card})")


def pil_transform(plane: np.ndarray, plan, nearest: bool) -> np.ndarray:
    """The host path's transform_image geometry of a uint8 plane with PIL:
    resize to the plan's size, then its centre crop."""
    from PIL import Image
    img = Image.fromarray(plane).resize(
        (plan.resize_w, plan.resize_h),
        Image.NEAREST if nearest else Image.BICUBIC)
    return np.asarray(img)[plan.crop_y:plan.crop_y + plan.out_h,
                           plan.crop_x:plan.crop_x + plan.out_w]


def same_pairs(got, want, what: str, fake_bound: float) -> float:
    """Two runs' pair records, pair by pair: labels, JSON, the planes both
    have and the full-resolution device maps equal; the fakes within
    `fake_bound` (0.0: bit-equal).  Returns the fakes' max |diff|."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a["label"], b["label"]) \
                or a["json"] != b["json"]:
            raise AssertionError(f"{what}, pair {i}: labels or JSON differ")
        for k in set(PLANES) & set(a) & set(b):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{what}, pair {i}: {k} differs")
        for k in ("instance_map", "normal_map", "depth_map"):
            if not torch.equal(a[k].to(b[k].dtype), b[k]):
                raise AssertionError(f"{what}, pair {i}: {k} differs")
        d = float(np.abs(a["fake"] - b["fake"]).max())
        worst = max(worst, d)
        if d > fake_bound:
            raise AssertionError(f"{what}, pair {i}: fake max |diff| {d} > "
                                 f"{fake_bound}")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} pairs vs {len(want)}")
    return worst


def generator_batch(chain, card: str) -> None:
    """The generator over a batch of BATCH_PAIRS conditioning stacks at
    192x624: frame by frame (GlobalGenerator.forward, what the batched
    chain runs) against one batched pass of its layers, in turns; the two
    outputs' max |diff| says whether cuDNN's batched convolutions would
    keep the serial bits."""
    import torch
    net = chain.textural_trainer.netG
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(BATCH_PAIRS, net.model[1].in_channels,
                    CHAIN_SHAPES["fine_height"], CHAIN_SHAPES["fine_width"],
                    generator=gen).to(chain.device)
    runs = {"frame by frame": [], "one batch": []}
    with torch.no_grad():
        diff = float((net(x) - net.model(x)).abs().max())
        for name in ("frame by frame", "one batch", "one batch",
                     "frame by frame"):
            fn = (lambda: net(x)) if name == "frame by frame" else \
                (lambda: net.model(x))
            runs[name].append(cuda_ms(fn, iters=5, warmup=1) / BATCH_PAIRS)
    log(f"[chain-8b] generator at {BATCH_PAIRS} x 192x624, ms per frame: "
        f"frame by frame {np.mean(runs['frame by frame']):.4f}, one batched "
        f"pass {np.mean(runs['one batch']):.4f} (runs {runs}); max |diff| "
        f"between the two {diff:.3g} ({card})")


def chain_requests(chain, root: str, edit_json: str):
    """The edit set's pairs as EditChain request dicts, in order."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.geometric_main import _keep_largest
    from sdn3d_tpu_torch.data import vkitti as VK

    table = VK.get_tables("inst", root)
    out = []
    for item in VK.benchmark_split(VK.load_edit_json(edit_json)):
        frame = int(item.source)
        image = np.asarray(Image.open(VK.rgb_path(
            root, item.world, item.topic, frame)).convert("RGB"))
        dets = _keep_largest(chain.infer_cfg, *VK.gt_objects(
            root, item.world, item.topic, frame, table))
        out.append({"image_rgb": image, "operations": item.operations,
                    "dets": dets, "cache_key": item.source_name})
    return out


def fresh_chain(chain, **cfg):
    """An EditChain over `chain`'s models (and detector) with empty caches
    (and, with `cfg`, another ChainConfig)."""
    import dataclasses

    from sdn3d_tpu_torch.pipelines.chain import EditChain
    return EditChain(dataclasses.replace(chain.cfg, **cfg),
                     chain.semantic_model, (chain.derender_model, chain.bank),
                     chain.textural_trainer, device=chain.device,
                     detector=chain.detector)


def edit_one(chain, r):
    return chain.edit_frame(r["image_rgb"], operations=r["operations"],
                            dets=r["dets"], cache_key=r["cache_key"])


def profile_chain_pair(chain, requests, card: str, n: int = 10) -> None:
    """Where one edit pair's time goes on the card, with the phase records
    off (nothing synchronises the card between stages): EditChain.edit_frame
    at the full-width defaults on the first edit pair of each source, host
    wall per call of edit_frame, `n` calls without the per-source caches
    (semantic, encode, render, textural all run) alternating with `n` calls
    that hit them; a cached pair must give the same bits as a fresh one.
    Then device time by kernel under torch.profiler for the uncached first
    pair."""
    import torch

    firsts = {}
    for r in requests:
        firsts.setdefault(r["cache_key"], r)

    def run(r, cache_key):
        t0 = time.perf_counter()
        out = edit_one(chain, dict(r, cache_key=cache_key))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    all_fresh, all_cached = [], []
    for key, r in firsts.items():
        run(r, None)
        _, fresh = run(r, None)
        run(r, key)                         # fills the caches
        walls = {None: [], key: []}
        for _ in range(n):
            for ck in (None, key):
                dt, out = run(r, ck)
                walls[ck].append(dt * 1e3)
        pairs = [(out[k], fresh[k], k) for k in ("fake", "label")] + [
            (out["geo"][k], fresh["geo"][k], k) for k in PLANES
            if k in fresh["geo"]]
        for got, want, name in pairs:
            if not np.array_equal(got, want):
                diff = np.abs(got.astype(np.float64) - want).max()
                raise AssertionError(f"{key}: a cached pair's {name} differs "
                                     f"from a fresh pair's by up to {diff}")
        all_fresh += walls[None]
        all_cached += walls[key]
        log(f"[chain-wall] {key} ({len(r['dets'][0])} cars), edit_frame wall "
            f"over {n} calls each, ms mean/median/min: uncached "
            f"{np.mean(walls[None]):.3f}/{np.median(walls[None]):.3f}/"
            f"{np.min(walls[None]):.3f}, cached {np.mean(walls[key]):.3f}/"
            f"{np.median(walls[key]):.3f}/{np.min(walls[key]):.3f}; cached "
            f"fake, label and planes bit-equal to a fresh pair ({card})")
    log(f"[chain-wall] all sources: uncached pair {np.mean(all_fresh):.3f} "
        f"ms mean, {np.median(all_fresh):.3f} median; cached pair "
        f"{np.mean(all_cached):.3f} ms mean, {np.median(all_cached):.3f} "
        f"median ({len(all_fresh)} calls each; {card})")

    first = next(iter(firsts.values()))
    m = 3
    t0 = time.perf_counter()
    for _ in range(m):
        run(first, None)
    wall_ms = (time.perf_counter() - t0) * 1e3 / m
    busy_ms, top = device_time(lambda: [run(first, None) for _ in range(m)],
                               m)
    what = f"chain pair ({len(first['dets'][0])} cars, no cache)"
    if busy_ms == 0.0:
        log(f"[profile] {what}: wall {wall_ms:.3f} ms/pair; device time not "
            f"measured (the profiler saw no device events)")
        return
    log(f"[profile] {what}: wall {wall_ms:.3f} ms/pair, device busy "
        f"{busy_ms:.3f} ms/pair, idle share {1.0 - busy_ms / wall_ms:.4f} "
        f"({card})")
    for name, (ms, count) in top[:12]:
        log(f"[profile]   {ms:9.4f} ms/pair  {count // m:4d} launches/pair"
            f"  {name[:90]}")


def device_time(fn, m: int):
    """Run fn under torch.profiler: (device busy ms per unit, [(kernel
    name, (ms per unit, launches))] by time), with `m` units in fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3 / m
            rec[1] += 1
    busy = sum(v[0] for v in by_name.values())
    return busy, sorted(by_name.items(), key=lambda kv: -kv[1][0])


def dtype_times(chain, image: np.ndarray, card: str) -> None:
    """The semantic pass of sem.infer (multiscale_labels_device on one
    375x1242 frame, 5 scales) and the generator of tex.generate (one
    192x624 frame) in float32 and bfloat16 on the card, in turns
    (float32, bfloat16, bfloat16, float32): ms per call from CUDA events
    over repeated calls (host enqueue gaps included), and device busy per
    call under the profiler."""
    import torch

    from sdn3d_tpu_torch.models.pix2pixhd import GlobalGenerator
    from sdn3d_tpu_torch.models.semantic import SemanticModel
    from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_device

    c, dev = chain.textural_trainer.cfg, chain.device
    s16 = SemanticModel(num_class=chain.cfg.num_class, dtype="bfloat16")
    s16.load_state_dict(chain.semantic_model.state_dict())
    g32 = chain.textural_trainer.netG
    g16 = GlobalGenerator(c.netG_input_nc, c.output_nc, c.ngf,
                          c.n_downsample_global, c.n_blocks_global,
                          dtype="bfloat16")
    g16.load_state_dict(g32.state_dict())
    x = torch.randn(1, c.netG_input_nc, CHAIN_SHAPES["fine_height"],
                    CHAIN_SHAPES["fine_width"],
                    generator=torch.Generator().manual_seed(2)).to(dev)
    scales = tuple(chain.cfg.scales)

    def sem_call(model):
        return lambda: multiscale_labels_device(model, image, scales, dev)

    s16, g16 = s16.to(dev).eval(), g16.to(dev).eval()
    cases = (("sem.infer semantic pass", {
        "float32": sem_call(chain.semantic_model), "bfloat16": sem_call(s16)}),
        ("tex.generate generator", {
            "float32": lambda: g32(x), "bfloat16": lambda: g16(x)}))
    with torch.no_grad():
        for what, fns in cases:
            ms = {k: [] for k in fns}
            for k in ("float32", "bfloat16", "bfloat16", "float32"):
                ms[k].append(cuda_ms(fns[k], iters=5, warmup=1))
            busy = {k: device_time(lambda: ([fn() for _ in range(3)],
                                            torch.cuda.synchronize()), 3)[0]
                    for k, fn in fns.items()}
            log(f"[chain-8d] {what}, ms a call: float32 "
                f"{np.mean(ms['float32']):.4f} (device busy "
                f"{busy['float32']:.4f}), bfloat16 "
                f"{np.mean(ms['bfloat16']):.4f} (device busy "
                f"{busy['bfloat16']:.4f}); runs {ms} ({card})")


def time_chain_modes(chain, requests, card: str, reps: int = 2,
                     tag: str = "chain-modes", split: bool = True) -> dict:
    """Steady wall per pair of the serial (edit_frame), batched
    (edit_frames, chunks of BATCH_PAIRS, the tail padded by repetition as
    the CLI pads) and pipelined (edit_frames_pipelined, the same chunks)
    chains over the whole edit set, each run on a chain with empty caches
    (so each source's first pair is uncached and its second cached, as in
    the CLI), in turns (serial, batched, pipelined, pipelined, batched,
    serial, ...), after one warm-up run each; then the device idle share
    of one run of each under torch.profiler.  Then the first BATCH_PAIRS
    pairs all uncached (no cache keys: every stage runs for every pair)
    and all cached, serial against batched, in turns (unless not
    `split`)."""
    import torch

    n = len(requests)
    chunks = [requests[i:i + BATCH_PAIRS] for i in range(0, n, BATCH_PAIRS)]
    chunks = [c + c[-1:] * (BATCH_PAIRS - len(c)) for c in chunks]

    def serial(ch, rs=requests):
        for r in rs:
            edit_one(ch, r)

    def batched(ch, cs=chunks):
        for c in cs:
            ch.edit_frames(c)

    def pipelined(ch, cs=chunks):
        for _ in ch.edit_frames_pipelined(iter(cs)):
            pass

    modes = {"serial": serial, "batched": batched, "pipelined": pipelined}

    def wall(fn, ch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(ch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for fn in modes.values():
        wall(fn, fresh_chain(chain))
    walls = {k: [] for k in modes}
    order = list(modes) + list(modes)[::-1]
    for _ in range(reps):
        for name in order:
            walls[name].append(wall(modes[name], fresh_chain(chain)) / n)
    out = {}
    for name, fn in modes.items():
        ms = walls[name]
        ch = fresh_chain(chain)
        busy, _ = device_time(lambda: (fn(ch), torch.cuda.synchronize()), n)
        # the profiler slows the host, so the idle share is the device
        # time of the profiled run over the unprofiled runs' wall
        idle = 1.0 - busy / np.mean(ms) if busy else float("nan")
        out[name] = float(np.mean(ms))
        log(f"[{tag}] {name}: {n} pairs (chunks of {BATCH_PAIRS}), "
            f"ms/pair over {len(ms)} runs mean {np.mean(ms):.3f} median "
            f"{np.median(ms):.3f} min {np.min(ms):.3f}; device busy "
            f"{busy:.3f} ms/pair (profiled run), idle share {idle:.4f} "
            f"({card})")

    if not split:
        return out
    head = requests[:BATCH_PAIRS]
    uncached = [dict(r, cache_key=None) for r in head]
    warm = fresh_chain(chain)
    serial(warm, head)                      # fills warm's caches
    split = {(m, c): [] for m in ("serial", "batched")
             for c in ("uncached", "cached")}
    for _ in range(reps):
        for m in ("serial", "batched", "batched", "serial"):
            for c, rs in (("uncached", uncached), ("cached", head)):
                fn = (lambda ch: serial(ch, rs)) if m == "serial" else \
                    (lambda ch: batched(ch, [rs]))
                split[(m, c)].append(wall(fn, warm) / len(rs))
    for c in ("uncached", "cached"):
        log(f"[{tag}] {len(head)} pairs {c}: serial "
            f"{np.mean(split[('serial', c)]):.3f} ms/pair, batched "
            f"{np.mean(split[('batched', c)]):.3f} ms/pair (means of "
            f"{len(split[('serial', c)])} runs each, in turns) ({card})")
    return out


def chain_reference(shapenet: str, root: str, edit_json: str,
                    seed: int) -> None:
    """The chain's CUDA path against its CPU path on one pair at small
    shapes (scale 100, render 64, 160x48 textural frames, device-downsized
    planes; full-width models, the same weights; `shapenet` holds small
    meshes, since the CPU's plain rasterizer took ~300 s a pair over the
    40k-face ones): labels and instance planes agree on >= 99.9% of
    pixels (ulp differences move near-ties and boundary pixels), the
    fakes by at most 5e-2 and on average by at most 1e-3."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.geometric_main import _keep_largest
    from sdn3d_tpu_torch.data import vkitti as VK
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain

    cfg = ChainConfig(scales=(100,), image_size=64, render_size=64,
                      load_size=160, fine_width=160, fine_height=48)
    item = VK.benchmark_split(VK.load_edit_json(edit_json))[0]
    frame = int(item.source)
    image = np.asarray(Image.open(VK.rgb_path(root, item.world, item.topic,
                                              frame)).convert("RGB"))
    outs = {}
    for d in ("cpu", "cuda"):
        chain = EditChain.build(cfg, shapenet, device=d, seed=seed)
        dets = _keep_largest(chain.infer_cfg, *VK.gt_objects(
            root, item.world, item.topic, frame, VK.get_tables("inst", root)))
        outs[d] = chain.edit_frame(image, operations=item.operations,
                                   dets=dets)
    a, b = outs["cpu"], outs["cuda"]
    lab = float((a["label"] == b["label"]).mean())
    inst = float((a["geo"]["instance_small"]
                  == b["geo"]["instance_small"]).mean())
    d = np.abs(a["fake"] - b["fake"])
    if lab < 0.999 or inst < 0.999 or d.max() > 5e-2 or d.mean() > 1e-3:
        raise AssertionError(f"chain cuda vs cpu: label agreement {lab}, "
                             f"instance agreement {inst}, fake max |diff| "
                             f"{d.max()}, mean {d.mean()}")
    log(f"[reference] chain cuda vs cpu on one pair (scale 100, render 64, "
        f"160x48): label agreement {lab}, instance agreement {inst}, fake "
        f"max |diff| {float(d.max()):.3g}, mean {float(d.mean()):.3g}")


# -- 9. detection ----------------------------------------------------------

def detector_flops(cfg) -> dict:
    """Multiply-adds of one frame through the detector at `cfg`, by module
    group, from the modules' shapes (forward hooks on the meta device,
    nothing computed): the backbone and FPN at the molded size, the RPN
    over P2..P6, the classifier at post_nms_rois_inference rois and the
    mask head at detection_max_instances rois (its transposed convolution
    counted by its useful products, not the zeros of the dilated input)."""
    import torch

    from sdn3d_tpu_torch.models.layers import ConvTranspose
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNN

    with torch.device("meta"):
        m = MaskRCNN(cfg)
    macs = {}

    def hook(group):
        def count(mod, inp, out):
            if isinstance(mod, ConvTranspose):
                n = inp[0].numel() * mod.weight[0].numel()
            elif isinstance(mod, torch.nn.Conv2d):
                n = out.numel() * mod.weight[0].numel()
            else:
                n = out.numel() * mod.weight.shape[1]
            macs[group] = macs.get(group, 0) + n
        return count

    for name, mod in m.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear, ConvTranspose)):
            parts = name.split(".")
            group = ".".join(parts[:2]) if parts[0] == "fpn" else parts[0]
            mod.register_forward_hook(hook(group))
    d = cfg.fpn_channels
    with torch.no_grad():
        m.rpn_forward(m.fpn(torch.empty(1, 3, cfg.image_max_dim,
                                        cfg.image_max_dim, device="meta")))
        c, mh = m.classifier, m.mask
        x = c.conv2(c.conv1(torch.empty(cfg.post_nms_rois_inference, d,
                                        cfg.pool_size, cfg.pool_size,
                                        device="meta"))).reshape(-1, 1024)
        c.linear_class(x)
        c.linear_bbox(x)
        x = torch.empty(cfg.detection_max_instances, d, cfg.mask_pool_size,
                        cfg.mask_pool_size, device="meta")
        for k in range(1, 5):
            x = getattr(mh, f"conv{k}")(x)
        mh.conv5(mh.deconv(x))
    return macs


def detector_checkpoint(path: str, seed: int) -> str:
    """The Mask R-CNN state_dict that phase 9's CLI runs load
    (--maskrcnn_ckpt), written from --seed: the weights the CLIs draw
    without a checkpoint (models/maskrcnn.init_weights), with the RPN's and
    the classifier's class and box weights scaled by DET_TAME and the
    classifier's class bias set to DET_CLASS_BIAS.  As drawn, the
    activations reach ~2e3 at full width: every RPN score is exactly 1.0
    (the 6000 "best" anchors are then the first in index order, above the
    frame's window), the box deltas reach ~1e3 (exp gives boxes of zero
    width) and no detection survives unmolding, so no object would reach
    the derenderer.  With this checkpoint the boxes stay near their
    anchors and class 1 scores ~0.9, over the default 0.7 confidence; the
    CLIs' configuration is unchanged."""
    import torch

    from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                                 init_weights)
    sd = init_weights(MaskRCNN(MaskRCNNConfig()), seed).state_dict()
    for k in ("rpn.conv_class.weight", "rpn.conv_bbox.weight",
              "classifier.linear_class.weight",
              "classifier.linear_bbox.weight"):
        sd[k] = sd[k] * DET_TAME
    sd["classifier.linear_class.bias"] = torch.tensor(DET_CLASS_BIAS)
    torch.save(sd, path)
    return path


def detector_stages(model, x, anchors, windows, feed=None) -> dict:
    """Each stage of MaskRCNN.forward on images `x` [F, 3, H, W]; with
    `feed` (another run's stages, on this device) every stage after the
    pyramid takes feed's inputs instead of its own stage's outputs."""
    from sdn3d_tpu_torch.models import maskrcnn as TM

    cfg, f, out = model.config, feed or {}, {}
    out["pyramid"] = model.fpn(x)
    pyr = f.get("pyramid", out["pyramid"])
    out["logits"], out["probs"], out["bbox"] = model.rpn_forward(pyr)
    out["props"], out["props_valid"] = TM.proposal_layer(
        f.get("probs", out["probs"]), f.get("bbox", out["bbox"]), anchors,
        cfg, cfg.post_nms_rois_inference)
    props = f.get("props", out["props"])
    feats = TM.RoiFeatures(pyr[:4])
    out["clogits"], out["cprobs"], out["cbbox"] = model.classifier(feats,
                                                                   props)
    out["dets"], out["dets_valid"] = TM.refine_detections(
        props, f.get("cprobs", out["cprobs"]), f.get("cbbox", out["cbbox"]),
        windows, f.get("props_valid", out["props_valid"]), cfg)
    dets = f.get("dets", out["dets"])
    out["masks"] = model.mask(feats, dets[..., :4] / float(cfg.image_max_dim))
    return out


def check_detector_stages(got: dict, ref: dict) -> dict:
    """The card's stages (each fed the CPU's inputs) against the CPU's:
    the errors, failing above the DET_* tolerances."""
    import torch

    def absd(a, b):
        # NaN against NaN and inf against the same inf count as equal (a
        # box of random deltas may overflow); anything else by its |diff|
        a, b = a.cpu().double(), b.cpu().double()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        return float(torch.where(same, 0.0, (a - b).abs()).max())

    def rel(a, b):
        b_fin = b.cpu().double()
        scale = b_fin[torch.isfinite(b_fin)].abs().max().clamp(min=1e-30)
        return absd(a, b) / float(scale)

    e = {"pyramid": max(rel(a, b) for a, b in zip(got["pyramid"],
                                                  ref["pyramid"])),
         "rpn": max(rel(got[k], ref[k]) for k in ("logits", "bbox")),
         "rpn_probs": absd(got["probs"], ref["probs"]),
         "proposals": absd(got["props"], ref["props"]),
         "classifier": max(rel(got[k], ref[k]) for k in ("clogits",
                                                         "cbbox")),
         "classifier_probs": absd(got["cprobs"], ref["cprobs"]),
         "boxes": absd(got["dets"][..., :4], ref["dets"][..., :4]),
         "scores": absd(got["dets"][..., 5], ref["dets"][..., 5]),
         "masks": absd(got["masks"], ref["masks"])}
    exact = (torch.equal(got["props_valid"].cpu(), ref["props_valid"])
             and torch.equal(got["dets_valid"].cpu(), ref["dets_valid"])
             and torch.equal(got["dets"][..., 4].cpu(), ref["dets"][..., 4]))
    bounds = {"pyramid": DET_RTOL, "rpn": DET_RTOL,
              "rpn_probs": max(DET_PROB_ATOL, 0.5 * absd(got["logits"],
                                                         ref["logits"])),
              "proposals": DET_PROPOSAL_ATOL, "classifier": DET_RTOL,
              "classifier_probs": max(DET_PROB_ATOL, 0.5 * absd(
                  got["clogits"], ref["clogits"])),
              "boxes": DET_BOX_ATOL, "scores": DET_PROB_ATOL,
              "masks": DET_MASK_ATOL}
    bad = {k: v for k, v in e.items() if not v <= bounds[k]}
    if bad or not exact:
        raise AssertionError(f"detector card vs cpu: over the bounds {bad} "
                             f"({bounds}); validity and classes equal: "
                             f"{exact}")
    return e


def detection_phase(args, card: str, frames, shapenet: str, tmp: str,
                    mark=lambda what: None) -> str:
    """Phase 9 (detection as the serving source): 9a the full-width
    detector card against CPU, stage by stage, and the card's packed
    buffer to the same bits on two runs; 9b the RPN NMS at 6000 boxes;
    9c the detector's time a frame, serial and at batch 4, float32 and
    bfloat16, with device busy and idle share; 9d geometric_main at its
    defaults (--source maskrcnn).  Returns the checkpoint of
    detector_checkpoint, which the chain phase's detection runs load."""
    import torch
    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.models import maskrcnn as TM
    from sdn3d_tpu_torch.ops import nms as N
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.pipelines.detect import (MaskRCNNDetector,
                                                  resize_image)

    cfg = TM.MaskRCNNConfig()
    macs = detector_flops(cfg)
    total = sum(macs.values())
    top = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                    sorted(macs.items(), key=lambda kv: -kv[1])[:6])
    log(f"[detect] MaskRCNNConfig() at {cfg.image_max_dim}^2: "
        f"{total / 1e9:.3f} GMAC = {2 * total / 1e9:.3f} GFLOP a frame "
        f"(GMAC: {top}); bound {2 * total / H100_FP32_FLOPS * 1e3:.3f} ms "
        f"float32, {2 * total / H100_BF16_FLOPS * 1e3:.3f} ms bfloat16")

    # -- 9a. card against CPU, stage by stage (the CLIs' random weights) --
    t0 = time.perf_counter()
    gpu = MaskRCNNDetector(cfg, "cuda").init(args.seed)
    cpu = MaskRCNNDetector(cfg, "cpu").init(args.seed)
    image = np.asarray(Image.open(frames[-1][0]).convert("RGB"))
    molded, window, _ = resize_image(image, cfg.image_min_dim,
                                     cfg.image_max_dim)
    x = torch.from_numpy(molded.astype(np.float32) - np.asarray(
        cfg.mean_pixel, np.float32)).permute(2, 0, 1)[None].contiguous()
    win = torch.tensor([window], dtype=torch.float32)
    anchors = torch.from_numpy(cpu.anchors)
    with torch.no_grad():
        ref = detector_stages(cpu.model, x, anchors, win)
        cuda = {k: ([t.cuda() for t in v] if isinstance(v, list)
                    else v.cuda()) for k, v in ref.items()}
        got = detector_stages(gpu.model, x.cuda(), anchors.cuda(),
                              win.cuda(), feed=cuda)
        errs = check_detector_stages(got, ref)
        p1 = gpu._packed([molded], [window])
        p2 = gpu._packed([molded], [window])
        p_cpu = cpu._packed([molded], [window])
    if not torch.equal(p1, p2) or not torch.isfinite(p1).all():
        raise AssertionError("detector: two runs of one frame on the card "
                             "gave different or non-finite bits")
    D = cfg.detection_max_instances
    v_gpu, v_cpu = p1[0, D * 6:D * 7].cpu(), p_cpu[0, D * 6:D * 7]
    log(f"[detect-9a] full-width detector (ResNet-101 FPN, "
        f"{cfg.image_max_dim}^2, {cfg.pre_nms_limit} -> "
        f"{cfg.post_nms_rois_inference} proposals, {D} detections), random "
        f"weights from --seed, card vs cpu with each card stage fed the "
        f"cpu's inputs: validity and classes equal; max errors {errs}; the "
        f"card's packed buffer bit-equal on two runs; end to end (each on "
        f"its own stages) valid detections card {int(v_gpu.sum())} cpu "
        f"{int(v_cpu.sum())}, packed max |diff| "
        f"{float((p1[0].cpu() - p_cpu[0]).abs().max()):.3g} "
        f"({time.perf_counter() - t0:.1f} s with the cpu reference) ({card})")
    mark("9a. detector card vs cpu")

    # -- 9b. the RPN NMS at 6000 boxes: raw weights, then the checkpoint's -
    ckpt = detector_checkpoint(os.path.join(tmp, "maskrcnn.pth"), args.seed)
    tamed = MaskRCNNDetector(cfg, "cuda").load_state_dict(torch.load(ckpt))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for what, det in (("random weights", gpu), ("checkpoint", tamed)):
        with torch.no_grad():
            probs, bbox = det.model.rpn_forward(det.model.fpn(x.cuda()))[1:]
            boxes, _ = TM.proposal_boxes(probs, bbox, anchors.cuda(), cfg)
        boxes = boxes[0]
        stats = {}
        keep = N.nms(boxes, cfg.rpn_nms_threshold, stats=stats)
        keep_cpu = N.nms(boxes.cpu(), cfg.rpn_nms_threshold)
        if not torch.equal(keep.cpu(), keep_cpu):
            raise AssertionError(f"RPN NMS ({what}): card keep != cpu keep")
        ms = cuda_ms(lambda: N.nms(boxes, cfg.rpn_nms_threshold), iters=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            N.nms(boxes, cfg.rpn_nms_threshold)
        launches = sum(e.device_type == DeviceType.CUDA
                       for e in prof.events())
        # bytes: the boxes read once, the keep mask written once
        log(f"[detect-9b] RPN NMS ({what}) at {boxes.shape[0]} boxes: card "
            f"keep == cpu keep ({int(keep.sum())} kept); {stats['steps']} "
            f"fixed-point steps, {launches} device launches a call "
            f"(profiler), {ms:.4f} ms a call ({card})")
    mark("9b. RPN NMS")

    # -- 9c. time a frame: forward and detect, float32 and bfloat16 -------
    half = MaskRCNNDetector(TM.MaskRCNNConfig(compute_dtype="bfloat16"),
                            "cuda").load_state_dict(torch.load(ckpt))
    xb = x.cuda()
    wb = win.cuda()
    ab = anchors.cuda()
    with torch.no_grad():
        for name, det in (("float32", tamed), ("bfloat16", half)):
            runs = {}
            for n in (1, BATCH_PAIRS, BATCH_PAIRS, 1):
                xs = xb.expand(n, -1, -1, -1).contiguous()
                ws = wb.expand(n, -1).contiguous()
                runs.setdefault(n, []).append(cuda_ms(
                    lambda: det.model(xs, ab, ws), iters=3) / n)
            log(f"[detect-9c] forward {name}, ms a frame (CUDA events, in "
                f"turns 1, {BATCH_PAIRS}, {BATCH_PAIRS}, 1): batch 1 "
                f"{np.mean(runs[1]):.3f}, batch {BATCH_PAIRS} "
                f"{np.mean(runs[BATCH_PAIRS]):.3f} (runs {runs}) ({card})")
    frames_rgb = [np.asarray(Image.open(f[0]).convert("RGB")) for f in frames]
    for name, det in (("float32", tamed), ("bfloat16", half)):
        det.detect(frames_rgb[0])
        t0 = time.perf_counter()
        outs = [det.detect(f) for f in frames_rgb for _ in range(2)]
        wall = (time.perf_counter() - t0) * 1e3 / len(outs)
        det.detect_batch(frames_rgb + frames_rgb[:1])
        t0 = time.perf_counter()
        det.detect_batch(frames_rgb + frames_rgb[:1])
        det.detect_batch(frames_rgb + frames_rgb[:1])
        wall_b = (time.perf_counter() - t0) * 1e3 / (2 * BATCH_PAIRS)
        busy, top_k = device_time(lambda: [det.detect(f) for f in frames_rgb],
                                  len(frames_rgb))
        log(f"[detect-9c] detect {name}: {[len(o[0]) for o in outs[::2]]} "
            f"objects on the three frames; wall {wall:.3f} ms a frame "
            f"serial (mold, upload, forward, packed copy, unmold), "
            f"{wall_b:.3f} ms a frame in detect_batch of {BATCH_PAIRS}; "
            f"device busy {busy:.3f} ms a frame, idle share "
            f"{1.0 - busy / wall:.4f} ({card})")
        for kname, (kms, count) in top_k[:6]:
            log(f"[detect-9c]   {kms:9.4f} ms/frame  {count // 3:4d} "
                f"launches/frame  {kname[:90]}")
    mark("9c. detector times")

    # -- 9d. geometric_main at its defaults (--source maskrcnn) -----------
    launch = TC.rasterize_face_index_cuda
    launch.launches = 0
    TR.rasterize_face_maps.calls = 0
    n_objs, t0 = [], time.perf_counter()
    for k, (img, _, edit, _) in enumerate(frames):
        out_dir = os.path.join(tmp, f"detect{k}")
        geometric_main.main(["--input_image", img, "--edit_json", edit,
                             "--shapenet_root", shapenet, "--output_dir",
                             out_dir, "--seed", str(args.seed),
                             "--maskrcnn_ckpt", ckpt])
        n_objs.append(check_outputs(out_dir, 16, min_objs=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1, plain = launch.launches, TR.rasterize_face_maps.calls
    if b1 != 2 * len(frames) or plain or not sum(n_objs):
        raise AssertionError(f"geometric_main --source maskrcnn: forward "
                             f"launches {b1} for {2 * len(frames)} items, "
                             f"plain calls {plain}, objects {n_objs}")
    out_dir = os.path.join(tmp, "detect_random")
    geometric_main.main(["--input_image", frames[0][0], "--shapenet_root",
                         shapenet, "--output_dir", out_dir, "--seed",
                         str(args.seed)])
    n_random = check_outputs(out_dir, 16, names=("frame0",), min_objs=0)
    frame_ms, frame_busy = detect_frame_wall(frames[-1], shapenet, ckpt,
                                             args.seed)
    log(f"[detect-9d] geometric_main at its defaults (--source maskrcnn, "
        f"the detector checkpoint written from --seed): {len(frames)} "
        f"frames x 2 items in {wall:.2f} s (models built included), objects "
        f"per frame {n_objs}; forward kernel launches {b1}, plain forward "
        f"calls {plain}; outputs ok.  Without --maskrcnn_ckpt (the weights "
        f"as drawn): {n_random} objects, outputs ok.  One served frame "
        f"(the 16-car frame, detect + derender_image, steady): wall "
        f"{frame_ms:.3f} ms, device busy {frame_busy:.3f} ms, idle share "
        f"{1.0 - frame_busy / frame_ms:.4f} ({card})")
    mark("9d. geometric_main --source maskrcnn")
    return ckpt


def detect_frame_wall(frame, shapenet: str, ckpt: str, seed: int):
    """One geometric_main --source maskrcnn frame without the CLI's file
    writes and model builds: detect (the checkpoint's weights) and the
    unrefined derender_image of its first edit item, host wall per frame
    over 5 steady calls and device busy per frame under torch.profiler.
    Returns (wall ms, busy ms)."""
    import torch
    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.data.vkitti import load_edit_json
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, keep_largest_detections)

    img, _, edit, _ = frame
    args = geometric_main.build_argparser().parse_args(
        ["--shapenet_root", shapenet, "--seed", str(seed), "--maskrcnn_ckpt",
         ckpt])
    model, bank = geometric_main.load_derenderer(args)
    det = geometric_main.make_detector(args)
    cfg = DerenderInferConfig()
    image = np.asarray(Image.open(img).convert("RGB"))
    ops = load_edit_json(edit)[0].operations

    def run():
        dets = keep_largest_detections(cfg, *det.detect(image))
        derender_image(model, bank, image, *dets, cfg, operations=ops,
                       device="cuda")
        torch.cuda.synchronize()

    run()
    run()
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    busy_ms, _ = device_time(lambda: [run() for _ in range(3)], 3)
    return wall_ms, busy_ms


def chain_phase(args, card: str, mark=lambda what: None) -> int:
    """Phase 8: the fused edit chain at full width, its serving modes
    (8a small against full fetch, 8b batched, 8c pipelined, 8d bfloat16,
    8e LPIPS), their wall per pair and the chain's CUDA path against its
    CPU path; `mark(step)` logs the time at the end of each step.
    Returns the forward kernel's launches on the default chain's run."""
    import torch

    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.ops.pil_resize import transform_plan
    from sdn3d_tpu_torch.utils import phases

    launch, dispatch = TC.rasterize_face_index_cuda, TC.rasterize_face_index
    inner = (TC.bin_faces_cuda, TC.raster_binned_cuda, TC.won_pixel_boxes_cuda)
    plain_fns = (TR.rasterize_face_maps, TR.walk_grads_plain,
                 TR.segment_face_grads_plain, TR.edge_invariant_stack,
                 TR.face_pixel_coords)

    def inner_counts():
        return tuple(fn.launches for fn in inner)

    def plain_counts():
        return tuple(fn.calls for fn in plain_fns)

    from sdn3d_tpu_torch.cli import edit_chain
    from sdn3d_tpu_torch.models.lpips import init_lpips
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain
    with tempfile.TemporaryDirectory(prefix="sdn3d_chain_") as tmp:
        t0 = time.perf_counter()
        shapenet, _ = write_assets(tmp, args.seed)
        root = os.path.join(tmp, "vkitti")
        edit_json, n_pairs = write_chain_root(root, args.seed)
        log(f"[chain] wrote assets and a VKITTI root ({n_pairs} edit pairs) "
            f"in {time.perf_counter() - t0:.1f} s")
        images = []                   # forward launches' image counts

        def shape_recording(faces, face_valid, image_size,
                            near=TR.DEFAULT_NEAR, far=TR.DEFAULT_FAR,
                            colors=None):
            images.append(int(faces.shape[0]))
            return dispatch(faces, face_valid, image_size, near, far, colors)

        def run_cli(tag, extra, phases_on=True):
            """cli/edit_chain.main over the edit set; counts set to 0 just
            before and read just after.  Returns (benchmark.json, the pairs'
            records in order, forward launches, bin/raster/box launches,
            plain calls, launches' image counts, wall s)."""
            records = []
            chunk = BATCH_PAIRS if "--batch_pairs" in extra else 1

            def keep(outs):
                # drop the padded outputs of a tail chunk, as the CLI does
                real = min(chunk, n_pairs - len(records))
                records.extend(pair_record(o) for o in outs[:real])
                return outs

            originals = (EditChain.edit_frame, EditChain.edit_frames,
                         EditChain._stage_c)
            EditChain.edit_frame = lambda self, *a, **kw: keep(
                [originals[0](self, *a, **kw)])[0]
            EditChain.edit_frames = lambda self, rs: keep(
                originals[1](self, rs))
            EditChain._stage_c = lambda self, b: keep(originals[2](self, b))
            TC.rasterize_face_index = shape_recording
            images.clear()
            launch.launches = 0
            for fn in inner:
                fn.launches = 0
            for fn in plain_fns:
                fn.calls = 0
            t0 = time.perf_counter()
            try:
                edit_chain.main([
                    "--edit_json", edit_json, "--data_root", root,
                    "--shapenet_root", shapenet, "--seed", str(args.seed),
                    "--results_dir", os.path.join(tmp, tag)]
                    + (["--phases"] if phases_on else []) + extra)
                torch.cuda.synchronize()
            finally:
                (EditChain.edit_frame, EditChain.edit_frames,
                 EditChain._stage_c) = originals
                TC.rasterize_face_index = dispatch
                phases.reset(False)
            wall = time.perf_counter() - t0
            counts = (launch.launches, inner_counts(), plain_counts(),
                      list(images))
            with open(os.path.join(tmp, tag, "benchmark.json")) as fh:
                saved = json.load(fh)
            check_chain_run(tag, saved, records, n_pairs, card)
            return (saved, records) + counts + (wall,)

        (saved, serial, c_launches, c_inner, c_plain, c_images,
         c_wall) = run_cli("chain_out", [])
        if c_launches != n_pairs or c_inner[:2] != (n_pairs, n_pairs) \
                or any(c_plain) or set(c_images) != {16}:
            raise AssertionError(f"chain path: forward launches {c_launches} "
                                 f"(bin, raster {c_inner[:2]}, images "
                                 f"{c_images}) for {n_pairs} pairs, plain "
                                 f"calls {c_plain}")
        if "instance_small" not in serial[0]:
            raise AssertionError("the default chain did not fetch the "
                                 "device-downsized planes")
        log(f"[chain] {n_pairs} pairs in {c_wall:.2f} s (models built "
            f"included); forward kernel launches {c_launches} (bin "
            f"{c_inner[0]}, raster {c_inner[1]}, {c_images[0]} images each); "
            f"plain calls (rasterizer, walk, reduction, edge_invariant_stack, "
            f"face_pixel_coords) {c_plain}; small_fetch on")
        log_phases("chain", saved, n_pairs, card)
        mark("8. chain, default")

        # 8a. small against full fetch
        saved_f, full, *_ = run_cli("chain_full", ["--full_fetch"])
        plan = transform_plan((1242, 375), CHAIN_SHAPES["load_size"],
                              (CHAIN_SHAPES["fine_width"],
                               CHAIN_SHAPES["fine_height"]))
        for i, (s_, f_) in enumerate(zip(serial, full)):
            for k, nearest in (("instance", True), ("normal", False)):
                want = pil_transform(f_[f"{k}_png"], plan, nearest)
                if not np.array_equal(s_[f"{k}_small"], want):
                    raise AssertionError(f"pair {i}: {k}_small differs from "
                                         f"the PIL transform of {k}_png")
        same_pairs(serial, full, "8a small vs full fetch", 0.0)
        mb = {t: sv["phase_breakdown"]["geo.package"]["MB"]
              / sv["phase_breakdown"]["geo.package"]["calls"]
              for t, sv in (("small", saved), ("full", saved_f))}
        log(f"[chain-8a] small vs full fetch over {n_pairs} pairs: "
            f"instance_small / normal_small byte-equal to the PIL transform "
            f"of the full planes, fakes, labels, JSON and device maps "
            f"bit-equal; geo.package {mb['small'] * 1e6:.0f} B a pair small, "
            f"{mb['full'] * 1e6:.0f} B full ({card})")

        mark("8a. full fetch")
        # 8b. batched: chunks of BATCH_PAIRS, the tail padded
        (saved_b, batched, b_launches, b_inner, b_plain, b_images,
         _) = run_cli("chain_batched", ["--batch_pairs", str(BATCH_PAIRS)])
        n_chunks = -(-n_pairs // BATCH_PAIRS)
        if b_launches != n_chunks or b_inner[:2] != (n_chunks, n_chunks) \
                or any(b_plain) or set(b_images) != {16 * BATCH_PAIRS}:
            raise AssertionError(f"batched chain: forward launches "
                                 f"{b_launches} (bin, raster {b_inner[:2]}, "
                                 f"images {b_images}) for {n_chunks} chunks, "
                                 f"plain calls {b_plain}")
        b_diff = same_pairs(batched, serial, "8b batched vs serial",
                            FAKE_BATCH_BOUND)
        log(f"[chain-8b] batch_pairs {BATCH_PAIRS}: {b_launches} forward "
            f"launches for {n_pairs} pairs at {b_images[0]} images each, "
            f"plain calls {b_plain}; labels, planes, device maps and JSON "
            f"equal to the serial run pair by pair; fake max |diff| "
            f"{b_diff:.3g} (bit-equal: {b_diff == 0.0}) ({card})")
        log_phases("chain-8b", saved_b, n_pairs, card)

        mark("8b. batched")
        # 8c. pipelined, with 8e: an official-layout LPIPS checkpoint from
        # --seed (seed + 1: seed 0 is the metric's own random default)
        ckpt = os.path.join(tmp, "lpips_vgg.pth")
        torch.save(init_lpips(args.seed + 1, "cpu").state_dict(), ckpt)
        saved_p, piped, p_launches, *_ = run_cli(
            "chain_piped", ["--batch_pairs", str(BATCH_PAIRS), "--pipeline",
                            "--lpips_ckpt", ckpt], phases_on=False)
        p_diff = same_pairs(piped, batched, "8c pipelined vs batched", 0.0)
        log(f"[chain-8c] pipelined, batch_pairs {BATCH_PAIRS}: outputs "
            f"bit-equal to the batched run (fake max |diff| {p_diff}); "
            f"forward launches {p_launches}; steady_s_per_pair "
            f"{saved_p.get('steady_s_per_pair', float('nan')):.4f} (one "
            f"steady chunk here; the stream's times are [chain-modes]) "
            f"({card})")
        if not (saved_p["lpips_backbone"] == "ported"
                and np.isfinite(saved_p["mean_LPIPS"])
                and saved["lpips_backbone"] == "random-init (uncalibrated)"
                and np.isfinite(saved["mean_LPIPS"])):
            raise AssertionError(f"LPIPS: {saved_p}, {saved}")
        log(f"[chain-8e] --lpips_ckpt (official layout, from --seed): "
            f"mean_LPIPS {saved_p['mean_LPIPS']:.6f}, lpips_backbone "
            f"{saved_p['lpips_backbone']!r}; without it "
            f"{saved['mean_LPIPS']:.6f} ({saved['lpips_backbone']!r}) "
            f"({card})")

        mark("8c/8e. pipelined, LPIPS")
        # 8d. bfloat16
        saved_h, half, *_ = run_cli("chain_bf16",
                                    ["--compute_dtype", "bfloat16"])
        agree = [float((h["label"] == s_["label"]).mean())
                 for h, s_ in zip(half, serial)]
        d_fake = max(float(np.abs(h["fake"] - s_["fake"]).max())
                     for h, s_ in zip(half, serial))
        log(f"[chain-8d] bfloat16: fakes finite in [-1, 1]; labels agree "
            f"with float32 on {min(agree):.6f} (worst pair) / "
            f"{np.mean(agree):.6f} (mean) of pixels; fake max |diff| from "
            f"float32 {d_fake:.4f} ({card})")
        for name in ("sem.infer", "tex.generate", "geo.encode"):
            f32 = saved["phase_breakdown"][name].get("steady_avg_s")
            b16 = saved_h["phase_breakdown"][name].get("steady_avg_s")
            log(f"[chain-8d] {name} steady s/call (host wall, the card "
                f"synchronised at the phase's end): float32 {f32:.6f}, "
                f"bfloat16 {b16:.6f} ({card})")

        mark("8d. bfloat16")
        # 9e. Mask R-CNN as the chain's source: serial, batched, pipelined
        det_ckpt = detector_checkpoint(os.path.join(tmp, "maskrcnn.pth"),
                                       args.seed)
        mr = ["--source", "maskrcnn", "--maskrcnn_ckpt", det_ckpt]
        (saved_m, m_serial, m_launches, _, m_plain, m_images,
         m_wall) = run_cli("chain_mrcnn", mr)
        (saved_mb, m_batched, mb_launches, _, mb_plain, mb_images,
         _) = run_cli("chain_mrcnn_batched",
                      mr + ["--batch_pairs", str(BATCH_PAIRS)])
        saved_mp, m_piped, mp_launches, _, mp_plain, *_ = run_cli(
            "chain_mrcnn_piped", mr + ["--batch_pairs", str(BATCH_PAIRS),
                                       "--pipeline"], phases_on=False)
        objs = [len(r["json"]) for r in m_serial]
        if (m_launches, mb_launches, mp_launches) != (n_pairs, n_chunks,
                                                      n_chunks) \
                or any(m_plain) or any(mb_plain) or any(mp_plain) \
                or set(m_images) != {16} \
                or set(mb_images) != {16 * BATCH_PAIRS} or not any(objs):
            raise AssertionError(f"maskrcnn chain: forward launches serial "
                                 f"{m_launches} (images {m_images}), batched "
                                 f"{mb_launches} (images {mb_images}), "
                                 f"pipelined {mp_launches}; plain calls "
                                 f"{m_plain} {mb_plain} {mp_plain}; objects "
                                 f"a pair {objs}")
        mp_diff = same_pairs(m_piped, m_batched, "9e pipelined vs batched",
                             0.0)
        same_json = all(a["json"] == b["json"]
                        for a, b in zip(m_serial, m_batched))
        sb_diff = max(float(np.abs(a["fake"] - b["fake"]).max())
                      for a, b in zip(m_serial, m_batched))
        log(f"[chain-9e] --source maskrcnn (detector checkpoint from "
            f"--seed): {n_pairs} pairs in {m_wall:.2f} s serial (models "
            f"built included), objects a pair {objs}; forward kernel "
            f"launches serial {m_launches} at 16 images, batched "
            f"{mb_launches} and pipelined {mp_launches} at "
            f"{16 * BATCH_PAIRS}; plain forward calls 0; pipelined bit-equal "
            f"to batched (fake max |diff| {mp_diff}); batched against serial "
            f"(one detection pass of {BATCH_PAIRS} frames against one a "
            f"frame): JSON equal {same_json}, fake max |diff| {sb_diff:.3g}; "
            f"steady_s_per_pair serial "
            f"{saved_m.get('steady_s_per_pair', float('nan')):.4f}, batched "
            f"{saved_mb.get('steady_s_per_pair', float('nan')):.4f}, "
            f"pipelined {saved_mp.get('steady_s_per_pair', float('nan')):.4f}"
            f" ({card})")
        log_phases("chain-9e", saved_m, n_pairs, card)
        mark("9e. maskrcnn chain runs")
        chain = EditChain.build(ChainConfig(), shapenet, device="cuda",
                                seed=args.seed)
        requests = chain_requests(chain, root, edit_json)
        generator_batch(chain, card)
        dtype_times(chain, requests[0]["image_rgb"], card)
        mark("8b/8d. generator batch, dtype times")
        time_chain_modes(chain, requests, card)
        mark("8. modes on one stream")
        time_chain_modes(EditChain.build(ChainConfig(), shapenet,
                                         maskrcnn_ckpt=det_ckpt, device="cuda",
                                         seed=args.seed),
                         [dict(r, dets=None) for r in requests], card,
                         reps=1, tag="chain-9e-modes", split=False)
        mark("9e. maskrcnn modes on one stream")
        profile_chain_pair(chain, requests, card, n=6)
        mark("8. pair profile")
        chain_reference(write_meshes(os.path.join(tmp, "shapenet_small"),
                                     args.seed, 20, 40),
                        root, edit_json, args.seed)
        mark("8. chain reference")

    return c_launches


# -- 10. the per-stage file contract -------------------------------------

def step_directories(tmp: str, seed: int) -> dict:
    """The chain's weights from `seed`, drawn as the CLIs draw them when no
    checkpoint is given, written once as core/checkpoint step directories:
    the semantic model ("encoder", "decoder"), the derenderer
    ("derenderer") and the full-width textural nets ("netG", "netE", meta
    as the textural trainer persists it).  Returns {name: directory}."""
    import torch

    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint
    from sdn3d_tpu_torch.models.derenderer import Derenderer
    from sdn3d_tpu_torch.models.semantic import SemanticModel
    from sdn3d_tpu_torch.pipelines.textural import (TexturalConfig,
                                                    TexturalTrainer)

    dirs = {k: os.path.join(tmp, f"ckpt_{k}") for k in ("sem", "der", "tex")}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sem = SemanticModel(num_class=14)
        torch.manual_seed(seed)
        der = Derenderer(num_classes=8)
        torch.manual_seed(seed)
        tex = TexturalTrainer(TexturalConfig())
    save_checkpoint(dirs["sem"], 0, {"encoder": sem.encoder.state_dict(),
                                     "decoder": sem.decoder.state_dict()})
    save_checkpoint(dirs["der"], 0, {"derenderer": der.state_dict()})
    save_checkpoint(dirs["tex"], 0, {"netG": tex.netG.state_dict(),
                                     "netE": tex.netE.state_dict()},
                    meta={"small": False, "no_vgg": True})
    return dirs


def same_files(a_dir: str, b_dir: str, names) -> None:
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as a, \
                open(os.path.join(b_dir, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{name}: {a_dir} and {b_dir} differ")


def crop_times(image: np.ndarray, rois: np.ndarray, masks: np.ndarray,
               class_ids: np.ndarray, card: str, reps: int = 5) -> None:
    """geo.prep's host work (derender_infer.prepare_objects: the uint8
    crops of a frame's objects) through the native host library against
    its numpy + PIL path, in turns; the two crops' bytes differ by at most
    one (the float crops agree to 1e-5, so a byte flips where its value
    lies that close to a rounding boundary)."""
    from sdn3d_tpu_torch.data import native
    from sdn3d_tpu_torch.pipelines.derender_infer import (DerenderInferConfig,
                                                          prepare_objects)

    cfg = DerenderInferConfig()
    saved = dict(native._state)
    runs = {"native": [], "PIL": []}
    outs = {}
    try:
        for path in ("native", "PIL", "PIL", "native") * reps:
            native._state.update(saved if path == "native"
                                 else {"tried": True, "lib": None})
            t0 = time.perf_counter()
            outs[path] = prepare_objects(image, rois, masks, class_ids, cfg)
            runs[path].append(time.perf_counter() - t0)
    finally:
        native._state.update(saved)
    diff = np.abs(outs["native"]["rgbs"].astype(int)
                  - outs["PIL"]["rgbs"].astype(int))
    n = outs["native"]["num_objs"]
    if diff.max() > 1:
        raise AssertionError(f"native against PIL crops: max {diff.max()}")
    log(f"[files-prep] prepare_objects of {n} objects at "
        f"{cfg.image_size}^2: native {np.median(runs['native']) * 1e3:.3f} "
        f"ms, numpy + PIL {np.median(runs['PIL']) * 1e3:.3f} ms (medians of "
        f"{2 * reps}, host wall); bytes differing by one "
        f"{int((diff > 0).sum())} of {diff.size} ({card})")


def file_contract_phase(args, card: str, mark=lambda what: None) -> None:
    """Phase 10: the reference's per-stage file contract at the chain's
    full widths (ChainConfig defaults), the weights from --seed written
    once as step directories (step_directories).  10a: semantic_test
    --test_img benchmark -> geometric_main --vkitti_root --edit_json
    --source gt -> edit_benchmark --chain_times on the chain phase's root,
    then edit_chain --dump_dirs with the same step directories: the dumped
    label and contract files byte-equal to the per-stage CLIs', mean L1 /
    SSIM / PSNR within 1e-6, one forward-kernel launch per geometric item
    and no plain forward.  10b: geometric_main --vkitti_root --split test
    -> textural_test on a root whose frames lie in the test ranges, with
    motgt tables: every frame written, a finite avg.  10c: geometric_main
    --input_image --edit_json --input_masks -> edit_vkitti (--edit_num 2):
    one launch an item, finite fakes, the gallery.  Also the native crops
    against the numpy + PIL path in geo.prep."""
    import torch
    from PIL import Image

    from sdn3d_tpu_torch.cli import (edit_benchmark, edit_chain, edit_vkitti,
                                     geometric_main, semantic_test,
                                     textural_test)
    from sdn3d_tpu_torch.data import native
    from sdn3d_tpu_torch.data import vkitti as VK
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC

    if not native.available():
        raise AssertionError("the native host library is not built")
    launch = TC.rasterize_face_index_cuda
    inner = (TC.bin_faces_cuda, TC.raster_binned_cuda)

    def geometric(tag, argv, items):
        """geometric_main with the forward's counts set to 0 just before
        and read just after; one launch an item, no plain forward."""
        launch.launches = 0
        for fn in inner:
            fn.launches = 0
        TR.rasterize_face_maps.calls = 0
        t0 = time.perf_counter()
        geometric_main.main(["--ckpt_dir", ckpt["der"], "--shapenet_root",
                             shapenet] + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (launch.launches, tuple(fn.launches for fn in inner),
                  TR.rasterize_face_maps.calls)
        if counts != (items, (items, items), 0):
            raise AssertionError(f"{tag}: forward launches (wrapper, bin / "
                                 f"raster, plain) {counts} for {items} items")
        log(f"[{tag}] geometric_main: {items} items in {wall:.3f} s (models "
            f"and mesh bank loaded included), forward launches {counts[0]} "
            f"(bin, raster {counts[1]}), plain forward calls 0 ({card})")
        return wall

    def timed(fn, argv):
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="sdn3d_files_") as tmp:
        t0 = time.perf_counter()
        shapenet = write_meshes(os.path.join(tmp, "shapenet"), args.seed)
        root = os.path.join(tmp, "vkitti")
        edit_json, n_pairs = write_chain_root(root, args.seed)
        with open(edit_json) as fh:
            items = json.load(fh)
        geo_json = os.path.join(tmp, "pairs.json")
        with open(geo_json, "w") as fh:
            json.dump(items[:n_pairs], fh)
        ckpt = step_directories(tmp, args.seed)
        log(f"[files] assets, root ({n_pairs} pairs) and step directories "
            f"written in {time.perf_counter() - t0:.1f} s")
        out = {k: os.path.join(tmp, k) for k in (
            "segm", "geo", "bench", "fused", "dump", "segm_b", "geo_b", "tt",
            "geo_c", "gallery")}

        # -- 10a. semantic_test -> geometric_main -> edit_benchmark --------
        _, semantic_s = timed(semantic_test.main, [
            "--test_img", "benchmark", "--edit_json", edit_json,
            "--data_root", root, "--result", out["segm"], "--ckpt_dir",
            ckpt["sem"]])
        geometric_s = geometric("files-10a", [
            "--source", "gt", "--vkitti_root", root, "--edit_json", geo_json,
            "--output_dir", out["geo"]], n_pairs)
        times = os.path.join(tmp, "chain_times.json")
        with open(times, "w") as fh:
            json.dump({"semantic_s": semantic_s, "geometric_s": geometric_s},
                      fh)
        bench, textural_s = timed(edit_benchmark.main, [
            "--edit_json", edit_json, "--data_root", root, "--segm_dir",
            out["segm"], "--geo_dir", out["geo"], "--ckpt_dir", ckpt["tex"],
            "--results_dir", out["bench"], "--chain_times", times])
        fused, fused_s = timed(edit_chain.main, [
            "--edit_json", edit_json, "--data_root", root, "--shapenet_root",
            shapenet, "--dump_dirs", out["dump"], "--results_dir",
            out["fused"], "--semantic_ckpt", ckpt["sem"], "--derender_ckpt",
            ckpt["der"], "--textural_ckpt", ckpt["tex"]])
        pairs = items[:n_pairs]
        sources = sorted({f"{i['world']}_{i['topic']}_{i['source']}.png"
                          for i in pairs})
        same_files(out["segm"], os.path.join(out["dump"], "segm"), sources)
        targets = [f"{i['world']}_{i['topic']}_{i['source']}_{i['target']}"
                   for i in pairs]
        same_files(out["geo"], os.path.join(out["dump"], "geo"),
                   [t + suffix for t in targets
                    for suffix in (".png", "-normal.png", "-depth.png",
                                   ".json")])
        worst = {k: abs(fused[k] - bench[k])
                 for k in ("mean_L1", "mean_SSIM", "mean_PSNR")}
        if not bench["pairs"] == fused["pairs"] == n_pairs \
                or max(worst.values()) > 1e-6 \
                or not np.isfinite(bench["edits_per_sec"]):
            raise AssertionError(f"file chain {bench} against fused "
                                 f"{fused}: {worst}")
        log(f"[files-10a] per-stage chain over {n_pairs} pairs: dumped "
            f"labels ({len(sources)}) and contract files ({4 * n_pairs}) "
            f"byte-equal to the per-stage CLIs'; |metric diff| {worst}")
        log(f"[files-10a] wall s (process-level, models loaded included): "
            f"semantic_test {semantic_s:.3f}, geometric_main "
            f"{geometric_s:.3f}, edit_benchmark {textural_s:.3f} (textural_s "
            f"{bench['textural_s']:.4f}, textural_steady_s_per_pair "
            f"{bench['textural_steady_s_per_pair']:.4f}), edits_per_sec "
            f"{bench['edits_per_sec']:.4f} over the three stages; fused "
            f"edit_chain --dump_dirs {fused_s:.3f} s, steady_s_per_pair "
            f"{fused['steady_s_per_pair']:.4f}, edits_per_sec "
            f"{fused['edits_per_sec']:.4f} ({card})")
        mark("10a. file chain against the fused chain")

        # -- 10b. dataset mode over the test split -> textural_test --------
        rng = np.random.RandomState(args.seed + 2)
        frames = {("0001", "clone", "00360"): car_boxes(rng, 6),
                  ("0001", "clone", "00372"): car_boxes(rng, 9),
                  ("0002", "fog", "00200"): car_boxes(rng, 4)}
        root_b = os.path.join(tmp, "vkitti_test")
        write_vkitti_root(root_b, frames, seed=args.seed)
        names = [f"{w}_{t}_{f}" for w, t, f in sorted(frames)]
        geometric("files-10b", ["--source", "gt", "--vkitti_root", root_b,
                                "--split", "test", "--output_dir",
                                out["geo_b"]], len(frames))
        written = sorted(n[:-4] for n in os.listdir(out["geo_b"])
                         if n.endswith(".pkl"))
        if written != names:
            raise AssertionError(f"--split test wrote {written}, not {names}")
        labels_json = os.path.join(tmp, "test_frames.json")
        with open(labels_json, "w") as fh:
            json.dump([{"world": w, "topic": t, "source": f, "target": f}
                       for w, t, f in sorted(frames)] * 2, fh)
        semantic_test.main(["--test_img", "benchmark", "--edit_json",
                            labels_json, "--data_root", root_b, "--result",
                            out["segm_b"], "--ckpt_dir", ckpt["sem"]])
        l1s, tt_s = timed(textural_test.main, [
            "--data_root", root_b, "--segm_dir", out["segm_b"], "--geo_dir",
            out["geo_b"], "--ckpt_dir", ckpt["tex"], "--results_dir",
            out["tt"]])
        avg = float(np.mean(list(l1s.values())))
        if sorted(l1s) != names or not np.isfinite(avg):
            raise AssertionError(f"textural_test: {l1s}")
        log(f"[files-10b] --split test: {len(names)} frames written; "
            f"textural_test avg L1 {avg:.6f} over {len(l1s)} frames in "
            f"{tt_s:.3f} s ({card})")
        mark("10b. dataset mode, textural_test")

        # -- 10c. the single-frame route -> edit_vkitti --------------------
        src_item = pairs[-1]
        src = VK.rgb_path(root, src_item["world"], src_item["topic"],
                          int(src_item["source"]))
        dets = VK.gt_objects(root, src_item["world"], src_item["topic"],
                             int(src_item["source"]),
                             VK.get_tables("inst", root))
        masks_npz = os.path.join(tmp, "gt.npz")
        np.savez(masks_npz, class_ids=dets[0], masks=dets[1], rois=dets[2])
        src_json = os.path.join(tmp, "source_edits.json")
        with open(src_json, "w") as fh:
            json.dump([i for i in pairs if i["source"] == src_item["source"]
                       and i["topic"] == src_item["topic"]], fh)
        geometric("files-10c", ["--source", "gt", "--input_image", src,
                                "--edit_json", src_json, "--input_masks",
                                masks_npz, "--output_dir", out["geo_c"]], 2)
        crop_times(np.asarray(Image.open(src).convert("RGB")), dets[2],
                   dets[1], dets[0], card)
        segm_src = os.path.join(out["segm"], "{world}_{topic}_{source}.png"
                                .format(**src_item))
        fakes, ev_s = timed(edit_vkitti.main, [
            "--edit_source", src, "--segm_path", segm_src, "--edit_dir",
            out["geo_c"], "--edit_num", "2", "--ckpt_dir", ckpt["tex"],
            "--results_dir", out["gallery"]])
        shape = (CHAIN_SHAPES["fine_height"], CHAIN_SHAPES["fine_width"], 3)
        if len(fakes) != 2 or any(f.shape != shape or not np.isfinite(f).all()
                                  for f in fakes) \
                or not os.path.exists(os.path.join(out["gallery"],
                                                   "index.html")) \
                or len(os.listdir(os.path.join(out["gallery"],
                                               "images"))) != 6:
            raise AssertionError("edit_vkitti: fakes or gallery missing")
        log(f"[files-10c] geometric_main --input_image (stems 00000, 00001) "
            f"-> edit_vkitti --edit_num 2: finite {shape} fakes, gallery "
            f"written, {ev_s:.3f} s ({card})")
        mark("10c. single frame, edit_vkitti")


# 11a: the CLI's iterations at full width; 11b: descent steps on one batch;
# 11e: timed steps a run (after 3 warm-up steps), and the runs of full
# float32 with the deterministic algorithms on and off, in turns
TRAIN_STEPS = 12
DESCENT_STEPS = 30
TIME_STEPS = 10
TIME_TURNS = 4
TRAIN_SHAPES = {"batch_size": 16, "image_size": 256, "render_size": 384}
# 11c: images of the last training step's forward held against the plain
# forward (at 16 x 768^2 the plain forward takes ~60 s; phase 5 holds all
# 16 serving images)
TRAIN_PLAIN_IMAGES = 4
# 11d: the card against the CPU, one step on the small shape, with the
# bounds of tests/test_torch_derender_train.py (port against JAX): losses
# relative (geometry, reprojection), running statistics and the two
# gradient halves against their largest entry, the cosines
SMALL_TRAIN = {"batch_size": 4, "image_size": 64, "render_size": 64}
TRAIN_LOSS_RTOL = (2e-5, 5e-4)
TRAIN_STATS_ATOL = 5e-5
TRAIN_HEAD_ATOL, TRAIN_HEAD_COS = 0.03, 0.999
# the encoder's backward is held to a float64 run of itself on the CPU,
# each parameter's gradient within TRAIN_ENC_ATOL of its largest entry and
# at cosine TRAIN_ENC_COS (the bounds of the CPU tests); at this shape
# (layer-4 batch statistics over 16 values, ReLU kinks) the CPU's own
# float32 gradient is off the float64 one by a few % in the early layers,
# a reading that is printed and bounds nothing
TRAIN_ENC_ATOL, TRAIN_ENC_COS = 2e-3, 0.9999
# 11e: the loader's root: in each world LOADER_TOPICS topics of three
# frames at the start of its train range, six non-overlapping cars a frame
# (18 a topic: write_vkitti_root colours at most 20), so 5 x 5 x 18 = 450
# objects, 28 batches of 16; LOADER_ITERS steps stay inside one loader
# epoch, and the first LOADER_WARM (the pipeline's fill) are reported
# apart from the steady window after them
LOADER_TOPICS = 5
LOADER_ITERS = 24
LOADER_WARM = 4
# the three kernels' device functions, for their share of a step
KERNEL_NAMES = {"B1": ("bin_count_kernel", "bin_scan_kernel",
                       "bin_scatter_kernel", "raster_binned_kernel"),
                "B3": ("walk_faces_kernel",),
                "B2": ("won_box_kernel", "segment_kernel")}
# the card phase 11 trains on (a CPU rehearsal of the phase's control flow
# sets "cpu" and fakes the kernels with their plain versions)
TRAIN_DEVICE = "cuda"
HEAD_KEYS = ("_theta_deltas", "_translation2ds", "_log_scales",
             "_log_depths", "_class_probs", "_ffd_coeffs")


def step_generator(seed: int, it: int, dev):
    from sdn3d_tpu_torch.cli.geometric_train import step_generator as g
    return g(seed, it, dev)


def train_batch(seed: int, dev, shapes=None):
    """A synthetic training batch at `shapes` (TRAIN_SHAPES by default)
    with the CLI's masks."""
    import torch

    from sdn3d_tpu_torch.data.synthetic import (centred_square_masks,
                                                make_derender_batch)
    shapes = shapes or TRAIN_SHAPES
    b = make_derender_batch(shapes["batch_size"], shapes["image_size"], seed)
    b.update(centred_square_masks(shapes["batch_size"],
                                  shapes["render_size"]))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def new_trainer(bank, seed: int, dev, mode: str = "full",
                dtype: str = "float32", shapes=None, **kw):
    """A fresh trainer at `shapes` (TRAIN_SHAPES by default), weights
    drawn from `seed` as the CLI draws them."""
    import torch

    from sdn3d_tpu_torch.models.derenderer import Derenderer, TargetType
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer
    shapes = shapes or TRAIN_SHAPES
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Derenderer(num_classes=8, dtype=dtype)
    return DerenderTrainer(model=model.to(dev), bank=bank,
                           mode=TargetType.BY_NAME[mode],
                           image_size=shapes["image_size"],
                           render_size=shapes["render_size"], **kw)


def close_to(got, want, frac: float, min_cos: float, what: str) -> float:
    """|got - want| <= frac * max|want| and cosine >= min_cos, or fail.
    Returns the max |diff| / max|want|."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / max(scale, 1e-30)
    cos = float((got * want).sum() / (got.norm() * want.norm())) \
        if scale > 0 else 1.0
    if rel > frac or cos < min_cos:
        raise AssertionError(f"{what}: max diff {rel:.3e} of the largest "
                             f"(bound {frac}), cosine {cos:.6f}")
    return rel


def fixed_draws(idx):
    """A select_class returning the given classes and their
    log-probabilities under the caller's class_probs."""
    import torch

    def select(class_probs, generator=None, sample=False):
        i = idx.to(class_probs.device).long()
        logp = torch.log(torch.gather(class_probs, 1, i[:, None])[:, 0]
                         + 1e-20)
        return i.to(torch.int32), logp
    return select


def card_against_cpu(seed: int, card: str) -> None:
    """11d: one train step on the small shape, the card against the CPU
    from the same weights, batch and class draws: the losses, the new
    running statistics, and the gradient in its two halves (the loss's
    gradient in the encoder outputs at the CPU's outputs; the encoder's
    backward of the CPU's cotangent, where a fc1 / fc2 pre-activation
    nearer zero than the two forwards differ is moved onto the CPU's side
    of the ReLU), each within the CPU tests' bounds."""
    import torch

    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models import derenderer as TD

    host = build_mesh_bank([make_sphere_mesh(8, 16)] * 8)
    devs = {"cpu": torch.device("cpu"), "card": torch.device(TRAIN_DEVICE)}
    trainers = {k: new_trainer(TD.DeviceMeshBank.from_host(host, d), seed,
                               d, shapes=SMALL_TRAIN) for k, d in devs.items()}
    sd0 = {k: v.clone() for k, v in trainers["cpu"].model.state_dict().items()}
    batches = {k: train_batch(seed + 5, d, SMALL_TRAIN)
               for k, d in devs.items()}
    mroi, droi = TD.roi_features(batches["cpu"]["roi_norms"])
    cpu_model = trainers["cpu"].model.train()
    pre = {}
    hooks = [getattr(cpu_model, n).register_forward_hook(
        lambda m, i, o, n=n: pre.__setitem__(n, o.detach().clone()))
        for n in ("fc1", "fc2")]
    enc = {k: v.detach() for k, v in cpu_model(
        batches["cpu"]["images"], mroi, droi).items()}
    for h in hooks:
        h.remove()
    cpu_model.load_state_dict(sd0)
    draws, _ = TD.select_class(enc["_class_probs"],
                               torch.Generator().manual_seed(seed), True)
    select = TD.select_class
    TD.select_class = fixed_draws(draws)
    try:
        out = {}
        for key, d in devs.items():
            t = trainers[key]
            t.model.load_state_dict(sd0)
            state = t.init()
            _, losses = t.gradients(state, batches[key], None)
            stats = {k: v.clone() for k, v in t.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            t.model.load_state_dict(sd0)
            # the loss's gradient in the encoder outputs, at the CPU's
            b = batches[key]
            leaves = {k: v.to(d).clone().requires_grad_(True)
                      for k, v in enc.items()}
            m_, d_ = TD.roi_features(b["roi_norms"])
            blob = {"_roi_norms": b["roi_norms"], "_mroi_norms": m_,
                    "_droi_norms": d_, "_focals": b["focals"], **leaves}
            blob.update(TD.render_blob(blob, t.bank, t.mode,
                                       SMALL_TRAIN["image_size"],
                                       SMALL_TRAIN["render_size"],
                                       training=True))
            head = torch.autograd.grad(sum(t.losses(blob, b).values()),
                                       [leaves[k] for k in HEAD_KEYS])
            out[key] = (losses, stats, head)
        cot = out["cpu"][2]
        flips = []
        ref64 = copy.deepcopy(trainers["cpu"].model).double()
        enc_grads = {}
        for key, model, d, dt in (
                ("cpu", trainers["cpu"].model, devs["cpu"], torch.float32),
                ("card", trainers["card"].model, devs["card"],
                 torch.float32),
                ("f64", ref64, devs["cpu"], torch.float64)):
            model.load_state_dict(sd0)
            model.train()

            def align(name):
                def hook(_, __, o):
                    ref = pre[name].to(o.device, o.dtype)
                    flip = (o > 0) != (ref > 0)
                    flips.append((key, name, int(flip.sum()),
                                  float((o.detach() - ref).abs().max())))
                    return o + torch.where(flip, ref - o, 0.0).detach()
                return hook
            hooks = [getattr(model, n).register_forward_hook(align(n))
                     for n in ("fc1", "fc2")]
            b = batches["cpu"]
            e = model(b["images"].to(d, dt),
                      *(x.to(d, dt) for x in TD.roi_features(
                          b["roi_norms"])))
            enc_grads[key] = torch.autograd.grad(
                [e[k] for k in HEAD_KEYS], list(model.parameters()),
                [c.to(d, dt) for c in cot])
            for h in hooks:
                h.remove()
    finally:
        TD.select_class = select
    torch.cuda.synchronize()
    (l_c, s_c, h_c), (l_g, s_g, h_g) = out["cpu"], out["card"]
    worst = {"loss": 0.0, "stats": 0.0, "head": 0.0, "encoder": 0.0}
    for k in l_c:
        rtol = TRAIN_LOSS_RTOL[k in ("mask_loss", "class_reward")]
        rel = abs(float(l_g[k]) - float(l_c[k])) / max(abs(float(l_c[k])),
                                                       1e-30)
        if not rel <= rtol:
            raise AssertionError(f"11d loss {k}: card {float(l_g[k])}, cpu "
                                 f"{float(l_c[k])}")
        worst["loss"] = max(worst["loss"], rel)
    for k in s_c:
        worst["stats"] = max(worst["stats"], close_to(
            s_g[k], s_c[k], TRAIN_STATS_ATOL, 0.0, f"11d {k}"))
    for k, a, b in zip(HEAD_KEYS, h_g, h_c):
        worst["head"] = max(worst["head"], close_to(
            a, b, TRAIN_HEAD_ATOL, TRAIN_HEAD_COS, f"11d d/d{k}"))
    names = [n for n, _ in trainers["cpu"].model.named_parameters()]
    cpu_worst = 0.0
    for n, a, b, r in zip(names, enc_grads["card"], enc_grads["cpu"],
                          enc_grads["f64"]):
        e_cpu = close_to(b, r, float("inf"), -1.0, f"11d cpu {n}")
        cpu_worst = max(cpu_worst, e_cpu)
        worst["encoder"] = max(worst["encoder"], close_to(
            a, r, TRAIN_ENC_ATOL, TRAIN_ENC_COS, f"11d card {n}"))
    if any(n > 2 or band > 2e-4 for _, _, n, band in flips):
        raise AssertionError(f"11d ReLU flips beyond the band: {flips}")
    log(f"[train-11d] card against CPU, one step on {SMALL_TRAIN}: worst "
        f"loss rel {worst['loss']:.3e} (bounds {TRAIN_LOSS_RTOL}), running "
        f"stats {worst['stats']:.3e} (bound {TRAIN_STATS_ATOL}), loss "
        f"gradient in the encoder outputs {worst['head']:.3e} (bound "
        f"{TRAIN_HEAD_ATOL}), encoder gradients against a float64 CPU run "
        f"{worst['encoder']:.3e} (bound {TRAIN_ENC_ATOL}, cosine "
        f"{TRAIN_ENC_COS}; the CPU's float32 {cpu_worst:.3e}); ReLU "
        f"pre-activations moved to the CPU's side "
        f"{[f for f in flips if f[2]]}")


def same_bits_step(trainer, batch, seed: int) -> None:
    """Two runs of one full-width step from the same weights, batch and
    draws give the same bits (losses, weights, running statistics,
    moments), or fail."""
    import torch
    sd0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    runs = []
    for _ in range(2):
        trainer.model.load_state_dict(sd0)
        state = trainer.init()
        state, losses = trainer.train_step(state, batch, step_generator(
            seed, 0, TRAIN_DEVICE))
        torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in
                      state.model.state_dict().items()},
                     state.mu.clone(), state.nu.clone(), losses))
    (a, amu, anu, al), (b, bmu, bnu, bl) = runs
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    bad += [k for k in al if not torch.equal(al[k], bl[k])]
    if bad or not torch.equal(amu, bmu) or not torch.equal(anu, bnu):
        raise AssertionError(f"two runs of a training step differ: {bad}")
    trainer.model.load_state_dict(sd0)


def time_steps(trainer, batch, seed: int, n: int = None):
    """ms a step (CUDA events around each step after 3 warm-up steps;
    median, min, max of n), host wall ms a step (synchronised) and the n
    step times."""
    import torch
    n = n or TIME_STEPS
    state = trainer.init()
    for i in range(3):
        state, _ = trainer.train_step(state, batch,
                                      step_generator(seed, i, TRAIN_DEVICE))
    torch.cuda.synchronize()
    ms = []
    t0 = time.perf_counter()
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = trainer.train_step(state, batch,
                                      step_generator(seed, 3 + i,
                                                     TRAIN_DEVICE))
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    ms = sorted(a.elapsed_time(b) for a, b in ms)
    return ms[len(ms) // 2], ms[0], ms[-1], wall, ms


def loader_root(root: str, seed: int) -> None:
    """A VKITTI root of every world, LOADER_TOPICS topics each, three
    frames a topic at the start of the world's train range, six
    non-overlapping cars a frame (motgt rows that pass
    training_row_filter)."""
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root
    from sdn3d_tpu_torch.data.vkitti import (SCENE_IDS, SPLIT_RANGES,
                                             WORLD_IDS)
    rng = np.random.RandomState(seed + 11)
    frames = {}
    for wi, world in enumerate(WORLD_IDS):
        for topic in SCENE_IDS[:LOADER_TOPICS]:
            for k in range(3):
                boxes = []
                for j in range(6):
                    h = int(rng.randint(40, 100))
                    w = int(h * rng.uniform(1.2, 1.9))
                    y1 = int(rng.randint(150, 375 - h))
                    x1 = 207 * j + int(rng.randint(0, 207 - w))
                    boxes.append((y1, x1, y1 + h, x1 + w))
                first = SPLIT_RANGES["train"][wi][0]
                frames[(world, topic, f"{first + k:05d}")] = boxes
    write_vkitti_root(root, frames, seed=seed)


def training_phase(args, card: str, frames, shapenet: str, tmp: str,
                   mark=lambda what: None) -> tuple:
    """Phase 11: derenderer training at full width (batch 16, image 256,
    render 384 -> 768^2, walk window 64, phase 4's eight 39.6k-face
    meshes).  Returns the kernel launches of 11a's run (B1, B3, B2)."""
    import contextlib
    import io

    import torch

    from sdn3d_tpu_torch.cli import geometric_main, geometric_train
    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import DeviceMeshBank
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.pipelines import derender as TP

    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    inner = (TC.bin_faces_cuda, TC.raster_binned_cuda, TC.won_pixel_boxes_cuda)
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain, TR.edge_invariant_stack,
             TR.face_pixel_coords)

    def reset():
        for fn in kernels + inner:
            fn.launches = 0
        for fn in plain:
            fn.calls = 0

    # -- 11a. the CLI at full width, its last step's kernel inputs kept ----
    seen, last = [], {}
    fwd, walk, seg = TC.rasterize_face_index, TC.walk_grads, \
        TC.segment_face_grads
    step = TP.DerenderTrainer.train_step

    def rec_fwd(faces, face_valid, image_size, near=TR.DEFAULT_NEAR,
                far=TR.DEFAULT_FAR, colors=None):
        last.update(faces=faces, valid=face_valid, size=image_size)
        return fwd(faces, face_valid, image_size, near, far, colors)

    def rec_walk(alpha, grad_alpha, pp, face_index, n_steps, eps):
        last.update(alpha=alpha, cot=grad_alpha, pp=pp, walk=n_steps)
        return walk(alpha, grad_alpha, pp, face_index, n_steps, eps)

    def rec_seg(acc_x, acc_y, face_index, num_faces):
        last.update(acc_x=acc_x, acc_y=acc_y, fi=face_index, F=num_faces)
        return seg(acc_x, acc_y, face_index, num_faces)

    def rec_step(self, state, batch, generator=None):
        state, losses = step(self, state, batch, generator)
        seen.append(losses)
        return state, losses

    ck = os.path.join(tmp, "train_ck")
    S = TRAIN_SHAPES
    argv = ["--mode", "full", "--batch_size", str(S["batch_size"]),
            "--image_size", str(S["image_size"]), "--render_size",
            str(S["render_size"]), "--shapenet_root", shapenet,
            "--num_iters", str(TRAIN_STEPS), "--save_every",
            str(TRAIN_STEPS), "--ckpt_dir", ck, "--seed", str(args.seed),
            "--device", TRAIN_DEVICE]
    TC.rasterize_face_index, TC.walk_grads, TC.segment_face_grads = \
        rec_fwd, rec_walk, rec_seg
    TP.DerenderTrainer.train_step = rec_step
    printed = io.StringIO()
    try:
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            state = geometric_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tuple(fn.launches for fn in kernels)
        inner_counts = tuple(fn.launches for fn in inner)
        plain_calls = tuple(fn.calls for fn in plain)
    finally:
        TC.rasterize_face_index, TC.walk_grads, TC.segment_face_grads = \
            fwd, walk, seg
        TP.DerenderTrainer.train_step = step
    for line in printed.getvalue().splitlines():
        log(f"[train-11a] {line}")
    values = [float(v) for losses in seen for v in losses.values()]
    printed_values = [float(kv.split("=")[1])
                      for line in printed.getvalue().splitlines()
                      if line.startswith("iter ")
                      for kv in line.split(": ", 1)[1].split()]
    if len(seen) != TRAIN_STEPS or not np.isfinite(values).all() \
            or not printed_values or not np.isfinite(printed_values).all():
        raise AssertionError(f"11a: {len(seen)} steps, losses {values}")
    want = (TRAIN_STEPS,) * 3
    if counts != want or inner_counts != want or any(plain_calls) \
            or state.step != TRAIN_STEPS:
        raise AssertionError(f"11a: launches {counts} (bin, raster, box "
                             f"pass {inner_counts}), need {want}; plain "
                             f"calls {plain_calls}")
    if sorted(os.listdir(os.path.join(ck, f"step-{TRAIN_STEPS}"))) != [
            "derenderer.pt", "opt_state.pt", "step.pt"]:
        raise AssertionError("11a: the train-state step is incomplete")
    log(f"[train-11a] geometric_train --mode full {S} on 8 x "
        f"{last['faces'].shape[1]}-face meshes, {TRAIN_STEPS} steps in "
        f"{wall:.2f} s (model build and mesh parse included): every loss "
        f"finite; launches B1 {counts[0]}, B3 {counts[1]}, B2 {counts[2]} "
        f"(bin / raster / box pass {inner_counts}); plain calls (rasterizer, "
        f"walk, reduction, edge_invariant_stack, face_pixel_coords) "
        f"{plain_calls}; step-{TRAIN_STEPS} written ({card})")

    # the trained step served by geometric_main --ckpt_dir
    reset()
    for k, (img, npz, edit, n) in enumerate(frames):
        out_dir = os.path.join(tmp, f"served{k}")
        with contextlib.redirect_stdout(io.StringIO()):
            geometric_main.main([
                "--source", "gt", "--input_image", img, "--input_masks",
                npz, "--edit_json", edit, "--shapenet_root", shapenet,
                "--output_dir", out_dir, "--ckpt_dir", ck, "--device",
                TRAIN_DEVICE])
        check_outputs(out_dir, n)
    torch.cuda.synchronize()
    served = kernels[0].launches
    if served != 2 * len(frames) or any(fn.calls for fn in plain):
        raise AssertionError(f"11a serving: {served} forward launches for "
                             f"{2 * len(frames)} items")
    log(f"[train-11a] geometric_main --ckpt_dir (the trained step) over "
        f"{len(frames)} frames x 2 items: outputs ok, {served} forward "
        f"launches, no plain forward")
    mark("11a. training CLI")

    # -- 11c. the kernels at the last training step's own inputs ------------
    n_img = TRAIN_PLAIN_IMAGES
    err, hits, plain_ms = compare(TC, TR, last["faces"][:n_img].contiguous(),
                                  last["valid"][:n_img].contiguous(),
                                  last["size"], None)
    walk_err = check_walk(TC, TR, last["alpha"], last["cot"], last["pp"],
                          last["fi"], last["walk"], TR.DEFAULT_EPS)
    red_err = check_reduction(TC, TR, last["acc_x"], last["acc_y"],
                              last["fi"], last["F"])
    log(f"[train-11c] last step's forward, {n_img} of "
        f"{last['faces'].shape[0]} images @{last['size']}^2: kernel == "
        f"plain ({hits} covered pixels, plain {plain_ms:.1f} ms); walk "
        f"{tuple(last['alpha'].shape)}, window {last['walk']}: bit-equal "
        f"(both axes); reduction: boxes == won_pixel_boxes, max err vs "
        f"float64 {red_err:.3e}, bit-equal across launches")
    mark("11c. kernels at the training inputs")

    # -- 11b. descent on one fixed full-width batch ---------------------------
    bank = DeviceMeshBank.from_host(load_shapenet_bank(shapenet), TRAIN_DEVICE)
    batch = train_batch(args.seed + 1, TRAIN_DEVICE)
    trainer = new_trainer(bank, args.seed, TRAIN_DEVICE, lr=3e-3,
                          mask_weight=1.0)
    state = trainer.init()
    mask, every = [], []
    for i in range(DESCENT_STEPS):
        state, losses = trainer.train_step(state, batch,
                                           step_generator(args.seed, i,
                                                          TRAIN_DEVICE))
        mask.append(losses["mask_loss"])
        every.extend(losses.values())
    mask = torch.stack(mask).tolist()
    first, lastm = np.mean(mask[:4]), np.mean(mask[-4:])
    if not torch.isfinite(torch.stack(every)).all() or not (
            lastm < 0.85 * first or lastm < 0.75 * max(mask)):
        raise AssertionError(f"11b: the mask loss did not descend: {mask}")
    log(f"[train-11b] {DESCENT_STEPS} steps, lr 3e-3, mask_weight 1.0, one "
        f"batch: mask loss first 4 {first:.6f}, last 4 {lastm:.6f}, peak "
        f"{max(mask):.6f}; every loss finite; trajectory "
        f"{[round(m, 6) for m in mask]}")
    mark("11b. descent")

    # -- 11d. the card against the CPU on the small shape ------------------
    card_against_cpu(args.seed, card)
    mark("11d. card against CPU")

    # -- 11e. timing --------------------------------------------------------
    same_bits_step(new_trainer(bank, args.seed, TRAIN_DEVICE), batch,
                   args.seed)
    log("[train-11e] two runs of a full-width step: the same bits (losses, "
        "weights, running statistics, moments)")
    rows = {}

    def timed(tag, mode="full", dtype="float32"):
        t = new_trainer(bank, args.seed, TRAIN_DEVICE, mode=mode, dtype=dtype)
        rows.setdefault(tag, []).append(time_steps(t, batch, args.seed))

    @contextlib.contextmanager
    def nondeterministic_cudnn():
        # the trainer's step with cuDNN free to pick its algorithms
        c = torch.backends.cudnn
        found = c.deterministic, c.benchmark
        c.deterministic, c.benchmark = False, False
        try:
            yield
        finally:
            c.deterministic, c.benchmark = found

    @contextlib.contextmanager
    def determinism(on: bool):
        ctx = TP.deterministic_cudnn
        if not on:
            TP.deterministic_cudnn = nondeterministic_cudnn
        try:
            yield
        finally:
            TP.deterministic_cudnn = ctx

    off_tag = "full float32, deterministic off"
    for turn in range(TIME_TURNS):
        for on in ((True, False) if turn % 2 == 0 else (False, True)):
            with determinism(on):
                timed("full float32" if on else off_tag)
    timed("full bfloat16", dtype="bfloat16")
    timed("pretrain float32", mode="pretrain")
    for tag, runs in rows.items():
        for med, lo, hi, wall, _ in runs:
            log(f"[train-11e] {tag}: {med:.3f} ms/step median of "
                f"{TIME_STEPS} (min {lo:.3f}, max {hi:.3f}), host wall "
                f"{wall:.3f} ms/step ({card})")
    pooled = {k: sorted(x for r in rows[k] for x in r[4])
              for k in ("full float32", off_tag)}
    busy_det, top = {True: [], False: []}, None
    for on in (True, False, False, True):
        t = new_trainer(bank, args.seed, TRAIN_DEVICE)
        st = t.init()

        def three_steps():
            nonlocal st
            for i in range(3):
                st, _ = t.train_step(st, batch, step_generator(
                    args.seed, i, TRAIN_DEVICE))
            torch.cuda.synchronize()
        with determinism(on):
            three_steps()
            busy, kernels_top = device_time(three_steps, 3)
        busy_det[on].append(busy)
        top = top or kernels_top        # the first run with them on
    med = {k: v[len(v) // 2] for k, v in pooled.items()}
    log(f"[train-11e] deterministic algorithms on / off, {TIME_TURNS} runs "
        f"each in turns: CUDA-event median of the {len(pooled[off_tag])} "
        f"steps {med['full float32']:.3f} / {med[off_tag]:.3f} ms/step "
        f"(on - off {med['full float32'] - med[off_tag]:.3f}); device busy "
        f"{[round(x, 3) for x in busy_det[True]]} / "
        f"{[round(x, 3) for x in busy_det[False]]} ms/step (profiler, in "
        f"turns on, off, off, on) ({card})")
    busy, wall = busy_det[True][0], rows["full float32"][0][3]
    log(f"[train-11e] full float32: device busy {busy:.3f} ms/step, idle "
        f"share {1.0 - busy / wall:.4f} of the host wall {wall:.3f} ms, "
        f"{sum(v[1] for _, v in top) // 3} device launches/step ({card})")
    for name, group in KERNEL_NAMES.items():
        ms = sum(v[0] for k, v in top if any(g in k for g in group))
        log(f"[train-11e] {name} in a step: {ms:.4f} ms")
    elem = [v for k, v in top if "elementwise_kernel" in k]
    log(f"[train-11e] PyTorch elementwise kernels "
        f"{sum(v[0] for v in elem):.4f} ms/step, "
        f"{sum(v[1] for v in elem) // 3} launches/step")
    for name, (ms, count) in top[:12]:
        log(f"[train-11e]   {ms:9.4f} ms/step  {count // 3:4d} launches/step"
            f"  {name[:90]}")

    mark("11e. training times")

    # the prefetch loader on VKITTI items at full width
    from sdn3d_tpu_torch.data import loader as TL
    from sdn3d_tpu_torch.data.select import select_derender_dataset
    from sdn3d_tpu_torch.models.derenderer import TargetType
    root = os.path.join(tmp, "vk_train")
    t0 = time.perf_counter()
    loader_root(root, args.seed)
    write_s = time.perf_counter() - t0
    # one item's cost in the main thread: its two PNG decodes, and the
    # whole item (the decodes, a full-frame mask per object of its frame,
    # the occlusion ignores, the crops)
    ds, _ = select_derender_dataset(
        "vkitti", TargetType.full, vkitti_root=root, is_train=True,
        image_size=S["image_size"], render_size=S["render_size"])
    n_obj, png_ms, item_ms = len(ds), [], []
    if n_obj // S["batch_size"] < LOADER_ITERS:
        raise AssertionError(f"11e loader: {n_obj} objects make fewer than "
                             f"{LOADER_ITERS} batches")
    for i in range(S["batch_size"]):
        world, topic, frame, _ = ds.items[i]
        t0 = time.perf_counter()
        ds.read_scene(world, topic, frame)
        ds.read_rgb(world, topic, frame)
        t1 = time.perf_counter()
        ds[i]
        png_ms.append((t1 - t0) * 1e3)
        item_ms.append((time.perf_counter() - t1) * 1e3)
    png_ms, item_ms = float(np.median(png_ms)), float(np.median(item_ms))
    loaders, stamps, waits = [], [], []
    Loader = TL.PrefetchLoader

    class Recording(Loader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append(self)

    def stamp_step(self, state, batch, generator=None):
        out = step(self, state, batch, generator)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        waits.append(sum(ld.wait_s for ld in loaders))
        return out

    TL.PrefetchLoader, TP.DerenderTrainer.train_step = Recording, stamp_step
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            geometric_train.main([
                "--dataset", "vkitti", "--vkitti_root", root, "--mode",
                "full", "--batch_size", str(S["batch_size"]),
                "--image_size", str(S["image_size"]), "--render_size",
                str(S["render_size"]), "--shapenet_root", shapenet,
                "--num_iters", str(LOADER_ITERS), "--ckpt_dir",
                os.path.join(tmp, "vk_ck"), "--seed", str(args.seed),
                "--device", TRAIN_DEVICE])
    finally:
        TL.PrefetchLoader, TP.DerenderTrainer.train_step = Loader, step
    if len(stamps) != LOADER_ITERS or len(loaders) != 1:
        raise AssertionError(f"11e loader: {len(stamps)} steps, "
                             f"{len(loaders)} loader epochs")
    w = LOADER_WARM
    n = LOADER_ITERS - w
    rate = n / (stamps[-1] - stamps[w - 1])
    wait = (waits[-1] - waits[w - 1]) * 1e3 / n
    fill = (waits[w - 1] - waits[0]) * 1e3
    serial = S["batch_size"] * item_ms
    log(f"[train-11e] --dataset vkitti through the prefetch loader "
        f"(8 workers): {n_obj} objects in one loader epoch, root written in "
        f"{write_s:.2f} s; the fill: first batch waited "
        f"{waits[0] * 1e3:.3f} ms, steps 2-{w} {fill:.3f} ms in all; "
        f"steady, steps {w + 1}-{LOADER_ITERS}: {rate:.3f} steps/s "
        f"(synchronised), wait for a batch {wait:.3f} ms/step mean ({card})")
    log(f"[train-11e] one VKITTI item in the main thread (median of "
        f"{S['batch_size']}): {item_ms:.3f} ms, of which its two PNG decodes "
        f"{png_ms:.3f} ms; a batch serially {serial:.1f} ms, so the steady "
        f"loader made batches at {rate * serial / 1e3:.2f} times one "
        f"thread's rate")
    mark("11e. the loader")
    return counts


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
    t_start = time.perf_counter()

    def mark(what):
        # where the script's time limit goes, phase by phase
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")
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
    # the native host library (data/native.py: scenegt decode, crops), so
    # the measured host path is the native one
    from sdn3d_tpu_torch.data import native
    t0 = time.perf_counter()
    lib = native.build()
    if not native.available():
        raise AssertionError("native host library not loaded")
    log(f"[build] {os.path.relpath(lib, REPO)} built+loaded in "
        f"{time.perf_counter() - t0:.2f} s (g++)")

    mark("2. build")
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

    mark("3. kernels vs plain, small")
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

        mark("4. main path")
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

        mark("4b. refinement path")
        # -- 6. where one frame's time goes (after the counts were read) --
        profile_frame(frames[-1], shapenet, args.seed, card)
        profile_frame(frames[-1], shapenet, args.seed, card,
                      num_opts=NUM_OPTS)
        mark("6. profiles")
        # -- 9. detection as the serving source (9e in the chain phase) ----
        detection_phase(args, card, frames, shapenet, tmp, mark)
        # -- 11. derenderer training at full width ---------------------------
        t_launches = training_phase(args, card, frames, shapenet, tmp, mark)

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

    mark("5. kernels vs plain, main-path shapes")
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

    mark("7. reference")
    # -- 8. chain: the fused edit chain at full width ------------------------
    chain_phase(args, card, mark)
    # -- 10. the per-stage file contract --------------------------------------
    file_contract_phase(args, card, mark)

    kernels = [{
        "name": "rasterize_forward",
        "route": "cuda",
        "source": "sdn3d_tpu_torch/csrc/rasterize.cu",
        "replaces": "sdn3d_tpu/ops/rasterize_pallas.py:662",
        "launches": t_launches[0],    # the training path's (phase 11a)
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
        "launches": t_launches[1],
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
        "launches": t_launches[2],
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
