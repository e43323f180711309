#!/usr/bin/env python3
"""Drive the PyTorch port (sdn3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (any failure exits non-zero):
  1. the card: requires torch.cuda; prints nvidia-smi's name and power limit;
  2. build: compiles the four CUDA kernels (csrc/rasterize.cu,
     silhouette_walk.cu, segment_face_grads.cu, edit_conditioning.cu) from
     source, one nvcc each,
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
     phase 4, the kernel on all 16 slots and the plain version on
     PLAIN_SLOTS of them; the last refine step's backward of 4b): equality
     as in 3, the kernels' and plain versions' times (the forward's on
     those slots alone too), each kernel's bound; for the walk
     its time per backward (one launch, both axes), the hit pixels that
     walk at all, and the same source built without staging
     (global-memory scans), timed in turns with it; for the
     forward the pre-pass, bin and raster times beside the wrapper's, the
     face-tile pairs, the longest tile list and the wide lists; for the
     reduction the box pass's time, box pixels per won pixel, and the time
     of one index_add_ computing the same sums;
  6. profile: one 16-car frame, unrefined and refined (PROFILE_CALLS
     calls each): wall time, device
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
     images and no plain forward, and in every run below one
     conditioning-kernel launch per generate_edit_batch; then the serving
     modes on the same root:
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
     8f. the edit conditioning kernel on the inputs the chain gave it (its
         source tables and frames at 192x624), 1 and 4 frames: every
         output equal to the plain twin's on the CPU, us a launch (CUDA
         events), the twin's ms on the card, the bound by bytes;
     then steady wall per pair of the serial, batched and pipelined chains
     over the edit set in turns (MODE_REPS rounds), with each one's device
     idle share, and uncached and cached pairs apart, serial against
     batched; the per-pair profile (PAIR_PROFILE_CALLS uncached and cached
     walls, device busy, top kernels); the chain's CUDA path against its
     CPU path on small shapes;
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
     stream over the first BATCH_PAIRS pairs;
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
     step's forward (TRAIN_PLAIN_SLOTS of its images), walk and reduction
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
     after LOADER_WARM, and one item's decode against its whole cost;
 12. textural (pix2pixHD) training at TexturalConfig()'s full width (G ngf
     64 with 9 residual blocks, the two-scale D, E, VGG19 to relu5_1) at
     192x624, batch 1, random weights from --seed, no repo kernel on the
     path: 12a. cli/textural_train.main --synthetic (the step written),
     then TEX_DESCENT iterations on one batch (every loss finite, G_L1
     falls); 12b. the iteration's gradients, card float32 against a
     float64 CPU run (small configuration); 12c. two runs of an iteration
     give the same bits; 12d. ms an iteration in float32 and bfloat16
     (CUDA events), device busy, idle share, launches, top kernels, the
     FLOPs (utils/flops), float32 with cuDNN's deterministic
     algorithms on and off in turns, then --use_global_encoder
     --pool_size 4;
     12e. (inside phase 10) the dataset mode (--split test) on 10b's
     files, one item's host cost, and the trained step served by
     textural_test and edit_benchmark.
 13. the semantic trainer and evaluator at the CLI defaults (batch 8,
     crop 256, 14 classes, the full-width dilated ResNet-50 + PPM, random
     weights from --seed; no repo kernel on the path), and geometric_train
     over the KITTI / Cityscapes derender datasets: 13a.
     cli/semantic_train.main --synthetic (the step written), descent on
     one batch, two runs of a step give the same bits, ms a step in
     float32 and bfloat16 (CUDA events), device busy, idle share,
     launches, FLOPs (utils/flops) and peak memory, float32 also
     with the decoder's convolutions on cuDNN; 13b. one step's two
     gradient halves, card float32 within 3x the CPU float32's distance
     to a float64 CPU run, bfloat16 outside it; 13c.
     the dataset mode on a write_vkitti_root root, the step served by
     semantic_test and scored by semantic_eval, ms a frame; 13d.
     cli/geometric_train --dataset kitti in its four modes and
     --dataset cityscapes in full and extend on data/synthetic's roots: B1
     once a rendering step, B3 and B2 once a step with a mask loss, the
     step written.
 14. Mask R-CNN training at MaskRCNNConfig()'s full width (ResNet-101 FPN
     at 1024^2, 6000 -> 2000 proposals, 200 sampled RoIs, 28^2 masks, 3
     classes, batch 1; no repo kernel on the training path): 14a.
     cli/detect_train.main --dataset synthetic with --stage heads, 4+ and
     all and the schedule with --coco_ckpt (phase 9's checkpoint), in
     float32 and bfloat16: every first-step loss finite, the step
     written, the stage's frozen parameters and the running statistics
     bit-unchanged; then geometric_main --maskrcnn_ckpt serving the
     float32 schedule run's step over phase 4's frames (one B1 launch an
     item, no plain forward); 14b. the total loss falls over DT_DESCENT
     steps on one example (stage all, train_bn); 14c. one step's
     gradients at a small configuration by label group, the card in
     float32 within 3x the CPU float32's distance to a float64 CPU run,
     bfloat16 printed; 14d. two runs of a full-width step give the same
     bits; 14e. ms a step of each stage in float32 and bfloat16 (CUDA
     events), device busy, idle share, launches, FLOPs against the card's
     peak (utils/flops), peak memory, and one VKITTI item's host cost.
 15. data parallelism (parallel/mesh.py), in processes of their own (one
     run at world size 1 and one at 2, each running both trainers' steps),
     under cuDNN's deterministic algorithms: 15a. geometric_train's
     step at the JAX CLI's defaults (batch 16, image 256, render 384,
     mode full, synthetic batches) through torchrun --nproc_per_node 1
     (NCCL): B1 / B3 / B2 once a step, ms a step (DDP_STEPS after
     DDP_WARM) beside the same step
     with no process group (this process), the collective calls a step
     and their device kernels' time; 15b. the same step in two ranks on
     the one card over gloo (8 a rank) against 15a's first step: the
     losses, the gradient, the running statistics (the same bits on both
     ranks); 15c. both for semantic_train at its defaults (batch 8, crop
     256).
 16. 16a. render() of the RGB type on 16 slots of phase 4's meshes at
     768^2 with random texture cubes: one B1 launch, no plain forward,
     the RGB of RGB_PLAIN_IMAGES images equal to the plain forward's, the
     texture
     gradient the same bits on two runs, ms forward and with the texture
     gradient; 16b. the face-chunk silhouette gradient against the
     pixelwise one (B3 + B2) on phase 3's 2 x 37 faces at 128^2; 16c. an
     EditSession over a Cityscapes-layout root (a label click, a stroke,
     an object paste, style_forward's 4 previews through the full-width
     generator at 192x624, undo), ms a preview; 16d. the reference's
     library names on the card, at the serving shape (16 slots of phase
     4's meshes, 768^2): Renderer(image_size=768, anti_aliasing=False)'s
     Silhouette forward and backward, one launch each of B1, B3 and B2 and
     no plain version, its silhouette and vertex gradient the same bits as
     render()'s with the same arguments; look_at of the meshes from
     get_points_from_angles and FFD.from_vertices(...)(coeff) within
     NAMES_ATOL of the CPU's; trace() around one render() writes a Chrome
     trace holding B1's kernel.
The line before last is the card's name and power limit, the line before
that the kernels' JSON (launches: phase 11a's training run; the
conditioning kernel's, phase 8's default chain run); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# the card's published peaks by its name (sdn3d_tpu_torch/utils/flops.
# PEAKS; the H100 SXM: 67 TFLOP/s float32 outside the tensor cores, 989
# dense bfloat16, 3.35 TB/s): "float32", "bfloat16" FLOP/s, "hbm" bytes/s;
# main sets them before the first phase
PEAK = {}
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
# phase 5: the slots of the main path's 16 whose forward is held against
# the plain version (~3.6 s an image at 768^2; the kernel runs on all 16)
PLAIN_SLOTS = (0, 5, 10, 15)
# the chain's modes (phase 8): pairs a chunk of the batched and pipelined
# chains, and the planes a pair's outputs are compared by
BATCH_PAIRS = 4
# the modes' steady walls on one stream: rounds of (serial, batched,
# pipelined, pipelined, batched, serial); the per-pair profile's calls of
# each source's pair, uncached and cached; the 16-car frame's profile
# (phase 6) calls
MODE_REPS = 1
PAIR_PROFILE_CALLS = 3
PROFILE_CALLS = 3
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


def compare(TC, TR, faces, valid, isz, colors, slots=None):
    """Kernel vs plain on the same card inputs.  Fails unless face index
    and colours are equal and depth bit-equal.  With `slots`, the kernel
    runs on the whole batch and the plain version on those images only
    (each image is rasterized on its own, so the kernel's rows of those
    images are what the plain version must give).  Returns (max |depth
    diff|, covered pixels, the plain version's ms on the card)."""
    import torch
    got = TC.rasterize_face_index_cuda(faces, valid, isz, colors=colors)
    if slots is not None:
        idx = torch.as_tensor(slots, device=faces.device)
        faces, valid = faces[idx].contiguous(), valid[idx].contiguous()
        colors = None if colors is None else colors[idx].contiguous()
        got = tuple(g[idx] for g in got)
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
    n = PROFILE_CALLS
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
    for name, ms in device_events(prof):
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += ms / n
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
    source); the first call of each phase carries one-time set-up.  A
    counter ({"n"}) is printed with its count and per pair."""
    for name, rec in sorted(saved["phase_breakdown"].items()):
        if "n" in rec:
            log(f"[{tag}] counter {name}: {rec['n']} ({rec['n'] / n_pairs:.3f}"
                f" a pair)")
            continue
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


def device_events(prof):
    """(name, ms) of each device event of a finished torch.profiler run,
    read from its kineto results: the events that prof.events() reports
    on the CUDA device, without building its tree of CPU ops, which took
    ~6 s for 25k kernels on the card's host."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            yield e.name(), e.duration_ns() / 1e6


def device_time(fn, m: int):
    """Run fn under torch.profiler: (device busy ms per unit, [(kernel
    name, (ms per unit, launches))] by time), with `m` units in fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = {}
    for name, ms in device_events(prof):
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += ms / m
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
        f"(GMAC: {top}); bound {2 * total / PEAK['float32'] * 1e3:.3f} ms "
        f"float32, {2 * total / PEAK['bfloat16'] * 1e3:.3f} ms bfloat16")

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
        launches = sum(1 for _ in device_events(prof))
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


def chain_phase(args, card: str, mark=lambda what: None) -> dict:
    """Phase 8: the fused edit chain at full width, its serving modes
    (8a small against full fetch, 8b batched, 8c pipelined, 8d bfloat16,
    8e LPIPS, 8f the conditioning kernel at the chain's own inputs), their
    wall per pair and the chain's CUDA path against its CPU path;
    `mark(step)` logs the time at the end of each step.  Returns the
    conditioning kernel's entry of the kernels' JSON (launches: the
    default chain's run)."""
    import torch

    from sdn3d_tpu_torch.ops import edit_conditioning as EC
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
        # the conditioning kernel's launches and generate_edit_batch calls
        # of each run, and its first inputs at each batch size
        cond_runs, cond_inputs = {}, {}

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

            originals = (EditChain.edit_frame, EditChain._stage_c)
            generate_items, conditioning = (EditChain._generate_items,
                                            EC.edit_conditioning)
            batches = []

            def counted(self, items):
                batches.append(len(items))
                return generate_items(self, items)

            def recording(inst, *rest):
                cond_inputs.setdefault(int(inst.shape[0]), (inst,) + rest)
                return conditioning(inst, *rest)

            EditChain.edit_frame = lambda self, *a, **kw: keep(
                [originals[0](self, *a, **kw)])[0]
            # edit_frames and edit_frames_pipelined end in _stage_c
            EditChain._stage_c = lambda self, b: keep(originals[1](self, b))
            EditChain._generate_items = counted
            EC.edit_conditioning = recording
            TC.rasterize_face_index = shape_recording
            images.clear()
            EC.edit_conditioning_cuda.launches = 0
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
                EditChain.edit_frame, EditChain._stage_c = originals
                EditChain._generate_items = generate_items
                EC.edit_conditioning = conditioning
                TC.rasterize_face_index = dispatch
                phases.reset(False)
            wall = time.perf_counter() - t0
            cond_runs[tag] = (EC.edit_conditioning_cuda.launches,
                              len(batches))
            if cond_runs[tag][0] != len(batches) or not batches:
                raise AssertionError(f"{tag}: conditioning kernel launches "
                                     f"{cond_runs[tag][0]} for "
                                     f"{len(batches)} generate_edit_batch "
                                     f"calls (frames {batches})")
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
            f"face_pixel_coords) {c_plain}; conditioning kernel launches "
            f"{cond_runs['chain_out'][0]} for "
            f"{cond_runs['chain_out'][1]} generate_edit_batch calls; "
            f"small_fetch on")
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
            f"conditioning kernel launches {cond_runs['chain_batched'][0]} "
            f"for {cond_runs['chain_batched'][1]} generate_edit_batch calls, "
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
        # 8f. the conditioning kernel at the chain's own inputs
        cond_kernel = conditioning_kernel(cond_inputs, card)
        cond_kernel["launches"] = cond_runs["chain_out"][0]
        mark("8f. conditioning kernel")
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
        time_chain_modes(chain, requests, card, reps=MODE_REPS)
        mark("8. modes on one stream")
        time_chain_modes(EditChain.build(ChainConfig(), shapenet,
                                         maskrcnn_ckpt=det_ckpt, device="cuda",
                                         seed=args.seed),
                         [dict(r, dets=None)
                          for r in requests[:BATCH_PAIRS]], card,
                         reps=MODE_REPS, tag="chain-9e-modes", split=False)
        mark("9e. maskrcnn modes on one stream")
        profile_chain_pair(chain, requests, card, n=PAIR_PROFILE_CALLS)
        mark("8. pair profile")
        chain_reference(write_meshes(os.path.join(tmp, "shapenet_small"),
                                     args.seed, 20, 40),
                        root, edit_json, args.seed)
        mark("8. chain reference")

    return cond_kernel


def conditioning_kernel(cond_inputs: dict, card: str) -> dict:
    """8f. The edit conditioning kernel (csrc/edit_conditioning.cu) on the
    inputs the chain gave it (its own source tables and edit frames, at
    192x624) at 1 and BATCH_PAIRS frames: every output equal to the plain
    twin's on the CPU (torch.equal), its time a launch (CUDA events) beside
    the twin's on the card, and its bound by bytes.  Returns the kernel's
    entry of the kernels' JSON for the BATCH_PAIRS launch."""
    import torch

    from sdn3d_tpu_torch.ops import edit_conditioning as EC

    entry = None
    for n in (1, BATCH_PAIRS):
        if n not in cond_inputs:
            raise AssertionError(f"8f: the chain gave the conditioning no "
                                 f"batch of {n} (sizes {sorted(cond_inputs)})")
        args = cond_inputs[n]
        inst, codes, M = args[0], args[4], args[5]
        got = EC.edit_conditioning_cuda(*args)
        want = EC.edit_conditioning_plain(
            *[a.cpu() for a in args[:5]], M)
        for field, g, w in zip(got._fields, got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"8f: {n} frames: the kernel's {field} "
                                     f"differs from the plain twin's")
        ms = cuda_ms(lambda: EC.edit_conditioning_cuda(*args), iters=50,
                     warmup=5)
        plain_ms = cuda_ms(lambda: EC.edit_conditioning_plain(*args),
                           iters=10, warmup=2)
        # bytes the conditioning needs: the instance and source label
        # planes read, the label, pose and slot planes written (5 a
        # pixel), the object tables read, the code tables written
        P = inst.shape[1] * inst.shape[2]
        nbytes = n * (5 * P + 2 * EC.TABLE + M * codes.shape[2] * 4)
        bound_ms = nbytes / PEAK["hbm"] * 1e3
        log(f"[chain-8f] conditioning kernel at the chain's inputs, {n} "
            f"frame(s) of {tuple(inst.shape[1:])}: every output equal to "
            f"the plain twin's (ids a frame {got.nids.tolist()}); "
            f"{ms * 1e3:.2f} us a launch, the twin on the card "
            f"{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by bytes "
            f"({nbytes} B) ({card})")
        entry = {
            "name": "edit_conditioning",
            "route": "cuda",
            "source": "sdn3d_tpu_torch/csrc/edit_conditioning.cu",
            "replaces": "host numpy",
            "launches": None,
            "max_abs_err": 0.0,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
        }
    return entry


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


def file_contract_phase(args, card: str, mark=lambda what: None,
                        textural: bool = False) -> None:
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
    against the numpy + PIL path in geo.prep.  With `textural`, then 12e
    (textural_files) on 10b's files and 10a's pairs."""
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
        if textural:
            textural_files(args, card, tmp, root_b, out["segm_b"],
                           out["geo_b"], names, [
                               "--edit_json", edit_json, "--data_root", root,
                               "--segm_dir", out["segm"], "--geo_dir",
                               out["geo"]])
            mark("12e. textural dataset mode, the trained step served")


# 11a: the CLI's iterations at full width; 11b: descent steps on one batch;
# 11e: timed steps a run (after 3 warm-up steps), and the runs of full
# float32 with the deterministic algorithms on and off, in turns
TRAIN_STEPS = 12
DESCENT_STEPS = 30
TIME_STEPS = 10
TIME_TURNS = 4
TRAIN_SHAPES = {"batch_size": 16, "image_size": 256, "render_size": 384}
# 11c: slots of the last training step's forward (the kernel runs on all
# 16) held against the plain forward, ~3.5 s an image at 768^2
TRAIN_PLAIN_SLOTS = (0, 15)
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
    n_img = len(TRAIN_PLAIN_SLOTS)
    err, hits, plain_ms = compare(TC, TR, last["faces"], last["valid"],
                                  last["size"], None, TRAIN_PLAIN_SLOTS)
    walk_err = check_walk(TC, TR, last["alpha"], last["cot"], last["pp"],
                          last["fi"], last["walk"], TR.DEFAULT_EPS)
    red_err = check_reduction(TC, TR, last["acc_x"], last["acc_y"],
                              last["fi"], last["F"])
    log(f"[train-11c] last step's forward of {last['faces'].shape[0]} "
        f"images @{last['size']}^2, {n_img} of them {TRAIN_PLAIN_SLOTS}: "
        f"kernel == plain ({hits} covered pixels, plain {plain_ms:.1f} ms); walk "
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


# phase 12: textural (pix2pixHD) training at TexturalConfig()'s full width,
# 192 x 624, batch 1.  12a: TEX_DESCENT iterations on one fixed synthetic
# batch, G_L1 over the last TEX_WINDOW against the first; 12d: ms an
# iteration (CUDA events after TEX_WARM iterations, median of TEX_TIME),
# TEX_GE_ITERS iterations with the global encoder and a pool of 4;
# 12e: TEX_DATA_ITERS dataset-mode iterations
TEX_SHAPES = {"fine_height": 192, "fine_width": 624}
TEX_DESCENT = 30
TEX_WINDOW = 6
TEX_WARM = 3
TEX_TIME = 10
TEX_CLI_ITERS = 3
TEX_GE_ITERS = 5
TEX_DATA_ITERS = 4
# 12b: the card against a float64 CPU run at the small configuration
# (SMALL_NET_OVERRIDES, VGG on, TEX_SMALL_HW): the bounds of
# tests/test_torch_textural_train.py (port against JAX on the CPU): the
# losses relative; each parameter's gradient within TEX_GRAD_RTOL of the
# larger of its own largest entry and TEX_GRAD_FLOOR times the largest
# gradient of its optimizer (a bias an instance norm follows has a zero
# gradient, rounding noise in both), cosine TEX_GRAD_COS above the floor
TEX_SMALL_HW = (32, 48)
# the card phase 12 trains on (a CPU rehearsal of the phase's control flow
# sets "cpu", with the CLIs' defaults shrunk)
TEX_DEVICE = "cuda"
TEX_LOSS_RTOL = 1e-5
TEX_GRAD_RTOL, TEX_GRAD_FLOOR, TEX_GRAD_COS = 1e-3, 1e-2, 0.99999


def tex_args(ckpt_dir: str, seed: int, **kw):
    """cli/textural_train's arguments at its defaults (full width)."""
    from sdn3d_tpu_torch.cli.textural_train import build_argparser
    argv = ["--ckpt_dir", ckpt_dir, "--seed", str(seed)]
    for k, v in kw.items():
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return build_argparser().parse_args(argv)


def tex_trainer(args):
    """The CLI's trainer and state for `args` (cli/textural_train)."""
    from sdn3d_tpu_torch.cli.textural_train import build_trainer, train_config
    return build_trainer(args, train_config(args))


def tex_batch(args, cfg, seed: int, dev):
    """One synthetic batch of the CLI's, on the card once."""
    from sdn3d_tpu_torch.cli.textural_train import synthetic_batch
    from sdn3d_tpu_torch.utils.transfer import to_device
    return {k: to_device(v, dev) for k, v in synthetic_batch(
        args, np.random.RandomState(seed), cfg).items()}


def clone_fields(x):
    if isinstance(x, dict):
        return {k: clone_fields(v) for k, v in x.items()}
    return x.clone() if hasattr(x, "clone") else x


def same_fields(a, b, path=""):
    """The paths where two field trees differ in a bit."""
    import torch
    if isinstance(a, dict):
        return [p for k in a for p in same_fields(a[k], b[k], f"{path}.{k}")]
    return [] if torch.equal(a, b) else [path]


def tex_iterations(trainer, state, batch, seed: int, n: int, pool=None,
                   first: int = 0):
    """n fused iterations, each with the CLI's generator; returns (state,
    [losses as floats], pool, [ms a step by CUDA events])."""
    import torch

    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    step = trainer.make_train_iteration()
    dev = trainer.device
    out, events = [], []
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, losses, pool = step(state, batch,
                                   step_generator(seed, first + i, dev), pool)
        b.record()
        out.append(losses)
        events.append((a, b))
    torch.cuda.synchronize()
    return (state, [{k: float(v) for k, v in l.items()} for l in out], pool,
            [a.elapsed_time(b) for a, b in events])


def tex_card_against_cpu(seed: int, card: str) -> None:
    """12b: the fused iteration's two halves (the G objective's gradients,
    then D's from the detached fake and the real pair's features) on the
    card in float32 against a float64 CPU run of the same nets and batch,
    at the small configuration; the CPU's own float32 printed beside."""
    import copy

    import torch

    from sdn3d_tpu_torch.pipelines.textural import (
        SMALL_NET_OVERRIDES, TexturalConfig, TexturalState, TexturalTrainer)
    cfg = TexturalConfig(**SMALL_NET_OVERRIDES)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        trainer = TexturalTrainer(cfg)
    base = trainer.to("cpu").init(torch.Generator().manual_seed(seed))
    h, w = TEX_SMALL_HW
    host = tex_batch(SimpleNamespace(fine_height=h, fine_width=w,
                                     batch_size=1), cfg, seed + 7, "cpu")
    runs = {}
    for key, dev, dt in (("f64", "cpu", torch.float64),
                         ("cpu", "cpu", torch.float32),
                         ("card", TEX_DEVICE, torch.float32)):
        nets = {k: copy.deepcopy(getattr(base, k)).to(dev, dt)
                for k in ("netG", "netE", "netD", "vgg")}
        st = TexturalState(step=0, opt_g=None, opt_d=None, **nets)
        b = {k: v.to(dev, dt) if v.is_floating_point() else v.to(dev)
             for k, v in host.items()}
        grads, losses, fake, label, pred_real = trainer.g_gradients(
            st, b, None, keep_real=True)
        grads_d, d_losses = trainer.d_gradients(
            st, torch.cat([label, fake], 1), pred_real=pred_real)
        runs[key] = ({**losses, **d_losses}, grads, grads_d,
                     [n for n, _ in st.g_named()],
                     [n for n, _ in st.d_named()])
    torch.cuda.synchronize()

    def worst(key):
        losses, gg, gd, ng, nd = runs[key]
        ref = runs["f64"]
        loss = max(abs(float(losses[k]) - float(ref[0][k]))
                   / max(abs(float(ref[0][k])), 1e-30) for k in losses)
        grad, low_cos = 0.0, 1.0
        for got, want, names in ((gg, ref[1], ng), (gd, ref[2], nd)):
            top = max(float(x.abs().max()) for x in want)
            for n, g, r in zip(names, got, want):
                g, r = g.double().cpu(), r.double().cpu()
                scale = float(r.abs().max())
                err = float((g - r).abs().max()) / max(
                    scale, TEX_GRAD_FLOOR * top)
                grad = max(grad, err)
                if scale >= TEX_GRAD_FLOOR * top:
                    low_cos = min(low_cos, float(
                        (g * r).sum() / (g.norm() * r.norm())))
        return loss, grad, low_cos
    card_w, cpu_w = worst("card"), worst("cpu")
    if not (card_w[0] <= TEX_LOSS_RTOL and card_w[1] <= TEX_GRAD_RTOL
            and card_w[2] >= TEX_GRAD_COS):
        raise AssertionError(f"12b card against float64: losses {card_w[0]}"
                             f", gradients {card_w[1]}, cosine {card_w[2]}")
    log(f"[tex-12b] card float32 against a float64 CPU run, the small "
        f"configuration at {h}x{w} (VGG on): worst loss rel {card_w[0]:.3e} "
        f"(bound {TEX_LOSS_RTOL}), worst gradient {card_w[1]:.3e} (bound "
        f"{TEX_GRAD_RTOL}, floor {TEX_GRAD_FLOOR}), lowest cosine "
        f"{card_w[2]:.7f} (bound {TEX_GRAD_COS}); the CPU's float32: "
        f"{cpu_w[0]:.3e}, {cpu_w[1]:.3e}, {cpu_w[2]:.7f}")


def tex_determinism_cost(trainer, state, batch, seed: int, card: str):
    """12d: float32 iterations with cuDNN's deterministic algorithms (the
    trainer's) and with cuDNN free to pick its algorithms (autotuning off),
    TEX_WARM + TEX_TIME iterations a run, four runs in turns (on, off, off,
    on); the CUDA-event medians of each side's timed iterations."""
    import contextlib

    import torch

    from sdn3d_tpu_torch.pipelines import textural as TTX

    @contextlib.contextmanager
    def free_cudnn():
        c = torch.backends.cudnn
        found = c.deterministic, c.benchmark
        c.deterministic, c.benchmark = False, False
        try:
            yield
        finally:
            c.deterministic, c.benchmark = found

    runs = {True: [], False: []}
    ctx = TTX.deterministic_cudnn
    for on in (True, False, False, True):
        TTX.deterministic_cudnn = ctx if on else free_cudnn
        try:
            state, _, _, ms = tex_iterations(trainer, state, batch, seed,
                                             TEX_WARM + TEX_TIME)
        finally:
            TTX.deterministic_cudnn = ctx
        runs[on] += ms[TEX_WARM:]
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    log(f"[tex-12d] float32 with cuDNN's deterministic algorithms on / off "
        f"(4 runs in turns, {TEX_TIME} timed iterations each): CUDA-event "
        f"medians {med[True]:.3f} / {med[False]:.3f} ms an iteration (on - "
        f"off {med[True] - med[False]:.3f}) ({card})")
    return state


def textural_phase(args, card: str, mark=lambda what: None) -> None:
    """Phase 12: textural training at TexturalConfig()'s full width (G ngf
    64, 4 downsamplings, 9 blocks; D ndf 64, 2 scales, 3 layers; E nef 16;
    VGG19 to relu5_1) at 192 x 624, batch 1, random weights from --seed.
    12a: cli/textural_train.main --synthetic for TEX_CLI_ITERS iterations
    (the step written), then TEX_DESCENT iterations of the CLI's trainer on
    one fixed batch: every loss finite, G_L1 over the last TEX_WINDOW below
    the first; 12b: the card against a float64 CPU run (small
    configuration); 12c: two runs of an iteration give the same bits; 12d:
    ms an iteration in float32 and bfloat16, device busy, idle share,
    launches and the top kernels, the FLOPs an iteration, float32 with
    cuDNN's deterministic algorithms on and off in turns, then
    TEX_GE_ITERS iterations with the global encoder and a pool of 4.
    12e runs inside the file-contract phase (textural_files)."""
    import torch

    from sdn3d_tpu_torch.cli import textural_train
    from sdn3d_tpu_torch.utils import flops as FL
    from sdn3d_tpu_torch.core.checkpoint import latest_step

    dev = torch.device(TEX_DEVICE)
    shape = f"{TEX_SHAPES['fine_height']}x{TEX_SHAPES['fine_width']}"
    with tempfile.TemporaryDirectory(prefix="sdn3d_tex_") as tmp:
        # -- 12a. the CLI, then descent on one batch ------------------------
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        _, state = textural_train.main([
            "--synthetic", "--num_iters", str(TEX_CLI_ITERS), "--ckpt_dir",
            ck, "--seed", str(args.seed)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(ck, f"step-{TEX_CLI_ITERS}")))
        if latest_step(ck) != TEX_CLI_ITERS or state.step != TEX_CLI_ITERS \
                or files != ["netD.pt", "netE.pt", "netG.pt", "opt_d.pt",
                             "opt_g.pt", "step.pt", "vgg.pt"]:
            raise AssertionError(f"12a textural_train: step {latest_step(ck)}"
                                 f", files {files}")
        del state
        log(f"[tex-12a] textural_train --synthetic at the CLI defaults "
            f"({shape}, batch 1): {TEX_CLI_ITERS} iterations, step "
            f"written ({', '.join(files)}) in {cli_s:.2f} s (models built "
            f"and saved included) ({card})")
        targs = tex_args(os.path.join(tmp, "none"), args.seed)
        trainer, state = tex_trainer(targs)
        cfg = trainer.cfg
        batch = tex_batch(targs, cfg, args.seed, dev)
        fields0 = clone_fields(state.fields())
        state, losses, _, _ = tex_iterations(trainer, state, batch,
                                             args.seed, TEX_DESCENT)
        l1 = np.asarray([l["G_L1"] for l in losses])
        finite = all(np.isfinite(v) for l in losses for v in l.values())
        first, last = l1[:TEX_WINDOW].mean(), l1[-TEX_WINDOW:].mean()
        if not finite or not last < first:
            raise AssertionError(f"12a descent: finite {finite}, G_L1 "
                                 f"{l1.tolist()}")
        log(f"[tex-12a] {TEX_DESCENT} iterations on one batch: every loss "
            f"finite; G_L1 first / last {TEX_WINDOW} {first:.6f} -> "
            f"{last:.6f}; iteration 0 {losses[0]}; iteration "
            f"{TEX_DESCENT - 1} {losses[-1]}")
        mark("12a. textural CLI and descent")

        # -- 12b. card against CPU float64 ------------------------------------
        tex_card_against_cpu(args.seed, card)
        mark("12b. textural card against CPU")

        # -- 12c. the same bits, run to run -------------------------------------
        runs = []
        for _ in range(2):
            state.load_fields(fields0)
            state, losses, _, _ = tex_iterations(trainer, state, batch,
                                                 args.seed, 1)
            runs.append((clone_fields(state.fields()), losses[0]))
        bad = same_fields(runs[0][0], runs[1][0])
        if bad or runs[0][1] != runs[1][1]:
            raise AssertionError(f"12c: two runs of an iteration differ: "
                                 f"{bad[:8]}, {runs[0][1]} / {runs[1][1]}")
        log(f"[tex-12c] two runs of a full-width iteration from the same "
            f"state, batch and draws: every net, Adam's moments and counts "
            f"and the losses bit-equal")
        del runs
        mark("12c. textural same bits")

        # -- 12d. times -----------------------------------------------------------
        state.load_fields(fields0)
        out = []
        flops, top_ops = FL.count_flops(lambda: out.append(tex_iterations(
            trainer, state, batch, args.seed, 1)), top=6)
        state = out[0][0]
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16":
                del trainer, state
                torch.cuda.empty_cache()
                trainer, state = tex_trainer(tex_args(
                    os.path.join(tmp, "none"), args.seed,
                    compute_dtype="bfloat16"))
            state, _, _, _ = tex_iterations(trainer, state, batch, args.seed,
                                            TEX_WARM)
            t0 = time.perf_counter()
            state, losses, _, ms = tex_iterations(
                trainer, state, batch, args.seed, TEX_TIME, first=TEX_WARM)
            wall = (time.perf_counter() - t0) * 1e3 / TEX_TIME
            ms = sorted(ms)
            busy, kernels = device_time(lambda: tex_iterations(
                trainer, state, batch, args.seed, 2), 2)
            launches = sum(v[1] for _, v in kernels) / 2
            conv = sum(v[0] for k, v in kernels if any(
                w in k.lower() for w in ("conv", "cudnn", "xmma", "gemm",
                                         "gemv", "fft")))
            bound = FL.mfu_row(flops, None, ms[len(ms) // 2] / 1e3,
                               dtype=dtype, peaks=PEAK)["floor_ms"]
            log(f"[tex-12d] {dtype} iteration at {shape}, batch 1: "
                f"{ms[len(ms) // 2]:.3f} ms (median of {TEX_TIME} after "
                f"{TEX_WARM}, CUDA events; min {ms[0]:.3f}, max "
                f"{ms[-1]:.3f}), host wall {wall:.3f} ms an iteration "
                f"(synchronised at the end); device busy {busy:.3f} ms, idle "
                f"share {1 - busy / wall:.4f}; {launches:.0f} launches an "
                f"iteration; convolution kernels (cuDNN, FFT, GEMM / GEMV) "
                f"{conv:.3f} ms; "
                f"{flops:.4e} FLOP an iteration (utils/flops, float32 "
                f"run), floor {bound:.3f} ms at the card's peak for "
                f"{dtype}; finite losses "
                f"{all(np.isfinite(v) for v in losses[-1].values())} "
                f"({card})")
            log(f"[tex-12d] {dtype} top kernels (ms an iteration, launches "
                f"over 2): " + "; ".join(
                    f"{k[:70]} {v[0]:.3f} ({v[1]})" for k, v in kernels[:8]))
            if dtype == "float32":
                state = tex_determinism_cost(trainer, state, batch,
                                             args.seed, card)
        log(f"[tex-12d] FLOPs by op (one float32 iteration): "
            + "; ".join(f"{k} {v:.3e}" for k, v in top_ops))
        del trainer, state
        torch.cuda.empty_cache()
        trainer, state = tex_trainer(tex_args(
            os.path.join(tmp, "none"), args.seed, use_global_encoder=True,
            pool_size=4))
        pool = trainer.device_pool(TEX_SHAPES["fine_height"],
                                   TEX_SHAPES["fine_width"])
        state, losses, pool, ms = tex_iterations(trainer, state, batch,
                                                 args.seed, TEX_GE_ITERS,
                                                 pool=pool)
        if pool.n != 4 or not all("E_VAE" in l and np.isfinite(
                list(l.values())).all() for l in losses):
            raise AssertionError(f"12d global encoder + pool: pool "
                                 f"{pool.n}, losses {losses}")
        log(f"[tex-12d] --use_global_encoder --pool_size 4: {TEX_GE_ITERS} "
            f"iterations, every loss finite (E_VAE {losses[-1]['E_VAE']:.4g}"
            f"), pool filled to {pool.n}; last {TEX_GE_ITERS - 2} "
            f"iterations {sorted(ms[2:])} ms ({card})")
        del trainer, state, pool
        torch.cuda.empty_cache()
        mark("12d. textural times")


def textural_files(args, card: str, tmp: str, root: str, segm: str,
                   geo: str, names, bench_argv) -> None:
    """12e: cli/textural_train in dataset mode (--split test) on the files
    of phase 10b (semantic_test's labels, geometric_main's instance maps,
    JSON, normals and depths, linked into the dataset's world/topic/frame
    layout) for TEX_DATA_ITERS iterations; one item's host cost; the step
    then served by cli/textural_test over the same frames and by
    cli/edit_benchmark --ckpt_dir over phase 10a's pairs."""
    import torch

    from sdn3d_tpu_torch.cli import edit_benchmark, textural_test, \
        textural_train
    from sdn3d_tpu_torch.data.textural_data import TexturalVKittiDataset

    nested = {k: os.path.join(tmp, f"tex_{k}") for k in ("segm", "geo")}
    for name in names:
        world, topic, frame = name.split("_")
        for key, src, suffixes in (
                ("segm", segm, (".png",)),
                ("geo", geo, (".png", ".json", "-normal.png",
                              "-depth.png"))):
            d = os.path.join(nested[key], world, topic)
            os.makedirs(d, exist_ok=True)
            for suf in suffixes:
                if os.path.exists(os.path.join(src, name + suf)):
                    os.symlink(os.path.join(src, name + suf),
                               os.path.join(d, frame + suf))
    ck = os.path.join(tmp, "ck_tex_trained")
    t0 = time.perf_counter()
    _, state = textural_train.main([
        "--data_root", root, "--segm_dir", nested["segm"], "--geo_dir",
        nested["geo"], "--split", "test", "--num_iters", str(TEX_DATA_ITERS),
        "--ckpt_dir", ck, "--seed", str(args.seed)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if state.step != TEX_DATA_ITERS:
        raise AssertionError(f"12e: dataset-mode step {state.step}")
    del state
    torch.cuda.empty_cache()
    ds = TexturalVKittiDataset(root, nested["segm"], nested["geo"],
                               split="test", max_instances=64)
    item_ms = []
    for i in range(6):
        t1 = time.perf_counter()
        item = ds.__getitem__(i % len(ds), np.random.RandomState(i))
        item_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"[tex-12e] textural_train --split test over {len(ds)} frames of "
        f"phase 10b (with depth: {ds.with_depth}): {TEX_DATA_ITERS} "
        f"iterations in {train_s:.2f} s (models built and saved included); "
        f"one item {np.median(item_ms):.3f} ms on the host (median of 6; "
        f"image {item['image'].shape}) ({card})")
    l1s = textural_test.main(["--data_root", root, "--segm_dir", segm,
                              "--geo_dir", geo, "--ckpt_dir", ck,
                              "--results_dir", os.path.join(tmp, "tt_tex")])
    avg = float(np.mean(list(l1s.values())))
    if sorted(l1s) != sorted(names) or not np.isfinite(avg):
        raise AssertionError(f"12e textural_test of the trained step: {l1s}")
    bench = edit_benchmark.main(bench_argv + ["--ckpt_dir", ck,
                                              "--results_dir",
                                              os.path.join(tmp, "bench_tex")])
    if not np.isfinite([bench["mean_L1"], bench["mean_SSIM"],
                        bench["mean_PSNR"]]).all():
        raise AssertionError(f"12e edit_benchmark of the trained step: "
                             f"{bench}")
    log(f"[tex-12e] the trained step served: textural_test avg L1 "
        f"{avg:.6f} over {len(l1s)} frames; edit_benchmark --ckpt_dir "
        f"{bench['pairs']} pairs, mean L1 {bench['mean_L1']:.6f}, SSIM "
        f"{bench['mean_SSIM']:.6f}, PSNR {bench['mean_PSNR']:.4f} ({card})")


# phase 13: the semantic trainer and evaluator at the CLI defaults (batch 8,
# crop 256, 14 classes, the full-width dilated ResNet-50 + PPM), random
# weights from --seed, no repo kernel on the path; and geometric_train over
# the KITTI / Cityscapes derender datasets, which runs B1, B3 and B2.
# 13a: SEM_CLI_ITERS steps through cli/semantic_train.main, SEM_DESCENT
# steps on one batch (the loss over the last SEM_WINDOW below
# SEM_DESCENT_FACTOR times the first's), two runs of a step, ms a step
# (CUDA events, median of SEM_TIME after SEM_WARM) in float32 (also with
# the decoder's convolutions on cuDNN) and bfloat16; 13c: SEM_DATA_ITERS
# steps in the dataset mode, then semantic_test and semantic_eval
# (SEM_EVAL_FRAMES test frames); 13d: GEO_DATA_ITERS steps of each
# (dataset, mode) row
SEM_CLI_ITERS = 2
SEM_DESCENT = 30
SEM_WINDOW = 3
SEM_DESCENT_FACTOR = 0.9
SEM_WARM = 3
SEM_TIME = 10
SEM_DATA_ITERS = 3
SEM_EVAL_FRAMES = 2
GEO_DATA_ITERS = 4
GEO_BATCH = 1            # the writer roots hold 1-4 objects a dataset
GEO_RUNS = (("kitti", "pretrain"), ("kitti", "extend"), ("kitti", "finetune"),
            ("kitti", "full"), ("cityscapes", "full"),
            ("cityscapes", "extend"))
# 13b: one step at SEM_SMALL, card float32 against a float64 CPU run from
# identical inputs and dropout masks: the loss within SEM_LOSS_RTOL; each
# half's gradients (decoder from the float64 run's features, encoder as
# the VJP of its cotangent) as one vector, its largest error relative to
# its largest entry and 1 - its cosine each within SEM_CPU_FACTOR times the
# CPU float32 run's.  The random-init ResNet-50's train-mode BatchNorm
# magnifies float32 rounding: the CPU's float32 sits 2.3e-2 / cosine
# 0.99968 off float64 in the encoder half, 5.0e-4 / 0.999999997 in the
# decoder half.  The same halves with the convolutions in bfloat16 must
# fall outside these bounds (the bound's own check).  The lowest cosine of
# a parameter whose largest entry reaches SEM_GRAD_FLOOR of its half's,
# the card with cuDNN off throughout and the card with the decoder's
# convolutions on cuDNN (3.4e-2 off in the decoder half) are printed, not
# bounded
SEM_SMALL = {"batch_size": 2, "crop_size": 64}
SEM_LOSS_RTOL = 1e-4
SEM_CPU_FACTOR = 3.0
SEM_GRAD_FLOOR = 1e-2
# the card phase 13 trains on (a CPU rehearsal of the phase's control flow
# sets "cpu", with the CLIs' defaults shrunk)
SEM_DEVICE = "cuda"


def sem_args(ckpt_dir: str, seed: int, **kw):
    """cli/semantic_train's arguments at its defaults (full width)."""
    from sdn3d_tpu_torch.cli.semantic_train import build_argparser
    argv = ["--ckpt_dir", ckpt_dir, "--seed", str(seed), "--device",
            SEM_DEVICE]
    for k, v in kw.items():
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return build_argparser().parse_args(argv)


def sem_batch(args, seed: int, dev):
    """One synthetic batch of the CLI's, on the device once."""
    from sdn3d_tpu_torch.cli.semantic_train import synthetic_batches, to_batch
    return to_batch(*next(synthetic_batches(args, np.random.RandomState(
        seed))), dev)


def sem_steps(trainer, state, batch, seed: int, n: int, first: int = 0):
    """n train steps on one batch, each with the CLI's dropout generator;
    returns (state, [losses], [ms a step by CUDA events])."""
    import torch

    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    dev = batch[0].device
    out, events = [], []
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = trainer.train_step(
            state, *batch, step_generator(seed, first + i, dev))
        b.record()
        out.append(metrics["loss"])
        events.append((a, b))
    torch.cuda.synchronize()
    return (state, [float(l) for l in out],
            [a.elapsed_time(b) for a, b in events])


@contextlib.contextmanager
def decoder_on_cudnn():
    """The semantic decoders' convolutions on cuDNN, as Conv2d computes
    them, in place of their float32 training route on the card
    (models/semantic.DecoderConv2d): 13a's and 13b's comparison."""
    from sdn3d_tpu_torch.models.layers import Conv2d
    from sdn3d_tpu_torch.models.semantic import DecoderConv2d
    route = DecoderConv2d.forward
    DecoderConv2d.forward = Conv2d.forward
    try:
        yield
    finally:
        DecoderConv2d.forward = route


def sem_halves(model, images, labels, masks, dev, dtype, feats=None,
               cot=None, compute="float32"):
    """One training forward of `model` (a copy, on dev in dtype, its
    convolutions computing in `compute`) in two halves: the decoder's loss
    and gradients from `feats` (or the encoder's own features), then the
    encoder's VJP of `cot` (or of the decoder's cotangent).  Returns
    (loss, decoder grads, encoder grads, features, cotangent), the last
    two in float64 on the CPU."""
    import torch

    from sdn3d_tpu_torch.models.layers import set_compute_dtype
    from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn
    from sdn3d_tpu_torch.pipelines.semantic import SemanticTrainer
    m = copy.deepcopy(model).to(dev, dtype).train()
    set_compute_dtype(m, compute)
    with deterministic_cudnn():
        out = m.encoder.stages(images.to(dev, dtype))[1:]
        src = out if feats is None else [f.to(dev, dtype) for f in feats]
        conv = [f.detach().requires_grad_(True) for f in src]
        loss, _ = SemanticTrainer(m).objective(
            m.decoder(conv, dropout=[k.to(dev) for k in masks]),
            labels.to(dev))
        g = torch.autograd.grad(loss, list(m.decoder.parameters()) + conv,
                                allow_unused=True)
        n = len(list(m.decoder.parameters()))
        g_dec = g[:n]
        g_conv = [torch.zeros_like(c) if x is None else x
                  for c, x in zip(conv, g[n:])]
        cot = g_conv if cot is None else [c.to(dev, dtype) for c in cot]
        g_enc = torch.autograd.grad(out, list(m.encoder.parameters()),
                                    grad_outputs=cot)
    return (float(loss.detach()), g_dec, g_enc,
            [f.detach().double().cpu() for f in src],
            [c.detach().double().cpu() for c in g_conv])


def half_errors(got, want):
    """(largest error relative to the largest entry, cosine) of a half's
    gradients, all parameters as one vector, against a float64 list; and
    the lowest cosine of a parameter whose largest entry reaches
    SEM_GRAD_FLOOR of the half's."""
    import torch
    g = torch.cat([x.double().cpu().reshape(-1) for x in got])
    w = torch.cat([x.reshape(-1) for x in want])
    top = float(w.abs().max())
    low = 1.0
    for a, b in zip(got, want):
        a = a.double().cpu()
        if float(b.abs().max()) >= SEM_GRAD_FLOOR * top:
            low = min(low, float((a * b).sum() / (a.norm() * b.norm())))
    return (float((g - w).abs().max()) / top,
            float((g * w).sum() / (g.norm() * w.norm())), low)


def conv_last_routes(model, feats, seed: int, card: str) -> None:
    """The PPM's conv_last.0 (4096 -> 512, 3x3) on the card in float32 by
    route, cuDNN (Conv2d) and the decoders' training route
    (models/semantic._GemmConv): the forward and the weight gradient (of
    a random cotangent) against float64 on the CPU at 13b's input (the
    float64 run's features through the PPM's branches), largest error
    relative to the largest entry; and ms of each route's forward and
    weight gradient at 13a's shapes (batch 8, 32 x 32; CUDA events)."""
    import torch
    import torch.nn.functional as F

    from sdn3d_tpu_torch.models.semantic import _GemmConv, resize_bilinear
    from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn
    dec = copy.deepcopy(model.decoder).double().train()
    c5 = feats[-1]
    with torch.no_grad():
        x = torch.cat([c5] + [resize_bilinear(b(c5), c5.shape[2:])
                              for b in dec.ppm], 1)
    w = dec.conv_last[0].weight.detach()
    g = torch.randn(x.shape[0], w.shape[0], *x.shape[2:], dtype=x.dtype,
                    generator=torch.Generator().manual_seed(seed))
    w64 = w.clone().requires_grad_(True)
    want = F.conv2d(x, w64, padding=1)
    want_gw = torch.autograd.grad(want, w64, g)[0]
    want = want.detach()
    dev = torch.device(SEM_DEVICE)

    def routes(x, w):
        return {"cuDNN": lambda: F.conv2d(x, w, padding=1),
                "GEMM": lambda: _GemmConv.apply(
                    x, w, ((1, 1), (1, 1), (1, 1), 1))}
    errs = {}
    xc = x.to(dev, torch.float32)
    wc = w.to(dev, torch.float32).requires_grad_(True)
    with deterministic_cudnn():
        for key, fn in routes(xc, wc).items():
            y = fn()
            gw = torch.autograd.grad(y, wc, g.to(dev, torch.float32))[0]
            errs[key] = [float((a.double().cpu() - b).abs().max()
                               / b.abs().max())
                         for a, b in ((y, want), (gw, want_gw))]
        xb = torch.randn(8, x.shape[1], 32, 32, device=dev)
        wb = torch.randn(w.shape, device=dev, requires_grad=True) * 1e-2
        ms = {}
        for key, fn in routes(xb, wb).items():
            y = fn()
            gb = torch.randn_like(y)
            ms[key] = (cuda_ms(fn, 5, 2), cuda_ms(lambda: torch.autograd.grad(
                y, wb, gb, retain_graph=True), 5, 2))
    log("[sem-13b] conv_last.0 (4096 -> 512, 3x3) float32 by route: "
        + "; ".join(f"{k}: forward {errs[k][0]:.3e}, weight gradient "
                    f"{errs[k][1]:.3e} off float64 at {tuple(x.shape)}; "
                    f"{ms[k][0]:.3f} / {ms[k][1]:.3f} ms forward / weight "
                    f"gradient at batch 8, 32x32" for k in errs)
        + f" ({card})")


def sem_card_against_cpu(seed: int, card: str) -> None:
    """13b: one training forward and backward at SEM_SMALL, in two halves
    from identical inputs and dropout masks, on the card in float32 and on
    the CPU in float64 (and float32, the bound's measure); the card in
    bfloat16 must fall outside the bound; the card with cuDNN off, and
    with the decoder's convolutions on cuDNN, printed beside."""
    import torch

    from sdn3d_tpu_torch.models.semantic import SemanticModel
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SemanticModel(num_class=14)
    B, S = SEM_SMALL["batch_size"], SEM_SMALL["crop_size"]
    rs = np.random.RandomState(seed + 11)
    images = torch.from_numpy(rs.rand(B, 3, S, S).astype(np.float32))
    labels = torch.from_numpy(rs.randint(-1, 14, (B, S // 8, S // 8)))
    g = torch.Generator().manual_seed(seed)
    masks = [torch.rand(B, 512, S // 8, S // 8, generator=g) < 0.9
             for _ in range(2)]
    ref = sem_halves(model, images, labels, masks, "cpu", torch.float64)
    conv_last_routes(model, ref[3], seed, card)
    given = dict(feats=ref[3], cot=ref[4])
    runs = {key: sem_halves(model, images, labels, masks, dev, torch.float32,
                            compute=compute, **given)
            for key, dev, compute in (("card", SEM_DEVICE, "float32"),
                                      ("cpu", "cpu", "float32"),
                                      ("bfloat16", SEM_DEVICE, "bfloat16"))}
    with torch.backends.cudnn.flags(enabled=False):
        runs["native"] = sem_halves(model, images, labels, masks, SEM_DEVICE,
                                    torch.float32, **given)
    with decoder_on_cudnn():
        runs["cudnn"] = sem_halves(model, images, labels, masks, SEM_DEVICE,
                                   torch.float32, **given)
    res = {}
    for key, (loss, g_dec, g_enc, _, _) in runs.items():
        res[key] = (abs(loss - ref[0]) / abs(ref[0]),
                    half_errors(g_dec, ref[1]), half_errors(g_enc, ref[2]))
    cpu = res["cpu"]

    def within(r, h):
        # half h of reading r within SEM_CPU_FACTOR x the CPU float32's
        return (r[h][0] <= SEM_CPU_FACTOR * cpu[h][0]
                and 1 - r[h][1] <= SEM_CPU_FACTOR * (1 - cpu[h][1]))
    c = res["card"]
    if not (c[0] <= SEM_LOSS_RTOL and within(c, 1) and within(c, 2)):
        raise AssertionError(f"13b card against float64: {c}; the CPU's "
                             f"float32: {cpu}")
    if within(res["bfloat16"], 1) or within(res["bfloat16"], 2):
        raise AssertionError(f"13b: a bfloat16 half passes the bound: "
                             f"{res['bfloat16']}; the CPU's float32: {cpu}")

    def fmt(r):
        return (f"loss rel {r[0]:.3e}; decoder half {r[1][0]:.3e} / cosine "
                f"{r[1][1]:.9f} (lowest parameter {r[1][2]:.7f}); encoder "
                f"half {r[2][0]:.3e} / {r[2][1]:.9f} (lowest parameter "
                f"{r[2][2]:.7f})")
    log(f"[sem-13b] card float32 against a float64 CPU run at {B}x{S}x{S} "
        f"(full width, identical inputs and masks; each half's gradients as "
        f"one vector, error relative to its largest entry): {fmt(c)} "
        f"(bounds: loss {SEM_LOSS_RTOL}; each half within {SEM_CPU_FACTOR}x "
        f"the CPU float32's error and 1 - cosine); the CPU's float32: "
        f"{fmt(cpu)}; the card in bfloat16 (outside the bound in both "
        f"halves): {fmt(res['bfloat16'])}; not bounded: the card with "
        f"cuDNN off {fmt(res['native'])}; the card with the decoder's "
        f"convolutions on cuDNN {fmt(res['cudnn'])} ({card})")


def sem_times(args, seed: int, card: str, tmp: str) -> None:
    """13a's times: a float32 step's FLOPs, then per dtype ms a step
    (CUDA events), host wall, device busy and idle share, launches a
    step, the top kernels and peak memory; float32 also with the
    decoder's convolutions on cuDNN (decoder_on_cudnn)."""
    flops = top_ops = None
    for dtype, route in (("float32", contextlib.nullcontext),
                         ("float32", decoder_on_cudnn),
                         ("bfloat16", contextlib.nullcontext)):
        with route():
            flops, top_ops = sem_time(seed, card, tmp, dtype, flops,
                                      top_ops, route is decoder_on_cudnn)
    log("[sem-13a] FLOPs by op (one float32 step): "
        + "; ".join(f"{k} {v:.3e}" for k, v in top_ops))


def sem_time(seed: int, card: str, tmp: str, dtype: str, flops, top_ops,
             on_cudnn: bool):
    """One of 13a's timed variants; counts a step's FLOPs when `flops` is
    None.  Returns (flops, top_ops)."""
    import torch

    from sdn3d_tpu_torch.cli.semantic_train import build_trainer
    from sdn3d_tpu_torch.utils import flops as FL
    targs = sem_args(os.path.join(tmp, "none"), seed,
                     compute_dtype=dtype)
    trainer = build_trainer(targs)
    state = trainer.init()
    batch = sem_batch(targs, seed, targs.device)
    if flops is None:
        out = []
        flops, top_ops = FL.count_flops(lambda: out.append(sem_steps(
            trainer, state, batch, seed, 1)))
        state = out[0][0]
    state, _, _ = sem_steps(trainer, state, batch, seed, SEM_WARM)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses, ms = sem_steps(trainer, state, batch, seed, SEM_TIME,
                                  first=SEM_WARM)
    wall = (time.perf_counter() - t0) * 1e3 / SEM_TIME
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sorted(ms)
    busy, kernels = device_time(lambda: sem_steps(
        trainer, state, batch, seed, 2), 2)
    launches = sum(v[1] for _, v in kernels) / 2
    conv = sum(v[0] for k, v in kernels if any(
        w in k.lower() for w in ("conv", "cudnn", "xmma", "gemm",
                                 "gemv", "fft")))
    med = ms[len(ms) // 2]
    row = FL.mfu_row(flops, None, med / 1e3, dtype=dtype, peaks=PEAK)
    what = dtype + (", the decoder's convolutions on cuDNN"
                    if on_cudnn else "")
    log(f"[sem-13a] {what} step at the CLI defaults (batch 8, crop "
        f"256): {med:.3f} ms (median of {SEM_TIME} after "
        f"{SEM_WARM}, CUDA events; min {ms[0]:.3f}, max {ms[-1]:.3f}), "
        f"host wall {wall:.3f} ms a step; device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}; {launches:.0f} launches a "
        f"step; convolution kernels {conv:.3f} ms; {flops:.4e} FLOP a "
        f"step (utils/flops, float32 run), floor {row['floor_ms']:.3f} "
        f"ms at the card's {dtype} peak ({row['pct_peak_flops']:.1f}% of "
        f"it); peak "
        f"memory {peak:.2f} GiB; finite loss {np.isfinite(losses).all()} "
        f"({card})")
    log(f"[sem-13a] {what} top kernels (ms a step, launches over 2): "
        + "; ".join(f"{k[:70]} {v[0]:.3f} ({v[1]})"
                    for k, v in kernels[:8]))
    del trainer, state, batch
    torch.cuda.empty_cache()
    return flops, top_ops


def sem_dataset_root(root: str, seed: int):
    """13c's VKITTI root (data/synthetic.write_vkitti_root): four train
    frames of 0001/clone with one or two cars (also 13d's VKITTI rows)
    and the first SEM_EVAL_FRAMES frames of the test split with one car.
    Returns the train frames' list entries."""
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root
    from sdn3d_tpu_torch.data.vkitti import get_lists
    frames = {("0001", "clone", f"{i:05d}"): [(150, 200 + 90 * i, 260,
                                              380 + 90 * i)]
              + ([(170, 800, 250, 930)] if i % 2 else [])
              for i in range(4)}
    for f in get_lists("test")[:SEM_EVAL_FRAMES]:
        w, t, name = f.split("/")
        frames[(w, t, name[:-4])] = [(160, 500, 270, 700)]
    write_vkitti_root(root, frames, seed)
    return sorted(f"{w}/{t}/{n}.png" for (w, t, n) in frames
                  if w == "0001" and t == "clone")


def semantic_phase(args, card: str, shapenet: str, tmp: str,
                   mark=lambda what: None) -> None:
    """Phase 13: the semantic trainer and evaluator, and geometric_train
    over the KITTI / Cityscapes derender datasets.  13a:
    cli/semantic_train.main --synthetic at the CLI defaults (batch 8, crop
    256; the step written), descent on one batch, two runs of a step give
    the same bits, ms a step in float32 and bfloat16 with device busy,
    idle share, launches, FLOPs and peak memory; 13b: the card against a
    float64 CPU run; 13c: the dataset mode on a write_vkitti_root root
    (the CLI's get_lists patched to the root's train frames), the step
    served by semantic_test and scored by semantic_eval, ms a frame; 13d:
    cli/geometric_train --dataset kitti in its four modes and cityscapes
    in full and extend on the data/synthetic writers' roots, shapenet's
    eight meshes, full-width shapes (batch GEO_BATCH): B1 launched once a
    rendering step, B3 and B2 once a step with a mask loss, the step
    written."""
    import contextlib
    import io

    import torch

    from sdn3d_tpu_torch.cli import (geometric_train, semantic_eval,
                                     semantic_test, semantic_train)
    from sdn3d_tpu_torch.cli.semantic_train import build_trainer
    from sdn3d_tpu_torch.core.checkpoint import latest_step
    from sdn3d_tpu_torch.data import synthetic, vkitti
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.pipelines import derender as TPD
    from sdn3d_tpu_torch.pipelines.semantic import SemanticTrainState

    t_phase = time.perf_counter()
    # -- 13a. the CLI, descent, the same bits, times ------------------------
    ck = os.path.join(tmp, "sem_ck")
    t0 = time.perf_counter()
    state = semantic_train.main(["--synthetic", "--num_iters",
                                 str(SEM_CLI_ITERS), "--ckpt_dir", ck,
                                 "--seed", str(args.seed), "--device",
                                 SEM_DEVICE])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    files = sorted(os.listdir(os.path.join(ck, f"step-{SEM_CLI_ITERS}")))
    if latest_step(ck) != SEM_CLI_ITERS or state.step != SEM_CLI_ITERS \
            or files != ["decoder.pt", "encoder.pt", "opt_dec.pt",
                         "opt_enc.pt", "step.pt"]:
        raise AssertionError(f"13a semantic_train: step {latest_step(ck)}, "
                             f"files {files}")
    del state
    log(f"[sem-13a] semantic_train --synthetic at the CLI defaults (batch "
        f"8, crop 256, 14 classes, 51.4M parameters): {SEM_CLI_ITERS} "
        f"steps, step written ({', '.join(files)}) in {cli_s:.2f} s (model "
        f"built and saved included) ({card})")
    targs = sem_args(os.path.join(tmp, "none"), args.seed)
    trainer = build_trainer(targs)
    state = trainer.init()
    batch = sem_batch(targs, args.seed, targs.device)
    fields0 = clone_fields(state.fields())
    state, losses, _ = sem_steps(trainer, state, batch, args.seed,
                                 SEM_DESCENT)
    first = float(np.mean(losses[:SEM_WINDOW]))
    last = float(np.mean(losses[-SEM_WINDOW:]))
    if not np.isfinite(losses).all() or not last < SEM_DESCENT_FACTOR * first:
        raise AssertionError(f"13a descent: {losses}")
    log(f"[sem-13a] {SEM_DESCENT} steps on one batch: loss first / last "
        f"{SEM_WINDOW} {first:.6f} -> {last:.6f} (factor {last / first:.4f}"
        f", bound {SEM_DESCENT_FACTOR}); step 0 {losses[0]:.6f}, step "
        f"{SEM_DESCENT - 1} {losses[-1]:.6f}")
    runs = []
    for _ in range(2):
        state = SemanticTrainState.from_fields(clone_fields(fields0),
                                               trainer.model)
        state, losses, _ = sem_steps(trainer, state, batch, args.seed, 1)
        runs.append((clone_fields(state.fields()), losses[0]))
    bad = same_fields(runs[0][0], runs[1][0])
    if bad or runs[0][1] != runs[1][1]:
        raise AssertionError(f"13a: two runs of a step differ: {bad[:8]}, "
                             f"{runs[0][1]} / {runs[1][1]}")
    log("[sem-13a] two runs of a full-width step from the same state, batch "
        "and dropout draws: the encoder, the decoder (running statistics "
        "included), both momentum traces and counts and the loss bit-equal")
    del runs, trainer, state, batch, fields0
    torch.cuda.empty_cache()
    mark("13a. semantic CLI, descent, same bits")
    sem_times(targs, args.seed, card, tmp)
    mark("13a. semantic times")

    # -- 13b. card against CPU float64 ----------------------------------------
    sem_card_against_cpu(args.seed, card)
    mark("13b. semantic card against CPU")

    # -- 13c. the dataset mode, semantic_test, semantic_eval -------------------
    root = os.path.join(tmp, "sem_vk")
    train_files = sem_dataset_root(root, args.seed)
    ck2 = os.path.join(tmp, "sem_ck_data")
    lists = vkitti.get_lists
    vkitti.get_lists = lambda opt: train_files if opt == "train" \
        else lists(opt)
    try:
        t0 = time.perf_counter()
        state = semantic_train.main([
            "--data_root", root, "--num_iters", str(SEM_DATA_ITERS),
            "--save_every", str(SEM_DATA_ITERS), "--ckpt_dir", ck2, "--seed",
            str(args.seed), "--device", SEM_DEVICE])
        torch.cuda.synchronize()
        data_s = time.perf_counter() - t0
    finally:
        vkitti.get_lists = lists
    if state.step != SEM_DATA_ITERS or latest_step(ck2) != SEM_DATA_ITERS:
        raise AssertionError(f"13c dataset mode: step {state.step}")
    del state
    torch.cuda.empty_cache()
    test_files = lists("test")[:SEM_EVAL_FRAMES]
    out = os.path.join(tmp, "sem_out")
    frame = os.path.join(root, "vkitti_1.3.1_rgb", test_files[0])
    semantic_test.main(["--test_img", frame, "--ckpt_dir", ck2, "--result",
                        out, "--device", SEM_DEVICE])
    from PIL import Image
    stem = os.path.splitext(os.path.basename(frame))[0]
    labels = np.asarray(Image.open(os.path.join(out, f"{stem}.png")))
    if labels.shape != (375, 1242) or labels.max() >= 14:
        raise AssertionError(f"13c semantic_test: {labels.shape}")
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = semantic_eval.main(["--data_root", root, "--ckpt_dir", ck2,
                                  "--limit", str(SEM_EVAL_FRAMES),
                                  "--device", SEM_DEVICE])
    eval_s = time.perf_counter() - t0
    if not (np.isfinite(res["iou"]).all() and 0 <= res["mean_iou"] <= 1
            and "Mean IoU" in text.getvalue()):
        raise AssertionError(f"13c semantic_eval: {res}")
    # steady ms a frame: the evaluator's multi-scale pass on a loaded model
    from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_fused
    model = semantic_test.load_model(SimpleNamespace(
        device=SEM_DEVICE, num_class=14, ckpt_dir=ck2, seed=args.seed))
    rgb = np.asarray(Image.open(frame).convert("RGB"))
    multiscale_labels_fused(model, rgb, device=SEM_DEVICE)
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        multiscale_labels_fused(model, rgb, device=SEM_DEVICE)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    del model
    torch.cuda.empty_cache()
    log(f"[sem-13c] dataset mode (get_lists patched to the root's "
        f"{len(train_files)} train frames, 375x1242, batch 8, crop 256): "
        f"{SEM_DATA_ITERS} steps in {data_s:.2f} s (model built and step "
        f"saved included, {data_s / SEM_DATA_ITERS * 1e3:.1f} ms a step "
        f"all in); semantic_test --ckpt_dir served the step (labels "
        f"{labels.shape}); semantic_eval --limit {SEM_EVAL_FRAMES} (5 "
        f"scales): mean IoU {res['mean_iou']:.4f}, accuracy "
        f"{res['accuracy']:.2f}% in {eval_s:.2f} s (model load included, "
        f"{eval_s / SEM_EVAL_FRAMES * 1e3:.1f} ms a frame all in); a "
        f"frame's multi-scale pass {sorted(frame_ms)[1]:.3f} ms (median of "
        f"3, host wall, fetch included) ({card})")
    mark("13c. semantic dataset mode, semantic_test, semantic_eval")

    # -- 13d. geometric_train over the KITTI / Cityscapes datasets ------------
    roots = {"kitti": os.path.join(tmp, "geo_kitti"),
             "ksem": os.path.join(tmp, "geo_ksem"),
             "cs": os.path.join(tmp, "geo_cs")}
    synthetic.write_kitti_object_root(roots["kitti"])
    synthetic.write_kitti_semantics_root(roots["ksem"])
    synthetic.write_cityscapes_derender_root(roots["cs"])
    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain)
    losses_fn, step_fn = TPD.DerenderTrainer.losses, \
        TPD.DerenderTrainer.train_step
    masked, events = [], []

    def losses(self, blob, batch):
        out = losses_fn(self, blob, batch)
        masked.append("mask_loss" in out)
        return out

    def train_step(self, state, batch, generator=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step_fn(self, state, batch, generator)
        b.record()
        events.append((a, b))
        return out
    TPD.DerenderTrainer.losses = losses
    TPD.DerenderTrainer.train_step = train_step
    rows = []
    try:
        for dataset, mode in GEO_RUNS:
            ckd = os.path.join(tmp, f"geo_ck_{dataset}_{mode}")
            argv = ["--mode", mode, "--dataset", dataset, "--num_iters",
                    str(GEO_DATA_ITERS), "--save_every", str(GEO_DATA_ITERS),
                    "--batch_size", str(GEO_BATCH), "--num_workers", "2",
                    "--ckpt_dir", ckd, "--shapenet_root", shapenet,
                    "--seed", str(args.seed), "--device", SEM_DEVICE]
            if dataset == "kitti":
                argv += ["--kitti_object_root", roots["kitti"],
                         "--kitti_semantics_root", roots["ksem"]]
            else:
                argv += ["--cityscapes_root", roots["cs"], "--vkitti_root",
                         root]
            for fn in kernels:
                fn.launches = 0
            for fn in plain:
                fn.calls = 0
            masked.clear()
            events.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                state = geometric_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = [fn.launches for fn in kernels]
            step_ms = sorted(a.elapsed_time(b) for a, b in events[1:])
            renders = GEO_DATA_ITERS if TPD.TargetType.BY_NAME[mode] \
                & TPD.TargetType.reproject else 0
            n_mask = sum(masked)
            if counts != [renders, n_mask, n_mask] \
                    or any(fn.calls for fn in plain) \
                    or state.step != GEO_DATA_ITERS \
                    or latest_step(ckd) != GEO_DATA_ITERS:
                raise AssertionError(
                    f"13d {dataset} {mode}: launches {counts} for {renders} "
                    f"rendering steps, {n_mask} with a mask loss; plain "
                    f"{[fn.calls for fn in plain]}; step {state.step}")
            rows.append(f"{dataset} {mode}: B1/B3/B2 {counts} over "
                        f"{GEO_DATA_ITERS} steps ({renders} rendering, "
                        f"{n_mask} with a mask loss), steps after the "
                        f"first {', '.join(f'{m:.3f}' for m in step_ms)} ms "
                        f"(CUDA events), {wall:.2f} s all in")
            del state
    finally:
        TPD.DerenderTrainer.losses = losses_fn
        TPD.DerenderTrainer.train_step = step_fn
    torch.cuda.empty_cache()
    log(f"[sem-13d] geometric_train on the writer roots (batch "
        f"{GEO_BATCH}, image 256, render 384, shapenet's eight meshes; model "
        f"built, bank loaded and step saved included): " + "; ".join(rows)
        + f" ({card})")
    mark("13d. geometric_train on kitti and cityscapes")
    log(f"[sem] phase 13 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 14: Mask R-CNN training ------------------------------------------
DT_CLI_ITERS = 2
# the CLI runs of 14a: (--stage, or None for the schedule, with --coco_ckpt)
DT_RUNS = (("heads", False), ("4+", False), ("all", False), (None, True))
DT_DESCENT = 20
DT_DESCENT_LR = 1e-2
DT_WINDOW = 3
DT_DESCENT_FACTOR = 0.9
DT_WARM = 3
DT_TIME = 10
DT_TIME_STAGES = ("heads", "4+", "all")
# 14c: the small configuration of the card against the CPU (the CLI's
# --small shapes at 256^2), and 13b's rule
DT_SMALL = dict(image_min_dim=256, image_max_dim=256, stage_sizes=(1, 1, 1, 1),
                fpn_channels=32, pre_nms_limit=100, post_nms_rois_training=40,
                train_rois_per_image=12, mask_shape=(14, 14),
                mask_pool_size=7, rpn_train_anchors_per_image=32)
DT_CPU_FACTOR = 3.0
DT_LOSS_RTOL = 1e-4
DT_DEVICE = "cuda"


def dt_example(cfg, seed: int, dev):
    """One synthetic example of the CLI's (data/detect_data, the RPN
    balance drawn from RandomState(seed) through the global generator's
    state saved and restored), on the device once."""
    from sdn3d_tpu_torch.cli.detect_train import to_example
    from sdn3d_tpu_torch.data.detect_data import synthetic_detect_example
    from sdn3d_tpu_torch.models.maskrcnn import generate_pyramid_anchors
    saved = np.random.get_state()
    np.random.seed(seed)
    try:
        ex = synthetic_detect_example(cfg, generate_pyramid_anchors(cfg),
                                      seed=seed)
    finally:
        np.random.set_state(saved)
    return to_example(ex, dev)


def dt_proposal_gt(model, cfg, batch):
    """`batch` with three of the model's own proposals (eval mode, its
    anchors) as the GT boxes, classes 1, 2, 1: the sampled RoIs then hold
    positives, and every head's loss has a gradient."""
    import torch

    from sdn3d_tpu_torch.models.maskrcnn import (bn_mode,
                                                 generate_pyramid_anchors,
                                                 proposal_layer)
    x, match, tb, gids, gb, gm = batch
    anchors = torch.from_numpy(generate_pyramid_anchors(cfg)).to(x.device)
    with torch.no_grad(), bn_mode(model, False):
        _, probs, bbox = model.rpn_forward(model.fpn(x))
        props, valid = proposal_layer(probs, bbox, anchors, cfg,
                                      cfg.post_nms_rois_training)
    pick = torch.nonzero(valid[0])[:, 0][:9:4]
    gids, gb = torch.zeros_like(gids), torch.zeros_like(gb)
    gids[:len(pick)] = torch.tensor([1, 2, 1][:len(pick)], dtype=gids.dtype)
    gb[:len(pick)] = props[0, pick]
    return x, match, tb, gids, gb, gm


def dt_trainer(sd, stage: str, dtype: str = "float32", lr: float = 1e-3,
               train_bn: bool = False, cfg=None):
    """A MaskRCNNTrainer on DT_DEVICE and its step-0 state with the weights
    of state_dict `sd` (MaskRCNNConfig() unless `cfg`)."""
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNN, MaskRCNNConfig
    from sdn3d_tpu_torch.pipelines.detect_train import MaskRCNNTrainer
    cfg = cfg or MaskRCNNConfig(compute_dtype=dtype)
    trainer = MaskRCNNTrainer(config=cfg, stage=stage, learning_rate=lr,
                              train_bn=train_bn, device=DT_DEVICE)
    model = MaskRCNN(cfg)
    model.load_state_dict(sd)
    return trainer, trainer.init(model=model.to(DT_DEVICE))


def dt_steps(trainer, state, batch, seed: int, n: int, first: int = 0):
    """n train steps on one example with the CLI's generator of each
    iteration; returns (state, [total losses], [ms a step, CUDA
    events])."""
    import torch

    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    dev = batch[0].device
    totals, events = [], []
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, losses = trainer.train_step(
            state, *batch, step_generator(seed, first + i, dev))
        b.record()
        totals.append(sum(losses.values()))
        events.append((a, b))
    torch.cuda.synchronize()
    return (state, [float(t) for t in totals],
            [a.elapsed_time(b) for a, b in events])


def dt_cli_runs(args, card: str, tmp: str, ckpt: str):
    """14a: cli/detect_train.main --dataset synthetic at MaskRCNNConfig()
    for each DT_RUNS entry in float32 and bfloat16: every first-step loss
    finite, the step written, the stage's frozen parameters bit-unchanged
    and its trained ones moved.  Returns the float32 schedule run's
    checkpoint directory."""
    import io

    import torch

    from sdn3d_tpu_torch.cli import detect_train
    from sdn3d_tpu_torch.core.checkpoint import latest_step, restore_checkpoint
    from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                                 init_weights)
    from sdn3d_tpu_torch.pipelines import detect_train as TDT

    start = {False: init_weights(MaskRCNN(MaskRCNNConfig()),
                                 args.seed).state_dict(),
             True: torch.load(ckpt)}
    step_fn = TDT.MaskRCNNTrainer.train_step
    first = []

    def train_step(self, state, *a, **kw):
        state, losses = step_fn(self, state, *a, **kw)
        if not first:
            first.append({k: float(v) for k, v in losses.items()})
        return state, losses
    rows, served = [], None
    TDT.MaskRCNNTrainer.train_step = train_step
    try:
        for dtype in ("float32", "bfloat16"):
            for stage, coco in DT_RUNS:
                ckd = os.path.join(tmp, f"dt_{dtype}_{stage or 'schedule'}")
                argv = ["--dataset", "synthetic", "--num_iters",
                        str(DT_CLI_ITERS), "--num_epochs", "1",
                        "--ckpt_dir", ckd, "--seed", str(args.seed),
                        "--device", DT_DEVICE, "--compute_dtype", dtype]
                argv += ["--stage", stage] if stage else []
                argv += ["--coco_ckpt", ckpt] if coco else []
                first.clear()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    state = detect_train.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                fields, _ = restore_checkpoint(ckd)
                trained = stage or "transfer"
                labels = TDT.layer_labels(state.model, trained)
                sd0 = start[coco]
                frozen = [n for n, lab in labels.items() if lab == "freeze"]
                moved = [n for n, lab in labels.items() if lab != "freeze"
                         and not torch.equal(fields["maskrcnn"][n], sd0[n])]
                bad = [n for n in frozen
                       if not torch.equal(fields["maskrcnn"][n], sd0[n])]
                stats = [n for n in sd0 if n.endswith(("running_mean",
                                                       "running_var"))
                         and not torch.equal(fields["maskrcnn"][n], sd0[n])]
                if latest_step(ckd) != 1 or sorted(fields) != [
                        "maskrcnn", "opt_state", "step"] \
                        or state.step != DT_CLI_ITERS \
                        or not first or not np.isfinite(
                            list(first[0].values())).all() \
                        or bad or stats or not moved:
                    raise AssertionError(
                        f"14a detect_train {dtype} {stage or 'schedule'}: "
                        f"step {latest_step(ckd)} / {state.step}, fields "
                        f"{sorted(fields)}, first losses {first}, frozen "
                        f"moved {bad[:4]}, statistics moved {stats[:4]}, "
                        f"trained moved {len(moved)}")
                rows.append(
                    f"{dtype} {'--stage ' + stage if stage else 'schedule'}"
                    f"{' --coco_ckpt' if coco else ''}: first-step losses "
                    + ", ".join(f"{k} {v:.4f}" for k, v in first[0].items())
                    + f"; {len(frozen)} frozen bit-unchanged, "
                    f"{len(moved)} of {len(labels) - len(frozen)} trained "
                    f"moved; {wall:.2f} s all in")
                if dtype == "float32" and coco:
                    served = ckd
                del state, fields
                torch.cuda.empty_cache()
    finally:
        TDT.MaskRCNNTrainer.train_step = step_fn
    log(f"[dt-14a] detect_train --dataset synthetic at MaskRCNNConfig() "
        f"(ResNet-101 FPN, 1024^2, 6000 -> 2000 proposals, 200 RoIs, 28^2 "
        f"masks, 3 classes, batch 1), {DT_CLI_ITERS} iterations a run, the "
        f"step written (model built and saved included): "
        + "; ".join(rows) + f" ({card})")
    return served


def dt_serve(args, card: str, frames, shapenet: str, tmp: str,
             ckd: str) -> None:
    """14a: geometric_main --maskrcnn_ckpt <a detect_train step> over
    phase 4's frames: one B1 launch an item, no plain forward."""
    import torch

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    launch = TC.rasterize_face_index_cuda
    launch.launches = 0
    TR.rasterize_face_maps.calls = 0
    n_objs, t0 = [], time.perf_counter()
    for k, (img, _, edit, _) in enumerate(frames):
        out_dir = os.path.join(tmp, f"dt_serve{k}")
        geometric_main.main(["--input_image", img, "--edit_json", edit,
                             "--shapenet_root", shapenet, "--output_dir",
                             out_dir, "--seed", str(args.seed),
                             "--maskrcnn_ckpt", ckd])
        n_objs.append(check_outputs(out_dir, 16, min_objs=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1, plain = launch.launches, TR.rasterize_face_maps.calls
    if b1 != 2 * len(frames) or plain:
        raise AssertionError(f"14a geometric_main --maskrcnn_ckpt {ckd}: "
                             f"forward launches {b1} for {2 * len(frames)} "
                             f"items, plain calls {plain}")
    log(f"[dt-14a] geometric_main --maskrcnn_ckpt (the float32 schedule "
        f"run's step) over {len(frames)} frames x 2 items in {wall:.2f} s: "
        f"forward kernel launches {b1}, plain forward calls {plain}, "
        f"objects per frame {n_objs}; outputs ok ({card})")


def dt_descent(args, card: str) -> None:
    """14b: DT_DESCENT steps of stage "all" with train_bn on one example
    from the weights as drawn: the total loss falls."""
    import torch

    from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                                 init_weights)
    sd = init_weights(MaskRCNN(MaskRCNNConfig()), args.seed).state_dict()
    trainer, state = dt_trainer(sd, "all", lr=DT_DESCENT_LR, train_bn=True)
    batch = dt_example(trainer.config, args.seed, DT_DEVICE)
    state, totals, _ = dt_steps(trainer, state, batch, args.seed,
                                DT_DESCENT)
    first = float(np.mean(totals[:DT_WINDOW]))
    last = float(np.mean(totals[-DT_WINDOW:]))
    if not np.isfinite(totals).all() or not last < DT_DESCENT_FACTOR * first:
        raise AssertionError(f"14b descent: {totals}")
    log(f"[dt-14b] {DT_DESCENT} steps of stage all, train_bn, lr "
        f"{DT_DESCENT_LR}, on one synthetic example from the weights as "
        f"drawn: total loss first / last {DT_WINDOW} {first:.6f} -> "
        f"{last:.6f} (factor {last / first:.4f}, bound "
        f"{DT_DESCENT_FACTOR}); step 0 {totals[0]:.6f}, step "
        f"{DT_DESCENT - 1} {totals[-1]:.6f} ({card})")
    del trainer, state, batch
    torch.cuda.empty_cache()


def dt_group_grads(sd, cfg, batch, targets, dev, dtype, compute="float32"):
    """The summed losses' gradients of stage "transfer" by group (one
    vector each, float64 on the host) and the total, with `targets`
    (detection_targets' dict) in place of the step's own."""
    import torch

    from sdn3d_tpu_torch.models import maskrcnn_train as TMT
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNN
    from sdn3d_tpu_torch.pipelines.detect_train import MaskRCNNTrainer
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    model = MaskRCNN(cfg)
    model.load_state_dict(sd)
    model = model.to(dev, dtype)
    trainer = MaskRCNNTrainer(config=cfg, stage="transfer", device=dev)
    state = trainer.init(model=model)
    given = {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev))
             for k, v in targets.items()}
    found = TMT.detection_targets
    TMT.detection_targets = lambda *a, **kw: given
    try:
        x, match, tb, gids, gb, gm = (
            t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
            for t in batch)
        grads, losses = trainer.gradients(state, x, match, tb, gids, gb, gm,
                                          None, trainer.anchors.to(dtype))
    finally:
        TMT.detection_targets = found
    vec = {g: torch.cat([t.reshape(-1) for t in grads[g]]).double().cpu()
           for g in grads if grads[g]}
    return vec, float(sum(losses.values()))


def dt_card_against_cpu(args, card: str) -> None:
    """14c: one step's gradients at DT_SMALL (stage transfer: the "train"
    and "transfer" groups), the card in float32 within DT_CPU_FACTOR x
    the CPU float32's distance to a float64 CPU run in each group (error
    relative to the group's largest entry, and 1 - cosine); bfloat16
    printed beside; three of the model's proposals are the GT boxes, and
    every run is given the CPU float32 run's targets."""
    import torch

    from sdn3d_tpu_torch.models import maskrcnn_train as TMT
    from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNN, MaskRCNNConfig,
                                                 generate_pyramid_anchors,
                                                 init_weights)
    cfg = MaskRCNNConfig(**DT_SMALL)
    sd = init_weights(MaskRCNN(cfg), args.seed).state_dict()
    for k in ("rpn.conv_class.weight", "rpn.conv_bbox.weight",
              "classifier.linear_class.weight",
              "classifier.linear_bbox.weight", "mask.conv5.weight"):
        sd[k] = sd[k] * DET_TAME
    model = MaskRCNN(cfg)
    model.load_state_dict(sd)
    anchors = torch.from_numpy(generate_pyramid_anchors(cfg))
    batch = dt_proposal_gt(model, cfg, dt_example(cfg, args.seed, "cpu"))
    x, _, _, gids, gb, gm = batch
    # the CPU float32 forward's own targets
    seen = []
    found = TMT.detection_targets

    def record(*a, **kw):
        seen.append(found(*a, **kw))
        return seen[-1]
    TMT.detection_targets = record
    try:
        with torch.no_grad():
            model.train_forward(x, anchors, gids, gb, gm,
                                torch.Generator().manual_seed(args.seed))
    finally:
        TMT.detection_targets = found
    targets = {k: v.detach() for k, v in seen[0].items()}
    ref, ref_loss = dt_group_grads(sd, cfg, batch, targets, "cpu",
                                   torch.float64)
    runs = {key: dt_group_grads(sd, cfg, batch, targets, dev, torch.float32,
                                compute)
            for key, dev, compute in (("card", DT_DEVICE, "float32"),
                                      ("cpu", "cpu", "float32"),
                                      ("bfloat16", DT_DEVICE, "bfloat16"))}

    def errs(vec):
        out = {}
        for g, want in ref.items():
            got = vec[g]
            cos = float(torch.dot(got, want) / (got.norm() * want.norm()))
            out[g] = (float((got - want).abs().max() / want.abs().max()),
                      max(1.0 - cos, 0.0))
        return out
    res = {k: (abs(loss - ref_loss) / abs(ref_loss), errs(v))
           for k, (v, loss) in runs.items()}
    cpu, c = res["cpu"][1], res["card"][1]
    # 1 - cosine below 1e-12 is the float64 cosine's own rounding
    bad = [g for g in ref if not (c[g][0] <= DT_CPU_FACTOR * cpu[g][0]
                                  and c[g][1] <= DT_CPU_FACTOR
                                  * max(cpu[g][1], 1e-12))]
    if bad or res["card"][0] > DT_LOSS_RTOL:
        raise AssertionError(f"14c card against float64: {res['card']}; the "
                             f"CPU's float32: {res['cpu']}; groups {bad}")

    def fmt(r):
        return (f"loss rel {r[0]:.3e}; " + "; ".join(
            f"{g} {e:.3e} / 1 - cos {d:.3e}" for g, (e, d) in r[1].items()))
    log(f"[dt-14c] one step's gradients of stage transfer at "
        f"{cfg.image_max_dim}^2, stage_sizes {cfg.stage_sizes}, FPN "
        f"{cfg.fpn_channels} (the heads' last layers scaled by {DET_TAME}; "
        f"every run given the CPU float32 run's targets), against a float64 "
        f"CPU run, by group (error relative to the group's largest entry): "
        f"card float32 {fmt(res['card'])} (bound: {DT_CPU_FACTOR}x the "
        f"CPU's in each group); CPU float32 {fmt(res['cpu'])}; card "
        f"bfloat16 {fmt(res['bfloat16'])} ({card})")


def dt_same_bits(args, card: str, ckpt: str) -> None:
    """14d: two runs of a full-width float32 step of stage "all" from the
    same state, example and draws give the same bits: weights, running
    statistics, the trace and the losses; the GT boxes are three of the
    model's proposals, so that every head's loss, and the RoI crops'
    backward, carry a gradient."""
    import torch
    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    trainer, state = dt_trainer(torch.load(ckpt), "all")
    batch = dt_proposal_gt(state.model, trainer.config, dt_example(
        trainer.config, args.seed, DT_DEVICE))
    model0 = clone_fields(state.model.state_dict())
    trace0 = clone_fields(state.trace)
    runs = []
    for _ in range(2):
        state.model.load_state_dict(model0)
        state.trace = clone_fields(trace0)
        state, losses = trainer.train_step(
            state, *batch, step_generator(args.seed, 0, DT_DEVICE))
        runs.append((clone_fields(state.model.state_dict()),
                     clone_fields(state.trace),
                     {k: float(v) for k, v in losses.items()}))
    bad = same_fields(runs[0][0], runs[1][0]) + same_fields(runs[0][1],
                                                            runs[1][1])
    if bad or runs[0][2] != runs[1][2] or not all(runs[0][2].values()):
        raise AssertionError(f"14d: two runs of a step differ, or a loss is "
                             f"0: {bad[:8]}, {runs[0][2]} / {runs[1][2]}")
    log(f"[dt-14d] two runs of a full-width float32 step (stage all, the "
        f"phase 9 checkpoint's weights, one example with three of the "
        f"model's proposals as its GT boxes, the same draws): weights, "
        f"running statistics, trace and losses bit-equal, every loss "
        f"nonzero (" + ", ".join(f"{k} {v:.6f}" for k, v in
                                 runs[0][2].items()) + f") ({card})")
    del trainer, state, runs
    torch.cuda.empty_cache()


def dt_times(args, card: str, ckpt: str) -> None:
    """14e: ms a full-width step of each DT_TIME_STAGES stage in float32
    and bfloat16 (CUDA events, median of DT_TIME after DT_WARM), host
    wall, device busy and idle share, launches a step, top kernels, FLOPs
    (utils/flops.count_flops of one float32 step) against the card's peak
    (utils/flops.mfu_row), peak memory."""
    import torch

    from sdn3d_tpu_torch.utils import flops as FL
    sd = torch.load(ckpt)
    for stage in DT_TIME_STAGES:
        n_flops = None
        for dtype in ("float32", "bfloat16"):
            trainer, state = dt_trainer(sd, stage, dtype)
            batch = dt_example(trainer.config, args.seed, DT_DEVICE)
            if n_flops is None:
                n_flops, top_ops = FL.count_flops(lambda: dt_steps(
                    trainer, state, batch, args.seed, 1))
            dt_steps(trainer, state, batch, args.seed, DT_WARM)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, totals, ms = dt_steps(trainer, state, batch, args.seed,
                                         DT_TIME, first=DT_WARM)
            wall = (time.perf_counter() - t0) * 1e3 / DT_TIME
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ms = sorted(ms)
            med = ms[len(ms) // 2]
            busy, kernels = device_time(lambda: dt_steps(
                trainer, state, batch, args.seed, 2), 2)
            launches = sum(v[1] for _, v in kernels) / 2
            conv = sum(v[0] for k, v in kernels if any(
                w in k.lower() for w in ("conv", "cudnn", "xmma", "gemm",
                                         "gemv", "fft")))
            row = FL.mfu_row(n_flops, None, med / 1e3, dtype=dtype,
                             peaks=PEAK)
            log(f"[dt-14e] {dtype} step of stage {stage} at MaskRCNNConfig() "
                f"(batch 1): {med:.3f} ms (median of {DT_TIME} after "
                f"{DT_WARM}, CUDA events; min {ms[0]:.3f}, max {ms[-1]:.3f}), "
                f"host wall {wall:.3f} ms a step; device busy {busy:.3f} ms, "
                f"idle share {1 - busy / wall:.4f}; {launches:.0f} launches "
                f"a step; convolution kernels {conv:.3f} ms; {n_flops:.4e} "
                f"FLOP a step (utils/flops, float32 run), floor "
                f"{row['floor_ms']:.3f} ms at the card's {dtype} peak "
                f"({row['pct_peak_flops']:.1f}% of it); peak memory "
                f"{peak:.2f} GiB; finite losses {np.isfinite(totals).all()} "
                f"({card})")
            log(f"[dt-14e] {dtype} {stage} top kernels (ms a step, launches "
                f"over 2): " + "; ".join(f"{k[:60]} {v[0]:.3f} ({v[1]})"
                                         for k, v in kernels[:6]))
            if dtype == "float32":
                log(f"[dt-14e] {stage} FLOPs by op (one float32 step): "
                    + "; ".join(f"{k} {v:.3e}" for k, v in top_ops))
            del trainer, state, batch
            torch.cuda.empty_cache()


def dt_item_cost(args, card: str, tmp: str) -> None:
    """14e: the host cost of one VKITTI item (VKittiDetectDataset at
    MaskRCNNConfig(): PNG decode, scenegt instances, mold_gt_example over
    the 261,888 anchors, PIL mini-masks) on a write_vkitti_root root."""
    from sdn3d_tpu_torch.data.detect_data import VKittiDetectDataset
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root
    from sdn3d_tpu_torch.models.maskrcnn import (MaskRCNNConfig,
                                                 generate_pyramid_anchors)
    root = os.path.join(tmp, "dt_vk")
    rng = np.random.RandomState(args.seed)
    write_vkitti_root(root, {("0001", "clone", f"{i:05d}"): car_boxes(
        rng, 4 + 4 * i) for i in range(2)}, args.seed)
    cfg = MaskRCNNConfig()
    anchors = generate_pyramid_anchors(cfg)
    ds = VKittiDetectDataset(root, cfg, anchors)
    walls = []
    for i in range(2 * len(ds) + 1):
        t0 = time.perf_counter()
        ex = ds[i % len(ds)]
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = sorted(walls[1:])
    n = int((ex["gt_class_ids"] > 0).sum())
    log(f"[dt-14e] one VKITTI item (375x1242 -> 1024^2, "
        f"{anchors.shape[0]} anchors, 56^2 mini-masks) on the host: "
        f"{walls[len(walls) // 2]:.3f} ms (median of {len(walls)}; min "
        f"{walls[0]:.3f}, max {walls[-1]:.3f}); {len(ds)} frames, {n} GT "
        f"instances in the last ({card})")


def detect_train_phase(args, card: str, frames, shapenet: str, tmp: str,
                       ckpt: str, mark=lambda what: None) -> None:
    """Phase 14: Mask R-CNN training at MaskRCNNConfig()'s full width (no
    repo kernel on the training path; B1 on the served step).  14a the
    CLI in each stage and the schedule with --coco_ckpt (phase 9's
    checkpoint), float32 and bfloat16, then geometric_main --maskrcnn_ckpt
    serving a step; 14b descent; 14c the card against the CPU; 14d the
    same bits on two runs; 14e times and a VKITTI item's host cost."""
    t_phase = time.perf_counter()
    served = dt_cli_runs(args, card, tmp, ckpt)
    dt_serve(args, card, frames, shapenet, tmp, served)
    mark("14a. detect_train CLI runs, served step")
    dt_descent(args, card)
    mark("14b. detect_train descent")
    dt_card_against_cpu(args, card)
    mark("14c. detect_train card against CPU")
    dt_same_bits(args, card, ckpt)
    mark("14d. detect_train same bits")
    dt_times(args, card, ckpt)
    dt_item_cost(args, card, tmp)
    mark("14e. detect_train times")
    log(f"[dt] phase 14 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 15. data parallelism: geometric_train and semantic_train under a process
# group (parallel/mesh.py), in processes of their own
# ---------------------------------------------------------------------------
DDP_STEPS = 3             # steps timed a run, after DDP_WARM
DDP_WARM = 1
DDP_DEVICE = "cuda"
DDP_SEM_SHAPES = {"batch_size": 8, "crop_size": 256}
DDP_TIMEOUT_S = 600
# World size 2 (gloo, two ranks on the card) against world size 1 (NCCL)
# on the same global batch, float32: the losses within DDP_LOSS_RTOL; the
# gradients (the derenderer's Adam moment, the semantic SGD trace) at
# cosine >= DDP_GRAD_COS with the largest error printed; the running
# statistics within DDP_STATS_RTOL of each tensor's largest entry and the
# same bits on both ranks.  The derenderer's silhouette gradient turns a
# last-bit difference of the encoder (BatchNorm's sums in another order)
# into moved subpixels, whose walk terms are ~1e-2 of a gradient
# (tests/test_torch_parallel.py holds the rendering step in float64).
DDP_LOSS_RTOL = 1e-4
DDP_GRAD_COS = 0.99
DDP_STATS_RTOL = 1e-4


def ddp_derender(job, dev, parallel):
    """geometric_train's step (mode full, job's shapes, phase 4's meshes)
    on this rank's slice: the first step's results, then the launches of
    B1 / B3 / B2 and ms a step over DDP_STEPS steps, and the collectives'
    kernels a step (profiler)."""
    import torch

    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import DeviceMeshBank
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC

    S = job["shapes"]
    bank = DeviceMeshBank.from_host(load_shapenet_bank(job["shapenet"]), dev)
    trainer = new_trainer(bank, job["seed"], dev, shapes=S)
    parallel.broadcast_module(trainer.model)
    B = S["batch_size"]
    batch = parallel.shard_batch(train_batch(job["seed"], dev, S), B)
    state = trainer.init()
    state, losses = trainer.train_step(state, batch, parallel.global_draw(
        step_generator(job["seed"], 0, dev), B))
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "grad": state.mu.cpu().clone(),
           "params": torch.cat([p.detach().reshape(-1).cpu()
                                for p in state.model.parameters()]),
           "stats": {n: v.cpu().clone() for n, v in state.model.state_dict().items()
                     if n.endswith(("running_mean", "running_var"))}}
    if not job.get("time"):
        return out
    # the kernels' launch counts; their plain versions' call counts on a
    # CPU rehearsal
    from sdn3d_tpu_torch.ops import rasterize as TR
    kernels, count = ((TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
                       TC.segment_face_grads_cuda), "launches") \
        if dev.type == "cuda" else ((TR.rasterize_face_maps,
                                     TR.walk_grads_plain,
                                     TR.segment_face_grads_plain), "calls")

    def steps(first, n):
        st = state
        for i in range(n):
            st, _ = trainer.train_step(st, batch, parallel.global_draw(
                step_generator(job["seed"], first + i, dev), B))
        return st

    state = steps(1, DDP_WARM)
    for fn in kernels:
        setattr(fn, count, 0)
    out["ms"] = timed_steps(lambda i: steps(1 + DDP_WARM + i, 1), DDP_STEPS,
                            dev)
    out["launches"] = [getattr(fn, count) / DDP_STEPS for fn in kernels]
    _, out["calls"] = counted_collectives(lambda: steps(50, 1))
    out["busy"], out["top"] = ddp_device_time(lambda: steps(100, 2), dev)
    return out


def ddp_semantic(job, dev, parallel):
    """semantic_train's step at its defaults on this rank's slice: the
    first step's results, then ms a step and the collectives' kernels."""
    import torch

    from sdn3d_tpu_torch.cli.semantic_train import build_trainer

    args = sem_args(job["ckpt"], job["seed"], **job["shapes"])
    args.device = str(dev)
    trainer = build_trainer(args)
    B = args.batch_size
    batch = parallel.shard_batch(sem_batch(args, job["seed"], dev), B)
    state = trainer.init()
    state, metrics = trainer.train_step(state, *batch, parallel.global_draw(
        step_generator(job["seed"], 0, dev), B))
    model = state.model
    out = {"losses": {k: float(v) for k, v in metrics.items()},
           "grad": torch.cat([t.reshape(-1).cpu() for t in
                              state.trace_enc + state.trace_dec]),
           "params": torch.cat([p.detach().reshape(-1).cpu()
                                for p in model.parameters()]),
           "stats": {n: v.cpu().clone() for n, v in model.state_dict().items()
                     if n.endswith(("running_mean", "running_var"))}}
    if not job.get("time"):
        return out

    def steps(first, n):
        st = state
        for i in range(n):
            st, _ = trainer.train_step(st, *batch, parallel.global_draw(
                step_generator(job["seed"], first + i, dev), B))
        return st

    steps(1, DDP_WARM)
    out["ms"] = timed_steps(lambda i: steps(1 + DDP_WARM + i, 1), DDP_STEPS,
                            dev)
    _, out["calls"] = counted_collectives(lambda: steps(50, 1))
    out["busy"], out["top"] = ddp_device_time(lambda: steps(100, 2), dev)
    return out


def ddp_device_time(fn, dev):
    """device_time of two steps on the card; nothing measured on the
    CPU."""
    import torch
    if torch.device(dev).type == "cpu":
        return 0.0, []
    return device_time(fn, 2)


def timed_steps(fn, n: int, dev=None) -> list:
    """ms of each of n calls fn(i) by CUDA events (by the host's clock
    when `dev` is the CPU, as a rehearsal of the phase runs it)."""
    import torch
    if dev is not None and torch.device(dev).type == "cpu":
        out = []
        for i in range(n):
            t0 = time.perf_counter()
            fn(i)
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    events = []
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def ddp_worker(spec: str) -> int:
    """One rank of phase 15 (`chip_smoke.py --ddp_worker SPEC`): joins the
    group (torchrun's environment, or the spec's FileStore, rank and
    world size), runs the spec's jobs (`kinds`: (kind, shapes) pairs, in
    order, one group for all) under the trainers' deterministic cuDNN,
    and writes their results by kind to the spec's `out` (rank 0), or
    `out`.rank<r>."""
    import torch

    sys.path.insert(0, REPO)
    from sdn3d_tpu_torch import parallel
    from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn

    job = torch.load(spec, weights_only=False)
    dev = parallel.initialize_multihost(
        job["device"], backend=job.get("backend"),
        init_method=job.get("init", "env://"), rank=job.get("rank"),
        world_size=job.get("world"))
    try:
        out = {}
        for kind, shapes in job["kinds"]:
            with deterministic_cudnn():
                out[kind] = {"derender": ddp_derender,
                             "semantic": ddp_semantic}[kind](
                    dict(job, shapes=shapes), dev, parallel)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out.update(rank=parallel.rank(), world=parallel.world_size(),
                   backend=torch.distributed.get_backend())
    finally:
        parallel.shutdown()
    r = out["rank"]
    torch.save(out, job["out"] if r == 0 else f"{job['out']}.rank{r}")
    return 0


def run_ranks(tmp: str, tag: str, job: dict, world: int) -> list:
    """The job on `world` ranks: world 1 through torchrun (--standalone,
    one process; NCCL on the card), world > 1 as processes of their own on
    one device over gloo with a FileStore.  Returns each rank's result."""
    import torch

    out = os.path.join(tmp, f"{tag}.out")
    cmds = []
    if world == 1:
        spec = os.path.join(tmp, f"{tag}.spec")
        torch.save(dict(job, out=out), spec)
        cmds.append([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", "1", __file__,
                     "--ddp_worker", spec])
    else:
        for r in range(world):
            spec = os.path.join(tmp, f"{tag}.spec{r}")
            torch.save(dict(job, out=out, rank=r, world=world,
                            backend="gloo",
                            init=f"file://{os.path.join(tmp, tag + '.store')}"),
                       spec)
            cmds.append([sys.executable, __file__, "--ddp_worker", spec])
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "4"))
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"15 {tag}: a rank exited {p.returncode}:\n"
                                 f"{text[-6000:]}")
    return [torch.load(out if r == 0 else f"{out}.rank{r}",
                       weights_only=False) for r in range(world)]


def ddp_compare(tag: str, one: dict, two: list) -> str:
    """World size 2 (both ranks) against world size 1, or fail; returns a
    summary."""
    import torch
    a, b = two
    for k in a["stats"]:
        if not torch.equal(a["stats"][k], b["stats"][k]):
            raise AssertionError(f"15 {tag}: running statistic {k} differs "
                                 f"between the ranks")
    for k, v in one["losses"].items():
        if abs(a["losses"][k] - v) > DDP_LOSS_RTOL * max(abs(v), 1e-12):
            raise AssertionError(f"15 {tag}: loss {k} {a['losses'][k]} at "
                                 f"world size 2, {v} at 1")
    g1, g2 = one["grad"].double(), a["grad"].double()
    cos = float((g1 * g2).sum() / (g1.norm() * g2.norm()))
    g_err = float((g1 - g2).abs().max() / g1.abs().max())
    stat_err = max(float((a["stats"][k] - v).abs().max()
                         / max(float(v.abs().max()), 1e-12))
                   for k, v in one["stats"].items())
    p_err = float((a["params"] - one["params"]).abs().max())
    if not cos >= DDP_GRAD_COS or not stat_err <= DDP_STATS_RTOL \
            or not torch.equal(a["grad"], b["grad"]) \
            or not torch.equal(a["params"], b["params"]):
        raise AssertionError(f"15 {tag}: gradient cosine {cos} (largest "
                             f"error {g_err}), statistics {stat_err}, ranks "
                             f"equal {torch.equal(a['params'], b['params'])}")
    return (f"losses within {DDP_LOSS_RTOL} ({one['losses']}); gradient "
            f"cosine {cos:.9f}, largest error {g_err:.3e} of the largest "
            f"entry; running statistics within {stat_err:.3e}, the same "
            f"bits on both ranks; parameters after the step largest "
            f"|diff| {p_err:.3e}; both ranks' parameters the same bits")


def collectives(top, what: str = "nccl") -> tuple:
    """(launches, ms) a step of the device kernels whose name holds
    `what` (two steps profiled)."""
    rows = [v for name, v in top if what in name.lower()]
    return sum(r[1] for r in rows) / 2, sum(r[0] for r in rows)


def counted_collectives(fn):
    """fn() with torch.distributed's all_reduce and broadcast counted:
    (fn's result, the calls)."""
    import torch.distributed as dist
    calls = [0]
    found = dist.all_reduce, dist.broadcast

    def wrap(f):
        def g(*a, **kw):
            calls[0] += 1
            return f(*a, **kw)
        return g

    dist.all_reduce, dist.broadcast = (wrap(f) for f in found)
    try:
        return fn(), calls[0]
    finally:
        dist.all_reduce, dist.broadcast = found


def ddp_phase(args, card: str, shapenet: str, tmp: str,
              mark=lambda what: None) -> None:
    """Phase 15, under the trainers' deterministic cuDNN: 15a
    geometric_train's step at the JAX CLI's defaults (batch 16, image 256,
    render 384, mode full, a mask loss) through torchrun --nproc_per_node
    1 (NCCL): B1 / B3 / B2 launches a step, ms a step beside the same
    step with no process group (this process), the collectives' launches
    and device ms a step; 15b the same step in two ranks on the one card
    over gloo (8 a rank) against 15a's first step; 15c both for
    semantic_train at its defaults (batch 8, crop 256).  One run at each
    world size steps both trainers, derenderer first."""
    import torch

    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import DeviceMeshBank
    from sdn3d_tpu_torch.pipelines.derender import deterministic_cudnn

    dev = torch.device(DDP_DEVICE)
    S = TRAIN_SHAPES
    # the step with no process group, in this process
    with deterministic_cudnn():
        bank = DeviceMeshBank.from_host(load_shapenet_bank(shapenet), dev)
        trainer = new_trainer(bank, args.seed, dev, shapes=S)
        batch = train_batch(args.seed, dev, S)
        state = trainer.init()
        for i in range(DDP_WARM):
            state, _ = trainer.train_step(state, batch, step_generator(
                args.seed, 1 + i, dev))

        def one(i):
            nonlocal state
            state, _ = trainer.train_step(state, batch, step_generator(
                args.seed, 1 + DDP_WARM + i, dev))

        alone_ms = timed_steps(one, DDP_STEPS, dev)
        del trainer, state, bank, batch
        s_args = sem_args(os.path.join(tmp, "ddp_sem"), args.seed,
                          **DDP_SEM_SHAPES)
        from sdn3d_tpu_torch.cli.semantic_train import build_trainer
        s_args.device = str(dev)
        s_trainer = build_trainer(s_args)
        s_batch = sem_batch(s_args, args.seed, dev)
        s_state = s_trainer.init()
        for i in range(DDP_WARM):
            s_state, _ = s_trainer.train_step(s_state, *s_batch,
                                              step_generator(args.seed,
                                                             1 + i, dev))

        def s_one(i):
            nonlocal s_state
            s_state, _ = s_trainer.train_step(
                s_state, *s_batch,
                step_generator(args.seed, 1 + DDP_WARM + i, dev))

        s_alone_ms = timed_steps(s_one, DDP_STEPS, dev)
        del s_trainer, s_state, s_batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mark("15. steps with no process group")

    base = {"device": DDP_DEVICE, "seed": args.seed, "shapenet": shapenet,
            "ckpt": os.path.join(tmp, "ddp_sem"),
            "kinds": [("derender", S), ("semantic", DDP_SEM_SHAPES)]}
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    t0 = time.perf_counter()
    (g1s,) = run_ranks(tmp, "15-1", dict(base, time=True), 1)
    run1_s = time.perf_counter() - t0
    if g1s["world"] != 1 or (DDP_DEVICE == "cuda"
                             and g1s["backend"] != "nccl"):
        raise AssertionError(f"15: world {g1s['world']}, backend "
                             f"{g1s['backend']}")
    for tag, kind, shapes, alone in (
            ("15a", "derender", S, alone_ms),
            ("15c", "semantic", DDP_SEM_SHAPES, s_alone_ms)):
        g1 = g1s[kind]
        n_coll, coll_ms = collectives(g1["top"])
        n_copy, copy_ms = collectives(g1["top"], "memcpy dtod")
        extra = ""
        if kind == "derender":
            want = [1, 1, 1] if dev.type == "cuda" else [1, 2, 1]
            if g1["launches"] != want:
                raise AssertionError(f"{tag}: launches a step "
                                     f"{g1['launches']}, need {want}")
            extra = (f"B1 / B3 / B2 launches a step {g1['launches']}; ")
        if g1["calls"] < 1:
            raise AssertionError(f"{tag}: no collective in a step")
        log(f"[ddp-{tag}] {kind} step at {shapes} under torchrun "
            f"--nproc_per_node 1 ({g1s['backend']}): {extra}ms a step median "
            f"{med(g1['ms']):.3f} (min {min(g1['ms']):.3f}, max "
            f"{max(g1['ms']):.3f}) against {med(alone):.3f} (min "
            f"{min(alone):.3f}, max {max(alone):.3f}) with no process group "
            f"(this process); device busy {g1['busy']:.3f} ms a step; "
            f"{g1['calls']} collectives a step (all_reduce / broadcast "
            f"calls), their NCCL kernels {n_coll:g} launches and "
            f"{coll_ms:.4f} ms a step, device-to-device copies {n_copy:g} "
            f"and {copy_ms:.4f} ms a step; "
            f"losses {g1['losses']}; the run (both trainers) {run1_s:.1f} s "
            f"({card})")
        for name, (ms_, n) in [kv for kv in g1["top"]
                               if "nccl" in kv[0].lower()][:4]:
            log(f"[ddp-{tag}] collective kernel {name}: {ms_:.4f} ms, "
                f"{n / 2:g} launches a step")
    mark("15a/15c")
    t0 = time.perf_counter()
    two = run_ranks(tmp, "15-2", base, 2)
    run2_s = time.perf_counter() - t0
    for tag, kind, shapes in (("15b", "derender", S),
                              ("15c-2", "semantic", DDP_SEM_SHAPES)):
        summary = ddp_compare(tag, g1s[kind], [r[kind] for r in two])
        log(f"[ddp-{tag}] {kind} step at world size 2 ({two[0]['backend']}, "
            f"two ranks on one device, {shapes['batch_size'] // 2} a rank) "
            f"against world size 1: {summary}; the run (both trainers) "
            f"{run2_s:.1f} s ({card})")
    mark("15b/15c-2")

# ---------------------------------------------------------------------------
# 16. the rest of the library: render() of the RGB type through B1, the
# face-chunk silhouette gradient, an interactive edit session
# ---------------------------------------------------------------------------
RGB_SIZE = 384            # render size: 768^2 rasterization, as phase 4's
RGB_TEXTURE = 4
RGB_PLAIN_IMAGES = 1      # images of the plain version's comparison
RGB_TIME = 5
CHUNK_TOL = 1e-3          # tests/test_torch_silhouette_chunk.py's bound
UI_SHAPE = (384, 1248)    # the Cityscapes-layout frames: 624 x 192 items
UI_PREVIEWS = 4
LIB_DEVICE = "cuda"
VIEW_ANGLE = 29.6         # the slots' viewing angle (degrees)
# 16d: Renderer's image size without anti-aliasing, so that B1 / B3 / B2
# run at the serving shape (16 slots, 768^2); look_at and FFD on the card
# against the CPU (float32, TF32 off; values of order 1)
NAMES_SIZE = 768
NAMES_ATOL = 1e-5


def posed_slots(bank, seed: int, dev):
    """16 slots of phase 4's meshes (each class twice), posed in front of
    the camera as phase 3 poses its car: (vertices, faces, face_valid,
    viewing angles)."""
    import torch

    from sdn3d_tpu_torch.geometry.transforms import perspective_transform
    rng = np.random.RandomState(seed)
    cls = torch.arange(16, device=dev) % bank.vertices.shape[0]
    th = torch.from_numpy(rng.uniform(-np.pi, np.pi, 16).astype(np.float32))
    rot = torch.stack([torch.cos(th / 2), 0 * th, torch.sin(th / 2), 0 * th],
                      1).to(dev)
    trans = torch.from_numpy(np.stack([
        rng.uniform(-1.5, 1.5, 16), rng.uniform(-0.5, 0.5, 16),
        rng.uniform(-16, -8, 16)], 1).astype(np.float32)).to(dev)
    verts, _ = perspective_transform(
        bank.vertices[cls.long()], scales=torch.full((16, 3), 1.5, device=dev),
        rotations=rot, translations=trans, perspective_translations=trans,
        zoom_tos=torch.full((16, 1), 384 / 1450.0, device=dev))
    return (verts, bank.faces[cls.long()], bank.face_valid[cls.long()],
            torch.full((16,), VIEW_ANGLE, device=dev))


def rgb_scene(bank, seed: int, dev):
    """posed_slots with random texture cubes: (vertices, faces,
    face_valid, viewing angles, textures)."""
    import torch
    F = bank.faces.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    tex = torch.rand((16, F, RGB_TEXTURE, RGB_TEXTURE, RGB_TEXTURE, 3),
                     generator=g, device=dev)
    return posed_slots(bank, seed, dev) + (tex,)


def write_cityscapes_textural_root(root: str, seed: int) -> None:
    """A Cityscapes-layout root for data/textural_cityscapes (the JAX
    tests' fixture, tests/test_textural_cityscapes.py, at UI_SHAPE): two
    frames of road / sky / two cars, gtFine label and instance ids, the
    annotations JSON."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    Hh, Ww = UI_SHAPE
    ann = {"images": []}
    city = os.path.join(root, "gtFine", "train", "darmstadt")
    os.makedirs(city, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for k in range(2):
        name = f"darmstadt_00000{k}_000019"
        fn = f"{name}_leftImg8bit.png"
        ann["images"].append({"file_name": fn,
                              "seg_file_name": f"{name}_gtFine_instanceIds.png"})
        Image.fromarray(rng.randint(0, 255, (Hh, Ww, 3), np.uint8)).save(
            os.path.join(root, "images", fn))
        label = np.full((Hh, Ww), 7, np.uint8)              # road
        label[:Hh // 3] = 23                                # sky
        inst = label.astype(np.int32)
        for j, (y, x) in enumerate(((200, 200), (240, 700))):
            label[y:y + 90, x:x + 260] = 26                 # car
            inst[y:y + 90, x:x + 260] = 26000 + j
        Image.fromarray(label).save(os.path.join(
            city, f"{name}_gtFine_labelIds.png"))
        Image.fromarray(inst.astype(np.uint16)).save(os.path.join(
            city, f"{name}_gtFine_instanceIds.png"))
    with open(os.path.join(root, "annotations",
                           "instancesonly_gtFine_train.json"), "w") as f:
        json.dump(ann, f)


def library_phase(args, card: str, shapenet: str, tmp: str, faces128,
                  mark=lambda what: None) -> None:
    """Phase 16.  16a: render() of the RGB type on 16 slots of phase 4's
    39.6k-face meshes at RGB_SIZE (768^2 rasterization) with random
    texture cubes (size 4): one B1 launch a render and no plain forward,
    the RGB of RGB_PLAIN_IMAGES images equal to the plain version's on the
    card, the texture gradient the same bits on two runs, the times;
    16b: the face-chunk silhouette gradient (plain PyTorch) against the
    pixelwise one (B3 + B2, walk to the border) on phase 3's 2 x 37 faces
    at 128^2; 16c: an EditSession over a Cityscapes-layout root (a label
    click, a stroke, an object paste, style_forward's UI_PREVIEWS previews
    through the full-width generator at 192x624, undo), ms a preview."""
    import torch

    from sdn3d_tpu_torch.data.textural_cityscapes import \
        TexturalCityscapesDataset
    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import DeviceMeshBank
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.pipelines import interactive as UI
    from sdn3d_tpu_torch.pipelines.textural import (TexturalConfig,
                                                    TexturalTrainer)
    from sdn3d_tpu_torch.render.renderer import RenderType, render

    dev = torch.device(LIB_DEVICE)
    # -- 16a. render() RGB ---------------------------------------------------
    bank = DeviceMeshBank.from_host(load_shapenet_bank(shapenet), dev)
    verts, faces, valid, angle, tex = rgb_scene(bank, args.seed, dev)
    kw = dict(image_size=RGB_SIZE, viewing_angle=angle)
    launch = TC.rasterize_face_index_cuda
    launch.launches = TR.rasterize_face_maps.calls = 0
    rgb = render(verts, faces, RenderType.RGB, valid, textures=tex, **kw)
    torch.cuda.synchronize()
    n_launch, n_plain = launch.launches, TR.rasterize_face_maps.calls
    if (n_launch, n_plain) != (1, 0):
        raise AssertionError(f"16a: B1 launches {n_launch}, plain forwards "
                             f"{n_plain} for one RGB render")
    cover = float((rgb.abs().sum(1) > 0).float().mean())
    if rgb.shape != (16, 3, RGB_SIZE, RGB_SIZE) or not torch.isfinite(
            rgb).all() or not 0.01 < cover < 0.99:
        raise AssertionError(f"16a: rgb {tuple(rgb.shape)}, coverage {cover}")
    # the plain version: the same render with the plain forward
    n = RGB_PLAIN_IMAGES
    dispatch = TC.rasterize_face_index
    TC.rasterize_face_index = lambda f, v, s, near=TR.DEFAULT_NEAR, \
        far=TR.DEFAULT_FAR, colors=None: TR.rasterize_face_maps(f, v, s,
                                                                near, far)
    try:
        t0 = time.perf_counter()
        plain = render(verts[:n], faces[:n], RenderType.RGB, valid[:n],
                       textures=tex[:n], image_size=RGB_SIZE,
                       viewing_angle=angle[:n])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        TC.rasterize_face_index = dispatch
    rgb_err = float((rgb[:n] - plain).abs().max())
    if not rgb_err <= 1e-6:
        raise AssertionError(f"16a: kernel RGB against plain: {rgb_err}")
    cot = torch.randn(rgb.shape, generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev)

    def grad():
        t = tex.clone().requires_grad_(True)
        out = render(verts, faces, RenderType.RGB, valid, textures=t, **kw)
        return torch.autograd.grad((out * cot).sum(), t)[0]

    g1, g2 = grad(), grad()
    if not torch.equal(g1, g2) or not float(g1.abs().sum()) > 0:
        raise AssertionError("16a: the texture gradient differs between two "
                             "runs (or is zero)")
    fwd_ms = timed_steps(lambda i: render(verts, faces, RenderType.RGB,
                                          valid, textures=tex, **kw),
                         RGB_TIME, dev)
    bwd_ms = timed_steps(lambda i: grad(), RGB_TIME, dev)
    busy, top = device_time(lambda: render(verts, faces, RenderType.RGB,
                                           valid, textures=tex, **kw), 1)
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    log(f"[rgb-16a] render() RGB, 16 slots x {faces.shape[1]} faces (2F = "
        f"{2 * faces.shape[1]} with fill_back), {2 * RGB_SIZE}^2 "
        f"rasterization, texture cubes {RGB_TEXTURE}^3: one B1 launch, no "
        f"plain forward; coverage {cover:.4f}; {n} images against the plain "
        f"forward ({plain_s:.1f} s) max |diff| {rgb_err:.3e}; the texture "
        f"gradient the same bits on two runs; forward median "
        f"{med(fwd_ms):.3f} ms (min {min(fwd_ms):.3f}), device busy "
        f"{busy:.3f} ms; forward + texture gradient median {med(bwd_ms):.3f} "
        f"ms (min {min(bwd_ms):.3f}) ({card})")
    for name, (ms_, k) in top[:6]:
        log(f"[rgb-16a] kernel {name[:90]}: {ms_:.4f} ms, {k} launches")
    del tex, g1, g2, rgb, plain, bank
    torch.cuda.empty_cache()
    mark("16a. RGB render")

    # -- 16b. the face-chunk gradient against the pixelwise one -------------
    sf, sv, sfi, scot = faces128
    salpha = (sfi >= 0).float()
    chunk = TR.silhouette_grad_chunked(sf, sv, sfi, salpha, scot, 128,
                                       TR.DEFAULT_EPS)
    launch_w = TC.walk_grads_cuda.launches
    pix = TR.silhouette_grad_pixelwise(sf, sfi, salpha, scot, 128,
                                       TR.DEFAULT_EPS, walk=0)
    torch.cuda.synchronize()
    c_err = float((chunk - pix).abs().max())
    scale = float(chunk.abs().max())
    if TC.walk_grads_cuda.launches != launch_w + 1 or not scale > 0 or \
            not torch.allclose(pix, chunk, rtol=CHUNK_TOL, atol=CHUNK_TOL):
        raise AssertionError(f"16b: face-chunk gradient against pixelwise: "
                             f"max |diff| {c_err} (max |g| {scale})")
    log(f"[chunk-16b] face-chunk silhouette gradient of 2 x 37 faces @128^2 "
        f"against the pixelwise one (B3 + B2, walk 128): max |diff| "
        f"{c_err:.3e}, max |g| {scale:.4g}, within {CHUNK_TOL}")
    mark("16b. face-chunk gradient")

    # -- 16c. an interactive edit session ------------------------------------
    root = os.path.join(tmp, "ui_cityscapes")
    write_cityscapes_textural_root(root, args.seed)
    cfg = TexturalConfig()
    ds = TexturalCityscapesDataset(root, "train", load_size=624,
                                   fine_wh=(624, 192),
                                   max_instances=cfg.max_instances)
    item = ds.__getitem__(0, np.random.RandomState(args.seed))
    rng = np.random.RandomState(args.seed)
    clusters = {c: rng.uniform(-1, 1, (5, cfg.feat_num)).astype(np.float32)
                for c in (7, 11, 23, 26)}
    st = UI.load_state(item["label"], item["inst"], clusters,
                       pose=item["pose"], normal=item["normal"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        trainer = TexturalTrainer(cfg)
    generate = UI.textural_generate(trainer.to(dev))
    sess = UI.EditSession(st)
    cars = sorted(int(v) for v in np.unique(item["inst"]) if v >= 26000)
    car0 = tuple(int(a[0]) for a in np.nonzero(item["inst"] == cars[0]))
    road = tuple(int(a[-1]) for a in np.nonzero(item["label"] == 1))
    sess.apply(UI.change_labels_click, car0, road)
    if (sess.state.inst == cars[0]).any():
        raise AssertionError("16c: the label click left the instance")
    sess.apply(UI.add_strokes, (20, 30), 11, 24, clusters, 2)
    mask = np.zeros((40, 90), bool)
    mask[5:35, 5:85] = True
    sess.apply(UI.add_objects_click, (130, 400), 26, mask, clusters, 3)
    before = sess.state.copy()
    car1 = tuple(int(a[0]) for a in np.nonzero(sess.state.inst == cars[1]))
    t0 = time.perf_counter()
    previews, _, crop = UI.style_forward(sess.state, car1, clusters, generate,
                                         multiple_output=UI_PREVIEWS)
    preview_ms = (time.perf_counter() - t0) * 1e3 / len(previews)
    t0 = time.perf_counter()
    previews2, _, _ = UI.style_forward(sess.state, car1, clusters, generate,
                                       multiple_output=UI_PREVIEWS)
    preview2_ms = (time.perf_counter() - t0) * 1e3 / len(previews2)
    full, committed, _ = UI.style_forward(sess.state, car1, clusters,
                                          generate, style_id=1)
    sess.apply(lambda s: committed)
    sess.undo()
    same = all(np.array_equal(getattr(sess.state, f), getattr(before, f))
               for f in ("label", "inst", "pose"))
    (y0, x0, y1, x1) = crop
    if len(previews) != UI_PREVIEWS or not same or any(
            p.shape != (y1 - y0, x1 - x0, 3) or not np.isfinite(p).all()
            for p in previews) or full[0].shape != (192, 624, 3) \
            or not np.abs(previews[0] - previews[1]).max() > 0 \
            or not all(np.array_equal(a, b)
                       for a, b in zip(previews, previews2)):
        raise AssertionError(f"16c: previews {[p.shape for p in previews]}, "
                             f"crop {crop}, undo restored {same}")
    log(f"[ui-16c] EditSession over a Cityscapes-layout item (624x192): label "
        f"click, stroke, object paste, style_forward {UI_PREVIEWS} previews "
        f"of crop {crop} through the full-width generator: "
        f"{preview_ms:.2f} ms a preview (first call), {preview2_ms:.2f} ms "
        f"(second, the same bits), the styles differ; commit, undo restores "
        f"the state ({card})")
    mark("16c. interactive session")
    names_phase(args, card, shapenet, tmp, mark)


@contextlib.contextmanager
def torch_deterministic():
    """torch's deterministic algorithms (warn_only: an op without one
    warns and runs as it is) for the block, the flags found restored."""
    import torch
    found = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(found[0], warn_only=found[1])


def names_phase(args, card: str, shapenet: str, tmp: str,
                mark=lambda what: None) -> None:
    """16d: the reference's library names on the card at the serving
    shape (posed_slots: 16 slots of phase 4's 39.6k-face meshes, 768^2).
    Renderer(NAMES_SIZE, anti_aliasing=False)'s Silhouette forward and
    backward launch B1, B3 (walk to the border) and B2 once each and no
    plain version, and give render()'s bits with the same arguments (both
    under torch's deterministic algorithms: the vertex gather's backward
    adds with atomics otherwise); look_at of the meshes from eyes of
    get_points_from_angles, and FFD.from_vertices(...)(coeff), within
    NAMES_ATOL of the CPU; trace() around one render() writes a Chrome
    trace that holds B1's raster kernel."""
    import torch

    from sdn3d_tpu_torch.geometry import FFD, look_at
    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.geometry.camera import get_points_from_angles
    from sdn3d_tpu_torch.models.derenderer import DeviceMeshBank
    from sdn3d_tpu_torch.ops import rasterize as TR
    from sdn3d_tpu_torch.ops import rasterize_cuda as TC
    from sdn3d_tpu_torch.render import Renderer, RenderType, render
    from sdn3d_tpu_torch.utils.profiling import trace

    dev = torch.device(LIB_DEVICE)
    host = load_shapenet_bank(shapenet)
    bank = DeviceMeshBank.from_host(host, dev)
    verts, faces, valid, _ = posed_slots(bank, args.seed, dev)
    S = NAMES_SIZE
    renderer = Renderer(image_size=S, viewing_angle=VIEW_ANGLE,
                        anti_aliasing=False)
    cot = torch.randn((16, 1, S, S), generator=torch.Generator(
        device=dev).manual_seed(args.seed + 1), device=dev)
    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain, TR.edge_invariant_stack,
             TR.face_pixel_coords)

    def silhouette(fn):
        v = verts.detach().clone().requires_grad_(True)
        sil = fn(v)
        g, = torch.autograd.grad((sil * cot).sum(), v)
        torch.cuda.synchronize()
        return sil.detach(), g

    def by_renderer(v):
        return renderer(v, faces, RenderType.Silhouette, valid)

    def by_render(v):
        return render(v, faces, RenderType.Silhouette, valid, image_size=S,
                      viewing_angle=VIEW_ANGLE, anti_aliasing=False)

    with torch_deterministic():
        for fn in kernels:
            fn.launches = 0
        for fn in plain:
            fn.calls = 0
        t0 = time.perf_counter()
        sil_r, g_r = silhouette(by_renderer)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = [fn.launches for fn in kernels]
        p_counts = [fn.calls for fn in plain]
        sil_f, g_f = silhouette(by_render)
    cover = float(sil_r.mean())
    if counts != [1, 1, 1] or any(p_counts):
        raise AssertionError(f"16d: Renderer's forward and backward launched "
                             f"B1 / B3 / B2 {counts}, plain calls {p_counts}")
    if sil_r.shape != (16, 1, S, S) or not 0.01 < cover < 0.99 \
            or not torch.isfinite(g_r).all() or not g_r.abs().max() > 0:
        raise AssertionError(f"16d: silhouette {tuple(sil_r.shape)} coverage "
                             f"{cover}, gradient finite "
                             f"{bool(torch.isfinite(g_r).all())}")
    if not torch.equal(sil_r, sil_f) or not torch.equal(g_r, g_f):
        raise AssertionError(
            f"16d: Renderer against render(): silhouette max |diff| "
            f"{float((sil_r - sil_f).abs().max())}, vertex gradient "
            f"{float((g_r - g_f).abs().max())}")
    # the same two without the deterministic algorithms, for the record
    g_a = silhouette(by_renderer)[1]
    g_b = silhouette(by_render)[1]
    free_diff = float((g_a - g_b).abs().max())
    log(f"[names-16d] Renderer(image_size={S}, anti_aliasing=False) "
        f"Silhouette of 16 slots x {faces.shape[1]} faces @{S}^2 (walk to "
        f"the border): forward + backward {wall_ms:.1f} ms (first call), "
        f"B1 / B3 / B2 launches {counts}, plain calls {p_counts}; coverage "
        f"{cover:.4f}; silhouette and vertex gradient (max |g| "
        f"{float(g_r.abs().max()):.4g}) the same bits as render() under "
        f"torch's deterministic algorithms; without them the two gradients "
        f"differ by {free_diff:.3g} ({card})")

    # look_at from get_points_from_angles, and FFD, card against CPU
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.RandomState(args.seed)
        angles = [rng.uniform(a, b, 16).astype(np.float32)
                  for a, b in ((2.0, 3.0), (-20.0, 40.0), (-180.0, 180.0))]
        v_host = torch.from_numpy(host.vertices[np.arange(16) % len(
            host.vertices)])
        coeff = torch.from_numpy((rng.randn(16, 3 * 64) * 0.1).astype(
            np.float32))
        n0 = int(host.num_vertices[0])

        def camera_and_ffd(d):
            eye = get_points_from_angles(
                *(torch.from_numpy(a).to(d) for a in angles))
            seen = look_at(v_host.to(d), eye)
            ffd = FFD.from_vertices(host.vertices[0, :n0], device=d)
            return eye.cpu(), seen.cpu(), ffd(coeff.to(d)).cpu()

        on_card, on_cpu = camera_and_ffd(dev), camera_and_ffd("cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    errs = [float((a - b).abs().max()) for a, b in zip(on_card, on_cpu)]
    if not all(e <= NAMES_ATOL for e in errs) or not all(
            torch.isfinite(t).all() for t in on_card):
        raise AssertionError(f"16d: card against CPU: get_points_from_angles "
                             f"{errs[0]}, look_at {errs[1]}, FFD {errs[2]} "
                             f"(bound {NAMES_ATOL})")
    log(f"[names-16d] card against CPU (float32, TF32 off): "
        f"get_points_from_angles max |diff| {errs[0]:.3g}, look_at of "
        f"{tuple(on_card[1].shape)} vertices {errs[1]:.3g} (scale "
        f"{float(on_cpu[1].abs().max()):.3g}), FFD.from_vertices(...)(coeff) "
        f"{tuple(on_card[2].shape)} {errs[2]:.3g} (bound {NAMES_ATOL})")

    # trace() around one render()
    log_dir = os.path.join(tmp, "trace_16d")
    with trace(log_dir):
        by_render(verts)
        torch.cuda.synchronize()
    files = sorted(os.listdir(log_dir))
    size, text = 0, ""
    if files:
        size = os.path.getsize(os.path.join(log_dir, files[0]))
        with open(os.path.join(log_dir, files[0])) as fh:
            text = fh.read()
    if len(files) != 1 or not size or "raster_binned_kernel" not in text:
        raise AssertionError(f"16d: trace() wrote {files} ({size} B), B1's "
                             f"kernel in it: {'raster_binned_kernel' in text}")
    log(f"[names-16d] trace() around one render(): {files[0]}, {size} B, "
        f"B1's raster kernel in it ({card})")
    del bank, verts, cot, sil_r, sil_f, g_r, g_f, g_a, g_b
    torch.cuda.empty_cache()
    mark("16d. library names")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ddp_worker", default=None,
                    help=argparse.SUPPRESS)   # one rank of phase 15
    args = ap.parse_args(argv)
    if args.ddp_worker:
        return ddp_worker(args.ddp_worker)

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
    from sdn3d_tpu_torch.utils.flops import device_peaks
    if device_peaks() is None:
        log(f"FAILED: no peaks for {torch.cuda.get_device_name(0)} in "
            f"sdn3d_tpu_torch/utils/flops.PEAKS")
        return 2
    PEAK.update(device_peaks())
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
            if "n" in rec:
                log(f"[phases] {tag} counter {name}: {rec['n']}")
                continue
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
        det_ckpt = detection_phase(args, card, frames, shapenet, tmp, mark)
        # -- 11. derenderer training at full width ---------------------------
        t_launches = training_phase(args, card, frames, shapenet, tmp, mark)
        # -- 13. semantic training and the kitti / cityscapes datasets ------
        semantic_phase(args, card, shapenet, tmp, mark)
        # -- 14. Mask R-CNN training ------------------------------------------
        detect_train_phase(args, card, frames, shapenet, tmp, det_ckpt, mark)
        # -- 15. geometric_train / semantic_train under a process group ------
        ddp_phase(args, card, shapenet, tmp, mark)
        # -- 16. render() RGB, the face-chunk gradient, interactive edits ----
        library_phase(args, card, shapenet, tmp, (sf, sv, sfi, scot), mark)

    # -- 5. kernels vs plain at the main paths' shapes ------------------------
    cf, cv, cs, cc = (captured["faces"], captured["valid"], captured["size"],
                      captured["colors"])
    err, hits, plain_ms = compare(TC, TR, cf, cv, cs, cc, PLAIN_SLOTS)
    max_err = max(max_err, err)
    bins = check_bins(TC, cf, cv, cs, lists=False)
    slot_idx = torch.as_tensor(PLAIN_SLOTS, device=dev)
    sf_, sv_, sc_ = (cf[slot_idx].contiguous(), cv[slot_idx].contiguous(),
                     None if cc is None else cc[slot_idx].contiguous())
    slots_ms = cuda_ms(lambda: launch(sf_, sv_, cs, colors=sc_), iters=20,
                       warmup=3)
    log(f"[kernel] main-path inputs {tuple(cf.shape)} @{cs}^2: the kernel's "
        f"slots {PLAIN_SLOTS} equal to the plain version's ({hits} covered "
        f"pixels); bin boxes == pack_faces boxes; on those "
        f"{len(PLAIN_SLOTS)} slots alone: kernel {slots_ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms ({card})")
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
    t_bytes = nbytes / PEAK["hbm"] * 1e3
    t_ops = pairs * EDGE_TEST_FLOPS / PEAK["float32"] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    log(f"[kernel] {ms:.4f} ms/launch, plain {plain_ms:.1f} ms (on "
        f"{len(PLAIN_SLOTS)} of the {B} slots); bound "
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
        (w_bytes / PEAK["hbm"] * 1e3, "bytes"),
        (w_ops / PEAK["float32"] * 1e3, "operations"))
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
        (r_bytes / PEAK["hbm"] * 1e3, "bytes"),
        (r_ops / PEAK["float32"] * 1e3, "operations"))
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
    cond_kernel = chain_phase(args, card, mark)
    # -- 12. textural training (12e inside phase 10) -------------------------
    textural_phase(args, card, mark)
    # -- 10. the per-stage file contract --------------------------------------
    file_contract_phase(args, card, mark, textural=True)

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
    }, cond_kernel]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
