"""Fused single-process edit benchmark, PyTorch port.

Runs the edit protocol — semantic labels, geometric de-render + edit +
re-render, textural regeneration, L1 / LPIPS / SSIM / PSNR against the
target — in ONE process with all three branch models resident on
`--device` (default cuda; pipelines/chain.py), instead of the reference's
three processes glued by PNG files (README.md:153-189).  Writes
RESULTS_DIR/benchmark.json and an HTML gallery; `--dump_dirs` also writes
the per-stage file contract (and fetches the full-resolution planes).

    python -m sdn3d_tpu_torch.cli.edit_chain --edit_json E.json \\
        --data_root VKITTI_ROOT --shapenet_root SHAPENET_ROOT \\
        [--source maskrcnn [--maskrcnn_ckpt mrcnn.pth]] \\
        [--batch_pairs N [--pipeline]] [--compute_dtype bfloat16] \\
        [--lpips_ckpt vgg.pth] [--full_fetch]

--source gt (the default) reads each source frame's objects from the
VKITTI ground truth; --source maskrcnn detects them with Mask R-CNN.
--semantic_ckpt, --derender_ckpt, --textural_ckpt and --maskrcnn_ckpt
each take what the per-stage CLI's checkpoint argument takes: a
checkpoint directory (core/checkpoint) or a torch file written from JAX
variables by utils/port; a model without one gets random weights from
--seed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--edit_json", required=True)
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--shapenet_root",
                   default=os.environ.get("SHAPENET_ROOT_DIR"))
    p.add_argument("--source", choices=["gt", "maskrcnn"], default="gt")
    p.add_argument("--semantic_ckpt", default=None,
                   help="semantic_test's --ckpt_dir")
    p.add_argument("--derender_ckpt", default=None,
                   help="geometric_main's --ckpt_dir")
    p.add_argument("--textural_ckpt", default=None,
                   help="edit_benchmark's --ckpt_dir")
    p.add_argument("--maskrcnn_ckpt", default=None,
                   help="geometric_main's --maskrcnn_ckpt")
    p.add_argument("--results_dir", default="./benchmark_chain_out")
    p.add_argument("--dump_dirs", default=None,
                   help="write the standard file contract under "
                        "DIR/segm and DIR/geo as a side effect")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch_pairs", type=int, default=1,
                   help="process N pairs per device pass "
                        "(EditChain.edit_frames): one render of the N "
                        "frames' slots and one generator forward per "
                        "chunk; the last chunk is padded by repetition and "
                        "the padded outputs are dropped")
    p.add_argument("--pipeline", action="store_true",
                   help="overlap chunks in a 3-deep software pipeline "
                        "(EditChain.edit_frames_pipelined): the next "
                        "chunks' semantic/encode and render run on the card "
                        "while the host conditions and scores the current "
                        "one; the outputs are those of the serial path")
    # stage shape knobs (defaults = the per-stage CLI defaults)
    p.add_argument("--scales", type=int, nargs="+",
                   default=[100, 150, 200, 300, 375])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--render_size", type=int, default=384)
    p.add_argument("--num_opts", type=int, default=0)
    p.add_argument("--mode", default="extend")
    p.add_argument("--load_size", type=int, default=624)
    p.add_argument("--fine_width", type=int, default=624)
    p.add_argument("--fine_height", type=int, default=192)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="convolution dtype of the semantic model, the "
                        "derenderer trunk and the textural nets (parameters, "
                        "BatchNorm, logits and outputs stay float32)")
    p.add_argument("--full_fetch", action="store_true",
                   help="fetch the full-resolution geometric planes per pair "
                        "instead of the device-downsized serving planes "
                        "(automatic with --dump_dirs; the outputs are the "
                        "same)")
    p.add_argument("--phases", action="store_true",
                   help="record a per-phase wall-clock + transfer-byte "
                        "breakdown (utils/phases.py) into the result JSON; "
                        "synchronises the card between phases")
    p.add_argument("--lpips_ckpt", default=None,
                   help="LPIPS checkpoint (.pth, official lpips package "
                        "layout); without it the LPIPS column uses a "
                        "random-init backbone (uncalibrated)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights of every model whose "
                        "checkpoint is not given")
    return p


def main(argv=None):
    from PIL import Image

    from sdn3d_tpu_torch.cli.geometric_main import _keep_largest
    from sdn3d_tpu_torch.data import vkitti as VK
    from sdn3d_tpu_torch.data.textural_data import transform_image
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain
    from sdn3d_tpu_torch.utils import metrics, phases
    from sdn3d_tpu_torch.utils.visualizer import HTMLGallery, tensor2im

    args = build_argparser().parse_args(argv)
    if args.phases:
        phases.reset(True)
    cfg = ChainConfig(scales=tuple(args.scales), image_size=args.image_size,
                      render_size=args.render_size, num_opts=args.num_opts,
                      mode=args.mode, load_size=args.load_size,
                      fine_width=args.fine_width,
                      fine_height=args.fine_height,
                      compute_dtype=args.compute_dtype,
                      small_fetch=not (args.full_fetch or args.dump_dirs))
    chain = EditChain.build(
        cfg, args.shapenet_root, semantic_ckpt=args.semantic_ckpt,
        derender_ckpt=args.derender_ckpt, textural_ckpt=args.textural_ckpt,
        maskrcnn_ckpt=args.maskrcnn_ckpt,
        with_detector=(args.source == "maskrcnn"), device=args.device,
        seed=args.seed)

    items = VK.benchmark_split(VK.load_edit_json(args.edit_json))
    if args.limit:
        items = items[:args.limit]
    table_inst = (VK.get_tables("inst", args.data_root)
                  if args.source == "gt" else None)
    gallery = HTMLGallery(args.results_dir, "fused edit benchmark")
    wh = (args.fine_width, args.fine_height)

    lpips_model = (metrics.load_lpips(args.lpips_ckpt, device=args.device)
                   if args.lpips_ckpt else None)
    l1s, lpipss, ssims, psnrs = [], [], [], []
    pair_times = []    # (seconds, pairs) per processed chunk
    dets_cache = {}    # GT decode per source (scenegt PNG + LUT walk)
    scoring_s = 0.0    # metric/gallery/dump cost, not part of the edit
    batch_n = max(1, args.batch_pairs)

    def build_request(item):
        frame = int(item.source)
        image = np.asarray(Image.open(VK.rgb_path(
            args.data_root, item.world, item.topic, frame)).convert("RGB"))
        dets = None         # --source maskrcnn: the chain detects
        if table_inst is not None:
            dets = dets_cache.get(item.source_name)
            if dets is None:
                dets = _keep_largest(chain.infer_cfg, *VK.gt_objects(
                    args.data_root, item.world, item.topic, frame,
                    table_inst))
                dets_cache[item.source_name] = dets
        return {"image_rgb": image, "operations": item.operations,
                "dets": dets, "cache_key": item.source_name}

    chunk_lists = [items[c0:c0 + batch_n]
                   for c0 in range(0, len(items), batch_n)]

    def padded(requests):
        # the tail chunk is padded by repetition: every chunk has the same
        # shape; the padded outputs are dropped
        return requests + [requests[-1]] * (batch_n - len(requests))

    def run_serial():
        for chunk in chunk_lists:
            tp = time.perf_counter()
            requests = [build_request(it) for it in chunk]
            if batch_n == 1:
                r = requests[0]
                outs = [chain.edit_frame(r["image_rgb"],
                                         operations=r["operations"],
                                         dets=r["dets"],
                                         cache_key=r["cache_key"])]
            else:
                outs = chain.edit_frames(padded(requests))[:len(requests)]
            pair_times.append((time.perf_counter() - tp, len(chunk)))
            yield chunk, outs

    def run_pipelined():
        # the requests are built lazily, so the pipeline holds at most its
        # three chunks in host memory
        chunks = (padded([build_request(it) for it in chunk])
                  for chunk in chunk_lists)
        tp = time.perf_counter()
        for chunk, outs in zip(chunk_lists,
                               chain.edit_frames_pipelined(chunks)):
            # yield-to-yield wall without this chunk's scoring (the card
            # keeps working on later chunks during both)
            pair_times.append((time.perf_counter() - tp, len(chunk)))
            yield chunk, outs[:len(chunk)]
            tp = time.perf_counter()

    runner = run_pipelined() if args.pipeline else run_serial()
    for chunk, outs in runner:
        ts = time.perf_counter()
        for item, out in zip(chunk, outs):
            tgt = os.path.join(args.data_root, "vkitti_1.3.1_rgb", item.world,
                               item.topic, f"{item.target}.png")
            target_t = transform_image(Image.open(tgt).convert("RGB"),
                                       args.load_size, wh)
            l1 = float(np.abs(out["fake"] - target_t).mean())
            fake_u8, target_u8 = tensor2im(out["fake"]), tensor2im(target_t)
            lp = metrics.lpips(fake_u8, target_u8, model=lpips_model,
                               device=args.device)
            l1s.append(l1)
            lpipss.append(lp)
            ssims.append(metrics.ssim(fake_u8, target_u8))
            psnrs.append(metrics.psnr(fake_u8, target_u8))
            gallery.add_images({"generated": fake_u8, "target": target_u8},
                               item.target_name)
            if args.dump_dirs:
                chain.dump(out["label"], out["geo"],
                           os.path.join(args.dump_dirs, "segm"),
                           os.path.join(args.dump_dirs, "geo"),
                           item.source_name, item.target_name)
            print(f"{item.target_name}: L1={l1:.4f} LPIPS={lp:.4f} "
                  f"SSIM={ssims[-1]:.4f} PSNR={psnrs[-1]:.3f}")
        scoring_s += time.perf_counter() - ts
    dt = float(sum(t for t, _ in pair_times))   # edit work; scoring excluded

    result = {
        "mean_L1": float(np.mean(l1s)),
        "mean_LPIPS": float(np.mean(lpipss)),
        "mean_SSIM": float(np.mean(ssims)),
        "mean_PSNR": float(np.mean(psnrs)),
        "lpips_backbone": ("ported" if lpips_model is not None
                           else "random-init (uncalibrated)"),
        "pairs": len(l1s),
        "batch_pairs": batch_n,
        "pipelined": bool(args.pipeline),
        "chain_s": dt,
        "scoring_s": round(scoring_s, 3),
        "stage_s": {k: round(v, 3) for k, v in chain.stage_s.items()},
        "edits_per_sec": len(l1s) / dt,
    }
    if len(pair_times) > 1:
        # serving-rate view: one-time set-up lands on the first chunk
        tail_s = sum(t for t, _ in pair_times[1:])
        tail_pairs = sum(n for _, n in pair_times[1:])
        result["steady_s_per_pair"] = tail_s / tail_pairs
        result["steady_edits_per_sec"] = tail_pairs / tail_s
    if args.phases:
        result["phase_breakdown"] = phases.snapshot()
    os.makedirs(args.results_dir, exist_ok=True)
    with open(os.path.join(args.results_dir, "benchmark.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    gallery.save()
    return result


if __name__ == "__main__":
    main()
