"""Edit benchmark over the per-stage file contract (mirrors
textural/edit_benchmark.py), PyTorch port.

For each edit pair of the benchmark JSON's first half: regenerate the
target image from the source image's texture codes and the geometric
branch's edited 2.5D maps (--geo_dir, what geometric_main --vkitti_root
--edit_json writes, one set of files per target name) with the source's
labels (--segm_dir, what semantic_test --test_img benchmark writes), then
report L1 / LPIPS / SSIM / PSNR against the target frame per pair and
their means (edit_benchmark.py:40,143) in RESULTS_DIR/benchmark.json.
The pair time covers the edit work only (scoring is kept outside it); a
source's transforms and texture codes are computed once and reused by its
later pairs.  With --chain_times (the upstream stages' wall, {"semantic_s":
S, "geometric_s": S}) the headline edits_per_sec covers all three stages;
without it, it is null.  Runs on `--device` (default cuda).
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
    p.add_argument("--segm_dir", required=True,
                   help="semantic branch outputs")
    p.add_argument("--geo_dir", required=True,
                   help="geometric branch outputs (per target-name files)")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint directory (core/checkpoint) or torch "
                        "file {netG, netE} of state_dicts")
    p.add_argument("--results_dir", default="./benchmark_out")
    p.add_argument("--load_size", type=int, default=624)
    p.add_argument("--fine_width", type=int, default=624)
    p.add_argument("--fine_height", type=int, default=192)
    p.add_argument("--chain_times", default=None,
                   help="JSON file with upstream wall-clock "
                        '{"semantic_s": S, "geometric_s": S} so the '
                        "headline edits/sec covers the WHOLE 3-stage "
                        "protocol, not just textural regeneration")
    p.add_argument("--lpips_ckpt", default=None,
                   help="LPIPS checkpoint (.pth, official lpips package "
                        "layout); without it the LPIPS column uses a "
                        "random-init backbone (uncalibrated)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --ckpt_dir "
                        "is not given")
    return p


def main(argv=None):
    """Run the benchmark; returns the benchmark.json dict."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.edit_vkitti import (generate_edit_frame,
                                                 load_trainer)
    from sdn3d_tpu_torch.data.textural_data import transform_image
    from sdn3d_tpu_torch.data.vkitti import benchmark_split, load_edit_json
    from sdn3d_tpu_torch.pipelines.textural_edit import prepare_source_inputs
    from sdn3d_tpu_torch.utils import metrics
    from sdn3d_tpu_torch.utils.visualizer import HTMLGallery, tensor2im

    args = build_argparser().parse_args(argv)
    args.no_vgg = True
    trainer = load_trainer(args)
    wh = (args.fine_width, args.fine_height)

    items = benchmark_split(load_edit_json(args.edit_json))
    gallery = HTMLGallery(args.results_dir, "92-pair edit benchmark")

    lpips_model = (metrics.load_lpips(args.lpips_ckpt, device=args.device)
                   if args.lpips_ckpt else None)
    l1s, lpipss, ssims, psnrs = [], [], [], []
    pair_times = []
    src_cache = {}   # per-source transforms + texture codes
    scoring_s = 0.0  # metric/gallery cost, not part of the edit
    for item in items:
        tgt = os.path.join(args.data_root, "vkitti_1.3.1_rgb", item.world,
                           item.topic, f"{item.target}.png")
        tp = time.perf_counter()
        if item.source_name not in src_cache:
            src = os.path.join(args.data_root, "vkitti_1.3.1_rgb",
                               item.world, item.topic, f"{item.source}.png")
            segm = os.path.join(args.segm_dir, f"{item.source_name}.png")
            src_cache[item.source_name] = prepare_source_inputs(
                trainer, Image.open(src), Image.open(segm), args.load_size,
                wh)
        prepared = src_cache[item.source_name]
        fake, _ = generate_edit_frame(trainer, prepared.image, prepared.label,
                                      args.geo_dir, item.target_name, wh,
                                      args, feats=prepared.feats,
                                      source=prepared.table)
        pair_times.append(time.perf_counter() - tp)

        # the target's decode and resize are scoring (the edit never reads
        # the target), kept out of the pair time as in cli/edit_chain.py
        ts = time.perf_counter()
        target_t = transform_image(Image.open(tgt).convert("RGB"),
                                   args.load_size, wh)
        l1 = float(np.abs(fake - target_t).mean())
        fake_u8, target_u8 = tensor2im(fake), tensor2im(target_t)
        lp = metrics.lpips(fake_u8, target_u8, model=lpips_model,
                           device=args.device)
        l1s.append(l1)
        lpipss.append(lp)
        ssims.append(metrics.ssim(fake_u8, target_u8))
        psnrs.append(metrics.psnr(fake_u8, target_u8))
        gallery.add_images({"generated": fake_u8, "target": target_u8},
                           item.target_name)
        scoring_s += time.perf_counter() - ts
        print(f"{item.target_name}: L1={l1:.4f} LPIPS={lp:.4f}")
    dt = float(np.sum(pair_times))   # edit work only; scoring excluded

    result = {
        "mean_L1": float(np.mean(l1s)),
        "mean_LPIPS": float(np.mean(lpipss)),
        "mean_SSIM": float(np.mean(ssims)),
        "mean_PSNR": float(np.mean(psnrs)),
        "lpips_backbone": ("ported" if lpips_model is not None
                           else "random-init (uncalibrated)"),
        "pairs": len(l1s),
        "textural_s": dt,
        "scoring_s": round(scoring_s, 3),
        "textural_edits_per_sec": len(l1s) / dt,
    }
    if len(pair_times) > 1:
        # serving-rate view: one-time set-up lands on the first pair
        steady = float(np.mean(pair_times[1:]))
        result["textural_steady_s_per_pair"] = steady
        result["textural_steady_edits_per_sec"] = 1.0 / steady
    if args.chain_times:
        with open(args.chain_times) as f:
            upstream = json.load(f)
        # only the two upstream stage times: anything else in the file
        # (a previous benchmark.json) would count twice
        upstream = {k: upstream[k] for k in ("semantic_s", "geometric_s")
                    if k in upstream}
        result.update(upstream)
        total = dt + sum(upstream.values())
        result["chain_s"] = total
        result["edits_per_sec"] = len(l1s) / total
    else:
        # the textural-only rate is not the three-stage protocol's
        result["edits_per_sec"] = None
    with open(os.path.join(args.results_dir, "benchmark.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    gallery.save()
    return result


if __name__ == "__main__":
    main()
