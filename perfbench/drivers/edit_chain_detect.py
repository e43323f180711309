"""Driver of the edit chain with Mask R-CNN as its source of objects:
`sdn3d_tpu_torch.pipelines.chain.EditChain` at the configuration's
ChainConfig, holding a `MaskRCNNDetector(MaskRCNNConfig(**detector))`
(the constructor's `detector=`, which `EditChain.build(with_detector=
True)` also fills), fed the frames of the edit chain's traffic without
their objects: every request calls `edit_frame(image, operations,
dets=None, cache_key=...)`, and the chain detects.  The operations keep
the pool's car positions; `match_operations` pairs each with the nearest
detected object.

The chain, the request loop, the sample and the warm-up are those of
drivers/edit_chain.py (loaded by name); the window is serial only.  The
sample holds each request with the objects the chain used (its result's
"dets"); a program whose result has none stops the run at its first
request.  The check: reference/chain_ref.py judges the stages after the
detection on those objects, reference/detect_ref.py the detector on the
same frames (the program's side read here, through the program's
detector entry, after the window)."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import numpy as np

from perfbench.harness import common, discovery
from perfbench.harness import traffic as T
from perfbench.kernels import counts
from perfbench.reference import detect_ref

base = discovery.driver("edit_chain")


def build_detector(cfg: Dict, device):
    """The program's MaskRCNNDetector at cfg["detector"], holding the
    configuration's weights (detect_ref.weights)."""
    import torch

    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig
    from sdn3d_tpu_torch.pipelines.detect import MaskRCNNDetector

    with torch.device(device):
        det = MaskRCNNDetector(MaskRCNNConfig(
            **detect_ref.detector_config(cfg)), device=device)
    return det.load_state_dict(detect_ref.weights(cfg, device))


def own_dets(out: Dict):
    """The objects the chain used for a request, from its result."""
    if "dets" not in out:
        raise RuntimeError(
            "edit_frame's result has no 'dets': this program does not "
            "hand back the objects its chain detected, so the check "
            "cannot judge them; no result")
    return out["dets"]


class Sampler(base.Sampler):
    """drivers/edit_chain.Sampler over each request with the objects the
    chain used, and their count as its cars."""

    def offer(self, r: Dict, out: Dict) -> None:
        dets = own_dets(out)
        super().offer(dict(r, dets=dets, cars=len(dets[0])), out)


def detless(reqs):
    for r in reqs:
        yield dict(r, dets=None)


def program_stages(det, image: np.ndarray) -> Dict:
    """The program's detector on one frame, stage by stage, as
    detect_ref compares it: the pyramid, the RPN's logits and deltas, the
    valid proposals, and from the packed buffer the valid detections'
    boxes, classes, scores and own-class mask planes."""
    import torch

    from sdn3d_tpu_torch.pipelines import detect as TD

    cfg = det.config
    dev = det.device
    molded, window, _ = TD.resize_image(image, cfg.image_min_dim,
                                        cfg.image_max_dim)
    mean = torch.tensor(cfg.mean_pixel, dtype=torch.float32, device=dev)
    x = (torch.as_tensor(molded, device=dev)[None].float() - mean
         ).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        pyramid = det.model.fpn(x)
        logits, _, deltas = det.model.rpn_forward(pyramid)
        out = det.model(x, torch.as_tensor(det.anchors, device=dev),
                        torch.tensor([window], dtype=torch.float32,
                                     device=dev))
        packed = TD.pack_outputs(out)[0].cpu().numpy()
    D, (mh, mw) = cfg.detection_max_instances, cfg.mask_shape
    valid = packed[D * 6:D * 7] > 0.5
    dets = packed[:D * 6].reshape(D, 6)[valid]
    return {"pyramid": list(pyramid), "rpn_logits": logits[0],
            "rpn_deltas": deltas[0],
            "proposals": out["proposals"][0][out["proposal_valid"][0]],
            "boxes": dets[:, :4], "class_ids": dets[:, 4].astype(np.int64),
            "scores": dets[:, 5],
            "masks": packed[D * 7:].reshape(D, mh, mw)[valid]}


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, control: bool = False) -> Dict:
    """One run of the cell, as drivers/edit_chain.run; with `control`,
    the controls' readings on the same sampled requests come back too."""
    import torch

    cfg, mix = cell["config"], cell["traffic"]
    if mix["mode"] != "serial":
        raise ValueError(f"{cfg['name']}: serial traffic only, got "
                         f"{mix['mode']!r}")
    device = torch.device(cfg.get("device", "cuda"))
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        marks = [("start", time.perf_counter() - t_start)]
        mesh_root = T.write_meshes(os.path.join(tmp, "shapenet"), seed,
                                   cfg["meshes"])
        marks.append(("meshes", time.perf_counter() - t_start))
        pool = T.frame_pool(seed, mix, cfg["frame"])
        marks.append(("frames", time.perf_counter() - t_start))
        chain = base.build_chain(cfg, mesh_root, seed, device)
        chain.detector = build_detector(cfg, device)
        marks.append(("build", time.perf_counter() - t_start))

        # warm-up: this cell's own shapes, other keys
        warm = detless(T.edit_requests(seed, mix, pool, stream=1,
                                       prefix="w"))
        for _ in range(int(mix["warmup_requests"])):
            own_dets(base._edit(chain, next(warm)))
        if sync is not None:
            sync()
        setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", setup_s))
        print("set-up, s from process start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks), file=sys.stderr)

        reqs = detless(T.edit_requests(seed, mix, pool))
        sampler = Sampler(int(cfg["check"]["sample"]), seed)
        out = {"trace": None}
        if not trace:
            lat, done, window = base.serial(chain, reqs, seconds, sampler,
                                            sync)
            out["metrics"] = {
                "setup_s": setup_s, "edits_per_s": len(done) / window,
                "edit_ms_p95": float(np.percentile(np.asarray(lat) * 1e3,
                                                   95))}
        else:
            from sdn3d_tpu_torch.utils import phases
            prof_s = seconds * float(mix.get("profiler_share", 0.4))
            (_, done_p, _), prof, wall_p = common.profiled(
                lambda: base.serial(chain, reqs, prof_s, sampler, sync),
                on_card)
            summary = common.trace_summary(prof, wall_p)
            del prof
            phases.reset(True)
            try:
                _, done_ph, _ = base.serial(chain, reqs, seconds - prof_s,
                                            sampler, sync)
                snap = phases.snapshot()
            finally:
                phases.reset(False)
            done = done_p + done_ph
            summary.update({
                "units_prof": len(done_p), "phases": snap,
                "units_phase": len(done_ph),
                "misses_prof": sum(r["first"] for r in done_p),
                "images_per_b1_call": 16})
            out["trace"] = summary
        out["attempted"] = len(done)
        out["failed"] = 0
        if on_card:
            out["device"] = common.device_record(device)
        else:
            out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}

        sample = sampler.sample()
        det = chain.detector
        program = {}
        for it in sample:
            if id(it["image_rgb"]) not in program:
                program[id(it["image_rgb"])] = program_stages(
                    det, it["image_rgb"])
        del chain, reqs, warm, det
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        from perfbench.reference import chain_ref
        judged = chain_ref.judge(cfg, mesh_root, seed, device, sample,
                                 with_counts=trace, control=control)
        found = detect_ref.judge(cfg, seed, device, sample, program,
                                 control=control)
        del program
        out["checks"] = dict(judged["checks"], **found["checks"])
        out["readings"] = dict(judged["readings"], **found["readings"])
        if control:
            out["control"] = dict(judged["control"], **found["control"])
        out["objects_drawn"] = judged["objects_drawn"]
        out["correct"] = judged["correct"] and found["correct"]
        if trace:
            t = out["trace"]
            t.update(chain_ref.trace_work(cfg, judged))
            t["flops_per_request"] += detect_ref.flops(cfg)
            t["flops_prof"] = (t["units_prof"] * t["flops_per_request"]
                               + t["misses_prof"] * t["flops_per_miss"])
            t["peaks"] = counts.peaks_for(out["device"]["kind"])
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
