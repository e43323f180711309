"""The check that decides `correct` in the edit chain's cells.

The reference is the frozen plain copy under perfbench/reference/frozen/
(no kernel: its rasterizer is the plain one, over face boxes; its host
crops are numpy and PIL), built from the same seed's weights and mesh
files as the program.  It judges each sampled request stage by stage,
because the stages meet at argmaxes (labels, instance ids) where two
sound float32 computations may pick different winners on a near tie:

  label_gap      semantic: the widest gap, over the frame's pixels, by
                 which the reference's averaged multi-scale probability
                 of the program's label lies below the reference's best.
  state_gap      geometric, the de-render and the edit: the largest
                 difference between the program's and the reference's
                 edited object state (scales, rotations, translations,
                 zooms), relative to the largest value of that quantity
                 in the frame; 1 where a drawn class or a kept object
                 differs.
  plane_mismatch geometric, the re-render (B1), composite and device
                 downsize: the share of the instance and normal planes'
                 bytes that differ from the reference's.
  fake_gap       textural: the largest |difference| of the generated
                 frame (in [-1, 1]) from the reference's generator.  Where
                 the reference's own labels, planes and object JSON equal
                 the program's to the bit, the generator takes its own;
                 elsewhere it is fed the program's (judged above).  The
                 readings give beside it `fake_gap_own`, the worst over
                 the requests of the first kind, and `own_inputs`, their
                 count.

The control is the same frozen chain computed in TF32 (float32 with TF32
off is what the configuration states), run in the program's place on the
same requests and judged the same way.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from perfbench.harness import weights as Wt

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")
STATE_FLOAT_KEYS = ("_scales", "_rotations", "_translations", "_zooms")
STATE_KEYS = STATE_FLOAT_KEYS + ("_class_samples",)


def record(r: Dict, out: Dict) -> Dict:
    """What the check needs of one finished request: its inputs (by
    reference) and the outputs of edit_frame (or of one pair of the
    batched chains), host arrays only."""
    geo = out["geo"]
    return {"image_rgb": r["image_rgb"], "dets": r["dets"],
            "operations": r["operations"], "cars": r["cars"],
            "first": r["first"], "label": out["label"], "fake": out["fake"],
            "instance_small": geo["instance_small"],
            "normal_small": geo["normal_small"],
            "json_obj": geo["json_obj"],
            "interests": np.asarray(geo["interests"]),
            "state": {k: np.asarray(geo["state"][k]) for k in STATE_KEYS},
            "num_objs": int(geo["state"]["num_objs"])}


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|; 1.0 where the two differ in
    which entries are not finite, or in those entries' values."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not got.size:
        return 0.0
    fg, fw = np.isfinite(got), np.isfinite(want)
    if not np.array_equal(fg, fw) or not np.array_equal(got[~fg],
                                                          want[~fw]):
        return 1.0
    if not fw.any():
        return 0.0
    scale = max(float(np.abs(want[fw]).max()), 1e-30)
    return float(np.abs(got[fg] - want[fw]).max()) / scale


def limits(config_name: str) -> Dict[str, float]:
    with open(os.path.join(LIMITS_DIR, config_name + ".json")) as fh:
        return json.load(fh)["limits"]


def build(cfg: Dict, mesh_root: str, seed: int, device):
    """The frozen EditChain with the seed's weights."""
    import torch

    from perfbench.reference.frozen.geometry.assets import load_shapenet_bank
    from perfbench.reference.frozen.models.derenderer import (Derenderer,
                                                              DeviceMeshBank)
    from perfbench.reference.frozen.models.semantic import SemanticModel
    from perfbench.reference.frozen.pipelines.chain import (ChainConfig,
                                                            EditChain)
    from perfbench.reference.frozen.pipelines.textural import (
        TexturalConfig, TexturalTrainer)

    cc = ChainConfig(**dict(cfg["chain"], scales=tuple(cfg["chain"]
                                                       ["scales"])))
    sd = Wt.make(Wt.layouts("chain"), seed, device)
    with torch.device(device):
        sem = SemanticModel(num_class=cc.num_class)
        der = Derenderer(num_classes=8)
        tex = TexturalTrainer(TexturalConfig())
    sem = sem.to(device).eval()
    sem.load_state_dict(sd["semantic"])
    der = der.to(device).eval()
    der.load_state_dict(sd["derenderer"])
    tex = tex.to(device)
    tex.load_state_dicts(sd["netG"], sd["netE"])
    bank = DeviceMeshBank.from_host(load_shapenet_bank(mesh_root),
                                    device=device)
    return EditChain(cc, sem, (der, bank), tex, device=str(device))


def tf32(on: bool) -> None:
    import torch

    from perfbench.reference.frozen.models import derenderer
    derenderer.ALLOW_TF32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _probs(ref, image: np.ndarray):
    from perfbench.reference.frozen.pipelines.semantic import \
        multiscale_probs_device
    return multiscale_probs_device(ref.semantic_model, image,
                                   tuple(ref.cfg.scales), device=ref.device)


def readings(ref, items: List[Dict]) -> Dict[str, float]:
    """The four numbers of the module's docstring, the worst over
    `items` (records of the program's, or the control's, requests)."""
    import torch

    out = {"label_gap": 0.0, "state_gap": 0.0, "plane_mismatch": 0.0,
           "fake_gap": 0.0, "fake_gap_own": 0.0, "own_inputs": 0}
    probs_of, labels_of = {}, {}
    with torch.no_grad():
        for it in items:
            key = id(it["image_rgb"])
            if key not in probs_of:
                probs_of[key] = _probs(ref, it["image_rgb"])
                labels_of[key] = np.asarray(ref.labels(it["image_rgb"]))
            p = probs_of[key]
            lab = torch.as_tensor(np.asarray(it["label"]), device=p.device
                                  ).long()
            gap = p.amax(0) - torch.gather(p, 0, lab[None])[0]
            g = float(gap.max())
            out["label_gap"] = max(out["label_gap"],
                                   g if np.isfinite(g) else 1.0)

            geo = ref.derender(it["image_rgb"], it["dets"],
                               it["operations"], cache_key=None)
            n = it["num_objs"]
            s_gap = 0.0
            for k in STATE_FLOAT_KEYS:
                s_gap = max(s_gap, rel_gap(it["state"][k][:n],
                                           geo["state"][k][:n]))
            same_cls = np.array_equal(
                np.asarray(it["state"]["_class_samples"])[:n],
                np.asarray(geo["state"]["_class_samples"])[:n])
            same_kept = np.array_equal(np.asarray(it["interests"]),
                                       np.asarray(geo["interests"]))
            if not (same_cls and same_kept):
                s_gap = 1.0
            out["state_gap"] = max(out["state_gap"], s_gap)
            bad = (np.count_nonzero(it["instance_small"]
                                    != geo["instance_small"])
                   + np.count_nonzero(it["normal_small"]
                                      != geo["normal_small"]))
            total = it["instance_small"].size + it["normal_small"].size
            out["plane_mismatch"] = max(out["plane_mismatch"], bad / total)

            own = (bad == 0 and s_gap == 0.0
                   and np.array_equal(labels_of[key],
                                      np.asarray(it["label"]))
                   and geo["json_obj"] == it["json_obj"])
            if own:
                label, planes = labels_of[key], geo
            else:
                label = np.asarray(it["label"])
                planes = {"json_obj": it["json_obj"],
                          "instance_small": it["instance_small"],
                          "normal_small": it["normal_small"]}
            fake, _ = ref.generate(it["image_rgb"], label, planes,
                                   cache_key=None)
            d = np.abs(np.asarray(it["fake"], np.float64) - fake)
            f_gap = float(d.max()) if np.isfinite(d).all() else 2.0
            out["fake_gap"] = max(out["fake_gap"], f_gap)
            if own:
                out["fake_gap_own"] = max(out["fake_gap_own"], f_gap)
                out["own_inputs"] += 1
            out["objects_drawn"] = min(out.get("objects_drawn", 1.0), float(
                np.count_nonzero(it["instance_small"]))
                / it["instance_small"].size)
    return out


def control_records(ref, items: List[Dict]) -> List[Dict]:
    """The control's outputs on the same requests: the frozen chain in
    TF32 in the program's place, recorded as the program's are."""
    tf32(True)
    try:
        return [record(dict(it, cache_key=None), ref.edit_frame(
            it["image_rgb"], operations=it["operations"], dets=it["dets"]))
            for it in items]
    finally:
        tf32(False)


def judge(cfg: Dict, mesh_root: str, seed: int, device, items: List[Dict],
          with_counts: bool = False, control: bool = False) -> Dict:
    """{"checks": {name: (reading, limit)}, "correct": bool, and with
    `control` the control's readings}."""
    from perfbench.reference.frozen.ops import rasterize_cuda as RC
    tf32(False)
    ref = build(cfg, mesh_root, seed, device)
    RC.COUNTS.clear()
    RC.COUNTING[0] = with_counts
    try:
        got = readings(ref, items)
    finally:
        RC.COUNTING[0] = False
    lim = limits(cfg["name"])
    checks = {k: (got[k], lim[k]) for k in lim}
    out = {"checks": checks, "readings": got,
           "correct": all(v <= lim_ for v, lim_ in checks.values()),
           "b1_counts": list(RC.COUNTS),
           "objects_drawn": got["objects_drawn"]}
    if control:
        out["control"] = readings(ref, control_records(ref, items))
    return out


def flops(cfg: Dict) -> Dict[str, float]:
    """FLOPs (torch.utils.flop_counter: products and convolutions;
    elementwise work and the rasterizer count 0) of each network pass of
    the configuration, counted on the frozen nets built on the meta
    device: `semantic` (the multi-scale pass of one frame), `encode` (the
    derenderer over its object slots), `source` (netE on the source
    frame), `generate` (netG on one frame's conditioning)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.frozen.models.derenderer import Derenderer
    from perfbench.reference.frozen.models.semantic import SemanticModel
    from perfbench.reference.frozen.pipelines.semantic import scale_sizes
    from perfbench.reference.frozen.pipelines.textural import (
        TexturalConfig, TexturalTrainer)

    c = cfg["chain"]
    H, W = cfg["frame"]["height"], cfg["frame"]["width"]
    fh, fw = c["fine_height"], c["fine_width"]
    S, M = c["image_size"], cfg["max_objects"]
    meta = torch.device("meta")
    with meta:
        sem = SemanticModel(num_class=c["num_class"]).eval()
        der = Derenderer(num_classes=8).eval()
        tcfg = TexturalConfig()
        tex = TexturalTrainer(tcfg)

    def count(fn) -> float:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    e = lambda *shape: torch.empty(shape, device=meta)  # noqa: E731
    return {
        "semantic": count(lambda: [
            sem(e(1, 3, h, w), seg_size=(H, W))
            for h, w in scale_sizes(H, W, tuple(c["scales"]))]),
        "encode": count(lambda: der(e(M, S, S, 3), e(M, 2), e(M, 2))),
        "source": count(lambda: tex.netE(e(1, 3, fh, fw))),
        "generate": count(lambda: tex.netG(e(1, tcfg.netG_input_nc, fh,
                                             fw))),
    }


def trace_work(cfg: Dict, judged: Dict) -> Dict[str, float]:
    """What the traced run's readers need from the reference: the FLOPs a
    request pays always (`generate`) and a request that misses the
    per-source caches pays besides (the semantic pass, the encode and the
    source features), and B1's work: face-box pairs per rendered image
    (from the check's own renders), faces per mesh, image size."""
    f = flops(cfg)
    counts = judged["b1_counts"]
    images = sum(c[0] for c in counts)
    return {"flops_per_request": f["generate"],
            "flops_per_miss": f["semantic"] + f["encode"] + f["source"],
            "b1_pairs_per_image": (sum(c[3] for c in counts) / images
                                   if images else None),
            "b1_faces": counts[0][2] if counts else None,
            "b1_size": counts[0][1] if counts else None}
