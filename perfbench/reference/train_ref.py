"""The check that decides `correct` in the derenderer training cell.

The frozen plain copy of the trainer (perfbench/reference/frozen/: the
derenderer, the silhouette render with the plain rasterizer, the plain
walk and per-face sums of its gradient, the losses, the REINFORCE draw
and the flat Adam) starts from the same seed's weights and follows the
program's first three steps on the same batches and class draws.  Three
numbers are compared, each as the worst over its items:

  loss_gap    |program's total loss - reference's| / |reference's| at
              the first step.  (Over the three steps it reads up to 50
              times more on some seeds: the kernels' sums of the
              silhouette gradient run in another order than the plain
              ones, and Adam's division by the root of the second moment
              turns the last bits of near-zero gradient entries into
              whole steps; the update_gap sees the later steps.)
  grad_gap    per parameter, the gap between the norms of the program's
              and the reference's first gradient as Adam got it (its
              first moment after one step over 1 - b1), over the larger
              of the reference's norm of that parameter and the median
              parameter's.
  update_gap  the same for the parameter's change over the three steps;
              parameters whose reference gradient norm is under a
              thousandth of the median parameter's (nought to rounding,
              moved by Adam's normalisation of round-off) are left out.
              Beside the numbers, the readings name the parameters left
              out with their gradient norms over the median's and their
              own gaps, and give the update_gap that a cut at a
              millionth of the median would read.

The control is the frozen trainer computed in TF32 (the configuration
states float32 with TF32 off), judged against the float32 reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.harness import traffic as T
from perfbench.harness import weights as Wt
from perfbench.reference.chain_ref import limits, tf32

SMALL_LEAF = 1e-3
ROUNDING_CUT = 1e-6           # reported beside the cut, not compared

CHECKED_STEPS = 3


def step_generator(seed: int, it: int, device):
    """The class-draw generator of step `it` (REINFORCE), from the seed."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(T.torch_seed(seed, 30, it))
    return g


def trainer_kwargs(cfg: Dict) -> Dict:
    t = cfg["trainer"]
    return {k: t[k] for k in ("image_size", "render_size", "mask_weight",
                              "ffd_coeff_reg", "lr", "weight_decay",
                              "lr_decay_steps", "lr_decay_rate")}


def leaf_norms(flat, params) -> List[float]:
    """Norms of a flat vector's pieces, one a parameter, in order."""
    import torch
    sizes = [p.numel() for p in params]
    return [float(torch.linalg.vector_norm(c.double()))
            for c in flat.split(sizes)]


def first_steps(trainer, state, batches, seed: int, device) -> Dict:
    """Steps 1-3 of `trainer` through train_step; the readings the check
    compares (see the module docstring)."""
    import torch
    params = list(state.model.parameters())
    p0 = torch.cat([p.detach().reshape(-1) for p in params]).clone()
    losses, grad = [], None
    b1 = 0.9                                  # Adam's first decay
    for it in range(CHECKED_STEPS):
        state, loss = trainer.train_step(state, batches[it % len(batches)],
                                         step_generator(seed, it, device))
        losses.append(float(sum(v.double() for v in loss.values())))
        if it == 0:
            grad = leaf_norms(state.mu / (1 - b1), params)
    p3 = torch.cat([p.detach().reshape(-1) for p in params])
    return {"losses": losses, "grad_norms": grad,
            "delta_norms": leaf_norms(p3 - p0, params),
            "names": [n for n, _ in state.model.named_parameters()]}


def build(cfg: Dict, mesh_root: str, seed: int, device):
    import torch

    from perfbench.reference.frozen.geometry.assets import load_shapenet_bank
    from perfbench.reference.frozen.models.derenderer import (
        Derenderer, DeviceMeshBank, TargetType)
    from perfbench.reference.frozen.pipelines.derender import \
        DerenderTrainer

    sd = Wt.make(Wt.layouts("derenderer"), seed, device)
    with torch.device(device):
        model = Derenderer(num_classes=8)
    model = model.to(device)
    model.load_state_dict(sd["derenderer"])
    bank = DeviceMeshBank.from_host(load_shapenet_bank(mesh_root),
                                    device=device)
    return DerenderTrainer(model=model, bank=bank,
                           mode=TargetType.BY_NAME[cfg["mode"]],
                           **trainer_kwargs(cfg))


def follow(cfg: Dict, mix: Dict, mesh_root: str, seed: int,
           device) -> Dict:
    """The frozen trainer's first three steps: losses, first-gradient
    and change norms per parameter, as first_steps records them."""
    import torch

    trainer = build(cfg, mesh_root, seed, device)
    batches = T.train_batches(seed, mix, cfg["trainer"], device)
    out = first_steps(trainer, trainer.init(), batches, seed, device)
    del trainer, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(got: Dict, ref: Dict) -> Dict[str, float]:
    """The module docstring's three numbers; a number whose inputs are
    not all finite reads inf."""
    numbers = ("losses", "grad_norms", "delta_norms")
    if not all(np.isfinite(np.asarray(d[k], np.float64)).all()
               for d in (got, ref) for k in numbers):
        return {k: np.inf for k in ("loss_gap", "grad_gap", "update_gap",
                                    "loss_gap_3_steps",
                                    "update_gap_median_leaf")}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(got["losses"], ref["losses"])]
    gr = np.asarray(ref["grad_norms"])
    gp = np.asarray(got["grad_norms"])
    g_med = float(np.median(gr))
    gg = float(np.max(np.abs(gp - gr) / np.maximum(gr, g_med)))
    dr_all = np.asarray(ref["delta_norms"])
    dp_all = np.asarray(got["delta_norms"])

    def leaf_gaps(cut):
        keep = gr >= cut * g_med
        dr, dp = dr_all[keep], dp_all[keep]
        return keep, np.abs(dp - dr) / np.maximum(dr, float(np.median(dr)))

    keep, per_leaf = leaf_gaps(SMALL_LEAF)
    d_med = float(np.median(dr_all[keep]))
    names = ref.get("names") or [str(i) for i in range(len(gr))]
    left_out = [[names[i], float(gr[i] / g_med),
                 float(abs(dp_all[i] - dr_all[i])
                       / max(dr_all[i], d_med))]
                for i in np.flatnonzero(~keep)]
    return {"loss_gap": gaps[0], "grad_gap": gg,
            "update_gap": float(np.max(per_leaf)),
            # not compared: what PERF.md reports beside them
            "loss_gap_3_steps": max(gaps),
            "update_gap_median_leaf": float(np.median(per_leaf)),
            "left_out": left_out,
            "update_gap_rounding_cut": float(np.max(
                leaf_gaps(ROUNDING_CUT)[1]))}


def judge(cfg: Dict, mix: Dict, mesh_root: str, seed: int, device,
          program: Dict, with_counts: bool = False,
          control: bool = False) -> Dict:
    from perfbench.reference.frozen.ops import rasterize_cuda as RC
    tf32(False)
    RC.COUNTS.clear()
    RC.COUNTING[0] = with_counts
    try:
        ref = follow(cfg, mix, mesh_root, seed, device)
    finally:
        RC.COUNTING[0] = False
    got = readings(program, ref)
    lim = limits(cfg["name"])
    checks = {k: (got[k], lim[k]) for k in lim}
    out = {"checks": checks, "readings": got,
           "correct": all(v <= lim_ for v, lim_ in checks.values()),
           "counts": list(RC.COUNTS), "reference": ref}
    if control:
        tf32(True)
        try:
            ctl = follow(cfg, mix, mesh_root, seed, device)
        finally:
            tf32(False)
        out["control"] = readings(ctl, ref)
    return out


def flops_per_step(cfg: Dict) -> float:
    """FLOPs (torch.utils.flop_counter: products and convolutions, their
    backward included; elementwise work and the rasterizer count 0) of
    one training step's network: the frozen derenderer's forward and
    backward at the batch, counted on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.frozen.models.derenderer import Derenderer
    t = cfg["trainer"]
    B, S = t["batch_size"], t["image_size"]
    meta = torch.device("meta")
    with meta:
        model = Derenderer(num_classes=8).train()
    e = lambda *shape: torch.empty(shape, device=meta)  # noqa: E731
    with FlopCounterMode(display=False) as fc:
        out = model(e(B, S, S, 3), e(B, 2), e(B, 2))
        sum(v.sum() for v in out.values()).backward()
    return float(fc.get_total_flops())


def trace_work(cfg: Dict, judged: Dict) -> Dict[str, float]:
    """What the traced run's readers need from the reference: FLOPs a
    step, and the kernels' shapes and data from the reference's own three
    steps (face-box pairs and won pixels per image)."""
    c: List = judged["counts"]
    images = sum(x[0] for x in c)
    return {"flops_per_step": flops_per_step(cfg),
            "b_images": cfg["trainer"]["batch_size"],
            "b_faces": c[0][2] if c else None,
            "b_size": c[0][1] if c else None,
            "b1_pairs_per_image": (sum(x[3] for x in c) / images
                                   if images else None),
            "won_per_image": (sum(x[4] for x in c) / images
                              if images else None)}
