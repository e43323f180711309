"""Driver of the derenderer training cell: `sdn3d_tpu_torch.pipelines.
derender.DerenderTrainer.train_step` at the configuration's settings,
back to back over a pool of synthetic batches made on the card.

Set-up builds one trainer (the model with the seed's weights, the mesh
bank, the flat Adam state) and drives it through its first three steps
with the window's own call and feed, recording what the check compares:
each step's total loss, the norm of each parameter's first gradient as
Adam got it (from its first moment after one step) and the norm of each
parameter's change over the three steps.  The same trainer then runs
the window; a traced run profiles the first part of it.  The check of
perfbench/reference/train_ref.py follows the same three steps on the
frozen plain copy once the window has closed.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

from perfbench.harness import common
from perfbench.harness import traffic as T
from perfbench.harness import weights as Wt
from perfbench.kernels import counts
from perfbench.reference.train_ref import (CHECKED_STEPS, first_steps,
                                           step_generator, trainer_kwargs)


def build_trainer(cfg: Dict, mesh_root: str, seed: int, device):
    import torch

    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import (Derenderer,
                                                   DeviceMeshBank,
                                                   TargetType)
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer

    sd = Wt.make(Wt.layouts("derenderer"), seed, device)
    with torch.device(device):
        model = Derenderer(num_classes=8, dtype=cfg["compute_dtype"])
    model = model.to(device)
    model.load_state_dict(sd["derenderer"])
    bank = DeviceMeshBank.from_host(load_shapenet_bank(mesh_root),
                                    device=device)
    return DerenderTrainer(model=model, bank=bank,
                           mode=TargetType.BY_NAME[cfg["mode"]],
                           **trainer_kwargs(cfg))


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, control: bool = False) -> Dict:
    """One run of the cell; with `control`, the control's readings come
    back too (under "control")."""
    import torch

    cfg, mix = cell["config"], cell["traffic"]
    device = torch.device(cfg.get("device", "cuda"))
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        marks = [("start", time.perf_counter() - t_start)]
        mesh_root = T.write_meshes(os.path.join(tmp, "shapenet"), seed,
                                   cfg["meshes"])
        marks.append(("meshes", time.perf_counter() - t_start))
        trainer = build_trainer(cfg, mesh_root, seed, device)
        marks.append(("build", time.perf_counter() - t_start))
        batches = T.train_batches(seed, mix, cfg["trainer"], device)
        state = trainer.init()
        program = first_steps(trainer, state, batches, seed, device)
        sync()
        setup_s = time.perf_counter() - t_start
        marks.append(("first steps", setup_s))
        print("set-up, s from process start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks), file=sys.stderr)

        it = [CHECKED_STEPS]

        def steps(secs):
            n = 0
            t0 = time.perf_counter()
            deadline = t0 + secs
            while time.perf_counter() < deadline:
                k = it[0]
                trainer.train_step(state, batches[k % len(batches)],
                                   step_generator(seed, k, device))
                it[0] += 1
                n += 1
            sync()
            return n, time.perf_counter() - t0

        out = {"trace": None}
        if not trace:
            n, window = steps(seconds)
            out["metrics"] = {"setup_s": setup_s,
                              "train_step_ms": window / n * 1e3}
        else:
            prof_s = seconds * float(mix.get("profiler_share", 0.2))
            (n_p, _), prof, wall_p = common.profiled(lambda: steps(prof_s),
                                                     on_card)
            summary = common.trace_summary(prof, wall_p)
            del prof
            n_rest, _ = steps(seconds - prof_s)
            n = n_p + n_rest
            summary["units_prof"] = n_p
            out["trace"] = summary
        out["attempted"] = n
        out["failed"] = 0
        out["device"] = (common.device_record(device) if on_card else
                         {"platform": "cpu", "kind": "cpu", "count": 1,
                          "memory_peak_bytes": 0})
        del trainer, state, batches
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        from perfbench.reference import train_ref
        judged = train_ref.judge(cfg, mix, mesh_root, seed, device, program,
                                 with_counts=trace, control=control)
        out["checks"] = judged["checks"]
        out["correct"] = judged["correct"]
        out["control"] = judged.get("control")
        out["readings"] = judged["readings"]
        if trace:
            t = out["trace"]
            t.update(train_ref.trace_work(cfg, judged))
            t["flops_prof"] = t["units_prof"] * t["flops_per_step"]
            t["peaks"] = counts.peaks_for(out["device"]["kind"])
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
