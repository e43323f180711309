"""Driver of the edit chain's cells: `sdn3d_tpu_torch.pipelines.chain.
EditChain` at the configuration's ChainConfig, fed frames and ground-truth
objects held in memory, as an interactive application holds them.

The traffic mix's `mode` picks the entry the window drives: "serial"
calls `edit_frame` once a request (closed loop, one client, no think
time; each request timed from the call to its return, when the generated
frame is a host array); "pipelined" streams chunks of `batch_pairs`
requests through `edit_frames_pipelined` until the window closes, and
ends the window when the last chunk has come out.

A traced run splits its window in two slices: a profiler slice (phase
records off) for the device's busy time, the kernels and the breakdown,
then a phase slice (the port's phase records on, which synchronise the
card) for each stage's seconds.  Every run ends with the correctness
check of perfbench/reference/chain_ref.py on a sample of the requests it
finished, drawn from the seed.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from perfbench.harness import common
from perfbench.harness import traffic as T
from perfbench.harness import weights as Wt
from perfbench.kernels import counts
from perfbench.reference.chain_ref import record

def build_chain(cfg: Dict, mesh_root: str, seed: int, device):
    """The port's EditChain at cfg["chain"], its models holding the
    benchmark's weights for `seed`."""
    import torch

    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.models.semantic import SemanticModel
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain
    from sdn3d_tpu_torch.pipelines.textural import (TexturalConfig,
                                                    TexturalTrainer)

    cc = ChainConfig(**dict(cfg["chain"], scales=tuple(cfg["chain"]
                                                       ["scales"])))
    sd = Wt.make(Wt.layouts("chain"), seed, device)
    with torch.device(device):
        sem = SemanticModel(num_class=cc.num_class, dtype=cc.compute_dtype)
        der = Derenderer(num_classes=8, dtype=cc.compute_dtype)
        tex = TexturalTrainer(TexturalConfig(compute_dtype=cc.compute_dtype))
    sem = sem.to(device).eval()
    sem.load_state_dict(sd["semantic"])
    der = der.to(device).eval()
    der.load_state_dict(sd["derenderer"])
    tex = tex.to(device)
    tex.load_state_dicts(sd["netG"], sd["netE"])
    del sd
    bank = DeviceMeshBank.from_host(load_shapenet_bank(mesh_root),
                                    device=device)
    return EditChain(cc, sem, (der, bank), tex, device=str(device))


class Sampler:
    """A uniform sample of `k` finished requests (reservoir sampling with
    the seed's generator) and the request with the most cars."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = T.rng(seed, 20)
        self.items: List[Dict] = []
        self.seen = 0
        self.largest = None

    def offer(self, r: Dict, out: Dict) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(record(r, out))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = record(r, out)
        if self.largest is None or r["cars"] > self.largest["cars"]:
            self.largest = record(r, out)

    def sample(self) -> List[Dict]:
        return self.items + ([self.largest] if self.largest else [])


def _edit(chain, r):
    return chain.edit_frame(r["image_rgb"], operations=r["operations"],
                            dets=r["dets"], cache_key=r["cache_key"])


def serial(chain, reqs, seconds: float, sampler=None, sync=None):
    """edit_frame in a closed loop until `seconds` have passed; the window
    ends with the first request that finishes after that.  Returns
    (latencies, requests, window seconds)."""
    lat, done = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        r = next(reqs)
        t1 = time.perf_counter()
        out = _edit(chain, r)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        done.append(r)
        if sampler is not None:
            sampler.offer(r, out)
        if t2 >= deadline:
            break
    if sync is not None:
        sync()
    return lat, done, time.perf_counter() - t0


def pipelined(chain, reqs, seconds: float, batch_pairs: int, sampler=None,
              sync=None):
    """Chunks of `batch_pairs` requests through edit_frames_pipelined,
    fed until `seconds` have passed; the window ends when the last chunk
    fed has come out.  Returns (None, requests, window seconds)."""
    fed, done = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def chunks():
        while time.perf_counter() < deadline:
            c = [next(reqs) for _ in range(batch_pairs)]
            fed.append(c)
            yield c

    for i, outs in enumerate(chain.edit_frames_pipelined(chunks())):
        for r, out in zip(fed[i], outs):
            done.append(r)
            if sampler is not None:
                sampler.offer(r, out)
    if sync is not None:
        sync()
    return None, done, time.perf_counter() - t0


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, control: bool = False) -> Dict:
    """One run of the cell; with `control`, the control's readings on the
    same sampled requests come back too (under "control")."""
    import torch

    cfg, mix = cell["config"], cell["traffic"]
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
        chain = build_chain(cfg, mesh_root, seed, device)
        marks.append(("build", time.perf_counter() - t_start))
        mode = mix["mode"]
        bp = int(mix.get("batch_pairs", 1))

        def drive(reqs, secs, sampler=None):
            if mode == "serial":
                return serial(chain, reqs, secs, sampler, sync)
            return pipelined(chain, reqs, secs, bp, sampler, sync)

        # warm-up: this cell's own shapes and cache paths, other keys
        warm = T.edit_requests(seed, mix, pool, stream=1, prefix="w")
        if mode == "serial":
            for _ in range(int(mix["warmup_requests"])):
                _edit(chain, next(warm))
        else:
            chunks = [[next(warm) for _ in range(bp)]
                      for _ in range(int(mix["warmup_chunks"]))]
            for _ in chain.edit_frames_pipelined(chunks):
                pass
        if sync is not None:
            sync()
        setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", setup_s))
        print("set-up, s from process start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks), file=sys.stderr)

        reqs = T.edit_requests(seed, mix, pool)
        sampler = Sampler(int(cfg["check"]["sample"]), seed)
        out = {"trace": None}
        if not trace:
            lat, done, window = drive(reqs, seconds, sampler)
            metrics = {"setup_s": setup_s,
                       "edits_per_s": len(done) / window}
            if lat is not None:
                metrics["edit_ms_p95"] = float(
                    np.percentile(np.asarray(lat) * 1e3, 95))
            out["metrics"] = metrics
        else:
            from sdn3d_tpu_torch.utils import phases
            prof_s = seconds * float(mix.get("profiler_share", 0.4))
            (_, done_p, _), prof, wall_p = common.profiled(
                lambda: drive(reqs, prof_s, sampler), on_card)
            summary = common.trace_summary(prof, wall_p)
            del prof
            phases.reset(True)
            try:
                _, done_ph, _ = drive(reqs, seconds - prof_s, sampler)
                snap = phases.snapshot()
            finally:
                phases.reset(False)
            done = done_p + done_ph
            summary.update({
                "units_prof": len(done_p), "phases": snap,
                "units_phase": len(done_ph),
                "misses_prof": sum(r["first"] for r in done_p),
                "images_per_b1_call": 16 * (bp if mode == "pipelined"
                                            else 1)})
            out["trace"] = summary
        out["attempted"] = len(done)
        out["failed"] = 0
        if on_card:
            out["device"] = common.device_record(device)
        else:
            out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}

        sample = sampler.sample()
        del chain, reqs, warm
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        from perfbench.reference import chain_ref
        judged = chain_ref.judge(cfg, mesh_root, seed, device, sample,
                                 with_counts=trace, control=control)
        out["checks"] = judged["checks"]
        out["control"] = judged.get("control")
        out["readings"] = judged["readings"]
        out["objects_drawn"] = judged["objects_drawn"]
        out["correct"] = judged["correct"]
        if trace:
            t = out["trace"]
            t.update(chain_ref.trace_work(cfg, judged))
            t["flops_prof"] = (t["units_prof"] * t["flops_per_request"]
                               + t["misses_prof"] * t["flops_per_miss"])
            t["peaks"] = counts.peaks_for(out["device"]["kind"])
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
