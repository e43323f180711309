"""Cells of BENCHMARK.json cut to sizes a CPU test can hold: the same
drivers, traffic generator and reference, at tiny frames and meshes."""

import copy
import os

from perfbench.harness import discovery

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell(name: str, device: str = "cpu", shrink: bool = True):
    """The cell `name` on `device`, cut to tiny sizes unless `shrink` is
    false."""
    bench = discovery.load_benchmark(ROOT)
    c = copy.deepcopy(discovery.load_cell(ROOT, bench, name))
    cfg, mix = c["config"], c["traffic"]
    cfg["device"] = device
    if not shrink:
        return c
    cfg["meshes"] = {"count": 8, "n_theta": 6, "n_phi": 12, "faces": 120}
    if "chain" in cfg:
        cfg["chain"].update(scales=[24], image_size=32, render_size=32,
                            load_size=208, fine_width=208, fine_height=64)
        cfg["frame"] = {"height": 140, "width": 430}
        cfg["check"]["sample"] = 2
        mix["pool_frames"] = 4
    else:
        cfg["trainer"].update(batch_size=2, image_size=32, render_size=32)
        mix["pool_batches"] = 3
    return c
