"""The frozen reference against the port at tiny sizes on the CPU: both
sides of every cell run through their drivers, and every number the
check compares reads 0; the reference's host crops equal the port's
host library's to the bit."""

import time

import numpy as np
import pytest

from perfbench.harness import discovery
from perfbench.harness import traffic as T
from perfbench.tests import tiny


@pytest.mark.parametrize("name", ["chain_gt.fresh", "chain_gt.reedit",
                                  "chain_gt.batch", "derender_train.full"])
def test_cell_reads_zero(name):
    bench = discovery.load_benchmark(tiny.ROOT)
    if name not in discovery.cell_names(bench):
        pytest.skip(f"{name} is not a cell of BENCHMARK.json")
    cell = tiny.cell(name)
    drv = discovery.driver(cell["config"]["driver"])
    out = drv.run(cell, seed=2**31 + 3, seconds=1.0, trace=False,
                  t_start=time.perf_counter())
    assert out["attempted"] > 0
    assert out["correct"], out["checks"]
    assert all(v == 0.0 for v, _ in out["checks"].values()), out["checks"]


def test_crops_equal_the_host_library():
    from perfbench.reference.frozen.data import vkitti as FVK
    from sdn3d_tpu_torch.data import vkitti as VK
    pool = T.frame_pool(5, {"pool_frames": 3, "cars": [5, 16]},
                        {"height": 140, "width": 430})
    for fr in pool:
        img = np.asarray(fr["image"], np.float32) / 255.0
        for roi in fr["rois"]:
            assert np.array_equal(
                VK.transform_rgb_u8(img, roi, 64, prescaled=True),
                FVK.transform_rgb_u8(img, roi, 64, prescaled=True))
