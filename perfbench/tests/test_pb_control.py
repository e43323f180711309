"""On a card: the control (the frozen reference computed in TF32, the
precision below the configuration's float32 with TF32 off, in the
program's place) fails at least one of each cell's numbers, while the
program passes all of them.  The chain cells run at tiny frames; the
training cell at its own size (1.7 GB, a few seconds a step of the
reference), because its limits hold Adam's amplification of the
kernels' summation order at the batch they were read at.  The card is
looked for inside the test; without one it skips."""

import time

import pytest

from perfbench.harness import discovery
from perfbench.tests import tiny

CELLS = ["chain_gt.fresh", "derender_train.full", "chain_gt.reedit",
         "chain_gt.batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_fails_where_the_program_passes(name, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = discovery.load_benchmark(tiny.ROOT)
    if name not in discovery.cell_names(bench):
        pytest.skip(f"{name} is not a cell of BENCHMARK.json")
    cell = tiny.cell(name, device="cuda",
                     shrink=not name.startswith("derender_train"))
    out = discovery.driver(cell["config"]["driver"]).run(
        cell, seed=seed, seconds=1.0, trace=False,
        t_start=time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert any(out["control"][k] > lim
               for k, (_, lim) in out["checks"].items()), out["control"]
