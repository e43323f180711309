"""The check sees faults planted in the timed path underneath a run
(the look for a card skipped, tiny sizes on the CPU): `correct` comes
out false for each fault the cell can have (perfbench/calibrate.py's
FAULTS, which read them at the cells' own size on a card)."""

import time

import pytest

from perfbench.calibrate import FAULTS
from perfbench.harness import discovery
from perfbench.tests import tiny

CASES = [("derender_train.full", "state_unchanged", "update_gap"),
         ("derender_train.full", "half_batch", None),
         ("chain_gt.fresh", "fake_altered", "fake_gap"),
         ("chain_gt.batch", "fake_altered", "fake_gap"),
         ("chain_gt.fresh", "label_altered", "label_gap"),
         ("chain_gt.fresh", "edit_dropped", None)]


@pytest.mark.parametrize("name,fault,number", CASES)
def test_fault_makes_the_run_incorrect(name, fault, number):
    cell = tiny.cell(name)
    drv = discovery.driver(cell["config"]["driver"])
    with FAULTS[fault]():
        out = drv.run(cell, seed=99, seconds=1.0, trace=False,
                      t_start=time.perf_counter())
    assert not out["correct"], out["checks"]
    if number is not None:
        value, limit = out["checks"][number]
        assert value > limit
