"""Readings of the correctness check over many seeds, for setting its
limits (not part of a measured run):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control]

Each seed runs the cell once (untraced, a window of --seconds) in this
process and prints one JSON line: the program's readings and, with
--control, the control's readings on the same sampled requests (the
reference computed in the next precision below the configuration's, in
the program's place).  With --fault <name>, one of FAULTS is planted in
the program's timed path for every run (perfbench/tests/test_pb_faults.py
plants the same ones)."""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"             # as perfbench/run.py sets them


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def state_unchanged():
    """A training step that returns its state unchanged."""
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer
    return _patched(DerenderTrainer, "apply_gradients",
                    lambda real: lambda self, state, grads: state)


def half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer

    def make(real):
        def gradients(self, state, batch, generator):
            n = batch["images"].shape[0] // 2
            return real(self, state, {k: v[:n] for k, v in batch.items()},
                        generator)
        return gradients
    return _patched(DerenderTrainer, "gradients", make)


def fake_altered():
    """Every generated frame altered where it is produced."""
    import numpy as np

    from sdn3d_tpu_torch.pipelines.chain import EditChain

    def make(real):
        def generate(self, items):
            fakes, maps = real(self, items)
            return [np.asarray(f) + 0.01 for f in fakes], maps
        return generate
    return _patched(EditChain, "_generate_items", make)


def label_altered():
    """Every label map altered where it is produced (four rows)."""
    import numpy as np

    from sdn3d_tpu_torch.pipelines.chain import EditChain

    def make(real):
        def labels(self, image_rgb, cache_key=None):
            lab = np.array(real(self, image_rgb, cache_key=cache_key))
            lab[:4] = (lab[:4] + 1) % 14
            return lab
        return labels
    return _patched(EditChain, "labels", make)


def edit_dropped():
    """The edit operations dropped before the re-render."""
    from sdn3d_tpu_torch.pipelines.chain import EditChain

    def make(real):
        def derender(self, image_rgb, dets, operations=None,
                     cache_key=None):
            return real(self, image_rgb, dets, None, cache_key=cache_key)
        return derender
    return _patched(EditChain, "derender", make)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                   fake_altered, label_altered,
                                   edit_dropped)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    from perfbench.harness import common, discovery
    bench = discovery.load_benchmark(ROOT)
    cell = discovery.load_cell(ROOT, bench, args.workload)
    common.check_card(int(cell["workload"]["chips"]))
    drv = discovery.driver(cell["config"]["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with (FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            out = drv.run(cell, seed=seed, seconds=args.seconds, trace=False,
                          t_start=t0, control=args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "program": out["readings"],
            "control": out.get("control"), "correct": out["correct"],
            "metrics": out["metrics"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "objects_drawn": out.get("objects_drawn"),
            "attempted": out["attempted"],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
