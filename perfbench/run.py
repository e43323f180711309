"""Runs one cell of the benchmark once, on a CUDA card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its driver,
its traffic mix and its metrics' readers are found by name from
BENCHMARK.json (perfbench/harness/discovery.py).  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device[, breakdown], checks); the numbers the correctness check compared
end standard error, each beside its limit.  Without a card, or with
fewer than the cell asks for, it prints no result and exits 3; with a
JAX module loaded after the window, it exits 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# libraries that would load JAX or flax by themselves stay off them
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one thread for the host's thread pools (OpenMP, torch's intra-op pool,
# BLAS): the chain is host-bound, and in four interleaved pairs of
# chain_gt.reedit runs the p95 read 59.7-79.8 ms with the default pools
# and 59.8-64.2 ms with one thread (PERF.md, section 2)
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# the program's build and kernel caches: fixed directories in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".perfbench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench.harness import common, discovery
    bench = discovery.load_benchmark(ROOT)
    cell = discovery.load_cell(ROOT, bench, args.workload)
    try:
        common.check_card(int(cell["workload"]["chips"]))
    except common.NoCard as e:
        print(f"perfbench: {e}; no result", file=sys.stderr)
        return 3
    drv = discovery.driver(cell["config"]["driver"])
    out = drv.run(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=T_START)

    bad = common.forbidden_loaded()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        return 4
    metrics = {}
    if args.trace:
        for m in cell["per_layer"]:
            value = discovery.metric_reader(m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = (out["metrics"][m["name"]], m["unit"])
    device = out["device"]
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    for line in common.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(
        out["correct"], out["attempted"], out["failed"], metrics, device,
        out["checks"],
        out["trace"]["breakdown"] if args.trace else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
