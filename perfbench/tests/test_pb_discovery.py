"""The harness is driven by data: a cell added as a configuration file,
a traffic file, a metric reader and BENCHMARK.json entries is found by
name, and no existing file of the benchmark changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench.harness import discovery

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digests(root):
    out = {}
    for d, _, names in os.walk(os.path.join(root, "perfbench")):
        if "__pycache__" in d:
            continue
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def copy_benchmark(dst):
    shutil.copytree(BENCH, os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


def test_every_cell_resolves():
    bench = discovery.load_benchmark(ROOT)
    for name in discovery.cell_names(bench):
        cell = discovery.load_cell(ROOT, bench, name)
        discovery.driver(cell["config"]["driver"])
        for m in cell["per_layer"]:
            assert callable(discovery.metric_reader(m["name"]).read)
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]


def test_a_cell_added_as_data(tmp_path):
    root = str(tmp_path)
    copy_benchmark(root)
    before = digests(root)
    pb = os.path.join(root, "perfbench")
    cfg = json.load(open(os.path.join(pb, "configs", "chain_gt.json")))
    cfg["name"] = "chain_other"
    json.dump(cfg, open(os.path.join(pb, "configs", "chain_other.json"),
                        "w"))
    mix = json.load(open(os.path.join(pb, "traffic", "fresh.json")))
    mix["session_len"] = 3
    json.dump(mix, open(os.path.join(pb, "traffic", "triples.json"), "w"))
    with open(os.path.join(pb, "metrics", "pairs_traced.edit.py"), "w") as fh:
        fh.write("def read(t):\n    return t['units_prof']\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(bench["configs"][0], name="chain_other",
                                 file="perfbench/configs/chain_other.json"))
    bench["workloads"].append({"name": "chain_other.triples",
                               "config": "chain_other",
                               "traffic": "triples", "chips": 1,
                               "why": "three edits a frame"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "chain_gt.fresh" in m["workloads"]:
            m["workloads"].append("chain_other.triples")
    bench["per_layer"].append({"name": "pairs_traced.edit", "unit": "pairs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "chain", "moves": "edits_per_s",
                               "workloads": ["chain_other.triples"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

    # the copy's own discovery lists and resolves the new cell
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from perfbench.harness import discovery as d;"
        "b = d.load_benchmark(sys.argv[1]);"
        "c = d.load_cell(sys.argv[1], b, 'chain_other.triples');"
        "print(d.cell_names(b)[-1], c['config']['name'],"
        " c['traffic']['session_len'],"
        " [m['name'] for m in c['per_layer']],"
        " d.metric_reader('pairs_traced.edit').read({'units_prof': 4}))")
    out = subprocess.run([sys.executable, "-c", code, root], cwd=root,
                         capture_output=True, text=True, check=True).stdout
    assert out.split()[0] == "chain_other.triples"
    assert "chain_other" in out and "pairs_traced.edit" in out
    assert out.strip().endswith("4")


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "chain_gt.fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA card only" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ exits with
    another code than 0 and prints no result."""
    root = str(tmp_path)
    copy_benchmark(root)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "chain_gt.fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert "{" not in proc.stdout
