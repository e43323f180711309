"""Finds a cell's parts by the names in BENCHMARK.json: its
configuration file, the driver the configuration names
(drivers/<driver>.py), its traffic mix (traffic/<traffic>.json) and the
readers of its per-layer metrics (metrics/<metric>.py).  Adding a cell,
a mix or a metric adds files and entries; no existing file changes."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_names(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]


def load_cell(root: str, bench: Dict, name: str) -> Dict:
    """{workload, config (its JSON), config_entry, traffic (its JSON),
    end_to_end, per_layer} of the cell `name`."""
    byname = {w["name"]: w for w in bench["workloads"]}
    if name not in byname:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(byname)})")
    w = byname[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return {"workload": w, "config": config, "config_entry": entry,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer}


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return load_module(os.path.join(HERE, "drivers", name + ".py"),
                       f"perfbench_driver_{name}")


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "perfbench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))
