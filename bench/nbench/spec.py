"""The benchmark's definition, read from data: ``BENCHMARK.json`` at the
root of the checkout, each configuration's file, each traffic mix's file
(``bench/traffic/<traffic>.json``) and each metric's reader
(``bench/metrics/<name>.py``, whose ``read(run)`` returns a number or
None) and each configuration's family module (``nbench/family.py``). A
configuration, family, mix, cell or metric is added by adding its file
and its entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

from nbench import family
from nbench.traffic import Mix


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    family: ModuleType             # the configuration's family module
    mix: Mix
    metrics: List[Metric]          # the trace-0 run's
    traced_metrics: List[Metric]   # the trace-1 run's


def _reader(root: Path, name: str) -> Callable:
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load(root: Path, cell_name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    fam = family.load(root, config["model"])
    mix = Mix.load(root / "bench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, cell_name, reported)]

    def metrics(entries):
        return [Metric(m["name"], m["unit"], _reader(root, m["name"]))
                for m in entries]
    return Cell(cell_name, int(w["chips"]), config, fam, mix, metrics(e2e),
                metrics(layer))
