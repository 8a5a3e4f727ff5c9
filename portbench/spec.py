"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
piece's data sits in a file of its own under ``portbench/``, so a later
change adds a configuration, a mix, a cell or a metric by adding files:

* ``configs/<config>.json``  the configuration as it is run;
* ``mixes/<traffic>.json``   the traffic mix's parameters;
* ``cells/<workload>.json``  the cell's correctness limits;
* ``metrics/<metric>.py``    the metric's reader, ``read(rec) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those whose ``workloads`` list it, or that have no list."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one cell is made of, found by the names in BENCHMARK.json."""
    w = workload(bench, name)
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return dict(pieces(name, root / conf_entry["file"], w["traffic"], root), workload=w,
                end_to_end=metrics_of(bench, name, "end_to_end"),
                per_layer=metrics_of(bench, name, "per_layer"))


def pieces(name: str, config_file: Path, traffic: str, root: Path = ROOT) -> dict:
    """A cell's data files: its configuration, its mix and its own file."""
    here = root / "portbench"
    return {"name": name, "config": load_json(config_file),
            "mix": load_json(here / "mixes" / f"{traffic}.json"),
            "cell": load_json(here / "cells" / f"{name}.json")}


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
