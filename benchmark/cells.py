"""Finds a cell's pieces by name: its entry in BENCHMARK.json, its
configuration (configs/<name>.json), its traffic mix (traffic/<name>.json)
and the reader of each metric it reports (metrics/<name>.py). Nothing here
names a cell, a configuration, a traffic mix or a metric: a later change adds
one by adding its file and its entry."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object          # read(record) -> number or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # [Metric]
    per_layer: list       # [Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, where: Path = HERE / "metrics"):
    """The `read` function of metrics/<name>.py."""
    path = where / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry of BENCHMARK.json is reported in `cell`."""
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, spec_path: Path = ROOT / "BENCHMARK.json",
              where: Path = HERE) -> Cell:
    """The cell `workload` of the benchmark at spec_path; its files under
    `where`. Raises KeyError for a cell the benchmark does not hold."""
    spec = load_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {spec_path}: "
                       + ", ".join(w["name"] for w in spec["workloads"]))

    def metrics(key):
        return [Metric(m["name"], m["unit"],
                       load_reader(m["name"], where / "metrics"))
                for m in spec[key] if reports(m, workload)]

    return Cell(
        name=workload, chips=entry["chips"],
        config=load_json(where / "configs" / f"{entry['config']}.json"),
        traffic=load_json(where / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))


def read_metrics(metrics: list, record: dict) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something in the record; a reader that returns None is left out."""
    out = {}
    for m in metrics:
        v = m.read(record)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out
