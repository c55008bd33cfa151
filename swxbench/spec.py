"""The benchmark's definition, found by name.

`BENCHMARK.json` at the root of the checkout names the configurations,
the cells (`workloads`) and the metrics. Everything that belongs to one
of them sits in a file of its own under `swxbench/`, found by its name:

- a configuration: its `file` (`configs/<name>.json`), which also names
  its plain reference (`reference/<module>.py`);
- a traffic mix: `traffic/<mix>.json`, read by the one generator
  (`generator.py`);
- a metric, end to end or per layer: `metrics/<name>.json`, naming a
  reader (`readers/<reader>.py`) and the reader's arguments;
- the limits that decide `correct` in a cell: `limits/<cell>.json`.

So a new cell, configuration or metric that uses an existing reader adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


class SpecError(ValueError):
    """A name that the benchmark does not define, or a file it lacks."""


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{path.relative_to(ROOT)} is missing") from None


def _safe(name: str, what: str) -> str:
    # names become file names: no path separators, no parent hops
    if not name or "/" in name or name.startswith("."):
        raise SpecError(f"bad {what} name {name!r}")
    return name


@dataclass
class Metric:
    name: str
    unit: str
    reader: str
    args: dict

    def read(self, run):
        """The reader's value for this run, or None where it finds
        nothing to read (the metric is then left out of the line)."""
        module = importlib.import_module(
            f"swxbench.readers.{_safe(self.reader, 'reader')}")
        return module.read(run, **self.args)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"swxbench.reference.{_safe(self.config['reference'], 'reference')}")


def benchmark() -> dict:
    return _load_json(BENCHMARK)


def _metric(entry: dict) -> Metric:
    name = _safe(entry["name"], "metric")
    spec = _load_json(PKG / "metrics" / f"{name}.json")
    return Metric(name=name, unit=entry["unit"], reader=spec["reader"],
                  args=spec.get("args", {}))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports; SpecError for a name the benchmark lacks."""
    bench = bench if bench is not None else benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(known: {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names an unknown config "
                        f"{w['config']!r}")
    config = _load_json(ROOT / configs[w["config"]]["file"])
    traffic = _load_json(PKG / "traffic"
                         / f"{_safe(w['traffic'], 'traffic')}.json")
    limits = _load_json(PKG / "limits" / f"{_safe(name, 'workload')}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[_metric(m) for m in bench["end_to_end"]
                    if _applies(m, name)],
        per_layer=[_metric(m) for m in bench["per_layer"]
                   if _applies(m, name)])
