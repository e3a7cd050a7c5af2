"""The benchmark's files, found by name.

`BENCHMARK.json` at the root of the checkout names every cell, its
configuration and its traffic, and every metric. A cell's files are:

- the configuration's `file` (`perfbench/configs/<config>.json`): the
  published sizes, the model `kind`, what was cut and why;
- `perfbench/traffic/<traffic>.json`: the job (batch, sequence length,
  warm-up and profiled steps, optimizer settings);
- `perfbench/workloads/<cell>.json`: the limits of the check that decides
  `correct`, with the readings they were set from;
- `perfbench/metrics/<metric>.py`: each metric's reader, end-to-end and
  per-layer;
- `perfbench/kinds/<kind>.py`, `perfbench/reference/<kind>.py` and
  `perfbench/layouts/<kind>.py`: the system under test for the model kind,
  its plain reference, and the parameters and weights both take.

A later cell, configuration, traffic mix or metric is new files and new
entries in `BENCHMARK.json`; no file here needs an edit.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # the check's limits, by the number's name
    end_to_end: tuple  # BENCHMARK.json entries that this cell reports
    per_layer: tuple


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_json(root / cfg["file"]),
        traffic=_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(PACKAGE / "workloads" / f"{name}.json")["limits"],
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def kind_module(kind: str):
    """`perfbench.kinds.<kind>`: builds and steps the port for this kind."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def reference_module(kind: str):
    """`perfbench.reference.<kind>`: the plain reference for this kind."""
    return importlib.import_module(f"perfbench.reference.{kind}")


def metric_reader(name: str):
    """`perfbench.metrics.<name>`: the metric's reader, `read(run)`."""
    return importlib.import_module(f"perfbench.metrics.{name}")
