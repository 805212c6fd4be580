"""Finds a cell's parts by the names in ``BENCHMARK.json``.

Nothing here names a cell, configuration, traffic mix or metric: each is a
file of its own, found by name, so a later change adds one as new files and
new entries and edits nothing that is there.

- ``BENCHMARK.json``'s ``configs[].file``: one deployment (JSON);
- ``traffic/<traffic>.json``: one traffic mix's parameters, with the name
  of the driver (``drivers/<driver>.py``) that runs them;
- ``metrics/<metric>.py``: one metric's reader, ``read(run)``;
- ``reference/<reference>.py``: a method's plain reference, which states
  in ``STATISTICS`` how its transform reads a call (``check.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# What a reference's ``STATISTICS`` may state: each output row depends on its
# own input row and the fit alone, or on the call's whole input.
STATISTICS = ("image", "call")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str, here: Path = HERE):
    """``<here>/<kind>/<name>.py``, loaded by path (a name may hold dots)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"portbench.{kind}.{name}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # A per-layer metric with no list goes wherever its end-to-end metric does.
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, bench: dict | None = None, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    reference = load_module("reference", config["reference"], here)
    stated = getattr(reference, "STATISTICS", None)
    if stated not in STATISTICS:
        raise ValueError(f"reference {config['reference']!r} of {name!r} states STATISTICS "
                         f"{stated!r}: it has to state one of {STATISTICS}, how its transform "
                         "reads a call, for the check to compare the right rows")
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer)
