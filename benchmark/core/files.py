"""Everything of a cell is found by name under the benchmark's folder:

- ``configs/<config>.json``: a recipe copied in full (``recipe``), its
  ``source``, what was ``reduced`` and ``assumed``, the stand-in
  vocabulary and the weights' rules;
- ``workloads/<cell>.json``: the cell's configuration, traffic generator,
  driving loop, parameters, chips, why, and the limits of its check;
- ``traffic/<kind>.py``: a generator of host inputs from the seed;
- ``loops/<loop>.py``: the loop that drives the program under test and
  records its calls;
- ``checks/<loop>.py``: the comparison with the reference;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``roofline/<kernel>.py`` and ``flops/<encoder>.py``: a kernel's work and
  an encoder's model FLOPs;
- ``peaks.json``: the card's published peaks.

``BENCHMARK.json`` at the root of the checkout lists which metrics a cell
reports. Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT.parent / "BENCHMARK.json")


def workload(name: str) -> dict:
    w = load_json(ROOT / "workloads" / f"{name}.json")
    if w.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {w.get('name')!r}")
    return w


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def peaks() -> dict:
    return load_json(ROOT / "peaks.json")


def module(kind: str, name: str):
    """Import ``<kind>/<name>.py`` (names may hold dots)."""
    key = f"benchmark.{kind}.{name}".replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    s = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(s)
    sys.modules[key] = mod
    s.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, trace: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` gives ``cell`` in this kind of run:
    end-to-end ones without tracing, per-layer ones with it."""
    out = []
    for m in spec()["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def cell_chips(cell: str) -> int:
    for w in spec()["workloads"]:
        if w["name"] == cell:
            return w["chips"]
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
