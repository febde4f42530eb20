"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the entry's ``file``; the traffic mix is
``perfbench/traffic/<traffic>.json``; each metric is read by
``perfbench/metrics/<metric>.py``; a configuration's ``family`` is built by
``perfbench/families/<family>.py`` and checked by
``perfbench/reference/<family>.py``. A later cell, mix, metric or family is
a new file here, and no file that exists changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a name: 1-64 letters, "
                         f"digits, '_', '.' and '-', not starting with "
                         f"'.' or '-'")
    return name


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str):
    """The Python file ``path`` as a module (metric, family and reference
    names may hold '.' and '-', which an import statement cannot)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # metric entries that this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_bench(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(root: Path, bench: dict, name: str) -> Cell:
    check_name(name, "workload")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    w = found[0]
    cfgs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(cfgs) != 1:
        raise KeyError(f"configuration {w['config']!r} is not in "
                       f"BENCHMARK.json")
    traffic = check_name(w["traffic"], "traffic")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=traffic,
        config=load_json(root / cfgs[0]["file"]),
        traffic=load_json(PKG / "traffic" / f"{traffic}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def metric_reader(name: str):
    return load_module(PKG / "metrics" / f"{check_name(name, 'metric')}.py",
                       "metric")


def family(name: str):
    return load_module(PKG / "families" / f"{check_name(name, 'family')}.py",
                       "family")


def reference(name: str):
    return load_module(PKG / "reference" / f"{check_name(name, 'family')}.py",
                       "reference")
