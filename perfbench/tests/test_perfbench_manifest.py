"""BENCHMARK.json and every file it names: present, parsed, found by name,
and within the benchmark contract's limits. CPU only, no card."""

import json
import math
import re
from pathlib import Path

import pytest

from perfbench.harness import manifest
from perfbench.harness.cell import instance_params

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
TEXT = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into its 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        manifest.check_name(n, "name")
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for m in METRICS:
        assert manifest.UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.fullmatch(c["why"]) and TEXT.fullmatch(c["source"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert TEXT.fullmatch(w["why"])
        assert w["chips"] in (1, 4)


def test_pairs_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("perfbench/") and (ROOT / f).is_file()


def test_end_to_end_and_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert TEXT.fullmatch(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert manifest.applies(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = manifest.cell(ROOT, BENCH, cell)
    assert manifest.family(c.config["family"]).build
    ref = manifest.reference(c.config["family"])
    assert ref.check and ref.shape and ref.dense
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert manifest.metric_reader(m["name"]).read
    lim = c.traffic["limits"]
    assert set(lim) == {"gap", "primal_error", "dual_error", "cone"}
    assert lim["cone"] == 0            # exact: no block outside the cone
    assert all(math.isfinite(v) and v > 0
               for k, v in lim.items() if k != "cone")


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_gets_the_same_instances(cell):
    c = manifest.cell(ROOT, BENCH, cell)
    key = c.config["vary"]["key"]
    sets = [sorted(p[key] for p in instance_params(c.config, c.traffic, s))
            for s in (0, 1, 2 ** 31 + 7, 10 ** 12)]
    assert all(s == sets[0] for s in sets)
    assert len(sets[0]) == int(c.traffic["instances"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell(ROOT, BENCH, "no-such-cell")
    with pytest.raises(ValueError):
        manifest.check_name("has space", "name")
    with pytest.raises(FileNotFoundError):
        manifest.metric_reader("no_such_metric")
