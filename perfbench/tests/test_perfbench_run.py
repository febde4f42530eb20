"""The command as the benchmark's check runs it: with no card it prints no
result and exits non-zero; on a card (``-m gpu``) a short run of each cell
prints one result line with the contract's keys, correct, and the checks
last."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(*args, timeout=900):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_no_card_no_result(no_card):
    r = run("--workload", BENCH["workloads"][0]["name"], "--seed",
            str(2 ** 33 + 1), "--seconds", "1", "--trace", "0", timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr


def test_unknown_workload_fails():
    r = run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
            timeout=300)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_on_the_card(card, cell, trace):
    r = run("--workload", cell, "--seed", str(2 ** 32 + 17), "--seconds",
            "2", "--trace", trace)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kind = "per_layer" if trace == "1" else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
