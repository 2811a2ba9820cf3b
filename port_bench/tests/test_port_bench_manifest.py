"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every cell, metric and configuration resolving to its files."""

import json
import math
import re

import pytest

from port_bench import harness

M = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and (harness.REPO / p).is_dir()


def test_run_seconds_fit_the_check_with_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"port_bench/configs/{c['name']}.json" and (harness.REPO / c["file"]).is_file()
    assert c["reduced"] == [] and harness.load_json(harness.REPO / c["file"])["reduced"] == []
    assert any(w["config"] == c["name"] for w in M["workloads"])


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cells_resolve_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    cell = harness.resolve(w["name"])
    loop = harness.load_loop(cell.traffic["loop"])
    assert cell.limits and set(cell.limits) <= set(loop.READINGS) and all(v > 0 for v in cell.limits.values())
    kinds = {m["kind"] for m in cell.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    e2e = [m["name"] for m in cell.metrics if m["kind"] == "end_to_end"]
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metrics(m):
    e2e = m in M["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in (("host_clock", "device_trace") if e2e else
                           ("device_trace", "program_span", "program_counter", "host_clock"))
    assert all(w in CELLS for w in m.get("workloads", []))
    assert callable(harness.reader(m["name"]))
    if e2e:
        assert 0.01 <= m["bound"] <= 0.25 and not math.isnan(m["bound"])
    else:
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    if m["name"].endswith("_roofline") or "mfu" in m["name"] or "_roofline." in m["name"]:
        assert m["unit"] == "%"


def test_setup_bound():
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
