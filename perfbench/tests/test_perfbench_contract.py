"""BENCHMARK.json against the benchmark's contract: names, units and keys;
every cell's configuration, mix and limits found by name; a reader for
every metric; each per-layer metric's cells reporting what it moves."""
import json
import re

import pytest
from conftest import REPO

from perfbench import harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head).*|.*(_dim|_rank|_size)$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_allowed(part):
    names = [e["name"] for e in BENCH[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(m):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    assert callable(harness.reader(m["name"]))
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_metric_everywhere():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    conf = harness.config_file(BENCH, w["config"])
    mix = harness.mix_file(w["traffic"])
    assert mix["kind"] in ("prefill", "train")
    assert (REPO / "perfbench" / "drivers" / f"{mix['kind']}.py").is_file()
    limits = harness.limits_file(w["name"])
    assert limits and all(v > 0 for v in limits.values())
    assert conf["hidden_size"] and conf["num_hidden_layers"]
    e2e = harness.metrics_for(BENCH, w["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_for(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m["workloads"]:
        assert m["moves"] in {e["name"] for e in harness.metrics_for(BENCH, w, False)}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
    conf = json.loads((REPO / c["file"]).read_text())
    assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME.match(key) and not WIDTH.match(key), key
    assert c["source"].startswith("https://") and len(c["source"]) <= 200
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_check_budget_fits():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
