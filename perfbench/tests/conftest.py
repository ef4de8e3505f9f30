"""Shared fixtures: ``BENCHMARK.json`` with its configurations swapped for
CPU-sized stand-ins (``tests/data/tiny-*.json``) and its mixes cut to short
prompts and rows, so that a whole run of a cell fits in a CPU test."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import harness  # noqa: E402

TINY = {"yi-6b": "perfbench/tests/data/tiny-yi.json",
        "h2o-danube-1.8b": "perfbench/tests/data/tiny-danube.json"}
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold, as seeds may be


def small_mix(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["kind"] == "prefill":
        mix["prompt_len"].update(lo=8, hi=96, round=8)
        mix["check"] = {"requests": 4, "from_first": 16}
        mix["trace"] = {"start_frac": 0.3, "seconds": 0.3}
    else:
        mix.update(batch=2, seq=32, max_steps=6)
    return mix


@pytest.fixture
def tiny_bench(monkeypatch):
    """The benchmark at CPU size: tiny configurations, short mixes."""
    bench = harness.load_bench()
    for c in bench["configs"]:
        c["file"] = TINY[c["name"]]
    real = harness.mix_file
    monkeypatch.setattr(harness, "mix_file", lambda name: small_mix(real(name)))
    return bench


def run_cell(bench, workload: str, seconds: float = 0.5, trace: bool = False, seed: int = SEED,
             device: str = "cpu"):
    import time

    from perfbench import run

    return run.execute(workload, seed, seconds, trace, device, bench,
                       t_start=time.perf_counter())
