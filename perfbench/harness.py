"""What the benchmark finds by name: ``BENCHMARK.json``'s cells and metrics,
a configuration's file (``configs/<config>.json``), a traffic mix's file
(``traffic/<traffic>.json``), a cell's limits (``limits/<workload>.json``)
and each metric's reader (``metrics/<metric>.py``, whose ``read(run)``
returns a number or None where it finds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_bench(path: Path | None = None) -> dict:
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((REPO / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix_file(traffic: str) -> dict:
    return json.loads((HERE / "traffic" / f"{traffic}.json").read_text())


def limits_file(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]


def applies(metric: dict, workload: str, reported=()) -> bool:
    """Whether ``metric`` is reported in ``workload``: listed there, or with
    no list and (a per-layer metric) its moved metric reported there."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m, workload, names)]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch_config(name: str, conf: dict, mix: dict):
    """The program's ``ArchConfig`` for a configuration file and a mix."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=name, family="dense", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
        vocab_size=conf["vocab_size"], head_dim=conf["head_dim"],
        sliding_window=conf.get("sliding_window") or 0, rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        param_dtype=conf["param_dtype"], compute_dtype=conf["compute_dtype"],
        remat=bool(mix.get("remat", True)))


@dataclass
class Run:
    """What a driver hands to the metric readers and the result line."""

    workload: str
    arch: object                   # reference.model.Arch
    mix: dict
    device_kind: str
    t_start: float = 0.0           # process start (host clock)
    setup_s: float = 0.0
    t0: float = 0.0                # window start and end (host clock, synchronized)
    t1: float = 0.0
    requests: list = field(default_factory=list)   # (issue, token_on_host, prompt_len, enqueue_s)
    steps: list = field(default_factory=list)      # (start, end, tokens)
    trace: object = None                           # trace.Trace of the traced part
    checks: dict = field(default_factory=dict)     # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    check_s: float = 0.0                           # the reference's check, after the window
    setup_parts: dict = field(default_factory=dict)   # seconds of each part of set-up
    t_mark: float = 0.0

    def mark(self, part: str) -> None:
        """Close the set-up part ``part``: the host time since the last mark
        (the first from the process's start)."""
        import time

        now = time.perf_counter()
        self.setup_parts[part] = now - self.t_mark
        self.t_mark = now

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def peaks(self) -> dict | None:
        from perfbench import counts

        return counts.peaks(self.device_kind)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for v, lim in self.checks.values())


def worst_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The largest |got - ref| over leaves, each against the larger of the
    reference's value of that leaf and its median leaf's (``keep``: the
    leaves that count)."""
    names = [n for n in ref if keep is None or n in keep]
    vals = sorted(ref[n] for n in names)
    median = vals[len(vals) // 2]
    return max(abs(got[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)
