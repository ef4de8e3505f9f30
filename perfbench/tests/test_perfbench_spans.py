"""The readers of the program's spans (``perfbench/spans.py`` and the
``program_span`` metrics): each on a hand-built trace against the value
worked out by hand, nothing where the spans are missing or miscounted, the
spans each traced run of a cell holds at CPU size, and on the card no
device event named after a span."""
import statistics

import pytest
import torch
from conftest import run_cell

from perfbench import harness, spans
from perfbench.trace import Trace

PROGRAM_SPANS = ("serve.prefill", "serve.prefill.forward", "serve.prefill.kv_fill",
                 "train.forward_backward", "train.grad_exchange", "train.optimizer",
                 "gradcomp.encode", "gradcomp.all_gather", "gradcomp.decode")
NEW = {"engine_idle_ms.prefill": "serve.prefill", "engine_launches.prefill": "serve.prefill",
       "gradcomp_ms.train": "train.grad_exchange",
       "gradcomp_idle_ms.train": "train.grad_exchange",
       "optimizer_idle_ms.train": "train.optimizer",
       "optimizer_idle_ms.train.plain": "train.optimizer"}


def _seconds(workload: str) -> float:
    """A window that reaches the traced steps however slow the host (a
    training run stops after the mix's ``max_steps`` anyway)."""
    return 60.0 if "pretrain" in workload else 2.0


class _Run:
    def __init__(self, trace):
        self.trace = trace


def _trace(name: str) -> Trace:
    """Two units of work, a span of ``name`` over each, in microseconds:
    span 1 [0, 1000] meets the device's [100, 300] and [250, 400] (merged
    [100, 400]) and [900, 1500]: busy 300 + 100, idle 600 us, 3 launches;
    span 2 [2000, 2600] holds [2100, 2200]: idle 500 us, 1 launch (the copy
    and the launch at 2700 do not count)."""
    kernels = [("k", 100, 300), ("k", 250, 400), ("k", 900, 1500), ("k", 2100, 2200),
               ("k", 3000, 3100)]
    host = [(0, 1000, name), (2000, 2600, name), (0, 1000, name + ".inner"),
            (10, 20, "cudaLaunchKernel"), (30, 40, "cuLaunchKernelEx"),
            (800, 810, "cudaLaunchKernelExC"), (2010, 2020, "cudaLaunchKernel"),
            (2500, 2510, "cudaMemcpyAsync"), (2700, 2710, "cudaLaunchKernel"),
            (50, 60, "aten::mm")]
    return Trace(window_s=0.004, kernels=kernels, host_ops=host, work=[7, 8])


def test_idle_inside_by_hand():
    tr = _trace("s")
    assert spans.idle_ms(tr, "s") == [0.6, 0.5]
    assert spans.launches(tr, "s") == [3, 1]
    assert spans.idle_us([[0, 10], [20, 30]], 5, 25) == 10
    assert spans.idle_us([[0, 10]], 20, 30) == 10
    assert spans.idle_us([], 20, 30) == 10


@pytest.mark.parametrize("metric, value", [("engine_idle_ms.prefill", 0.55),
                                           ("engine_launches.prefill", 2.0),
                                           ("gradcomp_ms.train", 0.8),
                                           ("gradcomp_idle_ms.train", 0.55),
                                           ("optimizer_idle_ms.train", 0.55),
                                           ("optimizer_idle_ms.train.plain", 0.55)])
def test_reader_by_hand(metric, value):
    got = harness.reader(metric)(_Run(_trace(NEW[metric])))
    assert got == pytest.approx(value)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_finds_nothing(metric):
    read, span = harness.reader(metric), NEW[metric]
    assert read(_Run(None)) is None
    assert read(_Run(_trace("another.span"))) is None           # the parent: no span
    extra = _trace(span)
    extra.host_ops.append((3000, 3050, span))                     # 3 spans, 2 prompts or steps
    assert read(_Run(extra)) is None
    idle = _trace(span)
    idle.kernels = []                                             # no device work
    assert read(_Run(idle)) is None


@pytest.mark.parametrize("workload, want", [
    ("yi-6b.rag-prefill-4k.szx-kv1", {"serve.prefill": 1, "serve.prefill.forward": 1,
                                      "serve.prefill.kv_fill": 1}),
    ("h2o-danube-1.8b.pretrain-2k.szx-grad1", {"train.forward_backward": 1,
                                               "train.grad_exchange": 1, "train.optimizer": 1}),
    ("h2o-danube-1.8b.pretrain-2k.plain", {"train.forward_backward": 1,
                                           "train.grad_exchange": 0, "train.optimizer": 1})])
def test_traced_run_holds_the_spans(tiny_bench, workload, want):
    """One span of each name a traced prompt or step, at CPU size; the
    exchange's per-leaf spans in the compressed step only."""
    out, run = run_cell(tiny_bench, workload, seconds=_seconds(workload), trace=True)
    tr = run.trace
    assert tr.work and out["correct"]
    names = [n for _, _, n in tr.host_ops]
    for name, per_unit in want.items():
        assert names.count(name) == per_unit * len(tr.work), name
    leaves = names.count("gradcomp.encode")
    assert leaves == names.count("gradcomp.all_gather") == names.count("gradcomp.decode") / 2
    assert bool(leaves) == ("szx-grad" in workload)
    for metric in NEW:                           # no device trace on the CPU: no reading
        assert metric not in out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["yi-6b.rag-prefill-4k.szx-kv1",
                                      "h2o-danube-1.8b.pretrain-2k.szx-grad1",
                                      "h2o-danube-1.8b.pretrain-2k.plain"])
def test_no_device_event_bears_a_span_name(tiny_bench, workload):
    """On the card (``python -m pytest -m cuda perfbench/tests``): a traced
    run at CPU size holds the spans on the host and none of their names on
    the device, and each of the cell's span metrics reads a number."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, run = run_cell(tiny_bench, workload, seconds=_seconds(workload), trace=True,
                        device="cuda")
    tr = run.trace
    device_names = {n for n, _, _ in tr.kernels}
    assert tr.kernels and not device_names & set(PROGRAM_SPANS)
    assert not any(n.startswith(PROGRAM_SPANS) for n in device_names)
    host = [n for _, _, n in tr.host_ops]
    assert host.count("serve.prefill") + host.count("train.optimizer") == len(tr.work)
    for m in harness.load_bench()["per_layer"]:
        if m["name"] in NEW and workload in m["workloads"]:
            assert out["metrics"][m["name"]]["value"] >= 0, m["name"]
    idle = spans.idle_ms(tr, "serve.prefill" if "prefill" in workload else "train.optimizer")
    assert statistics.median(idle) <= tr.window_s * 1e3
