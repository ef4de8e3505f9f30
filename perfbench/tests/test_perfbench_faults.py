"""Whole runs of each cell at CPU size, past the look for a card: a sound
run is correct, and a run whose timed path is broken underneath (the
program patched) is not, once for each fault the cell can have.  Then the
control at CPU size: the float8 reference in the program's place fails the
check.  And the result line's keys."""
import json

import pytest
import torch
from conftest import SEED, run_cell

from perfbench import control

PREFILL = ["yi-6b.rag-prefill-4k.szx-kv1"]
TRAIN = ["h2o-danube-1.8b.pretrain-2k.szx-grad1", "h2o-danube-1.8b.pretrain-2k.plain"]


def token_altered(monkeypatch):
    from repro_torch.models import transformer as T

    real = T.logits_for
    monkeypatch.setattr(T, "logits_for", lambda *a, **k: torch.roll(real(*a, **k), 1, -1))


def cache_left_empty(monkeypatch):
    from repro_torch.serve import engine as E

    monkeypatch.setattr(E, "fill_cache", lambda cache, *a, **k: cache)


def state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(self, grads, state, params, **kw):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(adamw.AdamW, "update", update)


def half_batch(monkeypatch):
    from repro_torch.train import step

    real = step.value_and_grad
    monkeypatch.setattr(step, "value_and_grad", lambda cfg, params, batch: real(
        cfg, params, {k: v[: len(v) // 2] for k, v in batch.items()}))


def exchange_left_out(monkeypatch):
    from repro_torch.core import grad_compress
    from repro_torch.core.pytree import tree_map

    monkeypatch.setattr(grad_compress, "compressed_psum_mean", lambda g, group=None, **kw: (
        g, tree_map(torch.zeros_like, g)))


FAULTS = [(w, f) for w in PREFILL for f in (token_altered, cache_left_empty)]
FAULTS += [(w, f) for w in TRAIN for f in (state_unchanged, half_batch)]
FAULTS += [(TRAIN[0], exchange_left_out)]


@pytest.mark.parametrize("workload", PREFILL + TRAIN)
def test_sound_run_is_correct(tiny_bench, workload):
    out, run = run_cell(tiny_bench, workload)
    assert out["correct"], out["checks"]
    assert run.attempted > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload, fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, workload, fault):
    fault(monkeypatch)
    out, _ = run_cell(tiny_bench, workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload, variant", [(w, "fp8") for w in PREFILL + TRAIN])
def test_control_is_not_correct(tiny_bench, workload, variant):
    checks = control.readings(workload, SEED, variant, "cpu", tiny_bench)
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("workload", [PREFILL[0], TRAIN[0]])
def test_result_line_keys(tiny_bench, workload):
    out, run = run_cell(tiny_bench, workload, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "setup_parts", "checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))
    plain, _ = run_cell(tiny_bench, workload)
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "setup_parts",
                           "checks"]
    assert "setup_s" in plain["metrics"]
    for m in plain["metrics"].values():
        assert set(m) == {"value", "unit"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", PREFILL + TRAIN)
def test_cell_on_the_card(workload):
    """A short run of each cell at full size (``python -m pytest -m cuda
    perfbench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import harness
    out, _ = run_cell(harness.load_bench(), workload, seconds=3.0, seed=SEED + 1,
                      device="cuda")
    assert out["correct"], out["checks"]
