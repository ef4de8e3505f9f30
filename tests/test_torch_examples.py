"""The port's examples (``examples/*_torch.py``) on the CPU.

Each example's ``main`` runs with ``--device cpu`` and its smallest
arguments and must return cleanly (the examples assert their own error
bounds, finite logits and a falling loss).  The quickstart's compression
ratios are held to the JAX package's numpy route on the same field: the
streams are byte-identical, so the printed ratios are equal.  Without
``--device`` each refuses to run on a machine without a card.
"""
import importlib.util
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Bound as RBound, SZxCodec as RSZxCodec, compress_with_stats
from repro.data import scidata as rscidata
from repro_torch.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
NAMES = ["quickstart_torch", "compress_checkpoint_torch", "serve_lm_torch", "train_lm_torch"]


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_ratios_are_the_references(capsys):
    _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "error bound strictly respected at every setting" in out
    _name, x = next(iter(rscidata.fields("Miranda")))    # the same field in this process
    ratios = dict(re.findall(r"REL=(\S+): CR=\s*(\S+)", out))
    assert len(ratios) == 3
    for rel, got in ratios.items():
        _buf, stats = compress_with_stats(x, RBound.rel(float(rel)), backend="numpy")
        assert got == f"{stats.ratio:.2f}", rel
    native = dict(re.findall(r"native (\w+): CR=\s*(\S+)", out))
    codec = RSZxCodec(backend="numpy")
    for dtype in ("float64", "float16"):
        xd = x.astype(dtype)
        assert native[dtype] == f"{xd.nbytes / len(codec.compress(xd, RBound.rel(1e-2))):.2f}"
    assert re.search(r"chunked: .* max\|err\|/e=0\.\d+", out)
    assert re.search(r"store: \d+ chunks .* query mean=", out)


def test_compress_checkpoint_within_bound(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _example("compress_checkpoint_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    raw = re.search(r"raw\s+:\s+(\S+) MB\s+ratio=\s*(\S+)", out)
    szx = re.search(r"szx\(rel 1e-5\)\s*:\s+(\S+) MB\s+ratio=\s*(\S+).*worst rel err=(\S+)", out)
    assert raw and szx, out
    assert float(raw.group(2)) == 1.0 and float(szx.group(2)) > 1.0
    assert float(szx.group(3)) <= 1e-5
    assert not list(tmp_path.iterdir())                  # both checkpoints removed


def test_serve_lm_both_cache_modes(capsys):
    firsts = _example("serve_lm_torch").main(["--device", "cpu", "--batch", "2", "--prompt",
                                              "8", "--tokens", "4"])
    out = capsys.readouterr().out
    assert out.count("tok/s") == 2 and "kv=compressed" in out
    assert len(firsts["dense"]) == len(firsts["compressed"]) == 4
    # the first token comes from the prefill's logits, the same in both modes
    assert firsts["dense"][0] == firsts["compressed"][0]


def test_train_lm_reduces_the_loss_and_checkpoints(capsys, tmp_path):
    tr = _example("train_lm_torch").main(["--device", "cpu", "--steps", "30", "--d-model",
                                          "32", "--layers", "1", "--seq", "16", "--batch", "2",
                                          "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(tr.history) == 30 and tr.history[-1]["loss"] < tr.history[0]["loss"]
    assert "loss:" in out and "checkpoint stats:" in out
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    assert ckpt.all_steps() == [29] and ckpt.stats()["ratio"] > 1.0
    assert all(np.isfinite(h["loss"]) for h in tr.history)


@pytest.mark.parametrize("name", NAMES)
def test_examples_refuse_to_run_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
