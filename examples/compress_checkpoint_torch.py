"""Checkpoint compression demo (PyTorch port; the paper's Fig. 13 dump/load
use case at framework level): save a model state raw vs SZx-compressed on
the card, compare size and verify the error bound end to end.

    PYTHONPATH=src python examples/compress_checkpoint_torch.py [--device cpu]

The counterpart of ``examples/compress_checkpoint.py``: the same reduced
llama3.2-1b (4 layers, d_model 512), its weights drawn on the device from
seed 0, saved under the temporary directory.  Without ``--device`` it runs
on the card, and fails without one.
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.api import Bound
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pytree
from repro_torch.core.codec import plan
from repro_torch.core.codec.device import resolve_device
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples/compress_checkpoint_torch.py")

    cfg = dataclasses.replace(
        configs.get("llama3.2-1b").reduced(),
        n_layers=4, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=16384,
    )
    params = T.param_tree(T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n = sum(x.numel() for x in pytree.leaves(params))
    print(f"state: {n/1e6:.1f}M params ({4*n/1e6:.0f} MB fp32) on {dev}")

    for compress, tag in ((False, "raw"), (True, "szx(rel 1e-5)")):
        root = os.path.join(tempfile.gettempdir(), f"repro_torch_ckpt_{int(compress)}")
        shutil.rmtree(root, ignore_errors=True)
        m = CheckpointManager(root, compress=compress, bound=Bound.rel(1e-5), device=dev)
        t0 = time.perf_counter()
        m.save(0, params)
        dt = time.perf_counter() - t0
        st = m.stats()
        restored, _ = m.restore(params)
        worst = 0.0
        for a, b in zip(pytree.leaves(params), pytree.leaves(restored)):
            err = float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
            assert err <= (plan.resolve_error_bound(a, m.bound) if compress else 0.0), \
                "checkpoint error bound violated!"
            rng = float(a.max() - a.min())
            if rng > 0:
                worst = max(worst, err / rng)
        print(
            f"{tag:16s}: {st['stored_bytes']/1e6:7.1f} MB  ratio={st['ratio']:5.2f}  "
            f"save={dt:5.2f}s  worst rel err={worst:.2e}"
        )
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
