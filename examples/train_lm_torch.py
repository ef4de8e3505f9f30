"""End-to-end training driver (PyTorch port): a ~100M-param llama-family
model on the card, with SZx-compressed checkpointing and fault-tolerant
restart.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --d-model 512 [--device cpu]

The counterpart of ``examples/train_lm.py``: the llama3.2-1b config family
scaled down, float32 compute without remat, weights drawn on the device
from seed 0, the deterministic synthetic pipeline (or ``--data-store``),
the train step of ``repro_torch.train.step``; the Trainer checkpoints every
50 steps and, re-invoked on the same ``--ckpt``, restarts from the last
checkpoint.  Without ``--device`` it runs on the card, and fails without
one.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.api import Bound
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.codec.device import resolve_device
from repro_torch.data import DataConfig, SteppedBatches, StoreLM, SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--data-store", default=None,
                    help="train from a compressed ArrayStore corpus "
                         "(path / manifest / service URL) instead of the "
                         "synthetic stream")
    ap.add_argument("--data-workers", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples/train_lm_torch.py")

    base = configs.get("llama3.2-1b")
    cfg = dataclasses.replace(
        base,
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=4,
        head_dim=args.d_model // 8,
        d_ff=args.d_model * 4,
        vocab_size=8192,
        compute_dtype="float32",
        remat=False,
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params on {dev}")

    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps))
    params = T.param_tree(T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    state = {"params": params, "opt": opt.init(params)}
    step_fn = step_mod.make_train_step(cfg, opt)

    if args.data_store:
        # the loader's batches are already on the device
        ds = StoreLM(args.data_store, DataConfig(cfg.vocab_size, args.seq, args.batch),
                     workers=args.data_workers, device=dev)
        batch_fn = SteppedBatches(lambda s: ds.batches(start_step=s))
    else:
        ds = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))

        def batch_fn(step):
            return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(step).items()}

    ckpt = CheckpointManager(args.ckpt, keep=2, compress=True, bound=Bound.rel(1e-6), device=dev)
    tr = Trainer(
        TrainerConfig(total_steps=args.steps, checkpoint_every=50, log_every=20),
        step_fn, batch_fn, ckpt,
    )
    try:
        state = tr.run(state)
    finally:
        if args.data_store:
            batch_fn.close()
            ds.close()
    first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {len(tr.history)} steps "
          f"({tr.restarts} restarts, {len(tr.straggler_steps)} straggler steps)")
    print(f"checkpoint stats: {ckpt.stats()}")
    assert last < first, "training did not reduce the loss"
    return tr


if __name__ == "__main__":
    main()
