"""Training launcher: every family of the configs on synthetic tokens (with
stub frame or image embeddings where the model takes them) or on a
compressed store corpus, with optional SZx gradient compression,
SZx-compressed checkpoints and telemetry.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 20 --ckpt <dir> --device cpu
    ... --grad-compress 1      # szx-planes gradient all-reduce, error feedback
    ... --ckpt-compress        # SZx-compressed checkpoints
    ... --data-store STORE     # tokens from quantized ROI windows of an
                               # ArrayStore (path, shard-manifest .json or a
                               # store-service URL), on the device as each
                               # batch needs them
    ... --data-workers N       # ingest worker threads (default 2)
    ... --profile-dir DIR      # telemetry on: DIR/trace.json (Chrome trace of
                               # the obs spans), DIR/metrics.prom, and
                               # torch.profiler's trace DIR/torch_trace.json,
                               # where every obs span shows on its clock too

Without ``--device`` it runs on the card, and fails without one.  The
gradient compression averages over the process group; launched alone, the
launcher makes a one-rank group (gloo on the CPU, NCCL on the card).
"""
import argparse
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.codec.device import resolve_device
from repro_torch.data import DataConfig, SteppedBatches, StoreLM, SyntheticLM
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def _one_rank_group(dev: torch.device) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=1, rank=0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--grad-compress", type=int, default=0, metavar="P",
                    help="szx-planes planes per gradient value (0: off)")
    ap.add_argument("--ckpt", default="/tmp/repro_launch_ckpt", help="checkpoint directory")
    ap.add_argument("--ckpt-compress", action="store_true")
    ap.add_argument("--data-store", default=None,
                    help="train from a compressed ArrayStore corpus (store path, "
                         "shard-manifest .json or http(s):// store-service URL) instead "
                         "of the synthetic stream; tokens are quantized ROI windows on "
                         "the device")
    ap.add_argument("--data-workers", type=int, default=2,
                    help="ingest worker threads for --data-store")
    ap.add_argument("--profile-dir", default=None,
                    help="enable telemetry and write <dir>/trace.json (Chrome trace, "
                         "opens in Perfetto) plus <dir>/metrics.prom; torch.profiler "
                         "traces the run into <dir>/torch_trace.json, where every obs "
                         "span (train.step, train.forward_backward, train.grad_exchange, "
                         "train.optimizer, gradcomp.*) shows on the profiler's clock")
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    dev = resolve_device(args.device, "repro_torch.launch.train")
    if not args.profile_dir:
        tr, _state = run(args, dev)
    else:
        obs.enable()
        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            tr, _state = run(args, dev)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "torch_trace.json"))
        obs.write_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
        with open(os.path.join(args.profile_dir, "metrics.prom"), "w") as f:
            f.write(obs.prometheus_text())
        print(f"telemetry written to {args.profile_dir}/trace.json, metrics.prom and "
              "torch_trace.json")
    print(f"arch={args.arch} on {dev}: loss {tr.history[0]['loss']:.3f} -> "
          f"{tr.history[-1]['loss']:.3f} ({len(tr.history)} steps, "
          f"{sum(h['dt'] for h in tr.history) / len(tr.history) * 1e3:.1f} ms/step)")
    return tr


def data_config(cfg, seq: int, batch: int) -> DataConfig:
    """The synthetic stream's configuration, with stub frames (B,
    encoder_len, D) for the encoder-decoder and image embeddings (B,
    prefix_embeds, D) for the VLM, as the reference's launcher makes it."""
    return DataConfig(cfg.vocab_size, seq, batch,
                      frames=cfg.encoder_len, frame_dim=cfg.d_model if cfg.encoder_decoder else 0,
                      prefix_embeds=cfg.prefix_embeds,
                      prefix_dim=cfg.d_model if cfg.prefix_embeds else 0)


def run(args, dev: torch.device) -> tuple[Trainer, dict]:
    """The launcher's training run on ``dev`` for parsed ``args``: returns
    the Trainer (its ``history``) and the final state."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = step_mod.init_state(cfg, opt, gen, ef_planes=args.grad_compress, device=dev)
    own_group = bool(args.grad_compress) and not dist.is_initialized()
    if own_group:
        _one_rank_group(dev)
    if args.data_store:
        # compressed-corpus ingest: pipelined ROI-window loader on the device,
        # same (seed, step, rank) replay contract as the synthetic stream;
        # its batches are already there
        ds = StoreLM(args.data_store, DataConfig(cfg.vocab_size, args.seq, args.batch),
                     workers=args.data_workers, device=dev)
        batch_fn = SteppedBatches(lambda s: ds.batches(start_step=s))
    else:
        ds = SyntheticLM(data_config(cfg, args.seq, args.batch))

        def batch_fn(s):
            return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(s).items()}

    try:
        step_fn = step_mod.make_train_step(cfg, opt, compress_planes=args.grad_compress)
        ckpt = CheckpointManager(args.ckpt, keep=2, compress=args.ckpt_compress, device=dev)
        tr = Trainer(TrainerConfig(total_steps=args.steps, checkpoint_every=25),
                     step_fn, batch_fn, ckpt)
        state = tr.run(state)
    finally:
        if args.data_store:
            batch_fn.close()
            ds.close()
        if own_group:
            dist.destroy_process_group()
    return tr, state


if __name__ == "__main__":
    main()
