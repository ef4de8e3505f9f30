"""Serving launcher: batched greedy generation with a dense, MoE, SSM,
hybrid, audio encoder-decoder (whisper-medium) or VLM (internvl2-1b) model,
weights made from ``--seed``.  The encoder-decoder gets zero frame
embeddings (B, encoder_len, D) and the VLM zero image embeddings (B,
prefix_embeds, D), as the reference's launcher gives them; the cache holds
the prefix too.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --kv-mode compressed --tokens 16 --device cpu

Without ``--device`` it runs on the card, and fails without one.
arctic-480b's weights (960 GB in bf16) do not fit one card: the launcher
runs it with ``--reduced``, as the reference's launcher, which takes no
mesh; the engine serves it sharded under ``models.sharding.use_rules``, and
the dry-run (``launch/dryrun.py``) traces its serving cells whole.
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.codec.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-mode", default="dense", choices=["dense", "compressed"])
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, "repro_torch.launch.serve")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    kw = {}
    if cfg.encoder_decoder:
        kw["frames"] = torch.zeros((args.batch, cfg.encoder_len, cfg.d_model), device=dev)
    if cfg.prefix_embeds:
        kw["image_embeds"] = torch.zeros((args.batch, cfg.prefix_embeds, cfg.d_model), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=gen,
                            device=dev)
    cache, logits = engine.prefill(params, cfg, prompts,
                                   seq_len=args.prompt + args.tokens + (cfg.prefix_embeds or 0),
                                   kv_mode=args.kv_mode, **kw)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tok = torch.argmax(logits[:, -1:], -1)
    logits, cache = engine.decode_step(params, cfg, cache, tok, kv_mode=args.kv_mode)
    sync()
    t0 = time.perf_counter()
    outs = [tok]
    for _ in range(args.tokens - 1):
        tok = torch.argmax(logits, -1)
        outs.append(tok)
        logits, cache = engine.decode_step(params, cfg, cache, tok, kv_mode=args.kv_mode)
    sync()
    dt = time.perf_counter() - t0
    print(f"{args.arch} kv={args.kv_mode} on {dev}: "
          f"{args.batch * (args.tokens - 1) / dt:.1f} tok/s; "
          f"sample row: {[int(t[0, 0]) for t in outs[:8]]}")


if __name__ == "__main__":
    main()
