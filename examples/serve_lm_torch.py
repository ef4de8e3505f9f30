"""Serving example (PyTorch port): batched prefill + decode with dense vs
SZx-compressed KV on the card.

    PYTHONPATH=src python examples/serve_lm_torch.py --tokens 32 --batch 4 [--device cpu]

The counterpart of ``examples/serve_lm.py``: the same small llama3.2-1b
(4 layers, d_model 256), its weights and prompts drawn on the device from
seeds 0 and 1.  Without ``--device`` it runs on the card, and fails
without one.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.core.codec.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples/serve_lm_torch.py")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = dataclasses.replace(
        configs.get("llama3.2-1b").reduced(),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=4096,
    )
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    max_len = args.prompt + args.tokens

    firsts = {}
    for kv_mode in ("dense", "compressed"):
        cache, logits = engine.prefill(params, cfg, prompts, seq_len=max_len, kv_mode=kv_mode)
        tok = torch.argmax(logits[:, -1:], -1)
        out = [tok]
        logits, cache = engine.decode_step(params, cfg, cache, tok, kv_mode=kv_mode)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            tok = torch.argmax(logits, -1)
            out.append(tok)
            logits, cache = engine.decode_step(params, cfg, cache, tok, kv_mode=kv_mode)
        sync()
        dt = time.perf_counter() - t0
        total = args.batch * (args.tokens - 1)
        firsts[kv_mode] = [int(t[0, 0]) for t in out[:6]]
        print(
            f"kv={kv_mode:10s}: {total/dt:7.1f} tok/s  "
            f"cache={engine.cache_nbytes(cache)/1e6:6.1f} MB  "
            f"first tokens={firsts[kv_mode]}"
        )
        assert bool(torch.isfinite(logits).all()), f"kv={kv_mode}: non-finite logits"
    return firsts


if __name__ == "__main__":
    main()
