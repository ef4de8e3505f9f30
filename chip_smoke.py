#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--edge 512] [--reps 50]
                          [--store-kernels | --ingest | --service | --families |
                           --enc-vlm | --families-train | --examples | --sharding |
                           --sharded-serve | --long-context | --dense-configs]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of the JAX package.  In order it:

  1. prints the card's name and power limit, the torch and nvcc versions,
     and builds every kernel in src/repro_torch/csrc (one nvcc per source,
     started together), printing the build time;
  2. holds each kernel against its plain PyTorch version on the card, for
     f32/f64/f16/bf16, at the main path's frame shape (64 MiB frames,
     bs=128), the store's chunk shape (2 MiB) and edge shapes (bs=1 with
     4,096 and 300,007 blocks, bs=100
     with a ragged last block, bs=4096, an all-constant input, a frame with
     every L = 0, verbatim blocks, NaN/inf blocks, blocks of zeros of both
     signs, and lo/rb/rebase block ranges) -- every output bit-identical:
     encode, decode_body, unpack and unpack_dense (which must also equal
     decode_body's values), and bitshuffle forward and inverse on random
     tiles (nt = 1, a chunk's and a frame's worth), whose inverse undoes it;
     unpack, unpack_dense and bitshuffle on both routes (the store chunk's
     planes, L and tiles also copied one byte off: the scalar route);
  3. reproduces the golden SHA-256 digests of the three f32 golden streams
     that use no transcendental function, through the kernel path;
  4. drives the codec's main path at a size users run: an --edge^3 float32
     field (512^3 = 512 MiB, the size of a Nyx snapshot) made on the card
     from --seed, through SZxCodec().compress/decompress, dump_chunked (64 MiB
     frames), load_chunked(n=), load_chunked(select=), decompress_range;
     checks max |x - x'| <= e on the card and one frame's bytes against the
     plain route; then f64/f16/bf16 chunked round trips of 64 MiB each;
  5. drives the array store at the same size: the field with a zeroed
     boundary slab and a quiet one (1 + noise at the bound), saved with
     ArrayStore.save (default 2 MiB chunks) stage-off and with each second
     stage this machine can run, then opened; ROIs (a z-slab, a 64^3 cube
     across chunks, one element, a row in the zeroed slab, the whole array)
     read by both routes (host parse + unpack, fused range decode) must
     equal a full decode bit for bit and stay within e; both query tiers;
     one chunk's frame bytes against the plain route, per stage.
     Launch counters are zeroed just before phase 4 and read after phase 5:
     every kernel must have run on the main path, and unpack, unpack_dense
     and bitshuffle only on their vector route;
  6. times each kernel (CUDA events, warmed up, --reps launches) and its
     plain version at the shape the main path launches it at, beside the
     bound from bytes moved at 3.35 TB/s; decode_body's two launches (the
     scan of the stored-byte counts and the gather) also apart; unpack,
     unpack_dense and bitshuffle (both ways) at the store chunk's shape and
     a 64 MiB frame's, each with its device time (torch.profiler), its
     wrapper call's time (CUDA events) and its host time apart
     (``--store-kernels`` runs only this part, after the build);
  7. breaks one 64 MiB frame's compress and decompress into their stages
     (host clock, synchronized around each stage);
  8. drives the szx-planes gradient path at the full width of llama3.2-1b:
     its gradient tree (1,235,814,400 f32 values, 4.94 GB, made on the card
     from --seed) through compressed_psum_mean with error feedback in a
     one-rank NCCL group, three steps at P = 1 and at P = 2 (block 64): the
     mean and residual bit-identical to the plain versions on the card, the
     error within the block bound, the wire bytes n * wire_bytes_per_value;
     then compressed_ppermute on a ring of one, compressed_all_to_all on
     one rank, and pipeline_apply with compressed shifts on one stage
     (8 microbatches of hidden states).  Launch counters are zeroed just before this phase and read
     after it: both planes kernels must have run, on the vector route.

  9. serves llama3.2-1b at full width and depth (16 layers, d_model 2048, 32
     query and 8 kv heads of 64, d_ff 8192, vocab 128256; float32 weights
     made on the card from --seed, bf16 compute): prefill of 4 prompts of
     2048 tokens, then 64 greedy decode steps, with a dense KV cache and
     SZx-planes caches at P = 1 and 2.  Launch counters are zeroed just
     before and read after: every prefill launches the flash kernel once per
     layer, every compressed step both planes kernels; the cache bytes equal
     the slab shapes; then the prefill and the first decode steps are held
     to forward over the same tokens, and the flash kernel is timed beside
     its plain version, scaled_dot_product_attention (a yardstick the port
     never calls), its bound and the bf16 route's floor with its 4 products;
     last, torch.profiler traces one prefill and
     2 decode steps per mode: where the device time goes, and its busy share.

 10. drives the two-call encode (ops.block_stats, then ops.pack, then pack
     with shift = 0, as the paper's Fig. 6 analysis calls them) on phase 4's
     512^3 field at rel 1e-3, bs 128, with launch counters zeroed just before
     and read after; then holds block_stats and pack bit for bit to their
     plain versions and the two calls' (mu, const, reqlen, shift, nbytes,
     planes, L) to the fused encode kernel, on that field, 64 MiB
     f64/f16/bf16 fields and edge inputs (bs 1/3/4096, NaN/inf, zeros of both
     signs, verbatim, constant, empty, the f16 rounding guard), pack with
     shift = 0 included; times both beside their byte bounds;
 11. trains llama3.2-1b at full width and depth (float32 weights and AdamW
     state from --seed on the card, B 4 x S 2048 SyntheticLM tokens): a
     warm-up and 3 steps each plain and compressed at P = 1 and P = 2 (a
     one-rank NCCL group), every loss finite, AdamW moving the weights, the
     flash kernel launched twice a layer a step (forward and remat), the
     planes kernels in the compressed steps; a torch.profiler trace of one
     compressed step; then a Trainer run of 6 compressed steps with SZx
     checkpoints every 3 steps and a fault at step 5: the restart restores
     on the card through the decode kernel (every leaf within the bound of
     the saved one) and replays step 4; then the embedding leaf of the last
     checkpoint, opened as a store view (``CheckpointManager.leaf_store``),
     gives three row ranges by both decode routes bit for bit as restored.

 12. trains from a compressed store, with telemetry: the codec cell's field
     as (32768, 4096) rows in chunks of (32, 4096), saved on the card, then a
     shuffled epoch of (16, 4096) windows, batch 8, 20 steps (~8 % of the
     store) by both read routes: bytes read through a counting file under
     20 % of the file, serial and pipelined samples/s with 0, 2 and 4
     workers, pipelined batches bit-identical to batch_at, unpack on its
     vector route (decode_body with fused_range=True; launch counters zeroed
     before each route and read after); then ``launch.train.main`` trains
     llama3.2-1b at full width (B 4 x S 2048) from phase 5's stage-off store
     with 2 ingest workers and --profile-dir: a warm-up and 3 steps, finite
     losses, moving weights, the flash kernel twice a layer a step,
     trace.json with train.step, ingest.batch and store.read spans, valid
     metrics.prom lines, the profiler's trace; SteppedBatches seeking back
     gives the same tokens; last, the same model timed step by step on the
     store's batches (batch draw + step) beside phase 11's plain step, and
     one profiled step's device busy share (``--ingest`` runs only this
     phase, after the build).

 13. serves the stores over HTTP on the card: phase 5's stage-off and
     bitshuffle-rle stores, a 4-shard manifest of the same field and phase
     12's ingest store behind ``make_service()`` (host parse + unpack, the
     256 MiB decoded-chunk cache on the card), and the stage-off store
     behind a second service with ``fused_range=True``, each an HttpServer
     on 127.0.0.1 in a thread.  16 client threads read phase 5's ROIs and a
     (64, 512, 512) slab through ``/v1/stores/{name}/read`` in a cold pass
     (empty cache) and a hot one: every body bit for bit ``ca[roi]`` read
     on the card from a handle of its own and within e of the field;
     requests/s, decoded MB/s, p50/p99 per route, cache hits, misses and
     evictions.  The protocol: If-None-Match/304, Range/206/416, chunk
     frames against the file, a URL shard's 307, stats of both tiers
     against ``ca.stats()``, the ``serve.*`` Prometheus series.  Then phase
     12's epoch through ``StoreLoader("http://...")`` serially and with 2
     and 4 workers, every batch bit for bit the local loader's.  Launch
     counters are zeroed before each service's traffic and read after: the
     host-parse service must launch unpack (and the inverse bitshuffle),
     the fused one decode_body (``--service`` runs only this phase, after
     the build, with its stores made from --seed).

 14. serves the MoE, SSM and hybrid families at full width:
     mamba2-1.3b (24 of its 48 layers, attention-free; phase 20 serves it
     at full depth), hymba-1.5b (16 of its 32 layers, 25
     query heads over 5 kv heads beside a Mamba2 mixer, a 2048-token window;
     phase 20 serves it at full depth) and deepseek-moe-16b (all 28
     layers, 64 experts top-6 and 2 shared, 16.88 B float32 weights,
     67.5 GB, last);
     weights from --seed on the card, bf16 compute, 4 prompts of 2048 tokens
     and 16 greedy steps with a dense cache and, where there is attention,
     SZx-planes caches at P = 1 and 2.  Launch counters are zeroed just
     before and read after: the flash kernel once per attention layer a
     prefill and never in decode, the planes kernels as in phase 9 (vector
     route); the cache bytes equal the slabs' shapes, SSM state included;
     the logits are finite; decode is held to forward over the same tokens
     (deepseek drop-free, capacity_factor = n_experts / top_k, in float32
     compute on as many prompts as fit; in bf16 measured beside the share
     of tokens that take another expert set in the two forms); the peak
     memory and a profile of a dense prefill and 2 steps per model
     (``--families`` runs this phase alone, after the flash kernel's checks
     at its two prefill shapes, then times the kernel at them).

 15. serves and trains the audio encoder-decoder and the VLM at full
     width: whisper-medium (12 of its 24 encoder and 24 decoder layers,
     d_model 1024, 16 heads of 64, vocab 51865; 4 x 1500 stub frame
     embeddings from --seed, the encoder's 30 s of audio, then 384-token
     prompts and 16 greedy steps, within Whisper's 448-position text
     context) and internvl2-1b (12 of its 24 layers, d_model
     896, 14 query heads over 2, vocab 151655, tied embeddings; 4 x 256 stub
     image embeddings and 1792 tokens, 16 steps; phase 20 serves both at
     full depth);
     float32 weights from --seed on the card, bf16 compute, dense and
     SZx-planes caches at P = 1 and 2 (whisper's cross K/V dense in all
     three).  Launch counters are zeroed just before and read after: the
     flash kernel once per encoder layer, decoder layer and cross-attention
     a prefill and never in decode, the planes kernels as in phase 9; the
     flash launches counted by shape, rows 8d-8g each launched; the cache
     bytes equal the slabs' shapes, the cross K/V apart; the logits finite;
     decode held to forward over the same tokens (the VLM at its text
     positions) in float32 compute, the bf16 figures measured beside; the
     peak memory and a profile of a dense prefill and 2 steps.  Then each
     model trains through ``launch.train.run`` (its Trainer and synthetic
     batches with the stub frames or image embeddings): 3 plain steps of
     B 4 x S 448 (whisper) and B 4 x (256 + 1792) (internvl2-1b), its final
     raw checkpoint under the gitignored ``_smoke_ckpt/`` (removed after),
     every loss finite and the weights moved; then one compressed step at
     P = 1 in a one-rank NCCL group after a warm-up step (``--enc-vlm`` runs
     this phase alone, after the flash kernel's checks at its four shapes,
     then times the kernel at them).

 16. trains the MoE, SSM and hybrid families: mamba2-1.3b (d_model 2048, 64
     SSD heads of 64, state 128; 8 of its 48 layers, cuts that pay for
     phases 19d, 18f and 20) and hymba-1.5b (d_model 1600, 25/5 heads of 64
     with a 2048 window beside 50 SSD heads, d_ff 5504; 8 of its 32
     layers, cuts that pay for phases 18f, which trains it at full depth,
     and 20)
     at full width through
     ``launch.train.run`` with --ckpt-compress: 3 plain steps of B 4 x S 2048
     SyntheticLM tokens with per-layer remat, every loss finite, the SSM's
     in/conv/A_log/dt_bias/D/out (and hymba's attention and MLP) moved, the
     final SZx checkpoint restored on the card with every float leaf within
     its bound and the rest bit for bit; then a compressed P = 1 step in a
     one-rank NCCL group after a warm-up step and a profiled plain step; then
     deepseek-moe-16b at full width (64 routed experts top-6, 2 shared) on 4
     of its 28 layers (the full depth's 270 GB of training state waits for
     sharding; the cut is printed): a warm-up and 3 plain steps and a
     profiled one.  Launch counters are zeroed before each model and read
     after: the flash kernel exactly twice an attention layer a step, the
     planes kernels (vector route) in the compressed steps, encode in the
     checkpoint save and decode_body in its restore (``--families-train``
     runs this phase alone, after the flash kernel's checks at phase 14's
     shapes);
 17. runs the four examples (``examples/quickstart_torch.py``,
     ``compress_checkpoint_torch.py``, ``serve_lm_torch.py``,
     ``train_lm_torch.py``) through their ``main`` on the card at their
     defaults, each checking its own results; launch counters zeroed before
     each and read after: each must launch the kernels its path runs
     (``--examples`` runs this phase alone);
 18. shards training on a device mesh (one-rank NCCL group, one-member
     meshes): (a) llama3.2-1b at full width and depth, B 4 x S 2048, 3
     steps of the sharded step on a (1, 1) data x model mesh, its state
     placed by ``state_specs``, against two runs of the plain step from the
     same seed (deterministic algorithms on): bit for bit where the plain
     step repeats itself, else within its run-to-run spread; the flash
     kernel exactly twice an attention layer a step; (d) that state through
     ``CheckpointManager.save(mesh=)`` (``compress_tree_sharded`` along
     'data', SZx rel 1e-6), restored by ``decompress_tree`` and by
     ``restore(shardings=)`` onto the mesh, every float leaf within its
     bound and the rest bit for bit, encode and decode_body launches
     counted; (b) deepseek-moe-16b at full width on 4 layers through the
     sharded step (fsdp, ``_moe_rule``): 3 steps, losses finite, the
     experts moved, the peak beside phase 16's; (c) the compressed sharded
     step at P = 1 on a (1, 1, 1) pod x data x model mesh, the planes
     kernels on the vector route; (f) mamba2-1.3b (8 of 48 layers),
     hymba-1.5b (full depth), whisper-medium (6 + 6 of 24 + 24 layers,
     1500 stub frames) and internvl2-1b (8 of 24 layers, 256 stub image
     embeddings + 1792 tokens) at full width, B 4 x S 2048 with remat, as
     (a): the sharded step, tensor-parallel, against two plain runs, the
     flash kernel exactly twice an attention layer a step; (e) the dry-run
     on fake CUDA tensors of the train_4k cells of deepseek-moe-16b,
     mamba2-1.3b, hymba-1.5b, whisper-medium and internvl2-1b on (16, 16)
     and llama3.2-1b on (2, 16, 16) with --grad-compress 1, and the
     long_500k decode cells of h2o-danube-1.8b, hymba-1.5b and mamba2-1.3b
     under ``LONG_CONTEXT_RULES``, dense and compressed, each cell a
     ``launch.dryrun`` process of its own started (at the lowest CPU
     priority) before (a) and read after (f), each record on a line with
     its wall time beside its parent tree's flops, then deepseek-moe-16b's
     state bytes a card on a (4, 1) mesh from the specs (in the whole run
     the records are read after phase 21).  Launch counters are zeroed
     before (a) and read after (f): flash, planes, encode and decode_body
     must each have run (``--sharding`` runs this phase alone);
 19. serves under a device mesh (one-rank NCCL group, one-member (1, 1)
     data x model meshes, the parameters ``DTensor``s placed by the
     reference's spec trees, ``models.sharding.use_rules``): (a)
     llama3.2-1b at full width and depth under ``DEFAULT_RULES``, 4 x 2048
     prompts and 16 decode steps (the unsharded engine's greedy tokens),
     dense and P = 1 caches: the prefill's logits and cache bit for bit the
     unsharded engine's where it repeats itself (deterministic algorithms
     on), the decode logits within a stated share of the largest logit
     (the scores rounded to bf16 under rules are the one difference), and
     again with the scores summed in float32 within 1e-5 of it;
     prefill and decode-step ms beside the unsharded engine's, and the
     device's busy share of a sharded decode step, and the host clock of
     sharded and unsharded decode steps timed in turns (ABBA, 2 rounds of
     16 steps); (b) deepseek-moe-16b at
     full width on 4 of its 28 layers, a prefill and 8 decode steps under
     ``DEFAULT_RULES`` (dense cache, fsdp specs) and ``SERVE_MOE_RULES``
     (P = 1, ``serve_param_specs_tree``), prefill bit for bit, the decode
     with float32 scores within 1e-5 (the bf16 one reported); (d) the SSM,
     hybrid, audio and VLM families at full width, B 4, 8 decode steps,
     dense and P = 1 caches: mamba2-1.3b (12 of 48 layers, 2048-token
     prompts), hymba-1.5b (16 of 32 layers, 2048), whisper-medium (6 + 6 of 24 +
     24 layers, 1500 stub frames, 384 tokens) and internvl2-1b (8 of 24
     layers, 256 image embeddings and 1792 tokens): prefill bit for bit,
     decode within 0.05 with bf16 scores (hymba-1.5b's reported) and 1e-5
     with float32 scores, the peak memory, flash and both planes kernels
     launched; (c) the dry-run's serving cells on fake CUDA tensors on (16,
     16), each a ``launch.dryrun`` process of its own started (at the
     lowest CPU priority) before (a) and read after (d) (in the whole run
     started with phase 21 and read after it): llama3.2-1b prefill_32k and decode_32k (dense and
     compressed), deepseek-moe-16b decode_32k with ``serve_layout``,
     arctic-480b decode_32k, mamba2-1.3b decode_32k, hymba-1.5b decode_32k
     compressed, whisper-medium prefill_32k.  Launch counters are set to 0
     before each
     sharded run and read after it: flash, planes_encode and planes_decode
     must each have run there (``--sharded-serve`` runs this phase alone).
 20. serves long contexts under ``LONG_CONTEXT_RULES`` (the batch whole,
     the sequence over 'data'; one-rank NCCL group, a one-member (1, 1)
     data x model mesh): h2o-danube-1.8b at full width and depth (24
     layers, d_model 2560, 32 query and 8 kv heads of 80, a 4096-token
     window; float32 weights from --seed, bf16 compute, B 1) on a
     32768-token prompt against the unsharded engine, then on a
     524288-token prompt (long_500k's), hymba-1.5b and mamba2-1.3b at full
     width and depth on 32768 tokens, deepseek-moe-16b at full width on 4
     of its 28 layers on 32768 tokens, internvl2-1b at full depth on 256
     image embeddings and 32512 tokens, and whisper-medium at full depth on
     1500 frames and a 432-token prompt, each against the unsharded engine;
     16 decode steps each (deepseek-moe-16b and internvl2-1b 4) with a
     dense cache and, where there is attention, a P = 1 cache.  Every run
     held to the unsharded engine is bit for bit in its prefill logits and
     cache (deterministic algorithms on); its decode logits, the scores'
     sum rounded to bf16 as under any rules, are reported, and a second run
     with the scores summed in float32 is bit for bit (prefill and decode);
     danube's 32768-token runs decode a third time with each score partial
     rounded before the (one-member) sum, the bits of the second run's
     rounding after it; prefill s, decode ms a step, peak memory.  Launch
     counters are set to 0 before the first run under the rules and read
     after: the flash kernel exactly once an attention layer (whisper's
     encoder and cross-attention layers too: 72), both planes kernels in a
     P = 1 run.  Then the flash kernel is timed at the one member's
     524288-token shape, at a rank of 16's (32768 queries after a 4095-key
     halo), at deepseek-moe-16b's and internvl2-1b's 32768-position
     prefills and at two shapes of a rank of 4 (deepseek's last rank, 8192
     queries after a 24576-key halo; a whisper encoder rank's 375 frames
     against 1500), beside its bound, and where it fits beside
     scaled_dot_product_attention, with a dense mask where the attention
     needs one (``--long-context``
     runs this phase alone, after the flash
     kernel's checks with an offset, and then traces the six long_500k
     dry-run cells; in the whole run phase 18e traces them).
 21. serves and trains the dense configs that no other phase runs, at
     full width: stablelm-3b (32 layers, d_model 2560, 32 query and 32 kv
     heads of 80, d_ff 6912, vocab 50304; 11.18 GB of float32 weights) and
     yi-6b (32 layers, d_model 4096, 32 query heads over 4 of 128, d_ff
     11008, vocab 64000, rope theta 5e6; 24.24 GB) served at full depth
     with phase 9's traffic (4 prompts of 2048 tokens, 16 greedy steps,
     dense and SZx-planes caches at P = 1 and 2): the flash kernel once a
     layer a prefill and never in decode, the planes kernels in every
     compressed step on the vector route, the cache bytes the slabs'
     shapes, finite logits, decode held to forward over the same tokens in
     bf16 where a mode meets phase 9's criterion and in float32 compute
     (on as many prompts as fit) where it does not, the bf16 figure
     measured beside it; the peak memory and a profile of a dense prefill
     and 2 steps each.  Then stablelm-3b and h2o-danube-1.8b (its 4096
     window longer than the 2048 positions) trained at full depth and
     yi-6b on 16 of its 32 layers (its full depth's 96.97 GB of training
     state waits for more cards; the cut is printed and must leave 10 GB
     of the card free): ``make_train_step``, a warm-up and 3 plain steps
     of B 4 x S 2048 with remat and a profiled one, every loss finite, the
     embedding, ``wq``, ``wi`` and ``ln1`` moved, the flash kernel exactly
     twice a layer a step; the state reckoned at 16 bytes a parameter
     beside the peak.  Launch counters are set to 0 before the phase and
     read after; the flash launches are also counted by shape, rows 8m-8n
     each launched (``--dense-configs`` runs this phase alone, after the
     flash kernel's checks at its two prefill shapes, then times the
     kernel at them).

Phase 2 also holds the planes kernels against their plain versions on both
routes (P = 1, 2, 3; bs 1, 3, 4, 6, 8, 16, 32, 64, 128, 4096; leading dims;
nb = 0; edge blocks; a view one float off and planes one byte off; random
records with sexp read as int32, int16 and int8), and phase 6 times them on
the embed gradient's shape at P = 1 and 2, each beside the scalar route, and
at the serving shapes; phases 8, 9 and 11 check through the per-route
counters that every planes launch took the vector route; the flash
kernel is held to its plain version right after (llama3.2-1b's prefill
shape, a window, unaligned S, hd 80 and 128, float32, and phase 14's
prefills: hymba's G = 5 with a window equal to S, deepseek's G = 1 at hd
128; phase 15's: whisper's non-causal encoder over 1500 frames and its
cross-attention of 384 positions against them, its causal decoder, and
internvl2-1b's G = 7; phase 20's: 4096 queries after h2o-danube-1.8b's
4095-key halo, a float32 case with an offset, and a whisper encoder rank's
375 frames against 1500; phase 21's: stablelm-3b's and yi-6b's prefills
at B 4 x S 2048), and timed at llama3.2-1b's, phase 14's, phase 15's,
phase 20's and phase 21's shapes.

Any failed check raises, so the exit code is non-zero.  The last two lines
are the kernels JSON and the result JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FRAME_BYTES = 64 << 20
GOLDEN_SHA256 = {                  # tests/test_codec.py, the f32 golden streams
    "walk_bs64_rel1e-3": "8268a4b101cb0f0008d5e1f0279de3021c5ed93d5de50f92ad1dd0c61f9bb1c9",
    "const_bs128": "b1e68c21ff4f2c1a2e782f54a8c46a151610398ac78ae536d3460f0e8a0879fd",
    "spiky_bs32_abs1e-5": "f47e60993b1aa622798eb1d605d066665e6aac9c32ec672d3fe817b601f6bcfd",
}


MAX_ERR_CASES = {}                 # flash_attention: max |kernel - plain| per case
MAX_ERR = {"encode": 0.0, "decode_body": 0.0, "bitshuffle": 0.0, "unpack": 0.0,
           "unpack_dense": 0.0, "planes_encode": 0.0, "planes_decode": 0.0,
           "flash_attention": 0.0, "block_stats": 0.0, "pack": 0.0}  # kernel vs plain, this run
SOURCES = {          # kernel -> (its source, the TPU kernel it replaces)
    "encode": ("src/repro_torch/csrc/encode.cu", "src/repro/kernels/encode.py:57"),
    "decode_body": ("src/repro_torch/csrc/decode.cu", "src/repro/kernels/decode.py:108"),
    "bitshuffle": ("src/repro_torch/csrc/bitshuffle.cu", "src/repro/kernels/bitshuffle.py:66"),
    "unpack": ("src/repro_torch/csrc/unpack.cu", "src/repro/kernels/unpack.py:123"),
    "unpack_dense": ("src/repro_torch/csrc/unpack.cu", "src/repro/kernels/unpack.py:136"),
    "planes_encode": ("src/repro_torch/csrc/planes.cu", "src/repro/kernels/planes.py:71"),
    "planes_decode": ("src/repro_torch/csrc/planes.cu", "src/repro/kernels/planes.py:111"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "block_stats": ("src/repro_torch/csrc/block_stats.cu", "src/repro/kernels/block_stats.py:91"),
    "pack": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack.py:73"),
}
CODEC_KERNELS = ("encode", "decode_body", "bitshuffle", "bitshuffle_inverse", "unpack",
                 "unpack_dense")
PLANES_KERNELS = ("planes_encode", "planes_decode")
PLANES_BS = (1, 3, 4, 6, 8, 16, 32, 64, 128, 4096)   # phase 2: both routes of the planes kernels
TWO_CALL_KERNELS = ("block_stats", "pack")
STORE_CHUNK_BYTES = 2 << 20        # the store's default chunk (store/grid.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def bits(t):
    """Tensor reinterpreted as signed integers of its own width (bit view)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(bits(a), bits(b)))


def max_abs_diff(a, b) -> float:
    """max |a - b| over the positions where not both are NaN (equal values,
    infinities included, differ by 0)."""
    import torch

    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    d = (a - b).abs()
    return float(torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0, d).max())


def walk(n, dtype, gen, scale=0.01):
    import torch

    steps = torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
    return (torch.cumsum(steps, 0) * scale).to(dtype)


def ptxas_registers(log_text: str) -> str:
    """'kernel<template args>: N (spills S B)' for each entry function in
    the output of an ``nvcc -Xptxas -v`` build."""
    import re

    types = {"a": "int8", "s": "int16", "i": "int32", "f": "float", "d": "double",
             "6__half": "half", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}
    tok = r"Li\d+E|Lb[01]E|6__half|13__nv_bfloat16|[asifd]"
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(rf"\d+([a-z_]+_kernel)(?:I((?:{tok})+)E)?", m.group(1))
            args = re.findall(rf"Li(\d+)E|({tok})", k.group(2) or "") if k else []
            targs = ",".join(a or types[t] for a, t in args)
            name = (k.group(1) if k else m.group(1)) + (f"<{targs}>" if targs else "")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            out.append([name, None, int(spill.group(1))])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out and out[-1][0] == name and out[-1][1] is None:
            out[-1][1] = int(regs.group(1))
    return "; ".join(f"{n}: {r} (spills {sp} B)" for n, r, sp in out)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------

def encode_both(xb, e, spec):
    """Kernel and plain encode of the same blocks; asserts bit identity."""
    from repro_torch.kernels import encode as enc_mod, specs

    p_e = specs.exact_exponent_of(e)
    k = enc_mod.encode(xb, e, p_e, spec=spec)
    p = enc_mod.encode_plain(xb, e, spec, p_e)
    names = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")
    for name, a, b in zip(names, k, p):
        check(same_bits(a, b), f"encode {spec.name} {tuple(xb.shape)}: {name} differs")
        MAX_ERR["encode"] = max(MAX_ERR["encode"], max_abs_diff(a, b))
    return k


def decode_both(body, nnc, lo, rb, rebase, spec, nb, bs):
    """Kernel and plain decode_body of one body; asserts bit identity and
    equal mid_total.  Returns the kernel's values and mid_total."""
    from repro_torch.kernels import decode as dec_mod, ref

    _c, mu, shift, nbytes, rank, _nnc_seen = ref.parse_body_ref(body, nnc, spec, nb)
    kv, kt = dec_mod.decode_body(body, nnc, lo, mu, shift, nbytes, rank,
                                 spec=spec, bs=bs, rb=rb, rebase=rebase)
    pv, pt = dec_mod.decode_body_plain(body, nnc, lo, mu, shift, nbytes, rank, spec,
                                       bs=bs, rb=rb, rebase=rebase)
    where = f"decode {spec.name} nb={nb} bs={bs} lo={lo} rb={rb} rebase={rebase}"
    check(same_bits(kv, pv), f"{where}: values differ")
    MAX_ERR["decode_body"] = max(MAX_ERR["decode_body"], max_abs_diff(kv, pv))
    check(int(kt) == int(pt), f"{where}: mid_total {int(kt)} != {int(pt)}")
    return kv, int(kt)


def off_by_one(t):
    """A contiguous copy of ``t`` that starts one byte past an aligned
    address (the scalar route of unpack and bitshuffle)."""
    import torch

    buf = torch.empty(t.numel() * t.element_size() + 1, dtype=torch.uint8, device=t.device)
    view = buf[1:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def unpack_both(enc, spec, *, misaligned=False):
    """Kernel and plain unpack and unpack_dense of one encoding; asserts bit
    identity, on the route the shape takes and, with ``misaligned``, on
    copies of the planes and L one byte off (the scalar route).  Returns
    the kernel's unpack values."""
    from repro_torch.kernels import unpack as up

    cases = [(enc.planes, enc.L)]
    if misaligned:
        cases.append((off_by_one(enc.planes), off_by_one(enc.L)))
        check(up.tensor_route(*cases[1]) == "scalar", "planes one byte off: scalar route")
    outs = []
    for planes, L in cases:
        args = (planes, enc.mu, enc.shift, enc.nbytes)
        k = up.unpack(*args, L, spec=spec)
        outs.append(k)
        p = up.unpack_plain(*args, L, spec)
        where = f"unpack {spec.name} {tuple(L.shape)} {up.tensor_route(planes, L)} route"
        check(same_bits(k, p), f"{where}: values differ")
        MAX_ERR["unpack"] = max(MAX_ERR["unpack"], max_abs_diff(k, p))
        kd = up.unpack_dense(*args, spec=spec)
        pd = up.unpack_dense_plain(*args, spec)
        check(same_bits(kd, pd), f"{where}: dense values differ")
        MAX_ERR["unpack_dense"] = max(MAX_ERR["unpack_dense"], max_abs_diff(kd, pd))
        if not bool(L.any()):
            check(same_bits(k, kd), f"{where}: dense != unpack with every L = 0")
    check(all(same_bits(outs[0], k) for k in outs), "unpack: the two routes differ")
    return outs[0]


def bitshuffle_both(nt, spec, gen, *, misaligned=False):
    """Kernel and plain bitshuffle, forward and inverse, of random tiles;
    asserts bit identity and that the inverse undoes the forward; with
    ``misaligned`` also on a copy one byte off (the scalar route)."""
    import torch
    from repro_torch.kernels import bitshuffle as bsh, specs

    T = specs.tile_bytes(spec)
    tiles = torch.randint(0, 256, (nt, T), dtype=torch.uint8, device="cuda", generator=gen)
    cases = [tiles] + ([off_by_one(tiles)] if misaligned else [])
    for t in cases:
        for inverse in (False, True):
            k = bsh.bitshuffle(t, spec=spec, inverse=inverse)
            p = bsh.bitshuffle_plain(t, inverse)
            check(torch.equal(k, p), f"bitshuffle {spec.name} nt={nt} inverse={inverse} "
                                     f"{bsh.route(t.data_ptr())} route differs")
            MAX_ERR["bitshuffle"] = max(MAX_ERR["bitshuffle"], max_abs_diff(k, p))
        back = bsh.bitshuffle(bsh.bitshuffle(t, spec=spec), spec=spec, inverse=True)
        check(torch.equal(back, tiles), f"bitshuffle {spec.name} nt={nt}: inverse(forward) != x")


def check_store_vector_route(path: str, routes: dict) -> None:
    """Every unpack, unpack_dense and bitshuffle launch of a main path took
    the vector route, and each of them ran."""
    for k in ("unpack", "unpack_dense", "bitshuffle", "bitshuffle_inverse"):
        check(routes[f"{k}_vector"] > 0 and routes[f"{k}_scalar"] == 0,
              f"{path}: {k} launches by route {routes}")


def kernel_vs_plain(x, e, spec, bs, *, ranges=(), expect_all_L0=False, misaligned=False):
    """Encode x (flat, on the card) both ways, assemble the body, decode it
    both ways (full, plus block ranges with and without rebase)."""
    import torch
    from repro_torch.core.codec import device, plan, transform

    p, xt = plan.make_plan(x, e, block_size=bs, device="cuda")
    xb = plan.to_blocks(xt, p)
    enc = transform.BlockEncoding(*encode_both(xb, p.error_bound, spec))
    if expect_all_L0:
        check(not bool(enc.L.any()), f"{spec.name}: the all-L=0 fixture has L > 0")
    body, nnc, nmid = device._assemble_body(spec, enc)
    nb = p.nblocks
    vals, mid_total = decode_both(body, nnc, 0, nb, False, spec, nb, bs)
    check(mid_total == nmid, f"{spec.name}: decoded mid_total {mid_total} != {nmid}")
    check(same_bits(unpack_both(enc, spec, misaligned=misaligned), vals),
          f"{spec.name} bs={bs}: unpack != decode_body")
    y = vals.reshape(-1)[: p.n]
    fin = torch.isfinite(xt)
    err = max_abs_diff(y[fin], xt[fin])
    check(err <= p.error_bound, f"{spec.name} bs={bs}: max error {err} > {p.error_bound}")
    inf = xt.isinf()
    check(same_bits(y.isnan(), xt.isnan()) and bool((y[inf] == xt[inf]).all()),
          f"{spec.name} bs={bs}: NaN/inf not kept")
    if ranges:
        counts = (enc.nbytes[:, None].to(torch.int64) - enc.L.to(torch.int64)).clamp(min=0).sum(1)
        starts = torch.cumsum(counts, 0) - counts
        mid_off = body.numel() - nmid
        for lo, rb in ranges:
            sub, _ = decode_both(body, nnc, lo, rb, False, spec, nb, bs)
            check(same_bits(sub, vals[lo:lo + rb]), f"{spec.name}: range [{lo}, {lo + rb})")
            a = int(starts[lo])
            b = int(starts[lo + rb]) if lo + rb < nb else nmid
            rbody = torch.cat([body[:mid_off], body[mid_off + a: mid_off + b]])
            sub, _ = decode_both(rbody, nnc, lo, rb, True, spec, nb, bs)
            check(same_bits(sub, vals[lo:lo + rb]),
                  f"{spec.name}: rebased range [{lo}, {lo + rb})")
    return p, body


def phase_kernels(gen):
    import torch
    from repro_torch.kernels import ops, specs

    before = ops.store_route_counts()
    for spec in specs.SPECS:
        t0 = time.perf_counter()
        e = 1e-3 if spec.itemsize >= 4 else 1e-2
        nb_frame = FRAME_BYTES // (spec.itemsize * 128)
        x = walk(nb_frame * 128, spec.dtype, gen)
        kernel_vs_plain(x, e, spec, 128,
                        ranges=((0, 1), (nb_frame // 3, nb_frame // 8), (nb_frame - 5, 5)))
        kernel_vs_plain(walk(4096, spec.dtype, gen), e, spec, 1, ranges=((17, 300),))
        # bs 1 across many tiles of the decode's scan (2048 blocks a tile)
        kernel_vs_plain(walk(300_007, spec.dtype, gen), e, spec, 1, ranges=((4095, 4099),))
        kernel_vs_plain(walk(100 * 1000 + 37, spec.dtype, gen), e, spec, 100,
                        ranges=((999, 2), (3, 40)))
        kernel_vs_plain(walk(4096 * 64, spec.dtype, gen, scale=0.1), e, spec, 4096,
                        ranges=((7, 9),))
        kernel_vs_plain(torch.full((128 * 300 + 5,), 2.5, dtype=spec.dtype, device="cuda"),
                        1e-3, spec, 128)
        alt = torch.linspace(1.0, 2.0, 1 << 16, dtype=torch.float64, device="cuda")
        alt[1::2] *= -1.0
        kernel_vs_plain(alt.to(spec.dtype), 1e-3, spec, 128, expect_all_L0=True)
        tiny = float(torch.finfo(spec.dtype).tiny)          # verbatim blocks
        kernel_vs_plain(walk(128 * 200, spec.dtype, gen, scale=1.0), tiny, spec, 128)
        odd = walk(128 * 200, spec.dtype, gen)               # NaN and inf blocks
        odd[::997] = float("nan")
        odd[5::1999] = float("inf")
        odd[7::2999] = -float("inf")
        kernel_vs_plain(odd, e, spec, 128)
        nb_chunk = STORE_CHUNK_BYTES // (spec.itemsize * 128)   # the store's chunk
        kernel_vs_plain(walk(nb_chunk * 128, spec.dtype, gen), e, spec, 128,
                        ranges=((0, 256), (100, 7)), misaligned=True)
        zeros = walk(128 * 300, spec.dtype, gen).reshape(300, 128)   # zeros of both signs
        signs = torch.randint(0, 2, (100, 128), device="cuda", generator=gen)
        zeros[1::3] = torch.where(signs == 1, -0.0, 0.0).to(spec.dtype)
        zeros[2::9] = -0.0
        kernel_vs_plain(zeros.reshape(-1), e, spec, 128)
        T = specs.tile_bytes(spec)
        for nt in (1, STORE_CHUNK_BYTES // T, FRAME_BYTES // T):
            bitshuffle_both(nt, spec, gen, misaligned=nt == STORE_CHUNK_BYTES // T)
        torch.cuda.synchronize()
        log(f"kernels vs plain {spec.name}: bit-identical at frame nb={nb_frame} bs=128, "
            f"store chunk nb={nb_chunk} (also one byte off) and edge shapes; bitshuffle at "
            f"nt=1, {STORE_CHUNK_BYTES // T} (also one byte off), {FRAME_BYTES // T} "
            f"({time.perf_counter() - t0:.1f} s)")
    routes = {k: v - before[k] for k, v in ops.store_route_counts().items()}
    for k, n in routes.items():
        check(n > 0, f"phase 2 never launched {k}")
    log(f"unpack and bitshuffle launches by route in phase 2: {routes}")


# ---------------------------------------------------------------------------
# phase 3: golden digests through the kernel path
# ---------------------------------------------------------------------------

def phase_golden():
    import numpy as np
    from repro_torch.core.codec import Bound, SZxCodec

    rng = np.random.default_rng(42)
    walk32 = np.cumsum(rng.standard_normal(7777)).astype(np.float32)
    spiky = rng.standard_normal(3001).astype(np.float32)
    spiky[::97] *= 1e4
    cases = {
        "walk_bs64_rel1e-3": SZxCodec(block_size=64).compress(walk32, Bound.rel(1e-3)),
        "const_bs128": SZxCodec().compress(np.full(1000, 7.5, np.float32), 1e-3),
        "spiky_bs32_abs1e-5": SZxCodec(block_size=32).compress(spiky, 1e-5),
    }
    for name, buf in cases.items():
        digest = hashlib.sha256(buf).hexdigest()
        check(digest == GOLDEN_SHA256[name], f"golden {name}: {digest}")
    log(f"golden digests through the kernels: {len(cases)}/{len(cases)} match")


# ---------------------------------------------------------------------------
# phase 4: the main path at a size users run
# ---------------------------------------------------------------------------

def make_field(edge: int, seed: int):
    """Smooth multi-scale float32 field on the card plus small noise."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ax = torch.linspace(0.0, 1.0, edge, device="cuda", dtype=torch.float32)
    field = torch.zeros((edge, edge, edge), device="cuda", dtype=torch.float32)
    for k in range(6):
        f = (2.0 ** k) * (1.0 + torch.rand(3, device="cuda", generator=gen))
        ph = 6.283185 * torch.rand(3, device="cuda", generator=gen)
        amp = 0.6 ** k
        sx = torch.sin(6.283185 * f[0] * ax + ph[0])[:, None, None]
        sy = torch.sin(6.283185 * f[1] * ax + ph[1])[None, :, None]
        sz = torch.sin(6.283185 * f[2] * ax + ph[2])[None, None, :]
        field += amp * sx * sy * sz
    field += 1e-4 * torch.randn(field.shape, device="cuda", generator=gen)
    return field


def plain_stream(chunk, e, bs=128) -> bytes:
    """The same v2 stream through the plain versions on the card."""
    from repro_torch.core.codec import device, plan, transform
    from repro_torch.kernels import ref, specs

    p, xt = plan.make_plan(chunk, e, block_size=bs, device="cuda")
    enc = transform.BlockEncoding(*ref.encode_ref(
        plan.to_blocks(xt, p), p.error_bound, p.dtype, specs.exact_exponent_of(p.error_bound)
    ))
    body, nnc, nmid = device._assemble_body(p.dtype, enc)
    return device.to_stream(device.DeviceEncoding.make(
        "szx-v2", {"body": body}, plan=p, nnc=nnc, nmid=nmid))


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_main(args):
    import torch
    from repro_torch.core.codec import Bound, SZxCodec, container, plan

    x = make_field(args.edge, args.seed)
    flat = x.reshape(-1)
    raw = flat.numel() * 4
    codec = SZxCodec()
    bound = Bound.rel(1e-3)
    e = plan.resolve_error_bound(flat, bound)
    torch.cuda.reset_peak_memory_stats()
    # monolithic, twice: the first call also pays allocator warm-up
    buf, t_c1 = timed(lambda: codec.compress(x, bound))
    buf, t_c = timed(lambda: codec.compress(x, bound))
    y, t_d1 = timed(lambda: codec.decompress(buf))
    y, t_d = timed(lambda: codec.decompress(buf))
    err = max_abs_diff(y, flat)
    check(y.shape == flat.shape and y.dtype == flat.dtype, "monolithic shape/dtype")
    check(err <= e, f"monolithic max error {err} > e={e}")
    peak = torch.cuda.max_memory_allocated()
    log(f"main f32 {args.edge}^3 ({raw / 2**20:.0f} MiB) monolithic rel 1e-3 (e={e:.6g}): "
        f"CR {raw / len(buf):.4f}, compress {raw / t_c / 1e9:.3f} GB/s "
        f"(first call {raw / t_c1 / 1e9:.3f}), decompress {raw / t_d / 1e9:.3f} GB/s "
        f"(first call {raw / t_d1 / 1e9:.3f}), max|x-x'| {err:.6g}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    # block range of the monolithic stream
    nb = (flat.numel() + 127) // 128
    lo, hi = nb // 3, min(nb, nb // 3 + 4099)
    part = codec.decompress_range(buf, lo, hi)
    check(same_bits(part, y[lo * 128: hi * 128]), "decompress_range != slice of decompress")
    del y
    # chunked: dump with the index footer, load whole, load a selection
    torch.cuda.reset_peak_memory_stats()
    sink = io.BytesIO()
    written, t_dump = timed(lambda: codec.dump_chunked(x, sink, bound, chunk_bytes=FRAME_BYTES))
    stream = sink.getvalue()
    check(written == len(stream), "dump_chunked byte count")
    y, t_load = timed(lambda: codec.load_chunked(io.BytesIO(stream), n=flat.numel()))
    err_c = max_abs_diff(y, flat)
    check(err_c <= e, f"chunked max error {err_c} > e={e}")
    per = plan.chunk_elements(128, FRAME_BYTES, 4)
    nframes = -(-flat.numel() // per)
    sel = sorted({min(1, nframes - 1), nframes - 1})
    got = codec.load_chunked(io.BytesIO(stream), select=sel)
    want = torch.cat([y[i * per:(i + 1) * per] for i in sel])
    check(same_bits(got, want), "load_chunked(select=) != slices of load_chunked(n=)")
    first = next(container.iter_frames(io.BytesIO(stream)))
    check(first == plain_stream(flat[:per], e), "frame 0 differs from the plain route's bytes")
    log(f"main f32 chunked ({nframes} frames of {FRAME_BYTES >> 20} MiB, v3 index): "
        f"CR {raw / len(stream):.4f}, dump {raw / t_dump / 1e9:.3f} GB/s, "
        f"load {raw / t_load / 1e9:.3f} GB/s, max|x-x'| {err_c:.6g}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"select={sel} and frame-0 plain-route bytes match")
    del y, got, want
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for dt in (torch.float64, torch.float16, torch.bfloat16):
        n = FRAME_BYTES // (torch.finfo(dt).bits // 8)
        xd = walk(n, dt, gen, scale=0.001)
        frames = list(codec.compress_chunked(xd, Bound.rel(1e-3), chunk_bytes=FRAME_BYTES // 4))
        yd = codec.decompress_chunked(frames, n=n)
        ed = plan.resolve_error_bound(xd, Bound.rel(1e-3))
        errd = max_abs_diff(yd, xd)
        check(errd <= ed, f"{dt} chunked max error {errd} > e={ed}")
        cr = n * xd.element_size() / sum(len(f) for f in frames)
        log(f"main {str(dt).removeprefix('torch.')} chunked round trip (64 MiB, "
            f"{len(frames)} frames): CR {cr:.4f}, max|x-x'| {errd:.6g} <= e={ed:.6g}")
    return x


# ---------------------------------------------------------------------------
# phase 5: the array store at a size users run
# ---------------------------------------------------------------------------

def staged_counts(data: bytes, idx: dict) -> tuple[int, int, int]:
    """(staged frames, staged segments, segments of staged frames) of a
    store file, read from its frame flags and stage tables."""
    import numpy as np
    from repro_torch.core.codec import container

    frames = staged = segs = 0
    for off, _length, _n in idx["frames"]:
        if not container.stage_of_flags(data[off + 5]):
            continue
        frames += 1
        p0 = off + container.FRAME_HEADER.size
        table = p0 + container.stream_prefix_length(data[p0:p0 + container.HEADER.size])
        _seg_blocks, nseg = struct.unpack_from("<HI", data, table)
        lens = np.frombuffer(data, "<u4", nseg, table + 6).astype(np.int64)
        records = table + 6 + 4 * nseg + np.concatenate(([0], np.cumsum(lens[:-1])))
        segs += nseg
        staged += sum(data[int(r)] == 1 for r in records)
    return frames, staged, segs


def store_field(field, seed: int):
    """Phase 5's array: the field with a zeroed boundary slab (constant
    blocks, every L = 0) and a two-level (telegraph) one, 1 +- 1.2 e0:
    non-constant blocks whose stored bytes take two patterns, which
    bitshuffle + RLE shrinks (on the smooth part of the field RLE never beats
    the raw bytes)."""
    import torch

    edge = field.shape[0]
    x = field.clone()
    e0 = 1e-3 * float(x.max() - x.min())
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    x[: edge // 8] = 0.0
    x[edge - edge // 8:] = 1.0 + 1.2 * e0 * torch.sign(torch.randn(
        (edge // 8, edge, edge), device="cuda", generator=gen))
    return x


def middle_chunk(data: bytes, idx: dict) -> bytes:
    """The v2 payload of a store file's middle chunk (what phase 6 times)."""
    from repro_torch.core.codec import container

    off, length, _n = idx["frames"][len(idx["frames"]) // 2]
    return data[off + container.FRAME_HEADER.size: off + length]


def phase_store(field, args):
    """Save the field (with a zeroed and a quiet boundary slab) as stores,
    read ROIs by both routes, run both query tiers, and hold one chunk's
    frame bytes per stage to the plain route.  Returns what phase 6 times:
    the stage-off store's middle chunk."""
    import numpy as np
    from repro_torch.core.codec import Bound, container, plan, stage as stage_mod
    from repro_torch.store import ArrayStore, ChunkGrid

    edge = field.shape[0]
    x = store_field(field, args.seed)
    raw = x.numel() * x.element_size()
    bound = Bound.rel(1e-3)
    e = plan.resolve_error_bound(x.reshape(-1), bound)
    names = [None, "bitshuffle-rle", "deflate"]
    if stage_mod._zstd() is not None:
        names.append("bitshuffle-zstd")
    else:
        log("store stage bitshuffle-zstd: not run, the zstandard package is not installed "
            "on this machine")
    stores = {}
    for name in names:
        buf = io.BytesIO()
        idx, t_save = timed(lambda: ArrayStore.save(buf, x, bound, stage=name))
        data = buf.getvalue()
        ca, t_open = timed(lambda: ArrayStore.open(io.BytesIO(data)))
        check(idx["e"] == e and ca.nchunks == len(idx["frames"]), f"store {name}: index")
        frames, staged, segs = staged_counts(data, idx)
        log(f"store {edge}^3 f32 stage={name or 'off'} ({ca.nchunks} chunks of "
            f"{tuple(ca.chunk_shape)}): CR {raw / len(data):.4f}, save {t_save:.3f} s "
            f"({raw / t_save / 1e9:.3f} GB/s), open {t_open * 1e3:.3f} ms; staged frames "
            f"{frames}/{ca.nchunks}, staged segments {staged}/{segs}")
        if name == "bitshuffle-rle":
            check(staged > 0, "the rle store staged no segment: the inverse bitshuffle "
                              "would never run")
        stores[name] = (data, idx)
    full_ca = ArrayStore.open(io.BytesIO(stores[None][0]))
    full, t_full = timed(lambda: full_ca[...])
    err = max_abs_diff(full, x)
    check(err <= e, f"store full decode max error {err} > e={e}")
    z, c = edge // 5, min(64, edge // 4)       # at 512: z 102, a 64^3 cube
    rois = {"z-slab": np.s_[z:z + 4],
            "cube": np.s_[z - 3:z - 3 + c, edge // 3:edge // 3 + c, edge // 2:edge // 2 + c],
            "element": np.s_[edge // 2, 3 * edge // 5, 5], "zeroed row": np.s_[5, : edge // 16],
            "all": np.s_[...]}
    for name, (data, idx) in stores.items():
        for fused in (False, True):
            ca = ArrayStore.open(io.BytesIO(data), fused_range=fused)
            rates = []
            for rname, key in rois.items():
                got, t = timed(lambda: ca[key])
                check(same_bits(got, full[key]), f"store {name} fused={fused} {rname}: "
                                                 "differs from the full decode")
                err_r = max_abs_diff(got, x[key])
                check(err_r <= e, f"store {name} {rname}: max error {err_r} > e={e}")
                rates.append(f"{rname} {got.numel() * 4 / t / 1e9:.3f} GB/s ({t * 1e3:.2f} ms)")
            log(f"store ROI reads stage={name or 'off'} "
                f"route={'fused decode_range' if fused else 'host parse + unpack'}: "
                + ", ".join(rates))
        ca = ArrayStore.open(io.BytesIO(data))
        st, t_q = timed(lambda: ca.stats())
        hs, t_h = timed(lambda: ca.stats(header_only=True))
        fd = full.double()
        check(st.exact and st.count == full.numel(), f"store {name}: exact stats count")
        check(st.min[0] == float(full.min()) and st.max[0] == float(full.max()),
              f"store {name}: exact min/max differ from the decoded array's")
        # float64 sums in another order: within 1e-12 of the sum of magnitudes
        check(abs(st.sum[0] - float(fd.sum())) <= 1e-12 * float(fd.abs().sum()),
              f"store {name}: exact sum {st.sum[0]} vs {float(fd.sum())}")
        for k in ("sum", "min", "max", "mean"):
            lo, hi = getattr(hs, k)
            check(lo <= getattr(st, k)[0] <= hi, f"store {name}: header-only {k} interval")
        log(f"store queries stage={name or 'off'}: exact stats {t_q:.3f} s (mean "
            f"{st.mean[0]:.9g}, min {st.min[0]:.9g}, max {st.max[0]:.9g}), header-only "
            f"{t_h:.3f} s (mean in [{hs.mean[0]:.6g}, {hs.mean[1]:.6g}])")
        cid = len(idx["frames"]) // 2
        off, length, _n = idx["frames"][cid]
        grid = ChunkGrid(tuple(idx["shape"]), tuple(idx["chunk_shape"]))
        box = tuple(slice(lo, hi) for lo, hi in grid.chunk_box(grid.chunk_coord(cid)))
        want = container.build_frame(plain_stream(x[box].reshape(-1), e), cid,
                                      last=False, stage=name, device="cpu")
        check(data[off:off + length] == want,
              f"store {name}: chunk {cid}'s frame differs from the plain route's")
    log(f"store: full decode {raw / t_full / 1e9:.3f} GB/s, max|x-x'| {err:.6g} <= e={e:.6g}; "
        f"every ROI by both routes bit-identical to it; chunk frames match the plain route")
    return middle_chunk(*stores[None])


# ---------------------------------------------------------------------------
# phase 6: per-kernel time at the main path's shapes
# ---------------------------------------------------------------------------

def phase_timing(field, store: bytes, reps: int, seed: int):
    import numpy as np
    from repro_torch.core.codec import container, device
    from repro_torch.kernels import decode as dec_mod, encode as enc_mod, ref, specs

    spec = specs.F32
    p, xb = frame_blocks(field)
    e, p_e = p.error_bound, specs.exact_exponent_of(p.error_bound)
    nb, bs, W = p.nblocks, p.block_size, spec.itemsize
    enc_ms = cuda_ms(lambda: enc_mod.encode(xb, e, p_e, spec=spec), reps)
    enc_plain_ms = cuda_ms(lambda: enc_mod.encode_plain(xb, e, spec, p_e), max(reps // 10, 3))
    enc_bytes = nb * bs * W + nb * W + nb + 12 * nb + nb * W * bs + nb * bs

    stream = device.encode_to_stream(xb, p)
    hsize = container.HEADER.size
    body = device.to_device(np.frombuffer(stream, np.uint8, offset=hsize), "cuda")
    nnc = container.HEADER.unpack_from(stream, 0)[7]
    _c, mu, shift, nbytes, rank, _s = ref.parse_body_ref(body, nnc, spec, nb)
    args = (body, nnc, 0, mu, shift, nbytes, rank)
    dec_ms = cuda_ms(lambda: dec_mod.decode_body(*args, spec=spec, bs=bs, rb=nb), reps)
    dec_plain_ms = cuda_ms(
        lambda: dec_mod.decode_body_plain(*args, spec, bs=bs, rb=nb), max(reps // 10, 3))
    time_decode_launches(body, nnc, mu, shift, nbytes, rank, spec, nb, bs, reps)
    nbm = (nb + 7) // 8
    needed_body = body.numel() - (nbm + W * nb + nnc)      # L codes + mid bytes
    dec_bytes = needed_body + nb * (W + 12) + nb * bs * W + 8
    timings = [("encode", f"f32 frame nb={nb} bs={bs}", enc_ms, enc_plain_ms, enc_bytes),
               ("decode_body", f"f32 frame nb={nb} bs={bs}", dec_ms, dec_plain_ms, dec_bytes)]

    timings += time_planes(seed + 5, reps)
    rows = []
    for name, where, ms, pms, nbytes_moved in timings:
        bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        rows.append((name, ms, pms, bound_ms))
        log(f"time {name} {where}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes_moved / 1e6:.3f} MB at 3.35 TB/s, "
            f"{bound_ms / ms * 100:.1f}% of the bound)")
    return rows + time_store_kernels(store, stream, reps)


def frame_blocks(field):
    """The first 64 MiB f32 frame of the field as the codec blocks it (rel
    1e-3, bs 128): (plan, blocks)."""
    from repro_torch.core.codec import plan

    p, xt = plan.make_plan(field.reshape(-1)[: FRAME_BYTES // 4], plan.Bound.rel(1e-3),
                           device="cuda")
    return p, plan.to_blocks(xt, p)


def profiled_ms(fn, reps: int, kernel: str) -> tuple[float, int] | None:
    """Device time of one launch of the kernel whose name holds ``kernel``:
    torch.profiler (card activity only) over ``reps`` calls of ``fn`` after a
    warm-up, the kernel's device time over the launches the trace holds
    (returned beside it: the tracer may miss one at the window's edge), or
    None when the trace holds fewer than half of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in evs)
    check(n <= reps, f"profiler: {n} launches of a kernel named *{kernel}* in {reps} calls")
    return (sum(e.self_device_time_total for e in evs) / n / 1e3, n) if n >= reps // 2 else None


def graph_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` replayed from a CUDA graph of ``reps``
    calls (CUDA events around the replay): the launches back to back with
    no host work between them, so the kernel's device time plus the gap
    between two kernels of a graph."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host-clock time of one call of ``fn`` over ``reps`` back-to-back calls,
    without waiting for the card (the enqueue alone)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def time_store_kernels(chunk_payload: bytes, frame_stream: bytes, reps: int):
    """The store path's kernels -- unpack and unpack_dense (the host-parse
    route's decode) and bitshuffle both ways (the second stage) -- at the
    store chunk's shape (what ROI reads and queries launch) and at one
    64 MiB f32 frame's (nb 131072 through container.parse_stream; 16384
    tiles).  Each gets its device time (torch.profiler), the wrapper call's
    time (CUDA events over ``reps`` calls: the host's rate where that is
    slower than the card), the host time of a call alone, and the bound
    from the bytes it must move (each input byte it needs read once -- for
    unpack the stored plane bytes, not the elided ones -- each output
    written once) at 3.35 TB/s; the plain version at the chunk.  Returns the kernels
    JSON rows (the chunk's numbers, the frame's beside them)."""
    import torch
    from repro_torch.core.codec import container, stage as stage_mod
    from repro_torch.kernels import bitshuffle as bsh, specs, unpack as up

    spec = specs.F32
    W, T = spec.itemsize, specs.tile_bytes(spec)
    plain_reps = max(reps // 10, 3)
    prefix_len = container.stream_prefix_length(chunk_payload)
    sec = container.parse_stream_sections(chunk_payload[:prefix_len], device="cuda")
    nt_chunk = sum(-(-(b - a) // T) for a, b in (
        sec.mid_range(lo, hi)
        for lo, hi in stage_mod._seg_ranges(sec.plan.nblocks, stage_mod.DEFAULT_SEG_BLOCKS)))
    got = {}
    for shape, payload, nt in (("store chunk", chunk_payload, nt_chunk),
                               ("frame", frame_stream, FRAME_BYTES // T)):
        _p, enc = container.parse_stream(payload, device="cuda")
        nb, bs = enc.L.shape
        args = (enc.planes, enc.mu, enc.shift, enc.nbytes)
        # plane bytes each function needs: every live one for unpack_dense;
        # for unpack only the stored ones, max(nbytes - L, 0) a value (the
        # stream's mid bytes), since it fills the elided ones from earlier
        # values
        nbytes64 = enc.nbytes.to(torch.int64)
        live = int(nbytes64.sum()) * bs
        stored = int((nbytes64[:, None] - enc.L.to(torch.int64)).clamp_(min=0).sum())
        meta_out = nb * (W + 4 + 4) + nb * bs * W                # mu, shift, nbytes; out
        log(f"store kernels f32 {shape}: {nb * bs} values, plane bytes live {live} "
            f"({live / (nb * bs):.3f} a value), stored {stored} ({stored / (nb * bs):.3f})")
        tiles = torch.randint(0, 256, (nt, T), dtype=torch.uint8, device="cuda")
        cases = (
            ("unpack", f"nb={nb} bs={bs}", "unpack", lambda: up.unpack(*args, enc.L, spec=spec),
             lambda: up.unpack_plain(*args, enc.L, spec), stored + nb * bs + meta_out),
            ("unpack_dense", f"nb={nb} bs={bs}", "unpack", lambda: up.unpack_dense(*args, spec=spec),
             lambda: up.unpack_dense_plain(*args, spec), live + meta_out),
            ("bitshuffle", f"nt={nt} tiles of {T} B", "bitshuffle",
             lambda: bsh.bitshuffle(tiles, spec=spec), lambda: bsh.bitshuffle_plain(tiles, False),
             2 * nt * T),
            ("bitshuffle_inverse", f"nt={nt} tiles of {T} B", "bitunshuffle",
             lambda: bsh.bitshuffle(tiles, spec=spec, inverse=True),
             lambda: bsh.bitshuffle_plain(tiles, True), 2 * nt * T))
        for name, where, kernel, fn, plain, moved in cases:
            # the profiler's trace, taken again where it came back short; a
            # graph replay of the same calls beside it (and in its place if
            # every trace came back short)
            prof = next(filter(None, (profiled_ms(fn, reps, kernel) for _ in range(3))), None)
            replay = graph_ms(fn, reps)
            dev_ms, how = ((prof[0], f"torch.profiler, {prof[1]} of {reps} launches traced")
                           if prof else (replay, "not traced: a CUDA graph's replay"))
            call = cuda_ms(fn, reps)
            host = host_ms(fn, reps)
            plain_ms = cuda_ms(plain, plain_reps) if shape == "store chunk" else None
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            got[name, shape] = (dev_ms, call, host, bound_ms, plain_ms)
            log(f"time {name} f32 {shape} {where}: device {dev_ms:.4f} ms ({how}; graph "
                f"replay {replay:.4f} ms), call {call:.4f} ms (CUDA events over {reps} wrapper "
                f"calls), host {host:.4f} ms a call, bound {bound_ms:.4f} ms ({moved / 1e6:.3f} MB "
                f"at 3.35 TB/s; {bound_ms / dev_ms * 100:.1f}% of it by the device time)"
                + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else ""))
        del enc, args, tiles
    helper_ms, context_ms = launch_idiom_host_ms(nt_chunk)
    log(f"launch idiom, host time a call of the bitshuffle C entry point at the store chunk "
        f"(median of 5 alternating rounds of 200): _build.launch {helper_ms:.4f} ms, device "
        f"context + current_stream {context_ms:.4f} ms")
    rows = []
    for name in ("unpack", "unpack_dense", "bitshuffle"):
        dev_ms, call, host, bound_ms, plain_ms = got[name, "store chunk"]
        frame = got[name, "frame"]
        extra = {"call_ms": call, "host_ms": host, "frame_ms": frame[0],
                 "frame_call_ms": frame[1], "frame_bound_ms": frame[3]}
        if name == "bitshuffle":
            inv, inv_frame = got["bitshuffle_inverse", "store chunk"], got["bitshuffle_inverse", "frame"]
            extra.update(inverse_ms=inv[0], inverse_call_ms=inv[1], inverse_frame_ms=inv_frame[0],
                         inverse_frame_call_ms=inv_frame[1])
        rows.append((name, dev_ms, plain_ms, bound_ms, extra))
    return rows


def launch_idiom_host_ms(nt: int, reps: int = 200, rounds: int = 5) -> tuple[float, float]:
    """Host time of one launch of the bitshuffle C entry point on ``nt``
    tiles by the wrappers' idiom (``_build.launch``: the raw handle of the
    current stream, no device context when the card is current) and by the
    idiom it replaced (a ``torch.cuda.device`` context around the call and
    ``torch.cuda.current_stream(dev).cuda_stream``), in alternating rounds
    of ``reps`` calls: the median of the rounds, ms a call, for each."""
    import statistics
    import torch
    from repro_torch.kernels import _build, bitshuffle as bsh, specs

    T = specs.tile_bytes(specs.F32)
    tiles = torch.zeros((nt, T), dtype=torch.uint8, device="cuda")
    out = torch.empty_like(tiles)
    fn = _build.function("bitshuffle", "szx_bitshuffle_vector", bsh._ARGTYPES)
    args, dev = (tiles.data_ptr(), out.data_ptr(), nt, T, 0), tiles.device

    def helper():
        return _build.launch(fn, dev, args)

    def context():
        with torch.cuda.device(dev):
            return fn(*args, torch.cuda.current_stream(dev).cuda_stream)

    times = {helper: [], context: []}
    for _ in range(rounds):
        for f in (helper, context):
            check(f() == 0, "bitshuffle launch for the launch-idiom timing")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                f()
            times[f].append((time.perf_counter() - t0) / reps * 1e3)
            torch.cuda.synchronize()
    return statistics.median(times[helper]), statistics.median(times[context])


def time_decode_launches(body, nnc, mu, shift, nbytes, rank, spec, nb, bs, reps):
    """decode_body's two launches timed apart on a copy of the wrapper's call
    (the same C entry points, arguments and scratch): the scan of the blocks'
    stored-byte counts, with the zeroing of its tile status, and the gather."""
    import ctypes
    import torch
    from repro_torch.kernels import _build, decode as dec_mod

    W = spec.itemsize
    l_off = (nb + 7) // 8 + W * nb + nnc
    mid_off = l_off + (nnc * bs + 3) // 4
    c_ll, c_int, c_ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    scan = _build.function("decode", "szx_decode_scan",
                           [c_ptr, c_ll, c_ll, c_int, c_ll] + [c_ptr] * 6)
    gather = _build.function("decode", "szx_decode_gather",
                             [c_int, c_ptr, c_ll, c_int] + [c_ll] * 4 + [c_int] + [c_ptr] * 7)
    n_status = _build.function("decode", "szx_decode_status_len", dec_mod._STATUS_ARGTYPES)(nb, bs)
    status = torch.zeros(n_status, dtype=torch.int64, device="cuda")
    starts = torch.empty(nb, dtype=torch.int64, device="cuda")
    total = torch.empty(1, dtype=torch.int64, device="cuda")
    out = torch.empty((nb, bs), dtype=spec.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def do_scan():
        status.zero_()
        check(scan(body.data_ptr(), body.numel(), nb, bs, l_off, nbytes.data_ptr(),
                   rank.data_ptr(), status.data_ptr(), starts.data_ptr(), total.data_ptr(),
                   stream) == 0, "decode scan launch")

    def do_gather():
        check(gather(spec.code, body.data_ptr(), body.numel(), bs, l_off, mid_off, 0, nb, 0,
                     mu.data_ptr(), shift.data_ptr(), nbytes.data_ptr(), rank.data_ptr(),
                     starts.data_ptr(), out.data_ptr(), stream) == 0, "decode gather launch")

    scan_ms = cuda_ms(do_scan, reps)
    gather_ms = cuda_ms(do_gather, reps)
    want, want_total = dec_mod.decode_body_plain(body, nnc, 0, mu, shift, nbytes, rank, spec,
                                                 bs=bs, rb=nb)
    check(same_bits(out, want) and int(total) == int(want_total),
          "decode scan + gather, called apart, differ from the plain version")
    log(f"time decode_body launches {spec.name} frame nb={nb} bs={bs}: scan (with its status "
        f"zeroing) {scan_ms:.4f} ms, gather {gather_ms:.4f} ms")


def time_planes(seed: int, reps: int):
    """planes_encode / planes_decode at the shape the gradient path launches
    them on its largest-row leaf, llama3.2-1b's embed gradient (128256 x 2048
    f32, block 64), at P = 1 (the kernels line) and P = 2, each beside the
    scalar route at the same shape (the warp-per-block kernels, called
    through their C entry points: vector, scalar, vector); then at the
    serving shapes, as the wrapper is called there: a decode step's K or V
    encode (4, 8, 64) and cache chunk decodes (4, 2048, 8, 64) and
    (4, 64, 8, 64) with the cache's int8 sexp."""
    import torch
    from repro_torch.kernels import _build, planes as pk, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, d = LLAMA_1B_GRADS["embed"]
    xb = (torch.randn((rows, d), device="cuda", generator=gen) * 1e-3).reshape(rows, -1, GRAD_BLOCK)
    n, nb = xb.numel(), xb.numel() // GRAD_BLOCK
    tab = ref.planes_scale_table("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    enc_scalar = _build.function("planes", "szx_planes_encode_scalar", pk._ENCODE_ARGTYPES)
    dec_scalar = _build.function("planes", "szx_planes_decode_scalar", pk._DECODE_ARGTYPES)
    out = []
    for P in (1, 2):
        mu, sexp, planes = enc = pk.planes_encode(xb, P)
        smu, ssexp, splanes = torch.empty_like(mu), torch.empty_like(sexp), torch.empty_like(planes)
        sout = torch.empty_like(xb)

        def encode_scalar():
            check(enc_scalar(xb.data_ptr(), nb, GRAD_BLOCK, P, tab.data_ptr(), smu.data_ptr(),
                             ssexp.data_ptr(), splanes.data_ptr(), stream) == 0,
                  "scalar planes encode launch")

        def decode_scalar():
            check(dec_scalar(mu.data_ptr(), sexp.data_ptr(), 4, planes.data_ptr(), nb,
                             GRAD_BLOCK, P, tab.data_ptr(), sout.data_ptr(), stream) == 0,
                  "scalar planes decode launch")

        moved = n * 4 + n * P + nb * 8          # f32 values, P planes, mu + int32 sexp
        where = f"embed gradient {rows}x{d} P={P} block {GRAD_BLOCK}"
        check(pk.encode_route(xb) == "vector", f"{where}: not the vector route")
        for name, fn, plain, scalar in (
                ("planes_encode", lambda: pk.planes_encode(xb, P),
                 lambda: pk.planes_encode_plain(xb, P), encode_scalar),
                ("planes_decode", lambda: pk.planes_decode(*enc),
                 lambda: pk.planes_decode_plain(*enc), decode_scalar)):
            ms, scalar_ms, ms_again = cuda_ms(fn, reps), cuda_ms(scalar, reps), cuda_ms(fn, reps)
            plain_ms = cuda_ms(plain, max(reps // 10, 3))
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            log(f"time {name} {where} by route: vector {ms:.4f} / {ms_again:.4f} ms, scalar "
                f"{scalar_ms:.4f} ms ({scalar_ms / ms:.2f}x), plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_ms / ms * 100:.1f}% of it)")
            if P == 1:
                out.append((name, where, ms, plain_ms, moved))
        torch.cuda.synchronize()
        check(same_bits(smu, mu) and same_bits(ssexp, sexp) and same_bits(splanes, planes)
              and same_bits(sout, pk.planes_decode(*enc)), f"{where}: the routes differ")
        del enc, mu, sexp, planes, smu, ssexp, splanes, sout
    del xb
    for P in (1, 2):
        x = torch.randn((4, 8, 64), device="cuda", generator=gen)
        m = x.numel()
        ms = cuda_ms(lambda: pk.planes_encode(x, P), reps * 4)
        bound_ms = (m * 4 + m * P + m // 64 * 8) / HBM_BYTES_PER_S * 1e3
        log(f"time planes_encode serving (4, 8, 64) P={P} (a wrapper call, host included): "
            f"{ms:.4f} ms, bound {bound_ms:.6f} ms")
        for shape in ((4, 2048, 8, 64), (4, 64, 8, 64)):
            mu, sexp, planes = pk.planes_encode(torch.randn(shape, device="cuda", generator=gen), P)
            s8 = sexp.clamp(-127, 127).to(torch.int8)
            m = planes[0].numel()
            ms = cuda_ms(lambda: pk.planes_decode(mu, s8, planes), reps * 4)
            bound_ms = (m * P + m // 64 * 5 + m * 4) / HBM_BYTES_PER_S * 1e3
            log(f"time planes_decode serving {shape} P={P} int8 sexp (a wrapper call, host "
                f"included): {ms:.4f} ms, bound {bound_ms:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 7: where one frame's time goes
# ---------------------------------------------------------------------------

def phase_breakdown(field, reps: int = 5) -> None:
    """Host-clock time of each stage of compress and decompress for one
    64 MiB f32 frame (synchronized around every stage; median of reps)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.core.codec import container, device, plan, transform
    from repro_torch.kernels import decode as dec_mod, ops, ref, specs

    spec = specs.F32
    chunk = field.reshape(-1)[: FRAME_BYTES // 4]
    e = plan.resolve_error_bound(field.reshape(-1), plan.Bound.rel(1e-3))
    p_e = specs.exact_exponent_of(e)
    times: dict[str, list[float]] = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return res

    for _ in range(reps):
        p, xt = stage("c.plan", lambda: plan.make_plan(chunk, e, device="cuda"))
        xb = plan.to_blocks(xt, p)
        enc = stage("c.encode kernel", lambda: transform.BlockEncoding(
            *ops.encode_staged(xb, e, p_e, spec=spec)))
        body, nnc, nmid = stage("c.assemble body", lambda: device._assemble_body(spec, enc))
        host = stage("c.copy to host", lambda: device.to_host(body))
        stream = stage("c.header + bytes", lambda: b"".join((container.HEADER.pack(
            container.MAGIC, container.VERSION, 0, 128, p.n, e, p.nblocks, nnc, nmid),
            host.numpy())))
        stage("c.total SZxCodec.compress", lambda: device.encode_to_stream(xb, p))
        raw = np.frombuffer(stream, np.uint8, offset=container.HEADER.size)
        dbody = stage("d.copy to device", lambda: device.to_device(raw, "cuda"))
        parsed = stage("d.parse body", lambda: ref.parse_body_ref(dbody, nnc, spec, p.nblocks))
        vals, total = stage("d.decode kernel", lambda: dec_mod.decode_body(
            dbody, nnc, 0, *parsed[1:5], spec=spec, bs=128, rb=p.nblocks))
        stage("d.measured readback", lambda: device.to_host(
            torch.stack([parsed[5], parsed[3].max().to(torch.int64), total])))
        stage("d.total SZxCodec.decompress", lambda: device.decode_stream(stream, device="cuda"))
    med = {k: statistics.median(v) for k, v in times.items()}
    for side, label in (("c.", "compress"), ("d.", "decompress")):
        total = next(v for k, v in med.items() if k.startswith(side + "total"))
        parts = ", ".join(f"{k[2:]} {v:.3f} ms ({100 * v / total:.0f}%)"
                          for k, v in med.items() if k.startswith(side) and "total" not in k)
        log(f"breakdown {label} of one f32 64 MiB frame (median of {reps}): "
            f"total {total:.3f} ms = {FRAME_BYTES / total / 1e6:.3f} GB/s; {parts}")



# ---------------------------------------------------------------------------
# phase 8: the szx-planes gradient path at the full width of llama3.2-1b
# ---------------------------------------------------------------------------

# The gradient pytree of llama3.2-1b: the leaf shapes of
# src/repro/models/transformer.py:117 init_params with
# src/repro/configs/llama3p2_1b.py (d_model 2048, 16 layers stacked on a
# leading axis, 32 heads and 8 kv heads of 64, d_ff 8192, vocab 128256, tied
# embeddings): 1,235,814,400 float32 values, 4.94 GB.
LLAMA_1B_GRADS = {
    "embed": (128256, 2048),
    "layers": {
        "attn": {"wq": (16, 2048, 2048), "wk": (16, 2048, 512),
                 "wv": (16, 2048, 512), "wo": (16, 2048, 2048)},
        "ln1": (16, 2048), "ln2": (16, 2048),
        "mlp": {"wi": (16, 2048, 16384), "wo": (16, 8192, 2048)},
    },
    "final_ln": (2048,),
}
GRAD_BLOCK = 64                    # grad_compress.DEFAULT_BLOCK (repro/core/grad_compress.py:26)


def leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def planes_edge_blocks(bs: int = 8):
    """Blocks the planes math must get right: constant blocks, signed zeros,
    subnormals, tiny radius (sexp >= 127), NaN with payloads, +-inf, and
    min + max that overflows."""
    import torch

    nan, inf = float("nan"), float("inf")
    snan = struct.unpack("<f", struct.pack("<I", 0x7F812345))[0]
    neg_nan = struct.unpack("<f", struct.pack("<I", 0xFFC00001))[0]
    fill = [float(i) for i in range(1, bs)]
    rows = [[0.0] * bs, [-0.0] * bs, [0.0, -0.0] * (bs // 2), [3.5] * bs, [1e-40] * bs,
            [0.0] * 3 + [1e-40] + [0.0] * (bs - 4), [-1e-40, 1e-40] + [0.0] * (bs - 2),
            [1e-38, 1.2e-38] + [1.1e-38] * (bs - 2), [1.5e-38, -1.2e-38] + [1.3e-38] * (bs - 2),
            [1.0, 1.0 + 2 ** -23] + [1.0] * (bs - 2), [1e-30] * (bs - 1) + [1.0000001e-30],
            [nan] + fill, [1.0, nan, nan] + fill[2:], [snan] + fill, [neg_nan] * bs,
            [inf] + fill, [-inf] + fill, [inf, -inf] + [0.0] * (bs - 2), [inf] * bs,
            [3e38, 2e38] + [3.3e38] * (bs - 2), [-3e38, -2e38] + [-3.3e38] * (bs - 2),
            [3.4e38, -3.4e38] + fill[:-1]]
    return torch.tensor(rows, dtype=torch.float32, device="cuda")


def check_vector_route(path: str, routes: dict) -> None:
    """Every planes launch of a main path took the vector route."""
    for k in PLANES_KERNELS:
        check(routes[f"{k}_vector"] > 0 and routes[f"{k}_scalar"] == 0,
              f"{path}: {k} launches by route {routes}")


def planes_both(x, P):
    """Kernel and plain planes encode of ``x`` and decode of the result;
    asserts bit identity of all four outputs."""
    from repro_torch.kernels import planes as pk

    k = pk.planes_encode(x, P)
    p = pk.planes_encode_plain(x, P)
    for name, a, b in zip(("mu", "sexp", "planes"), k, p):
        check(same_bits(a, b), f"planes_encode P={P} {tuple(x.shape)}: {name} differs")
        MAX_ERR["planes_encode"] = max(MAX_ERR["planes_encode"], max_abs_diff(a, b))
    planes_decode_both(*k)
    return k


def planes_decode_both(mu, sexp, planes):
    from repro_torch.kernels import planes as pk

    kd = pk.planes_decode(mu, sexp, planes)
    pd = pk.planes_decode_plain(mu, sexp, planes)
    check(same_bits(kd, pd), f"planes_decode P={planes.shape[0]} {tuple(planes.shape)}: differs")
    MAX_ERR["planes_decode"] = max(MAX_ERR["planes_decode"], max_abs_diff(kd, pd))
    return kd


def phase_planes_kernels(gen):
    """planes_encode / planes_decode against their plain versions, on both
    routes (kernels/planes.py ``route``), with sexp at each stored width."""
    import torch
    from repro_torch.kernels import ops, planes as pk

    t0 = time.perf_counter()
    before = ops.planes_route_counts()
    cases = []
    for bs in PLANES_BS:
        nb = (1 << 22) // bs
        scale = torch.exp2(torch.randint(-40, 40, (nb, 1), device="cuda", generator=gen).float())
        cases.append(torch.randn((nb, bs), device="cuda", generator=gen) * scale)
    cases.append(torch.randn((3, 5, 2, 32), device="cuda", generator=gen))     # leading dims
    cases.append(torch.zeros((0, 64), device="cuda"))                           # nb = 0
    cases += [planes_edge_blocks(), planes_edge_blocks(64)]
    base = 1.0 + torch.rand((2000, 1), device="cuda", generator=gen)            # sexp >= 127
    cases.append(base + torch.randint(0, 3, (2000, 16), device="cuda", generator=gen) * 2.0 ** -23 * base)
    flat = torch.randn((1 << 16) * 64 + 1, device="cuda", generator=gen)
    off = flat[1:].reshape(-1, 64)                      # one float off 16 bytes
    check(pk.encode_route(off) == "scalar", "a view one float off takes the scalar route")
    cases.append(off)
    for x in cases:
        for P in (1, 2, 3):
            mu, sexp, planes = planes_both(x, P)
            if x.numel() and x is off:                  # planes one byte off: scalar decode
                buf = torch.empty(planes.numel() + 1, dtype=torch.uint8, device="cuda")
                shifted = buf[1:].view(planes.shape)
                shifted.copy_(planes)
                check(pk.decode_route(shifted) == "scalar", "planes one byte off: scalar route")
                planes_decode_both(mu, sexp, shifted)
    nb = 1 << 16
    mu = torch.randn(nb, device="cuda", generator=gen) * torch.exp2(
        torch.randint(-140, 127, (nb,), device="cuda", generator=gen).float())
    mu[::97], mu[1::101], mu[2::103], mu[3::107] = float("nan"), float("inf"), 1e-40, -0.0
    sexp = torch.randint(-300, 300, (nb,), device="cuda", generator=gen, dtype=torch.int32)
    edges = torch.tensor([-128, -127, -126, -125, 125, 126, 127, 128, 0, 2 ** 31 - 1, -2 ** 31],
                         dtype=torch.int32, device="cuda")
    sexp[::5] = edges.repeat(nb // 50 + 1)[: len(sexp[::5])]
    narrow = {torch.int32: sexp, torch.int16: sexp.clamp(-2 ** 15, 2 ** 15 - 1).to(torch.int16),
              torch.int8: sexp.clamp(-128, 127).to(torch.int8)}
    for bs in (64, 3):
        for P in (1, 2, 3):
            planes = torch.randint(0, 256, (P, nb, bs), dtype=torch.uint8, device="cuda",
                                   generator=gen)
            for s in narrow.values():                   # each width read as stored
                planes_decode_both(mu, s, planes)
    torch.cuda.synchronize()
    routes = {k: v - before[k] for k, v in ops.planes_route_counts().items()}
    for k, n in routes.items():
        check(n > 0, f"phase 2 never launched {k}")
    log(f"planes kernels vs plain: bit-identical for P = 1, 2, 3 at bs = "
        f"{', '.join(map(str, PLANES_BS))} (2^22 values each), leading dims, nb = 0, edge "
        f"blocks, a view one float off and planes one byte off (scalar route), and random "
        f"records with sexp at +-127 and beyond, read as int32, int16 and int8; launches by "
        f"route {routes} ({time.perf_counter() - t0:.1f} s)")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def llama_grads(seed: int):
    """A gradient tree of llama3.2-1b's shapes on the card: normal values at a
    magnitude drawn per row (1e-6 .. 1e-1), as gradients vary by layer."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape):
        rows = torch.empty(shape[:-1] + (1,), device="cuda").uniform_(-6.0, -1.0, generator=gen)
        return torch.randn(shape, device="cuda", generator=gen) * torch.pow(10.0, rows)

    return tree_map(make, LLAMA_1B_GRADS)


def check_leaf(name, x, mean, resid, P):
    """One leaf of a one-member psum-mean against the plain versions on the
    card: the mean is (0 + decode(encode(x))) * 1, the residual is
    x - decode(encode(x)), both bit for bit; the error per value is within
    max_block_error_bound, widened as stated below.  Returns (values over
    the bare bound, values at the top of the range, max error / bound)."""
    import torch
    from repro_torch.core import planes as cplanes
    from repro_torch.kernels import ref

    xb = x.reshape(x.shape[:-1] + (-1, GRAD_BLOCK))
    mu, sexp, planes = ref.planes_encode_ref(xb, P)
    dec = ref.planes_decode_ref(mu, sexp, planes).reshape(x.shape)
    want_mean = ref.mul_flushed(ref.flush(torch.zeros_like(dec) + dec), torch.ones_like(dec))
    check(same_bits(mean, want_mean), f"psum-mean P={P} {name}: mean != plain decode(encode)")
    check(same_bits(resid, ref.flush(ref.flush(x) - dec)), f"psum-mean P={P} {name}: residual")
    # max_block_error_bound takes the scale as an exact power of two and
    # leaves out clamp events.  The jax route's exp2 is a few ulps off 2^s
    # (delta = |scale(s) 2^-s - 1|), which adds |x - mu| |scale(s) scale(-s) - 1|
    # to every value; a value clamped to the top of the range is off by up to
    # one step more, 2 bound (1 + 2^(8P-1) delta); and the three float
    # roundings (x - mu, the product, the add) each add half an ulp of a value
    # below |mu| + |x - mu|
    bound = cplanes.max_block_error_bound(
        cplanes.PlanesEncoded(mu, sexp, planes, x.numel(), GRAD_BLOCK)).double()[..., None]
    scale, inv = ref.planes_exp2(sexp.float()).double(), ref.planes_exp2(-sexp.float()).double()
    skew = (scale * inv - 1).abs()[..., None]
    delta = (scale * torch.pow(2.0, -sexp.double()) - 1).abs()[..., None]
    v = (xb.double() - mu.double()[..., None]).abs()
    err = (dec.reshape(xb.shape).double() - xb.double()).abs()
    uq = planes[0].to(torch.int32)
    for k in range(1, P):
        uq |= planes[k].to(torch.int32) << (8 * k)
    top = uq == (1 << (8 * P - 1)) - 1
    limit = (bound * torch.where(top, 2 + 2.0 ** (8 * P) * delta, 1.0) + v * skew
             + 2.0 ** -22 * (mu.double().abs()[..., None] + v))
    check(bool((err <= limit).all()), f"psum-mean P={P} {name}: error above the block bound")
    over = int((err > bound).sum())
    return over, int(top.sum()), float((err / bound).max())


def phase_gradient(args):
    """The gradient of llama3.2-1b through compressed_psum_mean with error
    feedback in a one-rank NCCL group, then compressed_ppermute on a ring of
    one, compressed_all_to_all on one rank and pipeline_apply on one stage."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import grad_compress as gc

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    wire = [0]
    gather = dist.all_gather

    def counted(parts, t, group=None, async_op=False):        # bytes each member sends
        wire[0] += t.numel() * t.element_size()
        return gather(parts, t, group=group, async_op=async_op)

    dist.all_gather = counted
    rows = {}
    try:
        grads = llama_grads(args.seed + 3)
        n = sum(g.numel() for _, g in leaves(grads))
        check(n == 1_235_814_400, f"llama3.2-1b gradient has {n} values")
        for P in (1, 2):
            acc = tree_map(torch.zeros_like, grads)
            times = []
            for step in range(3):
                inp = tree_map(torch.add, grads, acc)
                wire[0] = 0
                (mean, resid), t = timed(lambda: gc.compressed_psum_mean(
                    inp, None, num_planes=P, block=GRAD_BLOCK))
                times.append(t)
                want = n * gc.wire_bytes_per_value(P, GRAD_BLOCK)
                check(wire[0] == want, f"psum-mean P={P}: wire bytes {wire[0]} != {want}")
                over = clamps = 0
                worst = 0.0
                for (name, x), (_, m), (_, r) in zip(leaves(inp), leaves(mean), leaves(resid)):
                    # in slices of the leading axis (whole blocks) to bound memory
                    per = x.shape[0] if x.dim() == 1 else max(1, (1 << 26) // (x.numel() // x.shape[0]))
                    for i in range(0, x.shape[0], per):
                        sl = slice(i, i + per)
                        o, c, w = check_leaf(name, x[sl], m[sl], r[sl], P)
                        over, clamps, worst = over + o, clamps + c, max(worst, w)
                log(f"grad psum-mean P={P} step {step + 1}: {t:.3f} s host clock "
                    f"({n * 4 / t / 1e9:.3f} GB/s of f32 gradient), wire {wire[0]} B "
                    f"({wire[0] / n:.4f} B/value); mean and residual bit-identical to the plain "
                    f"route; error within the block bound ({over} values above the bare bound, "
                    f"{clamps} at the top of the range, max error/bound {worst:.6f})")
                acc = resid                      # error feedback
                del inp, mean
            rows[P] = times
        del grads, acc, resid
        # activation traffic: one microbatch of hidden states (8 x 2048 tokens x d_model)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 4)
        h = torch.randn((8, 2048, 2048), device="cuda", generator=gen)
        from repro_torch.kernels import ref

        for P in (1, 3):
            want = ref.planes_decode_ref(*ref.planes_encode_ref(
                h.reshape(8, 2048, -1, GRAD_BLOCK), P)).reshape(h.shape)
            got = gc.compressed_ppermute(h, None, [(0, 0)], num_planes=P, block=GRAD_BLOCK)
            check(same_bits(got, want), f"compressed_ppermute P={P} on a ring of one")
            got = gc.compressed_all_to_all(h, None, 0, 1, num_planes=P, block=GRAD_BLOCK)
            check(same_bits(got, want), f"compressed_all_to_all P={P} on one rank")
        log("compressed_ppermute (ring of one: a self-pair is a local copy) and compressed_all_to_all "
            "(one rank) of (8, 2048, 2048) hidden states at P = 1, 3: bit-identical to the "
            "plain decode(encode)")
        # the GPipe schedule with compressed shifts, one stage on a ring of
        # one: each of the 8 ticks round-trips the stage's output through
        # both planes kernels (the shift's result feeds no later stage here;
        # the cross-card case is tests/test_torch_cuda.py)
        from repro_torch.kernels import ops
        from repro_torch.pipeline_par import pipeline_apply

        w = torch.stack([torch.full((2048,), 2.0, device="cuda"),
                         torch.randn(2048, device="cuda", generator=gen).round()])
        before = ops.launch_counts()
        out = pipeline_apply(lambda p, x: x * p[0] + p[1], compress_activations=True,
                             num_planes=1, compress_block=GRAD_BLOCK)(w, h)
        after = ops.launch_counts()
        check(same_bits(out, h * w[0] + w[1]), "pipeline_apply: outputs != the stage's")
        for k in PLANES_KERNELS:
            check(after[k] - before[k] == h.shape[0],
                  f"pipeline_apply: {after[k] - before[k]} {k} launches for {h.shape[0]} ticks")
        log(f"pipeline_apply, one stage, compressed shifts at P = 1: outputs bit-identical to "
            f"the stage's; {h.shape[0]} ticks launched each planes kernel {h.shape[0]} times")
    finally:
        dist.all_gather = gather
        dist.destroy_process_group()
    return rows


# ---------------------------------------------------------------------------
# phase 9: serving llama3.2-1b at full width
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core rate (data sheet)
FP32_FLOPS = 67e12                 # H100 SXM float32 rate on the CUDA cores (data sheet)
SERVE_ARCH = "llama3.2-1b"         # src/repro/configs/llama3p2_1b.py, full width and depth
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 64
SERVE_MODES = (("dense", 1), ("compressed", 1), ("compressed", 2))
TEACHER_STEPS = 4                  # decode steps held to forward over the same tokens
# decode logits vs forward over the same tokens, as a share of the largest
# logit (tests/test_models.py's criterion): bf16 activations at full depth
# round at other places in the two forms, and the compressed cache adds the
# planes' quantization.  Measured on the card (PERF.md §6): up to 0.0154
# dense, 0.0237 at P = 1, 0.0152 at P = 2; the limits are twice the dense
# figure and the reference's own compressed limit (0.06)
TEACHER_TOL = {"dense": 0.03, "compressed": 0.06}
PROFILE_STEPS = 2                  # decode steps in each traced run
# phase 14's prefill shapes (B, S, Hq, Hkv, hd, causal, window): hymba's
# 25 query heads over 5 kv heads with its 2048-token window, deepseek's 16
# heads of 128 (configs/hymba_1p5b.py, configs/deepseek_moe_16b.py)
FAMILY_FLASH = {"hymba-1.5b": (4, 2048, 25, 5, 64, True, 2048),
                "deepseek-moe-16b": (4, 2048, 16, 16, 128, True, 0)}
# phase 15's shapes, rows 8d-8g of PERF.md's kernel table (B, Sq, Hq, Hkv, hd,
# causal, window, Skv): whisper-medium's encoder over its 1500 frames (not a
# multiple of the 64-key tile), its cross-attention (384 decoder positions
# against 1500) and its decoder's self-attention; internvl2-1b's prefill of
# 256 image embeddings and 1792 tokens, 14 query heads over 2 (G = 7, which
# does not divide the kernel's 64 rows) (configs/whisper_medium.py,
# configs/internvl2_1b.py)
ENC_VLM_FLASH = {"8d whisper-medium encoder": (4, 1500, 16, 16, 64, False, 0, 1500),
                 "8e whisper-medium cross": (4, 384, 16, 16, 64, False, 0, 1500),
                 "8f whisper-medium decoder": (4, 384, 16, 16, 64, True, 0, 384),
                 "8g internvl2-1b prefill": (4, 2048, 14, 2, 64, True, 0, 2048)}
# phase 20's kernel shapes (B, Sq, Hq, Hkv, hd, causal, window, Skv,
# q_offset): h2o-danube-1.8b's long-context prefill (32 query heads over 8 of
# 80, a 4096 window; configs/h2o_danube_1p8b.py) on one member, the whole
# 524288-token prompt, and on a rank of 16 along 'data', its 32768 queries
# after the 4095-key halo of the window before them; deepseek-moe-16b's and
# internvl2-1b's prefill of 32768 positions on one member (16 heads of 128;
# 14 query heads over 2 of 64: configs/deepseek_moe_16b.py,
# configs/internvl2_1b.py); two shapes only a rank of 4 runs (the CPU tests'
# gloo ranks): deepseek's last rank, 8192 queries after a 24576-key halo,
# and a whisper-medium encoder rank's 375 frames against all 1500
LONG_FLASH = {"20 h2o-danube-1.8b, one member": (1, 524288, 32, 8, 80, True, 4096, 524288, 0),
              "20 h2o-danube-1.8b, a rank of 16": (1, 32768, 32, 8, 80, True, 4096, 36863, 4095),
              "20 deepseek-moe-16b, one member": (1, 32768, 16, 16, 128, True, 0, 32768, 0),
              "20 internvl2-1b, one member": (1, 32768, 14, 2, 64, True, 0, 32768, 0),
              "20 deepseek-moe-16b, the last rank of 4": (1, 8192, 16, 16, 128, True, 0, 32768,
                                                          24576),
              "20 whisper-medium encoder, a rank of 4": (1, 375, 16, 16, 64, False, 0, 1500, 0)}
# phase 21's prefill shapes, rows 8m-8n of PERF.md's kernel table (B, S, Hq,
# Hkv, hd, causal, window): stablelm-3b's 32 heads of 80 with as many kv
# heads, yi-6b's 32 query heads over 4 of 128 (configs/stablelm_3b.py,
# configs/yi_6b.py); both train at the same shapes
DENSE_FLASH = {"8m stablelm-3b prefill": (4, 2048, 32, 32, 80, True, 0),
               "8n yi-6b prefill": (4, 2048, 32, 4, 128, True, 0)}
FLASH_CASES = (            # (B, S, Hq, Hkv, hd, causal, window[, Skv[, q_offset]], dtype name)
    (4, 2048, 32, 8, 64, True, 0, "bfloat16"),      # llama3.2-1b's prefill, the main path
    (4, 2048, 32, 8, 64, True, 512, "bfloat16"),    # a sliding window
    (4, 2000, 32, 8, 64, True, 0, "bfloat16"),      # unaligned S
    (2, 1024, 32, 32, 80, True, 0, "bfloat16"),     # hd 80 (stablelm-3b)
    (2, 1024, 32, 4, 128, True, 0, "bfloat16"),     # hd 128 (yi-6b)
) + tuple(shape + ("bfloat16",) for shape in DENSE_FLASH.values()) + (       # phase 21
    (2, 1024, 32, 8, 64, True, 0, "float32"),
    FAMILY_FLASH["hymba-1.5b"] + ("bfloat16",),      # G = 5, window = S (phase 14)
    FAMILY_FLASH["deepseek-moe-16b"] + ("bfloat16",),  # G = 1, hd 128 (phase 14)
) + tuple(shape + ("bfloat16",) for shape in ENC_VLM_FLASH.values()) + (      # phase 15
    # phase 20: 4096 queries after h2o-danube-1.8b's 4095-key halo, a
    # full-causal float32 case with an offset, and a whisper-medium encoder
    # rank of 4 (375 frames against all 1500, non-causal)
    (1, 4096, 32, 8, 80, True, 4096, 8191, 4095, "bfloat16"),
    (1, 1024, 32, 8, 64, True, 0, 2560, 1536, "float32"),
    LONG_FLASH["20 whisper-medium encoder, a rank of 4"] + ("bfloat16",),
)


def flash_shape(shape) -> tuple:
    """(B, Sq, Hq, Hkv, hd, causal, window, Skv, q_offset) of a case's
    shape; Skv is Sq and q_offset 0 where the shape leaves them out."""
    shape = tuple(shape)
    return (shape + (shape[1], 0)[len(shape) - 7:])[:9]


def flash_inputs(gen, b, s, hq, hkv, hd, dtype, skv=None):
    import torch

    skv = s if skv is None else skv
    return tuple(torch.randn(shape, device="cuda", generator=gen).to(dtype)
                 for shape in ((b, s, hq, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))


def phase_flash_kernel(gen, cases=FLASH_CASES):
    """The flash-attention kernel against its plain version on the card.
    Tolerance: float32 sums in another order (|d| <= 1e-5 |ref| + 1e-6);
    bf16 outputs are one rounding of a float32 result in both, so they may
    differ by one bf16 ulp (|d| <= 2^-7 |ref| + 1e-6)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    for *shape, dname in cases:
        b, s, hq, hkv, hd, causal, window, skv, off = flash_shape(shape)
        dtype = getattr(torch, dname)
        q, k, v = flash_inputs(gen, b, s, hq, hkv, hd, dtype, skv)
        got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=off)
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        d = (got.float() - want.float()).abs()
        check(bool((d <= rtol * want.float().abs() + 1e-6).all()) and not bool(got.isnan().any()),
              f"flash_attention B={b} S={s} Skv={skv} Hq={hq} Hkv={hkv} hd={hd} causal={causal} "
              f"window={window} q_offset={off} {dname}: max |kernel - plain| {float(d.max())}")
        MAX_ERR["flash_attention"] = max(MAX_ERR["flash_attention"], float(d.max()))
        MAX_ERR_CASES[tuple(shape)] = float(d.max())
        log(f"flash_attention vs plain B={b} S={s} Skv={skv} Hq={hq} Hkv={hkv} hd={hd} "
            f"causal={causal} window={window} q_offset={off} {dname}: max |d| "
            f"{float(d.max()):.3e} (tolerance {'2^-7' if rtol > 1e-5 else '1e-5'} |ref| + 1e-6)")
    torch.cuda.synchronize()
    log(f"flash kernel vs plain: {len(cases)} cases within tolerance "
        f"({time.perf_counter() - t0:.1f} s)")


def time_flash(gen, reps: int, shape=(SERVE_BATCH, SERVE_PROMPT, 32, 8, 64, True, 0)):
    """The kernel, its plain version and scaled_dot_product_attention (the
    yardstick; the port never calls it) at a prefill shape (default
    llama3.2-1b's; Skv may differ from Sq where the attention is not
    causal), beside the bound from this input's bytes and the operations of
    its unmasked (q, k) pairs.  A window no shorter than S masks nothing the
    causal mask keeps, so SDPA's is_causal computes the same function
    there."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, s, hq, hkv, hd, causal, window, skv, _off = flash_shape(shape)
    check((not window or window >= s) and (skv == s or not causal),
          f"time_flash: SDPA has no window < S and no causal rectangle {shape}")
    q, k, v = flash_inputs(gen, b, s, hq, hkv, hd, torch.bfloat16, skv)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window),
                       max(reps // 10, 3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                            enable_gqa=True), reps)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    pairs = s * (s + 1) // 2 if causal else s * skv    # (q, k) pairs the mask keeps
    flops = b * hq * pairs * hd * 4                # q.k and p @ v, 2 flops a multiply-add
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"time flash_attention bf16 B={b} S={s} Skv={skv} Hq={hq} Hkv={hkv} hd={hd} "
        f"causal={causal} window={window}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms ({flops / 1e9:.3f} GFLOP at 989 TFLOP/s bf16; "
        f"{nbytes / 1e6:.3f} MB at 3.35 TB/s takes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
        f"{bound_ms / ms * 100:.1f}% of the bound; the bf16 route runs 4 products (q.k, and "
        f"p @ v as three bf16 terms of p), {2 * flops / 1e9:.3f} GFLOP, whose floor at 989 "
        f"TFLOP/s is {2 * flops / BF16_FLOPS * 1e3:.4f} ms; the float32 route's 2 products on "
        f"the CUDA cores at 67 TFLOP/s take {flops / FP32_FLOPS * 1e3:.4f} ms")
    return ms, plain_ms, lib_ms, bound_ms


def phase_serve(args):
    """llama3.2-1b at full width and depth, weights from --seed on the card:
    prefill of 4 prompts of 2048 tokens, then 64 greedy decode steps, with
    a dense and an SZx-planes cache (P = 1, 2).  Returns, per mode, what the
    checks after the path need."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = configs.get(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    model, t_init = timed(lambda: T.init_params(cfg, gen, "cuda"))
    nparams = sum(p.numel() for p in model.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model        # param_count() leaves the norms out
    check(nparams == cfg.param_count() + norms, f"{SERVE_ARCH}: {nparams} parameters")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                            generator=gen)
    log(f"serve {SERVE_ARCH}: {nparams} parameters (f32) made on the card in {t_init:.2f} s; "
        f"{SERVE_BATCH} prompts of {SERVE_PROMPT} tokens, {SERVE_STEPS} greedy steps")
    seq = SERVE_PROMPT + SERVE_STEPS
    _, t_first = timed(lambda: E.prefill(model, cfg, prompts, seq_len=seq))
    log(f"serve {SERVE_ARCH}: first prefill (allocator and cuBLAS warm-up) {t_first * 1e3:.1f} ms")
    runs = {}
    for mode, P in SERVE_MODES:
        cache, toks, dec, t_pre, t_dec = serve_and_check(model, cfg, prompts, mode, P,
                                                         SERVE_STEPS, TEACHER_STEPS)
        runs[(mode, P)] = (toks, dec)
        log(f"serve {SERVE_ARCH} kv={mode} P={P}: prefill {t_pre * 1e3:.1f} ms "
            f"({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} tok/s), decode {SERVE_STEPS} steps in "
            f"{t_dec:.3f} s = {SERVE_BATCH * SERVE_STEPS / t_dec:.1f} tok/s "
            f"({t_dec / SERVE_STEPS * 1e3:.2f} ms a step), cache {E.cache_nbytes(cache)} B "
            f"({E.cache_nbytes(cache) / 2**20:.1f} MiB), sample row "
            f"{toks[0, :8].tolist()}")
        del cache
    return model, cfg, prompts, runs


def cache_bytes(cfg, mode: str, P: int, batch: int, seq: int) -> int:
    """The cache slabs' bytes from their shapes: K/V (dense in the compute
    dtype, or mu, sexp and P planes a head_dim block), the SSM's float32
    state and conv tail in the compute dtype, and the encoder-decoder's
    cross K/V (dense in the compute dtype in both modes)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    per_layer, item = 0, T.compute_dtype(cfg).itemsize
    if T.has_attention(cfg):
        w, hd = E.cache_window(cfg, seq), cfg.resolved_head_dim
        per = hd * item if mode == "dense" else 4 + 1 + P * hd
        per_layer += 2 * batch * w * cfg.n_kv_heads * per
    if T.has_ssm(cfg):
        per_layer += batch * (4 * cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim
                              + item * (cfg.ssm_conv_width - 1) * L.ssm_conv_channels(cfg))
    if cfg.encoder_decoder:
        per_layer += 2 * batch * cfg.encoder_len * cfg.n_kv_heads * cfg.resolved_head_dim * item
    return cfg.n_layers * per_layer


def prefill_flash(cfg) -> int:
    """Flash launches of one prefill or forward: one per attention layer,
    and for the encoder-decoder each encoder layer's and each decoder
    layer's cross-attention besides."""
    from repro_torch.models import transformer as T

    if not T.has_attention(cfg):
        return 0
    return cfg.n_layers * (2 if cfg.encoder_decoder else 1) + cfg.n_encoder_layers


def serve_and_check(model, cfg, prompts, mode: str, P: int, steps: int, record: int,
                    extra=None):
    """Prefill (with ``extra``: the encoder-decoder's frames or the VLM's
    image embeddings, whose positions the cache holds too), then ``steps``
    greedy decode steps; checks the launch counts (the flash kernel as
    ``prefill_flash`` says a prefill and never in decode, the planes kernels
    once per K and V a prefill and per layer and chunk a step), the cache
    bytes and finite logits.  Returns (cache, generated tokens (B, steps),
    logits of the prefill and the first ``record`` steps (B, record + 1, V),
    prefill s, decode s)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E

    extra = extra or {}
    b, s = prompts.shape
    seq = s + steps + (cfg.prefix_embeds if "image_embeds" in extra else 0)
    nl = cfg.n_layers
    before = ops.launch_counts()
    (cache, logits), t_pre = timed(lambda: E.prefill(model, cfg, prompts, seq_len=seq,
                                                     kv_mode=mode, num_planes=P, **extra))
    after = ops.launch_counts()
    n = after["flash_attention"] - before["flash_attention"]
    check(n == prefill_flash(cfg), f"{cfg.name} {mode} P={P}: prefill launched flash {n} times")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name} {mode} P={P}: prefill logits not finite")
    if mode == "compressed":
        check(after["planes_encode"] - before["planes_encode"] == 2,
              f"{cfg.name} P={P}: prefill's K and V encodes")
    want = cache_bytes(cfg, mode, P, b, seq)
    check(E.cache_nbytes(cache) == want,
          f"{cfg.name} {mode} P={P}: cache {E.cache_nbytes(cache)} B != slab shapes {want} B")
    first = [logits[:, -1].float()]
    gen_tokens = []
    tok = torch.argmax(logits[:, -1:], -1)
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        gen_tokens.append(tok)
        logits, cache = E.decode_step(model, cfg, cache, tok, kv_mode=mode, num_planes=P)
        if step < record:
            first.append(logits[:, -1].float())
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    after = ops.launch_counts()
    check(after["flash_attention"] == before["flash_attention"],
          f"{cfg.name}: decode launched flash")
    if mode == "compressed":
        nchunks = -(-E.cache_window(cfg, seq) // E.DECODE_CHUNK)
        for k, n in (("planes_encode", 2 * nl * steps),
                     ("planes_decode", 2 * nl * nchunks * steps)):
            check(after[k] - before[k] == n,
                  f"{cfg.name} P={P}: {after[k] - before[k]} {k} launches in {steps} steps, "
                  f"not {n}")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name} {mode} P={P}: decode logits not finite")
    return cache, torch.cat(gen_tokens, dim=1), torch.stack(first, dim=1), t_pre, t_dec


def forward_logits(model, cfg, prompts, toks, extra=None):
    """``forward`` over the prompts and the first TEACHER_STEPS generated
    tokens (with ``extra``, the frames or image embeddings the prefill
    took): the logits (B, TEACHER_STEPS + 1, V) at the text positions the
    prefill and those steps predict from."""
    import torch
    from repro_torch.models import transformer as T

    extra = extra or {}
    h, _ = T.forward(model, cfg, torch.cat([prompts, toks[:, :TEACHER_STEPS]], dim=1), **extra)
    start = prompts.shape[1] - 1 + (cfg.prefix_embeds if "image_embeds" in extra else 0)
    return T.logits_for(model, cfg, h[:, start:]).float()


def teacher_rel(full, dec, vocab: int) -> list:
    """max |forward - decode| / max |forward| per position, over the real
    vocabulary (the padding columns hold -1e9)."""
    return [float((full[:, i, :vocab] - dec[:, i, :vocab]).abs().max()
                  / full[:, i, :vocab].abs().max()) for i in range(full.shape[1])]


def check_serve(model, cfg, prompts, runs) -> None:
    """Decode logits after teacher-forced steps against ``forward`` over the
    same tokens on the card (tests/test_models.py's criterion)."""
    dense_toks = runs[("dense", 1)][0]
    for (mode, P), (toks, dec) in runs.items():
        rel = teacher_rel(forward_logits(model, cfg, prompts, toks), dec, cfg.vocab_size)
        check(max(rel) < TEACHER_TOL[mode], f"{mode} P={P}: decode vs forward {rel}")
        agree = float((toks == dense_toks).float().mean())
        log(f"serve check kv={mode} P={P}: prefill and {TEACHER_STEPS} decode steps vs forward "
            f"over the same tokens, max |d| / max |logit| = "
            + ", ".join(f"{r:.5f}" for r in rel)
            + f" (tolerance {TEACHER_TOL[mode]}); greedy tokens equal to dense's: {agree:.3f}")


def profile_serve(model, cfg, prompts, modes=SERVE_MODES, extra=None) -> None:
    """torch.profiler over one prefill and the PROFILE_STEPS decode steps
    after it, per mode: device time by kernel and the device's busy share of
    the wall time (kernels run on one stream, so their times add up without
    overlap).  It traces the card's activity only: the host's op events
    would triple the time spent reading the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine as E

    extra = extra or {}
    seq = prompts.shape[1] + SERVE_STEPS + (cfg.prefix_embeds if "image_embeds" in extra else 0)

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, wall, [e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA]

    def decode(cache, tok, mode, P):
        for _ in range(PROFILE_STEPS):
            logits, cache = E.decode_step(model, cfg, cache, tok, kv_mode=mode, num_planes=P)
            tok = torch.argmax(logits, -1)
        return cache

    for mode, P in modes:
        (cache, logits), wall_pre, evs_pre = traced(
            lambda: E.prefill(model, cfg, prompts, seq_len=seq, kv_mode=mode, num_planes=P,
                              **extra))
        tok = torch.argmax(logits[:, -1:], -1)
        _, wall_dec, evs_dec = traced(lambda: decode(cache, tok, mode, P))
        for what, wall, evs in (("prefill", wall_pre, evs_pre),
                                (f"decode x{PROFILE_STEPS}", wall_dec, evs_dec)):
            busy = sum(e.self_device_time_total for e in evs) / 1e6
            evs.sort(key=lambda e: -e.self_device_time_total)
            top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
                            f"x{e.count}" for e in evs[:8])
            share = f"{100 * busy / wall:.1f}%" if busy else "not measured: no device events"
            log(f"profile {cfg.name} kv={mode} P={P} {what}: wall {wall * 1e3:.1f} ms, device busy "
                f"{busy * 1e3:.1f} ms ({share}); top: {top}")
        del cache, logits


# ---------------------------------------------------------------------------
# phase 10: the two-call encode (block_stats, pack) at a size users run
# ---------------------------------------------------------------------------

STATS_NAMES = ("mu", "radius", "const", "reqlen", "shift", "nbytes")
ENCODE_NAMES = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")


def same_stats(a, b, where: str) -> None:
    """block_stats outputs bit-identical; a NaN radius by position (the NaN
    bits of a subtraction are the card's in both)."""
    import torch

    for name, x, y in zip(STATS_NAMES, a, b):
        if name == "radius":
            check(torch.equal(x.isnan(), y.isnan()), f"{where}: radius NaN positions differ")
            x, y = x[~x.isnan()], y[~y.isnan()]
        check(same_bits(x, y), f"{where}: block_stats {name} differs")


def two_call_vs_plain(xb, e, spec, where: str, *, lo: int = 0) -> None:
    """ops.block_stats / ops.pack on (nb, bs) blocks against their plain
    versions and the fused encode kernel, and pack with shift = 0, all bit
    for bit.  ``lo`` only names the blocks in messages."""
    import torch
    from repro_torch.kernels import block_stats as bsk, encode as enc_mod, ops, pack as pk, specs

    p_e = specs.exact_exponent_of(e)
    k = ops.block_stats(xb, e, spec=spec)
    plain = bsk.block_stats_plain(xb, e, spec, p_e)
    same_stats(k, plain, f"{where} blocks {lo}+")
    MAX_ERR["block_stats"] = max(MAX_ERR["block_stats"],
                                 *(max_abs_diff(a.double(), b.double()) for a, b in zip(k, plain)))
    mu, _r, const, reqlen, shift, nbytes = k
    kp = ops.pack(xb, mu, shift, nbytes, spec=spec)
    for name, a, b in zip(("planes", "L", "mid"), kp, pk.pack_plain(xb, mu, shift, nbytes, spec)):
        check(same_bits(a, b), f"{where} blocks {lo}+: pack {name} differs")
        MAX_ERR["pack"] = max(MAX_ERR["pack"], max_abs_diff(a.double(), b.double()))
    fused = enc_mod.encode(xb, e, p_e, spec=spec)
    two = (mu, const, reqlen, shift, nbytes, kp[0], kp[1].to(torch.uint8))
    for name, a, b in zip(ENCODE_NAMES, fused, two):
        check(same_bits(a, b), f"{where} blocks {lo}+: two calls != fused encode ({name})")
    zero = torch.zeros_like(shift)
    for name, a, b in zip(("planes", "L", "mid"), ops.pack(xb, mu, zero, nbytes, spec=spec),
                          pk.pack_plain(xb, mu, zero, nbytes, spec)):
        check(same_bits(a, b), f"{where} blocks {lo}+: pack shift=0 {name} differs")


def phase_two_call(field, args):
    """The two-call encode on the 512^3 field at rel 1e-3, bs 128, as the
    paper's Fig. 6 analysis drives it (benchmarks/run.py:141-178): block
    statistics, pack with Solution C's shift, and pack with shift = 0 for
    Solution B's bit count.  Launch counters are zeroed just before this
    path and read just after it.  Returns the path's outputs for the
    checks and timings that follow."""
    import torch
    from repro_torch.core.codec import Bound, SZxCodec, plan
    from repro_torch.kernels import ops, specs

    p, xt = plan.make_plan(field, Bound.rel(1e-3), block_size=128, device="cuda")
    xb = plan.to_blocks(xt, p)
    e = p.error_bound
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = ops.block_stats(xb, e)
    mu, _radius, const, reqlen, shift, nbytes = stats
    planes, L, mid = ops.pack(xb, mu, shift, nbytes)
    _p0, L0, _m0 = ops.pack(xb, mu, torch.zeros_like(shift), nbytes)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if k in TWO_CALL_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the two-call path")
    nc = ~const
    bits_c = int(mid[nc].to(torch.int64).sum()) * 8
    bits_b = int((reqlen[nc][:, None].to(torch.int64) - 8 * L0[nc].to(torch.int64))
                 .clamp(min=0).sum())
    comp = len(SZxCodec().compress(field, e))
    check(0 <= bits_b <= bits_c, f"Solution B bits {bits_b} vs C bits {bits_c}")
    log(f"two-call encode f32 {args.edge}^3 rel 1e-3 (e={e:.6g}) nb={p.nblocks} bs=128: "
        f"block_stats + pack + pack(shift=0) {t_path * 1e3:.1f} ms host clock; launches "
        f"{launches}; constant blocks {int(const.sum())}; Fig. 6 shift overhead (Solution C "
        f"minus B bytes over the stream's {comp} B) {(bits_c - bits_b) / 8 / comp * 100:.3f}%")
    del planes, L, mid, L0, _p0, _m0
    # the same blocks against the plain versions and the fused encode kernel,
    # a 64 MiB frame of blocks at a time
    per = FRAME_BYTES // (4 * 128)
    for lo in range(0, p.nblocks, per):
        two_call_vs_plain(xb[lo:lo + per], e, specs.F32, f"f32 {args.edge}^3", lo=lo)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    for spec in specs.SPECS[1:]:
        n = FRAME_BYTES // spec.itemsize
        x = walk(n, spec.dtype, gen, scale=0.001).reshape(-1, 128)
        two_call_vs_plain(x, float(plan.resolve_error_bound(x, Bound.rel(1e-3))), spec,
                          f"{spec.name} 64 MiB")
    for spec in specs.SPECS:
        e = 1e-3 if spec.itemsize >= 4 else 1e-2
        for nb, bs in ((4096, 1), (3001, 3), (64, 4096)):
            two_call_vs_plain(walk(nb * bs, spec.dtype, gen).reshape(nb, bs), e, spec,
                              f"{spec.name} bs={bs}")
        odd = walk(200 * 128, spec.dtype, gen).reshape(200, 128)    # NaN, inf, zeros
        odd[3, ::7] = float("nan")
        odd[5, 11] = float("inf")
        odd[6, :] = -float("inf")
        odd[9, :] = 0.0
        odd[10, ::3] = -0.0
        odd[11, :] = -0.0
        two_call_vs_plain(odd, e, spec, f"{spec.name} NaN/inf/zeros")
        two_call_vs_plain(walk(200 * 128, spec.dtype, gen, scale=1.0).reshape(200, 128),
                          float(torch.finfo(spec.dtype).tiny), spec, f"{spec.name} verbatim")
        two_call_vs_plain(torch.full((50, 128), 2.5, dtype=spec.dtype, device="cuda"), 1e-3,
                          spec, f"{spec.name} constant")
        two_call_vs_plain(torch.zeros((0, 128), dtype=spec.dtype, device="cuda"), 1e-3, spec,
                          f"{spec.name} nb=0")
    # the 16-bit next-up radius guard: e exactly at the f32-rounded radius
    g16 = torch.tensor([[-1.751e-03, 2554.0]], dtype=torch.float16, device="cuda")
    mn, mx = (float(v) for v in g16[0].double())
    mu16 = float(torch.tensor(0.5 * (mn + mx), dtype=torch.float32).to(torch.float16))
    e16 = float(max(torch.tensor(mx, dtype=torch.float32) - mu16,
                    mu16 - torch.tensor(mn, dtype=torch.float32)))
    two_call_vs_plain(g16, e16, specs.F16, "f16 rounding guard")
    check(not bool(ops.block_stats(g16, e16, spec=specs.F16)[2][0]), "f16 guard: block constant")
    torch.cuda.synchronize()
    log("two-call kernels vs plain: block_stats, pack and pack(shift=0) bit-identical to their "
        "plain versions, and (mu, const, reqlen, shift, nbytes, planes, L) to the fused encode "
        f"kernel, on the {args.edge}^3 field, 64 MiB f64/f16/bf16 fields, bs 1/3/4096, NaN/inf/"
        "signed-zero, verbatim, constant and empty inputs, and the f16 guard")
    return xb, e, stats, launches


def time_two_call(xb, e, stats, reps: int):
    """block_stats and pack (CUDA events) and their plain versions on the
    512^3 field's blocks, beside the bound from the bytes each moves (every
    input read once, every output written once) at 3.35 TB/s."""
    from repro_torch.kernels import block_stats as bsk, ops, pack as pk, specs

    p_e = specs.exact_exponent_of(e)
    mu, _r, _c, _rq, shift, nbytes = stats
    nb, bs = xb.shape
    outs = ops.block_stats(xb, e)
    st_bytes = xb.numel() * 4 + sum(t.numel() * t.element_size() for t in outs)
    pk_outs = ops.pack(xb, mu, shift, nbytes)
    pk_bytes = (xb.numel() * 4 + sum(t.numel() * t.element_size() for t in (mu, shift, nbytes))
                + sum(t.numel() * t.element_size() for t in pk_outs))
    del outs, pk_outs
    rows = []
    for name, fn, plain, nbytes_moved in (
            ("block_stats", lambda: ops.block_stats(xb, e),
             lambda: bsk.block_stats_plain(xb, e, specs.F32, p_e), st_bytes),
            ("pack", lambda: ops.pack(xb, mu, shift, nbytes),
             lambda: pk.pack_plain(xb, mu, shift, nbytes, specs.F32), pk_bytes)):
        ms = cuda_ms(fn, reps)
        pms = cuda_ms(plain, 3)
        bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        rows.append((name, ms, pms, bound_ms))
        log(f"time {name} f32 nb={nb} bs={bs}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes_moved / 1e6:.3f} MB at 3.35 TB/s, "
            f"{bound_ms / ms * 100:.1f}% of the bound)")
    return rows


# ---------------------------------------------------------------------------
# phase 11: training llama3.2-1b at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"         # src/repro/configs/llama3p2_1b.py, full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
TRAIN_MODES = (0, 1, 2)            # plain, then compressed at P = 1 and P = 2
TRAIN_LR = 1e-4
CKPT_DIR = ROOT / "_smoke_ckpt"    # checkpoints of the restart run; removed after it
CKPT_STEPS, CKPT_EVERY, CKPT_FAULT = 6, 3, 5   # the fault hits step 5 once: step 4 is replayed


def train_batch(ds, step: int):
    import torch

    return {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch_at(step).items()}


def phase_train(args):
    """Plain and compressed (P = 1, 2) training steps of llama3.2-1b at full
    width and depth on B 4 x S 2048 SyntheticLM tokens, float32 weights and
    AdamW state from --seed on the card, compressed modes in a one-rank NCCL
    group.  Then one Trainer run (compressed P = 1, SZx checkpoints) with a
    fault after its first checkpoint: the restart restores on the card and
    replays the lost step.  Returns per-mode step times for the summary."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    from repro_torch.train import step as step_mod

    cfg = configs.get(TRAIN_ARCH)
    check(cfg.remat, f"{TRAIN_ARCH} trains with per-layer remat")
    opt = AdamW(lr=TRAIN_LR)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    results = {}
    try:
        for P in TRAIN_MODES:
            mode = "plain" if not P else f"compressed P={P}"
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)
            state, t_init = timed(lambda: step_mod.init_state(cfg, opt, gen, ef_planes=P,
                                                              device="cuda"))
            nbytes = sum(t.numel() * t.element_size() for t in pytree.leaves(state))
            wq0 = state["params"]["layers"][0]["attn"]["wq"][:64, :64].clone()
            fn = step_mod.make_train_step(cfg, opt, compress_planes=P)
            torch.cuda.reset_peak_memory_stats()
            routes_before = ops.planes_route_counts()
            state, m, t_warm, losses, times, before, after = warm_and_time(fn, state, ds)
            peak = torch.cuda.max_memory_allocated()
            check(all(math.isfinite(v) for v in losses), f"{mode}: losses {losses}")
            moved = float((state["params"]["layers"][0]["attn"]["wq"][:64, :64] - wq0).abs().max())
            check(moved > 0, f"{mode}: AdamW did not move the parameters")
            flash = after["flash_attention"] - before["flash_attention"]
            check(flash == 2 * cfg.n_layers * TRAIN_STEPS,
                  f"{mode}: {flash} flash launches in {TRAIN_STEPS} steps (forward + remat)")
            if P:
                for k in PLANES_KERNELS:
                    check(after[k] > before[k], f"{mode}: {k} not launched")
                check_vector_route(f"train {mode}", {
                    k: v - routes_before[k] for k, v in ops.planes_route_counts().items()})
            results[P] = times
            log(f"train {TRAIN_ARCH} {mode}: state {nbytes / 1e9:.2f} GB made in {t_init:.2f} s; "
                f"first step {t_warm * 1e3:.1f} ms; steps "
                + ", ".join(f"{t * 1e3:.1f}" for t in times)
                + f" ms ({tokens / (sum(times) / len(times)):.0f} tokens/s); loss curve "
                + ", ".join(f"{v:.4f}" for v in losses)
                + f"; max |d wq| after {TRAIN_STEPS + 1} steps {moved:.3e}; peak device memory "
                f"{peak / 2**30:.2f} GiB; launches {dict((k, after[k] - before[k]) for k in after if after[k] != before[k])}")
            if P == 1:
                profile_train(fn, state, train_batch(ds, TRAIN_STEPS + 1), mode)
            del state, m, wq0
            torch.cuda.empty_cache()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        try:
            restart_run(args, cfg, opt, ds)
        finally:
            shutil.rmtree(CKPT_DIR, ignore_errors=True)
    finally:
        dist.destroy_process_group()
    return results


def warm_and_time(fn, state, ds):
    """A warm-up step on batch 0, then TRAIN_STEPS timed steps (host clock,
    synchronized) on the next batches.  Returns (state, the last metrics,
    the warm-up's seconds, every loss, the timed steps' seconds, and the
    launch counts before and after the timed steps)."""
    from repro_torch.kernels import ops

    (state, m), t_warm = timed(lambda: fn(state, train_batch(ds, 0)))
    losses, times = [float(m["loss"])], []
    before = ops.launch_counts()
    for s in range(1, TRAIN_STEPS + 1):
        batch = train_batch(ds, s)
        (state, m), t = timed(lambda: fn(state, batch))
        times.append(t)
        losses.append(float(m["loss"]))
    return state, m, t_warm, losses, times, before, ops.launch_counts()


def profile_train(fn, state, batch, mode: str) -> float | None:
    """torch.profiler over one training step: device busy share of its wall
    time (returned; None without device events) and the top kernels by
    device time (card activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    evs.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                    for e in evs[:10])
    share = f"{100 * busy / wall:.1f}%" if busy else "not measured: no device events"
    log(f"profile train {mode} step: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
        f"({share}); top: {top}")
    return busy / wall if busy else None


def restart_run(args, cfg, opt, ds) -> None:
    """A Trainer run of CKPT_STEPS compressed (P = 1) steps with SZx
    checkpoints every CKPT_EVERY steps and a fault once at step CKPT_FAULT:
    the restart restores the latest checkpoint on the card (the decode
    kernel) and replays the steps after it.  Every restored leaf is held to
    the leaf saved at that step (float leaves within the checkpoint's bound,
    the rest bit for bit); save and restore times, bytes and CR logged."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.core.codec import plan
    from repro_torch.kernels import ops
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig

    saved, events = {}, []

    class Checked(CheckpointManager):
        def save(self, step, tree):
            # the saved state on the host, to hold the restore to it
            saved.clear()
            saved.update({n: t.to("cpu", copy=True) for n, t in pytree.leaf_paths(tree)})
            before = ops.launch_counts()["encode"]
            out, t = timed(lambda: super(Checked, self).save(step, tree))
            st = self.stats(step)
            events.append(f"save step {step}: {t:.2f} s, {st['raw_bytes']} B -> "
                          f"{st['stored_bytes']} B (CR {st['ratio']:.4f}), "
                          f"{ops.launch_counts()['encode'] - before} encode launches")
            return out

        def restore(self, template, step=None):
            before = ops.launch_counts()["decode_body"]
            (tree, got), t = timed(lambda: super(Checked, self).restore(template, step))
            launched = ops.launch_counts()["decode_body"] - before
            check(launched > 0, "restore did not launch the decode kernel")
            worst = 0.0
            for name, leaf in pytree.leaf_paths(tree):
                want = saved[name].to(leaf.device)
                check(leaf.dtype == want.dtype and leaf.shape == want.shape, f"restored {name}")
                if leaf.is_floating_point() and leaf.numel() >= 1024:
                    e = plan.resolve_error_bound(want, self.bound)
                    err = max_abs_diff(leaf, want)
                    check(err <= e, f"restored {name}: max error {err} > e={e}")
                    worst = max(worst, err / e if e else 0.0)
                else:
                    check(same_bits(leaf, want), f"restored {name} not bit-identical")
                del want
            events.append(f"restore step {got}: {t:.2f} s, {launched} decode launches, every "
                          f"leaf within the bound (max error/bound {worst:.4f})")
            return tree, got

    faults = []

    def fault(step):
        if step == CKPT_FAULT and not faults:
            faults.append(step)
            raise RuntimeError("injected fault after the first checkpoint")

    ckpt = Checked(str(CKPT_DIR), keep=2, compress=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 9)
    state = step_mod.init_state(cfg, opt, gen, ef_planes=1, device="cuda")
    fn = step_mod.make_train_step(cfg, opt, compress_planes=1)
    tr = Trainer(TrainerConfig(total_steps=CKPT_STEPS, checkpoint_every=CKPT_EVERY),
                 fn, lambda s: train_batch(ds, s), ckpt, fault_hook=fault)
    _, t_run = timed(lambda: tr.run(state))
    steps = [h["step"] for h in tr.history]
    check(tr.restarts == 1, f"restarts {tr.restarts}")
    check(steps == [0, 1, 2, 3, 4, 4, 5], f"trainer steps {steps}")
    check(ckpt.latest_step() == CKPT_STEPS - 1, "final checkpoint")
    replay = [h["loss"] for h in tr.history if h["step"] == CKPT_FAULT - 1]
    for ev in events:
        log(f"train restart run: {ev}")
    leaf_view_check(ckpt)
    log(f"train restart run {TRAIN_ARCH} (compressed P=1, SZx checkpoints at rel 1e-6, "
        f"fault at step {CKPT_FAULT}): {t_run:.1f} s, restarts {tr.restarts}, steps {steps}, "
        f"losses " + ", ".join(f"{h['loss']:.4f}" for h in tr.history)
        + f"; step {CKPT_FAULT - 1} before and after the restart {replay[0]:.6f} / {replay[1]:.6f}")
    saved.clear()


LEAF = "params/embed"               # (128256, 2048) f32, the largest leaf of the state


def leaf_view_check(ckpt) -> None:
    """The embedding leaf of the last checkpoint as a store view
    (``leaf_store``): three row ranges, by both decode routes, bit for bit
    the restored leaf."""
    from repro_torch.kernels import ops

    restored, t_restore = timed(lambda: ckpt.restore_leaves([LEAF])[LEAF])
    nrows, width = restored.shape
    ranges = ((0, 4), (nrows // 2 - 8, nrows // 2 + 8), (nrows - 6, nrows))
    before = ops.launch_counts()
    times = []
    for fused in (False, True):
        with ckpt.leaf_store(LEAF, fused_range=fused) as lv:
            check(lv.shape == (nrows * width,) and lv.attrs["leaf_shape"] == [nrows, width],
                  f"leaf_store {LEAF}: shape {lv.shape}, attrs {lv.attrs}")
            for lo, hi in ranges:
                got, t = timed(lambda: lv[lo * width:hi * width])
                check(same_bits(got, restored[lo:hi].reshape(-1)),
                      f"leaf_store {LEAF} rows {lo}:{hi} fused={fused}: differ from the restore")
                times.append(f"{'fused' if fused else 'host parse'} rows {lo}:{hi} "
                             f"{t * 1e3:.2f} ms")
            nchunks = lv.nchunks
    after = ops.launch_counts()
    log(f"leaf_store {LEAF} {tuple(restored.shape)} of step {ckpt.latest_step()} ({nchunks} "
        f"frames; restore_leaves {t_restore:.2f} s): rows {ranges} bit-identical to the "
        f"restored leaf by both routes; " + ", ".join(times) + "; launches "
        + str({k: after[k] - before[k] for k in after if after[k] != before[k]}))


# ---------------------------------------------------------------------------
# phase 12: training ingest from a compressed store, with telemetry
# ---------------------------------------------------------------------------

DATA_DIR = ROOT / "_smoke_data"    # phase 12's store files and traces; removed after it
INGEST_SHAPE = (32768, 4096)       # the codec cell's 512^3 field as rows of 4096
INGEST_CHUNK = (32, 4096)          # benchmarks/run.py:532-538, the ingest row's grid
INGEST_WINDOW, INGEST_BATCH, INGEST_STEPS = (16, 4096), 8, 20   # ~8 % of the store an epoch
INGEST_SEED = 5                    # benchmarks/run.py's loader seed
INGEST_WORKERS = (0, 2, 4)
STORE_TRAIN_STEPS = 4              # the launcher's run: a warm-up and 3 timed steps


class CountingFile:
    """A binary file that counts the bytes read through it."""

    def __init__(self, f):
        self.f = f
        self.n = 0

    def read(self, k=-1):
        b = self.f.read(k)
        self.n += len(b)
        return b

    def seek(self, *a):
        return self.f.seek(*a)

    def tell(self):
        return self.f.tell()

    def close(self):
        self.f.close()


def ingest_epochs(path: Path, fused: bool) -> tuple[list, dict]:
    """The serial epoch through a counting file (twice: the first also warms
    up), then a pipelined epoch with each worker count, every batch held bit
    for bit to the serial one.  Returns (serial batches, {label: samples/s,
    the serial one as (samples/s, the first epoch's)})."""
    import torch
    from repro_torch.data import StoreLoader
    from repro_torch.store import ArrayStore

    samples = INGEST_BATCH * INGEST_STEPS
    rates = {}
    for rep in range(2):                        # the first epoch also warms up
        counting = CountingFile(open(path, "rb"))
        with ArrayStore.open(counting, fused_range=fused) as ca:
            ld = StoreLoader(ca, INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED, workers=0)
            serial, t = timed(lambda: [ld.batch_at(s).clone() for s in range(INGEST_STEPS)])
        counting.close()
        ratio = counting.n / path.stat().st_size
        rates["serial"] = (samples / t, rates.get("serial", (samples / t,))[0])
    check(ratio < 0.2, f"ingest fused={fused}: bytes read ratio {ratio:.4f} >= 0.2")
    for w in INGEST_WORKERS:
        with StoreLoader(path, INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED, workers=w,
                         lookahead=2, fused_range=fused) as ld:
            got, t = timed(lambda: [b.clone() for b in ld.batches(steps=INGEST_STEPS)])
        rates[f"workers={w}"] = samples / t
        check(len(got) == INGEST_STEPS and all(same_bits(g, r) for g, r in zip(got, serial)),
              f"ingest fused={fused} workers={w}: pipelined batches differ from batch_at")
    rates["bytes_read_ratio"] = ratio
    return serial, rates


def phase_ingest(args) -> dict:
    """Phase 12, part 1: the codec cell's field as (32768, 4096) rows in
    chunks of (32, 4096), saved on the card; a shuffled epoch of (16, 4096)
    windows, batch 8, 20 steps (~8 % of the store) by both read routes.
    Returns the launches of the epochs."""
    import torch
    from repro_torch.core.codec import Bound, plan
    from repro_torch.data import WindowSampler
    from repro_torch.kernels import ops
    from repro_torch.store import ArrayStore

    field = make_field(args.edge, args.seed).reshape(INGEST_SHAPE)
    path = DATA_DIR / "ingest.szs"
    _, t_save = timed(lambda: ArrayStore.save(path, field, Bound.rel(1e-3),
                                              chunk_shape=INGEST_CHUNK))
    raw = field.numel() * 4
    log(f"ingest store {tuple(field.shape)} f32 chunks {INGEST_CHUNK}: {path.stat().st_size} B "
        f"(CR {raw / path.stat().st_size:.4f}), saved in {t_save:.3f} s")
    e = plan.resolve_error_bound(field, Bound.rel(1e-3))
    launches = {}
    for fused in (False, True):
        route = "fused decode_range" if fused else "host parse + unpack"
        ops.reset_launch_counts()
        batches, rates = ingest_epochs(path, fused)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        log(f"ingest route={route}: window {INGEST_WINDOW} batch {INGEST_BATCH} x "
            f"{INGEST_STEPS} steps (e={e:.6g}), bytes read ratio {rates.pop('bytes_read_ratio'):.6f} "
            f"(< 0.2); samples/s serial {rates['serial'][0]:.1f} (first epoch "
            f"{rates.pop('serial')[1]:.1f}), pipelined "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
            + f"; pipelined == batch_at bit for bit; launches {counts}")
        if fused:
            check(counts.get("decode_body", 0) > 0, "ingest fused: decode_body not launched")
            check(all(same_bits(a, b) for a, b in zip(batches, host_batches)),
                  "ingest: the fused route's batches differ from the host parse's")
        else:
            host_batches = batches
            origins = WindowSampler(INGEST_SHAPE, INGEST_WINDOW, INGEST_BATCH,
                                    seed=INGEST_SEED).origins_at(0)
            for wi, (r, c) in enumerate(origins.tolist()):
                err = max_abs_diff(batches[0][wi], field[r:r + INGEST_WINDOW[0],
                                                         c:c + INGEST_WINDOW[1]])
                check(err <= e, f"ingest: window {wi} of step 0 off the field by {err} > e={e}")
            check(counts.get("unpack", 0) > 0, "ingest host parse: unpack not launched")
            by_route = ops.store_route_counts()
            log(f"ingest host parse launches by route: {by_route}")
            check(by_route["unpack_vector"] > 0, "ingest: unpack not on its vector route")
            check(not any(v for k, v in by_route.items() if k.endswith("_scalar")),
                  f"ingest: launches off the vector route {by_route}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    del field, batches, host_batches
    torch.cuda.empty_cache()
    ingest_breakdown(path)
    return launches


def ingest_breakdown(path: Path, reps: int = 5) -> None:
    """Where a batch's time goes: step 0's range reads by stage (host clock,
    synchronized around each stage; median of reps), then one pipelined
    epoch (2 workers) with telemetry on, read from its spans."""
    import statistics

    import torch
    from repro_torch import obs
    from repro_torch.core.codec import container, transform
    from repro_torch.data import StoreLoader
    from repro_torch.data.store_loader import _assemble, plan_batch
    from repro_torch.store import ArrayStore

    ca = ArrayStore.open(path)
    ld = StoreLoader(ca, INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED, workers=0)
    tasks, placements = plan_batch(ca._grid, ca._block_size, ld.sampler.origins_at(0),
                                   INGEST_WINDOW)
    times: dict[str, list[float]] = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name][-1] += (time.perf_counter() - t0) * 1e3
        return res

    f = ca._files[0]
    for _ in range(reps):
        for name in ("plan", "file reads", "parse prefix", "extract range", "decode kernel",
                     "assemble", "total batch_at"):
            times.setdefault(name, []).append(0.0)
        stage("plan", lambda: plan_batch(ca._grid, ca._block_size, ld.sampler.origins_at(0),
                                         INGEST_WINDOW))
        segs = {}
        for cid, (lo_b, hi_b) in tasks.items():
            off, length, elements = (int(v) for v in ca._frames[cid])

            def reads():
                _flags, _plen, sheader = container.read_frame_stream_header_at(f, off, cid)
                prefix_len = container.stream_prefix_length(sheader)
                prefix = sheader + container._read_exact(f, prefix_len - container.HEADER.size)
                return prefix, prefix_len

            prefix, prefix_len = stage("file reads", reads)
            sec = stage("parse prefix", lambda: container.parse_stream_sections(
                prefix, device="cuda"))
            hi = min(hi_b, sec.plan.nblocks)
            mlo, mhi = sec.mid_range(lo_b, hi)

            def mid_read():
                f.seek(off + container.FRAME_HEADER.size + prefix_len + mlo)
                return container._read_exact(f, mhi - mlo)

            mid = stage("file reads", mid_read)
            enc = stage("extract range", lambda: container.extract_block_range(
                sec, mid, lo_b, hi))
            flat = stage("decode kernel", lambda: transform.decode_blocks(
                enc, sec.plan).reshape(-1))
            bs = ca._block_size
            segs[cid] = (flat[: min(hi * bs, elements) - lo_b * bs], lo_b)
        out = ld._empty()
        stage("assemble", lambda: _assemble(out, placements, segs, ca._grid, ca._block_size))
        got = stage("total batch_at", lambda: ld.batch_at(0))
        check(same_bits(got, out), "ingest breakdown: the staged batch differs from batch_at")
    med = {k: statistics.median(v) for k, v in times.items()}
    total = med.pop("total batch_at")
    log(f"ingest breakdown of one batch ({len(tasks)} range reads, {len(placements)} window "
        f"pieces; median of {reps}, host clock, synchronized): batch_at {total:.3f} ms; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
    ca.close()
    obs.reset()
    obs.enable()
    try:
        with StoreLoader(path, INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED, workers=2) as ld:
            _, t = timed(lambda: [b.clone() for b in ld.batches(steps=INGEST_STEPS)])
        agg = obs.REGISTRY.span_aggregates()
        snap = obs.REGISTRY.snapshot()["metrics"]
    finally:
        obs.disable()
        obs.reset()
    hist = {k: v["series"][""] for k, v in snap.items() if v["kind"] == "histogram"}
    log(f"ingest epoch with telemetry on (2 workers): {INGEST_BATCH * INGEST_STEPS / t:.1f} "
        f"samples/s; spans " + ", ".join(f"{k} {c} x {tot / c / 1e6:.3f} ms"
                                         for k, (c, tot) in sorted(agg.items()))
        + "; " + ", ".join(f"{k} {h['count']} x {h['sum'] / max(h['count'], 1) * 1e3:.3f} ms"
                           for k, h in sorted(hist.items())))


def phase_store_train(args) -> tuple[dict, list, float | None]:
    """Phase 12, part 2: llama3.2-1b at full width and depth, B 4 x S 2048
    tokens from phase 5's stage-off 512^3 store (made again).  First the
    model timed step by step on the store's batches (batch draw + step,
    synchronized) and one profiled step; then ``launch.train.main`` with 2
    ingest workers and ``--profile-dir``: finite losses, weights that move,
    the flash kernel twice a layer a step, a valid trace.json (train.step,
    ingest.batch, store.read spans), metrics.prom and the profiler's trace;
    SteppedBatches seeking back gives the same tokens.  Returns (the
    launcher run's launches, store-fed step seconds, device busy share)."""
    import shutil

    import torch
    from repro_torch import configs, obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.codec import Bound
    from repro_torch.data import DataConfig, SteppedBatches, StoreLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.store import ArrayStore
    from repro_torch.train import step as step_mod

    cfg = configs.get(TRAIN_ARCH)
    store = DATA_DIR / "store_off.szs"
    x = store_field(make_field(args.edge, args.seed), args.seed)
    ArrayStore.save(store, x, Bound.rel(1e-3))
    del x
    torch.cuda.empty_cache()

    lm = StoreLM(str(store), DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    with SteppedBatches(lambda s: lm.batches(start_step=s)) as fn:
        fn(0)
        one = fn(1)["tokens"].clone()
        fn(2)
        check(torch.equal(fn(1)["tokens"], one) and torch.equal(one, lm.batch_at(1)["tokens"]),
              "SteppedBatches: seeking back to step 1 gave other tokens")
    opt = AdamW(lr=TRAIN_LR)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)
    state = step_mod.init_state(cfg, opt, gen, device="cuda")
    step = step_mod.make_train_step(cfg, opt)
    times, draws = [], []
    with SteppedBatches(lambda s: lm.batches(start_step=s)) as fn:
        state, _ = step(state, fn(0))
        for s in range(1, TRAIN_STEPS + 1):
            batch, t_draw = timed(lambda: fn(s))
            (state, m), t = timed(lambda: step(state, batch))
            draws.append(t_draw)
            times.append(t_draw + t)
        busy = profile_train(step, state, fn(TRAIN_STEPS + 1), "store-fed plain")
    lm.close()
    log(f"store-fed train step {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ} plain (batch draw + "
        f"step, host clock, synchronized): " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + " ms; of which the batch draw " + ", ".join(f"{t * 1e3:.2f}" for t in draws) + " ms")
    del state, m, batch
    torch.cuda.empty_cache()

    prof_dir = DATA_DIR / "profile"
    ops.reset_launch_counts()
    try:
        tr, t_run = timed(lambda: train.main([
            "--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
            "--steps", str(STORE_TRAIN_STEPS), "--data-store", str(store), "--data-workers", "2",
            "--profile-dir", str(prof_dir), "--ckpt", str(CKPT_DIR), "--seed", str(args.seed)]))
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        losses = [h["loss"] for h in tr.history]
        check(len(losses) == STORE_TRAIN_STEPS and all(math.isfinite(v) for v in losses),
              f"store-fed training: losses {losses}")
        check(launches.get("flash_attention", 0) == 2 * cfg.n_layers * STORE_TRAIN_STEPS,
              f"store-fed training: {launches.get('flash_attention')} flash launches in "
              f"{STORE_TRAIN_STEPS} steps")
        final_ln = CheckpointManager(str(CKPT_DIR), device="cuda").restore_leaves(
            ["params/final_ln"])["params/final_ln"]
        moved = float((final_ln - 1.0).abs().max())
        check(moved > 0, "store-fed training: the weights did not move")
    finally:
        obs.disable()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    trace = json.loads((prof_dir / "trace.json").read_text())
    spans = {}
    for ev in trace["traceEvents"]:
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    for name in ("train.step", "ingest.batch", "store.read"):
        check(name in spans, f"trace.json holds no {name} span")
    prom = (prof_dir / "metrics.prom").read_text().splitlines()
    line = re.compile(r'^(# TYPE szx_[a-z0-9_]+ (counter|gauge|histogram)|'
                      r'szx_[a-z0-9_]+(\{[^}]*\})? [-+0-9.eInf]+)$')
    bad = [ln for ln in prom if not line.match(ln)]
    check(prom and not bad, f"metrics.prom: invalid lines {bad[:3]}")
    drawn = [int(ln.split()[-1]) for ln in prom if ln.startswith("szx_ingest_batches{")]
    check(sum(drawn) >= STORE_TRAIN_STEPS, f"metrics.prom: ingest.batches {drawn}")
    torch_trace = json.loads((prof_dir / "torch_trace.json").read_text())
    kernels = sum(1 for ev in torch_trace["traceEvents"] if ev.get("cat") == "kernel")
    log(f"store-fed training (launch.train.main, --profile-dir; host clock): {t_run:.1f} s in "
        f"all; steps " + ", ".join(f"{h['dt'] * 1e3:.1f}" for h in tr.history)
        + " ms (the first a warm-up; telemetry and torch.profiler on); losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; max |final_ln - 1| {moved:.3e}; launches {launches}; spans (count, mean ms): "
        + ", ".join(f"{k} {len(v)} {sum(v) / len(v):.3f}" for k, v in sorted(spans.items()))
        + f"; metrics.prom {len(prom)} lines; torch_trace.json "
          f"{(prof_dir / 'torch_trace.json').stat().st_size} B, {kernels} kernel events")
    shutil.rmtree(prof_dir, ignore_errors=True)
    return launches, times, busy


# ---------------------------------------------------------------------------
# phase 13: the HTTP store service on the card
# ---------------------------------------------------------------------------

SERVICE_THREADS = 16               # client threads, each request an independent urlopen
SERVICE_SHARDS = 4
SERVICE_INGEST_WORKERS = (0, 2, 4)  # 0: the serial batch_at epoch
CACHE_COUNTERS = ("hits", "misses", "evictions")


def service_rois(edge: int) -> dict:
    """Phase 5's ROIs as the service's text, plus a slab of edge/8 planes
    (at 512: (64, 512, 512), 64 MiB)."""
    z, c = edge // 5, min(64, edge // 4)
    return {"z-slab": f"{z}:{z + 4}",
            "cube": f"{z - 3}:{z - 3 + c},{edge // 3}:{edge // 3 + c},{edge // 2}:{edge // 2 + c}",
            "element": f"{edge // 2},{3 * edge // 5},5", "zeroed row": f"5,:{edge // 16}",
            "slab": f"{edge // 2}:{edge // 2 + edge // 8}"}


def host_bytes(t) -> bytes:
    """A tensor's bytes in C order, as a /read body carries them."""
    import torch
    from repro_torch.core.codec.device import to_host

    return to_host(t.contiguous()).reshape(-1).view(torch.uint8).numpy().tobytes()


_OPENERS: dict = {}


def opener(follow: bool = True):
    """One shared urllib opener that uses no proxy (only 127.0.0.1 is ever
    asked) and, with ``follow=False``, returns a 3xx instead of following
    it.  Built once: an opener's HTTPS handler loads the CA store."""
    import urllib.request

    if follow not in _OPENERS:
        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **kw):
                return None

        handlers = [urllib.request.ProxyHandler({})] + ([] if follow else [NoRedirect])
        _OPENERS[follow] = urllib.request.build_opener(*handlers)
    return _OPENERS[follow]


def http_get(url: str, headers: dict | None = None, follow: bool = True):
    """(status, headers, body) of one GET, whatever the status."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    try:
        with opener(follow).open(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


class Served:
    """An HttpServer on 127.0.0.1, an OS-chosen port, in a thread."""

    def __init__(self, service):
        import threading
        from repro_torch.serve.service import HttpServer

        self.service = service
        self.srv = HttpServer(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(30)


def roi_traffic(served: Served, name: str, rois: dict, want: dict) -> dict:
    """One pass: SERVICE_THREADS client threads, each reading every ROI once
    (in its own rotation), every body held bit for bit to ``want``."""
    import urllib.parse
    from concurrent.futures import ThreadPoolExecutor

    items = list(rois.items())

    def client(i: int):
        n = nbytes = 0
        for rname, text in items[i % len(items):] + items[: i % len(items)]:
            status, _h, body = http_get(
                f"{served.base}/v1/stores/{name}/read?roi={urllib.parse.quote(text)}")
            check(status == 200 and body == want[rname],
                  f"service {name} {rname}: status {status}, body differs from ca[roi]")
            n += 1
            nbytes += len(body)
        return n, nbytes

    before = served.service.cache.stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVICE_THREADS) as pool:
        done = list(pool.map(client, range(SERVICE_THREADS)))
    wall = time.perf_counter() - t0
    after = served.service.cache.stats()
    n, nbytes = sum(d[0] for d in done), sum(d[1] for d in done)
    return {"requests": n, "bytes": nbytes, "s": wall, "req_s": n / wall,
            "MB_s": nbytes / wall / 1e6,
            **{k: after[k] - before[k] for k in CACHE_COUNTERS}}


def service_breakdown(served: Served, name: str, rois: dict, *, cold: bool = False,
                      reps: int = 5) -> None:
    """Where one request's time goes, one request at a time (median of
    reps, host clock): the request core in process (``handle``: the ROI
    assembled on the card from the cache -- emptied before each request if
    ``cold``, so the ranges decode first --, its copy to the host, the
    body's bytes) against the same request over the socket."""
    import statistics
    import urllib.parse

    parts = []
    for rname, text in rois.items():
        target = f"/v1/stores/{name}/read?roi={urllib.parse.quote(text)}"
        core, wire = [], []
        for _ in range(reps):
            if cold:
                served.service.cache.clear()
            t0 = time.perf_counter()
            resp = served.service.handle("GET", target, {})
            core.append(time.perf_counter() - t0)
            if cold:
                served.service.cache.clear()
            t0 = time.perf_counter()
            status, _h, body = http_get(served.base + target)
            wire.append(time.perf_counter() - t0)
            check(resp.status == status == 200 and resp.body == body,
                  f"service breakdown {rname}: handle and the socket differ")
        parts.append(f"{rname} ({len(body)} B) handle {statistics.median(core) * 1e3:.3f} ms, "
                     f"over the socket {statistics.median(wire) * 1e3:.3f} ms")
    log(f"service {'cold' if cold else 'hot'} request breakdown, {name}, one at a time "
        f"(median of {reps}, host clock): " + "; ".join(parts))


def route_latencies(served: Served) -> str:
    status, _h, body = http_get(served.base + "/v1/metrics")
    check(status == 200, "/v1/metrics")
    lat = json.loads(body)["latency"]
    return "; ".join(f"{route} n={v['count']} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
                     for route, v in sorted(lat.items()))


def service_protocol(served: Served, paths: dict, cas: dict, stats: dict) -> None:
    """If-None-Match/304, Range/206/416, chunk bytes, the URL shard's 307,
    stats of both tiers, the Prometheus text with telemetry on."""
    from repro_torch import obs

    base = served.base + "/v1/stores"
    status, h, _ = http_get(f"{base}/off/info")
    etag = h["ETag"]
    for route in ("info", "read?roi=5,7,9", "chunk/0"):
        status, h, body = http_get(f"{base}/off/{route}", {"If-None-Match": etag})
        check(status == 304 and body == b"" and h["ETag"] == etag,
              f"service If-None-Match on {route}: {status}")
    raw = paths["off"].read_bytes()
    size = len(raw)
    status, h, body = http_get(f"{base}/off/raw", {"Range": "bytes=100-1099"})
    check(status == 206 and h["Content-Range"] == f"bytes 100-1099/{size}"
          and body == raw[100:1100], f"service Range: {status} {h.get('Content-Range')}")
    status, h, _ = http_get(f"{base}/off/raw", {"Range": f"bytes={size}-"})
    check(status == 416 and h["Content-Range"] == f"bytes */{size}", f"service 416: {status}")
    for name in ("off", "rle", "sharded"):
        ca = cas[name]
        for cid in (0, ca.nchunks // 2, ca.nchunks - 1):
            off, length, _n = (int(v) for v in ca._frames[cid])
            f = ca._src(cid)
            f.seek(off)
            want = f.read(length)
            status, _h, body = http_get(f"{base}/{name}/chunk/{cid}")
            check(status == 200 and body == want, f"service {name} chunk {cid}: frame bytes")
        for header_only in (False, True):
            q = "?header_only=1" if header_only else ""
            status, _h, body = http_get(f"{base}/{name}/stats{q}")
            check(status == 200 and json.loads(body) == stats[name, header_only],
                  f"service {name} stats header_only={header_only} differ from ca.stats()")
    man = json.loads(paths["sharded_url"].read_text())
    sh = man["shards"][-1]
    lo = sh["chunks"][0]
    off, length, _n = sh["frames"][0]
    status, h, _ = http_get(f"{base}/sharded_url/chunk/{lo}", follow=False)
    check(status == 307 and h["Location"] == sh["file"]
          and (int(h["X-Chunk-Offset"]), int(h["X-Chunk-Length"])) == (off, length),
          f"service URL shard: {status} {h}")
    obs.reset()
    obs.enable()
    try:
        http_get(f"{base}/off/read?roi=1,2,3")
        status, h, body = http_get(served.base + "/v1/metrics", {"Accept": "text/plain"})
    finally:
        obs.disable()
        obs.reset()
    text = body.decode()
    series = ("szx_serve_requests", "szx_serve_responses", "szx_serve_bytes_sent",
              "szx_serve_request_seconds", "szx_serve_cache")
    check(status == 200 and h["Content-Type"].startswith("text/plain")
          and all(s in text for s in series), "/v1/metrics text/plain lacks the serve series")
    log(f"service protocol: 304 on info/read/chunk, Range 206 and 416, chunk frames == file "
        f"bytes (off, rle, sharded), URL shard 307 with X-Chunk-Offset/Length, stats of both "
        f"tiers == ca.stats(), {len(text.splitlines())} lines of Prometheus text with the serve "
        f"series")


def save_service_stores(x, field) -> dict:
    """The stores phase 13 serves, under DATA_DIR (those phase 12 left there
    are taken as they are): phase 5's stage-off and bitshuffle-rle stores,
    a 4-shard manifest of the same field, one copy of that manifest with its
    last shard at a URL, and phase 12's ingest store."""
    from repro_torch.core.codec import Bound
    from repro_torch.store import ArrayStore

    paths = {"off": DATA_DIR / "store_off.szs", "rle": DATA_DIR / "store_rle.szs",
             "sharded": DATA_DIR / "sharded.json", "ingest": DATA_DIR / "ingest.szs",
             "sharded_url": DATA_DIR / "sharded_url.json"}
    bound = Bound.rel(1e-3)
    t0 = time.perf_counter()
    if not paths["off"].exists():
        ArrayStore.save(paths["off"], x, bound)
    ArrayStore.save(paths["rle"], x, bound, stage="bitshuffle-rle")
    ArrayStore.save_sharded(paths["sharded"], x, bound, nshards=SERVICE_SHARDS)
    if not paths["ingest"].exists():
        ArrayStore.save(paths["ingest"], field.reshape(INGEST_SHAPE), bound,
                        chunk_shape=INGEST_CHUNK)
    man = json.loads(paths["sharded"].read_text())
    man["shards"][-1]["file"] = "http://127.0.0.1:9/sharded.shard-remote.szs"   # never fetched
    paths["sharded_url"].write_text(json.dumps(man))
    log(f"service stores saved in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {p.stat().st_size} B" for k, p in paths.items()))
    return paths


def phase_service(args) -> dict:
    """Phase 13: phase 5's 512^3 stores (stage-off, bitshuffle-rle, 4
    shards) and phase 12's (32768, 4096) ingest store served on the card by
    make_service() (host parse + unpack, 256 MiB cache) and a second
    service with fused_range=True over the stage-off store, each an
    HttpServer on 127.0.0.1 in a thread.  ROI traffic from 16 client
    threads, a cold and a hot pass; the protocol; phase 12's epoch through
    StoreLoader over HTTP.  Every body is held bit for bit to ca[roi] on the
    card and within e of the field; every batch to the local loader's
    batch_at.  Returns the launches of the served traffic."""
    import torch
    from repro_torch.core.codec import Bound, plan
    from repro_torch.data import StoreLoader, WindowSampler
    from repro_torch.kernels import ops
    from repro_torch.serve.store_service import make_service
    from repro_torch.store import ArrayStore
    from repro_torch.store.grid import parse_roi

    import os

    # the loader's client (urlopen) asks only 127.0.0.1: never through a proxy
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    field = make_field(args.edge, args.seed)
    x = store_field(field, args.seed)
    e = plan.resolve_error_bound(x.reshape(-1), Bound.rel(1e-3))
    paths = save_service_stores(x, field)
    del field
    rois = service_rois(args.edge)

    # references, outside the counted run: each ROI read on the card from a
    # handle of its own (by the route of the service that serves it)
    cas = {name: ArrayStore.open(paths[name]) for name in ("off", "rle", "sharded")}
    fused_ca = ArrayStore.open(paths["off"], fused_range=True)
    want = {}
    for name, ca in list(cas.items()) + [("fused", fused_ca)]:
        want[name] = {}
        for rname, text in rois.items():
            key = parse_roi(text)
            got = ca[key]
            err = max_abs_diff(got, x[key])
            check(err <= e, f"service reference {name} {rname}: max error {err} > e={e}")
            want[name][rname] = host_bytes(got)
    for rname in rois:
        check(all(want[n][rname] == want["off"][rname] for n in want),
              f"service references of {rname} differ across stores and routes")
    stats = {(name, h): json.loads(json.dumps(ca.stats(header_only=h).to_dict()))
             for name, ca in cas.items() for h in (False, True)}
    local = StoreLoader(paths["ingest"], INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED,
                        workers=0)
    samples = INGEST_BATCH * INGEST_STEPS
    local_batches, t_local = timed(lambda: [local.batch_at(s).clone()
                                            for s in range(INGEST_STEPS)])
    local_rates = {"serial": samples / t_local}
    for w in SERVICE_INGEST_WORKERS[1:]:
        with StoreLoader(paths["ingest"], INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED,
                         workers=w) as ld:
            _, t = timed(lambda: [b.clone() for b in ld.batches(steps=INGEST_STEPS)])
        local_rates[f"workers={w}"] = samples / t
    del x
    torch.cuda.empty_cache()

    svc = make_service()
    for name in ("off", "rle", "sharded", "ingest", "sharded_url"):
        svc.add_store(name, paths[name])
    fsvc = make_service(fused_range=True)
    fsvc.add_store("off", paths["off"])
    host, fused = Served(svc), Served(fsvc)
    launches = {}
    try:
        ops.reset_launch_counts()
        for name in ("off", "rle", "sharded"):
            svc.cache.clear()
            for label in ("cold", "hot"):
                r = roi_traffic(host, name, rois, want[name])
                log(f"service host parse {name} {label} pass: {r['requests']} requests in "
                    f"{r['s']:.3f} s, {r['req_s']:.1f} requests/s, {r['MB_s']:.1f} MB/s decoded "
                    f"on the wire; cache hits {r['hits']}, misses {r['misses']}, evictions "
                    f"{r['evictions']}")
        service_breakdown(host, "off", rois)
        w0 = WindowSampler(INGEST_SHAPE, INGEST_WINDOW, INGEST_BATCH,
                           seed=INGEST_SEED).origins_at(0)[0].tolist()
        service_breakdown(host, "ingest", {"window": ",".join(
            f"{o}:{o + w}" for o, w in zip(w0, INGEST_WINDOW))}, cold=True)
        service_protocol(host, paths, cas, stats)
        url = f"{host.base}/v1/stores/ingest"
        rates = {}
        for w in SERVICE_INGEST_WORKERS:
            svc.cache.clear()
            with StoreLoader(url, INGEST_WINDOW, INGEST_BATCH, seed=INGEST_SEED,
                             workers=w) as ld:
                check(ld.source.granularity == "window", "ingest over HTTP: not the URL source")
                if w == 0:
                    got, t = timed(lambda: [ld.batch_at(s).clone() for s in range(INGEST_STEPS)])
                else:
                    got, t = timed(lambda: [b.clone() for b in ld.batches(steps=INGEST_STEPS)])
            check(len(got) == INGEST_STEPS and all(same_bits(g, r) for g, r in
                                                   zip(got, local_batches)),
                  f"ingest over HTTP workers={w}: batches differ from the local batch_at")
            rates["serial" if w == 0 else f"workers={w}"] = samples / t
        log(f"ingest over HTTP: window {INGEST_WINDOW} batch {INGEST_BATCH} x {INGEST_STEPS} "
            f"steps, every batch == the local batch_at bit for bit; samples/s over HTTP "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + "; local (this phase) "
            + ", ".join(f"{k} {v:.1f}" for k, v in local_rates.items()))
        host_counts = {k: v for k, v in ops.launch_counts().items() if v}
        host_routes = {k: v for k, v in ops.store_route_counts().items() if v}
        log(f"service host parse metrics: {route_latencies(host)}; cache {svc.cache.stats()}")

        ops.reset_launch_counts()
        fsvc.cache.clear()
        for label in ("cold", "hot"):
            r = roi_traffic(fused, "off", rois, want["fused"])
            log(f"service fused range off {label} pass: {r['requests']} requests in "
                f"{r['s']:.3f} s, {r['req_s']:.1f} requests/s, {r['MB_s']:.1f} MB/s decoded on "
                f"the wire; cache hits {r['hits']}, misses {r['misses']}, evictions "
                f"{r['evictions']}")
        fused_counts = {k: v for k, v in ops.launch_counts().items() if v}
        log(f"service fused range metrics: {route_latencies(fused)}; cache {fsvc.cache.stats()}")
    finally:
        host.close()
        fused.close()
        for ca in list(cas.values()) + [fused_ca]:
            ca.close()
    log(f"phase 13 launches: host-parse service {host_counts} (by route {host_routes}); "
        f"fused-range service {fused_counts}")
    check(host_counts.get("unpack", 0) > 0, "the host-parse service launched no unpack")
    check(host_counts.get("bitshuffle_inverse", 0) > 0,
          "the host-parse service launched no inverse bitshuffle on the rle store")
    check(fused_counts.get("decode_body", 0) > 0, "the fused-range service launched no decode_body")
    for counts in (host_counts, fused_counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 14: the MoE, SSM and hybrid families at full width
# ---------------------------------------------------------------------------

# smallest first; deepseek-moe-16b's f32 weights last, on a card the earlier
# phases have freed (configs/*.py, full width)
FAMILY_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "deepseek-moe-16b")
FAMILY_SERVE_STEPS = 16            # greedy steps a mode; phase 9 keeps SERVE_STEPS
# phase 14's depth cuts, which pay for phase 20 (that phase serves mamba2-1.3b
# and hymba-1.5b at full depth): mamba2-1.3b on 24 of its 48 layers and
# hymba-1.5b on 16 of its 32; deepseek-moe-16b is served on all 28 (67.5 GB of
# float32 weights)
FAMILY_LAYERS = {"mamba2-1.3b": 24, "hymba-1.5b": 16}
TEACHER_PROMPTS = (4, 3, 2, 1)     # the float32 checks take as many as fit


def family_modes(cfg):
    from repro_torch.models import transformer as T

    return SERVE_MODES if T.has_attention(cfg) else SERVE_MODES[:1]


def family_flash_rows(gen, reps: int, launches: dict) -> list:
    """The flash kernel timed at phase 14's prefill shapes (``time_flash``),
    as entries of the kernels JSON's flash row, each with its max |kernel -
    plain| from the kernel-vs-plain cases and ``launches[arch]``, its flash
    launches in phase 14."""
    rows = []
    for arch, shape in FAMILY_FLASH.items():
        ms, plain_ms, lib_ms, bound_ms = time_flash(gen, reps, shape)
        rows.append({"arch": arch, "shape": list(shape), "launches": launches.get(arch),
                     "max_abs_err": MAX_ERR_CASES.get(shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "operations", "library_ms": lib_ms})
    return rows


def routes(fn, force=None):
    """``fn()`` with ``layers.moe_route`` recording the top-k experts (B,
    S, K) each call chooses; with ``force`` (one (B, S, K) a call, in call
    order) each call dispatches to those experts instead.  Returns (fn's
    result, the recorded choices)."""
    from repro_torch.models import layers as L

    seen, route = [], L.moe_route

    def hooked(x, router, cfg):
        out = route(x, router, cfg)
        seen.append(out[1])
        return out if force is None else L.dispatch(out[0], force[len(seen) - 1], cfg)

    L.moe_route = hooked
    try:
        return fn(), seen
    finally:
        L.moe_route = route


def moe_teacher(model, cfg, prompts, mode: str, P: int) -> tuple:
    """The MoE model's prefill and TEACHER_STEPS decode steps against
    forward over the same tokens, twice: as forward routes them, and with
    every token dispatched to the experts the serving form chose for it (so
    that only the cache and the rounding differ).  Returns (rel, rel with
    the serving form's routes, per layer the share of tokens forward routes
    to another expert set)."""
    import torch

    nl = cfg.n_layers
    (toks, dec), seen = routes(
        lambda: serve_and_check(model, cfg, prompts, mode, P, TEACHER_STEPS, TEACHER_STEPS)[1:3])
    # per layer: the prefill's choices, then one a decode step
    served = [torch.cat([seen[i]] + seen[nl + i::nl], dim=1) for i in range(nl)]
    del seen
    full, own = routes(lambda: forward_logits(model, cfg, prompts, toks))
    flips = [float((a.sort(-1).values != b.sort(-1).values).any(-1).float().mean())
             for a, b in zip(served, own)]
    forced, _ = routes(lambda: forward_logits(model, cfg, prompts, toks), force=served)
    return (teacher_rel(full, dec, cfg.vocab_size), teacher_rel(forced, dec, cfg.vocab_size),
            flips)


def fit_prompts(arch: str, what: str, fn):
    """``fn(nb)`` on the most prompts of TEACHER_PROMPTS that fit the card.
    Returns (nb, its result)."""
    import torch

    for nb in TEACHER_PROMPTS:
        torch.cuda.empty_cache()          # outside the handler: its frames hold tensors
        try:
            return nb, fn(nb)
        except torch.cuda.OutOfMemoryError:
            log(f"families {arch}: {what} does not fit with {nb} prompts")
    check(False, f"{arch}: {what} fits no prompt")


def layer_divergence(model, cfg, tokens, s: int) -> list:
    """Per layer, max |h_a - h_b| / max |h_b| over the first ``s``
    positions, where h_a runs the layers over ``tokens[:, :s]`` and h_b over
    all of ``tokens``: the train form at two lengths computes one function
    on those positions, but the SSD's chunks, the MoE's capacity and the
    products' tiles differ, so this is how far rounding alone moves the
    hidden state, layer by layer."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    out = []
    with torch.no_grad(), L.exact_matmuls():
        ha = T.embed_tokens(model, cfg, tokens[:, :s])
        hb = T.embed_tokens(model, cfg, tokens)
        for lp in model["layers"]:
            ha = T._block(lp, ha, cfg, causal=True)[0]
            hb = T._block(lp, hb, cfg, causal=True)[0]
            ref = hb[:, :s].float()
            out.append(float((ha.float() - ref).abs().max() / ref.abs().max()))
    return out


def family_teacher_checks(model, cfg, prompts, runs: dict) -> dict:
    """Decode vs forward over the same tokens for one model of phase 14.
    In bf16, as served, measured (from ``runs`` where the model has no
    experts), with ``layer_divergence`` beside it: rounding at other places
    in the two forms grows with depth.  In float32 compute (exact products),
    on as many prompts as fit, held to TEACHER_TOL.  The MoE runs drop-free
    (capacity_factor = n_experts / top_k, so cap = S): capacity drops make
    the two forms differ by design (tests/test_models.py:180-183).  A token
    whose k-th and (k+1)-th expert scores lie closer than what the forms
    differ by (rounding, or the compressed cache's quantization) takes
    another expert, so the MoE's check is held with forward dispatching each
    token to the experts the serving form chose (``moe_teacher``); the
    share of such tokens is printed.  Returns {(mode, P): (rel, what)} of
    the float32 checks."""
    import dataclasses

    import torch

    arch = cfg.name
    served = cfg
    if cfg.n_experts:
        served = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        s = SERVE_PROMPT + TEACHER_STEPS
        cap = min(s, max(8, int(s * cfg.top_k / cfg.n_experts * served.capacity_factor)))
        check(cap == s, f"{arch}: drop-free capacity {cap} != {s}")
    f32 = dataclasses.replace(served, compute_dtype="float32")
    drop = (f"drop-free (capacity_factor {served.capacity_factor:.4f}, cap = S), "
            if cfg.n_experts else "")

    def checks(c, nb):
        if c.n_experts:
            return {key: moe_teacher(model, c, prompts[:nb], *key) for key in family_modes(c)}
        out = {}
        for key in family_modes(c):
            cache, toks, dec, _, _ = serve_and_check(model, c, prompts[:nb], *key, TEACHER_STEPS,
                                                  TEACHER_STEPS)
            del cache
            out[key] = (teacher_rel(forward_logits(model, c, prompts[:nb], toks), dec,
                                    c.vocab_size), None, None)
        return out

    def report(c, nb, res, held: bool) -> dict:
        what = f"{drop}{c.compute_dtype}, {nb} prompts"
        for (mode, P), (rel, rel_routed, flips) in res.items():
            if flips is not None:
                log(f"families {arch} kv={mode} P={P} {c.compute_dtype}: tokens forward routes "
                    f"to another expert set than the serving form, per layer: max "
                    f"{max(flips):.4f}, mean {sum(flips) / len(flips):.4f}, layers with any "
                    f"{sum(f > 0 for f in flips)} of {len(flips)}; decode vs forward as forward "
                    "routes: " + ", ".join(f"{r:.5f}" for r in rel))
            if not held:
                log(f"families measure {arch} kv={mode} P={P}: prefill and {TEACHER_STEPS} "
                    f"decode steps vs forward over the same tokens, {what}"
                    + (", forward on the served routes" if flips else "")
                    + ": max |d| / max |logit| = "
                    + ", ".join(f"{r:.5f}" for r in (rel_routed or rel)) + " (measured)")
        return {key: (rel_routed or rel, what + (", forward on the served routes"
                                                 if flips else ""))
                for key, (rel, rel_routed, flips) in res.items()}

    if cfg.n_experts:
        nb, res = fit_prompts(arch, f"the check in {cfg.compute_dtype}",
                              lambda nb: checks(served, nb))
    else:           # the served runs' own tokens and logits
        nb = SERVE_BATCH
        res = {key: (teacher_rel(forward_logits(model, cfg, prompts, toks), dec, cfg.vocab_size),
                     None, None) for key, (toks, dec) in runs.items()}
    report(served, nb, res, held=False)
    toks = torch.cat([prompts[:1], runs[("dense", 1)][0][:1, :TEACHER_STEPS]], dim=1)
    for c in (served, f32):
        div = layer_divergence(model, c, toks, SERVE_PROMPT)
        marks = sorted({1, 2, 4, 8, 16, 32, len(div)} & set(range(1, len(div) + 1)))
        log(f"families {arch} {c.compute_dtype}: the layers over {SERVE_PROMPT} and "
            f"{SERVE_PROMPT + TEACHER_STEPS} tokens, max |d| / max |h| on the first "
            f"{SERVE_PROMPT} after layer " + ", ".join(f"{i}: {div[i - 1]:.2e}" for i in marks))
    nb, res = fit_prompts(arch, "the float32 check", lambda nb: checks(f32, nb))
    return report(f32, nb, res, held=True)


def phase_families(args) -> dict:
    """Phase 14: mamba2-1.3b, hymba-1.5b and deepseek-moe-16b at full width
    on FAMILY_LAYERS' depths, float32 weights from --seed on the card, bf16 compute: 4
    prompts of 2048 tokens and FAMILY_SERVE_STEPS greedy decode steps with
    a dense cache (and SZx-planes caches at P = 1, 2 where there is
    attention); launch counts, cache bytes, finite logits; decode vs
    forward over the same tokens (``family_teacher_checks``); peak memory;
    a profile of a dense prefill and 2 decode steps.  Returns the phase's
    launch counts and each model's flash launches."""
    import dataclasses
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    gc.collect()                    # the earlier phases' cycles hold memory on the card
    ops.reset_launch_counts()
    flash = {}
    for i, arch in enumerate(FAMILY_ARCHS):
        flash0 = ops.launch_counts()["flash_attention"]
        cfg = configs.get(arch)
        if arch in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
        depth = ("full depth" if arch not in FAMILY_LAYERS else
                 f"cut to {cfg.n_layers} of {configs.get(arch).n_layers}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free, total = torch.cuda.mem_get_info()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 14 + i)
        model, t_init = timed(lambda: T.init_params(cfg, gen, "cuda"))
        nparams = sum(p.numel() for p in model.parameters())
        # param_count() leaves out the norms and the SSM's norm
        norms = cfg.d_model * (1 + cfg.n_layers * (1 + bool(cfg.n_experts or cfg.d_ff))) \
            + cfg.n_layers * cfg.ssm_d_inner * T.has_ssm(cfg)
        check(nparams == cfg.param_count() + norms, f"{arch}: {nparams} parameters")
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                                generator=gen)
        log(f"families {arch} ({cfg.family}): {nparams} parameters, "
            f"{nparams * 4 / 1e9:.2f} GB f32, made on the card in {t_init:.2f} s "
            f"({free / 1e9:.2f} of {total / 1e9:.2f} GB free before); {cfg.n_layers} layers "
            f"({depth}), {SERVE_BATCH} prompts of {SERVE_PROMPT} tokens, "
            f"{FAMILY_SERVE_STEPS} greedy steps")
        t_first = timed(lambda: serve_and_check(model, cfg, prompts, "dense", 1, 1, 0) and None)[1]
        log(f"families {arch}: first prefill and step (allocator and cuBLAS warm-up) "
            f"{t_first * 1e3:.1f} ms")
        runs = {}
        for mode, P in family_modes(cfg):
            cache, toks, dec, t_pre, t_dec = serve_and_check(model, cfg, prompts, mode, P,
                                                          FAMILY_SERVE_STEPS, TEACHER_STEPS)
            log(f"families {arch} kv={mode} P={P}: prefill {t_pre * 1e3:.1f} ms "
                f"({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} tok/s), decode {FAMILY_SERVE_STEPS} "
                f"steps in {t_dec:.3f} s = {SERVE_BATCH * FAMILY_SERVE_STEPS / t_dec:.1f} tok/s "
                f"({t_dec / FAMILY_SERVE_STEPS * 1e3:.2f} ms a step), cache "
                f"{E.cache_nbytes(cache)} B "
                f"({E.cache_nbytes(cache) / 2**20:.1f} MiB), sample row {toks[0, :8].tolist()}")
            runs[(mode, P)] = (toks, dec)
            del cache
        checks = family_teacher_checks(model, cfg, prompts, runs)
        for (mode, P), (rel, what) in checks.items():
            check(max(rel) < TEACHER_TOL[mode], f"{arch} {mode} P={P}: decode vs forward {rel}")
            log(f"families check {arch} kv={mode} P={P}: prefill and {TEACHER_STEPS} decode steps "
                f"vs forward over the same tokens, {what}: max |d| / max |logit| = "
                + ", ".join(f"{r:.5f}" for r in rel) + f" (tolerance {TEACHER_TOL[mode]})")
        dense_toks = runs[("dense", 1)][0]
        for (mode, P), (toks, _) in runs.items():
            if mode != "dense":
                log(f"families {arch} kv={mode} P={P}: greedy tokens equal to dense's: "
                    f"{float((toks == dense_toks).float().mean()):.3f}")
        del runs
        _, t_prof = timed(lambda: profile_serve(model, cfg, prompts, modes=SERVE_MODES[:1]))
        peak = torch.cuda.max_memory_allocated()
        log(f"families {arch}: peak memory allocated {peak} B ({peak / 1e9:.2f} GB of "
            f"{total / 1e9:.2f}), weights {nparams * 4 / 1e9:.2f} GB; profile {t_prof:.1f} s")
        flash[arch] = ops.launch_counts()["flash_attention"] - flash0
        del model, prompts
    torch.cuda.empty_cache()
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in PLANES_KERNELS + ("flash_attention",)}
    log(f"families path launches: {counts}; by route {ops.planes_route_counts()}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the families path")
    check_vector_route("families path", ops.planes_route_counts())
    return counts, flash


# ---------------------------------------------------------------------------
# phase 15: the audio encoder-decoder and the VLM at full width
# ---------------------------------------------------------------------------

ENC_VLM_ARCHS = ("whisper-medium", "internvl2-1b")
# phase 15's depth cuts, which pay for phase 20 serving both at full
# depth: whisper-medium on 12 of its 24 encoder and 24 decoder layers,
# internvl2-1b on 12 of its 24
ENC_VLM_LAYERS = {"whisper-medium": 12, "internvl2-1b": 12}
# per model: text prompt, decode steps, training sequence.  whisper-medium:
# 30 s of audio (1500 encoder frames) and Whisper's 448-position text
# context, a 384-token prompt and 16 steps; internvl2-1b: 256 image
# embeddings and 1792 tokens (phase 9's 2048 positions) and 16 steps
ENC_VLM_TRAFFIC = {"whisper-medium": (384, 16, 448), "internvl2-1b": (1792, 16, 1792)}
ENC_VLM_TRAIN_STEPS = 3            # through launch.train: the first one warms up
# the leaves whose first 64 x 64 values must move in training
ENC_VLM_WATCH = {"whisper-medium": ("frontend_proj", "layers/0/attn/wq", "layers/0/cross/wk",
                                    "encoder/layers/0/attn/wq"),
                 "internvl2-1b": ("frontend_proj", "layers/0/attn/wq")}


def enc_vlm_extra(cfg, gen) -> dict:
    """Stub frame embeddings (B, encoder_len, D) for the encoder-decoder,
    image embeddings (B, prefix_embeds, D) for the VLM, drawn from ``gen``
    on the card (the configs' frontends are stubs)."""
    import torch

    if cfg.encoder_decoder:
        return {"frames": torch.randn((SERVE_BATCH, cfg.encoder_len, cfg.d_model),
                                      device="cuda", generator=gen)}
    return {"image_embeds": torch.randn((SERVE_BATCH, cfg.prefix_embeds, cfg.d_model),
                                        device="cuda", generator=gen)}


class FlashShapes:
    """Counts the flash kernel's launches by (B, Sq, Hq, Hkv, hd, causal,
    window, Skv, dtype) while it is entered, by wrapping the wrapper that
    ``FlashAttention`` calls; the kernels' own counts are untouched."""

    def __enter__(self):
        import collections

        from repro_torch.kernels import flash_attention as fa

        self.fa, self.inner, self.seen = fa, fa.flash_attention, collections.Counter()

        def counted(q, k, v, *, causal=True, window=0, q_offset=0):
            out = self.inner(q, k, v, causal=causal, window=window, q_offset=q_offset)
            if q.is_cuda:
                b, sq, hq, hd = q.shape
                self.seen[(b, sq, hq, k.shape[2], hd, bool(causal), int(window), k.shape[1],
                           str(q.dtype).split(".")[-1])] += 1
            return out

        fa.flash_attention = counted
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.inner


def corner(t):
    """A copy of the first 64 entries along every axis of ``t``: the part of
    a watched leaf the training phases compare before and after, 1-D leaves
    (the SSM's ``A_log``, ``dt_bias``, ``D``) and the experts' 3-D ones
    included."""
    return t[(slice(0, 64),) * t.dim()].clone()


def moved_leaves(params, init: dict) -> dict:
    """max |w - w0| over each watched leaf's corner."""
    from repro_torch.core import pytree

    return {n: float((corner(t) - init[n]).abs().max())
            for n, t in pytree.leaf_paths(params) if n in init}


def check_restored(path, state, arch: str) -> str:
    """The launcher's final SZx checkpoint under ``path`` restored on the
    card (``CheckpointManager.restore``, the decode kernel) and held to the
    final ``state``: every float leaf of 1024+ values within the
    checkpoint's bound, the rest bit for bit.  Returns the log line's
    text."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.core.codec import plan
    from repro_torch.kernels import ops

    ckpt = CheckpointManager(str(path), compress=True, device="cuda")
    before = ops.launch_counts()["decode_body"]
    (tree, step), t = timed(lambda: ckpt.restore(state))
    launched = ops.launch_counts()["decode_body"] - before
    check(launched > 0, f"{arch}: the restore did not launch the decode kernel")
    worst, shapes = 0.0, {"szx": set(), "raw": set()}
    for (name, leaf), want in zip(pytree.leaf_paths(tree), pytree.leaves(state)):
        check(leaf.dtype == want.dtype and leaf.shape == want.shape, f"{arch}: restored {name}")
        if leaf.is_floating_point() and leaf.numel() >= 1024:
            e = plan.resolve_error_bound(want, ckpt.bound)
            err = max_abs_diff(leaf, want)
            check(err <= e, f"{arch}: restored {name}: max error {err} > e={e}")
            worst = max(worst, err / e if e else 0.0)
            shapes["szx"].add(tuple(leaf.shape))
        else:
            check(same_bits(leaf, want), f"{arch}: restored {name} not bit-identical")
            shapes["raw"].add(tuple(leaf.shape))
    del tree
    st = ckpt.stats(step)
    return (f"restore step {step} on the card {t:.2f} s, {launched} decode launches; every "
            f"leaf of 1024+ float values within the bound (max error/bound {worst:.4f}; shapes "
            f"{sorted(shapes['szx'])}), the rest bit for bit (shapes {sorted(shapes['raw'])}); "
            f"{st['raw_bytes']} B -> {st['stored_bytes']} B (CR {st['ratio']:.4f})")


def train_launcher(args, cfg, seq: int, seed: int, watch: tuple, tag: str, *,
                   ckpt_compress: bool = False) -> dict:
    """``launch.train``'s run (its Trainer, its synthetic batches with the
    stub frames or image embeddings where the model takes them, AdamW) for
    ENC_VLM_TRAIN_STEPS plain steps of B 4 x ``seq`` tokens, its final
    checkpoint into CKPT_DIR (raw, or with ``ckpt_compress`` SZx, restored
    on the card and held to the final state; removed after); then one
    compressed step at P = 1 in a one-rank NCCL group after a warm-up step,
    and a profiled compressed and plain step.  Every loss finite, the ``watch`` leaves
    moved, the flash kernel twice an attention layer a step (forward and
    remat), the planes kernels in the compressed step on the vector route,
    the encode kernel in an SZx save.  Returns the step times, the peak
    memory and the profiled steps' busy shares."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.core import pytree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.train import step as step_mod

    arch = cfg.name
    init = {n: corner(t) for n, t in pytree.leaf_paths(T.param_tree(
        T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")))
        if n in watch}
    check(len(init) == len(watch), f"{arch}: watched leaves {sorted(init)} of {watch}")
    torch.cuda.empty_cache()
    flash_step = (2 if cfg.remat else 1) * prefill_flash(cfg)
    argv = ["--arch", arch, "--steps", str(ENC_VLM_TRAIN_STEPS), "--seq", str(seq),
            "--batch", str(SERVE_BATCH), "--ckpt", str(CKPT_DIR / arch), "--device", "cuda",
            "--seed", str(seed)] + ["--ckpt-compress"] * ckpt_compress
    shutil.rmtree(CKPT_DIR / arch, ignore_errors=True)
    saves = []

    class TimedSaves(train_cli.CheckpointManager):
        def save(self, step, tree):
            before = ops.launch_counts()["encode"]
            out, t = timed(lambda: super(TimedSaves, self).save(step, tree))
            saves.append(f"save step {step} {t:.2f} s, "
                         f"{ops.launch_counts()['encode'] - before} encode launches")
            return out

    torch.cuda.reset_peak_memory_stats()
    manager, train_cli.CheckpointManager = train_cli.CheckpointManager, TimedSaves
    # the launcher resolves --arch through the registry: give it ``cfg`` (a
    # depth cut of phase 16) for the run
    registry = train_cli.configs.get
    train_cli.configs.get = lambda name: cfg if name == arch else registry(name)
    before = ops.launch_counts()
    try:
        (tr, state), t_run = timed(lambda: train_cli.run(train_cli.build_parser().parse_args(argv),
                                                         torch.device("cuda")))
        after = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        restored = check_restored(CKPT_DIR / arch, state, arch) if ckpt_compress else None
    finally:
        train_cli.CheckpointManager = manager
        train_cli.configs.get = registry
        shutil.rmtree(CKPT_DIR / arch, ignore_errors=True)
    losses, dts = [h["loss"] for h in tr.history], [h["dt"] for h in tr.history]
    check(len(losses) == ENC_VLM_TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"{arch}: train losses {losses}")
    moved = moved_leaves(state["params"], init)
    check(len(moved) == len(init) and all(v > 0 for v in moved.values()),
          f"{arch}: the weights did not move {moved}")
    flash = after["flash_attention"] - before["flash_attention"]
    check(flash == flash_step * ENC_VLM_TRAIN_STEPS,
          f"{arch}: {flash} flash launches in {ENC_VLM_TRAIN_STEPS} steps")
    if ckpt_compress:
        check(after["encode"] > before["encode"], f"{arch}: the SZx save launched no encode")
    nbytes = sum(t.numel() * t.element_size() for t in pytree.leaves(state))
    nparams = sum(t.numel() for t in pytree.leaves(state["params"]))
    tokens = SERVE_BATCH * seq
    total = torch.cuda.mem_get_info()[1]
    log(f"{tag} train {arch} plain through launch.train (B {SERVE_BATCH} x S {seq}"
        + (f" + {cfg.prefix_embeds} image embeddings" if cfg.prefix_embeds else "")
        + (f", {cfg.encoder_len} frames" if cfg.encoder_decoder else "")
        + f"; {cfg.n_layers} layers, {nparams} parameters): steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in dts)
        + f" ms (the first warms up; {tokens / (sum(dts[1:]) / len(dts[1:])):.0f} tokens/s after"
        f"); loss curve " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; max |d w| " + ", ".join(f"{n} {v:.3e}" for n, v in moved.items())
        + f"; state {nbytes / 1e9:.2f} GB, the run with its final "
        + ("SZx" if ckpt_compress else "raw") + f" checkpoint {t_run:.1f} s"
        + (f" ({'; '.join(saves)})" if saves else "")
        + f"; peak {peak / 1e9:.2f} GB of {total / 1e9:.2f}; flash launches {flash}")
    if restored:
        log(f"{tag} train {arch}: {restored}")
    del state, tr
    torch.cuda.empty_cache()

    opt = AdamW(lr=TRAIN_LR)
    ds = SyntheticLM(train_cli.data_config(cfg, seq, SERVE_BATCH))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        torch.cuda.reset_peak_memory_stats()
        state = step_mod.init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(seed),
                                    ef_planes=1, device="cuda")
        fn = step_mod.make_train_step(cfg, opt, compress_planes=1)
        w0 = {n: corner(t) for n, t in pytree.leaf_paths(state["params"]) if n in init}
        (state, m0), t_warm = timed(lambda: fn(state, train_batch(ds, 0)))
        before, routes_before = ops.launch_counts(), ops.planes_route_counts()
        batch = train_batch(ds, 1)
        (state, m1), t_step = timed(lambda: fn(state, batch))
        after = ops.launch_counts()
        routes = {k: v - routes_before[k] for k, v in ops.planes_route_counts().items()}
        peak_c = torch.cuda.max_memory_allocated()
        busy_c = profile_train(fn, state, train_batch(ds, 2), f"{arch} compressed P=1")
    finally:
        dist.destroy_process_group()
    losses = [float(m0["loss"]), float(m1["loss"])]
    check(all(math.isfinite(v) for v in losses), f"{arch}: compressed losses {losses}")
    dw = moved_leaves(state["params"], w0)
    check(all(v > 0 for v in dw.values()), f"{arch}: the compressed steps did not move {dw}")
    for k in PLANES_KERNELS:
        check(after[k] > before[k], f"{arch} compressed P=1: {k} not launched")
    check_vector_route(f"{arch} compressed P=1", routes)
    check(after["flash_attention"] - before["flash_attention"] == flash_step,
          f"{arch} compressed P=1: flash launches "
          f"{after['flash_attention'] - before['flash_attention']}, not {flash_step}")
    log(f"{tag} train {arch} compressed P=1: warm-up step {t_warm * 1e3:.1f} ms, step "
        f"{t_step * 1e3:.1f} ms ({tokens / t_step:.0f} tokens/s); losses "
        + ", ".join(f"{v:.4f}" for v in losses) + "; max |d w| "
        + ", ".join(f"{n} {v:.3e}" for n, v in dw.items()) + f"; peak {peak_c / 1e9:.2f} GB; "
        f"launches {dict((k, after[k] - before[k]) for k in after if after[k] != before[k])}")
    busy = profile_train(step_mod.make_train_step(cfg, opt), state, train_batch(ds, 3),
                         f"{arch} plain")
    del state, m0, m1
    torch.cuda.empty_cache()
    return {"plain": dts, "compressed": t_step, "peak": peak, "busy": busy,
            "busy_compressed": busy_c}


def phase_enc_vlm(args) -> tuple:
    """Phase 15: whisper-medium and internvl2-1b at full width on
    ENC_VLM_LAYERS' depths, float32 weights from --seed on the card, bf16 compute, B 4: prefill
    (whisper: 1500 stub frames through the encoder, a 384-token prompt;
    internvl2-1b: 256 stub image embeddings and 1792 tokens) and 16 greedy
    steps with a dense and SZx-planes (P = 1, 2) caches; launch counts,
    cache bytes (the cross K/V apart), finite logits; decode vs forward over
    the same tokens in float32 compute, held to TEACHER_TOL, with the bf16
    figures measured beside; peak memory; a profile of a dense prefill and
    2 steps; then ``train_launcher``.  Returns the phase's launch counts and
    its flash launches by shape."""
    import dataclasses
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    gc.collect()
    ops.reset_launch_counts()
    with FlashShapes() as shapes:
        for i, arch in enumerate(ENC_VLM_ARCHS):
            cfg, cut = configs.get(arch), ENC_VLM_LAYERS[arch]
            full = cfg.n_layers
            cfg = dataclasses.replace(cfg, n_layers=cut,
                                      n_encoder_layers=cut if cfg.encoder_decoder else 0)
            prompt, steps, train_seq = ENC_VLM_TRAFFIC[arch]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            free, total = torch.cuda.mem_get_info()
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 30 + i)
            model, t_init = timed(lambda: T.init_params(cfg, gen, "cuda"))
            nparams = sum(p.numel() for p in model.parameters())
            # param_count() leaves out frontend_proj and the norms (ln1, ln2,
            # ln_cross a decoder layer, ln1 and ln2 an encoder layer, the final ones)
            d = cfg.d_model
            extra_params = d * d + d * (1 + cfg.n_layers * (2 + cfg.encoder_decoder)
                                        + (2 * cfg.n_encoder_layers + 1) * cfg.encoder_decoder)
            check(nparams == cfg.param_count() + extra_params, f"{arch}: {nparams} parameters")
            prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt), device="cuda",
                                    generator=gen)
            extra = enc_vlm_extra(cfg, gen)
            log(f"enc-vlm {arch} ({cfg.family}): {nparams} parameters, {nparams * 4 / 1e9:.2f} GB "
                f"f32, made on the card in {t_init:.2f} s ({free / 1e9:.2f} of "
                f"{total / 1e9:.2f} GB free before); {cfg.n_layers} decoder layers"
                + (f" and {cfg.n_encoder_layers} encoder layers over {cfg.encoder_len} frames"
                   if cfg.encoder_decoder else f", {cfg.prefix_embeds} image embeddings")
                + f" (cut to {cut} of {full}), {SERVE_BATCH} prompts of {prompt} tokens, "
                  f"{steps} greedy steps")
            t_first = timed(lambda: serve_and_check(model, cfg, prompts, "dense", 1, 1, 0,
                                                    extra) and None)[1]
            log(f"enc-vlm {arch}: first prefill and step (allocator and cuBLAS warm-up) "
                f"{t_first * 1e3:.1f} ms")
            runs = {}
            for mode, P in SERVE_MODES:
                cache, toks, dec, t_pre, t_dec = serve_and_check(model, cfg, prompts, mode, P,
                                                              steps, TEACHER_STEPS, extra)
                cross = sum(t.numel() * t.element_size() for t in cache.get("cross", {}).values())
                log(f"enc-vlm {arch} kv={mode} P={P}: prefill {t_pre * 1e3:.1f} ms, decode "
                    f"{steps} steps in {t_dec:.3f} s = {SERVE_BATCH * steps / t_dec:.1f} tok/s "
                    f"({t_dec / steps * 1e3:.2f} ms a step), cache {E.cache_nbytes(cache)} B "
                    f"({E.cache_nbytes(cache) / 2**20:.1f} MiB; self-attention "
                    f"{E.cache_nbytes(cache) - cross} B, cross {cross} B), sample row "
                    f"{toks[0, :8].tolist()}")
                runs[(mode, P)] = (toks, dec)
                del cache
            bf16 = {key: teacher_rel(forward_logits(model, cfg, prompts, toks, extra), dec,
                                     cfg.vocab_size) for key, (toks, dec) in runs.items()}
            f32 = dataclasses.replace(cfg, compute_dtype="float32")
            for mode, P in SERVE_MODES:
                _, toks, dec, _, _ = serve_and_check(model, f32, prompts, mode, P, TEACHER_STEPS,
                                                     TEACHER_STEPS, extra)
                rel = teacher_rel(forward_logits(model, f32, prompts, toks, extra), dec,
                                  cfg.vocab_size)
                check(max(rel) < TEACHER_TOL[mode], f"{arch} {mode} P={P}: decode vs forward {rel}")
                log(f"enc-vlm check {arch} kv={mode} P={P}: prefill and {TEACHER_STEPS} decode "
                    f"steps vs forward over the same tokens"
                    + (" (at the text positions)" if cfg.prefix_embeds else "")
                    + ", float32: max |d| / max |logit| = " + ", ".join(f"{r:.5f}" for r in rel)
                    + f" (tolerance {TEACHER_TOL[mode]}); bf16 as served (measured): "
                    + ", ".join(f"{r:.5f}" for r in bf16[(mode, P)]))
            dense_toks = runs[("dense", 1)][0]
            for (mode, P), (toks, _) in runs.items():
                if mode != "dense":
                    log(f"enc-vlm {arch} kv={mode} P={P}: greedy tokens equal to dense's: "
                        f"{float((toks == dense_toks).float().mean()):.3f}")
            del runs
            _, t_prof = timed(lambda: profile_serve(model, cfg, prompts, SERVE_MODES[:1], extra))
            peak = torch.cuda.max_memory_allocated()
            log(f"enc-vlm {arch}: peak memory allocated {peak} B ({peak / 1e9:.2f} GB of "
                f"{total / 1e9:.2f}), weights {nparams * 4 / 1e9:.2f} GB; profile {t_prof:.1f} s")
            del model, prompts, extra
            torch.cuda.empty_cache()
            train_launcher(args, cfg, train_seq, args.seed + 40 + i, ENC_VLM_WATCH[arch],
                           "enc-vlm")
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in PLANES_KERNELS + ("flash_attention",)}
    log(f"enc-vlm path launches: {counts}; by route {ops.planes_route_counts()}; flash by "
        f"shape (B, Sq, Hq, Hkv, hd, causal, window, Skv, dtype): {dict(shapes.seen)}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the enc-vlm path")
    check_vector_route("enc-vlm path", ops.planes_route_counts())
    by_row = {row: shapes.seen[shape + ("bfloat16",)] for row, shape in ENC_VLM_FLASH.items()}
    for row, n in by_row.items():
        check(n > 0, f"flash row {row} was not launched on the enc-vlm path")
    return counts, by_row


def flash_rows(gen, reps: int, table: dict, launches: dict) -> list:
    """The flash kernel timed at the shapes of ``table`` (row -> shape:
    ENC_VLM_FLASH's rows 8d-8g, DENSE_FLASH's 8m-8n), as entries of the
    kernels JSON's flash row with their max |kernel - plain| and their bf16
    launches in the phase (``launches[row]``)."""
    rows = []
    for row, shape in table.items():
        ms, plain_ms, lib_ms, bound_ms = time_flash(gen, reps, shape)
        rows.append({"row": row, "shape": list(shape), "launches": launches.get(row),
                     "max_abs_err": MAX_ERR_CASES.get(shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "operations", "library_ms": lib_ms})
    return rows


# ---------------------------------------------------------------------------
# phase 16: training of the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

# full width and depth through launch.train, with SZx checkpoints
SSM_WATCH = tuple(f"layers/0/ssm/{w}" for w in ("in", "conv", "A_log", "dt_bias", "D", "out"))
FAMILY_TRAIN_WATCH = {"mamba2-1.3b": SSM_WATCH,
                      "hymba-1.5b": SSM_WATCH + ("layers/0/attn/wq", "layers/0/mlp/wi")}
# phase 16's depth cuts (layers trained of the config's) at full width, which
# pay for phases 19d, 18f and 20:
# mamba2-1.3b 8 of its 48 layers, hymba-1.5b 8 of its 32 (18f trains it at
# full depth)
FAMILY_TRAIN_LAYERS = {"mamba2-1.3b": 8, "hymba-1.5b": 8}
# deepseek-moe-16b at full width on MOE_TRAIN_LAYERS of its 28 layers
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-moe-16b", 4
MOE_WATCH = tuple(f"layers/0/{w}" for w in ("attn/wq", "moe/router", "moe/wi", "moe/wo",
                                            "moe/shared_wi"))
TRAIN_STATE_BYTES = 16             # f32 weights, gradients and two AdamW moments a parameter


def train_moe_cut(args) -> dict:
    """deepseek-moe-16b at full width (d 2048, 64 routed experts top-6 and 2
    shared of 1408, vocab 102400, capacity factor 1.25) on MOE_TRAIN_LAYERS
    of its 28 layers (``train_steps``).  Returns the step times, the peak
    memory and the busy share."""
    import dataclasses

    import torch
    from repro_torch import configs

    full = configs.get(MOE_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    total = torch.cuda.mem_get_info()[1]
    log(f"families-train {MOE_TRAIN_ARCH}: cut to {MOE_TRAIN_LAYERS} of its {full.n_layers} "
        f"layers at full width, because the full depth's {full.param_count()} parameters need "
        f"{full.param_count() * TRAIN_STATE_BYTES / 1e9:.1f} GB of f32 weights, gradients and "
        f"AdamW moments against the card's {total / 1e9:.1f} GB; {MOE_TRAIN_LAYERS} layers have "
        f"{cfg.param_count()} ({cfg.param_count() * TRAIN_STATE_BYTES / 1e9:.1f} GB). Full "
        f"depth needs four cards (ROADMAP.md queue 1 item 12)")
    return train_steps(args, cfg, MOE_WATCH, "families-train", args.seed + 50)


def train_steps(args, cfg, watch: tuple, tag: str, seed: int) -> dict:
    """``make_train_step`` on ``cfg`` (full width, at its depth or a cut), a
    warm-up and TRAIN_STEPS plain steps of B 4 x S 2048 SyntheticLM tokens
    from --seed with per-layer remat, AdamW at TRAIN_LR; every loss finite,
    the ``watch`` leaves moved, the flash kernel twice an attention layer a
    step (forward and recompute); a profiled step.  Returns the step
    times, the peak memory and the busy share."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.train import step as step_mod

    arch = cfg.name
    check(cfg.remat, f"{arch} trains with per-layer remat")
    total = torch.cuda.mem_get_info()[1]
    opt = AdamW(lr=TRAIN_LR)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, t_init = timed(lambda: step_mod.init_state(cfg, opt, gen, device="cuda"))
    init = {n: corner(t) for n, t in pytree.leaf_paths(state["params"]) if n in watch}
    check(len(init) == len(watch), f"{arch}: watched leaves {sorted(init)}")
    nparams = sum(t.numel() for t in pytree.leaves(state["params"]))
    fn = step_mod.make_train_step(cfg, opt)
    state, m, t_warm, losses, times, before, after = warm_and_time(fn, state, ds)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), f"{arch}: losses {losses}")
    moved = moved_leaves(state["params"], init)
    check(all(v > 0 for v in moved.values()), f"{arch}: the weights did not move {moved}")
    flash = after["flash_attention"] - before["flash_attention"]
    check(flash == 2 * attention_layers(cfg) * TRAIN_STEPS,
          f"{arch}: {flash} flash launches in {TRAIN_STEPS} steps (forward + remat)")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"{tag} {arch} plain ({cfg.n_layers} layers, {nparams} parameters, "
        f"state made in {t_init:.2f} s; B {TRAIN_BATCH} x S {TRAIN_SEQ}): warm-up step "
        f"{t_warm * 1e3:.1f} ms; steps " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms ({tokens / (sum(times) / len(times)):.0f} tokens/s); loss curve "
        + ", ".join(f"{v:.4f}" for v in losses) + "; max |d w| "
        + ", ".join(f"{n} {v:.3e}" for n, v in moved.items())
        + f"; peak {peak / 1e9:.2f} GB of {total / 1e9:.2f}; flash launches {flash}")
    busy = profile_train(fn, state, train_batch(ds, TRAIN_STEPS + 1), f"{arch} plain")
    del state, m
    torch.cuda.empty_cache()
    return {"plain": times, "peak": peak, "busy": busy}


def phase_families_train(args) -> tuple:
    """Phase 16: mamba2-1.3b (8 of its 48 layers) and hymba-1.5b (8 of its
    32, FAMILY_TRAIN_LAYERS) trained at full width through
    ``launch.train.run`` (B 4 x S 2048, 3 steps, SZx checkpoints
    restored on the card within their bound, a compressed P = 1 step, a
    profiled step), then deepseek-moe-16b at full width on 4 layers
    (``train_moe_cut``).  Launch counters are zeroed before each model and
    read after it; the flash launches are also counted by shape.  Returns
    the phase's launch counts, each model's flash launches and its
    results."""
    import dataclasses
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops

    gc.collect()
    counts, flash, results = {}, {}, {}

    def add(arch, wanted):
        got = ops.launch_counts()
        log(f"families-train {arch} launches: "
            + str({k: v for k, v in got.items() if v}) + f"; planes by route "
            + str(ops.planes_route_counts()))
        for k in wanted:
            check(got[k] > 0, f"kernel {k} was not launched training {arch}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        flash[arch] = got["flash_attention"]

    with FlashShapes() as shapes:
        for i, (arch, watch) in enumerate(FAMILY_TRAIN_WATCH.items()):
            cfg = configs.get(arch)
            if arch in FAMILY_TRAIN_LAYERS:
                cfg = dataclasses.replace(cfg, n_layers=FAMILY_TRAIN_LAYERS[arch])
            ops.reset_launch_counts()
            torch.cuda.empty_cache()
            results[arch] = train_launcher(args, cfg, TRAIN_SEQ, args.seed + 60 + i, watch,
                                           "families-train", ckpt_compress=True)
            add(arch, ("encode", "decode_body") + PLANES_KERNELS
                + (("flash_attention",) if prefill_flash(cfg) else ()))
        ops.reset_launch_counts()
        results[MOE_TRAIN_ARCH] = train_moe_cut(args)
        add(MOE_TRAIN_ARCH, ("flash_attention",))
    log(f"families-train flash by shape (B, Sq, Hq, Hkv, hd, causal, window, Skv, dtype): "
        f"{dict(shapes.seen)}")
    for arch, shape in FAMILY_FLASH.items():
        n = shapes.seen[shape + (shape[1], "bfloat16")]
        check(n > 0, f"families-train: no flash launch at {arch}'s shape {shape}")
    return {k: v for k, v in counts.items() if v}, flash, results


# ---------------------------------------------------------------------------
# phase 17: the examples
# ---------------------------------------------------------------------------

# example -> (the flags beside its defaults, the kernels it must launch)
EXAMPLES = {
    "quickstart_torch": ((), ("encode", "decode_body", "unpack")),
    "compress_checkpoint_torch": ((), ("encode", "decode_body")),
    "serve_lm_torch": ((), ("flash_attention",) + PLANES_KERNELS),
    # its checkpoints under CKPT_DIR, removed after
    "train_lm_torch": (("--ckpt", str(CKPT_DIR / "train_lm_torch")),
                       ("flash_attention", "encode")),
}


def phase_examples() -> dict:
    """Phase 17: each of ``examples/*_torch.py`` run through its ``main`` on
    the card at its defaults (train_lm_torch's checkpoints under CKPT_DIR);
    each checks its own results (error bounds, finite logits, a falling
    loss) and must return cleanly.  Launch counters are zeroed before each
    and read after it.  Returns the phase's launch counts."""
    import importlib.util
    import shutil

    import torch
    from repro_torch.kernels import ops

    counts = {}
    for name, (argv, wanted) in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        shutil.rmtree(CKPT_DIR / name, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            _, t = timed(lambda: mod.main(list(argv)))
        finally:
            shutil.rmtree(CKPT_DIR / name, ignore_errors=True)
        got = {k: v for k, v in ops.launch_counts().items() if v}
        log(f"example {name}: main returned in {t:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {got}")
        for k in wanted:
            check(got.get(k, 0) > 0, f"example {name} did not launch {k}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    return counts


# ---------------------------------------------------------------------------
# phase 18: sharding on a device mesh, sharded checkpoints, the dry-run
# ---------------------------------------------------------------------------

# phase 16's deepseek-moe-16b plain steps, on an H100 80GB HBM3 at 700 W (PERF.md)
PHASE16_MOE_PEAK_GB = 50.33
SHARD_CKPT_DIR = CKPT_DIR / "sharded"
SMOKE_DRYRUN_DIR = ROOT / "_smoke_dryrun"     # 18e's records; removed after
DRYRUN_CELLS = (("deepseek-moe-16b", "train_4k", False, 0),   # (arch, shape, multi_pod, P)
                ("llama3.2-1b", "train_4k", True, 1),
                ("mamba2-1.3b", "train_4k", False, 0),
                ("hymba-1.5b", "train_4k", False, 0),
                ("whisper-medium", "train_4k", False, 0),
                ("internvl2-1b", "train_4k", False, 0))
# the same cells traced on fake CUDA tensors by the step before each family
# trained tensor-parallel, which gathered every parameter whole and ran the
# whole model on each 'model' rank: (flops a device, useful_flops_ratio)
# (PERF.md section 6)
DRYRUN_PARENT = {("deepseek-moe-16b", False): (1730096578691072.0, 0.04020907627361635),
                 ("llama3.2-1b", True): (353634722250752.0, 0.042939383266332266),
                 ("mamba2-1.3b", False): (704031039160320.0, 0.05048703016334188),
                 ("hymba-1.5b", False): (930251261607936.0, 0.04335221380768505),
                 ("whisper-medium", False): (471380436975616.0, 0.05278272833162793),
                 ("internvl2-1b", False): (325665710669824.0, 0.03725892319115537)}
DRYRUN_TIMEOUT_S = 600
# 18f: arch -> decoder layers (None: full depth; an encoder-decoder's
# encoder cut the same), tokens a row (internvl2-1b's 256 image embeddings
# before them make 2048 positions)
FAMILY_SHARDED_TRAIN = {"mamba2-1.3b": (8, 2048), "hymba-1.5b": (None, 2048),
                        "whisper-medium": (6, 2048), "internvl2-1b": (8, 1792)}


def one_member_mesh(names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cuda", (1,) * len(names), mesh_dim_names=names)


def shard_runs(cfg, opt, ds, mesh, seed: int, *, P: int = 0, watch=(), init=None,
               extras=None):
    """TRAIN_STEPS steps (B 4 x S 2048 from ``ds``, with ``extras[s]``'s
    stub frames or image embeddings) from ``seed``'s state: plain (``mesh``
    None) or sharded on ``mesh``; the initial corners of the ``watch``
    leaves go into ``init``.  Returns (state, losses, step seconds)."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.train import step as step_mod

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if mesh is None:
        state = step_mod.init_state(cfg, opt, gen, device="cuda")
    else:
        state = step_mod.init_sharded_state(cfg, opt, gen, mesh, ef_planes=P, device="cuda")
    if watch:
        leaves = dict(pytree.leaf_paths(state["params"]))
        init.update({n: corner(local(leaves[n])) for n in watch})
    fn = step_mod.make_train_step(cfg, opt, mesh=mesh, compress_planes=P)
    losses, times = [], []
    for s in range(TRAIN_STEPS):
        batch = {**train_batch(ds, s), **(extras[s] if extras else {})}
        (state, m), t = timed(lambda: fn(state, batch))
        losses.append(float(m["loss"]))
        times.append(t)
    return state, losses, times


def flat_params(state):
    """The parameters' local tensors: the whole leaves on a one-member mesh."""
    from repro_torch.core import pytree

    return [local(p) for p in pytree.leaves(state["params"])]


def max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def attention_layers(cfg) -> int:
    """The attention layers of a forward: each decoder layer's
    self-attention (none in the SSM), and an encoder-decoder's encoder
    layers and cross-attentions."""
    from repro_torch.models import transformer as T

    n = cfg.n_layers if T.has_attention(cfg) else 0
    return n + (cfg.n_encoder_layers + cfg.n_layers if cfg.encoder_decoder else 0)


def against_plain(tag, cfg, ds, seed: int, opt, watch=(), extras=None):
    """TRAIN_STEPS steps of ``cfg`` from ``seed``, deterministic algorithms
    on: the plain step twice (runs A and B), then the sharded step on a
    (1, 1) data x model mesh.  Where A and B agree bit for bit the sharded
    parameters and losses must equal A's; else lie within A's spread to B.
    The flash kernel runs twice an attention layer a step (forward and
    remat).  Returns the sharded state, the mesh and what to log; ``watch``
    names leaves whose corner must move from its initial value."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.kernels import flash_attention as fa

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, loss_a, t_a = shard_runs(cfg, opt, ds, None, seed, extras=extras)
        ref = [p.clone() for p in flat_params(state)]
        del state
        torch.cuda.empty_cache()
        state, loss_b, t_b = shard_runs(cfg, opt, ds, None, seed, extras=extras)
        spread = max_diff(flat_params(state), ref)
        loss_spread = max(abs(x - y) for x, y in zip(loss_a, loss_b))
        del state
        torch.cuda.empty_cache()
        mesh = one_member_mesh(("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        flash0 = fa.LAUNCHES
        init = {}
        state, loss_s, t_s = shard_runs(cfg, opt, ds, mesh, seed, watch=watch, init=init,
                                        extras=extras)
        flash = fa.LAUNCHES - flash0
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max_diff(flat_params(state), ref)
    loss_diff = max(abs(x - y) for x, y in zip(loss_s, loss_a))
    del ref
    if spread == 0 and loss_spread == 0:
        verdict = "bit for bit (the plain step repeats itself)"
        check(diff == 0 and loss_diff == 0,
              f"{tag}: the sharded step differs from the plain step by {diff:.3e} "
              f"(losses {loss_diff:.3e}) where the plain step repeats itself bit for bit")
    else:
        verdict = (f"within the plain step's own run-to-run spread (parameters "
                   f"{spread:.3e}, losses {loss_spread:.3e})")
        check(diff <= spread and loss_diff <= loss_spread,
              f"{tag}: sharded vs plain {diff:.3e} (losses {loss_diff:.3e}) outside the plain "
              f"step's run-to-run spread {spread:.3e} ({loss_spread:.3e})")
    check(all(math.isfinite(v) for v in loss_s), f"{tag}: losses {loss_s}")
    check(flash == 2 * attention_layers(cfg) * TRAIN_STEPS,
          f"{tag}: {flash} flash launches in {TRAIN_STEPS} sharded steps (forward + remat)")
    leaves = dict(pytree.leaf_paths(state["params"]))
    moved = {n: float((corner(local(leaves[n])) - c).abs().max()) for n, c in init.items()}
    check(all(v > 0 for v in moved.values()), f"{tag}: the watched leaves did not move {moved}")
    b, seq = train_batch(ds, 0)["tokens"].shape
    tokens = b * seq
    text = (f"tensor-parallel step, B {b} x S {seq}, deterministic algorithms on: "
            "sharded steps " + ", ".join(f"{t * 1e3:.1f}" for t in t_s) + " ms; plain run A "
            + ", ".join(f"{t * 1e3:.1f}" for t in t_a) + " ms, run B "
            + ", ".join(f"{t * 1e3:.1f}" for t in t_b) + " ms (first step of each warms up; "
            f"{tokens / (sum(t_s[1:]) / len(t_s[1:])):.0f} tokens/s sharded); losses "
            + ", ".join(f"{v:.6f}" for v in loss_s) + f"; max |sharded - plain| {diff:.3e}, "
            f"plain A vs B {spread:.3e}: {verdict}; flash launches {flash}; peak "
            f"{peak / 1e9:.2f} GB")
    if moved:
        text += "; max |d w| " + ", ".join(f"{n} {v:.3e}" for n, v in moved.items())
    return state, mesh, text


def sharded_llama(args, opt):
    """18a: llama3.2-1b through the sharded step on a (1, 1) data x model
    mesh against two runs of the plain step from the same seed; returns the
    sharded state (for 18d) and the mesh."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM

    cfg = configs.get(TRAIN_ARCH)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    state, mesh, text = against_plain("18a", cfg, ds, args.seed + 80, opt)
    log(f"sharding 18a {TRAIN_ARCH} on a (1, 1) data x model mesh, {text}")
    return state, mesh


def sharded_moe(args, opt):
    """18b: deepseek-moe-16b at full width on MOE_TRAIN_LAYERS layers
    through the sharded step (its config's fsdp, ``_moe_rule`` on the
    experts) on a (1, 1) mesh against two runs of the plain step, as 18a:
    the experts moved; the peak beside phase 16's."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)
    check(cfg.fsdp, f"{MOE_TRAIN_ARCH} is configured with fsdp")
    specs = mesh_lib.param_specs_tree(cfg, T.param_specs(cfg), one_member_mesh(("data", "model")))
    wi = specs["layers"][0]["moe"]["wi"]
    check(tuple(wi) == ("model", "data", None), f"18b: moe/wi spec {wi}")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    torch.cuda.empty_cache()
    state, _mesh, text = against_plain("18b", cfg, ds, args.seed + 81, opt,
                                       watch=("layers/0/moe/wi", "layers/0/moe/wo"))
    log(f"sharding 18b {MOE_TRAIN_ARCH} at full width on {MOE_TRAIN_LAYERS} layers, sharded "
        f"(fsdp, moe/wi {tuple(wi)}) on a (1, 1) mesh, {text} (phase 16's plain peak "
        f"{PHASE16_MOE_PEAK_GB} GB)")
    del state
    torch.cuda.empty_cache()


def sharded_compressed(args, opt):
    """18c: the compressed sharded step at P = 1 on a (1, 1, 1) pod x data x
    model mesh for llama3.2-1b: the planes kernels on the vector route, the
    loss finite."""
    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops

    cfg = configs.get(TRAIN_ARCH)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    mesh = one_member_mesh(("pod", "data", "model"))
    routes0, counts0 = ops.planes_route_counts(), ops.launch_counts()
    state, losses, times = shard_runs(cfg, opt, ds, mesh, args.seed + 82, P=1)
    counts = {k: v - counts0[k] for k, v in ops.launch_counts().items()}
    check(all(math.isfinite(v) for v in losses), f"18c: losses {losses}")
    for k in PLANES_KERNELS:
        check(counts[k] > 0, f"18c: {k} not launched by the compressed sharded step")
    check_vector_route("sharding 18c", {k: v - routes0[k]
                                        for k, v in ops.planes_route_counts().items()})
    log(f"sharding 18c {TRAIN_ARCH} compressed P = 1 on a (1, 1, 1) pod x data x model mesh: "
        f"steps " + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms; losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; planes launches "
        f"{counts['planes_encode']} / {counts['planes_decode']}")
    del state
    torch.cuda.empty_cache()


def sharded_family_steps(args, opt) -> None:
    """18f: FAMILY_SHARDED_TRAIN's models at full width (remat on, as their
    configs train) through the sharded step, tensor-parallel along 'model',
    on a (1, 1) mesh against two runs of the plain step from the same seed,
    as 18a; whisper-medium's 1500 stub frames and internvl2-1b's 256 stub
    image embeddings drawn once a step from the seed, the same in each
    run."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM

    for i, (arch, (layers, seq)) in enumerate(FAMILY_SHARDED_TRAIN.items()):
        cfg = configs.get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=(
                layers if cfg.encoder_decoder else 0))
        ds = SyntheticLM(DataConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=args.seed))
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 84 + i)
        extras = ([enc_vlm_extra(cfg, gen) for _ in range(TRAIN_STEPS)]
                  if cfg.encoder_decoder or cfg.prefix_embeds else None)
        torch.cuda.empty_cache()
        state, _mesh, text = against_plain("18f", cfg, ds, args.seed + 84 + i, opt,
                                           extras=extras)
        depth = "full depth" if layers is None else (
            f"cut to {layers} of {configs.get(arch).n_layers} layers"
            + (" in the encoder and the decoder" if cfg.encoder_decoder else ""))
        inputs = ("" if extras is None else
                  f", {cfg.encoder_len} stub frames" if cfg.encoder_decoder else
                  f", {cfg.prefix_embeds} stub image embeddings before the tokens")
        log(f"sharding 18f {arch} ({depth}) at full width on a (1, 1) mesh{inputs}, {text}")
        del state, extras
        torch.cuda.empty_cache()


def sharded_checkpoint(cfg, state, mesh):
    """18d: 18a's sharded state (params and AdamW moments) through
    ``CheckpointManager.save(mesh=)`` (``compress_tree_sharded`` along
    'data', SZx rel 1e-6), restored by ``decompress_tree`` and by
    ``restore(shardings=)`` onto the mesh: every float leaf within its
    bound, the rest bit for bit; the save's and both restores' encode and
    decode_body launches counted."""
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.core.codec import Bound, SZxCodec, plan
    from repro_torch.core.codec.tree import TreeCodec
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import step as step_mod

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    leaves = {n: whole(t) for n, t in pytree.leaf_paths(state)}
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    bounds = {n: plan.resolve_error_bound(t, Bound.rel(1e-6)) for n, t in leaves.items()
              if t.is_floating_point() and t.numel() >= 1024}

    def held(restored: dict, how: str) -> float:
        worst = 0.0
        for n, a in leaves.items():
            b = whole(restored[n])
            if n in bounds:
                err = float((a.float() - b.float()).abs().max())
                check(err <= bounds[n], f"18d {how}: {n} off by {err:.3e} > {bounds[n]:.3e}")
                worst = max(worst, err / bounds[n])
            else:
                check(same_bits(a, b), f"18d {how}: {n} not restored bit for bit")
        return worst

    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    ck = CheckpointManager(str(SHARD_CKPT_DIR), compress=True, device="cuda")
    c0 = ops.launch_counts()
    man, t_save = timed(lambda: ck.save(TRAIN_STEPS, state, mesh=mesh))
    c1 = ops.launch_counts()
    with open(SHARD_CKPT_DIR / f"step_{TRAIN_STEPS:09d}" / "tree.szt", "rb") as f:
        flat, t_flat = timed(lambda: TreeCodec(codec=SZxCodec(device="cuda"))
                             .decompress_tree(f, select=list(leaves)))
    w_flat = held(flat, "decompress_tree")
    del flat
    torch.cuda.empty_cache()
    c2 = ops.launch_counts()
    shardings = pytree.tree_map(lambda spec: mesh_lib.NamedSharding(mesh, spec),
                                step_mod.state_specs(cfg, state, mesh))
    (restored, step), t_restore = timed(lambda: ck.restore(state, shardings=shardings))
    c3 = ops.launch_counts()
    check(step == TRAIN_STEPS and all(hasattr(t, "placements")
                                      for t in pytree.leaves(restored)),
          "18d: restore(shardings=) gave no DTensors")
    w_sharded = held(dict(pytree.leaf_paths(restored)), "restore(shardings=)")
    del restored
    torch.cuda.empty_cache()
    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    launches = {"save": {k: c1[k] - c0[k] for k in ("encode", "decode_body")},
                "decompress_tree": {k: c2[k] - c1[k] for k in ("encode", "decode_body")},
                "restore": {k: c3[k] - c2[k] for k in ("encode", "decode_body")}}
    check(launches["save"]["encode"] > 0 and launches["decompress_tree"]["decode_body"] > 0
          and launches["restore"]["decode_body"] > 0, f"18d: launches {launches}")
    log(f"sharding 18d: the {nbytes / 1e9:.2f} GB state of 18a through save(mesh=) along "
        f"'data' in {t_save:.1f} s ({man['stored_bytes'] / 1e9:.2f} GB stored, "
        f"{len(man['frames'])} frames), decompress_tree in {t_flat:.1f} s, restore(shardings=) "
        f"in {t_restore:.1f} s; worst error / bound {w_flat:.3f} and {w_sharded:.3f}; "
        f"launches {launches}")


def train_dryrun_cells() -> list:
    """18e's cells, (arch, shape, multi_pod, P, kv_mode, serve_layout): the
    train_4k cells of DRYRUN_CELLS and the long_500k decode cells of
    LONG_DRYRUN_CELLS under LONG_CONTEXT_RULES."""
    return [cell + ("dense", False) for cell in DRYRUN_CELLS] + [
        (arch, "long_500k", False, 0, mode, False) for arch, mode in LONG_DRYRUN_CELLS]


def serve_dryrun_cells() -> list:
    """19c's cells, as ``train_dryrun_cells``'s: SERVE_DRYRUN_CELLS."""
    return [(arch, shape, False, 0, mode, layout)
            for arch, shape, mode, layout in SERVE_DRYRUN_CELLS]


def start_dryrun_cells(out_dir, cells) -> list:
    """One ``python -m repro_torch.launch.dryrun`` process a cell of
    ``cells`` (fake CUDA tensors on (16, 16), or (2, 16, 16) for a
    multi-pod cell), at the lowest CPU priority, each writing its record
    under ``out_dir``; they run beside the card's work.  Returns [(cell,
    process, start time)]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = []
    for cell in cells:
        arch, shape, multi_pod, P, mode, layout = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--kv-mode", mode, "--out", str(out_dir)]
        if multi_pod:
            cmd.append("--multi-pod")
        if P:
            cmd += ["--grad-compress", str(P)]
        if layout:
            cmd.append("--serve-layout")
        procs.append((cell, subprocess.Popen(
            cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, preexec_fn=lambda: os.nice(19)), time.perf_counter()))
    return procs


def finish_dryrun_cells(procs, out_dir):
    """18e and 19c: each cell's record (its process waited for, killed past
    DRYRUN_TIMEOUT_S from its start) on a line with its wall time: a train
    cell's beside its parent's flops a device, which a tensor-parallel rank
    must halve, a decode cell's with its floor fraction; then, where a
    train cell ran, deepseek-moe-16b's exact state bytes a card on a (4, 1)
    mesh from the specs.  ``out_dir`` is removed after."""
    import types

    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import analysis
    from repro_torch.train import step as step_mod

    try:
        for (arch, shape, multi_pod, P, mode, layout), proc, t0 in procs:
            try:
                text, _ = proc.communicate(timeout=max(
                    DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            t = time.perf_counter() - t0
            name = f"{arch}.{shape}.{'multi' if multi_pod else 'single'}" + (
                f".{mode}" if mode != "dense" else "") + (f".gc{P}" if P else "") + (
                ".serve_layout" if layout else "") + ".json"
            path = out_dir / name
            check(proc.returncode == 0 and path.exists(),
                  f"dry-run {arch} {shape} {mode} exited {proc.returncode}: {text[-2000:]}")
            if not path.exists():
                continue
            rec = json.loads(path.read_text())
            check(rec["status"] == "OK", f"dry-run {arch} {shape} {mode}: {rec}")
            rl = rec["roofline"]
            if shape in ("prefill_32k", "decode_32k"):
                check(shape != "decode_32k" or "floor_fraction" in rl,
                      f"19c: {arch} {shape}: no floor fraction")
                log(f"sharded serve 19c dry-run {arch} {shape} kv={mode} serve_layout={layout} "
                    f"mesh {rec['mesh']}: wall {rec['wall_s']} s in its process, read {t:.1f} s "
                    f"after its start; " + json.dumps(rec))
                continue
            if shape == "long_500k":
                check("floor_fraction" in rl, f"18e: {arch} long_500k {mode}: no floor fraction")
                log(f"sharding 18e dry-run {arch} long_500k kv={mode} mesh {rec['mesh']} under "
                    f"LONG_CONTEXT_RULES: ideal_bytes_per_device "
                    f"{rec['ideal_bytes_per_device']:.6g}, floor_fraction "
                    f"{rl.get('floor_fraction', 0):.6f}, bottleneck {rl['bottleneck']}; wall "
                    f"{rec['wall_s']} s, read {t:.1f} s after its start; " + json.dumps(rec))
                continue
            flops, useful = DRYRUN_PARENT[(arch, multi_pod)]
            log(f"sharding 18e dry-run {arch} {shape} mesh {rec['mesh']} grad_compress {P}: "
                f"flops_per_device {rl['flops_per_device']:.6g} (parent {flops:.6g}), "
                f"useful_flops_ratio {rl['useful_flops_ratio']:.6f} (parent {useful:.6f})")
            # a tensor-parallel rank runs its share of the model, not all of it
            check(rl["flops_per_device"] < flops / 2,
                  f"18e: {arch} runs {rl['flops_per_device']:.6g} flops a device, the parent's "
                  f"redundant step {flops:.6g}")
            log(f"sharding 18e dry-run {arch} {shape} mesh {rec['mesh']} grad_compress {P}: "
                f"wall {rec['wall_s']} s in its process beside 18a-18f, read {t:.1f} s after "
                f"its start; " + json.dumps(rec))
    finally:
        for _cell, proc, _t0 in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    if not any(cell[1] == "train_4k" for cell, _p, _t in procs):
        return
    cfg = configs.get(MOE_TRAIN_ARCH)
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1))
    template = step_mod.state_template(cfg)
    state = analysis.sharded_bytes_per_device(template, step_mod.state_specs(cfg, template, pm),
                                              pm)
    grads = analysis.sharded_bytes_per_device(
        template["params"], mesh_lib.param_specs_tree(cfg, template["params"], pm), pm)
    total = torch.cuda.mem_get_info()[1]
    log(f"sharding 18e: {MOE_TRAIN_ARCH} at full depth ({cfg.n_layers} layers) on a (4, 1) "
        f"data x model mesh with fsdp, from the specs: weights and AdamW moments "
        f"{state / 1e9:.2f} GB a card, {(state + grads) / 1e9:.2f} GB with the gradients, "
        f"beside this card's {total / 1e9:.2f} GB")


def phase_sharding(args, dryrun: bool = True) -> dict:
    """Phase 18 (``--sharding`` runs it alone): 18e's dry-run processes
    started, 18a-18d and 18f in a one-rank NCCL group on one-member meshes,
    then 18e's records read (without ``dryrun`` the caller starts and reads
    them).  Launch counters are zeroed before and read after: the flash,
    planes, encode and decode_body kernels must each have run.  Returns the
    launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW

    opt = AdamW(lr=TRAIN_LR)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    if not dryrun:
        return sharded_steps(args, opt)
    shutil.rmtree(SMOKE_DRYRUN_DIR, ignore_errors=True)
    dry = start_dryrun_cells(SMOKE_DRYRUN_DIR, train_dryrun_cells())
    try:
        counts = sharded_steps(args, opt)
    finally:
        finish_dryrun_cells(dry, SMOKE_DRYRUN_DIR)
    return counts


def sharded_steps(args, opt) -> dict:
    """Phase 18's card work, 18a-18d and 18f, in a one-rank NCCL group;
    returns the launch counts."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import ops

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        state, mesh = sharded_llama(args, opt)
        try:
            sharded_checkpoint(configs.get(TRAIN_ARCH), state, mesh)
        finally:
            import shutil

            shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
        del state
        torch.cuda.empty_cache()
        sharded_moe(args, opt)
        sharded_compressed(args, opt)
        sharded_family_steps(args, opt)
    finally:
        dist.destroy_process_group()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    log(f"phase 18 launches: {counts}; planes by route {ops.planes_route_counts()}")
    for k in ("flash_attention", "encode", "decode_body") + PLANES_KERNELS:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched on the sharded path")
    return counts


# ---------------------------------------------------------------------------
# phase 19: serving under a device mesh
# ---------------------------------------------------------------------------

SHARDED_SERVE_STEPS = 16           # 19a's decode steps
MOE_SERVE_STEPS = 8                # 19b's
# decode logits under rules vs the unsharded engine's, a share of the largest
# logit: the scores are rounded to bf16 before their (here one-member) sum,
# so the bf16 run is held loosely (19a) or only reported (19b, whose top-k can
# flip on a rounded score); with the scores summed in float32 a one-member
# mesh runs the unsharded engine's ops, and both are held tightly
SHARDED_DECODE_TOL = 0.05
SHARDED_DECODE_F32_TOL = 1e-5
SHARDED_TIMED_STEPS = 17           # 19a's ABBA timing: steps a run, the first dropped
SHARDED_TIMED_ROUNDS = 2
SERVE_DRYRUN_CELLS = (("llama3.2-1b", "prefill_32k", "dense", False),   # (arch, shape,
                      ("llama3.2-1b", "decode_32k", "dense", False),    #  kv_mode,
                      ("llama3.2-1b", "decode_32k", "compressed", False),   # serve_layout)
                      ("deepseek-moe-16b", "decode_32k", "dense", True),
                      ("arctic-480b", "decode_32k", "dense", False),
                      ("mamba2-1.3b", "decode_32k", "dense", False),
                      ("hymba-1.5b", "decode_32k", "compressed", False),
                      ("whisper-medium", "prefill_32k", "dense", False))
# 19d: the SSM, hybrid, audio and VLM families served on (1, 1) meshes at full
# width: (layers served, or None for the config's full depth; prompt tokens;
# the bf16-score decode's tolerance, or None where it is reported and not
# held).  Each is cut (mamba2-1.3b 12 of 48 layers, hymba-1.5b 16 of 32,
# whisper-medium 6 + 6 of 24 + 24, internvl2-1b 8 of 24) to pay for the phases
# in the script's time limit; phase 20 serves hymba-1.5b at full depth.
# hymba-1.5b's 32 random-weight layers carry the bf16 rounding of its scores
# to 0.04-0.11 of the largest logit in 8 steps on an H100 (PERF.md), as its
# own bf16 serving moves by up to half of it (phase 14): its bf16 run is
# reported, and its float32-score run held, as 19b's are
FAMILY_SHARDED_SERVE = {"mamba2-1.3b": (12, 2048, SHARDED_DECODE_TOL),
                        "hymba-1.5b": (16, 2048, None),
                        "whisper-medium": (6, 384, SHARDED_DECODE_TOL),
                        "internvl2-1b": (8, 1792, SHARDED_DECODE_TOL)}
FAMILY_SHARDED_STEPS = 8


def local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def serve_teacher(params, cfg, prompts, mode: str, P: int, steps: int, toks=None, counts=None,
                  extra=None):
    """A prefill of ``prompts`` (with ``extra``: stub frames or image
    embeddings) and ``steps`` decode steps, each on a column of ``toks``
    (the unsharded run's greedy tokens) or greedy without them.  Returns
    (prefill logits, the cache slabs after the prefill (clones; the cross
    K/V as ``cross_k``/``cross_v``), the decode logits (steps, B, V) in
    float32, the generated tokens, prefill s, decode s a step).  With
    ``counts`` the launch counters are set to 0 before the run and its
    launches added to ``counts`` after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E

    if counts is not None:
        ops.reset_launch_counts()
    extra = extra or {}
    seq = prompts.shape[1] + steps + (cfg.prefix_embeds if "image_embeds" in extra else 0)
    (cache, logits), t_pre = timed(lambda: E.prefill(
        params, cfg, prompts, seq_len=seq, kv_mode=mode, num_planes=P, **extra))
    pre = local(logits).clone()
    slabs = {k: local(v).clone() for k, v in cache["layers"].items()}
    slabs.update({"cross_" + k: local(v).clone() for k, v in cache.get("cross", {}).items()})
    tok = torch.argmax(pre[:, -1:], -1) if toks is None else toks[:, :1]
    out, gen, times = [], [], []
    for i in range(steps):
        gen.append(tok)
        (logits, cache), t = timed(lambda: E.decode_step(params, cfg, cache, tok, kv_mode=mode,
                                                         num_planes=P))
        times.append(t)
        lg = local(logits)[:, -1].float()
        out.append(lg)
        tok = torch.argmax(lg, -1)[:, None] if toks is None or i + 1 == steps else \
            toks[:, i + 1:i + 2]
    if counts is not None:
        for k, v in ops.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
    del cache
    return pre, slabs, torch.stack(out), torch.cat(gen, dim=1), t_pre, times


def same_prefill(a, b) -> bool:
    """Logits and every cache slab bit for bit."""
    return same_bits(a[0], b[0]) and a[1].keys() == b[1].keys() and all(
        same_bits(a[1][k], b[1][k]) for k in a[1])


def prefill_spread(a, b) -> float:
    return max([float((a[0] - b[0]).abs().max())] + [
        float((a[1][k].float() - b[1][k].float()).abs().max()) for k in a[1]])


def sharded_vs_plain(tag, model, cfg, prompts, steps, rules_specs, counts, decode_tol=None,
                     extra=None):
    """One model's unsharded runs (twice, to see whether the prefill
    repeats itself) and its sharded runs on a (1, 1) mesh for each (mode,
    P, rules name, rules, spec function) of ``rules_specs`` against them;
    prints the times.  The sharded decode runs twice: as it is (the scores
    rounded to bf16 under rules; its logits held to ``decode_tol`` where it
    is given, else reported) and with ``engine._reduce_scores`` summing the
    scores in float32, whose logits are held to SHARDED_DECODE_F32_TOL.
    Only the first sharded run's launches are counted.  ``extra`` (stub
    frames or image embeddings) goes to every prefill.  Returns the last
    run's mesh and parameters."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding as SH, transformer as T
    from repro_torch.serve import engine as E

    mesh = one_member_mesh(("data", "model"))
    tree = T.param_tree(model)
    vocab = cfg.vocab_size
    bf16_reduce = E._reduce_scores
    for mode, P, name, rules, specs_of in rules_specs:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a = serve_teacher(model, cfg, prompts, mode, P, steps, extra=extra)
            b = serve_teacher(model, cfg, prompts, mode, P, steps, a[3], extra=extra)
            params = mesh_lib.shard_tree(tree, specs_of(cfg, tree, mesh), mesh)
            with SH.use_rules(mesh, rules):
                sh = serve_teacher(params, cfg, prompts, mode, P, steps, a[3], counts, extra)
                E._reduce_scores = lambda s, dims=(): SH.all_reduce(s, dims)  # noqa: E731
                try:
                    f32 = serve_teacher(params, cfg, prompts, mode, P, steps, a[3], extra=extra)
                finally:
                    E._reduce_scores = bf16_reduce
        finally:
            torch.use_deterministic_algorithms(False)
        spread = prefill_spread(a, b)
        if spread == 0:
            verdict = "bit for bit (the unsharded prefill repeats itself)"
            check(same_prefill(sh, a), f"{tag} {mode} P={P} {name}: the sharded prefill differs "
                  f"from the unsharded one by {prefill_spread(sh, a):.3e}")
        else:
            verdict = f"within the unsharded prefill's own run-to-run spread {spread:.3e}"
            check(prefill_spread(sh, a) <= spread, f"{tag} {mode} P={P} {name}: sharded prefill "
                  f"{prefill_spread(sh, a):.3e} outside the spread {spread:.3e}")

        def rel(run):
            return teacher_rel(b[2][:, :, :vocab].transpose(0, 1),
                               run[2][:, :, :vocab].transpose(0, 1), vocab)

        r16, r32 = rel(sh), rel(f32)
        check(all(math.isfinite(r) for r in r16) and max(r16) <= (decode_tol or math.inf),
              f"{tag} {mode} P={P} {name}: sharded decode vs unsharded {r16}")
        check(max(r32) <= SHARDED_DECODE_F32_TOL, f"{tag} {mode} P={P} {name}: sharded decode "
              f"with float32 scores vs unsharded {r32}")
        mean = lambda ts: sum(ts[1:]) / len(ts[1:])   # noqa: E731  (the first step warms up)
        log(f"{tag} {cfg.name} ({cfg.n_layers} layers) kv={mode} P={P} under {name} on a (1, 1) "
            f"mesh: prefill {sh[4] * 1e3:.1f} ms sharded, {a[4] * 1e3:.1f} / {b[4] * 1e3:.1f} ms "
            f"unsharded; decode {mean(sh[5]) * 1e3:.2f} ms a step sharded, "
            f"{mean(a[5]) * 1e3:.2f} / {mean(b[5]) * 1e3:.2f} unsharded ({len(sh[5])} steps, "
            f"host clock, synchronized); prefill logits and cache {verdict}; decode logits vs "
            f"the unsharded engine's on its tokens, max |d| / max |logit|, bf16 scores "
            + ", ".join(f"{r:.5f}" for r in r16)
            + (f" (tolerance {decode_tol})" if decode_tol else " (reported, not held)")
            + f"; float32 scores max {max(r32):.3e} (tolerance {SHARDED_DECODE_F32_TOL})")
        del a, b, sh, f32
        torch.cuda.empty_cache()
    return mesh, params


def sharded_busy(model, params, cfg, prompts, mesh) -> None:
    """The device's busy share and kernel launches of PROFILE_STEPS decode
    steps (dense cache), unsharded and sharded in turns (torch.profiler,
    the card's activity only, as profile_serve reads it); then the host
    clock of SHARDED_TIMED_STEPS decode steps a run, each synchronized, in
    SHARDED_TIMED_ROUNDS rounds alternating unsharded and sharded (ABBA),
    medians and quartiles a side."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import sharding as SH
    from repro_torch.serve import engine as E

    def run(p, rules, n, traced):
        with SH.use_rules(mesh, rules) if rules is not False else contextlib.nullcontext():
            cache, logits = E.prefill(p, cfg, prompts, seq_len=prompts.shape[1] + n)
            tok = torch.argmax(local(logits)[:, -1:], -1)
            torch.cuda.synchronize()
            times = []
            with profile(activities=[ProfilerActivity.CUDA]) if traced else \
                    contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    t1 = time.perf_counter()
                    logits, cache = E.decode_step(p, cfg, cache, tok)
                    tok = torch.argmax(local(logits), -1)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t1)
                wall = time.perf_counter() - t0
        return prof, wall, times

    def busy(p, rules):
        prof, wall, _ = run(p, rules, PROFILE_STEPS, True)
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in evs) / 1e6
        share = f"{100 * dev / wall:.1f}%" if dev else "not measured: no device events"
        return (f"wall {wall * 1e3:.1f} ms, device busy {dev * 1e3:.1f} ms ({share}), "
                f"{sum(e.count for e in evs)} kernel launches")

    sides = (("unsharded", model, False), ("sharded", params, None))
    for name, p, rules in sides + sides[::-1]:
        log(f"sharded serve 19a profile {cfg.name} dense, {PROFILE_STEPS} {name} decode steps: "
            + busy(p, rules))
    got = {"unsharded": [], "sharded": []}
    for r in range(SHARDED_TIMED_ROUNDS):
        for name, p, rules in (sides if r % 2 == 0 else sides[::-1]):
            got[name] += run(p, rules, SHARDED_TIMED_STEPS, False)[2][1:]   # the first warms up
    quart = {k: statistics.quantiles([t * 1e3 for t in v], n=4) for k, v in got.items()}
    log(f"sharded serve 19a timed {cfg.name} dense, {SHARDED_TIMED_ROUNDS} rounds ABBA of "
        f"{SHARDED_TIMED_STEPS} decode steps (the first of each dropped), host clock, each step "
        f"synchronized: " + "; ".join(
            f"{k} median {q[1]:.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f}" for k, q in quart.items())
        + f"; sharded - unsharded medians {quart['sharded'][1] - quart['unsharded'][1]:+.2f} ms")


def sharded_families(args) -> dict:
    """19d: FAMILY_SHARDED_SERVE's models at full width (float32 weights from
    --seed, bf16 compute, B 4), each served on a (1, 1) mesh against the
    unsharded engine through ``sharded_vs_plain`` with dense and P = 1
    caches: the prefill bit for bit, the decode with float32 scores held to
    SHARDED_DECODE_F32_TOL and with bf16 scores to the model's tolerance
    there (reported where it has none); the peak memory of each model's
    runs.  Returns the sharded runs' launches, which must include
    the flash and both planes kernels."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T

    counts = {}
    for i, (arch, (layers, prompt, decode_tol)) in enumerate(FAMILY_SHARDED_SERVE.items()):
        cfg = configs.get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=(
                layers if cfg.encoder_decoder else 0))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 92 + i)
        model = T.init_params(cfg, gen, "cuda")
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt), device="cuda",
                                generator=gen)
        extra = enc_vlm_extra(cfg, gen) if cfg.encoder_decoder or cfg.prefix_embeds else None
        sharded_vs_plain(
            "sharded serve 19d", model, cfg, prompts, FAMILY_SHARDED_STEPS,
            [(mode, 1, "DEFAULT_RULES", None, mesh_lib.param_specs_tree)
             for mode in ("dense", "compressed")], counts, decode_tol, extra)
        depth = "full depth" if layers is None else (
            f"cut to {layers} of {configs.get(arch).n_layers} layers"
            + (" in the encoder and the decoder" if cfg.encoder_decoder else ""))
        log(f"sharded serve 19d {arch} ({depth}), {SERVE_BATCH} x {prompt} prompts, "
            f"{FAMILY_SHARDED_STEPS} steps: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model, prompts, extra
    torch.cuda.empty_cache()
    counts = {k: v for k, v in counts.items() if v}
    log(f"sharded serve 19d launches on the families' sharded serving path: {counts}")
    for k in ("flash_attention",) + PLANES_KERNELS:
        check(counts.get(k, 0) > 0, f"19d: kernel {k} was not launched on the families' "
                                    f"sharded serving path")
    return counts


def phase_sharded_serve(args, dryrun: bool = True) -> dict:
    """Phase 19 (``--sharded-serve`` runs it alone): 19c's dry-run cells
    started as processes, 19a, 19b and 19d in a one-rank NCCL group on
    one-member meshes, then 19c's records read (without ``dryrun`` the
    caller starts and reads them).  Returns the launches of the sharded
    runs, which must include the flash and both planes kernels."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding as SH, transformer as T

    if dryrun:
        shutil.rmtree(SMOKE_DRYRUN_DIR, ignore_errors=True)
        dry = start_dryrun_cells(SMOKE_DRYRUN_DIR, serve_dryrun_cells())
        try:
            return phase_sharded_serve(args, dryrun=False)
        finally:
            finish_dryrun_cells(dry, SMOKE_DRYRUN_DIR)
    counts = {}
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        cfg = configs.get(SERVE_ARCH)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 90)
        model = T.init_params(cfg, gen, "cuda")
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                                generator=gen)
        mesh, params = sharded_vs_plain(
            "sharded serve 19a", model, cfg, prompts, SHARDED_SERVE_STEPS,
            [(mode, P, "DEFAULT_RULES", None, mesh_lib.param_specs_tree)
             for mode, P in (("dense", 1), ("compressed", 1))], counts, SHARDED_DECODE_TOL)
        sharded_busy(model, params, cfg, prompts, mesh)
        del model, params
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(configs.get(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 91)
        model = T.init_params(cfg, gen, "cuda")
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                                generator=gen)
        sharded_vs_plain(
            "sharded serve 19b", model, cfg, prompts, MOE_SERVE_STEPS,
            [("dense", 1, "DEFAULT_RULES", None, mesh_lib.param_specs_tree),
             ("compressed", 1, "SERVE_MOE_RULES", SH.SERVE_MOE_RULES,
              mesh_lib.serve_param_specs_tree)], counts)
        del model
        torch.cuda.empty_cache()
        for k, v in sharded_families(args).items():
            counts[k] = counts.get(k, 0) + v
    finally:
        dist.destroy_process_group()
    counts = {k: v for k, v in counts.items() if v}
    log(f"phase 19 launches on the sharded serving path: {counts}")
    for k in ("flash_attention",) + PLANES_KERNELS:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched on the sharded serving path")
    return counts


# ---------------------------------------------------------------------------
# phase 20: long-context serving, the sequence split over act_seq
# ---------------------------------------------------------------------------

LONG_ARCH = "h2o-danube-1.8b"      # configs/h2o_danube_1p8b.py, full width and depth
LONG_PROMPT = 524288               # long_500k's seq_len, batch 1 (configs/base.py)
LONG_STEPS = 16
# where the one-member runs are held bit for bit to the unsharded engine: a
# prompt both runs of each mode fit the time at
LONG_CHECK_PROMPT = 32768
# every other family at full width, on 32768 positions or its own limit
# (prompt tokens, layers or None for full depth, decode steps, the
# LONG_FLASH row its prefill's flash launches are counted under or None
# where no row has its shape): the SSM and the hybrid at full depth; deepseek-moe-16b on 4 of its 28 layers, as
# phases 16, 18 and 19 cut it; internvl2-1b at full depth, 256 image
# embeddings and 32512 tokens; whisper-medium at full depth over 1500 frames
# with a 432-token prompt (432 + 16 steps is its 448 text positions).
# deepseek-moe-16b and internvl2-1b decode 4 steps: full attention over
# 32768 slots is 17 host-issued chunks a layer a step (PERF.md)
LONG_FAMILIES = {"hymba-1.5b": (32768, None, LONG_STEPS, None),
                 "mamba2-1.3b": (32768, None, LONG_STEPS, None),
                 "deepseek-moe-16b": (32768, 4, 4, "20 deepseek-moe-16b, one member"),
                 "internvl2-1b": (32512, None, 4, "20 internvl2-1b, one member"),
                 "whisper-medium": (432, None, LONG_STEPS, None)}
LONG_DRYRUN_CELLS = tuple((arch, mode) for arch in ("h2o-danube-1.8b", "hymba-1.5b",
                                                    "mamba2-1.3b")
                          for mode in ("dense", "compressed"))


def long_serve(tag, model, params, mesh, cfg, prompts, counts, *, check_plain: bool,
               extra=None, steps: int = LONG_STEPS) -> int:
    """One model's prompt (B 1; with ``extra``: stub frames or image
    embeddings) served on a one-member mesh under
    LONG_CONTEXT_RULES, a prefill and ``steps`` decode steps in each mode
    (dense and P = 1 where it has attention), the scores rounded to bf16 as
    under any rules (``engine._reduce_scores``).  With ``check_plain`` the
    unsharded engine first on the same prompt (deterministic algorithms
    on): the sharded prefill's logits and cache are held to it bit for bit,
    its bf16-score decode logits reported (max |d| / max |logit| a step),
    and a second sharded run with the scores summed in float32 (a
    one-member mesh then runs the unsharded engine's ops) held to it bit
    for bit, prefill and decode.  Launch counters are set to 0 before the
    first sharded run and read after: the flash kernel exactly once an
    attention layer (``attention_layers``: whisper-medium's encoder and
    cross-attention layers too; in the prefill, never in decode), both
    planes kernels in a P = 1 run; the counts are added to ``counts``.
    Returns that run's flash launches."""
    import torch
    from repro_torch.models import sharding as SH
    from repro_torch.serve import engine as E

    flash = 0
    layers = attention_layers(cfg)
    bf16_reduce = E._reduce_scores
    # the order before the scores' sum was rounded once: each rank's partial
    # rounded to bf16, then summed
    def partials_rounded(s, dims=()):
        return SH.all_reduce(s.to(torch.bfloat16), dims).to(s.dtype)

    for mode, _P in family_modes(cfg)[:2]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a = f32 = twice = None
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            if check_plain:
                a = serve_teacher(model, cfg, prompts, mode, 1, steps, extra=extra)
            run = {}
            with SH.use_rules(mesh, SH.LONG_CONTEXT_RULES):
                sh = serve_teacher(params, cfg, prompts, mode, 1, steps,
                                   None if a is None else a[3], run, extra=extra)
                if check_plain and layers:
                    E._reduce_scores = lambda s, dims=(): SH.all_reduce(s, dims)  # noqa: E731
                    try:
                        f32 = serve_teacher(params, cfg, prompts, mode, 1, steps, a[3],
                                            extra=extra)
                        if cfg.name == LONG_ARCH:
                            E._reduce_scores = partials_rounded
                            twice = serve_teacher(params, cfg, prompts, mode, 1, steps, a[3],
                                                  extra=extra)
                    finally:
                        E._reduce_scores = bf16_reduce
        finally:
            torch.use_deterministic_algorithms(False)
        peak = torch.cuda.max_memory_allocated() / 1e9
        run = {k: v for k, v in run.items() if v}
        for k, v in run.items():
            counts[k] = counts.get(k, 0) + v
        flash += run.get("flash_attention", 0)
        check(run.get("flash_attention", 0) == layers,
              f"{tag} {cfg.name} {mode}: {run.get('flash_attention', 0)} flash launches, "
              f"one an attention layer is {layers}")
        if mode == "compressed":
            for k in PLANES_KERNELS:
                check(run.get(k, 0) > 0, f"{tag} {cfg.name}: {k} not launched on the P = 1 run")
        check(bool(torch.isfinite(sh[0]).all()) and bool(torch.isfinite(sh[2]).all()),
              f"{tag} {cfg.name} {mode}: logits not finite")
        verdict = "not held (the unsharded engine not run at this length)"
        if a is not None:
            check(same_prefill(sh, a), f"{tag} {cfg.name} {mode}: the one-member prefill "
                  f"differs from the unsharded engine's by {prefill_spread(sh, a):.3e}")
            if f32 is None:              # no attention: no score is rounded
                check(same_bits(sh[2], a[2]), f"{tag} {cfg.name} {mode}: the one-member decode "
                      f"differs from the unsharded engine's by "
                      f"{float((sh[2] - a[2]).abs().max()):.3e}")
                verdict = ("bit for bit the unsharded engine's (prefill logits and cache, decode "
                           "logits; no attention, no score rounded)")
            else:
                check(same_prefill(f32, a) and same_bits(f32[2], a[2]),
                      f"{tag} {cfg.name} {mode}: the one-member run with float32 scores differs "
                      f"from the unsharded engine: prefill {prefill_spread(f32, a):.3e}, decode "
                      f"{float((f32[2] - a[2]).abs().max()):.3e}")
                vocab = cfg.vocab_size
                r16 = teacher_rel(a[2][:, :, :vocab].transpose(0, 1),
                                  sh[2][:, :, :vocab].transpose(0, 1), vocab)
                check(all(math.isfinite(r) for r in r16), f"{tag} {cfg.name} {mode}: {r16}")
                verdict = ("prefill logits and cache bit for bit the unsharded engine's; decode "
                           "with float32 scores bit for bit, with bf16 scores max |d| / max "
                           "|logit| " + ", ".join(f"{r:.5f}" for r in r16) + " (reported)")
                if twice is not None:
                    # a one-member all-reduce is the identity, so rounding the
                    # sum once or each partial before it gives the same bits
                    check(same_prefill(twice, sh) and same_bits(twice[2], sh[2]),
                          f"{tag} {cfg.name} {mode}: the scores rounded before their "
                          f"one-member sum differ from those rounded after it by "
                          f"{float((twice[2] - sh[2]).abs().max()):.3e}")
                    verdict += ("; the scores rounded to bf16 before their one-member sum "
                                "instead of after it: the same bits, prefill and decode")
        mean = lambda ts: sum(ts[1:]) / len(ts[1:])   # noqa: E731  (the first step warms up)
        inputs = "".join(f" after {v.shape[1]} {k.replace('_', ' ')}" for k, v in
                         (extra or {}).items())
        log(f"{tag} {cfg.name} ({cfg.n_layers} layers) kv={mode} P=1 under LONG_CONTEXT_RULES on "
            f"a (1, 1) mesh, a prompt of {prompts.shape[1]} tokens{inputs}: prefill "
            f"{sh[4]:.3f} s"
            + (f" (unsharded {a[4]:.3f} s)" if a is not None else "")
            + f", decode {mean(sh[5]) * 1e3:.2f} ms a step"
            + (f" (unsharded {mean(a[5]) * 1e3:.2f})" if a is not None else "")
            + f" ({len(sh[5])} steps, host clock, synchronized), peak memory {peak:.2f} GB, "
              f"launches {run}; {verdict}")
        del a, sh, f32, twice
    return flash


def phase_long_context(args) -> tuple:
    """Phase 20 (``--long-context`` runs it alone, then the long_500k
    dry-run cells in-process), in a one-rank NCCL group on a (1, 1) data x
    model mesh: h2o-danube-1.8b at full width and depth (float32 weights
    from --seed, bf16 compute, B 1) held bit for bit to the unsharded engine
    at LONG_CHECK_PROMPT tokens, then served at LONG_PROMPT (524288) tokens;
    LONG_FAMILIES' models at full width at their prompts and depths (with
    stub frames or image embeddings drawn from the seed), held bit for
    bit.  Returns the sharded runs' launches and the flash launches by
    LONG_FLASH row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T

    counts, flash = {}, {}
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = one_member_mesh(("data", "model"))
        # (arch, prompt, layers, steps, held to the unsharded engine, LONG_FLASH
        # row): danube's check run (32768 keys from key 0) has no row
        runs = [(LONG_ARCH, LONG_CHECK_PROMPT, None, LONG_STEPS, True, None),
                (LONG_ARCH, LONG_PROMPT, None, LONG_STEPS, False,
                 "20 h2o-danube-1.8b, one member")] + [
            (arch, prompt, layers, steps, True, row)
            for arch, (prompt, layers, steps, row) in LONG_FAMILIES.items()]
        model = params = None
        for i, (arch, prompt, layers, steps, check_plain, row) in enumerate(runs):
            cfg = configs.get(arch)
            if layers:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            if model is None or model.cfg.name != arch:
                model = params = None
                torch.cuda.empty_cache()
                gen = torch.Generator(device="cuda").manual_seed(args.seed + 100 + i)
                model = T.init_params(cfg, gen, "cuda")
                tree = T.param_tree(model)
                params = mesh_lib.shard_tree(tree, mesh_lib.param_specs_tree(cfg, tree, mesh),
                                             mesh)
            prompts = torch.randint(0, cfg.vocab_size, (1, prompt), device="cuda", generator=gen)
            extra = {}
            if cfg.encoder_decoder:
                extra["frames"] = torch.randn((1, cfg.encoder_len, cfg.d_model), device="cuda",
                                              generator=gen)
            if cfg.prefix_embeds:
                extra["image_embeds"] = torch.randn((1, cfg.prefix_embeds, cfg.d_model),
                                                    device="cuda", generator=gen)
            n = long_serve("long context 20", model, params, mesh, cfg, prompts, counts,
                           check_plain=check_plain, extra=extra, steps=steps)
            if row is not None:
                check(LONG_FLASH[row][1] == prompt + cfg.prefix_embeds,
                      f"{arch}: a prompt of {prompt} is not LONG_FLASH row {row!r}'s shape")
                flash[row] = n
        del model, params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    counts = {k: v for k, v in counts.items() if v}
    log(f"phase 20 launches on the long-context serving path: {counts}")
    for k in ("flash_attention",) + PLANES_KERNELS:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched on the long-context path")
    return counts, flash


def long_dryrun_cells() -> None:
    """The dry-run's long_500k cells on fake CUDA tensors on (16, 16),
    LONG_CONTEXT_RULES, in this process (no group may be live): each record
    on a line with its ideal bytes a device and floor fraction."""
    from repro_torch.launch import dryrun

    for arch, mode in LONG_DRYRUN_CELLS:
        rec, t = timed(lambda: dryrun.lower_cell(arch, "long_500k", kv_mode=mode))
        check(rec["status"] == "OK" and "floor_fraction" in rec.get("roofline", {}),
              f"dry-run {arch} long_500k {mode}: {rec}")
        rl = rec["roofline"]
        log(f"long context dry-run {arch} long_500k kv={mode} mesh {rec['mesh']}: wall {t:.1f} s; "
            f"ideal_bytes_per_device {rec['ideal_bytes_per_device']:.6g}, floor_fraction "
            f"{rl['floor_fraction']:.6f}, bottleneck {rl['bottleneck']}; " + json.dumps(rec))


def long_flash_rows(gen, reps: int, launches: dict) -> list:
    """The flash kernel timed at LONG_FLASH's shapes (CUDA events), as
    entries of the kernels JSON's flash row: the bound from the input's
    bytes and the operations of its visible (query, key) pairs
    (``visible_pairs`` with the offset); the plain version timed where its
    chunk pairs fit (it visits every key chunk for each query chunk: at
    524288 queries, 512 x 1024 chunk pairs), else null; the library call
    (``long_flash_library_ms``) where its mask fits, else null
    (scaled_dot_product_attention has no window short of a dense mask, at
    524288 queries 524288^2).  A row only the CPU tests' ranks run counts
    no launch."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    rows = []
    for row, shape in LONG_FLASH.items():
        b, s, hq, hkv, hd, causal, window, skv, off = shape
        q, k, v = flash_inputs(gen, b, s, hq, hkv, hd, torch.bfloat16, skv)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                                q_offset=off), reps)
        plain_ms = err = lib_ms = None
        if s * skv <= 1 << 31:
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=off)
            d = (fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off).float()
                 - want.float()).abs()
            check(bool((d <= 2.0 ** -7 * want.float().abs() + 1e-6).all()),
                  f"flash_attention {row}: max |kernel - plain| {float(d.max())}")
            err = float(d.max())
            MAX_ERR["flash_attention"] = max(MAX_ERR["flash_attention"], err)
            del want, d
            # one timed call: the plain version takes 0.5-2.6 s a call here
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window, q_offset=off), 1)
            lib_ms = long_flash_library_ms(row, q, k, v, causal, window, off, reps)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * b * hq * hd * fa.visible_pairs(s, skv, causal, window, off)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        log(f"time flash_attention bf16 {row} B={b} Sq={s} Skv={skv} Hq={hq} Hkv={hkv} hd={hd} "
            f"window={window} q_offset={off}: kernel {ms:.4f} ms, plain "
            + (f"{plain_ms:.4f} ms, max |kernel - plain| {err:.3e}" if plain_ms is not None
               else "not timed (its chunk pairs take minutes)")
            + (f", scaled_dot_product_attention {lib_ms:.4f} ms" if lib_ms is not None
               else ", no library call")
            + f"; bound {bound_ms:.4f} ms ({flops / 1e9:.3f} GFLOP at 989 TFLOP/s bf16, "
              f"{nbytes / 1e6:.3f} MB at 3.35 TB/s), {bound_ms / ms * 100:.1f}% of the bound; "
              f"the bf16 route's 4 products' floor {2 * flops / BF16_FLOPS * 1e3:.4f} ms")
        rows.append({"row": row, "shape": list(shape), "launches": launches.get(row, 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "operations", "library_ms": lib_ms})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def long_flash_library_ms(row, q, k, v, causal: bool, window: int, off: int,
                          reps: int) -> float | None:
    """scaled_dot_product_attention on the same function as the kernel at
    a LONG_FLASH shape: with no mask where the attention is non-causal,
    ``is_causal`` where it is causal over Sq = Skv from key 0 with no
    window, else a dense boolean mask (Sq x Skv bytes) of the keys each
    query sees (kpos <= q_offset + i where causal, q_offset + i - kpos <
    window where windowed); the flash (maskless only), memory-efficient or
    cuDNN backend (the math backend would hold Hq x Sq x Skv scores), with
    ``enable_gqa``; where no such backend takes the GQA form, on K/V
    repeated to the query heads (made before the timing).  Its output is
    held to the kernel's loosely (2 % of the largest |value|: a wrong mask
    moves it by more).  Returns its time (CUDA events), or None with the
    reason logged where no backend runs it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa

    s, skv, hq, hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    mask, is_causal = None, causal
    if causal and (window or off or s != skv):
        qpos = torch.arange(off, off + s, device="cuda")[:, None]
        kpos = torch.arange(skv, device="cuda")[None, :]
        mask = kpos <= qpos
        if window:
            mask &= qpos - kpos < window
        del qpos, kpos
        is_causal = False
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    want = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    backends = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    if mask is None:
        backends.insert(0, SDPBackend.FLASH_ATTENTION)
    lib_ms, form, errors = None, None, []
    for form in ("enable_gqa", "K/V repeated to the query heads"):
        if form != "enable_gqa":
            kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))

        def call(kt=kt, vt=vt, gqa=form == "enable_gqa"):
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      is_causal=is_causal, enable_gqa=gqa)
        try:
            got = call().transpose(1, 2)
        except RuntimeError as e:         # no backend of the two takes this form
            errors.append(f"{form}: {str(e).splitlines()[0][:200]}")
            torch.cuda.empty_cache()
            continue
        d = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        check(d <= 0.02 * top, f"flash {row}: scaled_dot_product_attention differs from the "
              f"kernel by {d:.3e} (largest |value| {top:.3e})")
        del got
        lib_ms = cuda_ms(call, reps)
        how = (f"a {s} x {skv} boolean mask, memory-efficient or cuDNN backend" if mask is not None
               else f"is_causal={is_causal}, no mask, flash, memory-efficient or cuDNN backend")
        log(f"flash {row}: scaled_dot_product_attention ({form}, {how}) {lib_ms:.4f} ms, max |d| "
            f"from the kernel {d:.3e} of {top:.3e}")
        break
    if lib_ms is None:
        log(f"flash {row}: scaled_dot_product_attention not run: " + "; ".join(errors))
    del mask, qt, kt, vt, want
    torch.cuda.empty_cache()
    return lib_ms


# ---------------------------------------------------------------------------
# phase 21: the dense configs that no other phase runs, at full width
# ---------------------------------------------------------------------------

# 21a: served at full width and depth (configs/stablelm_3b.py, configs/yi_6b.py)
DENSE_SERVE_ARCHS = ("stablelm-3b", "yi-6b")
DENSE_SERVE_STEPS = 16
# 21b: trained at full width: arch -> layers (None: its full depth).  yi-6b's
# 32 layers need 96.97 GB of training state (TRAIN_STATE_BYTES a parameter),
# more than the card holds; 16 layers need 52.68 GB, which leaves the step's
# transients (9.2 GB over llama3.2-1b's state in phase 11) and at least
# DENSE_TRAIN_FREE of the card free.  h2o-danube-1.8b's window of 4096 is
# longer than S 2048, so it trains with full causal attention
DENSE_TRAIN_LAYERS = {"stablelm-3b": None, "h2o-danube-1.8b": None, "yi-6b": 16}
DENSE_TRAIN_FREE = 10e9
DENSE_WATCH = ("embed", "layers/0/attn/wq", "layers/0/mlp/wi", "layers/0/ln1")


def dense_teacher_check(model, cfg, prompts, runs: dict) -> None:
    """Decode vs forward over the same tokens (phase 9's criterion) for a
    model of 21a, from the served runs: each mode held in bf16, as served,
    where it meets TEACHER_TOL; the modes that do not are measured in bf16
    and held in float32 compute (exact products) on as many prompts as
    fit, as phase 14 holds its models."""
    import dataclasses

    vocab = cfg.vocab_size
    rel16 = {key: teacher_rel(forward_logits(model, cfg, prompts, toks), dec, vocab)
             for key, (toks, dec) in runs.items()}
    f32_keys = [key for key, rel in rel16.items() if max(rel) >= TEACHER_TOL[key[0]]]
    for (mode, P), rel in rel16.items():
        held = (mode, P) not in f32_keys
        log(f"dense check {cfg.name} kv={mode} P={P} bfloat16, {prompts.shape[0]} prompts: "
            f"prefill and {TEACHER_STEPS} decode steps vs forward over the same tokens, max |d| "
            f"/ max |logit| = " + ", ".join(f"{r:.5f}" for r in rel)
            + (f" (tolerance {TEACHER_TOL[mode]})" if held else
               " (measured; over the tolerance, held in float32 below)"))
    if not f32_keys:
        return
    f32 = dataclasses.replace(cfg, compute_dtype="float32")

    def checks(nb):
        out = {}
        for key in f32_keys:
            cache, toks, dec, _, _ = serve_and_check(model, f32, prompts[:nb], *key,
                                                     TEACHER_STEPS, TEACHER_STEPS)
            del cache
            out[key] = teacher_rel(forward_logits(model, f32, prompts[:nb], toks), dec, vocab)
        return out

    nb, res = fit_prompts(cfg.name, "the float32 check", checks)
    for (mode, P), rel in res.items():
        check(max(rel) < TEACHER_TOL[mode], f"{cfg.name} {mode} P={P}: decode vs forward in "
              f"float32 {rel}")
        log(f"dense check {cfg.name} kv={mode} P={P} float32, {nb} prompts: prefill and "
            f"{TEACHER_STEPS} decode steps vs forward over the same tokens, max |d| / max "
            f"|logit| = " + ", ".join(f"{r:.5f}" for r in rel)
            + f" (tolerance {TEACHER_TOL[mode]})")


def dense_serve(args, arch: str, seed: int) -> None:
    """21a: one dense model at full width and depth, float32 weights from
    --seed on the card, bf16 compute: 4 prompts of 2048 tokens and
    DENSE_SERVE_STEPS greedy steps with a dense cache and SZx-planes caches
    at P = 1, 2 (``serve_and_check``: the launch counts, the cache bytes,
    finite logits); decode vs forward (``dense_teacher_check``); the peak
    memory; a profile of a dense prefill and 2 decode steps."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops, planes as PL
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    routes0 = ops.planes_route_counts()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, t_init = timed(lambda: T.init_params(cfg, gen, "cuda"))
    nparams = sum(p.numel() for p in model.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model        # param_count() leaves the norms out
    check(nparams == cfg.param_count() + norms, f"{arch}: {nparams} parameters")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                            generator=gen)
    log(f"dense {arch}: {nparams} parameters, {nparams * 4 / 1e9:.2f} GB f32, made on the card "
        f"in {t_init:.2f} s ({free / 1e9:.2f} of {total / 1e9:.2f} GB free before); "
        f"{cfg.n_layers} layers (full depth), d_model {cfg.d_model}, {cfg.n_heads} query heads "
        f"over {cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, rope theta {cfg.rope_theta:g}; {SERVE_BATCH} prompts of "
        f"{SERVE_PROMPT} tokens, {DENSE_SERVE_STEPS} greedy steps")
    t_first = timed(lambda: serve_and_check(model, cfg, prompts, "dense", 1, 1, 0) and None)[1]
    log(f"dense {arch}: first prefill and step (allocator and cuBLAS warm-up) "
        f"{t_first * 1e3:.1f} ms")
    runs = {}
    for mode, P in SERVE_MODES:
        cache, toks, dec, t_pre, t_dec = serve_and_check(model, cfg, prompts, mode, P,
                                                         DENSE_SERVE_STEPS, TEACHER_STEPS)
        log(f"dense {arch} kv={mode} P={P}: prefill {t_pre * 1e3:.1f} ms "
            f"({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} tok/s), decode {DENSE_SERVE_STEPS} "
            f"steps in {t_dec:.3f} s = {SERVE_BATCH * DENSE_SERVE_STEPS / t_dec:.1f} tok/s "
            f"({t_dec / DENSE_SERVE_STEPS * 1e3:.2f} ms a step), cache {E.cache_nbytes(cache)} B "
            f"({E.cache_nbytes(cache) / 2**20:.1f} MiB), sample row {toks[0, :8].tolist()}")
        runs[(mode, P)] = (toks, dec)
        del cache
    dense_teacher_check(model, cfg, prompts, runs)
    # a head_dim block's route is the one planes.route gives its width on
    # fresh (aligned) slabs: the vector route for a power of two (yi-6b's
    # 128), the scalar route for the rest (stablelm-3b's 80)
    want = PL.route(cfg.resolved_head_dim, 0, 0)
    other = "scalar" if want == "vector" else "vector"
    got = {k: v - routes0[k] for k, v in ops.planes_route_counts().items()}
    for k in PLANES_KERNELS:
        check(got[f"{k}_{want}"] > 0 and got[f"{k}_{other}"] == 0,
              f"{arch}: {k} launches by route {got}, not all on the {want} route")
    log(f"dense {arch}: planes launches by route {got}: head_dim {cfg.resolved_head_dim} "
        f"takes the {want} route")
    dense_toks = runs[("dense", 1)][0]
    for (mode, P), (toks, _) in runs.items():
        if mode != "dense":
            log(f"dense {arch} kv={mode} P={P}: greedy tokens equal to dense's: "
                f"{float((toks == dense_toks).float().mean()):.3f}")
    del runs
    _, t_prof = timed(lambda: profile_serve(model, cfg, prompts, modes=SERVE_MODES[:1]))
    peak = torch.cuda.max_memory_allocated()
    log(f"dense {arch}: peak memory allocated {peak} B ({peak / 1e9:.2f} GB of "
        f"{total / 1e9:.2f}), weights {nparams * 4 / 1e9:.2f} GB; profile {t_prof:.1f} s")
    del model, prompts
    torch.cuda.empty_cache()


def dense_train(args, arch: str, layers, seed: int) -> dict:
    """21b: one dense model trained at full width on ``layers`` of its
    depth (None: all), its training state reckoned at TRAIN_STATE_BYTES a
    parameter and printed beside the card's memory (``train_steps``); a cut
    must leave DENSE_TRAIN_FREE of the card free at its peak."""
    import dataclasses

    import torch
    from repro_torch import configs

    full = configs.get(arch)
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    total = torch.cuda.mem_get_info()[1]
    state = cfg.param_count() * TRAIN_STATE_BYTES
    more = None if layers is None else dataclasses.replace(full, n_layers=layers + 4)
    if layers is None:
        log(f"dense-train {arch}: full depth ({full.n_layers} layers) at full width, "
            f"{full.param_count()} parameters, {state / 1e9:.2f} GB of f32 weights, gradients "
            f"and AdamW moments against the card's {total / 1e9:.1f} GB")
    else:
        log(f"dense-train {arch}: cut to {layers} of its {full.n_layers} layers at full width, "
            f"because the full depth's {full.param_count()} parameters need "
            f"{full.param_count() * TRAIN_STATE_BYTES / 1e9:.2f} GB of f32 weights, gradients "
            f"and AdamW moments against the card's {total / 1e9:.1f} GB; {layers} layers have "
            f"{cfg.param_count()} ({state / 1e9:.2f} GB; "
            f"{more.param_count() * TRAIN_STATE_BYTES / 1e9:.2f} GB at {more.n_layers}), "
            f"leaving at least {DENSE_TRAIN_FREE / 1e9:.0f} GB free beside "
            f"the step's transients. Full depth needs four cards (ROADMAP.md queue 1 item 12)")
    out = train_steps(args, cfg, DENSE_WATCH, "dense-train", seed)
    if layers is not None:
        check(out["peak"] <= total - DENSE_TRAIN_FREE,
              f"{arch}: the cut's peak {out['peak'] / 1e9:.2f} GB leaves less than "
              f"{DENSE_TRAIN_FREE / 1e9:.0f} GB of {total / 1e9:.2f} free")
    log(f"dense-train {arch}: state {state / 1e9:.2f} GB reckoned, peak "
        f"{out['peak'] / 1e9:.2f} GB measured ({(out['peak'] - state) / 1e9:.2f} GB over the "
        f"state)")
    return out


def phase_dense_configs(args) -> tuple:
    """Phase 21 (``--dense-configs`` runs it alone): stablelm-3b and yi-6b
    served at full width and depth (``dense_serve``), then stablelm-3b and
    h2o-danube-1.8b trained at full depth and yi-6b on DENSE_TRAIN_LAYERS'
    cut (``dense_train``).  Launch counters are set to 0 before and read
    after: the flash and both planes kernels must each have run, the planes
    kernels on the route their head_dim takes (``dense_serve``); the flash
    launches are also counted by shape, and DENSE_FLASH's rows must each
    have been launched.  Returns
    the phase's launch counts and the flash launches by DENSE_FLASH row."""
    import gc

    import torch
    from repro_torch.kernels import ops

    gc.collect()                    # the earlier phases' cycles hold memory on the card
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    with FlashShapes() as shapes:
        for i, arch in enumerate(DENSE_SERVE_ARCHS):
            dense_serve(args, arch, args.seed + 210 + i)
        for i, (arch, layers) in enumerate(DENSE_TRAIN_LAYERS.items()):
            dense_train(args, arch, layers, args.seed + 220 + i)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    log(f"phase 21 launches on the dense configs' path: {counts}; planes by route "
        f"{ops.planes_route_counts()}; flash by shape (B, Sq, Hq, Hkv, hd, causal, window, "
        f"Skv, dtype): {dict(shapes.seen)}")
    for k in ("flash_attention",) + PLANES_KERNELS:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched on the dense configs' path")
    flash = {row: shapes.seen[shape + (shape[1], "bfloat16")] for row, shape in DENSE_FLASH.items()}
    for row, n in flash.items():
        check(n > 0, f"phase 21: no flash launch at row {row}'s shape {DENSE_FLASH[row]}")
    return counts, flash


def dispatch_cost(reps: int, rounds: int = 5) -> dict:
    """``--dispatch``: the cost of the custom operator that every flash and
    planes call goes through.  Each wrapper call, through its operator,
    against the operator's body called directly (``_init_fn``: the same
    checks and launch, no dispatch), ``reps`` calls in a tight loop timed
    with CUDA events (the card waits on the host for calls this small),
    ``rounds`` rounds alternating which goes first.  Shapes: a compressed
    decode step's of llama3.2-1b at B 4 (one position's K of 8 kv heads x
    hd 64 encoded; a 2048-slot chunk decoded, P = 1), a 128-token flash
    prefill.  Returns microseconds a call, medians."""
    import statistics

    import torch
    from repro_torch.kernels import flash_attention as F, ops, planes

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn(4, 8, 64, device="cuda", generator=gen)
    mu, sexp, pl = planes.planes_encode(torch.randn(4, 2048, 8, 64, device="cuda",
                                                    generator=gen), 1)
    sexp = sexp.clamp(-127, 127).to(torch.int8)
    q = torch.randn(1, 128, 32, 64, device="cuda", generator=gen).to(torch.bfloat16)
    kv = torch.randn(1, 128, 8, 64, device="cuda", generator=gen).to(torch.bfloat16)
    calls = {
        "planes_encode": (lambda: planes.planes_encode(t, 1),
                          lambda: planes._encode_op._init_fn(t, 1)),
        "planes_decode": (lambda: planes.planes_decode(mu, sexp, pl),
                          lambda: planes._decode_op._init_fn(mu, sexp, pl)),
        "flash_attention": (lambda: F.flash_attention(q, kv, kv, causal=True),
                            lambda: F._flash_op._init_fn(q, kv, kv, True, 0, 0)),
    }
    out = {}
    for name, (via_op, direct) in calls.items():
        got = {"operator": [], "direct": []}
        for r in range(rounds):
            order = (("operator", via_op), ("direct", direct))
            for side, fn in (order if r % 2 == 0 else order[::-1]):
                got[side].append(cuda_ms(fn, reps) * 1e3)
        op_us, direct_us = (statistics.median(got[k]) for k in ("operator", "direct"))
        out[name] = {"operator_us": op_us, "direct_us": direct_us,
                     "rounds": {k: [round(v, 3) for v in vs] for k, vs in got.items()}}
    ops.reset_launch_counts()
    return out


def store_kernels_only(args) -> int:
    """``--store-kernels``: phase 6's store-kernel rows alone, on phase 5's
    middle chunk (the stage-off store of the same array) and phase 4's first
    frame, so that two trees can be timed in turns in one call."""
    from repro_torch.core.codec import Bound, device
    from repro_torch.store import ArrayStore

    field = make_field(args.edge, args.seed)
    buf = io.BytesIO()
    idx = ArrayStore.save(buf, store_field(field, args.seed), Bound.rel(1e-3))
    p, xb = frame_blocks(field)
    rows = time_store_kernels(middle_chunk(buf.getvalue(), idx), device.encode_to_stream(xb, p),
                              args.reps)
    print(json.dumps({"store_kernels": [
        {"name": name, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms, **extra}
        for name, ms, pms, bound_ms, extra in rows]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edge", type=int, default=512,
                    help="edge of the cubic f32 field on the main path (512 = 512 MiB)")
    ap.add_argument("--reps", type=int, default=50, help="timed launches per kernel")
    ap.add_argument("--store-kernels", action="store_true",
                    help="build, time the store path's kernels as phase 6 does (unpack, "
                         "unpack_dense, bitshuffle both ways at the store chunk's and a 64 MiB "
                         "frame's shapes), print their rows as JSON and stop")
    ap.add_argument("--ingest", action="store_true",
                    help="build, run phase 12 alone (training ingest from a compressed store, "
                         "with telemetry) and stop")
    ap.add_argument("--service", action="store_true",
                    help="build, run phase 13 alone (the HTTP store service on the card, its "
                         "stores made from --seed) and stop")
    ap.add_argument("--families", action="store_true",
                    help="build, hold the flash kernel to its plain version at phase 14's "
                         "prefill shapes, run phase 14 alone (the MoE, SSM and hybrid families "
                         "at full width), time the flash kernel at those shapes and stop")
    ap.add_argument("--enc-vlm", action="store_true",
                    help="build, hold the flash kernel to its plain version at phase 15's "
                         "shapes, run phase 15 alone (whisper-medium and internvl2-1b served "
                         "and trained at full width), time the flash kernel at those shapes "
                         "and stop")
    ap.add_argument("--families-train", action="store_true",
                    help="build, hold the flash kernel to its plain version at phase 14's "
                         "prefill shapes, run phase 16 alone (mamba2-1.3b on 8 layers and "
                         "hymba-1.5b on 8, deepseek-moe-16b on 4, trained at full width) "
                         "and stop")
    ap.add_argument("--examples", action="store_true",
                    help="build, run phase 17 alone (the four examples/*_torch.py on the "
                         "card) and stop")
    ap.add_argument("--dispatch", action="store_true",
                    help="build, time each flash and planes wrapper call through its custom "
                         "operator against the operator's body called directly, print the "
                         "rows as JSON and stop")
    ap.add_argument("--sharding", action="store_true",
                    help="build, run phase 18 alone (the sharded training step on one-member "
                         "meshes, sharded checkpoints, the dry-run) and stop")
    ap.add_argument("--long-context", action="store_true",
                    help="build, hold the flash kernel with an offset to its plain version, "
                         "run phase 20 alone (long-context serving under LONG_CONTEXT_RULES: "
                         "h2o-danube-1.8b at 524288 tokens, hymba-1.5b, mamba2-1.3b, "
                         "deepseek-moe-16b, internvl2-1b and whisper-medium), time "
                         "the flash kernel at its shapes, trace the long_500k dry-run cells "
                         "and stop")
    ap.add_argument("--sharded-serve", action="store_true",
                    help="build, run phase 19 alone (serving under one-member meshes, the "
                         "SSM, hybrid, audio and VLM families among them, the dry-run's "
                         "serving cells) and stop")
    ap.add_argument("--dense-configs", action="store_true",
                    help="build, hold the flash kernel to its plain version at phase 21's "
                         "prefill shapes, run phase 21 alone (stablelm-3b and yi-6b served at "
                         "full width and depth; stablelm-3b, h2o-danube-1.8b and a depth cut "
                         "of yi-6b trained), time the flash kernel at those shapes and stop")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc_version = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {nvcc_version}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'} "
        f"(wall {time.perf_counter() - t0:.1f} s, nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in ("planes", "unpack", "bitshuffle"):
        if name in _build.LOGS:
            log(f"{name} kernels, registers a thread (ptxas -v): "
                f"{ptxas_registers(_build.LOGS[name])}")

    if args.store_kernels:
        return store_kernels_only(args)
    if args.dispatch:
        log(f"dispatch (us a call, {args.reps * 20} calls a round): "
            f"{json.dumps(dispatch_cost(args.reps * 20))}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.ingest:
        import shutil

        DATA_DIR.mkdir(exist_ok=True)
        try:
            log(f"phase 12 launches: ingest {phase_ingest(args)}, training "
                f"{phase_store_train(args)[0]}")
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0
    if args.service:
        import shutil

        DATA_DIR.mkdir(exist_ok=True)
        try:
            phase_service(args)
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0
    if args.families:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        phase_flash_kernel(gen, [c for c in FLASH_CASES if c[:-1] in FAMILY_FLASH.values()])
        _, flash = phase_families(args)
        family_flash_rows(gen, max(args.reps // 2, 5), flash)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.enc_vlm:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        phase_flash_kernel(gen, [c for c in FLASH_CASES if c[:-1] in ENC_VLM_FLASH.values()])
        try:
            _, flash = phase_enc_vlm(args)
        finally:
            import shutil

            shutil.rmtree(CKPT_DIR, ignore_errors=True)
        rows = flash_rows(gen, max(args.reps // 2, 5), ENC_VLM_FLASH, flash)
        log(f"phase 15 flash rows: {json.dumps(rows)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    if args.families_train:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        phase_flash_kernel(gen, [c for c in FLASH_CASES if c[:-1] in FAMILY_FLASH.values()])
        try:
            log(f"phase 16 launches: {phase_families_train(args)[0]}")
        finally:
            import shutil

            shutil.rmtree(CKPT_DIR, ignore_errors=True)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.examples:
        log(f"phase 17 launches: {phase_examples()}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.sharding:
        phase_sharding(args)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.sharded_serve:
        phase_sharded_serve(args)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.dense_configs:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        phase_flash_kernel(gen, [c for c in FLASH_CASES if c[:-1] in DENSE_FLASH.values()])
        _, flash = phase_dense_configs(args)
        rows = flash_rows(gen, max(args.reps // 2, 5), DENSE_FLASH, flash)
        log(f"phase 21 flash rows: {json.dumps(rows)}")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.long_context:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        phase_flash_kernel(gen, [c for c in FLASH_CASES if len(c) == 10])
        _, flash = phase_long_context(args)
        rows = long_flash_rows(gen, max(args.reps // 10, 3), flash)
        log(f"phase 20 flash rows: {json.dumps(rows)}")
        long_dryrun_cells()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(gen)
    phase_planes_kernels(gen)
    phase_flash_kernel(gen)
    phase_golden()

    ops.reset_launch_counts()
    field = phase_main(args)
    store = phase_store(field, args)
    launches = {k: v for k, v in ops.launch_counts().items() if k in CODEC_KERNELS}
    log(f"codec and store path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the codec and store path")
    log(f"codec and store path launches by route: {ops.store_route_counts()}")
    check_store_vector_route("codec and store path", ops.store_route_counts())

    rows = phase_timing(field, store, args.reps, args.seed)
    phase_breakdown(field)
    del field, store
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    step_s = phase_gradient(args)
    grad_launches = {k: v for k, v in ops.launch_counts().items() if k in PLANES_KERNELS}
    log(f"gradient path launches: {grad_launches}; by route {ops.planes_route_counts()}")
    for name, n in grad_launches.items():
        check(n > 0, f"kernel {name} was not launched on the gradient path")
    check_vector_route("gradient path", ops.planes_route_counts())
    launches.update(grad_launches)
    n = sum(math.prod(shape) for _, shape in leaves(LLAMA_1B_GRADS))
    for P, times in step_s.items():
        enc_bytes = n * 4 + n * P + (n // GRAD_BLOCK) * 8
        log(f"time psum-mean step, whole llama3.2-1b gradient P={P} (host clock, synchronized): "
            + ", ".join(f"{t * 1e3:.1f} ms" for t in times)
            + f"; encode bound {enc_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({enc_bytes} B at 3.35 TB/s)")
    torch.cuda.empty_cache()

    log(f"phase 9 starts {time.perf_counter() - t_start:.1f} s into the run")
    ops.reset_launch_counts()
    model, cfg, prompts, runs = phase_serve(args)
    serve_launches = {k: v for k, v in ops.launch_counts().items()
                      if k in PLANES_KERNELS + ("flash_attention",)}
    log(f"serving path launches: {serve_launches}; by route {ops.planes_route_counts()}")
    for name, n in serve_launches.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")
    check_vector_route("serving path", ops.planes_route_counts())
    launches["flash_attention"] = serve_launches["flash_attention"]
    check_serve(model, cfg, prompts, runs)
    _, t_prof = timed(lambda: profile_serve(model, cfg, prompts))
    log(f"serving profile: {t_prof:.1f} s in all")
    del model, runs
    torch.cuda.empty_cache()
    flash_ms, flash_plain_ms, flash_lib_ms, flash_bound_ms = time_flash(gen, max(args.reps // 2, 5))
    torch.cuda.empty_cache()

    log(f"phase 10 starts {time.perf_counter() - t_start:.1f} s into the run")
    field = make_field(args.edge, args.seed)            # phase 4's field, made again
    xb, e, stats, two_call_launches = phase_two_call(field, args)
    launches.update(two_call_launches)
    rows += time_two_call(xb, e, stats, args.reps)
    del field, xb, stats
    torch.cuda.empty_cache()

    log(f"phase 11 starts {time.perf_counter() - t_start:.1f} s into the run")
    train_s = phase_train(args)
    for P, times in train_s.items():
        log(f"time train step {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ} "
            f"{'plain' if not P else f'compressed P={P}'} (host clock, synchronized): "
            + ", ".join(f"{t * 1e3:.1f} ms" for t in times))
    torch.cuda.empty_cache()

    log(f"phase 12 starts {time.perf_counter() - t_start:.1f} s into the run")
    import shutil

    DATA_DIR.mkdir(exist_ok=True)
    try:
        ingest_launches = phase_ingest(args)
        store_launches, store_s, busy = phase_store_train(args)
        log(f"phase 13 starts {time.perf_counter() - t_start:.1f} s into the run")
        service_launches = phase_service(args)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    for counts in (ingest_launches, store_launches, service_launches):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 14 starts {time.perf_counter() - t_start:.1f} s into the run")
    family_launches, family_flash = phase_families(args)
    for k, v in family_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 15 starts {time.perf_counter() - t_start:.1f} s into the run")
    try:
        enc_vlm_launches, enc_vlm_flash = phase_enc_vlm(args)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for k, v in enc_vlm_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 16 starts {time.perf_counter() - t_start:.1f} s into the run")
    try:
        train_launches, train_flash, _ = phase_families_train(args)
        log(f"phase 17 starts {time.perf_counter() - t_start:.1f} s into the run")
        example_launches = phase_examples()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    # 18e's dry-run cells run as processes beside phases 18-21, 19c's beside
    # phase 21 (mostly device-bound: its host-bound decode steps are few),
    # and all are read after phase 21
    log(f"phase 18 starts {time.perf_counter() - t_start:.1f} s into the run")
    shutil.rmtree(SMOKE_DRYRUN_DIR, ignore_errors=True)
    dry = start_dryrun_cells(SMOKE_DRYRUN_DIR, train_dryrun_cells())
    try:
        sharding_launches = phase_sharding(args, dryrun=False)
        log(f"phase 19 starts {time.perf_counter() - t_start:.1f} s into the run")
        sharded_serve_launches = phase_sharded_serve(args, dryrun=False)
        log(f"phase 20 starts {time.perf_counter() - t_start:.1f} s into the run")
        long_launches, long_flash = phase_long_context(args)
        log(f"phase 21 starts {time.perf_counter() - t_start:.1f} s into the run")
        dry += start_dryrun_cells(SMOKE_DRYRUN_DIR, serve_dryrun_cells())
        dense_launches, dense_flash = phase_dense_configs(args)
        log(f"18e's and 19c's dry-run records read {time.perf_counter() - t_start:.1f} s into "
            f"the run")
    finally:
        finish_dryrun_cells(dry, SMOKE_DRYRUN_DIR)
    for counts in (train_launches, example_launches, sharding_launches,
                   sharded_serve_launches, long_launches, dense_launches):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for arch, n in train_flash.items():
        if arch in family_flash:
            family_flash[arch] += n
    flash_cases = (family_flash_rows(gen, max(args.reps // 2, 5), family_flash)
                   + flash_rows(gen, max(args.reps // 2, 5), ENC_VLM_FLASH, enc_vlm_flash)
                   + long_flash_rows(gen, max(args.reps // 10, 3), long_flash)
                   + flash_rows(gen, max(args.reps // 2, 5), DENSE_FLASH, dense_flash))
    log(f"time train step {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ} plain: store-fed (batch "
        f"draw + step) " + ", ".join(f"{t * 1e3:.1f}" for t in store_s)
        + " ms vs synthetic tokens (phase 11, step only) "
        + ", ".join(f"{t * 1e3:.1f}" for t in train_s[0])
        + f" ms (host clock, synchronized); device busy in a store-fed step "
        + (f"{100 * busy:.1f}%" if busy else "not measured"))

    kernels = []
    for name, ms, pms, bound_ms, *extra in rows:
        src, replaces = SOURCES[name]
        n = launches[name] + (launches["bitshuffle_inverse"] if name == "bitshuffle" else 0)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "max_abs_err": MAX_ERR[name],
            "ms": ms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, **(extra[0] if extra else {}),
        })
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"][0],
        "replaces": SOURCES["flash_attention"][1], "launches": launches["flash_attention"],
        "max_abs_err": MAX_ERR["flash_attention"], "ms": flash_ms, "plain_ms": flash_plain_ms,
        "bound_ms": flash_bound_ms, "bound_by": "operations", "library_ms": flash_lib_ms,
        "cases": flash_cases,
    })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
