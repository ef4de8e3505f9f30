"""Prefill serving: one closed-loop client sends one prompt at a time to
``repro_torch.serve.engine.prefill`` and waits for its first token (the
greedy argmax of the last position's logits) on the host.

Set-up makes the weights from the seed on the device and hands them to the
program, draws the prompts, and warms up the mix's warm-up lengths.  The
window then serves prompts in order for ``seconds``, rounded up to whole
rounds of the mix's lengths (so that every window serves the same sizes,
whatever its number of rounds).  After it, the program
is freed and the reference checks a sample of the finished requests: the
served token against the reference's logits, the logits themselves, and the
SZx-planes cache the prefill wrote against the reference's K/V.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import harness, traffic
from perfbench.reference import model, planes, weights


def load_weights(params: dict, arch, seed: int, device) -> None:
    """Copy the seed's weights, chunk by chunk, into the program's tree."""
    for c in range(weights.chunk_count(arch)):
        for name, t in weights.make_chunk(arch, seed, c, device).items():
            leaf(params, name).copy_(t)


def leaf(tree, name: str):
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def program_kv(cache: dict, s: int):
    """The K/V of a prompt of ``s`` tokens as the program's cache holds them
    (the last W positions of a ring of W slots, position p in slot p % W),
    decoded by the reference: ``kv(layer) -> (positions, k, v)``, k and v
    (n, Hkv, hd) float32 (batch row 0)."""
    lay = cache["layers"]
    w = (lay["k"] if "k" in lay else lay["kmu"]).shape[2]
    pos = torch.arange(max(0, s - w), s)

    def kv(i):
        out = [pos]
        for nm in ("k", "v"):
            if nm in lay:
                slab = lay[nm][i, 0].float()
            else:
                slab = planes.decode(lay[nm + "mu"][i, 0], lay[nm + "sexp"][i, 0],
                                     lay[nm + "pl"][i, :, 0])
            out.append(slab[(pos % w).to(slab.device)])
        return tuple(out)

    return kv


def empty_like_cache(meta: dict, device) -> dict:
    """Buffers on ``device`` for the layers' slabs of a cache made on the
    ``meta`` device."""
    return {"layers": {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                       for k, t in meta["layers"].items()}}


def keep(buf: dict, cache: dict, s: int):
    """Copy ``cache``'s slabs into ``buf``; its K/V as :func:`program_kv`."""
    for k, t in buf["layers"].items():
        t.copy_(cache["layers"][k])
    return program_kv(buf, s)


def judge(arch, w: dict, reqs, answers: dict, limits: dict) -> dict:
    """The compared numbers over the sampled requests ``answers`` ({i:
    (token, logits (V,), kv)}), each with its limit:

    - ``token_gap``: the widest gap by which a served token's reference
      logit lies below the reference's best;
    - ``logit_err``: the largest |logit - reference| over the vocabulary,
      against the standard deviation of the reference's logits;
    - ``cache_err``: the largest ||K - K_ref|| / ||K_ref|| (and V) of a
      layer, the cache's K/V decoded by the reference."""
    gap = lerr = cerr = 0.0
    for i, (tok, logits, kv) in answers.items():
        errs = []

        def on_layer(j, k, v, kv=kv, errs=errs):
            pos, *got = kv(j)
            pos = pos.to(k.device)
            for g, ref in zip(got, (k[pos], v[pos])):
                errs.append(float(torch.linalg.vector_norm(g - ref)
                                  / torch.linalg.vector_norm(ref)))

        ref = model.prefill(w, arch, reqs.prompt(i)[0], on_layer=on_layer)
        gap = max(gap, float(ref.max() - ref[tok]))
        lerr = max(lerr, float((logits.float() - ref).abs().max() / ref.std()))
        cerr = max(cerr, max(errs))
    return {"token_gap": (gap, limits["token_gap"]), "logit_err": (lerr, limits["logit_err"]),
            "cache_err": (cerr, limits["cache_err"])}


def drive(run: harness.Run, conf: dict, seed: int, seconds: float, trace: bool,
          device) -> harness.Run:
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    from perfbench.trace import Tracer

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arch, mix = run.arch, run.mix
    cfg = harness.arch_config(run.workload.split(".")[0], conf, mix)
    run.mark("imports")
    prog = T.Transformer(cfg, device=device)
    params = T.param_tree(prog)
    load_weights(params, arch, seed, device)
    run.mark("weights")
    reqs = traffic.Requests(mix, arch.vocab, seed, device)
    sample = set(traffic.check_sample(mix, reqs.lengths, seed))
    kw = dict(kv_mode=mix["kv_mode"], num_planes=mix["num_planes"])
    extra = mix["answer_slots"]

    def serve(prompt):
        cache, logits = E.prefill(params, cfg, prompt, seq_len=prompt.shape[1] + extra, **kw)
        return cache, logits[0, -1]

    warm_lens = traffic.warmup_lengths(mix)
    warm = traffic.warmup_tokens(max(warm_lens), arch.vocab, seed, device)
    for j, s in enumerate(warm_lens):
        serve(warm[:s][None])[1].argmax().item()
        if j == 0:
            run.mark("first_prefill")
    del warm
    run.mark("warmup")
    # the sampled requests' caches and logits are copied into buffers made
    # here, so that keeping them allocates nothing in the window
    held = {i: empty_like_cache(E.make_cache(cfg, 1, reqs.lengths[i] + extra, device="meta",
                                             **kw), device) for i in sample}
    held_logits = {i: torch.empty(cfg.padded_vocab, device=device) for i in sample}
    tracer = Tracer(device) if trace else None
    traced, state = [], "wait"
    answers = {}
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    run.t0 = t = time.perf_counter()
    run.setup_s = run.t0 - run.t_start
    run.mark("buffers")
    i = 0
    rounds = mix["prompt_len"]["round"]
    # whole rounds: every window serves the same sizes, however many rounds
    while (t - run.t0 < seconds or i % rounds) and i < len(reqs):
        if tracer and state == "wait" and t - run.t0 >= mix["trace"]["start_frac"] * seconds:
            tracer.start()
            state, t_tr = "on", time.perf_counter()
            t = t_tr
        prompt = reqs.prompt(i)
        cache, logits = serve(prompt)
        t_enq = time.perf_counter()
        tok = int(logits.argmax())
        t_tok = time.perf_counter()
        run.requests.append((t, t_tok, prompt.shape[1], t_enq - t))
        if state == "on":
            traced.append(prompt.shape[1])
        if i in sample:
            answers[i] = (tok, held_logits[i].copy_(logits), keep(held[i], cache, prompt.shape[1]))
        del cache, logits
        i += 1
        t = time.perf_counter()
        if state == "on" and t - t_tr >= mix["trace"]["seconds"]:
            tracer.stop(traced)
            state, t = "off", time.perf_counter()
    run.t1 = run.requests[-1][1] if run.requests else run.t0
    if state == "on":
        tracer.stop(traced)
    gc.unfreeze()
    run.attempted = len(run.requests)
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if tracer:
        run.trace = tracer.reduce()
    for j in sorted(sample - set(answers)):      # a short window: answered after it
        cache, logits = serve(reqs.prompt(j))
        answers[j] = (int(logits.argmax()), logits, keep(held[j], cache, reqs.lengths[j]))
    del prog, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    w = weights.make_all(arch, seed, device)
    run.checks = judge(arch, w, reqs, answers, harness.limits_file(run.workload))
    run.check_s = time.perf_counter() - t_check
    return run
