"""Training: ``repro_torch.train.step.make_train_step``'s step on rows of the
mix from the seed, plain or with szx-planes gradient compression and error
feedback over a one-member process group (NCCL on the card).

Set-up builds the training state (the weights from the seed copied into the
program's state), runs its first ``setup_steps`` steps through the same
step function and batches as the window, and records what the check
compares: each step's loss, each leaf's norm of the first gradient as the
optimizer took it (its first moment over 1 - b1), of the error feedback
after step 1, and of the weights' change over those steps.  The window then
runs steps, each ending in a synchronize, for ``seconds``.  After it the
program's state is freed and the reference follows the same first steps.
"""
from __future__ import annotations

import gc
import socket
import time

import torch

from perfbench import harness, traffic
from perfbench.drivers.prefill import leaf, load_weights
from perfbench.reference import train as ref_train, weights


def one_member_group(device) -> None:
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=1, rank=0)


def optimizer(mix: dict):
    from repro_torch.optim.adamw import AdamW, warmup_cosine

    o = mix["optimizer"]
    return AdamW(lr=warmup_cosine(o["peak_lr"], o["warmup"], o["total"], o["floor"]),
                 b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                 clip_norm=o["clip_norm"])


@torch.no_grad()
def norms(tree: dict, names, pick=lambda t: t) -> dict:
    return {n: float(torch.linalg.vector_norm(pick(leaf(tree, n)).float())) for n in names}


def judge(got: dict, ref: dict, limits: dict) -> dict:
    """The compared numbers, each with its limit:

    - ``loss``: the largest |loss - reference| / reference over the steps;
    - ``grad``: the worst leaf's gap between the norms of the first
      gradient as the optimizer takes it, against the larger of the
      reference's norm of that leaf and of its median leaf;
    - ``delta``: the same for the change of the weights over the steps,
      over the leaves whose reference gradient is at least a thousandth of
      the median leaf's (the rest move by round-off alone);
    - ``ef``: the same for the error feedback after the first step (a
      compressed step)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g = sorted(ref["grad"].values())
    moving = {n for n, v in ref["grad"].items() if v >= 1e-3 * g[len(g) // 2]}
    out = {"loss": (loss, limits["loss"]),
           "grad": (harness.worst_leaf_gap(got["grad"], ref["grad"]), limits["grad"]),
           "delta": (harness.worst_leaf_gap(got["delta"], ref["delta"], moving),
                     limits["delta"])}
    if ref.get("ef"):
        out["ef"] = (harness.worst_leaf_gap(got["ef"], ref["ef"]), limits["ef"])
    return out


def drive(run: harness.Run, conf: dict, seed: int, seconds: float, trace: bool,
          device) -> harness.Run:
    import torch.distributed as dist
    from repro_torch.train import step as step_mod

    from perfbench.trace import Tracer

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arch, mix = run.arch, run.mix
    cfg = harness.arch_config(run.workload.split(".")[0], conf, mix)
    run.mark("imports")
    planes_n = mix.get("compress_planes", 0)
    first = mix["setup_steps"]
    if planes_n:
        one_member_group(device)
        run.mark("group")
    try:
        opt = optimizer(mix)
        gen = torch.Generator(device=device).manual_seed(0)
        state = step_mod.init_state(cfg, opt, gen, ef_planes=planes_n, device=device)
        load_weights(state["params"], arch, seed, device)
        run.mark("state")
        names = [n for n, _, _ in weights.all_leaf_specs(arch)]
        step_fn = step_mod.make_train_step(cfg, opt, compress_planes=planes_n)
        batches = traffic.train_batches(mix, arch.vocab, seed, device, first + mix["max_steps"])
        feed = [{"tokens": t, "labels": lab} for t, lab in batches]
        got = {"loss": []}
        for k in range(first):
            state, met = step_fn(state, feed[k])
            got["loss"].append(float(met["loss"]))
            if k == 0:
                run.mark("first_step")
                b1 = mix["optimizer"]["b1"]
                got["grad"] = {n: v / (1 - b1)
                               for n, v in norms(state["opt"].m, names).items()}
                if planes_n:
                    got["ef"] = norms(state["ef"], names, lambda t: t[0])
        run.mark("next_steps")
        got["delta"] = ref_train.delta_norms(
            arch, seed, {n: leaf(state["params"], n) for n in names}, device)
        tracer = Tracer(device) if trace else None
        tr = mix["trace"]
        tokens = mix["batch"] * mix["seq"]
        gc.collect()
        gc.freeze()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        run.t0 = t = time.perf_counter()
        run.setup_s = run.t0 - run.t_start
        run.mark("readings")
        k, traced = first, []
        while t - run.t0 < seconds and k < len(feed):
            if tracer and k - first == tr["start_step"]:
                tracer.start()
                t = time.perf_counter()
            state, met = step_fn(state, feed[k])
            sync()
            end = time.perf_counter()
            run.steps.append((t, end, tokens))
            if tracer and tr["start_step"] <= k - first < tr["start_step"] + tr["steps"]:
                traced.append(k)
                if len(traced) == tr["steps"]:
                    tracer.stop(traced)
                    end = time.perf_counter()
            k += 1
            t = end
        if tracer and traced and not tracer.stopped:
            tracer.stop(traced)
        gc.unfreeze()
        run.t1 = run.steps[-1][1] if run.steps else run.t0
        run.attempted = len(run.steps)
        if cuda:
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        if tracer:
            run.trace = tracer.reduce()
        del state, met, step_fn
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ref = ref_train.follow(arch, seed, batches[:first], mix, device)
        run.checks = judge(got, ref, harness.limits_file(run.workload))
        run.check_s = time.perf_counter() - t_check
    finally:
        if planes_n:
            dist.destroy_process_group()
    return run
