"""The check's control and planted faults, read at a cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 \
        --variant fp8|half_batch|no_exchange [--out DIR]

puts the reference in the program's place and judges its answers as a run
of the cell judges the program's (the same sample, the same judge):

- ``fp8``, the control: the reference computed with float8 (e4m3) operands
  in every product, each scaled by its absolute maximum, the nearest
  precision below the configurations' bfloat16;
- ``half_batch`` (training): the loss over the first half of each batch's
  rows, the mean over the rest;
- ``no_exchange`` (compressed training): the planes round trip of the
  gradient left out, no error feedback.

A state left unchanged reads 1 on ``delta`` by its definition and needs no
run.  Each seed prints one line ``{"seed", "variant", "checks"}``.  The
benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def prefill_readings(workload: str, conf: dict, mix: dict, seed: int, device, limits: dict):
    """The prefill check's numbers with the float8 reference in the
    program's place: its first token, last logits and planes-encoded K/V
    for each sampled request, judged by the run's own judge."""
    import torch

    from perfbench import traffic
    from perfbench.drivers.prefill import judge
    from perfbench.reference import model, planes, weights

    arch = model.Arch.from_config(conf)
    reqs = traffic.Requests(mix, arch.vocab, seed, device)
    w = weights.make_all(arch, seed, device)
    answers = {}
    for i in traffic.check_sample(mix, reqs.lengths, seed):
        enc = []

        def keep(j, k, v, enc=enc):
            enc.append([planes.encode(t, mix["num_planes"]) for t in (k, v)])

        logits = model.prefill(w, arch, reqs.prompt(i)[0], mm=model.Fp8(), on_layer=keep)

        def kv(j, enc=enc, s=reqs.lengths[i]):
            return (torch.arange(s),) + tuple(planes.decode(*e) for e in enc[j])

        answers[i] = (int(logits.argmax()), logits, kv)
    return judge(arch, w, reqs, answers, limits)


def train_readings(workload: str, conf: dict, mix: dict, seed: int, device, limits: dict,
                   variant: str):
    from perfbench import traffic
    from perfbench.drivers.train import judge
    from perfbench.reference import model, train

    arch = model.Arch.from_config(conf)
    batches = traffic.train_batches(mix, arch.vocab, seed, device, mix["setup_steps"])
    kw = {"fp8": dict(mm=model.Fp8()), "half_batch": dict(half_batch=True),
          "no_exchange": dict(exchange=False)}[variant]
    got = train.follow(arch, seed, batches, mix, device, **kw)
    ref = train.follow(arch, seed, batches, mix, device)
    return judge(got, ref, limits)


def readings(workload: str, seed: int, variant: str, device="cuda", bench=None) -> dict:
    from perfbench import harness

    bench = bench or harness.load_bench()
    cell = harness.cell(bench, workload)
    conf = harness.config_file(bench, cell["config"])
    mix = harness.mix_file(cell["traffic"])
    limits = harness.limits_file(workload)
    if mix["kind"] == "prefill":
        if variant != "fp8":
            raise ValueError(f"a prefill cell has no variant {variant!r}")
        return prefill_readings(workload, conf, mix, seed, device, limits)
    return train_readings(workload, conf, mix, seed, device, limits, variant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variant", default="fp8", choices=("fp8", "half_batch", "no_exchange"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = readings(args.workload, seed, args.variant)
        line = {"workload": args.workload, "seed": seed, "variant": args.variant,
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0),
                "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"control.{args.workload}.{args.variant}.jsonl")
        with open(path, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
