"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card it is started on and prints,
as the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``setup_parts`` (the seconds of each part of set-up), and
last ``checks``: each number compared with the reference
beside its limit (also the last lines of standard error).  ``--out DIR``
also writes the run's requests or steps and trace summary to
``DIR/<workload>.<seed>.<trace>.json``.

It exits with a code other than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), without the program, or with
JAX or the JAX package loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# run as a script, this folder heads sys.path: its modules must not shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
os.environ.setdefault("NCCL_SHM_DISABLE", "1")   # one member: nothing to share, nothing in /dev/shm

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def execute(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
            bench: dict | None = None, t_start: float | None = None,
            marks: tuple = ()) -> tuple[dict, object]:
    """Run one cell on ``device``; returns (the result object, the Run).
    ``marks`` are (set-up part, host time at its end) already passed."""
    import torch

    from perfbench import harness
    from perfbench.reference import model

    bench = bench or harness.load_bench()
    cell = harness.cell(bench, workload)
    conf = harness.config_file(bench, cell["config"])
    mix = harness.mix_file(cell["traffic"])
    kind = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    t0 = T_START if t_start is None else t_start
    run = harness.Run(workload, model.Arch.from_config(conf), mix, kind, t_start=t0, t_mark=t0)
    for part, t in marks:
        run.setup_parts[part], run.t_mark = t - run.t_mark, t
    driver = __import__(f"perfbench.drivers.{mix['kind']}", fromlist=["drive"])
    driver.drive(run, conf, seed, seconds, trace, device)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for m in harness.metrics_for(bench, workload, trace):
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    # where set-up went; a checkout's first run builds the kernels in its
    # first prefill or step
    out["setup_parts"] = run.setup_parts
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return out, run


def details(run) -> dict:
    """The run's requests or steps and its trace summary, for ``--out``."""
    d = {"setup_s": run.setup_s, "setup_parts": run.setup_parts, "window_s": run.window_s,
         "check_s": run.check_s,
         "requests": run.requests, "steps": run.steps}
    if run.trace is not None:
        d["trace"] = {"window_s": run.trace.window_s, "busy_s": run.trace.busy_s(),
                      "work": run.trace.work, "top_ops": run.trace.top_ops(30),
                      "idle_gaps": run.trace.idle_gaps(30)}
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="write the run's details here")
    args = ap.parse_args(argv)

    from perfbench import harness

    bench = harness.load_bench()
    chips = harness.cell(bench, args.workload)["chips"]
    import torch

    marks = [("torch", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not here ({e})", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks.append(("cuda_init", time.perf_counter()))
    out, run = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench,
                       marks=marks)
    found = banned_modules()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"{args.workload}.{args.seed}.{args.trace}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(details(run), f)
    print(f"perfbench: {args.workload} seed {args.seed}: setup {run.setup_s:.3f} s, "
          f"window {run.window_s:.3f} s, {run.attempted} done, check {run.check_s:.3f} s, "
          f"correct {out['correct']}",
          file=sys.stderr)
    print("perfbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
