"""The benchmark of the PyTorch / CUDA port (`tokenpacker_tpu_torch`).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Finds the cell in BENCHMARK.json, its
configuration under configs/ and its traffic under traffic/, builds the
program's entry from them, warms it up on the cell's traffic, measures for
`--seconds`, reads the program's outputs against the plain reference under
reference/, and prints one JSON line last on standard output: the cell's
end-to-end metrics (`--trace 0`) or its per-layer metrics from metrics/
(`--trace 1`). Exits non-zero, with no result, without enough CUDA cards,
and when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))
# a library the port imports must not pull JAX in through its Flax hooks
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

from benchlib import peaks, stats, work  # noqa: E402
from benchlib.drivers import holds  # noqa: E402
from benchlib.guard import forbidden_modules  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402


class Run:
    """What a per-layer reader reads: the driver's records, the trace slice,
    the configuration's widths, the peaks, the work counts and the
    statistics."""

    def __init__(self, outcome, conf: dict):
        self.data = outcome.data
        self.trace = outcome.trace
        self.widths = work.Widths.of(conf)
        self.peaks = peaks
        self.work = work
        self.stats = stats


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, root: Path = REPO, device=None):
    """Run the cell; returns (result dict, outcome). `device` None: the card,
    which must be there."""
    import importlib

    import torch

    from benchlib.drivers import Context

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    driver = importlib.import_module(f"benchlib.drivers.{traffic['driver']}")
    ctx = Context(conf=conf, traffic=traffic, limits=manifest.limits(args.workload),
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device(device), t_process=T_PROCESS)
    out = driver.run(ctx)
    metrics = {}
    if args.trace:
        run = Run(out, conf)
        for m in manifest.metrics(args.workload, "per_layer"):
            value = manifest.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics(args.workload, "end_to_end"):
            value = out.window_start - T_PROCESS if m["name"] == "setup_s" else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": out.memory_peak}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if args.trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim, "holds": holds((name, v, lim, op))}
                        for name, v, lim, op in out.checks}
    return result, out


def main(argv=None) -> int:
    args = parse(argv)
    result, out = measure(args)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for name, value in out.data.get("diagnosis", {}).items():
        print(f"{name}: {value!r}", file=sys.stderr)
    print(f"requests or steps failed: {out.failed} of {out.attempted}", file=sys.stderr)
    for name, v, lim, op in out.checks:
        print(f"check {name}: {v!r} {op} {lim!r}: {'holds' if holds((name, v, lim, op)) else 'FAILS'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
