"""The highest arrival rate the chat cell's system sustains, found once by a
sweep on the card; the cell then offers a fixed share of it.

    python benchmark/tools/knee_sweep.py --workload llava-mpt-7b-hd9.chat \
        --rates 3,4,5,6,7,8 --seconds 20 --out chiprun_out/knee.jsonl

One process, one run of the cell's driver a rate (its traffic at that
rate). A rate is sustained where the queue does not grow over the window:
the median time to first token of the window's last third stays within
1.5x that of its first third, and every request of the window finished.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run as bench_run  # noqa: E402
from benchlib import stats  # noqa: E402
from benchlib.drivers import Context, free_device  # noqa: E402
from benchlib.drivers import chat  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402


def sustained(row: dict) -> bool:
    thirds = row["ttft_median_by_third_ms"]
    return row["failed"] == 0 and thirds[2] <= 1.5 * thirds[0]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="llava-mpt-7b-hd9.chat")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2_000_000_011)
    ap.add_argument("--repeat", type=int, default=1, help="runs a rate, the same seed")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda:0", help="cpu: a rehearsal at a tiny size")
    ap.add_argument("--root", default=str(bench_run.REPO), help="where BENCHMARK.json is")
    args = ap.parse_args(argv)
    manifest = Manifest(Path(args.root))
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    device = torch.device(args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for rate in (float(r) for r in args.rates.split(",") for _ in range(args.repeat)):
            t0 = time.perf_counter()
            ctx = Context(conf=conf, traffic=traffic, limits=manifest.limits(args.workload), seed=args.seed, seconds=args.seconds,
                          trace=False, device=device, t_process=t0, rate=rate)
            out = chat.run(ctx)
            d = out.data
            row = {"rate": rate, **out.e2e, "failed": out.failed, "attempted": out.attempted,
                   "ttft_median_by_third_ms": d["ttft_median_by_third_ms"],
                   "late_p95_ms": d["late_p95_ms"],
                   "step_ms": 1e3 * d["window_decode_s"] / max(d["window_steps"], 1),
                   "checks": {n: v for n, v, _, _ in out.checks},
                   "ttft_q_ms": {q: 1e3 * stats.quantile(d["ttft_s"], q / 100)
                                 for q in (50, 75, 90, 95, 99)},
                   "itl_q_ms": {q: 1e3 * stats.quantile(d["itl_s"], q / 100)
                                for q in (50, 75, 90, 95, 99)},
                   "seconds": time.perf_counter() - t0}
            row["sustained"] = sustained(row)
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            del ctx, out
            free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
