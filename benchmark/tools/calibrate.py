"""The readings a cell's correctness limits are set from, on the card.

    python benchmark/tools/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 10 --out chiprun_out/calibrate-<cell>.jsonl

In one process, for each seed: one run of the cell's driver (its own load,
a short window) gives the program's readings, the numbers its checks
compare (the lower readings). For the first `--control-seeds` seeds the
same inputs also go through the control, the reference computed in float8
(the upper reading of a serving cell), and, for a training cell, through
the reference with each planted fault: half of each micro-batch left out
(the mean over the rest), and one caption token altered where the data is
made. A state left unchanged reads 1 by the training measure and needs no
run. One JSON line a seed.
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
from benchlib.checks import control_gap, train_readings  # noqa: E402
from benchlib.drivers import Context, free_device  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402


def fault_batches(batches, fault: str, text_vocab: int):
    """The followed micro-batches with a fault planted where the data is made."""
    out = []
    for pixels, samples in batches:
        if fault == "half_batch":
            n = max(1, len(samples) // 2)
            out.append((pixels[:n], samples[:n]))
        else:  # token_altered: the first caption token of the first row
            ids, labels = samples[0]
            t = ids[1] % (text_vocab - 1) + 1
            out.append((pixels, [(ids[:1] + [t] + ids[2:], labels[:1] + [t] + labels[2:])]
                        + samples[1:]))
    return out


def leaf_table(start, got, ref, stored) -> list:
    """Per projector leaf: its size and mean |value|, and its first gradient's
    and change's norms in the program, the reference and the reference with
    bf16 storage."""
    from reference.train import _tree_leaves

    rows = []
    for path, t in _tree_leaves(start["projector"]):
        rows.append({"leaf": "/".join(map(str, path)), "numel": t.numel(),
                     "mean_abs": float(t.float().abs().mean()),
                     "grad": [float(x["first_grad"][path].float().norm()) for x in (got, ref, stored)],
                     "change": [float(x["change"][path].float().norm()) for x in (got, ref, stored)]})
    return rows


def main(argv=None) -> int:
    import importlib

    import torch

    from reference import mpt, train
    from reference.precision import Float8, Float32

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_007)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--leaves", action="store_true",
                    help="training: each leaf's readings, and the reference with bf16 storage")
    ap.add_argument("--device", default="cuda:0", help="cpu: a rehearsal at a tiny size")
    ap.add_argument("--root", default=str(bench_run.REPO), help="where BENCHMARK.json is")
    args = ap.parse_args(argv)
    manifest = Manifest(Path(args.root))
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    driver = importlib.import_module(f"benchlib.drivers.{traffic['driver']}")
    device = torch.device(args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            ctx = Context(conf=conf, traffic=traffic, limits=manifest.limits(args.workload), seed=seed, seconds=args.seconds, trace=False,
                          device=device, t_process=t0)
            out = driver.run(ctx)
            row = {"workload": args.workload, "seed": seed, "correct": out.correct,
                   "program": {name: value for name, value, _, _ in out.checks},
                   "e2e": out.e2e, "failed": out.failed, "attempted": out.attempted}
            if i < args.control_seeds:
                if traffic["driver"] == "pretrain":
                    start, recipe, batches, ref, got = ctx.cases
                    lm32 = mpt.upcast(start["lm"])
                    if args.leaves:
                        stored = train.follow(start, conf, recipe, batches, Float32(), lm32,
                                              store=torch.bfloat16)
                        row["bf16_storage"] = train_readings(stored, ref)
                        row["leaves"] = leaf_table(start, got, ref, stored)
                    row["control"] = train_readings(
                        train.follow(start, conf, recipe, batches, Float8(), lm32), ref)
                    for fault in ("half_batch", "token_altered"):
                        planted = fault_batches(batches, fault,
                                                conf["assumed"]["tokenizer"]["text_vocab"])
                        row[fault] = train_readings(
                            train.follow(start, conf, recipe, planted, Float32(), lm32), ref)
                    del lm32
                else:
                    weights, cases = ctx.cases
                    row["control"] = {"logit_gap": control_gap(weights, conf, cases, device)}
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            f.flush()
            del ctx, out
            free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
