"""Every cell of BENCHMARK.json run through the harness on the CPU at a tiny
size: the driver, the reference check and the result line, both with
`--trace 0` (the end-to-end metrics) and the readers' arithmetic."""

from __future__ import annotations

import json

import pytest

import run as bench_run
from conftest import manifest_with_held_out

CELLS = [w["name"] for w in manifest_with_held_out()["workloads"]]


def measure(root, cell, seed=7, seconds=1.0, trace=0):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace)])
    return bench_run.measure(args, root=root, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(tiny_root, cell):
    result, out = measure(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_per_layer_metrics(tiny_root, cell):
    """`--trace 1`: the same correctness, a slice traced after the window, the
    per-layer metrics that find something to read on the CPU (no device ops: the rooflines and idle
    shares stay out), `busy_s`, `window_s` and a breakdown."""
    result, out = measure(tiny_root, cell, seconds=1.5, trace=1)
    assert result["correct"], result["checks"]
    # the profiler runs after the window, never inside it
    if "window_step_range" in out.data:
        assert out.data["trace_step_range"][0] >= out.data["window_step_range"][1]
    if "traced_batches" in out.data:
        assert out.data["traced_batches"]
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in manifest["per_layer"] if cell in m.get("workloads", [cell])}
    assert result["metrics"] and set(result["metrics"]) <= listed
    assert not any("roofline" in m or "idle_share" in m for m in result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
