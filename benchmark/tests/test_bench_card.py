"""On the card (skipped without one): each cell's program readings stay
under its limit and its control, the reference in float8, reads over it,
at the cell's own sizes, on one seed with a short window. Run with

    python -m pytest benchmark/tests/test_bench_card.py -q

The full readings the limits were set from (a dozen seeds, the control on
three) come from `tools/calibrate.py`; PERF.md lists them."""

from __future__ import annotations

import json

import pytest

import run as bench_run
from tools import calibrate

@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("llava-mpt-7b-hd9.chat", 10),
                                          ("llava-mpt-7b-hd9.vqa-offline", 3)])
def test_control_fails_and_program_passes(card, tmp_path, cell, seconds):
    out = tmp_path / "readings.jsonl"
    calibrate.main(["--workload", cell, "--seeds", "1", "--control-seeds", "1",
                    "--seconds", str(seconds), "--out", str(out)])
    row = json.loads(out.read_text().splitlines()[0])
    assert row["correct"], row["program"]
    limits = json.loads((bench_run.BENCH_DIR / "limits" / f"{cell}.json").read_text())
    assert row["control"]["logit_gap"] > limits["served_logit_gap"]
