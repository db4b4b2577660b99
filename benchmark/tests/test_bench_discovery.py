"""A later change adds a configuration, a traffic mix, a cell and a per-layer
metric as files and entries of their own; the harness finds them by name,
with no file that is there edited."""

from __future__ import annotations

import hashlib
import json

import run as bench_run
from benchlib.manifest import BENCH_DIR

READER = '''
def read(run):
    """Decode steps of the window (a made-up metric)."""
    return float(run.data["window_steps"]) or None
'''


def digest() -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in BENCH_DIR.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_found_by_name(tiny_root):
    before = digest()
    bench = tiny_root / "benchmark"
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    conf = json.loads((tiny_root / "benchmark/configs/llava-mpt-7b-hd9.json").read_text())
    conf["name"] = "llava-mpt-7b-hd4"
    conf["patch_num"] = 9
    conf["lm"]["n_layers"] = 1
    (bench / "configs" / "llava-mpt-7b-hd4.json").write_text(json.dumps(conf))
    chat = json.loads((bench / "traffic" / "chat.json").read_text())
    chat["rate_per_s"] = 12.0
    chat["images"] = [[300, 300, 1.0]]
    (bench / "traffic" / "chat-small.json").write_text(json.dumps(chat))
    (bench / "metrics" / "batcher.steps.small.py").write_text(READER)
    manifest["configs"].append({"name": "llava-mpt-7b-hd4", "source": "https://example.org/x",
                                "file": "benchmark/configs/llava-mpt-7b-hd4.json",
                                "reduced": ["n_layers"], "why": "a test"})
    manifest["workloads"].append({"name": "llava-mpt-7b-hd4.chat-small", "config": "llava-mpt-7b-hd4",
                                  "traffic": "chat-small", "chips": 1, "why": "a test"})
    (bench / "limits" / "llava-mpt-7b-hd4.chat-small.json").write_text(
        json.dumps({"served_logit_gap": 1e-3}))
    for m in manifest["end_to_end"]:
        if "workloads" in m and "llava-mpt-7b-hd9.chat" in m["workloads"]:
            m["workloads"].append("llava-mpt-7b-hd4.chat-small")
    manifest["per_layer"].append({"name": "batcher.steps.small", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "batcher",
                                  "moves": "itl_p95_ms", "workloads": ["llava-mpt-7b-hd4.chat-small"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for trace in ("0", "1"):
        args = bench_run.parse(["--workload", "llava-mpt-7b-hd4.chat-small", "--seed", "5",
                                "--seconds", "1", "--trace", trace])
        result, _ = bench_run.measure(args, root=tiny_root, device="cpu")
        assert result["correct"], result["checks"]
        if trace == "1":
            assert set(result["metrics"]) == {"batcher.steps.small"}
        else:
            assert set(result["metrics"]) == {"itl_p95_ms", "setup_s"}
    assert digest() == before
