"""Fixtures of the benchmark's CPU tests: the harness's modules on the path,
and a tiny copy of the benchmark (the same cells, metrics and drivers over
a configuration a CPU runs in seconds) that the harness runs on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config(conf: dict) -> dict:
    """The configuration at a CPU's size: every width and depth cut, the
    structure (families, slice or pad mode, layer selection) kept."""
    c = copy.deepcopy(conf)
    c["lm"].update(d_model=64, n_heads=4, n_layers=2, vocab_size=256, max_seq_len=512)
    c["vision"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                       num_attention_heads=4, image_size=56, multi_layers=[1, 2, 3, 4])
    c["projector"].update(embed_dim=32)
    c["assumed"]["tokenizer"].update(text_vocab=250, newline_id=7, sep_id=5)
    # at these widths N(0, 0.02^2) kernels leave the residual stream to the
    # embeddings, and greedy tokens that no fault can move
    c["assumed"]["kernel_std"] = 0.2
    c["dtype"] = c["kv_cache_dtype"] = "float32"
    return c


def tiny_limits(limits: dict) -> dict:
    """float32 on the CPU against the float32 reference: both compute the same
    arithmetic, so the readings are rounding (0 to 1e-6) and a fault shows."""
    return {k: 1e-3 for k in limits if k != "why"}


def tiny_traffic(t: dict) -> dict:
    t = copy.deepcopy(t)
    if t["driver"] == "chat":
        t.update(rate_per_s=24.0, preroll_s=0.5, drain_limit_s=30)
        t["answer_tokens"].update(median=16, min=8, max=24)
        t["batcher"].update(num_slots=4, max_seq_len=512, prefill_chunk_size=32)
        t["check"].update(requests=4, min_tokens=16)
        t["trace"].update(settle_s=0.1, slice_s=0.2)
    if t["driver"] == "offline":
        t.update(batch_size=4, cycle_batches=2)
        t["check"].update(requests=8, min_tokens=8)
    if t["driver"] == "pretrain":
        t.update(per_device_batch_size=2, gradient_accumulation_steps=2, updates=64,
                 setup_updates=2, seq_pad_to=96, distinct_images=4)
        t["images"] = [[60, 45, 0.5], [40, 56, 0.5]]
        t["trace"].update(skip_micro_steps=0, micro_steps=2)
    return t


def manifest_with_held_out() -> dict:
    """BENCHMARK.json with the entries of the cells held out of it
    (`held_out.json`, which says why each is out)."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    held = json.loads((BENCH / "held_out.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        manifest[key] = manifest[key] + held.get(key, [])
    return manifest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-shaped directory: BENCHMARK.json (with the held-out cell) and
    benchmark/ with tiny configurations and traffic, the real metric readers."""
    manifest = manifest_with_held_out()
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for c in manifest["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        (tmp_path / c["file"]).write_text(json.dumps(tiny_config(conf)))
    for w in manifest["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tiny_traffic(t)))
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        (bench / "limits" / f"{w['name']}.json").write_text(json.dumps(tiny_limits(lim)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's card tests)")
    return torch.device("cuda", 0)
