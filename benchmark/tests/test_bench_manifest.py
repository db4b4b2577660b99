"""BENCHMARK.json against the benchmark's rules, and the check that fails a run
with JAX or the JAX package loaded."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchlib.guard import forbidden_modules
from benchlib.manifest import BENCH_DIR, Manifest, NAME_RE, UNIT_RE, check_manifest
from conftest import manifest_with_held_out

REPO = BENCH_DIR.parent
DATA = json.loads((REPO / "BENCHMARK.json").read_text())
E2E = {"itl_p95_ms", "answers_per_s", "setup_s"}


def test_manifest_sound():
    assert check_manifest(DATA) == []
    assert check_manifest(manifest_with_held_out()) == []
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert {m["name"] for m in DATA["end_to_end"]} == E2E
    assert [w["name"] for w in DATA["workloads"]] == [
        "llava-mpt-7b-hd9.chat", "llava-mpt-7b-hd9.vqa-offline"]
    assert all(w["chips"] == 1 for w in DATA["workloads"])


def test_entries_keys_and_lengths():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for kind, want in keys.items():
        for e in DATA[kind]:
            assert set(e) == want
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in DATA["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DATA["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(DATA).encode()) <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51


def test_names_units_and_files():
    for kind in ("end_to_end", "per_layer"):
        for m in DATA[kind]:
            assert NAME_RE.match(m["name"]) and UNIT_RE.match(m["unit"])
    man = Manifest(REPO)
    for w in DATA["workloads"]:
        assert NAME_RE.match(w["name"]) and NAME_RE.match(w["traffic"])
        man.traffic(w["traffic"])
        assert all(v is not None for k, v in man.limits(w["name"]).items())
        assert man.config(w["config"])["name"] == w["config"]
    for m in manifest_with_held_out()["per_layer"]:
        assert callable(man.reader(m["name"]).read)
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(path.relative_to(REPO)))


def test_name_rules_refuse():
    bad = json.loads(json.dumps(DATA))
    bad["per_layer"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "per second"
    faults = check_manifest(bad)
    assert any("bad name" in f for f in faults) and any("bad unit" in f for f in faults)


@pytest.mark.parametrize("loaded,found", [
    (["jax", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["tokenpacker_tpu", "tokenpacker_tpu.models.mpt"], ["tokenpacker_tpu", "tokenpacker_tpu.models.mpt"]),
    (["tokenpacker_tpu_torch", "tokenpacker_tpu_torch.generate", "jaxtyping", "torch"], []),
])
def test_forbidden_modules(loaded, found):
    assert forbidden_modules(loaded) == found


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; import run; "
            "import reference.serve, reference.train, benchlib.drivers.chat, "
            "benchlib.drivers.offline, benchlib.drivers.pretrain; "
            "from benchlib.guard import forbidden_modules; "
            "assert not forbidden_modules(), forbidden_modules(); "
            "import importlib; [importlib.import_module(m) for m in ('reference.clip', "
            "'reference.mpt', 'reference.projector', 'reference.splice', 'reference.image')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] == 'tokenpacker_tpu_torch']; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code, str(BENCH_DIR), str(REPO)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_run_refuses_without_card_or_files(tmp_path):
    r = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                        "llava-mpt-7b-hd9.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
