"""Finding what a cell needs by the names in `BENCHMARK.json`.

A cell names a configuration and a traffic mix; each lives in a file of its
own: `configs/<config>.json` (the manifest's `file`), `traffic/<traffic>.json`,
the cell's correctness limits in `limits/<cell>.json` and, for each
per-layer metric, `metrics/<metric name>.py`. A later change
adds a cell, a configuration, a mix or a metric by adding files and entries,
never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class Manifest:
    """`BENCHMARK.json` at `root`, with the benchmark's files under
    `root / <paths[0]>`."""

    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {self.root}")
        self.data = json.loads(path.read_text())
        self.bench_dir = self.root / self.data["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        """The configuration's file, parsed, with the manifest entry under
        `_entry`."""
        for c in self.data["configs"]:
            if c["name"] == name:
                out = json.loads((self.root / c["file"]).read_text())
                out["_entry"] = c
                return out
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.bench_dir / "traffic" / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no traffic file {path}")
        return json.loads(path.read_text())

    def limits(self, cell: str) -> dict:
        """The cell's correctness limits (`limits/<cell>.json`)."""
        path = self.bench_dir / "limits" / f"{cell}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no limits file {path}")
        return json.loads(path.read_text())

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` entries that this cell reports: those
        whose `workloads` list it, or that have no such list."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The per-layer metric's reader module (`metrics/<name>.py`)."""
        return load_module(self.bench_dir / "metrics" / f"{metric}.py", f"metric_{metric}")


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_manifest(data: dict) -> list[str]:
    """The manifest's names, units and cross references against the
    benchmark's rules; returns the faults found (empty when sound)."""
    faults = []

    def name_ok(what, x):
        if not isinstance(x, str) or not NAME_RE.match(x):
            faults.append(f"{what}: bad name {x!r}")

    configs = {c["name"] for c in data["configs"]}
    cells = {w["name"] for w in data["workloads"]}
    for c in data["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok(f"config {c['name']} reduced", k)
    for w in data["workloads"]:
        name_ok("workload", w["name"])
        name_ok(f"workload {w['name']} traffic", w["traffic"])
        if w["config"] not in configs:
            faults.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            faults.append(f"workload {w['name']}: chips {w['chips']}")
    e2e = {m["name"]: m for m in data["end_to_end"]}
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in data[kind]:
            name_ok(kind, m["name"])
            if m["name"] in seen:
                faults.append(f"metric {m['name']} twice")
            seen.add(m["name"])
            if not UNIT_RE.match(m["unit"]):
                faults.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                faults.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                faults.append(f"metric {m['name']}: source {m['source']!r}")
            for cell in m.get("workloads", []):
                if cell not in cells:
                    faults.append(f"metric {m['name']}: unknown workload {cell!r}")
            if kind == "per_layer":
                moved = e2e.get(m["moves"])
                if moved is None:
                    faults.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
                else:
                    for cell in m.get("workloads", sorted(cells)):
                        if cell not in moved.get("workloads", [cell]):
                            faults.append(f"metric {m['name']}: {cell} does not report "
                                          f"{m['moves']}")
    if "setup_s" not in e2e:
        faults.append("no setup_s")
    return faults
