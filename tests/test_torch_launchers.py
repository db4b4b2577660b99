"""The port's training launchers and its install.

- `tokenpacker_tpu_torch/train/scripts/*.sh` carry the JAX package's
  recipes (`scripts/{pretrain,finetune,pretrain_hd,finetune_hd}.sh`) flag
  for flag. Each launcher of both packages runs with a stand-in `python`
  first on PATH that writes its argv to a file; the port's argv, parsed
  by `tokenpacker_tpu_torch.train.train.build_parser`, gives the settings
  JAX's argv gives through JAX's parser. With NUM_DEVICES unset, the port's
  launchers reach the reference's global batch on one card.
- `pyproject.toml` names a `tokenpacker-torch-*` command for each of the
  JAX package's eight, and one that builds the native library; each
  resolves to a callable `main`. Every file of the port's package that is
  neither Python nor a build product matches a package-data glob.
"""

import fnmatch
import importlib
import os
import subprocess
import tomllib
from pathlib import Path

import pytest

from tokenpacker_tpu.train.train import build_parser as jax_build_parser
from tokenpacker_tpu_torch.train.train import build_parser as port_build_parser

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tokenpacker_tpu_torch"
LAUNCHERS = ("pretrain", "finetune", "pretrain_hd", "finetune_hd")
# the reference's global batch of each recipe (scripts/v1_5/*.sh)
GLOBAL_BATCH = {"pretrain": 256, "finetune": 128, "pretrain_hd": 256, "finetune_hd": 128}
STUB = """#!/bin/bash
printf '%s\\n' "$@" > "$ARGV_FILE"
"""


def _argv(script: Path, tmp: Path, env: dict) -> list:
    """The arguments `script` hands to `python`."""
    stub_dir = tmp / "bin"
    stub_dir.mkdir(exist_ok=True)
    (stub_dir / "python").write_text(STUB)
    (stub_dir / "python").chmod(0o755)
    out = tmp / f"argv-{script.parent.parent.name}-{script.stem}.txt"
    run_env = {k: v for k, v in os.environ.items()
               if k not in ("NUM_DEVICES", "GRAD_ACCUM", "MODEL_PATH", "DATA_PATH", "ADAPTER",
                            "IMAGE_FOLDER", "OUTPUT_DIR", "SCALE_FACTOR", "PATCH_NUM")}
    run_env.update(PATH=f"{stub_dir}:{os.environ['PATH']}", ARGV_FILE=str(out), **env)
    proc = subprocess.run(["bash", str(script)], cwd=tmp, env=run_env, capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
    return out.read_text().splitlines()


def _settings(argv: list, module: str, parser) -> dict:
    assert argv[:2] == ["-m", module], argv[:2]
    return vars(parser.parse_args(argv[2:]))


@pytest.mark.parametrize("name", LAUNCHERS)
def test_training_launcher_carries_the_jax_recipe(name, tmp_path):
    env = {"NUM_DEVICES": "8"}
    if name == "finetune_hd":  # the recipe has no default for these
        env.update(ADAPTER="ckpt/mm_projector.bin", DATA_PATH="data.json")
    want = _settings(_argv(REPO / "scripts" / f"{name}.sh", tmp_path, env),
                     "tokenpacker_tpu.train.train", jax_build_parser())
    got = _settings(_argv(PORT / "train" / "scripts" / f"{name}.sh", tmp_path, env),
                    "tokenpacker_tpu_torch.train.train", port_build_parser())
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    parser = port_build_parser()  # the port's own flags (--device, --tp, ...) keep defaults
    assert {k: got[k] for k in set(got) - set(want)} == {k: parser.get_default(k)
                                                         for k in set(got) - set(want)}
    # one card: the accumulation makes up the reference's global batch
    env.pop("NUM_DEVICES")
    one = _settings(_argv(PORT / "train" / "scripts" / f"{name}.sh", tmp_path, env),
                    "tokenpacker_tpu_torch.train.train", port_build_parser())
    assert one["per_device_batch_size"] * one["gradient_accumulation_steps"] == \
        GLOBAL_BATCH[name]
    assert {k: v for k, v in one.items() if k != "gradient_accumulation_steps"} == \
        {k: v for k, v in got.items() if k != "gradient_accumulation_steps"}


def test_port_commands_resolve_to_main():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    jax_cmds = {k: v for k, v in scripts.items() if v.startswith("tokenpacker_tpu.")}
    port_cmds = {k: v for k, v in scripts.items() if v.startswith("tokenpacker_tpu_torch.")}
    assert len(jax_cmds) == 8 and set(jax_cmds) | set(port_cmds) == set(scripts)
    want = {k.replace("tokenpacker-", "tokenpacker-torch-", 1):
            v.replace("tokenpacker_tpu.", "tokenpacker_tpu_torch.", 1)
            for k, v in jax_cmds.items()}
    want["tokenpacker-torch-native-build"] = "tokenpacker_tpu_torch.image.native:main"
    assert port_cmds == want
    for target in port_cmds.values():
        module, attr = target.split(":")
        assert attr == "main" and callable(getattr(importlib.import_module(module), attr))


def test_every_port_data_file_is_package_data():
    """Build products (`_kernels_build/`, bytecode, libraries) aside, every
    file of the port that is not Python matches a package-data glob, and
    every glob matches a file."""
    pyproject = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = pyproject["tool"]["setuptools"]["package-data"]["tokenpacker_tpu_torch"]
    data = []
    for path in PORT.rglob("*"):
        rel = path.relative_to(PORT).as_posix()
        if (path.is_dir() or rel.startswith("_kernels_build/") or "__pycache__" in rel
                or path.suffix in (".py", ".pyc", ".so", ".o")):
            continue
        data.append(rel)
    assert {"native/preprocess.cpp", "train/scripts/pretrain.sh",
            "eval/scripts/gqa.sh"} <= set(data)
    assert [f for f in data if not any(fnmatch.fnmatch(f, g) for g in globs)] == []
    assert all(any(fnmatch.fnmatch(f, g) for f in data) for g in globs), globs

