"""The port's training CLI (`python -m tokenpacker_tpu_torch.train.train`)
against the JAX package's, run with `--device cpu` (the counterparts of
`tests/test_train_cli.py`).

A full tiny checkpoint in the reference's layout (`test_torch_api.
write_layout`, the LM 128 wide, so that the default quantization's
min_size of 2^16 takes gate, up and down and leaves q, k, v, o and the
head dense) and 8 captioned images; the tokenizer is the word-level
stand-in, HF is set offline. Stage 1 writes `mm_projector.bin`;
`--bits 8` and `--bits 4 --lora-enable` write the reference's LoRA files;
a checkpoint written by either CLI loads through both packages' `api`
(over the base directory) with identical greedy tokens;
`--bits 4` without `--lora-enable` exits as JAX's CLI does; a second run
into the same directory resumes.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tokenpacker_tpu import api as jax_api
from tokenpacker_tpu.train import train as jax_train_cli
from tokenpacker_tpu_torch import api
from tokenpacker_tpu_torch.serve.multi_lora import load_adapter
from tokenpacker_tpu_torch.train import train as train_cli
from tokenpacker_tpu_torch.train.lora import NAME_MAP
from test_torch_api import IdTok, _tokens, write_layout

import jax.numpy as jnp

LORA = ["--lora-enable", "--lora-r", "4", "--lora-alpha", "8"]


@pytest.fixture
def run(tmp_path, monkeypatch):
    """The checkpoint, the data and both packages' tokenizer loader
    replaced; returns a function that builds a CLI argv."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.delenv("TOKENPACKER_CLIP_PATH", raising=False)
    for mod in (api, jax_api):
        monkeypatch.setattr(mod, "_load_tokenizer", lambda path: IdTok())
    model_path, _, _, _ = write_layout(tmp_path, "full bin")
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(
            img_dir / f"im{i}.png")
        records.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\ncaption please"},
            {"from": "gpt", "value": f"thing {i}"}]})
    (tmp_path / "data.json").write_text(json.dumps(records))

    def argv(out: str, *extra, batch: int = 8, device: bool = True):
        return (["--model-path", model_path, "--data-path", str(tmp_path / "data.json"),
                 "--image-folder", str(img_dir), "--output-dir", str(tmp_path / out),
                 "--per-device-batch-size", str(batch), "--model-max-length", "64",
                 "--learning-rate", "1e-3"] + (["--device", "cpu"] if device else [])
                + list(extra))

    argv.model_path = model_path
    argv.root = tmp_path
    return argv


def _lora_files_ok(ckpt, n_layers: int):
    for name in ("adapter_model.bin", "adapter_config.json", "non_lora_trainables.bin"):
        assert (ckpt / name).is_file(), name
    acfg = json.loads((ckpt / "adapter_config.json").read_text())
    assert acfg == {"r": 4, "lora_alpha": 8, "lora_dropout": 0.05, "peft_type": "LORA"}
    sd = torch.load(ckpt / "adapter_model.bin", weights_only=True)
    want = {f"base_model.model.model.layers.{i}.{mod}.lora_{p}.weight"
            for i in range(n_layers) for mod in NAME_MAP.values() for p in "AB"}
    assert set(sd) == want
    nlt = torch.load(ckpt / "non_lora_trainables.bin", weights_only=True)
    assert nlt and all(k.startswith("base_model.model.model.mm_projector.") for k in nlt)
    return sd


def test_help_lists_the_jax_flags_and_device():
    ours = {a for act in train_cli.build_parser()._actions for a in act.option_strings}
    theirs = {a for act in jax_train_cli.build_parser()._actions for a in act.option_strings}
    assert ours == theirs | {"--device"}


def test_stage1_writes_mm_projector(run):
    trainer = train_cli.main(run("stage1", "--stage", "pretrain", "--version", "plain"))
    sd = torch.load(run.root / "stage1" / "checkpoint-1" / "mm_projector.bin", weights_only=True)
    assert sd and all(k.startswith("model.mm_projector.") for k in sd)
    assert [r["step"] for r in trainer.history] == [1]


@pytest.mark.parametrize("bits", ["8", "4"])
def test_lora_cli_writes_the_reference_files(run, bits):
    """`--bits 8|4 --lora-enable`: the three reference files with every
    target's keys; the base stays quantized, the adapters trained; the
    directory loads through the port's `api` over the base and through
    `multi_lora.load_adapter`, and (4-bit, the QLoRA recipe) through JAX's
    `api` with the same greedy tokens."""
    trainer = train_cli.main(run("lora", "--bits", bits, *LORA, "--num-train-epochs", "2",
                                 "--save-total-limit", "2", "--save-steps", "1"))
    n_layers = trainer.cfg.lm.num_hidden_layers
    ckpt = run.root / "lora" / "checkpoint-2"
    sd = _lora_files_ok(ckpt, n_layers)
    first = torch.load(run.root / "lora" / "checkpoint-1" / "adapter_model.bin",
                       weights_only=True)
    assert all(not v.any() for k, v in first.items() if "lora_B" in k)  # step 1: lr 0
    assert any(v.any() for k, v in sd.items() if "lora_B" in k)
    key = "q" if bits == "8" else "q4:nf4:64"
    mlp = trainer.params["lm"]["layers"][0]["mlp"]
    assert key in mlp["gate"]["kernel"] and isinstance(
        trainer.params["lm"]["layers"][0]["attn"]["q"]["kernel"], torch.Tensor)
    assert trainer.lora["layers"][0]["mlp"]["gate"]["a"].dtype == torch.bfloat16
    adapter = load_adapter(str(ckpt), trainer.cfg, torch.float32)
    assert adapter.r == 4 and len(adapter.lora) == 7 and adapter.projector is not None
    port = api.load_pretrained_model(str(ckpt), run.model_path, dtype=torch.float32,
                                     device="cpu")
    base = api.load_pretrained_model(run.model_path, dtype=torch.float32, device="cpu")
    moved = (port[1].params["lm"]["layers"][0]["mlp"]["up"]["kernel"]
             - base[1].params["lm"]["layers"][0]["mlp"]["up"]["kernel"]).abs().max()
    assert moved > 0
    if bits == "4":
        want = jax_api.load_pretrained_model(str(ckpt), run.model_path, dtype=jnp.float32)
        got, jgot = _tokens(port, want)
        assert got == jgot


def test_jax_cli_checkpoint_loads_through_the_port(run):
    """The JAX CLI's QLoRA checkpoint (`--bits 8`, one step of 8 on its
    8-device CPU mesh) loads through the port's `api` as through JAX's,
    with the same greedy tokens."""
    jax_train_cli.main(run("jax", "--bits", "8", *LORA, batch=1, device=False))
    ckpt = run.root / "jax" / "checkpoint-1"
    _lora_files_ok(ckpt, 2)
    (ckpt / "config.json").write_text((run.root / "tokenpacker-tiny" / "config.json").read_text())
    port = api.load_pretrained_model(str(ckpt), run.model_path, dtype=torch.float32,
                                     device="cpu")
    want = jax_api.load_pretrained_model(str(ckpt), run.model_path, dtype=jnp.float32)
    got, jgot = _tokens(port, want)
    assert got == jgot


def test_bits_without_lora_exits_as_jax(run):
    with pytest.raises(SystemExit) as ours:
        train_cli.main(run("x", "--bits", "4"))
    with pytest.raises(SystemExit) as theirs:
        jax_train_cli.main(run("y", "--bits", "4", device=False))
    assert str(ours.value) == str(theirs.value) and "--lora-enable" in str(ours.value)


def test_lora_run_resumes(run):
    """A second run into the same directory starts from the latest LoRA
    checkpoint: its adapters, projector, optimizer state and step."""
    first = train_cli.main(run("resume", "--bits", "4", *LORA, "--save-total-limit", "3"))
    again = train_cli.main(run("resume", "--bits", "4", *LORA, "--save-total-limit", "3"))
    assert [r["step"] for r in first.history] == [1]
    assert [r["step"] for r in again.history] == [2]
    assert again.opt_state["count"] == {"lora": 2, "projector": 2}
    sd1 = torch.load(run.root / "resume" / "checkpoint-1" / "adapter_model.bin",
                     weights_only=True)
    sd2 = torch.load(run.root / "resume" / "checkpoint-2" / "adapter_model.bin",
                     weights_only=True)
    assert any(not torch.equal(sd1[k], sd2[k]) for k in sd1 if "lora_B" in k)
