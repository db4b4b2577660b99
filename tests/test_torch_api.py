"""The port's public API (`api.load_pretrained_model`) and terminal chat
(`serve/cli`) against the JAX package, on the CPU.

Checkpoints are written into `tmp_path` from seeded random weights in the
reference's HF layout, in each layout the loader reads: a full `.bin`,
sharded `.bin`s, fp32 safetensors, a checkpoint without tower keys (the
tower from TOKENPACKER_CLIP_PATH), a stage-1 delta (a base LM plus
`mm_projector.bin`) and a LoRA adapter merged into its base. Both
packages load each one (`device="cpu"`, fp32): the same params leaf by
leaf, the same tokenizer path, context length and image processor, and
identical greedy tokens. `load_8bit` and `load_4bit` run on an LM 128
wide, where qkv, gate/up and down cross `min_size` (2^16 elements over
both layers) and o and the LM head ([128, 128] and [128, 256] a layer)
do not: int8 and 4-bit codes bit-equal, scales equal. No test reaches a
download: the tower comes from TOKENPACKER_CLIP_PATH or the checkpoint,
the tokenizer is a word-level stand-in, and HF is set offline.
"""

import builtins
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu import api as jax_api
from tokenpacker_tpu.serve import cli as jax_cli
from tokenpacker_tpu_torch import api
from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu_torch.data.conversation import conv_templates
from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token
from tokenpacker_tpu_torch.generate import pick_bucket
from tokenpacker_tpu_torch.io import hf_export, hf_import
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.serve import cli
from test_torch_checkpoint import _assert_same_tree, _write_lora
from tests.test_trainer import Tok

LM = dict(vocab_size=256, hidden_size=128, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
LAYOUTS = ["full bin", "sharded bin", "fp32 safetensors", "no tower keys", "stage-1 delta",
           "lora"]
NEW_TOKENS = 6


class IdTok(Tok):
    """The word tokenizer; decode writes one "<id>" a token, so that two
    texts compare their ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.delenv("TOKENPACKER_CLIP_PATH", raising=False)


@pytest.fixture
def tokenizers(monkeypatch):
    """Both packages' `_load_tokenizer` replaced; records the paths asked."""
    asked = {"port": [], "jax": []}
    for side, mod in (("port", api), ("jax", jax_api)):
        monkeypatch.setattr(mod, "_load_tokenizer",
                            lambda path, side=side: asked[side].append(path) or IdTok())
    return asked


def _cfg():
    return tiny_vlm_config(lm=LMConfig(**LM))


def _save(sd: dict, path, name="pytorch_model.bin"):
    path.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path / name)


def write_layout(root, layout: str, seed: int = 0):
    """Writes `layout` under root; returns (model_path, model_base, the
    state dict of the weights it holds, TOKENPACKER_CLIP_PATH or None)."""
    cfg = _cfg()
    params = init_vlm_on_device(cfg, seed=seed, device="cpu", dtype=torch.float32)
    sd = hf_export.to_torch_state_dict(hf_export.export_vlm_state_dict(params, cfg))
    tower = "model.vision_tower.vision_tower."
    path, base, clip = root / "tokenpacker-tiny", None, None
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    if layout == "full bin":
        _save(sd, path)
    elif layout == "sharded bin":
        keys = list(sd)
        _save({k: sd[k] for k in keys[: len(keys) // 2]}, path, "pytorch_model-00001-of-00002.bin")
        _save({k: sd[k] for k in keys[len(keys) // 2:]}, path, "pytorch_model-00002-of-00002.bin")
    elif layout == "fp32 safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path / "model.safetensors"))
    else:
        clip = root / "clip"
        _save({k[len(tower):]: v for k, v in sd.items() if k.startswith(tower)}, clip)
        no_tower = {k: v for k, v in sd.items() if not k.startswith(tower)}
        if layout == "no tower keys":
            _save(no_tower, path)
        elif layout == "stage-1 delta":
            base = root / "base"
            _save({k: v for k, v in no_tower.items() if "mm_projector" not in k}, base)
            _save({k: v for k, v in sd.items() if "mm_projector" in k}, path, "mm_projector.bin")
        else:  # lora: the base is the full checkpoint
            base = root / "base"
            _save(sd, base)
            _write_lora(path, cfg, seed + 7)
            clip = None
    return str(path), None if base is None else str(base), sd, None if clip is None else str(clip)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ids = [np.array([1, 17, IMAGE_TOKEN_INDEX, 40, 41, 42, 43], np.int64),
           np.array([1, IMAGE_TOKEN_INDEX, 50], np.int64)]
    plan = build_splice_plan(ids, [[(1, 1)], [(1, 1)]], cfg.tokens_per_view, "single", 7, 8, 0,
                             pad_to=16)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}


def load_both(tmp_path, monkeypatch, layout, **flags):
    path, base, sd, clip = write_layout(tmp_path, layout)
    if clip is not None:
        monkeypatch.setenv("TOKENPACKER_CLIP_PATH", clip)
    port = api.load_pretrained_model(path, base, dtype=torch.float32, device="cpu", **flags)
    want = jax_api.load_pretrained_model(path, base, dtype=jnp.float32, **flags)
    return port, want, sd


def _check_same(port, want, asked):
    tok, model, processor, context_len = port
    _, jmodel, jprocessor, jcontext_len = want
    _assert_same_tree(model.params, params_from_jax(jax.tree.map(np.asarray, jmodel.params),
                                                    model.cfg))
    assert asked["port"] == asked["jax"] and len(asked["port"]) == 1
    assert context_len == jcontext_len == 2048 and model.cfg is model.config
    assert model.cfg.dtype == torch.float32 and model.generator.params is model.params
    rng = np.random.default_rng(1)
    images = [Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8))]
    for kw in ({}, {"image_aspect_ratio": "slice", "patch_num": 9}):
        crops, blocks = processor(images, **kw)
        jcrops, jblocks = jprocessor(images, **kw)
        np.testing.assert_array_equal(crops, jcrops)
        assert blocks == jblocks


def _tokens(port, want):
    batch = _batch(port[1].cfg)
    got = port[1].generator.generate(batch, max_new_tokens=NEW_TOKENS).sequences
    return got, want[1].generator.generate(batch, max_new_tokens=NEW_TOKENS).sequences


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_pretrained_model_matches_jax(layout, tmp_path, monkeypatch, tokenizers):
    """Each layout: the same params leaf by leaf as JAX's loader gives,
    equal to the written weights where the layout holds them all (the
    LoRA merge: W + (alpha / r) B A of the base's, within fp32 rounding),
    the tokenizer read from the same path, the same image processor and
    context length, identical greedy tokens."""
    port, want, sd = load_both(tmp_path, monkeypatch, layout)
    _check_same(port, want, tokenizers)
    params, cfg = port[1].params, port[1].cfg
    if layout != "lora":
        _assert_same_tree(params, hf_import.import_vlm(sd, cfg))
    else:
        q = params["lm"]["layers"][1]["attn"]["q"]["kernel"]
        adapter = torch.load(tmp_path / "tokenpacker-tiny" / "adapter_model.bin")
        pre = "base_model.model.model.layers.1.self_attn.q_proj"
        delta = 4.0 * (adapter[f"{pre}.lora_B.weight"] @ adapter[f"{pre}.lora_A.weight"])
        want_q = sd["model.layers.1.self_attn.q_proj.weight"] + delta
        torch.testing.assert_close(q, want_q.t(), rtol=1e-6, atol=1e-6)
        assert not torch.equal(params["projector"]["mlp"]["fc1"]["kernel"],
                               sd["model.mm_projector.mlp.0.weight"].t())
    base = str(tmp_path / "base")
    assert tokenizers["port"] == [base if layout in ("stage-1 delta", "lora")
                                  else str(tmp_path / "tokenpacker-tiny")]
    got, jgot = _tokens(port, want)
    assert got == jgot and all(len(s) == NEW_TOKENS for s in got)


@pytest.mark.parametrize("flags", [{"load_8bit": True}, {"load_4bit": True},
                                   {"load_4bit": True, "quant_type": "int4"}],
                         ids=["8bit", "nf4", "int4"])
def test_load_quantized_matches_jax(flags, tmp_path, monkeypatch, tokenizers):
    """load_8bit fuses q/k/v and gate/up and makes them int8 (load_4bit:
    nf4 or int4 codes) as JAX does, leaf for leaf and bit for bit, with
    the same dense leaves left where the kernels are below min_size;
    identical greedy tokens from both Generators."""
    port, want, _ = load_both(tmp_path, monkeypatch, "full bin", **flags)
    _check_same(port, want, tokenizers)
    lm = port[1].params["lm"]
    layer = lm["layers"][0]
    key = "q" if "load_8bit" in flags else f"q4:{flags.get('quant_type', 'nf4')}:64"
    for name in (("attn", "qkv"), ("mlp", "gateup"), ("mlp", "down")):
        assert key in layer[name[0]][name[1]]["kernel"], name
    assert isinstance(layer["attn"]["o"]["kernel"], torch.Tensor)
    assert isinstance(lm["lm_head"]["kernel"], torch.Tensor)
    got, jgot = _tokens(port, want)
    assert got == jgot


def test_both_quantizations_at_once_raise(tmp_path, tokenizers):
    path, *_ = write_layout(tmp_path, "full bin")
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.load_pretrained_model(path, device="cpu", load_8bit=True, load_4bit=True)


def test_lora_needs_a_base_and_no_weights_raise(tmp_path, tokenizers):
    path, *_ = write_layout(tmp_path, "lora")
    with pytest.raises(ValueError, match="model_base"):
        api.load_pretrained_model(path, device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(_cfg().to_hf_dict()))
    with pytest.raises(FileNotFoundError):
        api.load_pretrained_model(str(empty), device="cpu")


def test_the_default_device_is_the_card(tmp_path, tokenizers):
    """With no CUDA device, the default raises instead of loading on the
    CPU; the tower falls back to random weights (logged) when neither
    TOKENPACKER_CLIP_PATH nor transformers gives it."""
    path, *_ = write_layout(tmp_path, "full bin")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_pretrained_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model-path", path, "--image-file", "unused.png"])


def test_random_tower_fallback_is_logged(tmp_path, monkeypatch, caplog):
    """No TOKENPACKER_CLIP_PATH and no `transformers` (as on the GPU
    machine; a stand-in module without CLIPVisionModel here): the port's
    seed-0 random tower, with a warning saying so."""
    import types

    monkeypatch.setitem(sys.modules, "transformers", types.ModuleType("transformers"))
    cfg = _cfg()
    with caplog.at_level("INFO", logger="tokenpacker_tpu_torch.api"):
        tower = api._load_tower_params(cfg, torch.float32, "cpu")
    assert "random weights" in caplog.text
    want = init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32)["vision"]
    _assert_same_tree(tower, want)


# -- the terminal chat ---------------------------------------------------------


def test_pick_conv_mode_matches_jax():
    for name in ("TokenPacker-7b-144token", "llava-v1.5-7b", "llava-llama-2-13b-chat",
                 "LLaVA-Lightning-MPT-7B", "llava-7b-v0", "vicuna", "checkpoint-100",
                 "tokenpacker-hd-13b"):
        assert cli.pick_conv_mode(name) == jax_cli.pick_conv_mode(name), name


def test_cli_streams_the_generators_text(tmp_path, monkeypatch, capsys, tokenizers):
    """`cli.main --load-8bit` on a tiny checkpoint, fed two turns through
    `input` at temperature 0: each answer printed is the text of
    `generate_stream` on the model it loaded, for the prompt the llava_v1
    template makes (the image in the first turn, the first answer in the
    second's history)."""
    path, *_ = write_layout(tmp_path, "full bin")
    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (60, 80, 3), np.uint8)).save(image)
    turns = iter(["describe it", "and then"])

    def fake_input(prompt):
        print(prompt, end="")
        try:
            return next(turns)
        except StopIteration:
            raise EOFError from None

    loaded = {}
    real_load = api.load_pretrained_model

    def load(*a, **k):
        loaded["out"] = real_load(*a, **k)
        return loaded["out"]

    monkeypatch.setattr(api, "load_pretrained_model", load)
    monkeypatch.setattr(builtins, "input", fake_input)
    cli.main(["--model-path", path, "--image-file", str(image), "--load-8bit", "--temperature",
              "0", "--max-new-tokens", str(NEW_TOKENS), "--device", "cpu"])
    out = capsys.readouterr().out
    tok, model, _, _ = loaded["out"]
    assert model.cfg.dtype == torch.bfloat16
    assert isinstance(model.params["lm"]["layers"][0]["attn"]["qkv"]["kernel"], dict)

    cfg = model.cfg
    crops, hb, wb = api.process_image(Image.open(image).convert("RGB"), cfg.image_aspect_ratio,
                                      cfg.patch_num, cfg.vision.image_size)
    conv = conv_templates["llava_v1"].copy()
    answers = []
    for i, text in enumerate(("<image>\ndescribe it", "and then")):
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tok), np.int64)
        args = ([ids], [[(hb, wb)]], cfg.tokens_per_view, "single",
                tok.convert_tokens_to_ids(","), tok.convert_tokens_to_ids("\n"), 0)
        plan = build_splice_plan(*args)
        plan = build_splice_plan(*args, pad_to=pick_bucket(int(plan.lengths[0])))
        batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
                 "image_slot": plan.image_slot, "lengths": plan.lengths,
                 "images": crops.transpose(0, 2, 3, 1)}
        texts = list(model.generator.generate_stream(batch, max_new_tokens=NEW_TOKENS,
                                                     stop_strings=(conv.sep2,)))
        answers.append(texts[-1])
        conv.messages[-1][-1] = texts[-1]
    assert all(a.startswith("<") for a in answers)
    lines = out.split("USER: ")
    assert len(lines) == 4 and lines[-1] == ""  # two turns, then end of input
    for line, answer in zip(lines[1:3], answers):
        assert line.startswith(f"ASSISTANT: {answer}\n[turn took "), (line, answer)


def test_new_modules_import_no_jax():
    """The checkpoint layer, the API and the CLI import neither JAX nor the
    JAX package, nor `safetensors` or `transformers` (absent on the GPU
    machine)."""
    code = ("import sys, tokenpacker_tpu_torch.api, tokenpacker_tpu_torch.io.checkpoint, "
            "tokenpacker_tpu_torch.io.hf_import, tokenpacker_tpu_torch.io.hf_export, "
            "tokenpacker_tpu_torch.io.surgery, tokenpacker_tpu_torch.serve.cli, "
            "tokenpacker_tpu_torch.config, tokenpacker_tpu_torch.data.mm_tokenize; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tokenpacker_tpu', 'safetensors', 'transformers')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
