"""The port's checkpoint layer against the JAX package, on the CPU at the
tiny geometry: the HF `config.json` round trip, `get_model_name_from_path`,
the HF-layout import (`io/hf_import`) and export (`io/hf_export`), the
state-dict reader with its own safetensors parser (`io/checkpoint`), the
surgery tools (`io/surgery`) and MPT's int8 and 4-bit forms
(`io/weights.quantize_lm_int8` / `quantize_lm_4bit`).

Tolerances: imports, exports, quantized trees and surgery outputs are
exact (the same values moved, cast or rounded by the same rule); MPT's
quantized logits are fp32 sums in another order, held within 1e-4 as in
`test_torch_mpt.py` and `test_torch_q4.py`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu import api as jax_api
from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.config import TokenPackerVLMConfig as JaxVLMConfig
from tokenpacker_tpu.config import preset_config as jax_preset_config
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.data.mm_tokenize import get_model_name_from_path as jax_model_name
from tokenpacker_tpu.io import hf_export as jax_export
from tokenpacker_tpu.io import hf_import as jax_import
from tokenpacker_tpu.io import surgery as jax_surgery
from tokenpacker_tpu.models.vlm import init_vlm as jax_init_vlm
from tokenpacker_tpu.ops import quantize as jq
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import MODEL_PRESETS, LMConfig, TokenPackerVLMConfig
from tokenpacker_tpu_torch.config import preset_config, tiny_vlm_config
from tokenpacker_tpu_torch.data.mm_tokenize import get_model_name_from_path
from tokenpacker_tpu_torch.io import checkpoint, hf_export, hf_import, surgery
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_from_jax,
    params_to_jax,
    quantize_lm_4bit,
    quantize_lm_int8,
)
from test_torch_mpt import LOGIT_TOL, MPT_LM, _batch

CONFIGS = sorted(MODEL_PRESETS) + ["tiny", "tiny, llama-2 vision"]


def _configs(name):
    if name == "tiny":
        return tiny_vlm_config(), jax_tiny_config()
    if name == "tiny, llama-2 vision":  # a tower with other select keys
        over = dict(select_layer=-1, select_feature="cls_patch")
        port, jax_cfg = tiny_vlm_config(), jax_tiny_config()
        return (dataclasses.replace(port, vision=dataclasses.replace(port.vision, **over)),
                dataclasses.replace(jax_cfg, vision=dataclasses.replace(jax_cfg.vision, **over)))
    return preset_config(name), jax_preset_config(name)


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("name", CONFIGS)
def test_config_hf_dict_round_trip_matches_jax(name, tmp_path):
    """`to_hf_dict` equals JAX's (the `mm_vision_cfg` block for a tower that
    is not ViT-L included); `from_hf_dict` and `from_json` of it give
    field-equal configs in both packages."""
    port, jax_cfg = _configs(name)
    d = port.to_hf_dict()
    assert d == jax_cfg.to_hf_dict()
    assert ("mm_vision_cfg" in d) == name.startswith("tiny")
    back, back_j = TokenPackerVLMConfig.from_hf_dict(d), JaxVLMConfig.from_hf_dict(d)
    assert _fields(back) == _fields(back_j)
    assert back.vision == port.vision and back.to_hf_dict() == d  # None kv heads come back as H
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    assert _fields(TokenPackerVLMConfig.from_json(str(path))) == _fields(back)


def test_from_hf_dict_drops_the_mpt_keys_as_jax_does():
    """ROADMAP R13: `from_hf_dict` never reads `model_family`, `alibi` or
    `no_bias`, so an MPT `config.json` loads as llama in both packages."""
    d = {"model_type": "llava_mpt", "model_family": "mpt", "alibi": True, "no_bias": True,
         "hidden_size": 4096, "num_hidden_layers": 32, "vocab_size": 50432}
    port, jax_cfg = TokenPackerVLMConfig.from_hf_dict(d), JaxVLMConfig.from_hf_dict(d)
    assert (port.lm.model_family, port.lm.alibi) == ("llama", False)
    assert _fields(port) == _fields(jax_cfg)


def test_get_model_name_from_path_matches_jax():
    """The same names, and the same IndexError for a bare `checkpoint-N`."""

    def outcome(fn, path):
        try:
            return fn(path)
        except Exception as e:  # noqa: BLE001 - the error is what is compared
            return type(e)

    for path in ("sunshine-lwt/TokenPacker-7b-144token", "/ckpt/run1/checkpoint-300/",
                 "checkpoint-5", "a/b/llava-v1.5-mpt", "/x/y/", "TokenPacker-HD-13b"):
        assert outcome(get_model_name_from_path, path) == outcome(jax_model_name, path), path
    assert outcome(get_model_name_from_path, "checkpoint-5") is IndexError


# -- import and export ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sd():
    cfg_j = jax_tiny_config()
    tree = jax_init_vlm(jax.random.PRNGKey(3), cfg_j)
    return cfg_j, tree, jax_export.export_vlm_state_dict(tree, cfg_j)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(params_to_jax(tree))


def _assert_same_tree(got, want):
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def _assert_dtypes(tree, dtype):
    for path, leaf in _walk(tree):
        assert leaf.dtype == dtype, path


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("form", ["fp32 numpy", "bf16 tensors"])
def test_import_vlm_equals_params_from_jax(jax_sd, form):
    """JAX's export of a JAX `init_vlm` tree, imported by the port, equals
    `params_from_jax` of JAX's import of the same state dict, leaf by
    leaf: exactly in fp32 from numpy values, bit for bit in bf16 from bf16
    torch tensors."""
    cfg_j, _, sd = jax_sd
    cfg = tiny_vlm_config()
    if form == "fp32 numpy":
        values, dtype, jdtype = sd, torch.float32, jnp.float32
    else:
        values = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in sd.items()}
        dtype, jdtype = torch.bfloat16, jnp.bfloat16
    got = hf_import.import_vlm(values, cfg, dtype)
    want = params_from_jax(jax.tree.map(np.asarray, jax_import.import_vlm(values, cfg_j, jdtype)),
                           cfg)
    _assert_same_tree(got, want)
    _assert_dtypes(got, dtype)
    kernel = got["lm"]["layers"][0]["attn"]["q"]["kernel"]
    assert kernel.is_contiguous() and kernel.shape == (64, 64)


def test_import_copies_its_values(jax_sd):
    """The imported tensors own their memory: a later write to the state
    dict's tensors does not reach them."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jax_sd[2].items()}
    got = hf_import.import_vlm(sd, tiny_vlm_config(), torch.float32)
    before = got["lm"]["embed"].clone()
    sd["model.embed_tokens.weight"].add_(1.0)
    assert torch.equal(got["lm"]["embed"], before)


def test_export_vlm_state_dict_equals_jax(jax_sd):
    """The port's export of the port's params equals JAX's export of the
    same JAX tree, key for key and byte for byte (fp32 numpy)."""
    cfg_j, tree, want = jax_sd
    params = params_from_jax(jax.tree.map(np.asarray, tree), tiny_vlm_config())
    got = hf_export.export_vlm_state_dict(params, tiny_vlm_config())
    assert list(got) == list(want)
    for k in want:
        w = np.ascontiguousarray(np.asarray(want[k]))
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert np.ascontiguousarray(got[k]).tobytes() == w.tobytes(), k


def test_export_then_import_is_the_identity():
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=5, device="cpu", dtype=torch.float32)
    back = hf_import.import_vlm(hf_export.export_vlm_state_dict(params, cfg), cfg)
    params["projector"]["q_proj"]["bias"] = None  # the reference's q_proj_1 has no bias
    _assert_same_tree(back, params)


# -- the reader ----------------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(6, 10, generator=g)
    return {"f32": x, "f16": (x * 3).half(), "bf16": (x * 5).bfloat16(),
            "i8": torch.randint(-128, 128, (3, 7), generator=g, dtype=torch.int8),
            "u8": torch.randint(0, 256, (5,), generator=g, dtype=torch.uint8),
            "odd": torch.randn(3, generator=g).half(), "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4)}


def test_read_safetensors_matches_the_safetensors_package(tmp_path):
    """F32, F16, BF16, I8, U8, a 0-d and an empty tensor: dtype, shape and
    bytes as `safetensors.torch.load_file` reads them, metadata ignored."""
    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "model.safetensors")
    save_file(_tensors(), path, metadata={"format": "pt"})
    got, want = checkpoint.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k].view(-1).view(torch.uint8) if got[k].numel() else got[k],
                           want[k].view(-1).view(torch.uint8) if want[k].numel() else want[k]), k


def test_read_safetensors_copies_a_misaligned_tensor(tmp_path):
    """A writer that does not align: an f32 tensor at an odd offset is read
    right (copied out of the map)."""
    import struct

    a, b = torch.arange(3, dtype=torch.uint8), torch.randn(4)
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": [3, 19]}}
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(text)) + text + a.numpy().tobytes()
                     + b.numpy().tobytes())
    got = checkpoint.read_safetensors(str(path))
    assert torch.equal(got["a"], a) and torch.equal(got["b"], b)


def test_bf16_safetensors_r12_side_by_side(tmp_path):
    """ROADMAP R12. The JAX package reads safetensors through
    `safe_open(framework="np")`, which knows bf16 only once JAX has
    registered ml_dtypes' bfloat16 with numpy: its surgery tools, which
    import no JAX, raise on a bf16 file, and `extract_mm_projector` raises
    even with JAX loaded (`torch.as_tensor` of an ml_dtypes array). Its
    `api._load_state_dict` reads the values (as ml_dtypes bf16). The port
    reads bf16 itself, and extracts it."""
    import subprocess
    import sys

    from safetensors.torch import save_file

    x = torch.randn(4, 8).bfloat16()
    save_file({"model.mm_projector.w": x}, str(tmp_path / "model.safetensors"))
    code = ("import sys; from tokenpacker_tpu.io import surgery; "
            f"surgery._load_any_state_dict({str(tmp_path)!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and "data type 'bfloat16' not understood" in run.stderr
    with pytest.raises(TypeError, match="bfloat16"):
        jax_surgery.extract_mm_projector(str(tmp_path), str(tmp_path / "jax.bin"))
    jax_values = jax_api._load_state_dict(str(tmp_path))["model.mm_projector.w"]
    got = checkpoint.load_state_dict(str(tmp_path))["model.mm_projector.w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jax_values, np.float32))
    surgery.extract_mm_projector(str(tmp_path), str(tmp_path / "port.bin"))
    assert torch.equal(torch.load(tmp_path / "port.bin")["model.mm_projector.w"], x)


def test_load_state_dict_reads_sharded_bins_in_order(tmp_path):
    """`pytorch_model*.bin` shards in sorted order (a later shard's key
    wins, as in the JAX loader); safetensors files take precedence."""
    t = _tensors()
    torch.save({"a": t["f32"], "b": t["i8"]}, tmp_path / "pytorch_model-00001-of-00002.bin")
    torch.save({"b": t["u8"], "c": t["bf16"]}, tmp_path / "pytorch_model-00002-of-00002.bin")
    got, want = checkpoint.load_state_dict(str(tmp_path)), jax_api._load_state_dict(str(tmp_path))
    assert list(got) == list(want) == ["a", "b", "c"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(FileNotFoundError):
        checkpoint.load_state_dict(str(tmp_path / "nothing"))


# -- surgery -------------------------------------------------------------------


def _write_full(path, cfg, seed, dtype=torch.float32):
    path.mkdir(parents=True, exist_ok=True)
    params = init_vlm_on_device(cfg, seed=seed, device="cpu", dtype=torch.float32)
    sd = hf_export.to_torch_state_dict(hf_export.export_vlm_state_dict(params, cfg), dtype)
    torch.save(sd, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    return sd


def test_extract_mm_projector_matches_jax(tmp_path):
    """From the last `checkpoint-*` of a trainer's directory: the same keys
    and values as JAX's tool writes."""
    cfg = tiny_vlm_config()
    _write_full(tmp_path / "run" / "checkpoint-2", cfg, 0)
    sd = _write_full(tmp_path / "run" / "checkpoint-9", cfg, 1)
    surgery.extract_mm_projector(str(tmp_path / "run"), str(tmp_path / "port.bin"))
    jax_surgery.extract_mm_projector(str(tmp_path / "run"), str(tmp_path / "jax.bin"))
    got, want = torch.load(tmp_path / "port.bin"), torch.load(tmp_path / "jax.bin")
    assert list(got) == list(want) and all(k.startswith("model.mm_projector.") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k]), k
    with pytest.raises(ValueError, match="no mm_projector"):
        torch.save({"x": torch.ones(1)}, tmp_path / "pytorch_model.bin")
        surgery.extract_mm_projector(str(tmp_path), str(tmp_path / "none.bin"))


def _write_lora(path, cfg, seed, r=2, alpha=8):
    """A PEFT adapter over q_proj and down_proj of both layers (and a tower
    key, which the merge applies only if the base has it), plus a projector
    in non_lora_trainables.bin."""
    path.mkdir(parents=True, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.lm.hidden_size, cfg.lm.intermediate_size
    sd = {}
    for i in range(cfg.lm.num_hidden_layers):
        for name, din, dout in ((f"layers.{i}.self_attn.q_proj", d, d),
                                (f"layers.{i}.mlp.down_proj", f, d)):
            sd[f"base_model.model.model.{name}.lora_A.weight"] = torch.randn(r, din, generator=g)
            sd[f"base_model.model.model.{name}.lora_B.weight"] = torch.randn(dout, r, generator=g)
    sd["base_model.model.model.missing.lora_A.weight"] = torch.randn(r, d, generator=g)
    sd["base_model.model.model.missing.lora_B.weight"] = torch.randn(d, r, generator=g)
    torch.save(sd, path / "adapter_model.bin")
    (path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))
    proj = init_vlm_on_device(cfg, seed=seed + 1, device="cpu", dtype=torch.float32)["projector"]
    nlt = {f"base_model.model.model.mm_projector.{k}": torch.from_numpy(np.ascontiguousarray(v))
           for k, v in hf_import.export_tokenpacker(proj).items()}
    torch.save(nlt, path / "non_lora_trainables.bin")
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict()))


def test_merge_lora_and_consolidate_match_jax(tmp_path):
    """`merge-lora` and `consolidate` through each package's `main`: the
    same files, the merged weights and config.json equal to JAX's (the
    merge is W + (alpha / r) B A in fp32 on the host in both)."""
    cfg = tiny_vlm_config()
    _write_full(tmp_path / "base", cfg, 2)
    _write_lora(tmp_path / "lora", cfg, 4)
    for tool, side in ((surgery, "port"), (jax_surgery, "jax")):
        tool.main(["merge-lora", "--model-path", str(tmp_path / "lora"), "--model-base",
                   str(tmp_path / "base"), "--save-model-path", str(tmp_path / f"merged_{side}")])
        tool.main(["consolidate", "--src", str(tmp_path / "lora"), "--dst",
                   str(tmp_path / f"cons_{side}")])
    for kind in ("merged", "cons"):
        port, jax_dir = tmp_path / f"{kind}_port", tmp_path / f"{kind}_jax"
        assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
        assert json.loads((port / "config.json").read_text()) == json.loads(
            (jax_dir / "config.json").read_text())
    got = torch.load(tmp_path / "merged_port" / "pytorch_model.bin")
    want = torch.load(tmp_path / "merged_jax" / "pytorch_model.bin")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    base = torch.load(tmp_path / "base" / "pytorch_model.bin")
    q = "model.layers.1.self_attn.q_proj.weight"
    assert not torch.equal(got[q], base[q])
    assert torch.equal(got["model.layers.1.self_attn.k_proj.weight"],
                       base["model.layers.1.self_attn.k_proj.weight"])
    for name in ("adapter_model.bin", "non_lora_trainables.bin"):
        a = torch.load(tmp_path / "cons_port" / name)
        b = torch.load(tmp_path / "cons_jax" / name)
        assert all(torch.equal(a[k], b[k]) for k in b)


# -- MPT's int8 and 4-bit forms ------------------------------------------------

MPT_QUANT = [("int8", None), ("4bit", "nf4"), ("4bit", "int4")]
# d 128 so that the default min_size (2^16 over both layers) quantizes
# wqkv, up and down and leaves out [128, 128] (32,768 elements)
MPT_WIDE = dict(MPT_LM, hidden_size=128, intermediate_size=512)


@pytest.fixture(scope="module")
def mpt_model():
    cfg = tiny_vlm_config(lm=LMConfig(**MPT_WIDE))
    params = init_vlm_on_device(cfg, seed=13, device="cpu", dtype=torch.float32)
    return {"cfg": cfg, "cfg_j": jax_tiny_config(lm=JaxLMConfig(**MPT_WIDE)), "params": params,
            "tree": params_to_jax(params)}


def _quantize_both(mpt_model, kind, quant_type):
    tree = jax.tree.map(jnp.asarray, mpt_model["tree"])
    if kind == "int8":
        tree["lm"] = jq.quantize_tree(tree["lm"])  # api.py:145, no fusing for MPT
        port = quantize_lm_int8(params_from_jax(mpt_model["tree"], mpt_model["cfg"]))
    else:
        tree["lm"] = jq.quantize_tree_4bit(tree["lm"], quant_type=quant_type)  # api.py:166
        port = quantize_lm_4bit(params_from_jax(mpt_model["tree"], mpt_model["cfg"]), quant_type)
    return tree, port


@pytest.mark.parametrize("kind,quant_type", MPT_QUANT)
def test_mpt_quantized_tree_equals_jax(mpt_model, kind, quant_type):
    """`quantize_lm_int8` / `quantize_lm_4bit` of the port's MPT tree equal
    JAX's `quantize_tree` / `quantize_tree_4bit` of the same unfused tree,
    leaf by leaf (codes bit-equal, scales equal); `wte` and `out` (below
    min_size) stay dense in both."""
    tree, port = _quantize_both(mpt_model, kind, quant_type)
    want = params_from_jax(jax.tree.map(np.asarray, tree), mpt_model["cfg"])
    _assert_same_tree(port["lm"], want["lm"])
    layer = port["lm"]["layers"][0]
    for name, quantized in ((("attn", "wqkv"), True), (("attn", "out"), False),
                            (("ffn", "up"), True), (("ffn", "down"), True)):
        assert isinstance(layer[name[0]][name[1]]["kernel"], dict) == quantized, name
    assert isinstance(port["lm"]["wte"], torch.Tensor)


@pytest.mark.parametrize("kind,quant_type", MPT_QUANT + [("w8a8", None)])
def test_mpt_quantized_prefill_and_decode_match_jax(mpt_model, kind, quant_type, monkeypatch):
    """The quantized MPT VLM's prefill logits and one decode step (K3's
    slopes form; K6's plain version for the 4-bit products of a step; in
    the w8a8 mode K7's for every int8 product, prefill and step having at
    most 64 rows) against the JAX engine's on the same quantized tree (for
    w8a8 with its `linear` routed as on a TPU, the kernels in interpret
    mode, JAX's compiled programs cleared around it)."""
    from test_torch_w8a8 import _jax_w8a8_linear, _spies

    from tokenpacker_tpu.models import mpt as jax_mpt

    cfg, cfg_j = mpt_model["cfg"], mpt_model["cfg_j"]
    w8a8 = kind == "w8a8"
    tree, params = _quantize_both(mpt_model, "int8" if w8a8 else kind, quant_type)
    if w8a8:
        monkeypatch.setattr(jax_mpt, "linear", _jax_w8a8_linear)
        jax.clear_caches()
    calls = _spies(monkeypatch)
    batch = _batch(cfg)
    l, s_max = 24, 28
    try:
        jl, jc = jax_generate.prefill(tree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype),
                                      s_max)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl1, _ = jax_generate.decode_step(tree, cfg_j, jc, jnp.asarray(tok),
                                          jnp.asarray(batch["lengths"]),
                                          jnp.asarray(0, jnp.int32), l)
    finally:
        if w8a8:
            jax.clear_caches()
    tl, tc = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), s_max,
                              w8a8=w8a8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tl, _ = generate.decode_step(params, cfg, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(batch["lengths"]), 0, l, w8a8=w8a8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl1), **LOGIT_TOL)
    # wqkv, up and down of 2 layers, in the prefill and in the step
    want = {"w8a8": {"w8a8_matmul": 12}, "4bit": {"q4_matmul": 6}, "int8": {}}[kind]
    assert calls == want
