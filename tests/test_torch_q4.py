"""The 4-bit (`load_4bit`) half of the port against the JAX package on the
CPU: `ops/quantize`'s nf4/int4 leaves, K6's plain version, `linear`'s
4-bit route, `io/weights.quantize_lm_4bit` and the tiny HD slice served
from a 4-bit LM.

The packed bytes and absmax must equal JAX's exactly (the weight bridge
carries the leaves unchanged), ties between two codes included. Every
other tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.ops import quantize as jq
from tokenpacker_tpu.ops.q4_matmul import q4_matmul as jax_q4_matmul
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.image.processing import process_images
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_from_jax,
    params_to,
    params_to_jax,
    quantize_lm_4bit,
)
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.ops import layers
from tokenpacker_tpu_torch.ops import quantize as tq
from tokenpacker_tpu_torch.ops.decode_attention import MAX_SPLITS
from tokenpacker_tpu_torch.ops.q4_matmul import BLOCK_COLS, q4_matmul, q4_matmul_plain, q4_splits

QUANT_TYPES = ("nf4", "int4")
SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary


def _weights_with_ties(seed, quant_type):
    """[256, 384] f32 weights of typical size, whose first 64-row block of
    the first 15 columns holds values exactly between two codes: nf4 the
    f32 midpoints of neighbouring codes at absmax 1, int4 +-3.5 at absmax
    7 (norm * 7 = +-3.5, a half-way round)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((256, 384)) * 0.02).astype(np.float32)
    if quant_type == "nf4":
        code = np.asarray(jq.NF4_VALUES, np.float32)
        w[0, :15] = 1.0
        w[1:16, :15] = ((code[1:] + code[:-1]) / 2)[None, :]
    else:
        w[0, :15] = 7.0
        w[1:16:2, :15] = 3.5
        w[2:16:2, :15] = -3.5
    return w


def _ties(w, quant_type):
    """How many entries of w's first block sit exactly between two codes,
    by the f32 arithmetic both packages use."""
    blk = w[:64, :15] / np.abs(w[:64, :15]).max(axis=0)
    if quant_type == "int4":
        return int((np.abs(blk * np.float32(7.0)) % 1 == 0.5).sum())
    d = np.abs(blk[..., None] - np.asarray(jq.NF4_VALUES, np.float32))
    best = d.min(-1, keepdims=True)
    return int(((d == best).sum(-1) > 1).sum())


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_quantize_4bit_bytes_equal_jax(quant_type):
    w = _weights_with_ties(0, quant_type)
    assert _ties(w, quant_type) >= 10
    want = jq.quantize_4bit(jnp.asarray(w), 64, quant_type)
    got = tq.quantize_4bit(torch.from_numpy(w), 64, quant_type)
    key = f"q4:{quant_type}:64"
    assert set(got) == set(want) == {key, "absmax"}
    assert got[key].dtype == torch.uint8 and tuple(got[key].shape) == (128, 384)
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(got["absmax"].numpy(), np.asarray(want["absmax"]))


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_quantize_4bit_nearest_code_in_column_chunks(quant_type, monkeypatch):
    """The nf4 search runs over column chunks (a bound on its memory); a
    chunk of 7 columns gives the same bytes as one pass."""
    w = torch.from_numpy(_weights_with_ties(1, quant_type))
    whole = tq.quantize_4bit(w, 64, quant_type)
    monkeypatch.setattr(tq, "_NF4_CHUNK_ELEMS", 256 * 16 * 7)
    chunked = tq.quantize_4bit(w, 64, quant_type)
    for key in whole:
        assert torch.equal(whole[key], chunked[key])


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_dequantize_4bit_matches_jax(quant_type):
    """Within 1e-6 (the same f32 code times absmax on both sides), with a
    stacked leading dim passed through."""
    w = _weights_with_ties(2, quant_type)
    leaf = jq.quantize_4bit(jnp.asarray(w), 64, quant_type)
    tleaf = {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
    want = np.asarray(jq.dequantize_4bit(leaf, jnp.float32))
    np.testing.assert_allclose(tq.dequantize_4bit(tleaf, torch.float32).numpy(), want, atol=1e-6)
    stacked = {k: torch.stack([v, v]) for k, v in tleaf.items()}
    got = tq.dequantize_4bit(stacked, torch.float32)
    assert tuple(got.shape) == (2, 256, 384)
    np.testing.assert_allclose(got[1].numpy(), want, atol=1e-6)
    assert tq.dequantize_4bit(tleaf).dtype == torch.bfloat16


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
@pytest.mark.parametrize("m", [1, 3, 32])
def test_q4_matmul_plain_matches_jax_kernel(quant_type, m):
    """K6's plain version against `q4_matmul(..., interpret=True)` and JAX's
    dequantized product, within 2e-5 (the JAX test's own tolerance,
    tests/test_quantize.py)."""
    rng = np.random.default_rng(3 + m)
    w = (rng.standard_normal((256, 384)) * 0.02).astype(np.float32)
    leaf = jq.quantize_4bit(jnp.asarray(w), 64, quant_type)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    tleaf = {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
    got = q4_matmul_plain(torch.from_numpy(x), tleaf).numpy()
    kernel = np.asarray(jax_q4_matmul(jnp.asarray(x), leaf, interpret=True))
    dense = np.asarray(jnp.asarray(x) @ jq.dequantize_4bit(leaf, jnp.float32))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
    # the wrapper on a CPU tensor is the plain version, leading dims kept
    x3 = torch.from_numpy(x).reshape(1, m, 256)
    assert torch.equal(q4_matmul(x3, tleaf), torch.from_numpy(got).reshape(1, m, 384))


def _spy(monkeypatch, name):
    """Count the calls `linear` makes to the kernel wrapper `name` (on the
    CPU a wrapper runs its plain version and its launch counter stays)."""
    real = getattr(layers, name)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(layers, name, spy)
    return calls


# Vicuna-7B's 4-bit products (E's shapes): qkv, o, gateup, down, lm_head
E_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("k,n,splits", [
    (4096, 12288, 4), (4096, 4096, 8), (4096, 22016, 2), (11008, 4096, 8), (4096, 32000, 2),
    (128, 4096, 2), (64, 640, 1), (1024, 1024, 8),
])
def test_q4_splits_at_the_4bit_shapes(k, n, splits):
    """K6's blocks a 128-column tile: E's products take 2-8 splits; a K of
    one or two quantization blocks takes no more splits than blocks."""
    assert q4_splits(k, n) == splits


@pytest.mark.parametrize("sms", [132, 114])
def test_q4_splits_take_whole_blocks_and_fill_the_card(sms):
    """A power of two up to the cluster size, never more splits than K has
    64-row quantization blocks; while K allows it, the grid holds two
    blocks an SM. E's products fill every SM."""
    for k in (64, 128, 192, 512, 1024, 4096, 11008):
        for n in (16, 640, 1024, 4096, 12288, 22016, 32000):
            splits = q4_splits(k, n, sms)
            tiles = -(-n // BLOCK_COLS)
            assert splits in (1, 2, 4, 8) and splits <= MAX_SPLITS
            assert splits <= k // 64
            if splits < MAX_SPLITS and 2 * splits <= k // 64:
                assert tiles * splits >= 2 * sms
    for k, n in E_SHAPES:
        assert -(-n // BLOCK_COLS) * q4_splits(k, n, sms) >= sms


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_linear_routes_4bit_by_rows(quant_type, monkeypatch):
    """M <= 32 rows go through K6, M = 33 through the dequantized dense
    product, as the JAX package routes on a TPU; both equal x @ dequant
    within 2e-5, and the bias is added."""
    calls = _spy(monkeypatch, "q4_matmul")
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((256, 384)) * 0.02).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(384).astype(np.float32))
    p = {"kernel": tq.quantize_4bit(w, 64, quant_type), "bias": bias}
    dense = tq.dequantize_4bit(p["kernel"], torch.float32)
    for shape, via_k6 in (((4, 8, 256), True), ((32, 256), True), ((33, 256), False),
                          ((3, 11, 256), False)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        n0 = len(calls)
        y = layers.linear(p, x)
        assert (len(calls) == n0 + 1) == via_k6, shape
        torch.testing.assert_close(y, x @ dense + bias, rtol=2e-5, atol=2e-5)


def test_linear_raises_for_lora_terms_on_quantized_bases():
    w = torch.zeros((64, 128))
    q4 = tq.quantize_4bit(w)
    # the QLoRA term (train/lora) takes lora_a [in, r] and lora_b [r, out]:
    # a pair of other shapes raises; a pair of these shapes adds its term
    with pytest.raises(RuntimeError):
        layers.linear({"kernel": {**q4, "lora_a": w, "lora_b": w}}, torch.zeros(1, 64))
    y = layers.linear({"kernel": {**q4, "lora_a": torch.ones(64, 2), "lora_b": torch.ones(2, 128)}},
                      torch.ones(1, 64))
    torch.testing.assert_close(y, torch.full((1, 128), 128.0))
    # the slot term over a 4-bit base is multi-LoRA serving's
    # (tests/test_torch_multi_lora.py); a leaf with A but no selection
    # raises, as the JAX package's linear does
    with pytest.raises(KeyError, match="slot_lora_sel"):
        layers.linear({"kernel": q4, "slot_lora_a": torch.zeros((1, 64, 2)),
                       "slot_lora_b": torch.zeros((1, 2, 128))}, torch.zeros(1, 64))


def test_quantize_tree_4bit_matches_jax():
    """The JAX test's tree: a big kernel, a stacked one (quantized slice by
    slice) and a small one that stays dense; plus an in dim that does not
    divide by 64, which stays dense too."""
    rng = np.random.default_rng(5)
    tree = {
        "a": {"kernel": rng.standard_normal((512, 512)).astype(np.float32),
              "bias": np.zeros((512,), np.float32)},
        "stacked": {"kernel": rng.standard_normal((2, 512, 512)).astype(np.float32)},
        "small": {"kernel": rng.standard_normal((8, 8)).astype(np.float32)},
        "odd": {"kernel": rng.standard_normal((520, 256)).astype(np.float32)},
    }
    want = jq.quantize_tree_4bit(jax.tree.map(jnp.asarray, tree), quant_type="nf4")
    got = tq.quantize_tree_4bit(jax.tree.map(torch.from_numpy, tree), quant_type="nf4")
    for name in ("a", "stacked"):
        for key, v in want[name]["kernel"].items():
            np.testing.assert_array_equal(got[name]["kernel"][key].numpy(), np.asarray(v))
    for name in ("small", "odd"):
        assert isinstance(got[name]["kernel"], torch.Tensor)
        assert not isinstance(want[name]["kernel"], dict)
    dq = tq.dequantize_tree_4bit(got, torch.float32)
    assert tuple(dq["stacked"]["kernel"].shape) == (2, 512, 512)
    assert dq["a"]["bias"] is got["a"]["bias"]


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_quantize_lm_4bit_equals_jax_leaf_for_leaf(quant_type):
    """`quantize_lm_4bit` on the tiny VLM (min_size lowered to 1024, as the
    JAX package's load_4bit test lowers it) against JAX's
    fuse_llama_layers + quantize_tree_4bit on the same weights: every leaf
    equal, the 4-bit ones byte for byte; `params_from_jax` carries JAX's
    tree to the same tensors, and `params_to` keeps the codes uint8 and
    absmax f32."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=3, device="cpu", dtype=torch.float32)
    jtree = jax.tree.map(jnp.asarray, params_to_jax(params))
    jlm = jq.quantize_tree_4bit(jq.fuse_llama_layers(jtree["lm"]), quant_type=quant_type,
                                min_size=1024)
    got = quantize_lm_4bit(params, quant_type, min_size=1024)
    assert got is params
    bridged = params_from_jax({"lm": jax.tree.map(np.asarray, jlm)}, cfg)["lm"]
    want_leaves = jax.tree_util.tree_leaves_with_path(params_to_jax(bridged))
    got_leaves = jax.tree_util.tree_leaves_with_path(params_to_jax(got["lm"]))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    n4 = 0
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
        n4 += jax.tree_util.keystr(path).endswith(f"['q4:{quant_type}:64']")
    assert n4 == 5  # qkv, o, gateup, down (stacked) and lm_head
    moved = params_to(got, "cpu", torch.bfloat16)["lm"]["layers"][0]["mlp"]["gateup"]["kernel"]
    assert moved[f"q4:{quant_type}:64"].dtype == torch.uint8
    assert moved["absmax"].dtype == torch.float32


# -- the tiny HD slice from a 4-bit LM -----------------------------------------


@pytest.fixture(scope="module", params=QUANT_TYPES)
def slice4(request):
    """The tiny VLM in slice (HD) mode, fp32, its LM made 4-bit by both
    packages from the same seeded weights."""
    quant_type = request.param
    cfg = tiny_vlm_config(image_aspect_ratio="slice")
    cfg_j = jax_tiny_config(image_aspect_ratio="slice")
    params = init_vlm_on_device(cfg, seed=8, device="cpu", dtype=torch.float32)
    jtree = jax.tree.map(jnp.asarray, params_to_jax(params))
    jtree["lm"] = jq.quantize_tree_4bit(jq.fuse_llama_layers(jtree["lm"]), quant_type=quant_type,
                                        min_size=1024)  # api.load_4bit
    params = quantize_lm_4bit(params, quant_type, min_size=1024)
    assert generate.fused_weights(params, cfg) is False  # per-layer decode, K6 per product
    rng = np.random.default_rng(3)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((110, 160), (60, 40))]
    crops, blocks = process_images(images, "slice", 9, cfg.vision.image_size)
    ids = [np.array([1, 21, IMAGE_TOKEN_INDEX, 50, 51, 52], np.int64),
           np.array([1, IMAGE_TOKEN_INDEX, 60, 61], np.int64)]
    plan = build_splice_plan(ids, [[b] for b in blocks], cfg.tokens_per_view, "slice", SEP,
                             NEWLINE, pad_to=64)
    batch = {"token_ids": plan.token_ids, "is_image": plan.is_image, "image_slot": plan.image_slot,
             "lengths": plan.lengths, "images": crops.transpose(0, 2, 3, 1).copy()}
    return cfg_j, jtree, cfg, params, batch


# fp32 on both sides, the same dequantized weights: the logits differ only
# in the order of the sums
LOGIT_RTOL, MARGIN_FACTOR = 1e-4, 5


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want).max()
    assert diff <= LOGIT_RTOL * np.abs(want).max(), diff
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = top2[..., 1] - top2[..., 0] > MARGIN_FACTOR * max(diff, 1e-6)
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    return decisive


def test_4bit_slice_prefill_and_steps_match_jax(slice4, monkeypatch):
    """Prefill logits, then 4 decode steps fed the same tokens; the port's
    decode products go through K6's route (2 layers x 4 + lm_head a step)."""
    cfg_j, jtree, cfg, params, batch = slice4
    calls = _spy(monkeypatch, "q4_matmul")
    l = batch["token_ids"].shape[1]
    jl, jc = jax_generate.prefill(jtree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), l + 8)
    tl, tc = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), l + 8)
    assert len(calls) == 1  # the prefill's LM head over the 2 last positions
    decisive = [_close(tl, jl)]
    lengths = torch.from_numpy(batch["lengths"])
    for step in range(4):
        tok = np.full((2,), (step * 37 + 11) % 256, np.int32)
        jl, jc = jax_generate.decode_step(jtree, cfg_j, jc, jnp.asarray(tok),
                                          jnp.asarray(batch["lengths"]),
                                          jnp.asarray(step, jnp.int32), l)
        tl, tc = generate.decode_step(params, cfg, tc, torch.from_numpy(tok).long(), lengths,
                                      step, l)
        decisive.append(_close(tl, jl))
    assert len(calls) == 1 + 4 * (4 * cfg.lm.num_hidden_layers + 1)
    assert np.stack(decisive).any()


def test_4bit_slice_greedy_tokens_match_jax(slice4):
    """The two Generators' greedy tokens agree until the first step whose
    JAX top-2 margin is not decisive."""
    cfg_j, jtree, cfg, params, batch = slice4
    want = jax_generate.Generator(jtree, cfg_j).generate(batch, max_new_tokens=8, check_every=4)
    got = generate.Generator(params, cfg).generate(batch, max_new_tokens=8, check_every=4)
    assert got.stats["decode_steps"] == 7
    checked = 0
    for g, w in zip(got.sequences, want.sequences):
        for a, b in zip(g, w):
            if a != b:
                break
            checked += 1
    assert checked >= 8, (got.sequences, want.sequences)


def test_4bit_tree_serves_through_the_paged_batcher(slice4):
    """A 4-bit tree through PagedContinuousBatcher (K6's route for its
    decode products, K5's plain version) gives the Generator's greedy
    tokens for two text requests served together."""
    from tokenpacker_tpu_torch.serve.scheduler import PagedContinuousBatcher

    cfg, params = slice4[2], slice4[3]
    prompts = ([1, 5, 9, 12, 40], [1, 7, 30, 31, 32, 33, 34])
    reqs = [{"token_ids": np.array([p]), "is_image": np.zeros((1, len(p)), bool),
             "image_slot": np.zeros((1, len(p)), np.int32), "lengths": np.array([len(p)]),
             "images": None} for p in prompts]
    gen = generate.Generator(params, cfg)
    want = [gen.generate(r, max_new_tokens=4, check_every=2).sequences[0] for r in reqs]
    batcher = PagedContinuousBatcher(params, cfg, device="cpu", num_slots=2, num_pages=64,
                                     page_size=8, max_pages_per_seq=16)
    batcher.start()
    try:
        got = [f.result(timeout=300) for f in [batcher.submit(r, 4) for r in reqs]]
    finally:
        batcher.stop()
    assert got == want
