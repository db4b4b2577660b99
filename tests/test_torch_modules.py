"""Modules of the PyTorch port against their JAX originals, at the tiny
geometry, fp32 on the CPU: layers, the CLIP tower, the TokenPacker
projector, the splice, the image pipeline and the weight bridge.

Inputs and weights are made once from a seed and handed to both sides as
numpy arrays.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import ProjectorConfig as JaxProjectorConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tokenpacker_tpu.image import processing as jax_processing
from tokenpacker_tpu.models import clip_vit as jax_clip
from tokenpacker_tpu.models import llama as jax_llama
from tokenpacker_tpu.models import splice as jax_splice
from tokenpacker_tpu.models import tokenpacker as jax_tp
from tokenpacker_tpu.models.vlm import init_vlm
from tokenpacker_tpu.ops import layers as jax_layers
from tokenpacker_tpu_torch.config import ProjectorConfig, tiny_vlm_config
from tokenpacker_tpu_torch.image import processing
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_from_jax,
    params_to,
    params_to_jax,
    to_tensors,
)
from tokenpacker_tpu_torch.models import clip_vit, llama, splice, tokenpacker
from tokenpacker_tpu_torch.models.lm_api import lm_apply
from tokenpacker_tpu_torch.ops import layers
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

# fp32 on both sides; only the order of the sums differs. Single ops hold
# 1e-5; the tower (4 blocks) and the projector chain 2e-5, as the JAX
# package's own tower parity tests use.
OP_TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def vlm():
    """Tiny weights made by the port (fast) and handed to JAX as numpy; the
    bridge's key and shape layout is checked against JAX's own `init_vlm`
    in test_weight_bridge_round_trip. Biases and norm scales are random,
    so a norm or bias that is dropped or swapped shows."""
    cfg = tiny_vlm_config()
    tree = params_to_jax(init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32))
    return jax_tiny_config(), cfg, tree, params_from_jax(tree, cfg)


# ---- ops/layers --------------------------------------------------------------


def test_layers_match_jax():
    x = _randn((3, 5, 16), 0)
    lin = {"kernel": _randn((16, 8), 1), "bias": _randn((8,), 2)}
    ln = {"scale": _randn((16,), 3), "bias": _randn((16,), 4)}
    rms = {"scale": _randn((16,), 5)}
    xt = torch.from_numpy(x)
    pairs = [
        (layers.linear(to_tensors(lin), xt), jax_layers.linear(lin, x)),
        (layers.layer_norm(to_tensors(ln), xt, 1e-5), jax_layers.layer_norm(ln, x, 1e-5)),
        (layers.rms_norm(to_tensors(rms), xt, 1e-5), jax_layers.rms_norm(rms, x, 1e-5)),
        (layers.gelu(xt), jax_layers.gelu(x)),
        (layers.quick_gelu(xt), jax_layers.quick_gelu(x)),
        (layers.silu(xt), jax_layers.silu(x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("src,dst", [(24, 12), (24, 8), (24, 6), (7, 3), (4, 4)])
def test_bilinear_matches_jax(src, dst):
    np.testing.assert_array_equal(
        layers.bilinear_resize_matrix(src, dst), jax_layers.bilinear_resize_matrix(src, dst)
    )
    x = _randn((2, src, src, 5), 0)
    got = layers.bilinear_downsample_2d(torch.from_numpy(x), dst, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_layers.bilinear_downsample_2d(x, dst, dst)),
                               **OP_TOL)


def test_bilinear_matches_torch_interpolate():
    x = torch.from_numpy(_randn((1, 24, 24, 3), 1))
    want = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(12, 12), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    torch.testing.assert_close(layers.bilinear_downsample_2d(x, 12, 12), want, **OP_TOL)


# ---- models/clip_vit ---------------------------------------------------------


def test_patchify_matches_jax():
    imgs = _randn((2, 28, 42, 3), 0)
    np.testing.assert_array_equal(
        clip_vit.patchify(torch.from_numpy(imgs), 14).numpy(),
        np.asarray(jax_clip.patchify(jnp.asarray(imgs), 14)),
    )


def test_clip_tower_features_match_jax(vlm):
    cfg_j, cfg, tree, params = vlm
    imgs = _randn((2, 56, 56, 3), 1)
    before = vit_attention.launches
    feats, multi = clip_vit.clip_tower_features(params["vision"], cfg.vision, torch.from_numpy(imgs))
    want_f, want_m = jax_clip.clip_tower_features(tree["vision"], cfg_j.vision, jnp.asarray(imgs))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f), **CHAIN_TOL)
    np.testing.assert_allclose(multi.numpy(), np.asarray(want_m), **CHAIN_TOL)
    assert feats.shape == (2, 16, 32) and multi.shape == (2, 16, 128)
    assert vit_attention.launches == before  # CPU tensors run the plain version


def test_clip_tower_skips_unused_blocks():
    """select_layer=-2 with multi_layers <= 23 of 24: block 24 never runs."""
    cfg = tiny_vlm_config().vision
    import dataclasses

    cfg = dataclasses.replace(cfg, multi_layers=(1, 2, 3, 3))
    params = init_vlm_on_device(tiny_vlm_config(vision=cfg), 0, "cpu", torch.float32)["vision"]
    params["layers"][3] = None  # the 4th block must not be touched
    feats, multi = clip_vit.clip_tower_features(params, cfg, torch.zeros(1, 56, 56, 3))
    assert feats.shape == (1, 16, 32) and multi.shape == (1, 16, 128)


# ---- models/tokenpacker ------------------------------------------------------


@pytest.mark.parametrize("s", [2, 3, 4])
def test_tokenpacker_forward_matches_jax(s):
    geo = dict(raw_grid=12, embed_dim=32, num_heads=4, kv_dim=32, kv_input_dim=128,
               hidden_size=64, scale_factor=s)
    cfg_j, cfg = JaxProjectorConfig(**geo), ProjectorConfig(**geo)
    tree = _np(jax_tp.init_tokenpacker(jax.random.PRNGKey(s), cfg_j))
    x, xm = _randn((2, 144, 32), 0), _randn((2, 144, 128), 1)
    got = tokenpacker.tokenpacker_forward(to_tensors(tree), cfg, torch.from_numpy(x), torch.from_numpy(xm))
    want = jax_tp.tokenpacker_forward(tree, cfg_j, jnp.asarray(x), jnp.asarray(xm))
    assert got.shape == (2, (12 // s) ** 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


def test_regionize_matches_jax():
    x = _randn((2, 36, 5), 0)
    np.testing.assert_array_equal(
        tokenpacker._regionize(torch.from_numpy(x), 6, 3).numpy(),
        np.asarray(jax_tp._regionize(jnp.asarray(x), 6, 3)),
    )


# ---- models/llama pieces -----------------------------------------------------


def test_rope_matches_jax():
    pos = np.array([[0, 1, 5, 9], [3, 4, 100, 511]], np.int32)
    cos, sin = llama.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = jax_llama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **OP_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **OP_TOL)
    x = _randn((2, 4, 3, 16), 1)
    np.testing.assert_allclose(
        llama.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jax_llama.apply_rope(jnp.asarray(x), jcos, jsin)), **OP_TOL,
    )


def test_llama_apply_without_cache_matches_jax(vlm):
    """Causal prefill over right-padded rows equals the JAX bias path on
    every valid position."""
    cfg_j, cfg, tree, params = vlm
    x = _randn((2, 12, 64), 0)
    lengths = np.array([12, 7])
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    bias = jax_llama.make_attention_bias(
        jnp.asarray(pos), jnp.asarray(np.arange(12)[None] < lengths[:, None]), 0, 12
    )
    want, _ = jax_llama.llama_apply(tree["lm"], cfg_j.lm, jnp.asarray(x), jnp.asarray(pos), bias,
                                    use_flash=False)
    got = lm_apply(params["lm"], cfg.lm, torch.from_numpy(x), torch.from_numpy(pos))
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :ln].numpy(), np.asarray(want)[i, :ln], **CHAIN_TOL)


def test_unported_lm_options_raise():
    from tokenpacker_tpu_torch.io.weights import quantize_lm_int8

    # MPT runs (tests/test_torch_mpt.py) and so do its int8 and 4-bit forms
    # (tests/test_torch_checkpoint.py): the unfused tree, `wte` left dense
    wte, wqkv = torch.randn(8, 64), torch.randn(64, 192)
    mpt_lm = quantize_lm_int8({"lm": {"wte": wte, "layers": [{"attn": {"wqkv": {"kernel": wqkv}}}]}},
                              min_size=1)["lm"]
    assert mpt_lm["wte"] is wte and set(mpt_lm["layers"][0]["attn"]["wqkv"]["kernel"]) == {
        "q", "scale"}
    # a quantized kernel in a form the port has not ported (the JAX
    # package's u16-row-packed "qp" of its fused decode) raises; LoRA over
    # an int8 head (train/lora) runs: zero adapters add an exact zero
    head = {"q": torch.ones((64, 8), dtype=torch.int8), "scale": torch.ones((1, 8))}
    packed = {"layers": [], "lm_head": {"kernel": {"qp": torch.zeros((32, 8), dtype=torch.int16),
                                                   "scale": torch.ones((1, 8))}}}
    with pytest.raises(NotImplementedError, match="not a ported leaf"):
        llama.llama_logits(packed, torch.zeros(1, 64))
    lora = {"layers": [], "lm_head": {"kernel": {**head, "lora_a": torch.zeros((64, 2)),
                                                 "lora_b": torch.zeros((2, 8))}}}
    x = torch.randn(1, 64)
    assert torch.equal(llama.llama_logits(lora, x),
                       llama.llama_logits({"layers": [], "lm_head": {"kernel": head}}, x))


# ---- models/splice -----------------------------------------------------------

SPLICE_CASES = [
    # (per-sample ids, labels?, pad_to)
    ([[1, 5, IMAGE_TOKEN_INDEX, 9, 10]], False, None),
    ([[1, IMAGE_TOKEN_INDEX, 4], [1, 2, 3, IMAGE_TOKEN_INDEX, 7, 8, 9]], True, 40),
    ([[IMAGE_TOKEN_INDEX, 3, IMAGE_TOKEN_INDEX, 6], [1, 2, 3]], True, None),
]


@pytest.mark.parametrize("ids,with_labels,pad_to", SPLICE_CASES)
def test_build_splice_plan_fields_equal_jax(ids, with_labels, pad_to):
    ids = [np.asarray(x, np.int64) for x in ids]
    blocks = [[(1, 1)] * int((x == IMAGE_TOKEN_INDEX).sum()) for x in ids]
    labels = [np.where(x < 0, IGNORE_INDEX, x) for x in ids] if with_labels else None
    args = (ids, blocks, 4, "single", 3, 4, 0)
    got = splice.build_splice_plan(*args, labels=labels, pad_to=pad_to)
    want = jax_splice.build_splice_plan(*args, labels=labels, pad_to=pad_to)
    for name in ("token_ids", "is_image", "image_slot", "attn_mask", "labels", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_splice_slice_mode_not_ported():
    """Slice mode is ported now (tests/test_torch_hd.py covers it): the plan
    this call once refused equals JAX's."""
    args = ([np.array([1, IMAGE_TOKEN_INDEX])], [[(2, 2)]], 4, "slice", 3, 4, 0)
    got, want = splice.build_splice_plan(*args), jax_splice.build_splice_plan(*args)
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    np.testing.assert_array_equal(got.image_slot, want.image_slot)


def test_assemble_embeds_matches_jax(vlm):
    cfg_j, cfg, tree, params = vlm
    ids = [np.array([1, 5, IMAGE_TOKEN_INDEX, 9], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)]
    plan = jax_splice.build_splice_plan(ids, [[(1, 1)], [(1, 1)]], cfg.tokens_per_view, pad_to=12)
    visual = _randn((2, cfg.tokens_per_view, 64), 0)
    want = jax_splice.assemble_embeds(tree["lm"], jnp.asarray(visual), plan.token_ids, plan.is_image,
                                      plan.image_slot)
    got = splice.assemble_embeds(
        params["lm"], torch.from_numpy(visual), torch.from_numpy(plan.token_ids).long(),
        torch.from_numpy(plan.is_image), torch.from_numpy(plan.image_slot).long(),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- image/processing --------------------------------------------------------


@pytest.mark.parametrize("size", [(300, 200), (200, 300), (336, 336)])
@pytest.mark.parametrize("mode", ["pad", None])
def test_process_image_matches_jax(size, mode):
    arr = np.random.default_rng(0).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    got, hb, wb = processing.process_image(img, mode)
    want, jhb, jwb = jax_processing.process_image(img, mode)
    assert (hb, wb) == (jhb, jwb) == (1, 1)
    np.testing.assert_array_equal(got, want)
    x = processing.to_model_input(got)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jax_processing.to_model_input(want)))


def test_process_image_slice_not_ported():
    """Slice mode is ported now (tests/test_torch_hd.py covers it): the crops
    this call once refused equal JAX's."""
    img = Image.new("RGB", (40, 30))
    got, hb, wb = processing.process_image(img, "slice")
    want, jhb, jwb = jax_processing.process_image(img, "slice")
    assert (hb, wb) == (jhb, jwb)
    np.testing.assert_array_equal(got, want)


# ---- io/weights --------------------------------------------------------------


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_weight_bridge_round_trip(vlm):
    cfg_j, cfg, tree, params = vlm
    jax_shapes = jax.eval_shape(lambda: init_vlm(jax.random.PRNGKey(0), cfg_j))
    assert _shapes(tree) == _shapes(jax_shapes)
    assert len(params["vision"]["layers"]) == cfg.vision.num_hidden_layers
    assert len(params["lm"]["layers"]) == cfg.lm.num_hidden_layers
    assert params["vision"]["patch_embed"]["kernel"].shape == (3 * 14 * 14, 32)
    back = params_to_jax(params)
    assert _shapes(back) == _shapes(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_on_device_is_seeded(vlm):
    cfg_j, cfg, tree, params = vlm
    made = init_vlm_on_device(cfg, seed=3, device="cpu", dtype=torch.float32)
    again = init_vlm_on_device(cfg, seed=3, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(made["lm"]["embed"], again["lm"]["embed"], rtol=0, atol=0)
    half = params_to(made, "cpu", torch.bfloat16)
    assert half["lm"]["layers"][0]["mlp"]["up"]["kernel"].dtype == torch.bfloat16


def test_params_from_jax_checks_depth(vlm):
    cfg_j, cfg, tree, params = vlm
    import dataclasses

    deeper = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_hidden_layers=3))
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(tree, deeper)


# ---- the package itself ------------------------------------------------------


def test_port_imports_no_jax():
    """Neither JAX nor any module of the JAX package (nor its probe
    scripts) is imported."""
    code = (
        "import sys, tokenpacker_tpu_torch.generate, tokenpacker_tpu_torch.io.weights, "
        "tokenpacker_tpu_torch.image.processing, tokenpacker_tpu_torch.image.hd_tiler, "
        "tokenpacker_tpu_torch.ops.fused_decode, tokenpacker_tpu_torch.ops._build, "
        "tokenpacker_tpu_torch.ops.flash_attention, tokenpacker_tpu_torch.models.vlm, "
        "tokenpacker_tpu_torch.data.conversation, tokenpacker_tpu_torch.data.mm_tokenize, "
        "tokenpacker_tpu_torch.data.preprocess, tokenpacker_tpu_torch.data.dataset, "
        "tokenpacker_tpu_torch.image.io, tokenpacker_tpu_torch.io.hf_import, "
        "tokenpacker_tpu_torch.train.step, tokenpacker_tpu_torch.train.trainer, "
        "tokenpacker_tpu_torch.ops.paged_attention, tokenpacker_tpu_torch.ops.paged_kv, "
        "tokenpacker_tpu_torch.serve.prefix_cache, tokenpacker_tpu_torch.serve.scheduler, "
        "tokenpacker_tpu_torch.ops.q4_matmul, tokenpacker_tpu_torch.ops.q8_matmul, "
        "tokenpacker_tpu_torch.ops.s8_gemm, tokenpacker_tpu_torch.ops.vit_block, "
        "tokenpacker_tpu_torch.speculative, tokenpacker_tpu_torch.serve.multi_lora, "
        "tokenpacker_tpu_torch.probes.dma_stride, tokenpacker_tpu_torch.probes.int4_ring, "
        "tokenpacker_tpu_torch.probes.bitcast_pack, tokenpacker_tpu_torch.probes.stream_dtype, "
        "tokenpacker_tpu_torch.beam; "
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'tokenpacker_tpu', 'scripts')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_constants_equal_jax():
    from tokenpacker_tpu import constants as jax_constants
    from tokenpacker_tpu_torch import constants

    names = [n for n in vars(constants) if n.isupper()]
    assert len(names) == 13  # the model constants and the serving ones
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name


def test_init_draws_biases_and_norm_scales():
    """Every bias is N(0, 0.02^2) and every norm scale 1 + N(0, 0.1^2), so
    the parity tests on these weights see a norm or bias that is dropped
    or swapped."""
    made = init_vlm_on_device(tiny_vlm_config(), seed=1, device="cpu", dtype=torch.float32)
    block = made["vision"]["layers"][0]
    scales = [block["ln1"]["scale"], block["ln2"]["scale"], made["lm"]["norm"]["scale"],
              made["lm"]["layers"][0]["input_ln"]["scale"], made["projector"]["ln_q"]["scale"]]
    biases = [block["attn"]["q"]["bias"], block["ln1"]["bias"], made["projector"]["mlp"]["fc1"]["bias"]]
    for s in scales:
        assert 0.05 < (s - 1).std() < 0.2
    for b in biases:
        assert 0.01 < b.std() < 0.04
    assert not torch.equal(block["ln1"]["scale"], block["ln2"]["scale"])


def test_cuda_requests_raise_without_a_card():
    """No silent CPU fallback: a CUDA device or a non-CPU tensor raises."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        init_vlm_on_device(tiny_vlm_config(), 0, device="cuda")
    meta = torch.empty((1, 8, 16), device="meta")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        vit_attention(meta, meta, meta, 2)
