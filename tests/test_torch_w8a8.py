"""The w8a8 mode of the port against the JAX package on the CPU: the
per-row activation quantization, K7's and K8's plain versions, `linear`'s
routing, `clip_vit.quantize_tower_int8`, the tower and the paged batcher
with `w8a8=True`.

The JAX package routes to K7 and K8 only on a TPU backend
(`ops/layers.py:46-64`); here its `linear` is wrapped where its modules
import it, with the same routing and the kernels in interpret mode
(`jax_w8a8` below). The JAX package itself is not edited. The int32
products must equal JAX's exactly; every other tolerance is stated where
it is used.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.config import VisionConfig as JaxVisionConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.models import clip_vit as jax_clip_vit
from tokenpacker_tpu.models import llama as jax_llama
from tokenpacker_tpu.ops import layers as jax_layers
from tokenpacker_tpu.ops import paged_kv as jax_paged_kv
from tokenpacker_tpu.ops import q8_matmul as jq8
from tokenpacker_tpu.ops import s8_gemm as js8
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxBatcher
from tokenpacker_tpu_torch.config import LMConfig, VisionConfig, tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_to_jax,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models import clip_vit
from tokenpacker_tpu_torch.ops import layers
from tokenpacker_tpu_torch.ops.decode_attention import MAX_SPLITS
from tokenpacker_tpu_torch.ops.q8_matmul import (
    BLOCK_COLS,
    quantize_activations,
    s8_matmul,
    s8_matmul_plain,
    s8_splits,
    w8a8_matmul,
)
from tokenpacker_tpu_torch.ops.quantize import quantize_int8
from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm, s8_gemm_plain, w8a8_gemm
from tokenpacker_tpu_torch.ops.splits import STAGE_ROWS
from tokenpacker_tpu_torch.serve.scheduler import PagedContinuousBatcher


def _int8_leaf(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(w))
    return {"q": q, "scale": scale}


def test_quantize_activations_equal_jax():
    """Bit-equal int8 rows and scales, including a zero row (the 1e-8
    floor) and entries exactly half-way between two steps (x / ax = k +
    0.5, rounded to even as jnp.round does)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 384)).astype(np.float32)
    x[2] = 0.0
    x[3, 0] = 127.0  # ax = 1: x / ax is x itself
    x[3, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    xq, ax = quantize_activations(torch.from_numpy(x))
    jxq, jax_ = jq8.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jax_))
    assert xq[3, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    assert xq.dtype == torch.int8 and tuple(ax.shape) == (6, 1)


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (8, 512, 384), (16, 1024, 256), (3, 96, 48)])
def test_s8_matmul_plain_bit_equal_jax_kernel(m, k, n):
    """K7's plain version against `s8_matmul(interpret=True)` at the JAX
    test's shapes (tests/test_quantize.py), bit for bit; the wrapper on CPU
    tensors is the plain version. The last shape (M not a multiple of 8,
    K and N not of 128) is the JAX integer product, which the TPU kernel
    does not take."""
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = s8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    if m % 8 == 0:
        want = np.asarray(jq8.s8_matmul(jnp.asarray(xq), jnp.asarray(wq), interpret=True))
    else:
        want = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, s8_matmul_plain(torch.from_numpy(xq), torch.from_numpy(wq)))


# Vicuna-7B's w8a8 decode products (F's shapes): qkv, o, gateup, down, lm_head
F_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("k,n,splits", [
    (4096, 12288, 4), (4096, 4096, 8), (4096, 22016, 2), (11008, 4096, 8), (4096, 32000, 2),
    (32, 16, 1), (96, 48, 2), (1440, 16, 8), (1024, 1040, 8),
])
def test_s8_splits_at_the_w8a8_shapes(k, n, splits):
    """K7's blocks a 128-column tile: F's products take 2-8 splits; a K of
    one or two 64-row stages takes no more splits than stages, and a K of
    23 stages (the last one half full) takes 8 uneven ones."""
    assert s8_splits(k, n) == splits


@pytest.mark.parametrize("sms", [132, 114])
def test_s8_splits_take_whole_stages_and_fill_the_card(sms):
    """A power of two up to the cluster size, never more splits than K has
    64-row stages; while K allows it, the grid holds two blocks an SM. F's
    products fill every SM."""
    for k in (32, 64, 96, 128, 1024, 1440, 4096, 11008):
        for n in (16, 48, 640, 1024, 4096, 12288, 22016, 32000):
            splits = s8_splits(k, n, sms)
            stages, tiles = -(-k // STAGE_ROWS), -(-n // BLOCK_COLS)
            assert splits in (1, 2, 4, 8) and splits <= MAX_SPLITS
            assert splits <= stages
            if splits < MAX_SPLITS and 2 * splits <= stages:
                assert tiles * splits >= 2 * sms
    for k, n in F_SHAPES:
        assert -(-n // BLOCK_COLS) * s8_splits(k, n, sms) >= sms


def test_w8a8_matmul_matches_jax():
    """Within 1e-5 of `w8a8_matmul(interpret=True)` (the JAX test's shape
    and tolerance); leading dims kept."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    leaf = _int8_leaf(rng, 512, 384)
    jleaf = {"q": jnp.asarray(leaf["q"].numpy()), "scale": jnp.asarray(leaf["scale"].numpy())}
    want = np.asarray(jq8.w8a8_matmul(jnp.asarray(x), jleaf, interpret=True))
    got = w8a8_matmul(torch.from_numpy(x).reshape(1, 3, 512), leaf)
    assert tuple(got.shape) == (1, 3, 384)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [256, 300])
def test_s8_gemm_plain_matches_jax_kernel(m):
    """K8's plain version against `s8_gemm(interpret=True)`: the int8 rows
    equal JAX's quantization and the outputs agree within 1e-5 (fp32)."""
    rng = np.random.default_rng(m)
    k, n = 256, 384
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[5] *= 40.0  # rows of very different size
    leaf = _int8_leaf(rng, k, n)
    want = np.asarray(js8.s8_gemm(jnp.asarray(x), jnp.asarray(leaf["q"].numpy()),
                                  jnp.asarray(leaf["scale"].numpy()), interpret=True))
    y, xq, ax, acc = s8_gemm_plain(torch.from_numpy(x), leaf["q"], leaf["scale"], parts=True)
    jxq, jax_ = jq8.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jax_))
    np.testing.assert_array_equal(
        acc.numpy(), xq.numpy().astype(np.int64) @ leaf["q"].numpy().astype(np.int64))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(s8_gemm(torch.from_numpy(x), leaf["q"], leaf["scale"]), y)
    got = w8a8_gemm(torch.from_numpy(x).reshape(2, m // 2, k), leaf)
    assert torch.equal(got.reshape(m, n), y)


def _spies(monkeypatch):
    calls = {}
    for name in ("w8a8_matmul", "w8a8_gemm", "q4_matmul"):
        real = getattr(layers, name)

        def spy(*args, real=real, name=name):
            calls[name] = calls.get(name, 0) + 1
            return real(*args)

        monkeypatch.setattr(layers, name, spy)
    return calls


@pytest.mark.parametrize("m,k,n,route", [
    (64, 256, 384, "w8a8_matmul"), (65, 256, 384, None), (255, 256, 384, None),
    (256, 256, 384, "w8a8_gemm"), (256, 200, 384, None), (256, 256, 200, None),
    (1, 200, 200, "w8a8_matmul"),
])
def test_linear_routes_w8a8_as_jax(monkeypatch, m, k, n, route):
    """With w8a8: K7 for M <= 64, K8 for M >= 256 with K and N multiples of
    128, else the weight-only product (M 65-255, or K or N not multiples of
    128); without w8a8 always the weight-only product. Each route's output
    equals its function's (bias added)."""
    calls = _spies(monkeypatch)
    rng = np.random.default_rng(m + k + n)
    p = {"kernel": _int8_leaf(rng, k, n), "bias": torch.from_numpy(rng.standard_normal(n)
                                                                    .astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((1, m, k)).astype(np.float32))
    weight_only = (x @ p["kernel"]["q"].float()) * p["kernel"]["scale"][0] + p["bias"]
    torch.testing.assert_close(layers.linear(p, x), weight_only, rtol=0, atol=0)
    assert calls == {}
    y = layers.linear(p, x, w8a8=True)
    assert calls == ({route: 1} if route else {})
    fn = {"w8a8_matmul": w8a8_matmul, "w8a8_gemm": w8a8_gemm, None: None}[route]
    want = weight_only if fn is None else fn(x, p["kernel"]) + p["bias"]
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_quantize_tower_int8_equals_jax():
    """The tower's q/k/v/o and fc1/fc2 become int8 leaves with JAX's bytes
    and scales; every other leaf is untouched and shared."""
    cfg = tiny_vlm_config()
    vision = init_vlm_on_device(cfg, seed=4, device="cpu", dtype=torch.float32)["vision"]
    got = clip_vit.quantize_tower_int8(vision)
    want = jax_clip_vit.quantize_tower_int8(jax.tree.map(jnp.asarray, params_to_jax(vision)))
    got_leaves = jax.tree_util.tree_leaves_with_path(params_to_jax(got))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
    assert got["layers"][0]["attn"]["q"]["kernel"]["q"].dtype == torch.int8
    assert got["layers"][0]["ln1"] is vision["layers"][0]["ln1"]
    assert got["pos_embed"] is vision["pos_embed"]


def _jax_w8a8_linear(params, x):
    """The JAX package's `linear` with its TPU routing of the w8a8 mode
    (ops/layers.py:46-64), the kernels in interpret mode."""
    k = params["kernel"]
    if isinstance(k, dict) and set(k) == {"q", "scale"} and k["q"].ndim == 2:
        m = math.prod(x.shape[:-1])
        if m <= 64:
            y = jq8.w8a8_matmul(x, k, interpret=True)
        elif m >= 256 and x.shape[-1] % 128 == 0 and k["q"].shape[1] % 128 == 0:
            y = js8.w8a8_gemm(x, k, interpret=True)
        else:
            return jax_layers.linear(params, x)
        return y + params["bias"] if params.get("bias") is not None else y
    return jax_layers.linear(params, x)


@pytest.fixture
def jax_w8a8(monkeypatch):
    for mod in (jax_clip_vit, jax_llama, jax_paged_kv):
        monkeypatch.setattr(mod, "linear", _jax_w8a8_linear)


# CLIP-like tower whose widths are multiples of 128, so that K8's route is
# taken: 16 images of 17 positions are 272 rows
TOWER = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=3, num_attention_heads=4,
             image_size=56, patch_size=14, multi_layers=(1, 2, 3))


def test_tower_w8a8_matches_jax(jax_w8a8, monkeypatch):
    """The int8 tower with w8a8 (every block product through K8's route)
    against JAX's clip_tower_features with the wrapped linear, fp32: within
    2e-3 of the largest feature. Both sides quantize the same activations,
    but their attention sums in another order, so an activation that lies
    within rounding of a half-way point may take the other int8 step
    (one step of ax * scale in one product term)."""
    calls = _spies(monkeypatch)
    vc, jvc = VisionConfig(**TOWER), JaxVisionConfig(**TOWER)
    cfg = tiny_vlm_config(vision=vc)
    vision = init_vlm_on_device(cfg, seed=5, device="cpu", dtype=torch.float32)["vision"]
    qv = clip_vit.quantize_tower_int8(vision)
    jqv = jax_clip_vit.quantize_tower_int8(jax.tree.map(jnp.asarray, params_to_jax(vision)))
    images = np.random.default_rng(6).standard_normal((16, 56, 56, 3)).astype(np.float32)
    feats, multi = clip_vit.clip_tower_features(qv, vc, torch.from_numpy(images), w8a8=True)
    assert calls == {"w8a8_gemm": 6 * 3}
    jfeats, jmulti = jax_clip_vit.clip_tower_features(jqv, jvc, jnp.asarray(images))
    for got, want in ((feats, jfeats), (multi, jmulti)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * np.abs(want).max())
    dense, _ = clip_vit.clip_tower_features(vision, vc, torch.from_numpy(images))
    rel = (feats - dense).norm() / dense.norm()
    assert 0 < rel < 0.05, rel  # the int8 scheme's own error against the dense tower


# the tiny LM at widths that are multiples of 128 (qkv 128 x 384, gateup
# 128 x 512, down 256 x 128, lm_head 128 x 256), so that admission chunks
# of 256 rows take K8's route and decode steps K7's
LM = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=1024)
PAGED = dict(num_slots=2, num_pages=96, page_size=16, max_pages_per_seq=32, prefix_cache=True,
             prefill_chunk_size=256)


def _text_request(ids):
    ids = np.asarray(ids, np.int64)[None]
    return {"token_ids": ids, "is_image": np.zeros_like(ids, bool),
            "image_slot": np.zeros_like(ids, np.int32), "lengths": np.array([ids.shape[1]]),
            "images": None}


def test_paged_batcher_w8a8_matches_jax(jax_w8a8, monkeypatch):
    """The paged batcher with w8a8=True on an int8 fp32 tree against the
    JAX batcher with the wrapped linear, chunked admissions of 256: a
    300-token prompt (padded to the 512 bucket: two chunks of 256, K8's
    route), a 100-token one (padded to the 128 bucket: one chunk of 128,
    the weight-only route) and a repeat of the first (a prefix-cache hit
    on 18 pages whose suffix chunk of 224 takes the weight-only route),
    one request at a time: 15 decode steps and the 3 first-token heads
    through K7's route.
    fp32 on both sides and the same int8 weights: every greedy token
    equal."""
    cfg = tiny_vlm_config(lm=LMConfig(**LM))
    cfg_j = jax_tiny_config(lm=JaxLMConfig(**LM))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=12, device="cpu",
                                                 dtype=torch.float32), min_size=1)
    rng = np.random.default_rng(7)
    long = [1] + rng.integers(3, 256, 299).tolist()
    reqs = [_text_request(long), _text_request([1] + rng.integers(3, 256, 99).tolist()),
            _text_request(long)]

    def serve(batcher):
        batcher.start()
        try:
            out = []
            for r in reqs:  # one at a time: the repeat finds the first's pages cached
                out.append(batcher.submit(r, 6).result(timeout=600))
            return out
        finally:
            batcher.stop()

    want = serve(JaxBatcher(params_to_jax(params), cfg_j, **PAGED))
    calls = _spies(monkeypatch)
    got = serve(PagedContinuousBatcher(params, cfg, device="cpu", w8a8=True, **PAGED))
    assert got == want
    assert got[2] == got[0] and all(len(t) == 6 for t in got)
    # K8: 2 chunks x 2 layers x 4 products; K7: 3 first-token heads and
    # (2 layers x 4 + 1) per decode step
    assert calls == {"w8a8_gemm": 2 * 2 * 4, "w8a8_matmul": 3 + 15 * 9}
