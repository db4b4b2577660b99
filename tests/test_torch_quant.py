"""The int8 serving pieces of the port against the JAX package on the CPU:
weight quantization, the fused layouts, int8 KV rows, the int8 linear,
the int8-cache prefill, the weight bridge of a quantized tree and
`quantize_lm_int8` (the `load_8bit` counterpart).

Quantizers must give the same bytes as JAX (int8 values and f32 scales
equal); products and the prefill are compared in fp32 within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.models import llama as jax_llama
from tokenpacker_tpu.ops import kv_quant as jax_kv
from tokenpacker_tpu.ops import layers as jax_layers
from tokenpacker_tpu.ops import quantize as jax_quant
from tokenpacker_tpu_torch.config import LMConfig, TokenPackerVLMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_lm_on_device,
    init_vlm_on_device,
    params_from_jax,
    params_to,
    params_to_jax,
    quantize_lm_int8,
    to_tensors,
)
from tokenpacker_tpu_torch.models import llama
from tokenpacker_tpu_torch.ops import kv_quant, layers, quantize

# fp32 on both sides, sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)

LM = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
          num_attention_heads=4)


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _lm_tree(seed=0, **kw):
    cfg = LMConfig(**{**LM, **kw})
    tree = params_to_jax({"lm": init_lm_on_device(cfg, seed, "cpu", torch.float32)})["lm"]
    return JaxLMConfig(**{**LM, **kw}), cfg, tree


def _port(tree, cfg):
    return params_from_jax({"lm": jax.tree.map(np.asarray, tree)}, TokenPackerVLMConfig(lm=cfg))["lm"]


def _equal_trees(got, want):
    """Port tree (per-layer lists) == JAX tree (stacked), leaf for leaf, dtypes too."""
    back = params_to_jax(got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


@pytest.mark.parametrize("shape", [(64, 48), (3, 128, 40), (16, 1)])
def test_quantize_int8_equals_jax(shape):
    w = _randn(shape, 0, 0.02)
    w[..., 0, :] = np.round(w[..., 0, :] * 1e4) / 1e4  # some exact halves after scaling
    if shape[-1] > 1:
        w[..., 1] = 0.0  # an all-zero column: scale 1, q 0
    q, s = quantize.quantize_int8(torch.from_numpy(w))
    jq, js = jax_quant.quantize_int8(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quantize.dequantize_int8(q, s, torch.float32).numpy(),
                                  np.asarray(jax_quant.dequantize_int8(jq, js, jnp.float32)))


@pytest.mark.parametrize("min_size", [1, 1 << 16, 1 << 20])
def test_fuse_and_quantize_tree_equal_jax(min_size):
    """fuse_llama_layers then quantize_tree; the size threshold counts all
    layers, as the JAX package counts its stacked leaves."""
    cfg_j, cfg, tree = _lm_tree()
    want = jax_quant.quantize_tree(jax_quant.fuse_llama_layers(tree), min_size=min_size)
    got = quantize.quantize_tree(quantize.fuse_llama_layers(_port(tree, cfg)), min_size=min_size)
    _equal_trees(got, want)
    _equal_trees(quantize.dequantize_tree(got, torch.float32),
                 jax_quant.dequantize_tree(want, jnp.float32))
    assert quantize.tree_bytes(got) == jax_quant.tree_bytes(want)


def test_quantize_lm_int8_equals_load_8bit():
    """`quantize_lm_int8` = the JAX `load_8bit` LM transform (fuse, then
    quantize_tree), layer by layer and in place."""
    cfg_j, cfg, tree = _lm_tree(seed=2)
    want = jax_quant.quantize_tree(jax_quant.fuse_llama_layers(tree))
    params = {"lm": _port(tree, cfg)}
    first = params["lm"]["layers"]
    assert quantize_lm_int8(params) is params and params["lm"]["layers"] is first
    _equal_trees(params["lm"], want)
    assert quantize.is_qleaf(params["lm"]["lm_head"]["kernel"])


@pytest.mark.parametrize("shape", [(2, 5, 4, 128), (3, 2, 16)])
def test_quantize_kv_equals_jax(shape):
    x = _randn(shape, 1)
    x[0, 0] = 0.0  # a zero row
    x[-1, -1, ..., :4] = np.array([127.0, 63.5, -0.5, 1.5]) / 127.0  # halves: to even
    q, s = kv_quant.quantize_kv(torch.from_numpy(x))
    jq, js = jax_kv.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(kv_quant.dequantize_kv(q, s, torch.float32).numpy(),
                                  np.asarray(jax_kv.dequantize_kv(jq, js, jnp.float32)))


def test_int8_linear_matches_jax():
    w = _randn((64, 48), 3, 0.05)
    jq, js = jax_quant.quantize_int8(jnp.asarray(w))
    leaf = {"kernel": {"q": np.asarray(jq), "scale": np.asarray(js)}, "bias": _randn((48,), 4)}
    x = _randn((3, 5, 64), 5)
    got = layers.linear(to_tensors(leaf), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_layers.linear(leaf, x)), **TOL)
    # a 4-bit leaf goes through linear as JAX's does (4-bit parity in
    # tests/test_torch_q4.py); a leaf of another form raises
    q4 = jax_quant.quantize_4bit(jnp.asarray(w), 64, "nf4")
    leaf4 = {"kernel": {k: np.asarray(v) for k, v in q4.items()}, "bias": leaf["bias"]}
    got = layers.linear(to_tensors(leaf4), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_layers.linear(leaf4, x)), **TOL)
    with pytest.raises(NotImplementedError, match="not a ported leaf"):
        layers.linear({"kernel": {"qp": torch.zeros(1)}}, torch.zeros(1, 64))


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_int8_cache_prefill_matches_jax(kv_heads):
    """llama_apply over a fused int8 tree with an int8 cache: hidden states
    and the cache (int8 rows and scales) against JAX with its flash
    prefill, which attends the unquantized k/v as the port's K2 does."""
    cfg_j, cfg, tree = _lm_tree(seed=1, num_key_value_heads=kv_heads)
    tree = jax_quant.quantize_tree(jax_quant.fuse_llama_layers(tree), min_size=1)
    params = _port(tree, cfg)
    n, t, s = 2, 12, 32
    x = _randn((n, t, cfg.hidden_size), 6, 0.1)
    pos = np.broadcast_to(np.arange(t), (n, t)).copy()
    lengths = np.array([12, 7])
    bias = jax_llama.make_attention_bias(
        jnp.asarray(pos), jnp.asarray(np.arange(s)[None] < lengths[:, None]), 0, s)
    jcache = jax_llama.KVCache.create(cfg_j, n, s, dtype=jnp.int8)
    want, jcache = jax_llama.llama_apply(tree, cfg_j, jnp.asarray(x), jnp.asarray(pos), bias,
                                         jcache, use_flash=True)
    cache = llama.KVCache.create(cfg, n, s, dtype=torch.int8)
    got = llama.llama_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(pos), cache)
    assert cache.length == t
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :ln].numpy(), np.asarray(want)[i, :ln], **TOL)
        for rows, scales, jrows, jscales in ((cache.k, cache.k_scale, jcache.k, jcache.k_scale),
                                             (cache.v, cache.v_scale, jcache.v, jcache.v_scale)):
            np.testing.assert_allclose(scales[:, i, :ln].numpy(), np.asarray(jscales)[:, i, :ln],
                                       **TOL)
            # fp32 rows that differ by ~1e-6 may round to neighbouring int8
            # values: at most one step, on at most 1% of the entries
            dq = rows[:, i, :ln].int() - torch.from_numpy(np.array(jrows[:, i, :ln])).int()
            assert dq.abs().max() <= 1 and (dq != 0).float().mean() < 0.01


def test_quantized_bridge_round_trip():
    """params_from_jax -> params_to_jax keeps int8 as int8 and scale [1, N]
    per layer; params_to keeps the scales f32."""
    cfg = tiny_vlm_config(lm=LMConfig(**LM))
    full = params_to_jax(init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32))
    full["lm"] = jax.tree.map(np.asarray,
                              jax_quant.quantize_tree(jax_quant.fuse_llama_layers(full["lm"])))
    params = params_from_jax(full, cfg)
    k = params["lm"]["layers"][1]["attn"]["qkv"]["kernel"]
    assert k["q"].dtype == torch.int8 and k["q"].shape == (512, 1536)
    assert k["scale"].dtype == torch.float32 and k["scale"].shape == (1, 1536)
    _equal_trees(params, full)
    half = params_to(params, "cpu", torch.bfloat16)
    k = half["lm"]["layers"][0]["mlp"]["down"]["kernel"]
    assert k["q"].dtype == torch.int8 and k["scale"].dtype == torch.float32
    assert half["lm"]["layers"][0]["input_ln"]["scale"].dtype == torch.bfloat16


def test_int8_kv_cache_create():
    cfg = LMConfig(**LM)
    c = llama.KVCache.create(cfg, 3, 40, dtype=torch.int8)
    assert c.k.dtype == torch.int8 and c.k.shape == (2, 3, 40, 4, 128)
    assert c.k_scale.dtype == torch.float32 and c.k_scale.shape == (2, 3, 40, 4)
    f = llama.KVCache.create(dataclasses.replace(cfg), 1, 8)
    assert f.k_scale is None and f.k.dtype == torch.bfloat16
