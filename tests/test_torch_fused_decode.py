"""K4, the fused int8 decode step, against the JAX kernel (Pallas interpret
mode) on the CPU, at the geometry of the JAX package's own fused-decode
tests: D=512, 4 heads of 128, F=1024, 2 layers, B=2, S=64, ragged
prompts, 3 decode steps, bf16 and int8 caches.

Both sides get the same bf16 weights (int8-quantized by JAX and moved
with `params_from_jax`), the same prefilled caches and the same
embedded tokens. The port runs `fused_decode_hidden` on CPU tensors,
that is its plain version, which is also what the kernel is held against
on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.models.llama import KVCache as JaxKVCache
from tokenpacker_tpu.models.llama import llama_apply, make_attention_bias
from tokenpacker_tpu.ops import fused_decode as jax_fd
from tokenpacker_tpu.ops.quantize import fuse_llama_layers as jax_fuse
from tokenpacker_tpu.ops.quantize import quantize_tree as jax_quantize_tree
from tokenpacker_tpu_torch.config import LMConfig, TokenPackerVLMConfig
from tokenpacker_tpu_torch.io.weights import init_lm_on_device, params_from_jax, params_to_jax
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.ops import fused_decode
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv

# the JAX test's own bounds (tests/test_fused_decode.py): bf16 sums in
# another order, f32 vs bf16-rounded k*q products
HIDDEN_RTOL = 2e-2  # of max|hidden|
ROW_ATOL = 0.05  # new cache rows, after dequantization

B, S, PRE = 2, 64, 16
LENGTHS = np.array([10, 16], np.int32)


def tiny_cfg(**kw):
    base = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                num_attention_heads=4, model_family="llama")
    base.update(kw)
    return JaxLMConfig(**base), LMConfig(**base)


def _jax_tree(lm_cfg, seed=0):
    """Seeded weights (random norm scales) as a JAX numpy tree."""
    return params_to_jax({"lm": init_lm_on_device(lm_cfg, seed, "cpu", torch.float32)})["lm"]


def _int8_trees(seed=0):
    """(JAX int8 fused bf16 tree, the port's copy of it)."""
    cfg_j, cfg = tiny_cfg()
    tree = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _jax_tree(cfg, seed))
    tree = jax_quantize_tree(jax_fuse(tree), min_size=1)
    port = params_from_jax({"lm": jax.tree.map(np.asarray, tree)}, TokenPackerVLMConfig(lm=cfg))
    return cfg_j, cfg, tree, port["lm"]


def _jax_prefill_cache(tree, cfg_j, cache_dtype):
    emb = (0.1 * np.random.default_rng(1).standard_normal((B, PRE, cfg_j.hidden_size)))
    cache = JaxKVCache.create(cfg_j, B, S, dtype=cache_dtype)
    pos = jnp.broadcast_to(jnp.arange(PRE), (B, PRE))
    bias = make_attention_bias(pos, jnp.arange(S)[None, :] < LENGTHS[:, None], 0, S)
    _, cache = llama_apply(tree, cfg_j, jnp.asarray(emb, jnp.bfloat16), pos, bias, cache)
    return cache


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.fixture(scope="module")
def trees():
    return _int8_trees()


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_plain_k4_matches_jax_interpret(trees, cache_dtype):
    cfg_j, cfg, tree, port = trees
    jcache = _jax_prefill_cache(tree, cfg_j, jnp.int8 if cache_dtype == "int8" else jnp.bfloat16)
    int8 = cache_dtype == "int8"
    cache = KVCache(_to_torch(jcache.k), _to_torch(jcache.v), PRE,
                    _to_torch(jcache.k_scale) if int8 else None,
                    _to_torch(jcache.v_scale) if int8 else None)
    jk, jv, jks, jvs = jcache.k, jcache.v, jcache.k_scale, jcache.v_scale
    lengths = torch.from_numpy(LENGTHS)
    rng = np.random.default_rng(7)
    for step in range(3):
        emb = (0.1 * rng.standard_normal((B, cfg.hidden_size))).astype(np.float32)
        wpos = np.full((B,), PRE + step, np.int32)
        out = jax_fd.fused_decode_hidden(
            tree, cfg_j, jnp.asarray(emb, jnp.bfloat16), jk, jv, jnp.asarray(LENGTHS),
            jnp.full((B,), PRE, jnp.int32), jnp.asarray(wpos), jnp.asarray(wpos),
            positions=jnp.asarray(LENGTHS + step), interpret=True, k_scale=jks, v_scale=jvs,
        )
        want, jk, jv = out[:3]
        if int8:
            jks, jvs = out[3:]
        wp = torch.from_numpy(wpos)
        got, _, _ = fused_decode.fused_decode_hidden(
            port, cfg, torch.from_numpy(emb).to(torch.bfloat16), cache.k, cache.v, lengths,
            torch.full((B,), PRE, dtype=torch.int32), wp, wp, lengths + step,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
        )
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= HIDDEN_RTOL * np.abs(want).max(), (step, err)
        # the row written at PRE + step, as the next step will read it
        rows = np.arange(B)
        for c, sc, jc, jsc in ((cache.k, cache.k_scale, jk, jks), (cache.v, cache.v_scale, jv, jvs)):
            new = c[:, rows, wpos]
            jnew = _to_torch(np.asarray(jc)[:, rows, wpos])
            if int8:
                new = dequantize_kv(new, sc[:, rows, wpos], torch.float32)
                jnew = dequantize_kv(jnew, _to_torch(np.asarray(jsc)[:, rows, wpos]), torch.float32)
            assert (new.float() - jnew.float()).abs().max() < ROW_ATOL, step


def test_decode_step_k4_matches_per_layer_path(trees):
    """On one tree, the K4 step agrees with the per-layer int8 path (K3 over
    the dequantized cache), as the JAX test holds its kernel against XLA."""
    from tokenpacker_tpu_torch.generate import decode_step

    _, cfg, _, port = trees
    vcfg = TokenPackerVLMConfig(lm=cfg, dtype=torch.bfloat16)
    params = {"lm": port}
    lengths = torch.from_numpy(LENGTHS)
    gen = torch.Generator().manual_seed(3)
    caches = []
    for _ in range(2):
        c = KVCache.create(cfg, B, S, dtype=torch.int8)
        c.k.copy_(torch.randint(-127, 128, c.k.shape, generator=gen))
        c.v.copy_(torch.randint(-127, 128, c.v.shape, generator=gen))
        c.k_scale.copy_(torch.rand(c.k_scale.shape, generator=gen) * 0.01)
        c.v_scale.copy_(torch.rand(c.v_scale.shape, generator=gen) * 0.01)
        caches.append(c)
    caches[1] = KVCache(caches[0].k.clone(), caches[0].v.clone(), 0,
                        caches[0].k_scale.clone(), caches[0].v_scale.clone())
    tok = torch.tensor([5, 77])
    for step in range(2):
        got, _ = decode_step(params, vcfg, caches[0], tok, lengths, step, PRE, fused=True)
        want, _ = decode_step(params, vcfg, caches[1], tok, lengths, step, PRE, fused=False)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 3e-2 * want.float().abs().max().item(), (step, err)
        assert caches[0].length == caches[1].length == PRE + step + 1
        tok = want.argmax(-1)


def test_fused_eligible_agrees_with_jax():
    """Dense, fused bf16, fused int8 and GQA int8 trees, and a non-llama
    family: the port's eligibility equals the JAX package's."""
    cfg_j, cfg = tiny_cfg()
    gqa_j, gqa = tiny_cfg(num_key_value_heads=2)
    cases = []
    for cj, c in ((cfg_j, cfg), (gqa_j, gqa)):
        dense = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _jax_tree(c))
        for tree in (dense, jax_fuse(dense), jax_quantize_tree(jax_fuse(dense), min_size=1),
                     jax_quantize_tree(dense, min_size=1)):
            cases.append((cj, c, tree))
    mpt_j, mpt = tiny_cfg(model_family="mpt")
    cases.append((mpt_j, mpt, cases[2][2]))
    got = []
    for cj, c, tree in cases:
        port = params_from_jax({"lm": jax.tree.map(np.asarray, tree)},
                               TokenPackerVLMConfig(lm=cfg if c is mpt else c))
        want = jax_fd.fused_eligible(tree, cj)
        assert fused_decode.fused_eligible(port["lm"], c) == want
        got.append(want)
    assert got == [False, False, True, False, False, False, False, False, False]


def test_unported_forms_raise(trees):
    _, cfg, _, port = trees
    cache = KVCache.create(cfg, B, S, dtype=torch.bfloat16)
    z = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="LoRA"):
        fused_decode.fused_decode_hidden(port, cfg, torch.zeros(B, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z, slot_lora={})
    with pytest.raises(NotImplementedError, match="verify"):
        fused_decode.fused_decode_hidden(port, cfg, torch.zeros(B, 3, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    qp = {**port, "layers": [{**layer, "attn": {**layer["attn"], "qkv": {"kernel": {
        "qp": torch.zeros(1, dtype=torch.uint16), "scale": torch.zeros(1)}}}}
        for layer in port["layers"]]}
    with pytest.raises(NotImplementedError, match="qp"):
        fused_decode.fused_decode_hidden(qp, cfg, torch.zeros(B, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    with pytest.raises(ValueError, match="not an int8"):
        fused_decode.FusedWeights({"layers": []}, cfg)
