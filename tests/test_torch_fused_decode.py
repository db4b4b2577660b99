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
from tokenpacker_tpu_torch.ops.splits import MAX_SPLITS, STAGE_ROWS, cluster_splits

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
    # slot LoRA is K4-LoRA's (tests/test_torch_multi_lora.py); a QLoRA
    # `lora_a` on an int8 kernel stays refused, as JAX's fused_eligible
    # refuses it
    qlora = {**port, "layers": [{**layer, "mlp": {**layer["mlp"], "down": {"kernel": {
        **layer["mlp"]["down"]["kernel"], "lora_a": torch.zeros(1)}}}}
        for layer in port["layers"]]}
    with pytest.raises(NotImplementedError, match="int8 fused"):
        fused_decode.fused_decode_hidden(qlora, cfg, torch.zeros(B, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    # the T = k+1 verify form is ported: it is fused_verify_hidden's, and
    # fused_decode_hidden points there
    with pytest.raises(ValueError, match="fused_verify_hidden"):
        fused_decode.fused_decode_hidden(port, cfg, torch.zeros(B, 3, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    hidden, k_new, _ = fused_decode.fused_verify_hidden(
        port, cfg, torch.zeros(B, 3, cfg.hidden_size, dtype=torch.bfloat16), cache.k, cache.v,
        z, z, z, z, torch.zeros(B, 3, dtype=torch.int32))
    assert hidden.shape == (B, 3, cfg.hidden_size) and k_new.shape[1:3] == (B, 3)
    with pytest.raises(NotImplementedError, match="int8 fused"):
        fused_decode.fused_verify_hidden(qlora, cfg, torch.zeros(B, 3, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    qp = {**port, "layers": [{**layer, "attn": {**layer["attn"], "qkv": {"kernel": {
        "qp": torch.zeros(1, dtype=torch.uint16), "scale": torch.zeros(1)}}}}
        for layer in port["layers"]]}
    with pytest.raises(NotImplementedError, match="qp"):
        fused_decode.fused_decode_hidden(qp, cfg, torch.zeros(B, cfg.hidden_size), cache.k,
                                         cache.v, z, z, z, z, z)
    with pytest.raises(ValueError, match="not an int8"):
        fused_decode.FusedWeights({"layers": []}, cfg)


# K4's GEMV and attention plans on the card (`step_plan`: `cluster_splits`
# and `att_splits`, which the kernel's host code computes alike and a card
# test of tests/test_torch_cuda.py holds to them): Vicuna-7B's products
# and B's cache
@pytest.mark.parametrize("name,k,splits", [
    ("qkv", 4096, 4), ("o", 4096, 8), ("gateup", 4096, 2), ("down", 11008, 8),
])
def test_gemv_splits_at_vicuna_7b(name, k, splits):
    """qkv's 96 tiles take 4 splits, o's and down's 32 take 8, gate/up's 172
    (64 gate and 64 up columns each) take 2: every product holds two
    blocks an SM or the cluster's 8."""
    tiles = fused_decode.gemv_tiles(4096, 11008)[name]
    assert cluster_splits(k, tiles) == splits
    assert fused_decode.step_plan(4, 1, 4096, 11008, 32, 2080)[name] == splits
    assert tiles * splits >= 132


@pytest.mark.parametrize("sms", [132, 114])
def test_gemv_splits_keep_whole_stages(sms):
    """A power of two up to the cluster size, never more splits than K has
    64-row stages; while K allows it, the grid holds two blocks an SM."""
    for k in (32, 64, 96, 512, 1024, 2816, 4096, 11008):
        for tiles in (1, 4, 8, 22, 32, 44, 96, 172):
            splits = cluster_splits(k, tiles, sms)
            stages = -(-k // STAGE_ROWS)
            assert splits in (1, 2, 4, 8) and splits <= stages
            if splits < MAX_SPLITS and 2 * splits <= stages:
                assert tiles * splits >= 2 * sms


@pytest.mark.parametrize("b,heads,s,t,splits", [
    (4, 32, 2080, 1, 2), (4, 32, 2080, 5, 2), (4, 32, 1040, 1, 2), (8, 32, 2080, 1, 1),
    (1, 8, 544, 1, 2), (1, 8, 544, 16, 2), (3, 8, 160, 1, 1), (1, 32, 2080, 5, 8),
    (1, 32, 2080, 1, 8),
])
def test_att_splits_fill_the_card_in_whole_tiles(b, heads, s, t, splits):
    """B's attention (4 samples, 32 heads, S = 2080) takes 2 splits at T =
    1 (256 blocks: one wave of two an SM) and 2 in the verify form, whose
    tiles cost more; a split keeps at least 256 of the S slots (8 tiles of
    32 keys)."""
    assert fused_decode.att_splits(b, heads, s, t) == splits
    assert fused_decode.step_plan(b, t, heads * 128, 11008, heads, s)["attention"] == splits


@pytest.mark.parametrize("sms", [132, 114])
def test_att_splits_keep_256_slots_a_split(sms):
    for b in (1, 3, 4, 8):
        for heads in (8, 32):
            for s in (64, 160, 544, 1040, 2080, 4096):
                for t in (1, 5):
                    splits = fused_decode.att_splits(b, heads, s, t, sms)
                    assert splits in (1, 2, 4, 8) and (splits == 1 or s >= 256 * splits)
                    if t == 1:  # one wave of two blocks an SM
                        assert splits == 1 or b * heads * splits <= 2 * sms
                    if splits < MAX_SPLITS and s >= 512 * splits:
                        assert b * heads * splits > sms if t == 1 else b * heads * splits >= sms


def test_gemv_tiles_cover_every_column():
    """qkv's tiles are whole heads (a tile of q, k or v is one head of
    128), gate/up's cover f in runs of 64 gate and 64 up columns."""
    for d, f in ((4096, 11008), (1024, 2816), (512, 1024), (256, 688)):
        tiles = fused_decode.gemv_tiles(d, f)
        assert tiles["qkv"] == 3 * (d // 128) and tiles["o"] == tiles["down"] == d // 128
        assert (tiles["gateup"] - 1) * 64 < f <= tiles["gateup"] * 64
