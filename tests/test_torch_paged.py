"""The paged serving path of the port against the JAX package on the CPU:
K5's plain version, the paged decode step, admission into the pool,
chunked prefill at an offset, the prefix cache and the
PagedContinuousBatcher as a whole, on the tiny geometry and the same
seeded weights and numpy inputs.

The JAX side runs as its own tests run it: K5 as `paged_attention(...,
interpret=True)` and, in the decode step, through TOKENPACKER_PAGED_ATTN=
pallas (interpret mode on the CPU); its batcher on its default gather
path. Every tolerance is stated where it is used.
"""

import queue
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.models import llama as jax_llama
from tokenpacker_tpu.models.vlm import encode_images as jax_encode_images
from tokenpacker_tpu.ops import kv_quant as jax_kv_quant
from tokenpacker_tpu.ops import paged_kv as jax_paged_kv
from tokenpacker_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from tokenpacker_tpu.serve import prefix_cache as jax_prefix_cache
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxBatcher
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    paged_from_jax,
    paged_to_jax,
    params_from_jax,
    params_to,
    params_to_jax,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.models.vlm import encode_images
from tokenpacker_tpu_torch.ops import paged_kv
from tokenpacker_tpu_torch.ops.decode_attention import MAX_SPLITS
from tokenpacker_tpu_torch.ops.paged_attention import (
    MIN_SPLIT_POSITIONS,
    paged_attention,
    paged_attention_plain,
    paged_splits,
)
from tokenpacker_tpu_torch.serve import prefix_cache
from tokenpacker_tpu_torch.serve.multi_lora import Adapter
from tokenpacker_tpu_torch.serve import scheduler as sched
from tokenpacker_tpu_torch.serve.scheduler import PagedContinuousBatcher

SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def model():
    """Seeded tiny weights (made by the port's initializer), loaded by both
    packages: the fp32 tree and its int8 fused form (`quantize_lm_int8`
    with every kernel quantized, as the JAX serving dry run quantizes)."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=11, device="cpu", dtype=torch.float32)
    int8 = quantize_lm_int8(params_to(params, "cpu", torch.float32), min_size=1)
    return {"cfg": cfg, "cfg_j": jax_tiny_config(), "params": params,
            "tree": params_to_jax(params), "int8": int8, "int8_tree": params_to_jax(int8)}


# -- K5's plain version ---------------------------------------------------------


def _pool(rng, n_pages, ps, hkv, d, int8, lead=()):
    """Random pages (numpy f32), quantized with the JAX package's
    quantize_kv for an int8 pool: (k, v, k_scales, v_scales)."""
    k, v = (rng.standard_normal((*lead, n_pages, ps, hkv, d)).astype(np.float32) for _ in range(2))
    if not int8:
        return k, v, None, None
    (kq, ks), (vq, vs) = (jax_kv_quant.quantize_kv(jnp.asarray(x)) for x in (k, v))
    return tuple(np.array(x) for x in (kq, vq, ks, vs))


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("groups", [1, 4])
def test_paged_attention_plain_matches_jax(pool, groups):
    """Shuffled pages; lengths 19 (ends inside its 3rd page), 16 (fills its
    last page), 5 and 0 (no key: 0); table entries past each length point
    at pages of other sequences. Against JAX's kernel in interpret mode:
    fp32 and int8 pools within 1e-5 (the same fp32 arithmetic, the scales
    folded the same way); a bf16 pool within 1e-2 of max|o| (the kernel
    rounds the probabilities to bf16 against its running max, the plain
    version against the global max; the outputs are bf16). Against JAX's
    gather path (dequantize, `_sdpa`) for the rows with keys: 1e-4, and
    1e-2 of max|o| in bf16."""
    rng = np.random.default_rng(3 + groups)
    n, h, d, ps, mp, p_total = 4, 4, 32, 8, 4, 13
    hkv = h // groups
    k, v, ks, vs = _pool(rng, p_total, ps, hkv, d, pool == "int8")
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    pages = rng.permutation(np.arange(1, p_total))
    table = np.stack([pages[0:4], pages[4:8], pages[8:12], pages[[3, 2, 1, 0]]]).astype(np.int32)
    lengths = np.array([19, 16, 5, 0], np.int32)
    jdt = jnp.bfloat16 if pool == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jdt if x.dtype == np.float32 else None) for x in (q, k, v))
    scales = {} if ks is None else {"k_scales": jnp.asarray(ks), "v_scales": jnp.asarray(vs)}
    want = np.asarray(jax_paged_attention(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                                          groups=groups, interpret=True, **scales), np.float32)

    def t(x):
        if x is None:
            return None
        x = torch.from_numpy(np.array(x))
        return x.to(torch.bfloat16) if pool == "bfloat16" and x.dtype == torch.float32 else x

    got = _np(paged_attention(t(q), t(k), t(v), torch.from_numpy(table),
                              torch.from_numpy(lengths), t(ks), t(vs)))
    assert got.shape == (n, h, d) and not got[3].any()
    tol = 1e-2 * np.abs(want).max() if pool == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)

    # the gather path of JAX's _paged_layer: pages -> dense rows, dequantized
    kg, vg = (jnp.asarray(x)[table].reshape(n, mp * ps, hkv, d) for x in (jk, jv))
    if ks is not None:
        kg = jax_kv_quant.dequantize_kv(kg, jnp.asarray(ks)[table].reshape(n, -1, hkv), jnp.float32)
        vg = jax_kv_quant.dequantize_kv(vg, jnp.asarray(vs)[table].reshape(n, -1, hkv), jnp.float32)
    bias = jnp.where(jnp.arange(mp * ps)[None, None, None, :] < lengths[:, None, None, None],
                     0.0, jnp.finfo(jnp.float32).min)
    gather = np.asarray(jax_llama._sdpa(jq[:, None], kg.astype(jq.dtype), vg.astype(jq.dtype),
                                        bias)[:, 0], np.float32)
    tol = 1e-2 * np.abs(gather).max() if pool == "bfloat16" else 1e-4
    np.testing.assert_allclose(got[:3], gather[:3], atol=tol, rtol=0)


def test_paged_attention_plain_reads_nothing_past_the_length():
    """Pages past a sequence's length and rows past it in its last page may
    hold anything, even NaN (a stale table, a freed page)."""
    rng = np.random.default_rng(9)
    k, v, _, _ = _pool(rng, 6, 8, 2, 32, False)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
    table = torch.tensor([[2, 4, 1]], dtype=torch.int32)
    lengths = torch.tensor([11], dtype=torch.int32)
    want = paged_attention(q, torch.from_numpy(k), torch.from_numpy(v), table, lengths)
    k[1], v[1], k[4, 3:], v[4, 3:] = np.nan, np.nan, np.nan, np.nan
    got = paged_attention(q, torch.from_numpy(k), torch.from_numpy(v), table, lengths)
    assert torch.equal(got, want)


# -- the paged decode step -----------------------------------------------------


def _decode_case(lm, int8):
    """A pool of 3 slots: slot 0 (length 10 over pages 1-3, page 6 mapped
    for its growth), slot 1 (length 5, pages 4-5), slot 2 inactive with a
    stale row whose write target (block 1 = page 2, offset 5 % 4) is a
    position slot 0 attends."""
    rng = np.random.default_rng(7 + int8)
    k, v, ks, vs = _pool(rng, 8, 4, lm.kv_heads, lm.head_dim, int8, (lm.num_hidden_layers,))
    table = np.zeros((3, 4), np.int32)
    table[0] = [1, 2, 3, 6]
    table[1, :2] = [4, 5]
    table[2, 1] = 2
    return (k, v, table, np.array([10, 5, 5], np.int32), ks, vs)


@pytest.mark.parametrize("n,hkv,mp,ps,splits", [
    (8, 32, 40, 64, 2), (8, 8, 40, 64, 4), (4, 8, 64, 64, 8), (1, 32, 160, 16, 4),
    (4, 8, 10, 64, 1), (2, 32, 2, 64, 1), (8, 32, 1, 64, 1), (64, 32, 40, 64, 1),
])
def test_paged_splits_at_the_serving_shapes(n, hkv, mp, ps, splits):
    """K5's blocks a (sequence, kv head): D's and F's pool (8 slots, 32 kv
    heads, 40 pages of 64) takes 2 splits, its 8-kv-head form 4; a table
    of one page, or a grid that fills the card, takes one."""
    assert paged_splits(n, hkv, mp, ps) == splits


@pytest.mark.parametrize("sms", [132, 114])
def test_paged_splits_take_whole_pages_and_fill_the_card(sms):
    """A power of two up to the cluster size, never more splits than the
    table has pages (each split can take a whole page) nor fewer than
    MIN_SPLIT_POSITIONS positions a split; while the table allows it, the
    grid holds two blocks an SM. D's and F's grid (8 slots, 32 kv heads)
    and its 8-kv-head form fill every SM."""
    for n in (1, 2, 4, 8, 32):
        for hkv in (4, 8, 32):
            for ps in (16, 32, 64):
                for mp in (1, 2, 3, 5, 8, 10, 40, 64, 130):
                    splits = paged_splits(n, hkv, mp, ps, sms)
                    assert splits in (1, 2, 4, 8) and splits <= MAX_SPLITS
                    assert splits <= mp
                    assert splits == 1 or mp * ps >= MIN_SPLIT_POSITIONS * splits
                    if (splits < MAX_SPLITS and 2 * splits <= mp
                            and mp * ps >= 2 * MIN_SPLIT_POSITIONS * splits):
                        assert n * hkv * splits >= 2 * sms
    for hkv in (32, 8):
        assert 8 * hkv * paged_splits(8, hkv, 40, 64, sms) >= sms


@pytest.mark.parametrize("form", ["bf16 unfused, bf16 pool", "fp32 int8 fused, int8 pool"])
def test_paged_decode_step_matches_jax(model, form, monkeypatch):
    """3 decode steps fed the same tokens (JAX's argmax), the JAX step with
    its Pallas kernel in interpret mode. bf16: logits within 2e-2 of their
    largest magnitude (bf16 sums in another order) and the argmax equal
    where the JAX top-2 margin exceeds 5x that gap; int8 fp32: within 1e-4
    (a k/v value on a rounding boundary of quantize_kv may land one int8
    step apart). The stale inactive slot changes nothing: the pool after
    the steps equals JAX's, row 2 excepted, and equals a run whose stale
    row is zeroed."""
    monkeypatch.setenv("TOKENPACKER_PAGED_ATTN", "pallas")
    int8 = form.startswith("fp32")
    cfg, cfg_j = model["cfg"], model["cfg_j"]
    if int8:
        params, tree = model["int8"], model["int8_tree"]
    else:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.bfloat16)
        params = params_to(model["params"], "cpu", torch.bfloat16)
        tree = params_to_jax(params)
    jtree = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16 if not int8 and x.dtype == np.float32
                                               else None), tree)
    fields = _decode_case(cfg.lm, int8)
    if not int8:
        fields = (fields[0].astype(jnp.bfloat16), fields[1].astype(jnp.bfloat16), *fields[2:])
    jp = jax_paged_kv.PagedKV(*(None if x is None else jnp.asarray(x) for x in fields))
    tp = paged_from_jax(fields)
    clean = paged_from_jax(fields)
    clean.page_table[2] = 0
    active = np.array([True, True, False])
    toks = np.array([42, 99, 7], np.int32)
    for _ in range(3):
        jl, jp = jax_paged_kv.paged_decode_step(jtree, cfg_j, jp, jnp.asarray(toks),
                                                jnp.asarray(active))
        tl, tp = paged_kv.paged_decode_step(params, cfg, tp, torch.from_numpy(toks).long(),
                                            torch.from_numpy(active))
        cl, clean = paged_kv.paged_decode_step(params, cfg, clean, torch.from_numpy(toks).long(),
                                               torch.from_numpy(active))
        jl, tl = _np(jl)[:2], _np(tl)[:2]
        np.testing.assert_allclose(tl, _np(cl)[:2], atol=1e-6, rtol=1e-6)
        diff = np.abs(tl - jl).max()
        assert diff <= (1e-4 if int8 else 2e-2) * np.abs(jl).max(), diff
        top2 = np.sort(jl, axis=-1)[:, -2:]
        decisive = top2[:, 1] - top2[:, 0] > 5 * diff
        assert (tl.argmax(-1) == jl.argmax(-1))[decisive].all()
        toks = np.array([*jl.argmax(-1), 7], np.int32)
    assert np.array_equal(np.asarray(jp.lengths), tp.lengths.numpy())
    back = paged_to_jax(tp)
    for got, want in zip(back[:2], (jp.k_pages, jp.v_pages)):
        # the active slots' pages (the null page 0 takes the inactive writes)
        np.testing.assert_allclose(got[:, 1:7], np.asarray(want, np.float32)[:, 1:7],
                                   atol=1 if int8 else 5e-2, rtol=0)


# -- admission into the pool ---------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_insert_prefill_and_gather_prefix_match_jax(model, int8):
    """Bit-equal data movement: insert_prefill at block 0 and at a later
    block, map_blocks, map_page and gather_prefix against JAX's."""
    lm = model["cfg"].lm
    rng = np.random.default_rng(21)
    lead = (lm.num_hidden_layers,)
    pk, pv, pks, pvs = _pool(rng, 10, 4, lm.kv_heads, lm.head_dim, int8, lead)
    fields = (pk, pv, np.zeros((2, 6), np.int32), np.zeros(2, np.int32), pks, pvs)
    # a batch-1 prefilled cache [L, 1, 16, Hkv, d]
    small = _pool(rng, 1, 16, lm.kv_heads, lm.head_dim, int8, lead)
    jp = jax_paged_kv.PagedKV(*(None if x is None else jnp.asarray(x) for x in fields))
    tp = paged_from_jax(fields)
    jc = jax_llama.KVCache(jnp.asarray(small[0]), jnp.asarray(small[1]), jnp.asarray(0),
                           *(None if x is None else jnp.asarray(x) for x in small[2:]))
    tc = KVCache(*(None if x is None else torch.from_numpy(x) for x in small[:2]), 0,
                 *(None if x is None else torch.from_numpy(x) for x in small[2:]))
    jp = jax_paged_kv.insert_prefill(jp, jc, 0, [3, 7, 1, 9], 13)
    jp = jax_paged_kv.insert_prefill(jp, jc, 1, [2, 5], 14, first_block=2)
    jp = jax_paged_kv.map_blocks(jp, 1, 0, [3, 7])
    jp = jax_paged_kv.map_page(jp, 1, 4, 8)
    paged_kv.insert_prefill(tp, tc, 0, [3, 7, 1, 9], 13)
    paged_kv.insert_prefill(tp, tc, 1, [2, 5], 14, first_block=2)
    paged_kv.map_blocks(tp, 1, 0, [3, 7])
    paged_kv.map_page(tp, 1, 4, 8)
    for got, want in zip(paged_to_jax(tp), jp):
        if want is not None:
            assert np.array_equal(got, np.asarray(want))
    jg = jax_paged_kv.gather_prefix(jp, [3, 7, 1], 16)
    tg = paged_kv.gather_prefix(tp, [3, 7, 1], 16)
    assert tg.length == 0
    for got, want in zip((tg.k, tg.v, tg.k_scale, tg.v_scale), (jg.k, jg.v, jg.k_scale, jg.v_scale)):
        if want is not None:
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hkv", [4, 1])
def test_attention_bias_and_sdpa_match_jax(hkv):
    """make_attention_bias bit-equal to JAX's for queries at an offset over
    a partly valid cache; sdpa (grouped query heads) within 1e-5 of JAX's
    `_sdpa` (which repeats the kv heads), fp32."""
    from tokenpacker_tpu_torch.models.llama import make_attention_bias, sdpa

    rng = np.random.default_rng(hkv)
    positions = np.array([[5, 6, 7], [9, 10, 11]], np.int32)
    key_valid = np.arange(16)[None, :] < np.array([[8], [12]])
    want = np.asarray(jax_llama.make_attention_bias(jnp.asarray(positions),
                                                    jnp.asarray(key_valid), 0, 16))
    got = make_attention_bias(torch.from_numpy(positions), torch.from_numpy(key_valid))
    assert np.array_equal(got.numpy(), want)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, hkv, 16)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_llama._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(want)))
    out = sdpa(*(torch.from_numpy(x) for x in (q, k, v)), got)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def _chunk_inputs(model, cfg, l_pad, seed):
    """A request of 16 text tokens and one image (20 positions) padded to
    l_pad, its image and its projector output from each package."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    ids = np.concatenate([[1], 100 + np.arange(6), [IMAGE_TOKEN_INDEX],
                          30 + np.arange(9)]).astype(np.int64)
    plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, pad_to=l_pad)
    vis_j = jax_encode_images(model["int8_tree"], model["cfg_j"], jnp.asarray(images))
    vis_t = encode_images(model["int8"], cfg, torch.from_numpy(images))
    return plan, images, vis_j, vis_t


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_prefill_chunk_at_an_offset_matches_jax(model, cache):
    """Two chunks of 8 into a 24-row cache: [0, 8), then [8, 16), which
    attends the first chunk's rows through the cache (with the chunk's own
    rows already stored: quantized for an int8 cache, rounded for a bf16
    one). fp32 model, int8 fused weights. Hidden states within 1e-4 (the
    same arithmetic, sums in another order); the cache's rows equal (int8:
    within one step where a value sits on a rounding boundary)."""
    cfg, cfg_j = model["cfg"], model["cfg_j"]
    plan, _, vis_j, vis_t = _chunk_inputs(model, cfg, 24, 5)
    jdt, tdt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    jc = jax_llama.KVCache.create(cfg_j.lm, 1, 24, dtype=jdt)
    tc = KVCache.create(cfg.lm, 1, 24, dtype=tdt)
    for off in (0, 8):
        cols = slice(off, off + 8)
        jh, jc = jax_generate.prefill_chunk(
            model["int8_tree"], cfg_j, jc, vis_j, jnp.asarray(plan.token_ids[:, cols]),
            jnp.asarray(plan.is_image[:, cols]), jnp.asarray(plan.image_slot[:, cols]),
            jnp.asarray(off, jnp.int32), 8)
        th, tc = generate.prefill_chunk(
            model["int8"], cfg, tc, vis_t, torch.from_numpy(plan.token_ids[:, cols]),
            torch.from_numpy(plan.is_image[:, cols]), torch.from_numpy(plan.image_slot[:, cols]),
            off, 8, tdt)
        np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-4, rtol=1e-4)
    assert tc.length == int(jc.length) == 16
    np.testing.assert_allclose(_np(tc.k), _np(np.asarray(jc.k, np.float32)),
                               atol=1 if cache == "int8" else 1e-2, rtol=0)
    with pytest.raises(ValueError, match="cache holds"):
        generate.prefill_chunk(model["int8"], cfg, tc, vis_t, torch.zeros((1, 8), dtype=torch.long),
                               torch.zeros((1, 8), dtype=torch.bool),
                               torch.zeros((1, 8), dtype=torch.long), 16, 8)


@pytest.mark.parametrize("int8", [False, True])
def test_prefix_admit_matches_jax(model, int8, monkeypatch):
    """The pages of a cold prefill of a 20-position prompt (pages of 4) in
    slot 0; a warm admission into slot 1 maps the first 2 and prefills
    [8, 24) against them (`prefix_admit`). Logits within 1e-4, tables and
    lengths equal, the suffix pages equal (int8: within one step)."""
    if int8:
        monkeypatch.setenv("TOKENPACKER_KV_CACHE", "int8")
    cfg, cfg_j = model["cfg"], model["cfg_j"]
    plan, images, vis_j, vis_t = _chunk_inputs(model, cfg, 24, 6)
    dt = torch.int8 if int8 else torch.float32
    tp = paged_kv.PagedKV.create(cfg.lm, 16, 4, 2, 8, dt, "cpu")
    jp = jax_paged_kv.PagedKV(*(None if x is None else jnp.asarray(x) for x in paged_to_jax(tp)))
    # the cold admission's pages from one prefill of both packages
    jl, jc = jax_generate.prefill(model["int8_tree"], cfg_j,
                                  jax_generate.device_batch(
                                      {"token_ids": plan.token_ids, "is_image": plan.is_image,
                                       "image_slot": plan.image_slot, "lengths": plan.lengths,
                                       "images": images}, jnp.float32), 24)
    tc = KVCache(*(torch.from_numpy(np.array(x)) for x in (jc.k, jc.v)), 0,
                 *(None if x is None else torch.from_numpy(np.array(x))
                   for x in (jc.k_scale, jc.v_scale)))
    jp = jax_paged_kv.insert_prefill(jp, jc, 0, [1, 2, 3, 4, 5, 6], 20)
    paged_kv.insert_prefill(tp, tc, 0, [1, 2, 3, 4, 5, 6], 20)

    cols = slice(8, 24)
    jlog, jp = jax_paged_kv.prefix_admit(
        jp, model["int8_tree"], cfg_j, jnp.asarray([1, 2], jnp.int32),
        jnp.asarray([7, 8, 9, 10], jnp.int32), vis_j, jnp.asarray(plan.token_ids[:, cols]),
        jnp.asarray(plan.is_image[:, cols]), jnp.asarray(plan.image_slot[:, cols]),
        jnp.asarray(1, jnp.int32), jnp.asarray(20, jnp.int32), 2, 16)
    tlog, tp = paged_kv.prefix_admit(
        tp, model["int8"], cfg, [1, 2], [7, 8, 9, 10], vis_t,
        torch.from_numpy(plan.token_ids[:, cols]), torch.from_numpy(plan.is_image[:, cols]),
        torch.from_numpy(plan.image_slot[:, cols]), 1, 20, 2, 16)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    back = paged_to_jax(tp)
    assert np.array_equal(back[2], np.asarray(jp.page_table))
    assert np.array_equal(back[3], np.asarray(jp.lengths))
    np.testing.assert_allclose(back[0][:, 7:11], np.asarray(jp.k_pages, np.float32)[:, 7:11],
                               atol=1 if int8 else 1e-4, rtol=0)


# -- the prefix cache (the JAX cases of tests/test_prefix_cache.py) -----------

IMPLS = {"jax": (jax_prefix_cache, jax_paged_kv.PageAllocator),
         "port": (prefix_cache, paged_kv.PageAllocator)}


@pytest.mark.parametrize("impl", IMPLS)
def test_block_hashes_chain_and_image_identity(impl):
    pc_mod = IMPLS[impl][0]
    ids = np.arange(16)
    im = np.zeros(16, bool)
    im[4:8] = True
    slots = np.zeros(16, np.int32)
    a = pc_mod.block_hashes(ids, im, slots, b"imgA", page_size=4)
    assert len(a) == 4
    assert a == jax_prefix_cache.block_hashes(ids, im, slots, b"imgA", page_size=4)
    ids2 = ids.copy()
    ids2[1] = 99
    b = pc_mod.block_hashes(ids2, im, slots, b"imgA", page_size=4)
    assert all(x != y for x, y in zip(a, b))
    c = pc_mod.block_hashes(ids, im, slots, b"imgB", page_size=4)
    assert c[0] == a[0]
    assert all(x != y for x, y in zip(a[1:], c[1:]))
    assert pc_mod.block_hashes(ids, im, slots, b"imgA", 4, limit=2) == a[:2]
    img = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
    assert pc_mod.image_digest(img) == jax_prefix_cache.image_digest(img)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefix_cache_match_is_longest_chain(impl):
    pc_mod, alloc_cls = IMPLS[impl]
    pc = pc_mod.PrefixCache(page_size=4)
    alloc = alloc_cls(8)
    pages = alloc.alloc(3)
    pc.register([b"h0", b"h1", b"h2"], pages, alloc)
    m, ids = pc.match([b"h0", b"h1", b"XX"])
    assert m == 2 and ids == pages[:2]
    m, ids = pc.match([b"XX", b"h1"])
    assert m == 0 and ids == []
    assert pc.stats() == {"prefix_cache_blocks": 3, "prefix_cache_hits": 1,
                          "prefix_cache_misses": 1, "prefix_tokens_reused": 0,
                          "prefix_vision_encodes_skipped": 0}


@pytest.mark.parametrize("impl", IMPLS)
def test_refcounts_cache_plus_slot_claims(impl):
    pc_mod, alloc_cls = IMPLS[impl]
    alloc = alloc_cls(8)
    pc = pc_mod.PrefixCache(page_size=4)
    (pid,) = alloc.alloc(1)
    pc.register([b"h"], [pid], alloc)
    alloc.incref(pid)
    alloc.release([pid])
    assert pid not in alloc.free
    pc.evict_until_available(alloc, alloc.available() + 1)
    assert pid not in alloc.free
    alloc.release([pid])
    assert pid in alloc.free
    with pytest.raises(RuntimeError, match="double free"):
        alloc.release([pid])


@pytest.mark.parametrize("impl", IMPLS)
def test_eviction_frees_lru_first(impl):
    pc_mod, alloc_cls = IMPLS[impl]
    alloc = alloc_cls(8)
    pc = pc_mod.PrefixCache(page_size=4)
    p = alloc.alloc(4)
    pc.register([b"a", b"b", b"c", b"d"], p, alloc)
    [alloc.release([x]) for x in p]
    pc.match([b"a"])
    pc.evict_until_available(alloc, alloc.available() + 2)
    assert p[1] in alloc.free and p[2] in alloc.free
    assert p[0] not in alloc.free and p[3] not in alloc.free


# -- the batcher as a whole ----------------------------------------------------


def _request(cfg, seed, extra_len=0, pad_to=32, hd=False):
    """One image (or an HD 2x2 grid plus its global view) and a short
    prompt, as the JAX scheduler tests make them."""
    rng = np.random.default_rng(seed)
    blocks = (2, 2) if hd else (1, 1)
    views = blocks[0] * blocks[1] + (1 if hd else 0)
    images = rng.standard_normal((views, 56, 56, 3)).astype(np.float32)
    ids = np.concatenate([[1, 17 + seed], [IMAGE_TOKEN_INDEX],
                          30 + np.arange(2 + extra_len)]).astype(np.int64)
    plan = build_splice_plan([ids], [[blocks]], cfg.tokens_per_view, "slice" if hd else "single",
                             SEP, NEWLINE, 0, pad_to=pad_to)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}


def _text_request(prompt):
    ids = np.asarray(prompt, np.int64)[None]
    return {"token_ids": ids, "is_image": np.zeros_like(ids, bool),
            "image_slot": np.zeros_like(ids, np.int32), "lengths": np.array([ids.shape[1]]),
            "images": None}


# cold admissions of 3 plain requests, an HD slice request and one whose
# page pad is not a multiple of the cache tile (pad 12 with pages of 4)
MIXED = dict(num_slots=2, num_pages=64, page_size=4, max_pages_per_seq=24)
MAX_NEW = 5


@pytest.fixture(scope="module")
def mixed_requests(model):
    cfg = model["cfg"]
    return ([_request(cfg, s, extra_len=3 * s) for s in range(3)]
            + [_request(cfg, 4, pad_to=64, hd=True), _request(cfg, 5, pad_to=12)])


@pytest.fixture(scope="module")
def jax_mixed(model, mixed_requests):
    """The JAX batcher's greedy tokens for the mixed requests (int8 fused
    weights, fp32 pool)."""
    batcher = JaxBatcher(model["int8_tree"], model["cfg_j"], **MIXED)
    batcher.start()
    try:
        futs = [batcher.submit(r, MAX_NEW, temperature=0.0) for r in mixed_requests]
        return [f.result(timeout=600) for f in futs]
    finally:
        batcher.stop()


def _serve(params, cfg, requests, max_new=MAX_NEW, **kw):
    batcher = PagedContinuousBatcher(params, cfg, device="cpu", **{**MIXED, **kw})
    free0 = batcher.allocator.available()
    batcher.start()
    try:
        futs = [batcher.submit(r, max_new) for r in requests]
        got = [f.result(timeout=300) for f in futs]
    finally:
        batcher.stop()
    retained = len(batcher.prefix.blocks) if batcher.prefix is not None else 0
    assert batcher.allocator.available() == free0 - retained  # nothing leaked
    return got, batcher


@pytest.mark.parametrize("mode", ["cold", "chunked", "chunked, no prefix cache"])
def test_batcher_matches_generator_and_jax(model, mixed_requests, jax_mixed, mode):
    """Greedy tokens of every request equal the port's Generator's (one
    request at a time) and the JAX PagedContinuousBatcher's, fp32 with int8
    fused weights: cold admissions through `prefill`, chunked ones (chunks
    of 8) through `prefill_chunk`, with and without the prefix cache."""
    cfg, params = model["cfg"], model["int8"]
    gen = generate.Generator(params, cfg)
    want = [gen.generate(r, max_new_tokens=MAX_NEW).sequences[0] for r in mixed_requests]
    kw = {"cold": {}, "chunked": {"prefill_chunk_size": 8},
          "chunked, no prefix cache": {"prefill_chunk_size": 8, "prefix_cache": False}}[mode]
    got, batcher = _serve(params, cfg, mixed_requests, **kw)
    assert got == want
    assert got == jax_mixed
    assert batcher.stats["decode_steps"] >= MAX_NEW - 1 and batcher.stats["pages_peak"] > 0


def test_batcher_int8_pool_matches_generator(model, mixed_requests):
    """An int8 pool against the Generator's int8 cache, cold admissions
    (both prefill through K2 over the unquantized prompt and store the same
    quantized rows); decode attention folds the scales (K5) or dequantizes
    (the per-layer path): fp32 sums in another order, greedy tokens
    equal."""
    cfg, params = model["cfg"], model["int8"]
    gen = generate.Generator(params, cfg, kv_cache_dtype=torch.int8)
    want = [gen.generate(r, max_new_tokens=MAX_NEW).sequences[0] for r in mixed_requests[:3]]
    got, _ = _serve(params, cfg, mixed_requests[:3], kv_cache_dtype=torch.int8)
    assert got == want


def _serving_scenario(make):
    """The JAX package's serving dry run (`__graft_entry__`'s
    _dryrun_tp_serving_batcher), single-device: a cold admission, a warm
    one of the same prompt (prefix-cache hit), then a request cancelled
    after 2 streamed tokens beside a live one; pages leaked once the
    slots drain. Returns (cold, warm, cancelled, other, reused, leaked)."""
    p1, p2 = list(range(2, 10)), list(range(3, 15))
    batcher = make()
    free0 = batcher.allocator.available()
    batcher.start()
    try:
        cold = batcher.submit(_text_request(p1), max_new_tokens=6).result(timeout=600)
        warm = batcher.submit(_text_request(p1), max_new_tokens=6).result(timeout=600)
        reused = batcher.prefix.tokens_reused
        q: queue.Queue = queue.Queue()
        fut_c = batcher.submit(_text_request(p2), max_new_tokens=64, on_token=q.put)
        fut_d = batcher.submit(_text_request(p1), max_new_tokens=6)
        for _ in range(2):
            q.get(timeout=600)
        batcher.cancel(fut_c)
        cancelled = fut_c.result(timeout=600)
        other = fut_d.result(timeout=600)
        deadline = time.time() + 60
        while (batcher.allocator.available() != free0 - len(batcher.prefix.blocks)
               and time.time() < deadline):
            time.sleep(0.05)
        leaked = free0 - len(batcher.prefix.blocks) - batcher.allocator.available()
    finally:
        batcher.stop()
    return cold, warm, cancelled, other, reused, leaked


def test_serving_dry_run_scenario_matches_jax(model):
    """The dry run's checks on the port: warm == cold, tokens_reused > 0,
    the cancelled stream a prefix of JAX's (at least 2 tokens) and shorter
    than its 64, the live request equal, 0 leaked pages; tokens equal to
    the JAX batcher's on the same int8 fused weights."""
    kw = dict(num_slots=2, num_pages=64, page_size=4, max_pages_per_seq=16, prefix_cache=True,
              prefill_chunk_size=8)
    ref = _serving_scenario(lambda: JaxBatcher(model["int8_tree"], model["cfg_j"], **kw))
    got = _serving_scenario(lambda: PagedContinuousBatcher(model["int8"], model["cfg"],
                                                           device="cpu", **kw))
    assert got[0] == ref[0]
    assert got[1] == got[0] == ref[1]
    assert got[3] == ref[3]
    n = min(len(got[2]), len(ref[2]))
    assert 2 <= n and got[2][:n] == ref[2][:n] and len(got[2]) < 64
    assert got[4] > 0 and got[4] == ref[4]
    assert got[5] == 0 == ref[5]


def test_warm_hd_request_skips_the_vision_encode(model):
    """A repeated HD request maps its cached blocks (every image token
    among them), skips the tower and the projector, and gives the cold
    request's tokens."""
    cfg, params = model["cfg"], model["int8"]
    req = _request(cfg, 4, pad_to=64, hd=True)
    batcher = PagedContinuousBatcher(params, cfg, device="cpu", **{**MIXED, "num_slots": 1})
    batcher.start()
    try:
        cold = batcher.submit(req, MAX_NEW).result(timeout=300)
        warm = batcher.submit(req, MAX_NEW).result(timeout=300)
    finally:
        batcher.stop()
    stats = batcher.prefix.stats()
    assert warm == cold
    assert stats["prefix_cache_hits"] == 1 and stats["prefix_vision_encodes_skipped"] == 1
    assert stats["prefix_tokens_reused"] > 0


@pytest.mark.parametrize("fails,chunk", [("prefill", None), ("prefill_chunk", 8),
                                         ("paged_decode_step", None)])
def test_batcher_crash_fails_every_future(model, monkeypatch, fails, chunk):
    """Crash net: a failing admission (prefill, a prefill chunk) or decode
    step fails every in-flight and queued future with "batcher loop died",
    and later submits fail at once."""
    cfg, params = model["cfg"], model["int8"]

    def boom(*a, **k):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(sched, fails, boom)
    batcher = PagedContinuousBatcher(params, cfg, device="cpu", prefill_chunk_size=chunk, **MIXED)
    batcher.start()
    try:
        futs = [batcher.submit(_request(cfg, s), 4) for s in range(3)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="batcher loop died"):
                fut.result(timeout=60)
        late = batcher.submit(_request(cfg, 3), 4)
        with pytest.raises(RuntimeError, match="batcher loop died"):
            late.result(timeout=5)
    finally:
        batcher.stop()


@pytest.mark.parametrize("option", [
    dict(temperature=0.7), dict(top_p=0.9), dict(top_k=5), dict(min_p=0.1), dict(seed=3),
    dict(adapter="a"), dict(repetition_penalty=1.2), dict(presence_penalty=0.5),
    dict(frequency_penalty=0.5), dict(logprobs=2),
])
def test_unported_submit_options_raise_at_submit(model, option):
    """submit's options, refused with NotImplementedError until sampling
    was ported, are now taken and served (tests/test_torch_sampling.py
    holds them against the JAX batcher): the request gets its 4 tokens,
    and with logprobs an entry a token. An adapter with none loaded is
    refused at submit, as the JAX batcher refuses it: the future it
    returns already holds the KeyError, and nothing is queued."""
    cfg, params = model["cfg"], model["int8"]
    batcher = PagedContinuousBatcher(params, cfg, device="cpu", **MIXED)
    if "adapter" in option:
        fut = batcher.submit(_request(cfg, 0), 4, **option)
        assert fut.done() and isinstance(fut.exception(), KeyError)
        assert "no LoRA adapters" in str(fut.exception())
        assert batcher.queue.empty()
        return
    batcher.start()
    try:
        fut = batcher.submit(_request(cfg, 0), 4, **option)
        tokens = fut.result(timeout=120)
    finally:
        batcher.stop()
    assert len(tokens) == 4 and all(0 <= t < cfg.lm.vocab_size for t in tokens)
    assert len(fut._tp_request.lp_entries) == (4 if "logprobs" in option else 0)


def test_prompt_longer_than_the_page_budget_is_refused_at_submit(model):
    """A prompt whose pad needs more than max_pages_per_seq pages raises at
    submit (the JAX batcher asserts inside its loop, which then fails
    every request); the batcher goes on serving."""
    cfg, params = model["cfg"], model["int8"]
    batcher = PagedContinuousBatcher(params, cfg, device="cpu",
                                     **{**MIXED, "max_pages_per_seq": 8})  # 32 positions
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        batcher.submit(_request(cfg, 0, pad_to=40), 4)
    batcher.start()
    try:
        assert len(batcher.submit(_request(cfg, 0), 4).result(timeout=120)) == 4
    finally:
        batcher.stop()


@pytest.mark.parametrize("option", [dict(temperature=0.7), dict(temperature=0.7, speculative_k=2),
                                    dict(temperature=0.7, adapters={"a": Adapter({}, 2)})])
def test_unported_batcher_options_raise_when_made(model, option):
    """A batcher made with temperature > 0 (beside speculation or adapters),
    refused until sampling was ported, is made, and its temperature is
    the default of the requests that give none."""
    batcher = PagedContinuousBatcher(model["int8"], model["cfg"], device="cpu", **MIXED, **option)
    batcher.submit(_request(model["cfg"], 0), 4)
    batcher.submit(_request(model["cfg"], 0), 4, temperature=0.0)
    assert [batcher.queue.get_nowait().temperature for _ in range(2)] == [0.7, 0.0]


def test_batcher_refuses_params_on_another_device(model):
    with pytest.raises(ValueError, match="params are on cpu"):
        PagedContinuousBatcher(model["int8"], model["cfg"], **MIXED)  # device="cuda"
