"""Speculative serving of the port against the JAX package on the CPU, at the
tiny geometry on the same seeded weights and numpy inputs: K4's verify
form (its plain version against `fused_verify_hidden(interpret=True)`),
the verify steps against T decode steps, the prompt-lookup proposers,
`Generator.generate(speculative=k)`, the dense `ContinuousBatcher`
(plain, chunked, speculative, backed off, cancelled) and the paged
batcher with `speculative_k`.

The bar is greedy parity: with speculation on, every request's tokens
are exactly plain decoding's, and equal to the JAX engine's. A rigged
"repeater" LM (attention and MLP outputs zeroed, the head tied to the
embedding, so it predicts its input token) makes every draft land, to
show that drafts are accepted. Every tolerance is stated where it is
used.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu import speculative as jax_spec
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.ops import fused_decode as jax_fd
from tokenpacker_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher
from tokenpacker_tpu_torch import generate, speculative
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_to,
    params_to_jax,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.ops import fused_decode
from tokenpacker_tpu_torch.serve import scheduler as sched
from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher, PagedContinuousBatcher
from test_torch_fused_decode import HIDDEN_RTOL, PRE, ROW_ATOL, B, S, LENGTHS, _int8_trees
from test_torch_fused_decode import _jax_prefill_cache, _to_torch

SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary
K = 3  # draft length
# fp32 logits, the same function in another order: the JAX package's bound
# for verify against decode steps (tests/test_speculative.py)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def model():
    """Seeded tiny fp32 weights in both packages; their int8 fused form (K4
    serves its steps, the plain version on the CPU); the repeater."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=9, device="cpu", dtype=torch.float32)
    int8 = quantize_lm_int8(params_to(params, "cpu", torch.float32), min_size=1)
    rep = params_to(params, "cpu", torch.float32)
    for layer in rep["lm"]["layers"]:
        layer["attn"]["o"]["kernel"].zero_()
        layer["mlp"]["down"]["kernel"].zero_()
    rep["lm"]["lm_head"]["kernel"] = rep["lm"]["embed"].T.contiguous()
    return {"cfg": cfg, "cfg_j": jax_tiny_config(), "params": params,
            "tree": params_to_jax(params), "int8": int8, "int8_tree": params_to_jax(int8),
            "repeater": rep}


def _request(cfg, seed, extra=0, pad_to=32, repeat=False):
    """One image and a short prompt; `repeat` gives it a repeated run of
    text, so that prompt lookup finds drafts."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    text = [40, 41, 42, 40, 41, 42, 40, 41] if repeat else list(30 + np.arange(2 + extra))
    ids = np.array([1, 17 + seed, IMAGE_TOKEN_INDEX, *text], np.int64)
    plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, "single", SEP, NEWLINE, 0,
                             pad_to=pad_to)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}


# -- K4's verify form ---------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return _int8_trees()


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_plain_k4_verify_matches_jax_interpret(trees, cache_dtype):
    """T = 3 fed tokens at decode step 2 over the JAX test's prefilled
    cache (D=512, 2 layers, B=2, S=64), bf16: the hidden states within
    the JAX test's bound of K4 (2e-2 of max|hidden|), the written rows
    within 0.05 after dequantization, the rows outside equal."""
    cfg_j, cfg, tree, port = trees
    int8 = cache_dtype == "int8"
    jcache = _jax_prefill_cache(tree, cfg_j, jnp.int8 if int8 else jnp.bfloat16)
    cache = KVCache(_to_torch(jcache.k), _to_torch(jcache.v), PRE,
                    _to_torch(jcache.k_scale) if int8 else None,
                    _to_torch(jcache.v_scale) if int8 else None)
    t, step = 3, 2
    emb = (0.1 * np.random.default_rng(4).standard_normal((B, t, cfg.hidden_size))).astype(
        np.float32)
    pos = (LENGTHS[:, None] + step + np.arange(t)).astype(np.int32)
    wpos0 = np.full((B,), PRE + step, np.int32)
    start2 = np.full((B,), PRE, np.int32)
    out = jax_fd.fused_verify_hidden(
        tree, cfg_j, jnp.asarray(emb, jnp.bfloat16), jcache.k, jcache.v, jnp.asarray(LENGTHS),
        jnp.asarray(start2), jnp.asarray(wpos0), jnp.asarray(wpos0), jnp.asarray(pos),
        interpret=True, k_scale=jcache.k_scale, v_scale=jcache.v_scale)
    k_before = cache.k.clone()
    got, k_new, _ = fused_decode.fused_verify_hidden(
        port, cfg, torch.from_numpy(emb).bfloat16(), cache.k, cache.v, torch.from_numpy(LENGTHS),
        torch.from_numpy(start2), torch.from_numpy(wpos0), torch.from_numpy(wpos0),
        torch.from_numpy(pos), k_scale=cache.k_scale, v_scale=cache.v_scale)
    want = np.asarray(out[0], np.float32)
    assert got.shape == (B, t, cfg.hidden_size) and k_new.shape[1:3] == (B, t)
    assert np.abs(got.float().numpy() - want).max() <= HIDDEN_RTOL * np.abs(want).max()
    cols = PRE + step + np.arange(t)
    jk = np.asarray(out[1])
    for i in range(B):
        new, jnew = cache.k[:, i, cols], _to_torch(jk[:, i, cols])
        if int8:
            new = fused_decode.dequantize_kv(new, cache.k_scale[:, i, cols], torch.float32)
            jnew = fused_decode.dequantize_kv(jnew, _to_torch(np.asarray(out[3])[:, i, cols]),
                                              torch.float32)
        assert (new.float() - jnew.float()).abs().max() < ROW_ATOL
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[cols] = False
    assert torch.equal(cache.k[:, :, untouched], k_before[:, :, untouched])


def test_k4_verify_at_t_equal_1_is_the_decode_step(trees):
    """T = 1 through the verify entry gives K4's one-token bits."""
    _, cfg, _, port = trees
    g = torch.Generator().manual_seed(2)
    caches = [KVCache.create(cfg, B, S, dtype=torch.int8) for _ in range(2)]
    caches[0].k.copy_(torch.randint(-127, 128, caches[0].k.shape, generator=g))
    caches[0].v.copy_(torch.randint(-127, 128, caches[0].v.shape, generator=g))
    caches[0].k_scale.fill_(0.01)
    caches[0].v_scale.fill_(0.02)
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(caches[1], name).copy_(getattr(caches[0], name))
    h0 = (0.1 * torch.randn((B, cfg.hidden_size), generator=g)).bfloat16()
    lengths, start2 = torch.from_numpy(LENGTHS), torch.full((B,), PRE, dtype=torch.int32)
    end2 = start2 + 1
    a = fused_decode.fused_decode_hidden(port, cfg, h0, caches[0].k, caches[0].v, lengths,
                                         start2, end2, end2, lengths + 1,
                                         k_scale=caches[0].k_scale, v_scale=caches[0].v_scale)
    b = fused_decode.fused_verify_hidden(port, cfg, h0[:, None], caches[1].k, caches[1].v,
                                         lengths, start2, end2, end2, (lengths + 1)[:, None],
                                         k_scale=caches[1].k_scale, v_scale=caches[1].v_scale)
    assert torch.equal(a[0], b[0][:, 0]) and torch.equal(a[1], b[1][:, :, 0])
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].k_scale,
                                                                 caches[1].k_scale)


# -- verify steps against decode steps ------------------------------------------


@pytest.mark.parametrize("tree", ["params", "int8"])
def test_verify_step_matches_decode_steps(model, tree):
    """verify_step's logits[:, j] equal the j'th of T decode steps fed the
    same tokens, and both write the same rows; the per-layer path (fp32
    tree) and K4 (int8 tree, its plain version here)."""
    cfg, params = model["cfg"], model[tree]
    batch = _request(cfg, 1, extra=4)
    l, t = batch["token_ids"].shape[1], 4
    dev = generate.device_batch(batch, cfg.dtype, "cpu")
    logits0, cache = generate.prefill(params, cfg, dev, l + 8)
    vcache = KVCache(cache.k.clone(), cache.v.clone(), cache.length)
    toks, step_logits = [int(logits0[0].argmax())], []
    for s in range(t):
        lg, cache = generate.decode_step(params, cfg, cache, torch.tensor([toks[-1]]),
                                         dev["lengths"], s, l)
        step_logits.append(lg[0])
        toks.append(int(lg[0].argmax()))
    vlogits, vcache = speculative.verify_step(params, cfg, vcache, torch.tensor([toks[:t]]),
                                              dev["lengths"], 0, l)
    for j in range(t):
        np.testing.assert_allclose(vlogits[0, j].numpy(), step_logits[j].numpy(), **STEP_TOL)
    np.testing.assert_allclose(vcache.k[:, :, :l + t].numpy(), cache.k[:, :, :l + t].numpy(),
                               atol=1e-5)
    assert vcache.length == l + t


@pytest.mark.parametrize("tree", ["params", "int8"])
def test_verify_step_cb_matches_decode_steps_cb(model, tree):
    """Two slots at different lengths: verify_step_cb's logits equal T
    decode_step_cb calls fed the same tokens, for every slot."""
    cfg, params = model["cfg"], model[tree]
    batch = _request(cfg, 2, extra=3)
    l = batch["token_ids"].shape[1]
    logits, small = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"),
                                     l)
    true_len, t = int(batch["lengths"][0]), 4
    big = KVCache.create(cfg.lm, 2, 64, dtype=cfg.dtype)
    generate.insert_into_cache(big, small, 0)
    generate.insert_into_cache(big, small, 1)
    cur = torch.tensor([true_len, true_len + 1], dtype=torch.int32)  # slot 1 one step ahead
    tok0 = int(logits[0].argmax())
    vbig = KVCache(big.k.clone(), big.v.clone(), 0)
    active = torch.ones(2, dtype=torch.bool)
    fed, step_logits = [[tok0], [tok0 + 1]], []
    lens = cur.clone()
    for _ in range(t):
        lg, big = generate.decode_step_cb(params, cfg, big, torch.tensor([f[-1] for f in fed]),
                                          lens, active)
        lens = big.length
        step_logits.append(lg)
        for i in range(2):
            fed[i].append(int(lg[i].argmax()))
    vlogits, vbig = speculative.verify_step_cb(params, cfg, vbig,
                                               torch.tensor([f[:t] for f in fed]), cur)
    assert torch.equal(vbig.length, cur)
    for j in range(t):
        np.testing.assert_allclose(vlogits[:, j].numpy(), step_logits[j].numpy(), **STEP_TOL)


def test_insert_into_cache_checks_the_storage(model):
    cfg = model["cfg"]
    big = KVCache.create(cfg.lm, 2, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype mismatch"):
        generate.insert_into_cache(big, KVCache.create(cfg.lm, 1, 8, dtype=torch.int8), 0)
    wide = KVCache.create(cfg.lm, 1, 24, dtype=torch.float32)
    wide.k.fill_(1.0)
    generate.insert_into_cache(big, wide, 1)  # clamped to the shared cache's 16 rows
    assert big.k[:, 1].eq(1).all() and big.k[:, 0].eq(0).all()


# -- the proposers ---------------------------------------------------------------


def test_proposers_match_jax():
    """Host and device prompt lookup against JAX's device proposer: fixed
    cases (several earlier matches: the earliest wins; none; too short)
    and 25 random sequences over a 4-token alphabet."""
    rng = np.random.default_rng(0)
    cases = [([5, 6, 7, 8, 5, 6], 3), ([1, 2, 3, 1, 2], 3), ([9, 4, 9, 4, 9, 4], 3),
             ([3, 3, 3, 3, 3], 4), ([1, 2, 3, 4, 5], 3), ([1, 2], 2)]
    cases += [(rng.integers(0, 4, int(rng.integers(3, 28))).tolist(), int(rng.integers(1, 5)))
              for _ in range(25)]
    for seq, k in cases:
        ctx = np.full(40, -1, np.int32)
        ctx[:len(seq)] = seq
        jdraft, jdk = jax_spec._propose_ngram(jnp.asarray(ctx), jnp.asarray(len(seq)), k, 2)
        want = list(np.asarray(jdraft)[:int(jdk)])
        draft, dk = speculative.propose_ngram(torch.from_numpy(ctx), len(seq), k, 2)
        assert draft.tolist()[:dk] == want and dk == int(jdk), (seq, k)
        assert speculative.propose_ngram_host(list(seq), k, 2) == want
        assert jax_spec.propose_ngram_host(list(seq), k, 2) == want


def test_make_ctx_and_accept_greedy_match_jax():
    ids = np.array([1, 5, -200, -200, 7, 8, 0, 0])
    im = np.array([0, 0, 1, 1, 0, 0, 0, 0], bool)
    np.testing.assert_array_equal(speculative.make_ctx(ids, im, 6, 12),
                                  jax_spec.make_ctx(ids, im, 6, 12))
    for preds, draft, dk in (([4, 5, 6, 7], [4, 5, 9], 3), ([4, 2, 6, 7], [4, 2, 6], 3),
                             ([2, 5, 6, 7], [4, 5, 6], 3), ([4, 5, 6, 7], [4, 5, 6], 1)):
        for eos in (2, 5):
            assert (speculative.accept_greedy(preds, draft, dk, eos)
                    == jax_spec.accept_greedy(np.array(preds), np.array(draft), dk, eos))


# -- generation ------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["params", "int8"])
def test_generate_speculative_matches_plain_and_jax(model, tree):
    """Greedy tokens with speculation equal plain decoding's and the JAX
    engine's (per-layer verify on the fp32 tree, K4's verify form on the
    int8 one)."""
    cfg, params = model["cfg"], model[tree]
    batch = _request(cfg, 3, repeat=True)
    gen = generate.Generator(params, cfg)
    plain = gen.generate(batch, max_new_tokens=12)
    spec = gen.generate(batch, max_new_tokens=12, speculative=K)
    jax_tree = model[{"params": "tree", "int8": "int8_tree"}[tree]]
    want = jax_generate.Generator(jax_tree, model["cfg_j"]).generate(batch, max_new_tokens=12)
    assert spec.sequences == plain.sequences == want.sequences
    assert spec.stats["verify_rounds"] > 0 and spec.stats["decode_steps"] == 0


def test_repeater_accepts_drafts(model):
    """On the repeater every draft lands: the chunk emits more tokens than
    it runs rounds, and they are plain decoding's."""
    cfg, params = model["cfg"], model["repeater"]
    batch = _request(cfg, 4)
    gen = generate.Generator(params, cfg)
    plain = gen.generate(batch, max_new_tokens=20)
    spec = gen.generate(batch, max_new_tokens=20, speculative=4)
    assert spec.sequences == plain.sequences
    assert len(set(plain.sequences[0])) == 1  # it really repeats
    assert spec.stats["verify_rounds"] * 2 < 20


# -- the dense continuous batcher -------------------------------------------------

MAX_NEW = 6


@pytest.fixture(scope="module")
def requests(model):
    cfg = model["cfg"]
    return [_request(cfg, 0, repeat=True), _request(cfg, 1, extra=3), _request(cfg, 2, extra=6)]


@pytest.fixture(scope="module")
def jax_tokens(model, requests):
    """The JAX dense batcher's greedy tokens (int8 fused weights)."""
    batcher = JaxBatcher(model["int8_tree"], model["cfg_j"], num_slots=2, max_seq_len=64)
    batcher.start()
    try:
        return [f.result(timeout=600) for f in
                [batcher.submit(r, MAX_NEW, temperature=0.0) for r in requests]]
    finally:
        batcher.stop()


def _serve(params, cfg, requests, cls=ContinuousBatcher, max_new=MAX_NEW, **kw):
    batcher = cls(params, cfg, device="cpu", num_slots=2, **kw)
    batcher.start()
    try:
        return [f.result(timeout=300) for f in
                [batcher.submit(r, max_new) for r in requests]], batcher
    finally:
        batcher.stop()


@pytest.mark.parametrize("mode", ["plain", "chunked", "speculative", "chunked speculative"])
def test_dense_batcher_matches_jax(model, requests, jax_tokens, mode):
    """Greedy tokens of 3 requests through 2 slots (a mid-flight admission)
    equal the JAX batcher's: whole-prompt and chunked (chunks of 8)
    admissions, plain steps (K4 on the int8 tree) and verify rounds (K4's
    verify form)."""
    kw = {"plain": {}, "chunked": {"prefill_chunk_size": 8}, "speculative": {"speculative_k": K},
          "chunked speculative": {"prefill_chunk_size": 8, "speculative_k": K}}[mode]
    got, batcher = _serve(model["int8"], model["cfg"], requests, max_seq_len=64, **kw)
    assert got == jax_tokens
    if "speculative" in mode:
        assert batcher.stats["verify_rounds"] > 0
    else:
        assert batcher.stats["decode_steps"] >= MAX_NEW - 1


def test_dense_batcher_per_layer_path_matches_jax(model, requests):
    """The fp32 tree (per-layer steps and verify rounds) against the JAX
    batcher on the same tree."""
    batcher = JaxBatcher(model["tree"], model["cfg_j"], num_slots=2, max_seq_len=64,
                         speculative_k=K)
    batcher.start()
    try:
        want = [f.result(timeout=600) for f in [batcher.submit(r, MAX_NEW, temperature=0.0)
                                                for r in requests]]
    finally:
        batcher.stop()
    got, _ = _serve(model["params"], model["cfg"], requests, max_seq_len=64, speculative_k=K)
    assert got == want


def test_dense_batcher_repeater_accepts_drafts(model):
    cfg, params = model["cfg"], model["repeater"]
    reqs = [_request(cfg, 5), _request(cfg, 6, extra=2)]
    want = [generate.Generator(params, cfg).generate(r, max_new_tokens=16).sequences[0]
            for r in reqs]
    got, batcher = _serve(params, cfg, reqs, max_new=16, max_seq_len=64, speculative_k=4)
    assert got == want
    assert batcher.stats["verify_tokens"] > 1.5 * batcher.stats["verify_rounds"]


def test_dense_batcher_backs_off_when_no_draft_lands(model, requests, monkeypatch):
    """Drafts that never match: the accepted-draft EMA (0.9^r from 1.0)
    falls below SPEC_EMA_THRESHOLD after 19 rounds, then the batcher runs
    plain steps (up to SPEC_BACKOFF_ROUNDS of them; the 10 the request has
    left) and the tokens stay plain decoding's."""
    monkeypatch.setattr(sched, "propose_ngram_host", lambda ctx, k: [-1] * k)
    cfg, params = model["cfg"], model["params"]
    want = generate.Generator(params, cfg).generate(requests[1], max_new_tokens=30).sequences
    got, batcher = _serve(params, cfg, requests[1:2], max_new=30, max_seq_len=96,
                          speculative_k=K)
    assert got == want
    assert batcher.stats["verify_rounds"] == 19 and batcher.stats["decode_steps"] == 10
    assert batcher.stats["verify_tokens"] == 19  # one token a round, no draft


def test_dense_batcher_cancel_and_stop_rule(model, requests):
    """A request cancelled after 2 streamed tokens resolves with a prefix of
    its tokens while another is served in full; a request runs until its
    next round could pass max_seq_len."""
    import queue

    cfg, params = model["cfg"], model["int8"]
    full, _ = _serve(params, cfg, requests[:1], max_new=20, max_seq_len=64, speculative_k=K)
    batcher = ContinuousBatcher(params, cfg, device="cpu", num_slots=2, max_seq_len=64,
                                speculative_k=K)
    batcher.start()
    try:
        q: queue.Queue = queue.Queue()
        fut = batcher.submit(requests[0], max_new_tokens=20, on_token=q.put)
        other = batcher.submit(requests[1], max_new_tokens=MAX_NEW)
        for _ in range(2):
            q.get(timeout=300)
        batcher.cancel(fut)
        cancelled = fut.result(timeout=300)
        assert len(other.result(timeout=300)) == MAX_NEW
        short = batcher.submit(requests[2], max_new_tokens=200).result(timeout=300)
    finally:
        batcher.stop()
    assert 2 <= len(cancelled) < 20 and cancelled == full[0][:len(cancelled)]
    # stopped by the room rule (length + 1 + k >= max_seq_len at an emission;
    # a round advances the length by at most k + 1, and its last burst may
    # be cut by up to k tokens)
    true_len = int(requests[2]["lengths"][0])
    assert 64 - 2 * K <= true_len + len(short) <= 64


def test_dense_batcher_refuses_what_it_does_not_take(model):
    """A prompt past max_seq_len and params on another device are refused;
    a sampling temperature and logprobs, refused until sampling was
    ported, are taken (tests/test_torch_sampling.py serves them)."""
    cfg, params = model["cfg"], model["params"]
    assert ContinuousBatcher(params, cfg, device="cpu", temperature=0.5).temperature == 0.5
    batcher = ContinuousBatcher(params, cfg, device="cpu", max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        batcher.submit(_request(cfg, 0, pad_to=32), 4)
    batcher.submit(_request(cfg, 0, pad_to=16), 4, logprobs=2)
    assert batcher.queue.get_nowait().logprobs == 2
    with pytest.raises(ValueError, match="params are on cpu"):
        ContinuousBatcher(params, cfg)  # device="cuda"


# -- the paged batcher with speculation --------------------------------------------


def test_paged_batcher_speculative_matches_jax(model, requests):
    """speculative_k on the paged batcher (pages of 4, so rounds cross page
    boundaries and growth looks k ahead): tokens equal the JAX paged
    batcher's with speculation, and the repeater's drafts land."""
    from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxPaged

    kw = dict(num_pages=64, page_size=4, max_pages_per_seq=24, prefill_chunk_size=8,
              speculative_k=K)
    batcher = JaxPaged(model["int8_tree"], model["cfg_j"], num_slots=2, **kw)
    batcher.start()
    try:
        want = [f.result(timeout=600) for f in [batcher.submit(r, MAX_NEW, temperature=0.0)
                                                for r in requests]]
    finally:
        batcher.stop()
    got, paged = _serve(model["int8"], model["cfg"], requests, cls=PagedContinuousBatcher, **kw)
    assert got == want
    assert paged.allocator.available() == 63 - len(paged.prefix.blocks)  # nothing leaked
    reps = [_request(model["cfg"], 7)]
    want = generate.Generator(model["repeater"], model["cfg"]).generate(
        reps[0], max_new_tokens=16).sequences
    got, paged = _serve(model["repeater"], model["cfg"], reps, cls=PagedContinuousBatcher,
                        max_new=16, **kw)
    assert got == want
    assert paged.stats["verify_tokens"] > 1.5 * paged.stats["verify_rounds"]

