"""The port's generation surface against the JAX package on the CPU, at the
tiny geometry on the same seeded weights and numpy inputs: the sampling
filters, the penalties, prompt presence, logprob entries, the seed rule,
`Generator.generate` with sampling, penalties and speculation at a batch
of 2, `Generator.generate_stream` and both batchers with per-request
sampling, penalties, seeds and logprobs.

JAX's threefry stream and the port's noise can never agree token for
token, so sampled paths are held by the filters' -inf sets (against HF
4.57's warpers in their order), by the support of JAX's draws and of the
port's, and by the distribution of the draws. Greedy and penalized
greedy tokens must be identical to JAX's; penalties are bit-equal in
fp32. Every other bound is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.serve.scheduler import ContinuousBatcher as JaxDense
from tokenpacker_tpu.serve.scheduler import PagedContinuousBatcher as JaxPaged
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_to,
    params_to_jax,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher, PagedContinuousBatcher

SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary
MAX_NEW = 6
# fp32 log_softmax of the same logits in both packages (another order of
# the sum over the vocabulary): the JAX package's logprob bound
LP_TOL = 1e-5
PAGED = dict(num_pages=64, page_size=4, max_pages_per_seq=24, prefill_chunk_size=8)
BATCHERS = {"dense": (ContinuousBatcher, JaxDense, dict(max_seq_len=64)),
            "paged": (PagedContinuousBatcher, JaxPaged, PAGED)}


class WordTokenizer:
    """decode: one "<id>" word a token, so that texts compare the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module")
def model():
    """Seeded tiny fp32 weights in both packages and their int8 form (int8
    products per layer: the tiny heads are narrower than K4's 128; beams
    hold K4's plain version, tests/test_torch_beam.py)."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=9, device="cpu", dtype=torch.float32)
    int8 = quantize_lm_int8(params_to(params, "cpu", torch.float32), min_size=1)
    return {"cfg": cfg, "cfg_j": jax_tiny_config(), "params": params,
            "tree": params_to_jax(params), "int8": int8, "int8_tree": params_to_jax(int8)}


def _request(cfg, seed, extra=0, repeat=False, n=1):
    """n requests with one image each and short prompts (`repeat`: a
    repeated run of text, so that prompt lookup finds drafts)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 56, 56, 3)).astype(np.float32)
    ids = []
    for i in range(n):
        text = [40, 41, 42, 40, 41, 42, 40, 41] if repeat else list(30 + np.arange(2 + extra + i))
        ids.append(np.array([1, 17 + seed + i, IMAGE_TOKEN_INDEX, *text], np.int64))
    plan = build_splice_plan(ids, [[(1, 1)]] * n, cfg.tokens_per_view, "single", SEP, NEWLINE, 0,
                             pad_to=32)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}


# -- the filters against HF 4.57's warpers ------------------------------------------


def _hf_support(row, t, k, p, m):
    """HF's warpers in generation/utils.py's order on one row: the finite set."""
    from transformers.generation import (
        MinPLogitsWarper,
        TemperatureLogitsWarper,
        TopKLogitsWarper,
        TopPLogitsWarper,
    )

    x = TemperatureLogitsWarper(t)(None, torch.from_numpy(row[None]))
    if k and 0 < k < row.shape[-1]:
        x = TopKLogitsWarper(top_k=k)(None, x)
    if p is not None and p < 1.0:
        x = TopPLogitsWarper(top_p=p)(None, x)
    if m and 0.0 < m <= 1.0:
        x = MinPLogitsWarper(min_p=m)(None, x)
    return np.isfinite(x.numpy()[0])


# one setting for every row (the JAX package's sample_tokens), or one a row
# (sample_tokens_per_row, rows whose values switch a filter off included)
FILTER_CASES = {
    "top_k": dict(t=0.8, k=3),
    "top_p": dict(t=0.9, p=0.8),
    "min_p": dict(t=0.9, m=0.25),
    "mixed": dict(t=0.7, k=12, p=0.9, m=0.05),
    "per_row": dict(t=[0.8, 1.2, 0.5, 1.0], k=[3, 0, 10, 64], p=[1.0, 0.7, 0.9, 1.0],
                    m=[0.0, 0.0, 0.2, 1.5]),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_matches_hf_warpers_and_holds_the_draws(case):
    """The port's -inf set equals HF's warpers applied in order, row by row;
    300 draws of JAX's sampler (vmapped over keys) and of the port's lie
    inside it, and the port's reach more than one token where the set has
    more."""
    s = FILTER_CASES[case]
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
    per_row = case == "per_row"
    rows = [{key: (v[i] if per_row else v) for key, v in s.items()} for i in range(4)]
    want = np.stack([_hf_support(logits[i], r["t"], r.get("k"), r.get("p"), r.get("m"))
                     for i, r in enumerate(rows)])
    filtered = generate.filter_logits(torch.from_numpy(logits), s["t"], s.get("k"), s.get("p"),
                                      s.get("m"))
    np.testing.assert_array_equal(torch.isfinite(filtered).numpy(), want)

    keys = jax.random.split(jax.random.PRNGKey(0), 300)
    x = jnp.asarray(logits)
    if per_row:
        fn = lambda key: jax_generate.sample_tokens_per_row(  # noqa: E731
            x, jnp.asarray(s["t"]), key, jnp.asarray(s["p"]), jnp.asarray(s["k"]),
            jnp.asarray(s["m"]))
    else:
        fn = lambda key: jax_generate.sample_tokens(  # noqa: E731
            x, s["t"], s.get("p"), key, top_k=s.get("k"), min_p=s.get("m"))
    jax_draws = np.asarray(jax.jit(jax.vmap(fn))(keys))  # [300, 4]
    gen = torch.Generator().manual_seed(0)
    ours = generate.draw(filtered.repeat(300, 1),
                         generate.gumbel_noise((1200, 64), "cpu", gen)).reshape(300, 4).numpy()
    for i in range(4):
        assert want[i, jax_draws[:, i]].all() and want[i, ours[:, i]].all()
        assert len(set(ours[:, i])) > 1 or want[i].sum() == 1


def test_sample_tokens_takes_the_argmax_of_greedy_rows():
    """Rows with temperature <= 0 take the argmax of the unfiltered logits
    (their filters ignored); a scalar temperature <= 0 returns the argmax."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 32)).astype(np.float32))
    got = generate.sample_tokens(logits, torch.tensor([0.0, 1.0, -1.0]), top_k=[1, 1, 1],
                                 generator=torch.Generator().manual_seed(0))
    assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()
    assert got[1] == logits[1].argmax()  # top_k = 1 at temperature 1
    assert torch.equal(generate.sample_tokens(logits, 0.0), logits.argmax(-1))


def test_top_p_index_past_the_last_cdf_entry_is_clamped():
    """cdf < top_p can hold for every entry when rounding leaves the last
    cdf value below top_p; JAX's take_along_axis clamps the index to V - 1
    (everything survives), and so does the port."""
    logits = torch.zeros((1, 7))
    filtered = generate.filter_logits(logits, 1.0, top_p=0.9999999)
    assert torch.isfinite(filtered).all()


# -- penalties, prompt presence, logprobs ---------------------------------------------


@pytest.mark.parametrize("form", ["scalar", "per_row"])
def test_apply_penalties_bit_equal_to_jax(form):
    """fp32 results bit-equal to JAX's; a row with identity values (1, 0, 0)
    keeps its logits bit for bit."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 50)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (3, 50)).astype(np.int32) * (rng.random((3, 50)) < 0.3)
    presence = rng.random((3, 50)) < 0.2
    if form == "scalar":
        rep, pres, freq = 1.3, 0.4, 0.25
    else:
        rep = np.array([1.3, 1.0, 0.7], np.float32)
        pres = np.array([0.4, 0.0, 0.1], np.float32)
        freq = np.array([0.25, 0.0, 1.5], np.float32)
    got = generate.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts),
                                   torch.from_numpy(presence), rep, pres, freq).numpy()
    want = np.asarray(jax_generate.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                                   jnp.asarray(presence), rep, pres, freq))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if form == "per_row":
        np.testing.assert_array_equal(got[1], logits[1])
    bf16 = torch.from_numpy(logits).bfloat16()
    same = generate.apply_penalties(bf16, torch.from_numpy(counts), torch.from_numpy(presence),
                                    1.0, 0.0, 0.0)
    assert torch.equal(same, bf16.float())


def test_prompt_presence_mask_matches_jax(model):
    """Text positions within the true length only: image placeholders,
    pads and ids outside the vocabulary do not count."""
    batch = _request(model["cfg"], 2, extra=3, n=2)
    batch["token_ids"][1, 3] = 10_000  # outside the tiny vocabulary
    v = model["cfg"].lm.vocab_size
    got = generate.prompt_presence_mask(batch, v)
    np.testing.assert_array_equal(got, jax_generate.prompt_presence_mask(batch, v))
    assert got.sum() > 0


def test_token_logprob_entry_matches_jax():
    """Within 1e-6, the same top ids, lower ids first among equal values
    (the row holds ties); the batched rows equal the per-row entries."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 40)).astype(np.float32)
    logits[0, [3, 9, 17]] = logits[0].max() + 1.0  # a three-way tie at the top
    logits[1, [30, 2]] = logits[1].max() + 0.5
    toks = np.array([9, 5])
    for i in range(2):
        got = generate.token_logprob_entry(torch.from_numpy(logits[i]), toks[i], 5)
        want = jax_generate.token_logprob_entry(jnp.asarray(logits[i]), int(toks[i]), 5)
        assert got["id"] == want["id"]
        assert abs(got["logprob"] - want["logprob"]) <= 1e-6
        assert [t for t, _ in got["top"]] == [t for t, _ in want["top"]]
        np.testing.assert_allclose([v for _, v in got["top"]], [v for _, v in want["top"]],
                                   atol=1e-6)
    assert [t for t, _ in generate.token_logprob_entry(
        torch.from_numpy(logits[0]), 3, 3)["top"]] == [3, 9, 17]
    chosen, top_lps, top_ids = generate.logprob_rows(torch.from_numpy(logits),
                                                     torch.from_numpy(toks), 5)
    for i in range(2):
        entry = generate.token_logprob_entry(torch.from_numpy(logits[i]), toks[i], 5)
        assert chosen[i].item() == entry["logprob"]
        assert list(zip(top_ids[i].tolist(), top_lps[i].tolist())) == entry["top"]


# -- the seed rule ---------------------------------------------------------------------------


def _hash_reference(seed: int, step: int, idx: int) -> float:
    """seed_keys and seeded_uniform in Python integers (no width limit)."""
    m = 0xFFFFFFFF

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & m
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & m
        return h ^ (h >> 16)

    h = ((idx * 0x9E3779B1) & m) ^ fmix(fmix((seed & 0x7FFFFFFF) ^ 0x9E3779B9) ^ (step & m))
    h ^= h >> 16
    h = (h * 0x7FEB352D) & m
    h ^= h >> 15
    h = (h * 0x5BD1E995) & m
    h ^= h >> 16
    return ((h >> 9) + 0.5) * 2.0**-23


def test_seeded_uniform_is_the_32_bit_hash():
    """The host's keys and the device's mix equal the hash in Python
    integers bit for bit (no product overflows int64); a row without a
    seed gets the key -1."""
    seeds, steps = [0, 1234, 2**31 - 1, 2**40 + 5, -1], [0, 7, 2**31, 3, 4]
    keys = generate.seed_keys(seeds, steps)
    assert keys[-1] == -1 and (keys[:-1] >= 0).all()
    got = generate.seeded_uniform(torch.from_numpy(keys[:-1]), 1000)
    for r in range(4):
        for idx in (0, 1, 517, 999):
            assert got[r, idx].item() == _hash_reference(seeds[r], steps[r], idx)
    assert generate.seed_keys([5], [3])[0] == keys[3]  # only the seed's low 31 bits count
    assert 0.0 < got.min() and got.max() < 1.0


def test_seeded_draw_depends_on_seed_step_and_logits_alone():
    """A seeded row's token does not depend on the shared generator, its
    slot, its neighbours or the form of the call (one setting or one a
    row); its steps vary the draw."""
    rng = np.random.default_rng(1)
    mine = torch.from_numpy(rng.standard_normal((1, 48)).astype(np.float32))
    want = generate.sample_tokens(mine, 1.0, top_p=0.95, keys=generate.seed_keys([77], [4]))
    for slot in range(4):
        logits = torch.from_numpy(rng.standard_normal((4, 48)).astype(np.float32))
        logits[slot] = mine[0]
        seeds, steps = [-1, 5, -1, 6], [9, 2, 0, 1]
        seeds[slot], steps[slot] = 77, 4
        got = generate.sample_tokens(
            logits, torch.tensor([0.7, 1.0, 1.3, 1.0]).index_fill(0, torch.tensor([slot]), 1.0),
            top_p=torch.tensor([0.95] * 4), keys=torch.from_numpy(generate.seed_keys(seeds, steps)),
            generator=torch.Generator().manual_seed(slot + 100))
        assert got[slot] == want[0]
    draws = {int(generate.sample_tokens(mine, 1.0, keys=generate.seed_keys([77], [k]))[0])
             for k in range(40)}
    assert len(draws) > 5


@pytest.mark.parametrize("source", ["generator", "seeds", "steps"])
def test_draws_follow_the_distribution(source):
    """4,000 draws from one 16-token distribution: total variation under
    0.05 (sampling noise alone gives ~0.03 at this count), unseeded from a
    generator, seeded over 4,000 seeds at one step, and one seed over
    4,000 steps."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal(16) * 1.5).astype(np.float32))
    p = torch.softmax(logits / 0.9, -1).numpy()
    n = 4000
    tiled = logits.expand(n, 16)
    kw = {"generator": torch.Generator().manual_seed(0)}
    if source == "seeds":
        kw.update(keys=generate.seed_keys(np.arange(n), np.zeros(n)))
    elif source == "steps":
        kw.update(keys=generate.seed_keys(np.full(n, 4321), np.arange(n)))
    toks = generate.sample_tokens(tiled, 0.9, **kw).numpy()
    freq = np.bincount(toks, minlength=16) / n
    assert 0.5 * np.abs(freq - p).sum() < 0.05


# -- Generator -------------------------------------------------------------------------------

PENALTIES = dict(repetition_penalty=1.3, presence_penalty=0.4, frequency_penalty=0.2)


@pytest.mark.parametrize("tree", ["params", "int8"])
def test_generate_penalized_greedy_matches_jax(model, tree):
    """Penalized greedy tokens identical to the JAX engine's (the first
    token from the penalized prefill logits), on the fp32 tree and the
    int8 one."""
    cfg, batch = model["cfg"], _request(model["cfg"], 0, extra=2, n=2)
    got = generate.Generator(model[tree], cfg).generate(batch, max_new_tokens=10, check_every=4,
                                                         **PENALTIES)
    jax_tree = model[{"params": "tree", "int8": "int8_tree"}[tree]]
    want = jax_generate.Generator(jax_tree, model["cfg_j"]).generate(
        batch, max_new_tokens=10, check_every=4, **PENALTIES)
    assert got.sequences == want.sequences
    plain = generate.Generator(model[tree], cfg).generate(batch, max_new_tokens=10)
    assert got.sequences != plain.sequences  # the penalties changed something


def test_generate_samples_inside_the_support_of_jax_logits(model):
    """Sampled, filtered and penalized tokens: each lies in the filter's
    support computed from JAX's teacher-forced logits (penalized by JAX
    with the port's tokens so far); top_k = 1 gives greedy's tokens; two
    calls without a generator give the same tokens."""
    cfg, cfg_j, tree = model["cfg"], model["cfg_j"], model["tree"]
    batch = _request(cfg, 1, extra=1, n=2)
    gen = generate.Generator(model["params"], cfg)
    settings = dict(temperature=0.8, top_p=0.9, top_k=20, min_p=0.05, repetition_penalty=1.1,
                    presence_penalty=0.2)
    got = gen.generate(batch, max_new_tokens=10, **settings).sequences
    assert gen.generate(batch, max_new_tokens=10, **settings).sequences == got
    other = gen.generate(batch, max_new_tokens=10, generator=torch.Generator().manual_seed(3),
                         **settings).sequences
    assert other != got

    l = batch["token_ids"].shape[1]
    logits, cache = jax_generate.prefill(tree, cfg_j, jax_generate.device_batch(batch, jnp.float32),
                                         l + 10)
    presence = jax_generate.prompt_presence_mask(batch, cfg.lm.vocab_size)
    counts = np.zeros((2, cfg.lm.vocab_size), np.int32)
    for step in range(10):
        pen = jax_generate.apply_penalties(logits, jnp.asarray(counts), jnp.asarray(presence), 1.1,
                                           0.2, 0.0)
        support = torch.isfinite(generate.filter_logits(torch.from_numpy(np.array(pen)), 0.8,
                                                        20, 0.9, 0.05)).numpy()
        fed = np.array([seq[min(step, len(seq) - 1)] for seq in got], np.int32)
        for i, seq in enumerate(got):
            if step < len(seq):
                assert support[i, seq[step]], (i, step)
        counts[np.arange(2), fed] += 1
        logits, cache = jax_generate.decode_step(tree, cfg_j, cache, jnp.asarray(fed),
                                                 jnp.asarray(batch["lengths"]),
                                                 jnp.asarray(step, jnp.int32), l)

    greedy = gen.generate(batch, max_new_tokens=10).sequences
    assert gen.generate(batch, max_new_tokens=10, temperature=0.7, top_k=1).sequences == greedy


def test_generate_ignores_speculation_where_jax_does(model):
    """speculative at a batch of 2, with penalties or with sampling is
    ignored (no verify round): the tokens are plain decoding's and JAX's."""
    cfg = model["cfg"]
    batch = _request(cfg, 3, repeat=True, n=2)
    gen = generate.Generator(model["int8"], cfg)
    plain = gen.generate(batch, max_new_tokens=8)
    spec = gen.generate(batch, max_new_tokens=8, speculative=2)
    assert spec.sequences == plain.sequences and spec.stats["verify_rounds"] == 0
    want = jax_generate.Generator(model["int8_tree"], model["cfg_j"]).generate(
        batch, max_new_tokens=8, speculative=2)
    assert spec.sequences == want.sequences
    one = {k: v[:1] for k, v in batch.items()}
    pen = gen.generate(one, max_new_tokens=8, speculative=2, repetition_penalty=1.2)
    assert pen.stats["verify_rounds"] == 0
    assert pen.sequences == gen.generate(one, max_new_tokens=8, repetition_penalty=1.2).sequences


# -- generate_stream ---------------------------------------------------------------------------


def _stream_items(gen, batch, **kw):
    return list(gen.generate_stream(batch, max_new_tokens=8, **kw))


@pytest.mark.parametrize("mode", ["greedy", "penalized", "logprobs", "stop"])
def test_stream_matches_jax(model, mode):
    """The streamed texts equal JAX's stream item for item; with logprobs
    the entries agree within LP_TOL and their top ids are equal; a stop
    string cuts the text and ends the stream."""
    cfg = model["cfg"]
    batch = _request(cfg, 4, extra=1)
    tok = WordTokenizer()
    ours = generate.Generator(model["params"], cfg, tokenizer=tok)
    theirs = jax_generate.Generator(model["tree"], model["cfg_j"], tokenizer=tok)
    kw = {"greedy": {}, "penalized": PENALTIES, "logprobs": dict(logprobs=3, **PENALTIES),
          "stop": {}}[mode]
    if mode == "stop":
        first = _stream_items(ours, batch)[-1].split()
        kw = dict(stop_strings=(first[4],))
    got, want = _stream_items(ours, batch, **kw), _stream_items(theirs, batch, **kw)
    assert len(got) == len(want) > 0
    if mode != "logprobs":
        assert got == want
        if mode == "stop":
            assert len(got) == first.index(first[4]) + 1 and first[4] not in got[-1]
        return
    for (g_text, g), (w_text, w) in zip(got, want):
        assert g_text == w_text and g["id"] == w["id"]
        assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
        assert [t for t, _ in g["top"]] == [t for t, _ in w["top"]]
        np.testing.assert_allclose([v for _, v in g["top"]], [v for _, v in w["top"]],
                                   atol=LP_TOL)


def test_speculative_stream_is_greedy(model):
    """The speculative stream (drafts land on the repeated prompt) yields the
    greedy stream's texts, as JAX's does; logprobs turn speculation off."""
    cfg = model["cfg"]
    batch = _request(cfg, 5, repeat=True)
    gen = generate.Generator(model["int8"], cfg, tokenizer=WordTokenizer())
    greedy = _stream_items(gen, batch)
    assert _stream_items(gen, batch, speculative=2) == greedy
    jax_gen = jax_generate.Generator(model["int8_tree"], model["cfg_j"], tokenizer=WordTokenizer())
    assert _stream_items(jax_gen, batch, speculative=2) == greedy
    with_lp = _stream_items(gen, batch, speculative=2, logprobs=1)
    assert [text for text, _ in with_lp] == greedy
    with pytest.raises(ValueError, match="batch 1"):
        _stream_items(gen, _request(cfg, 5, n=2))


# -- the batchers ---------------------------------------------------------------------------------


def _serve(batcher, items, max_new=MAX_NEW):
    """Submit (request, options) pairs in order; returns the futures'
    tokens and their requests' logprob entries."""
    batcher.start()
    try:
        futs = [batcher.submit(r, max_new, **kw) for r, kw in items]
        tokens = [f.result(timeout=600) for f in futs]
    finally:
        batcher.stop()
    return tokens, [f._tp_request.lp_entries for f in futs]


def _entries_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and abs(g["logprob"] - w["logprob"]) <= LP_TOL
        assert [t for t, _ in g.get("top", [])] == [t for t, _ in w.get("top", [])]


@pytest.mark.parametrize("kind", list(BATCHERS))
def test_batcher_penalties_and_logprobs_match_jax(model, kind):
    """Plain, penalized and logprob-recording greedy requests through 2
    slots: tokens identical to the JAX batcher's, logprob entries (one a
    token, raw logits) within LP_TOL with the same top ids."""
    cls, jax_cls, kw = BATCHERS[kind]
    cfg = model["cfg"]
    items = [(_request(cfg, 0), {}), (_request(cfg, 1, extra=2), PENALTIES),
             (_request(cfg, 2, extra=1), dict(logprobs=3)),
             (_request(cfg, 3), dict(logprobs=2, repetition_penalty=1.5))]
    want, want_lp = _serve(jax_cls(model["int8_tree"], model["cfg_j"], num_slots=2, **kw),
                           [(r, {"temperature": 0.0, **o}) for r, o in items])
    got, got_lp = _serve(cls(model["int8"], cfg, device="cpu", num_slots=2, **kw), items)
    assert got == want
    for g, w, (_, o) in zip(got_lp, want_lp, items):
        assert len(g) == (MAX_NEW if "logprobs" in o else 0)
        _entries_close(g, w)


@pytest.mark.parametrize("kind", list(BATCHERS))
def test_sampled_neighbours_and_seeds(model, kind):
    """Greedy requests keep their tokens beside sampled ones; a seeded
    request gives the same tokens alone in slot 0 and in slot 1 among
    others, in either batcher (the noise is a function of the seed and the
    step); an unseeded twin gives others; every token is in the
    vocabulary and the requests stop at MAX_NEW."""
    cls, _, kw = BATCHERS[kind]
    cfg, params = model["cfg"], model["int8"]
    g0, g1, s = _request(cfg, 0), _request(cfg, 1, extra=2), _request(cfg, 2, extra=1)
    seeded = dict(temperature=1.0, top_p=0.95, seed=1234)
    alone, _ = _serve(cls(params, cfg, device="cpu", num_slots=2, **kw),
                      [(g0, {}), (g1, {}), (s, seeded)])
    mixed, _ = _serve(cls(params, cfg, device="cpu", num_slots=2, **kw),
                      [(g0, {}), (s, dict(temperature=0.9, min_p=0.1)), (g1, {}),
                       (s, dict(temperature=1.0, top_k=30)), (s, seeded)])
    assert mixed[0] == alone[0] and mixed[2] == alone[1]
    assert mixed[4] == alone[2]
    other_kind = "paged" if kind == "dense" else "dense"
    ocls, _, okw = BATCHERS[other_kind]
    across, _ = _serve(ocls(params, cfg, device="cpu", num_slots=2, **okw), [(s, seeded)])
    assert across[0] == alone[2]
    twin, _ = _serve(cls(params, cfg, device="cpu", num_slots=2, **kw),
                     [(s, dict(seeded, seed=None))] * 2)
    assert alone[2] not in twin
    assert all(len(t) == MAX_NEW and all(0 <= x < cfg.lm.vocab_size for x in t)
               for t in mixed + twin)


@pytest.mark.parametrize("kind", list(BATCHERS))
def test_speculative_rounds_with_mixed_slots_match_jax(model, kind):
    """speculative_k = 2 with greedy, penalized and sampled slots (3
    slots): greedy and penalized tokens equal the JAX batcher's on the
    same traffic; rounds run while a greedy slot is active, and every
    other slot advances one token a round."""
    cls, jax_cls, kw = BATCHERS[kind]
    cfg = model["cfg"]
    items = [(_request(cfg, 0, repeat=True), {}),
             (_request(cfg, 1, extra=2), dict(temperature=0.8, top_p=0.95)),
             (_request(cfg, 2, extra=1), dict(repetition_penalty=1.3)),
             (_request(cfg, 3, repeat=True), dict(logprobs=1)),
             (_request(cfg, 4), dict(temperature=0.7, seed=9))]
    kw = dict(kw, speculative_k=2, num_slots=3)
    want, want_lp = _serve(jax_cls(model["int8_tree"], model["cfg_j"], **kw),
                           [(r, {"temperature": 0.0, **o}) for r, o in items], max_new=10)
    batcher = cls(model["int8"], cfg, device="cpu", **kw)
    advance = []
    real_round = batcher._verify_round

    def counting_round(active):
        before = {slot: len(r.tokens) for slot, r in enumerate(batcher.slots)
                  if r is not None and not r.plain_greedy}
        reqs = list(batcher.slots)
        real_round(active)
        advance.extend(len(reqs[slot].tokens) - n for slot, n in before.items())

    batcher._verify_round = counting_round
    got, got_lp = _serve(batcher, items, max_new=10)
    for i in (0, 2, 3):
        assert got[i] == want[i], i
    _entries_close(got_lp[3], want_lp[3])
    assert batcher.stats["verify_rounds"] > 0 and advance and set(advance) == {1}


def test_k4_batcher_rounds_with_sampled_slots(model):
    """At K4's geometry (heads of 128; its plain version and its verify
    form's on the CPU) the dense batcher with speculative_k = 2 serves a
    greedy, a sampled and a penalized request through 3 slots: the greedy
    and penalized tokens equal the Generator's (K4 steps), and the sampled
    request's stay in the vocabulary."""
    from tokenpacker_tpu_torch.config import LMConfig

    lm = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
              num_attention_heads=4)
    cfg = tiny_vlm_config(lm=LMConfig(**lm))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=8, device="cpu", dtype=torch.float32))
    assert generate.fused_weights(params, cfg) is True
    greedy, sampled, pen = (_request(cfg, 0, repeat=True), _request(cfg, 1, extra=2),
                            _request(cfg, 2, extra=1))
    gen = generate.Generator(params, cfg)
    want = [gen.generate(greedy, max_new_tokens=10).sequences[0],
            gen.generate(pen, max_new_tokens=10, repetition_penalty=1.3).sequences[0]]
    batcher = ContinuousBatcher(params, cfg, device="cpu", num_slots=3, max_seq_len=64,
                                speculative_k=2)
    got, _ = _serve(batcher, [(greedy, {}), (sampled, dict(temperature=0.8, top_k=40, seed=5)),
                              (pen, dict(repetition_penalty=1.3))], max_new=10)
    assert [got[0], got[2]] == want
    assert len(got[1]) == 10 and all(0 <= t < lm["vocab_size"] for t in got[1])
    assert batcher.stats["verify_rounds"] > 0
