"""The serving slice end to end: image -> tower -> projector -> splice ->
prefill -> greedy decode, PyTorch port against the JAX engine at the tiny
geometry, fp32 on the CPU, on the same seeded weights and the same numpy
inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.models.splice import build_splice_plan as jax_build_splice_plan
from tokenpacker_tpu.models.vlm import vlm_hidden as jax_vlm_hidden
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax, params_to_jax
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.models.vlm import vlm_hidden

# fp32 on both sides, the order of the sums differs through tower,
# projector and LM: 1e-4 on logits of magnitude ~0.1-1
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    """Seeded tiny weights as numpy (made by the port's initializer, which
    is faster than JAX's eager init), loaded by both engines. Biases and
    norm scales are random, so a norm or bias that is dropped or swapped
    shows."""
    cfg = tiny_vlm_config()
    tree = params_to_jax(init_vlm_on_device(cfg, seed=4, device="cpu", dtype=torch.float32))
    return jax_tiny_config(), tree, cfg, params_from_jax(tree, cfg)


@pytest.fixture(scope="module")
def batch(model):
    """Two right-padded requests with one image each, prompt lengths 9 and 5
    + 4 visual tokens, padded to 16."""
    cfg = model[2]
    ids = [
        np.array([1, 17, 23, IMAGE_TOKEN_INDEX, 40, 41, 42, 43, 44, 45], np.int64),
        np.array([1, IMAGE_TOKEN_INDEX, 30, 31, 32], np.int64),
    ]
    plan = build_splice_plan(ids, [[(1, 1)], [(1, 1)]], cfg.tokens_per_view, pad_to=16)
    images = np.random.default_rng(5).standard_normal(
        (2, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)
    return {
        "token_ids": plan.token_ids,
        "is_image": plan.is_image,
        "image_slot": plan.image_slot,
        "lengths": plan.lengths,
        "images": images,
    }


def test_splice_plan_of_batch_matches_jax(batch, model):
    cfg = model[2]
    ids = [
        np.array([1, 17, 23, IMAGE_TOKEN_INDEX, 40, 41, 42, 43, 44, 45], np.int64),
        np.array([1, IMAGE_TOKEN_INDEX, 30, 31, 32], np.int64),
    ]
    want = jax_build_splice_plan(ids, [[(1, 1)], [(1, 1)]], cfg.tokens_per_view, pad_to=16)
    np.testing.assert_array_equal(batch["token_ids"], want.token_ids)
    np.testing.assert_array_equal(batch["lengths"], want.lengths)


def test_vlm_hidden_matches_jax(model, batch):
    """The entry() computation: hidden states at every valid position."""
    cfg_j, tree, cfg, params = model
    n, l = batch["token_ids"].shape
    pos = np.broadcast_to(np.arange(l), (n, l)).copy()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "lengths"}
    jb.update(positions=jnp.asarray(pos),
              key_valid=jnp.asarray(np.arange(l)[None] < batch["lengths"][:, None]))
    want, _ = jax_vlm_hidden(tree, cfg_j, jb)
    dev = generate.device_batch(batch, torch.float32, "cpu")
    got = vlm_hidden(params, cfg, {**dev, "positions": torch.from_numpy(pos)})
    for i, ln in enumerate(batch["lengths"]):
        np.testing.assert_allclose(got[i, :ln].numpy(), np.asarray(want)[i, :ln], **LOGIT_TOL)


def test_prefill_logits_and_cache_match_jax(model, batch):
    cfg_j, tree, cfg, params = model
    s_max = 16 + 5
    want_logits, want_cache = jax_generate.prefill(
        tree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), s_max
    )
    logits, cache = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), s_max)
    assert tuple(cache.k.shape) == want_cache.k.shape  # s_max rounded up to 8 alike
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **LOGIT_TOL)
    for i, ln in enumerate(batch["lengths"]):
        np.testing.assert_allclose(cache.k[:, i, :ln].numpy(), np.asarray(want_cache.k)[:, i, :ln],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(cache.v[:, i, :ln].numpy(), np.asarray(want_cache.v)[:, i, :ln],
                                   **LOGIT_TOL)
    assert cache.length == 16


def test_decode_step_logits_match_jax(model, batch):
    cfg_j, tree, cfg, params = model
    s_max, l = 24, 16
    jl, jc = jax_generate.prefill(tree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), s_max)
    tl, tc = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), s_max)
    lengths = torch.from_numpy(batch["lengths"])
    tok = np.array([7, 99], np.int32)
    for step in range(3):
        jl, jc = jax_generate.decode_step(tree, cfg_j, jc, jnp.asarray(tok), jnp.asarray(lengths.numpy()),
                                          jnp.asarray(step, jnp.int32), l)
        tl, tc = generate.decode_step(params, cfg, tc, torch.from_numpy(tok).long(), lengths, step, l)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_greedy_tokens_equal_jax(model, batch):
    """Two right-padded requests, 10 greedy tokens each, checked by the host
    every 4 tokens: the token ids must be identical to the JAX engine's."""
    cfg_j, tree, cfg, params = model
    want = jax_generate.Generator(tree, cfg_j).generate(batch, max_new_tokens=10, check_every=4)
    got = generate.Generator(params, cfg).generate(batch, max_new_tokens=10, check_every=4)
    assert got.sequences == want.sequences
    assert all(len(s) >= 8 for s in got.sequences), got.sequences
    assert got.stats["decode_steps"] == 9  # after the first token: chunks of 4 + 4 + 1


def test_greedy_stops_at_eos(model, batch):
    """With EOS set to the first generated token of both requests, each
    stops after one token, like the JAX engine."""
    import dataclasses

    cfg_j, tree, cfg, params = model
    first = generate.Generator(params, cfg).generate(batch, max_new_tokens=1).sequences
    eos = first[0][0]
    cfg_eos = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, eos_token_id=eos))
    cfg_j_eos = dataclasses.replace(cfg_j, lm=dataclasses.replace(cfg_j.lm, eos_token_id=eos))
    got = generate.Generator(params, cfg_eos).generate(batch, max_new_tokens=6, check_every=2)
    want = jax_generate.Generator(tree, cfg_j_eos).generate(batch, max_new_tokens=6, check_every=2)
    assert got.sequences == want.sequences
    assert got.sequences[0] == [eos]


@pytest.mark.parametrize("kwargs", [
    dict(temperature=0.7), dict(top_p=0.9), dict(top_k=5), dict(min_p=0.1),
    dict(num_beams=2), dict(speculative=3), dict(repetition_penalty=1.2),
    dict(presence_penalty=0.5), dict(frequency_penalty=0.5),
])
def test_unported_generate_options_raise(model, batch, kwargs):
    """Each of these options, refused with NotImplementedError until the
    generation surface was ported, now does what it does in the JAX
    engine: at temperature 0 the sampling filters leave greedy decoding
    as it is, num_beams runs beam search, speculation at a batch of 2 is
    ignored and the penalties change the tokens, each time as JAX's
    tokens do (tests/test_torch_sampling.py and test_torch_beam.py hold
    them in depth); a positive temperature samples, the same tokens on
    each call without a generator (a fresh one seeded 0)."""
    cfg_j, tree, cfg, params = model
    got = generate.Generator(params, cfg).generate(batch, max_new_tokens=4, **kwargs)
    if kwargs.get("temperature", 0.0) > 0.0:
        again = generate.Generator(params, cfg).generate(batch, max_new_tokens=4, **kwargs)
        assert got.sequences == again.sequences
        assert all(len(s) == 4 and all(0 <= t < cfg.lm.vocab_size for t in s)
                   for s in got.sequences)
        return
    want = jax_generate.Generator(tree, cfg_j).generate(batch, max_new_tokens=4, **kwargs)
    assert got.sequences == want.sequences


def test_pick_bucket_matches_jax():
    for n in (1, 128, 129, 500, 2048, 2049, 5000):
        assert generate.pick_bucket(n) == jax_generate.pick_bucket(n)
