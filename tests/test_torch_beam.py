"""The port's beam search (`tokenpacker_tpu_torch/beam.py`) against the JAX
package's `beam_generate` on the CPU, at the tiny geometry on the same
seeded weights and numpy inputs.

The EOS id is set to a token the beams meet early, so that beams finish,
the finished set fills and the early-stopping rules decide. Bars: the
same tokens and scores within 1e-5 (fp32 sums of log-probabilities over
at most 10 tokens, another summation order in the log-softmax), over
length_penalty in {0.5, 1, 2} and early_stopping in {False, True,
"never"}; a batch equal to its samples searched alone; an int8 tree
through K4's plain version against JAX's kernel in interpret mode, with
a float cache and an int8 one, whose scales move with its rows in the
reorder.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tokenpacker_tpu import beam as jax_beam
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu_torch import beam, generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to_jax, quantize_lm_int8
from tokenpacker_tpu_torch.models.splice import build_splice_plan

SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary
K, MAX_NEW = 3, 8
SCORE_TOL = 1e-5


def _with_eos(cfg, eos):
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, eos_token_id=eos))


def _batch(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = [np.array([1, 17 + i, IMAGE_TOKEN_INDEX, *(30 + np.arange(2 + 3 * i))], np.int64)
           for i in range(n)]
    plan = build_splice_plan(ids, [[(1, 1)]] * n, cfg.tokens_per_view, "single", SEP, NEWLINE, 0,
                             pad_to=32)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image, "image_slot": plan.image_slot,
            "lengths": plan.lengths,
            "images": rng.standard_normal((n, 56, 56, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def model():
    """Seeded tiny weights in both packages and an EOS id: the third token
    of the first request's greedy decode, which the beams meet within
    MAX_NEW."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=9, device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    eos = generate.Generator(params, cfg).generate(batch, max_new_tokens=3).sequences[0][2]
    return {"cfg": _with_eos(cfg, eos), "cfg_j": _with_eos(jax_tiny_config(), eos),
            "params": params, "tree": params_to_jax(params), "batch": batch, "eos": eos}


def _assert_same(got, want):
    (g_seqs, g_scores), (w_seqs, w_scores) = got, want
    assert g_seqs == w_seqs
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("early_stopping", [False, True, "never"])
@pytest.mark.parametrize("length_penalty", [0.5, 1.0, 2.0])
def test_beams_match_jax(model, length_penalty, early_stopping):
    """Tokens identical to JAX's beam_generate (terminal EOS included) and
    scores within SCORE_TOL; at least one sample ends on EOS."""
    kw = dict(num_beams=K, max_new_tokens=MAX_NEW, length_penalty=length_penalty,
              early_stopping=early_stopping)
    got = beam.beam_generate(model["params"], model["cfg"], model["batch"], **kw)
    want = jax_beam.beam_generate(model["tree"], model["cfg_j"], model["batch"], **kw)
    _assert_same(got, want)
    if length_penalty < 2.0:  # a length penalty of 2 favours the longer running beams here
        assert any(seq[-1] == model["eos"] for seq in got[0])


def test_batch_equals_each_sample_alone(model):
    """A sample that finishes early keeps its state while the others run:
    each sample's result is its batch-1 result, tokens and score alike
    (text prompts of ragged lengths; with images the batched tower itself
    rounds otherwise than at one image, in both packages)."""
    prompts = [[1, 17, 23], [1, 99, 3, 77, 12, 5, 64, 8, 9], [1, 44]]
    plan = build_splice_plan([np.array(p, np.int64) for p in prompts], [[]] * 3,
                             model["cfg"].tokens_per_view, "single", SEP, NEWLINE, 0, pad_to=32)
    batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
             "image_slot": plan.image_slot, "lengths": plan.lengths, "images": None}
    seqs, scores = beam.beam_generate(model["params"], model["cfg"], batch, K, MAX_NEW)
    assert any(seq[-1] == model["eos"] for seq in seqs) and len(set(map(len, seqs))) > 1
    for i in range(3):
        one = {k: (v[i:i + 1] if v is not None else None) for k, v in batch.items()}
        s1, sc1 = beam.beam_generate(model["params"], model["cfg"], one, K, MAX_NEW)
        assert s1[0] == seqs[i] and sc1[0] == scores[i]


# K4's geometry (heads of 128) at 2 small layers, fp32 weights quantized to int8
K4_LM = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4)
K4_EOS = 60  # a token the second request's beams end on within MAX_NEW
# JAX's kernel with an int8 cache rounds its products to bf16 (2^-9 each):
# the scores (mean log-probabilities over 6-8 tokens) read 1.3e-3 to 1.9e-3
# from the XLA decode's, which the port's plain version matches to 1e-5
K4_INT8_CACHE_TOL = 5e-3


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_int8_tree_matches_jax(cache, monkeypatch):
    """An int8 tree whose n*k-row steps run K4 (its plain version here)
    against the JAX engine on the same tree with its fused kernel in
    interpret mode (TOKENPACKER_FUSED_DECODE=interpret), with a float
    cache and with an int8 one (TOKENPACKER_KV_CACHE=int8, JAX's flash
    prefill as on a TPU): the reorder moves the rows' scales with them.
    Tokens identical. Scores within SCORE_TOL, except that JAX's kernel
    rounds the products of its int8-cache form to bf16 (the JAX package's
    own fused-vs-XLA bound, tests/test_fused_decode.py): there within
    K4_INT8_CACHE_TOL, and within SCORE_TOL of JAX's XLA decode
    (TOKENPACKER_FUSED_DECODE=off)."""
    from tokenpacker_tpu.config import LMConfig as JaxLMConfig
    from tokenpacker_tpu.models import llama as jax_llama
    from tokenpacker_tpu_torch.config import LMConfig

    cfg = tiny_vlm_config(lm=LMConfig(**K4_LM, eos_token_id=K4_EOS))
    cfg_j = jax_tiny_config(lm=JaxLMConfig(**K4_LM, eos_token_id=K4_EOS))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=8, device="cpu", dtype=torch.float32))
    assert generate.fused_weights(params, cfg) is True
    if cache == "int8":
        monkeypatch.setenv("TOKENPACKER_KV_CACHE", "int8")
        monkeypatch.setattr(jax_llama, "_use_flash_prefill", lambda t: True)
    batch = _batch(cfg)
    got = beam.beam_generate(params, cfg, batch, K, MAX_NEW,
                             kv_cache_dtype=torch.int8 if cache == "int8" else None)
    assert got[0][1][-1] == K4_EOS
    for mode, tol in (("interpret", SCORE_TOL if cache == "float" else K4_INT8_CACHE_TOL),
                      ("off", SCORE_TOL)):
        monkeypatch.setenv("TOKENPACKER_FUSED_DECODE", mode)
        # the JAX package reads these switches when it traces: programs
        # traced under other settings must not be reused, here or after
        jax.clear_caches()
        try:
            want = jax_beam.beam_generate(params_to_jax(params), cfg_j, batch, K, MAX_NEW)
        finally:
            jax.clear_caches()
        assert got[0] == want[0], mode
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol, err_msg=mode)


def test_gather_cache_moves_scales_with_rows():
    """The reorder of an int8 cache takes k, v and both scales from the same
    source row, over the decoded span only."""
    from tokenpacker_tpu_torch.config import LMConfig
    from tokenpacker_tpu_torch.models.llama import KVCache

    lc = LMConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=2)
    cache = KVCache.create(lc, 4, 12, dtype=torch.int8)
    for i, name in enumerate(("k", "v", "k_scale", "v_scale")):
        a = getattr(cache, name)
        a.copy_((torch.arange(4).reshape(1, 4, *[1] * (a.dim() - 2)) * 10 + i).to(a.dtype)
                .expand_as(a))
    beam._gather_cache(cache, torch.tensor([1, 1, 3, 2]), 8, 12)
    for i, name in enumerate(("k", "v", "k_scale", "v_scale")):
        a = getattr(cache, name).float()
        assert (a[:, :, :8] == (torch.arange(4) * 10 + i).reshape(1, 4, *[1] * (a.dim() - 2))
                ).all()
        assert (a[0, :, 8:].flatten(1).mean(1) == torch.tensor([10, 10, 30, 20]) + i).all()


def test_generator_beams_and_their_refusals(model):
    """Generator.generate(num_beams=k) is beam_generate; penalties with beams
    raise ValueError as in JAX; a positive temperature falls back to plain
    sampling (the same tokens as without num_beams); more than MAX_BEAMS
    beams raise ValueError."""
    cfg, batch = model["cfg"], model["batch"]
    gen = generate.Generator(model["params"], cfg)
    got = gen.generate(batch, max_new_tokens=MAX_NEW, num_beams=K, length_penalty=2.0)
    assert got.sequences == beam.beam_generate(model["params"], cfg, batch, K, MAX_NEW, 2.0)[0]
    with pytest.raises(ValueError, match="penalties are not supported with beam search"):
        gen.generate(batch, max_new_tokens=MAX_NEW, num_beams=K, repetition_penalty=1.2)
    sampled = gen.generate(batch, max_new_tokens=MAX_NEW, num_beams=K, temperature=0.8)
    assert sampled.sequences == gen.generate(batch, max_new_tokens=MAX_NEW,
                                             temperature=0.8).sequences
    assert beam.MAX_BEAMS == 16
    with pytest.raises(ValueError, match="num_beams"):
        gen.generate(batch, max_new_tokens=MAX_NEW, num_beams=beam.MAX_BEAMS + 1)
    seqs, _ = beam.beam_generate(model["params"], cfg, {k: v[:1] for k, v in batch.items()},
                                 beam.MAX_BEAMS, 2)
    assert len(seqs[0]) == 2
