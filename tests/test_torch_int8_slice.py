"""The int8 HD serving slice end to end on the CPU, in bf16: HD images ->
slice-mode splice -> tower -> projector -> int8-weight prefill into an
int8 KV cache -> greedy decode through K4 (its plain version on the CPU),
against the JAX engine with its fused kernel in interpret mode
(TOKENPACKER_FUSED_DECODE=interpret) and TOKENPACKER_KV_CACHE=int8.

The tiny VLM's LM is the fused-decode test geometry (D=512, 4 heads of
128, F=1024, 2 layers), so the tree is K4-eligible. The JAX side takes
its flash prefill, as on the TPU: both engines attend the prompt's
unquantized k/v in prefill and write int8 rows.

bf16 sums in another order and f32 vs bf16-rounded k*q products:
logits agree within 3e-2 of their largest magnitude, and greedy tokens
agree wherever the JAX top-2 margin exceeds 5x the largest logit gap
(the JAX package's own fused-vs-XLA bound, tests/test_fused_decode.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.models import llama as jax_llama
from tokenpacker_tpu.ops.quantize import fuse_llama_layers, quantize_tree
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.image.processing import process_images
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_from_jax,
    params_to,
    params_to_jax,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models.splice import build_splice_plan

LOGIT_RTOL = 3e-2
MARGIN_FACTOR = 5
SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary
LM = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
          num_attention_heads=4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_vlm_config(lm=LMConfig(**LM), image_aspect_ratio="slice", dtype=torch.bfloat16)
    cfg_j = jax_tiny_config(lm=JaxLMConfig(**LM), image_aspect_ratio="slice", dtype=jnp.bfloat16)
    tree = params_to_jax(init_vlm_on_device(cfg, seed=8, device="cpu", dtype=torch.float32))
    jtree = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    jtree["lm"] = quantize_tree(fuse_llama_layers(jtree["lm"]))  # api.load_8bit
    params = quantize_lm_int8(params_to(params_from_jax(tree, cfg), "cpu", torch.bfloat16))
    assert generate.fused_weights(params, cfg) is True  # K4's plain version on the CPU
    return cfg_j, jtree, cfg, params


@pytest.fixture(scope="module")
def batch(model):
    cfg = model[2]
    rng = np.random.default_rng(3)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((110, 160), (60, 40))]
    crops, blocks = process_images(images, "slice", 9, cfg.vision.image_size)
    ids = [np.array([1, 21, IMAGE_TOKEN_INDEX, 50, 51, 52], np.int64),
           np.array([1, IMAGE_TOKEN_INDEX, 60, 61], np.int64)]
    plan = build_splice_plan(ids, [[b] for b in blocks], cfg.tokens_per_view, "slice", SEP,
                             NEWLINE, pad_to=64)
    assert blocks[0][0] * blocks[0][1] > 1
    return {"token_ids": plan.token_ids, "is_image": plan.is_image, "image_slot": plan.image_slot,
            "lengths": plan.lengths, "images": crops.transpose(0, 2, 3, 1).copy()}


@pytest.fixture
def jax_int8_fused(monkeypatch):
    monkeypatch.setenv("TOKENPACKER_FUSED_DECODE", "interpret")
    monkeypatch.setenv("TOKENPACKER_KV_CACHE", "int8")
    # the TPU engine's prefill: flash attention over the unquantized k/v
    monkeypatch.setattr(jax_llama, "_use_flash_prefill", lambda t: True)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want).max()
    assert diff <= LOGIT_RTOL * np.abs(want).max(), diff
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = top2[..., 1] - top2[..., 0] > MARGIN_FACTOR * diff
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    return decisive


def _replay(model, batch, streams):
    """Prefill, then one decode step per column of `streams` [steps, 2]
    (the same tokens fed to both engines, so a near-tie cannot fork the
    runs). Returns the per-step decisive masks [steps + 1, 2]."""
    cfg_j, jtree, cfg, params = model
    l = batch["token_ids"].shape[1]
    jl, jc = jax_generate.prefill(jtree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), l + 8)
    tl, tc = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), l + 8,
                              kv_cache_dtype=torch.int8)
    assert tc.k.dtype == torch.int8 and tuple(tc.k.shape) == jc.k.shape  # S rounded to 32 alike
    assert jax_generate._fused_decode_mode(jtree, cfg_j, jc) == "interpret"
    decisive = [_close(tl.float(), jl)]
    lengths = torch.from_numpy(batch["lengths"])
    for step, tok in enumerate(np.asarray(streams, np.int32)):
        jl, jc = jax_generate.decode_step(jtree, cfg_j, jc, jnp.asarray(tok),
                                          jnp.asarray(batch["lengths"]),
                                          jnp.asarray(step, jnp.int32), l)
        tl, tc = generate.decode_step(params, cfg, tc, torch.from_numpy(tok).long(), lengths,
                                      step, l)
        decisive.append(_close(tl.float(), jl))
    return np.stack(decisive)


def test_int8_prefill_and_k4_steps_match_jax(model, batch, jax_int8_fused):
    """Prefill logits, then 4 decode steps fed fixed tokens."""
    streams = [np.full((2,), (step * 37 + 11) % 256) for step in range(4)]
    assert _replay(model, batch, streams).any()


def test_int8_greedy_generate_matches_jax(model, batch, jax_int8_fused):
    """The two Generators' greedy tokens: where the prefixes agree, a token
    that differs must come at a step whose JAX top-2 margin is not
    decisive (replayed on the JAX tokens); the runs stop being comparable
    after it."""
    cfg_j, jtree, cfg, params = model
    want = jax_generate.Generator(jtree, cfg_j).generate(batch, max_new_tokens=8, check_every=4)
    got = generate.Generator(params, cfg, kv_cache_dtype=torch.int8).generate(
        batch, max_new_tokens=8, check_every=4)
    assert got.stats["decode_steps"] == 7
    decisive = _replay(model, batch, np.array(want.sequences).T[:-1])
    checked = 0
    for i, (g, w) in enumerate(zip(got.sequences, want.sequences)):
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert not decisive[j, i], (i, j, g, w)
                break
            checked += int(decisive[j, i])
    assert checked >= 8, checked


def test_int8_cache_per_layer_path_serves_gqa(model, batch):
    """A GQA int8 tree is not K4-eligible: its decode steps take the
    per-layer path over the dequantized int8 cache."""
    cfg = dataclasses.replace(model[2], lm=LMConfig(**LM, num_key_value_heads=2))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=1, device="cpu", dtype=torch.bfloat16))
    assert generate.fused_weights(params, cfg) is False
    out = generate.Generator(params, cfg, kv_cache_dtype=torch.int8).generate(
        batch, max_new_tokens=4, check_every=2)
    assert all(len(s) == 4 for s in out.sequences) and torch.isfinite(out.last_logits).all()
