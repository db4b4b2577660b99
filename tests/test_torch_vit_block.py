"""K9, the fused CLIP block, against the JAX package on the CPU, fp32 at the
tiny geometry: its plain version against `vit_block(interpret=True)`, the
port's tower with `vit_block=True` against the JAX tower under
TOKENPACKER_VIT_BLOCK=interpret, the int8 tower refused, and greedy tokens
of the Generator with the fused tower against the JAX engine's.

The JAX package reads TOKENPACKER_VIT_BLOCK when it traces, so the
`fused_jax` fixture sets it and clears JAX's caches before and after the
test: a function traced earlier would keep the per-op block, and one
traced here would keep the fused block for later tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IMAGE_TOKEN_INDEX
from tokenpacker_tpu.models import clip_vit as jax_clip
from tokenpacker_tpu.ops.vit_block import vit_block as jax_vit_block
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_from_jax, params_to_jax
from tokenpacker_tpu_torch.models import clip_vit
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.ops import vit_block as k9

# fp32 on both sides, the same arithmetic in another order: the JAX
# package's own bound for its fused block (tests/test_clip_vit.py)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def model():
    """Seeded tiny weights (random biases and norm scales) in both packages."""
    cfg = tiny_vlm_config()
    tree = params_to_jax(init_vlm_on_device(cfg, seed=6, device="cpu", dtype=torch.float32))
    return jax_tiny_config(), tree, cfg, params_from_jax(tree, cfg)


@pytest.fixture
def fused_jax(monkeypatch):
    monkeypatch.setenv("TOKENPACKER_VIT_BLOCK", "interpret")
    jax.clear_caches()
    yield
    monkeypatch.delenv("TOKENPACKER_VIT_BLOCK")
    jax.clear_caches()


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 56, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("layer", [0, 3])
def test_plain_block_matches_jax_interpret(model, layer):
    """One block on [3, 17, 32] hidden states (17 = the tiny tower's 16
    patches + CLS) and on a ragged [2, 9, 32]."""
    cfg_j, tree, cfg, params = model
    p_j = jax.tree.map(lambda a: a[layer], tree["vision"]["layers"])
    p = params["vision"]["layers"][layer]
    for shape, seed in (((3, 17, 32), 1), ((2, 9, 32), 2)):
        x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        want = jax_vit_block(jnp.asarray(x), p_j, cfg_j.vision.num_attention_heads,
                             cfg_j.vision.layer_norm_eps, interpret=True)
        got = k9.vit_block(torch.from_numpy(x), p, cfg.vision.num_attention_heads,
                           cfg.vision.layer_norm_eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tower_with_vit_block_matches_jax(model, fused_jax):
    cfg_j, tree, cfg, params = model
    imgs = _images(2, 3)
    before = k9.vit_block.launches
    feats, multi = clip_vit.clip_tower_features(params["vision"], cfg.vision,
                                                torch.from_numpy(imgs), vit_block=True)
    want_f, want_m = jax_clip.clip_tower_features(tree["vision"], cfg_j.vision, jnp.asarray(imgs))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(multi.numpy(), np.asarray(want_m), **TOL)
    assert k9.vit_block.launches == before  # CPU tensors run the plain version


def test_fused_tower_equals_per_op_tower_in_fp32(model):
    """In fp32 the fused block's numerics reduce to the per-op block's."""
    _, _, cfg, params = model
    imgs = torch.from_numpy(_images(2, 4))
    fused = clip_vit.clip_tower_features(params["vision"], cfg.vision, imgs, vit_block=True)
    per_op = clip_vit.clip_tower_features(params["vision"], cfg.vision, imgs)
    for a, b in zip(fused, per_op):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_int8_tower_with_vit_block_raises(model):
    _, _, cfg, params = model
    quantized = clip_vit.quantize_tower_int8(params["vision"])
    with pytest.raises(ValueError, match="dense tower"):
        clip_vit.clip_tower_features(quantized, cfg.vision, torch.from_numpy(_images(1, 5)),
                                     vit_block=True)


def test_generator_tokens_with_vit_block_match_jax(model, fused_jax):
    """Two image requests, 6 greedy tokens each: the port's Generator with
    the fused tower against the JAX engine under TOKENPACKER_VIT_BLOCK."""
    cfg_j, tree, cfg, params = model
    ids = [np.array([1, 17, 23, IMAGE_TOKEN_INDEX, 40, 41, 42], np.int64),
           np.array([1, IMAGE_TOKEN_INDEX, 30, 31], np.int64)]
    plan = build_splice_plan(ids, [[(1, 1)], [(1, 1)]], cfg.tokens_per_view, pad_to=16)
    batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
             "image_slot": plan.image_slot, "lengths": plan.lengths, "images": _images(2, 6)}
    got = generate.Generator(params, cfg, vit_block=True).generate(batch, max_new_tokens=6)
    want = jax_generate.Generator(tree, cfg_j).generate(batch, max_new_tokens=6)
    assert got.sequences == want.sequences
