"""The MPT family of the PyTorch port against the JAX package, on the CPU
at the tiny geometry (d_model 64, 4 heads of 16, 2 layers, vocab 256:
`tests/test_mpt.py`, `tests/test_vlm_mpt.py`), fp32, on the same numpy
inputs and the same seeded weights: ALiBi's helpers, K2's key-only bias
(forward and backward) and K3's slopes (the plain versions against the
Pallas kernels in interpret mode), `mpt_apply` on every route,
`import_mpt`, `vlm_loss` and its gradients, greedy generation (plain and
speculative), the dense continuous batcher, `Trainer.train()` in both
stages, the init schemes and what MPT refuses.

Tolerances, each with its reason, where it is used: kernels 2e-5 (fp32,
sums in another order, the bound of the JAX package's own flash tests);
hidden states and logits through 2 layers 1e-4; ALiBi's helpers equal to
fp32 rounding (1e-6 relative).
"""

import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tokenpacker_tpu import generate as jax_generate
from tokenpacker_tpu.config import LMConfig as JaxLMConfig
from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tokenpacker_tpu.data.dataset import SupervisedDataset as JaxDataset
from tokenpacker_tpu.io import tokenizer as jax_tokenizer
from tokenpacker_tpu.models import init_fns as jax_init_fns
from tokenpacker_tpu.models import mpt as jax_mpt
from tokenpacker_tpu.models.llama import KVCache as JaxKVCache
from tokenpacker_tpu.models.llama import make_attention_bias as jax_attention_bias
from tokenpacker_tpu.models.vlm import init_vlm as jax_init_vlm
from tokenpacker_tpu.models.vlm import vlm_loss as jax_vlm_loss
from tokenpacker_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from tokenpacker_tpu.ops.flash_attention import (
    _flash_bwd_pallas,
    _flash_fwd,
    attention_reference,
)
from tokenpacker_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from tokenpacker_tpu.train import step as jax_step
from tokenpacker_tpu.train.trainer import RunConfig as JaxRunConfig
from tokenpacker_tpu.train.trainer import Trainer as JaxTrainer
from tokenpacker_tpu_torch import generate
from tokenpacker_tpu_torch.config import LMConfig, tiny_vlm_config
from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
from tokenpacker_tpu_torch.io import tokenizer
from tokenpacker_tpu_torch.io.weights import (
    init_vlm_on_device,
    params_from_jax,
    params_to_jax,
    quantize_lm_4bit,
    quantize_lm_int8,
)
from tokenpacker_tpu_torch.models import init_fns, mpt
from tokenpacker_tpu_torch.models.llama import KVCache, make_attention_bias
from tokenpacker_tpu_torch.models.lm_api import lm_apply
from tokenpacker_tpu_torch.models.splice import build_splice_plan
from tokenpacker_tpu_torch.models.vlm import vlm_loss
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
from tokenpacker_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher, PagedContinuousBatcher
from tokenpacker_tpu_torch.train.step import TrainConfig, leaves_with_paths
from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer
from tests.test_trainer import Tok

# fp32, the same function with sums in another order
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
# fp32 through the tower, the projector and 2 MPT layers
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MPT_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, model_family="mpt", alibi=True, tie_word_embeddings=True)
SEP, NEWLINE = 7, 8  # stand-in ids of "," and "\n" in the tiny vocabulary


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    """Seeded tiny MPT VLM weights (random norm scales and biases, so a
    dropped or swapped norm shows), as port tensors and as the JAX tree."""
    cfg = tiny_vlm_config(lm=LMConfig(**MPT_LM))
    params = init_vlm_on_device(cfg, seed=11, device="cpu", dtype=torch.float32)
    tree = params_to_jax(params)
    return {"cfg": cfg, "cfg_j": jax_tiny_config(lm=JaxLMConfig(**MPT_LM)), "params": params,
            "tree": tree}


def _request(cfg, seed, extra=0, pad_to=32, repeat=False):
    """One image and a short prompt (a repeated run of text with `repeat`,
    so that prompt lookup finds drafts), as a batch-1 splice plan."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    text = [40, 41, 42, 40, 41, 42, 40, 41] if repeat else list(30 + np.arange(2 + extra))
    ids = np.array([1, 17 + seed, IMAGE_TOKEN_INDEX, *text], np.int64)
    plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, "single", SEP, NEWLINE, 0,
                             pad_to=pad_to)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}


def _batch(cfg):
    """Two right-padded requests of different lengths, padded to 24."""
    reqs = [_request(cfg, 0, extra=5, pad_to=24), _request(cfg, 1, extra=1, pad_to=24)]
    return {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}


# -- ALiBi ------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [4, 6, 32])
def test_alibi_helpers_match_jax(heads):
    """Slopes (6 heads: the interleave of a count that is not a power of
    two), the key-only bias, the bias from token positions and the
    prefix-LM bias: equal to the JAX package's to fp32 rounding."""
    np.testing.assert_allclose(mpt.alibi_slopes(heads).numpy(),
                               np.asarray(jax_mpt.alibi_slopes(heads)), rtol=1e-6)
    np.testing.assert_allclose(mpt.alibi_bias(heads, 19).numpy(),
                               np.asarray(jax_mpt.alibi_bias(heads, 19)), rtol=1e-6)
    kpos = np.random.default_rng(heads).integers(0, 500, (3, 17))
    np.testing.assert_allclose(mpt.alibi_bias_from_positions(heads, _t(kpos)).numpy(),
                               np.asarray(jax_mpt.alibi_bias_from_positions(heads, jnp.asarray(kpos))),
                               rtol=1e-6)
    positions = np.arange(4, 9)[None].repeat(2, 0)
    key_valid = np.arange(12)[None] < np.array([[10], [12]])
    prefix = np.array([3, 7])
    got = mpt.make_prefix_lm_bias(_t(positions), _t(key_valid), _t(prefix), 12)
    want = jax_mpt.make_prefix_lm_bias(jnp.asarray(positions), jnp.asarray(key_valid),
                                       jnp.asarray(prefix), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_six_head_slopes_interleave():
    """The interleave itself: 8 slopes 2^-1..2^-8, odd entries then even."""
    want = [2.0**-e for e in (2, 4, 6, 8, 1, 3)]
    np.testing.assert_allclose(mpt.alibi_slopes(6).numpy(), want, rtol=1e-6)


# -- K2's key-only bias -------------------------------------------------------------


def _key_bias(h, tk, seed, heads_in_bias=None):
    """MPT's ALiBi plus noise, [1, H|1, 1, Tk], so that a bias indexed by
    the wrong head or key shows."""
    hb = heads_in_bias or h
    return (np.asarray(jax_mpt.alibi_bias(hb, tk)) + 0.3 * _randn((1, hb, 1, tk), seed))


@pytest.mark.parametrize("tq,tk,h,hb", [
    (100, 100, 2, 2),  # ragged T (not a multiple of the kernel's block)
    (40, 100, 4, 4),  # Tq < Tk: queries aligned to the end of the keys
    (100, 40, 2, 1),  # Tq > Tk: the first 60 rows see no key; one bias row for all heads
    (128, 128, 4, 4),
])
def test_flash_bias_plain_forward_matches_pallas(tq, tk, h, hb):
    """o and lse of the plain forward against `_flash_fwd(interpret=True)`
    with a key-only bias, o against `attention_reference` too; a row with
    no key: o = 0, lse = +inf in the port (the TPU kernel leaves such rows
    at lse ~ -1e30, ROADMAP R8), so those rows are compared apart."""
    n, d = 2, 32
    q, k, v = _randn((n, tq, h, d), 0), _randn((n, tk, h, d), 1), _randn((n, tk, h, d), 2)
    bias = _key_bias(h, tk, 3, hb)
    want_o, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                             True, None, 128, 128, True)
    ref = attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jnp.asarray(bias), causal=True)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), True, _t(bias))
    seen = max(tq - tk, 0)  # rows [0, seen) see no key
    np.testing.assert_allclose(got_o.numpy()[:, seen:], np.asarray(want_o)[:, seen:], **KERNEL_TOL)
    np.testing.assert_allclose(got_o.numpy()[:, seen:], np.asarray(ref)[:, seen:], **KERNEL_TOL)
    lse = got_lse.view(n, h, tq)
    np.testing.assert_allclose(lse.numpy()[:, :, seen:],
                               np.asarray(res[-1]).reshape(n, h, tq)[:, :, seen:], **KERNEL_TOL)
    assert not got_o[:, :seen].any() and torch.isinf(lse[:, :, :seen]).all()
    # without the bias the output moves: the test sees a lost bias
    plain, _ = flash_attention(_t(q), _t(k), _t(v), True)
    assert (plain - got_o)[:, seen:].abs().max() > 1e-2


@pytest.mark.parametrize("tq,tk,h", [(100, 100, 2), (40, 100, 2), (100, 40, 2)])
def test_flash_bias_plain_backward_matches_pallas(tq, tk, h):
    """The plain backward against `_flash_bwd_pallas(interpret=True,
    bias=...)` from the same o and lse (the TPU kernel's forward)."""
    n, d = 1, 32
    q, k, v, do = (_randn(s, i) for i, s in enumerate(
        [(n, tq, h, d), (n, tk, h, d), (n, tk, h, d), (n, tq, h, d)]))
    bias = _key_bias(h, tk, 4)
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    o, res = _flash_fwd(jq, jk, jv, jb, True, None, 128, 128, True)
    lse = np.asarray(res[-1])
    want = _flash_bwd_pallas(jq, jk, jv, o, jnp.asarray(lse), jnp.asarray(do), True, None, 128,
                             128, True, bias=jb)
    got = flash_attention_bwd_plain(*(_t(x) for x in (q, k, v, o, lse, do)), True, _t(bias))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL, err_msg=name)
    # a recompute without the bias gives other gradients
    lossy = flash_attention_bwd_plain(*(_t(x) for x in (q, k, v, o, lse, do)), True)
    assert max((a - b).abs().max().item() for a, b in zip(lossy, got)) > 1e-2


@pytest.mark.parametrize("tq,tk", [(50, 50), (30, 90)])
def test_flash_bias_autograd_matches_jax_grad(tq, tk):
    """`FlashAttention.apply(q, k, v, True, bias)` under autograd against
    `jax.grad` through the JAX `flash_attention(bias=..., interpret=True)`;
    the bias gets no gradient (None), as the JAX custom_vjp gives zeros."""
    n, h, d = 2, 4, 16
    q, k, v, do = (_randn(s, 10 + i) for i, s in enumerate(
        [(n, tq, h, d), (n, tk, h, d), (n, tk, h, d), (n, tq, h, d)]))
    bias = _key_bias(h, tk, 5)

    def loss(q, k, v):
        return (jax_flash_attention(q, k, v, bias=jnp.asarray(bias), causal=True,
                                    interpret=True) * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    bt = _t(bias).requires_grad_()
    before = (flash_attention.bias_launches, flash_attention_bwd.bias_launches)
    o = FlashAttention.apply(qt, kt, vt, True, bt)
    got = torch.autograd.grad(o, (qt, kt, vt, bt), _t(do), allow_unused=True)
    # CPU tensors run the plain versions: no launch is counted
    assert (flash_attention.bias_launches, flash_attention_bwd.bias_launches) == before
    assert got[3] is None
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL, err_msg=name)


def test_flash_bias_shape_is_checked():
    """A bias that is neither key-only [1, H|1, 1, Tk] nor full [N|1, H|1,
    Tq, Tk] raises (the full form is `tests/test_torch_flash_full_bias.py`'s)."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="key-only"):
        flash_attention(q, q, q, True, torch.zeros(1, 2, 8, 7))
    with pytest.raises(ValueError, match="key-only"):
        flash_attention(q, q, q, True, torch.zeros(1, 3, 1, 8))


# -- K3's slopes --------------------------------------------------------------------


@pytest.mark.parametrize("span_start", [0, 24])
def test_decode_alibi_plain_matches_pallas(span_start):
    """The plain version against `decode_attention(..., slopes=...,
    interpret=True)`: with span_start > 0 the decoded span's keys sit at
    compacted token positions (kpos - span_start + length)."""
    n, h, d, s = 3, 4, 32, 40
    q, ck, cv = _randn((n, h, d), 0), _randn((n, s, h, d), 1), _randn((n, s, h, d), 2)
    lengths = np.array([5, 17, 24], np.int32) if span_start else np.array([5, 17, 40], np.int32)
    needed = np.full(n, span_start + 3, np.int32) if span_start else lengths
    slopes = np.asarray(jax_mpt.alibi_slopes(h)) * 8  # steeper, so positions matter
    args = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths),
            jnp.asarray(needed))
    want = jax_decode_attention(*args, jnp.asarray(slopes), groups=1, span_start=span_start,
                                interpret=True)
    got = decode_attention(_t(q), _t(ck), _t(cv), _t(lengths), _t(needed), span_start, _t(slopes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    without = decode_attention(_t(q), _t(ck), _t(cv), _t(lengths), _t(needed), span_start)
    assert (without - got).abs().max() > 1e-2


# -- the model ----------------------------------------------------------------------


def _jax_hidden_no_cache(tree, cfg_j, emb, lengths):
    n, t, _ = emb.shape
    key_valid = np.arange(t)[None] < lengths[:, None]
    bias = jax_attention_bias(jnp.broadcast_to(jnp.arange(t), (n, t)), jnp.asarray(key_valid),
                              0, t)
    return jax_mpt.mpt_apply(tree, cfg_j, jnp.asarray(emb), bias)[0]


def test_mpt_apply_without_cache_matches_jax(model):
    """The cache-free path (K2's ALiBi form) against JAX's masked `_sdpa`
    over the same right-padded batch, on the valid rows."""
    cfg, tree = model["cfg"].lm, model["tree"]["lm"]
    emb = _randn((2, 12, 64), 3)
    lengths = np.array([12, 7])
    want = _jax_hidden_no_cache(tree, model["cfg_j"].lm, emb, lengths)
    got = mpt.mpt_apply(model["params"]["lm"], cfg, _t(emb))
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :ln].numpy(), np.asarray(want)[i, :ln], **LOGIT_TOL)


def test_mpt_prefill_and_decode_over_a_cache_match_jax(model):
    """Prefill into a cache (K2's ALiBi form), then decode steps through
    K3's slopes form in the bucketed layout (the decoded span after the
    padded prompt) against JAX's `mpt_apply` with `key_positions`."""
    cfg, cfg_j = model["cfg"].lm, model["cfg_j"].lm
    lm, tree = model["params"]["lm"], model["tree"]["lm"]
    n, l, s = 2, 10, 16
    lengths = np.array([10, 6], np.int32)
    emb = _randn((n, l, 64), 4)
    cache = KVCache.create(cfg, n, s, torch.float32)
    got = mpt.mpt_apply(lm, cfg, _t(emb), cache)
    jc = JaxKVCache.create(cfg_j, n, s, jnp.float32)
    key_valid = np.arange(s)[None] < lengths[:, None]
    bias = jax_attention_bias(jnp.broadcast_to(jnp.arange(l), (n, l)), jnp.asarray(key_valid), 0, s)
    want, jc = jax_mpt.mpt_apply(tree, cfg_j, jnp.asarray(emb), bias, jc)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(got[i, :ln].numpy(), np.asarray(want)[i, :ln], **LOGIT_TOL)
    for step in range(3):
        x = _randn((n, 1, 64), 20 + step)
        needed = np.full(n, l + step + 1, np.int32)
        got = mpt.mpt_apply(lm, cfg, _t(x), cache, decode_info=(_t(lengths), _t(needed), l))
        key = np.arange(s)[None]
        ok = (key < lengths[:, None]) | ((key >= l) & (key <= l + step))
        jbias = jnp.where(jnp.asarray(ok)[:, None, None, :], 0.0, -1e30).astype(jnp.float32)
        kpos = np.where(key >= l, key - l + lengths[:, None], key)
        want, jc = jax_mpt.mpt_apply(tree, cfg_j, jnp.asarray(x), jbias, jc._replace(length=l + step),
                                     key_positions=jnp.asarray(kpos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_flash_route_equals_the_einsum_route(model):
    """The same tokens through K2's key-only ALiBi form (no cache) and
    through `sdpa` over a cache with `attn_bias` and ALiBi over the slot
    positions (the chunk route) give the same hidden states on valid rows:
    ALiBi over keys is shift-invariant, and no valid query sees a pad key."""
    cfg, lm = model["cfg"].lm, model["params"]["lm"]
    n, t, s = 2, 11, 16
    lengths = torch.tensor([11, 5])
    emb = _t(_randn((n, t, 64), 6))
    flash = mpt.mpt_apply(lm, cfg, emb)
    cache = KVCache.create(cfg, n, s, torch.float32)
    key_valid = torch.arange(s)[None] < lengths[:, None]
    bias = make_attention_bias(torch.arange(t).expand(n, t), key_valid)
    chunk = lm_apply(lm, cfg, emb, None, cache, attn_bias=bias)
    for i, ln in enumerate(lengths.tolist()):
        torch.testing.assert_close(chunk[i, :ln], flash[i, :ln], **LOGIT_TOL)


def test_import_mpt_matches_jax():
    """A random HF-named state dict through both importers."""
    cfg = mpt.mpt_config(d_model=64, n_heads=4, n_layers=2, vocab_size=128)
    rng = np.random.default_rng(7)
    sd = {"transformer.wte.weight": rng.standard_normal((128, 64)),
          "transformer.norm_f.weight": rng.standard_normal(64)}
    for i in range(2):
        b = f"transformer.blocks.{i}"
        sd.update({f"{b}.norm_1.weight": rng.standard_normal(64),
                   f"{b}.attn.Wqkv.weight": rng.standard_normal((192, 64)),
                   f"{b}.attn.out_proj.weight": rng.standard_normal((64, 64)),
                   f"{b}.norm_2.weight": rng.standard_normal(64),
                   f"{b}.ffn.up_proj.weight": rng.standard_normal((256, 64)),
                   f"{b}.ffn.down_proj.weight": rng.standard_normal((64, 256))})
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    got = params_to_jax(mpt.import_mpt(sd, cfg))
    want = jax_mpt.import_mpt(sd, jax_mpt.mpt_config(d_model=64, n_heads=4, n_layers=2,
                                                     vocab_size=128))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _train_batch(cfg, seed):
    """A labelled, right-padded batch (numpy for JAX, tensors for the port)."""
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for i in range(2):
        text = rng.integers(3, cfg.lm.vocab_size, 5 + 2 * i)
        ids.append(np.concatenate([[1, 5, IMAGE_TOKEN_INDEX], text]).astype(np.int64))
        labels.append(np.concatenate([[IGNORE_INDEX] * 3, text]).astype(np.int64))
    plan = build_splice_plan(ids, [[(1, 1)]] * 2, cfg.tokens_per_view, labels=labels, pad_to=24)
    s = cfg.vision.image_size
    np_batch = {"images": rng.standard_normal((2, s, s, 3)).astype(np.float32),
                "token_ids": plan.token_ids, "is_image": plan.is_image,
                "image_slot": plan.image_slot,
                "positions": np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32),
                "key_valid": plan.attn_mask, "labels": plan.labels}
    port = {k: _t(v) for k, v in np_batch.items() if k != "key_valid"}
    for k in ("token_ids", "image_slot", "positions", "labels"):
        port[k] = port[k].long()
    return {k: jnp.asarray(v) for k, v in np_batch.items()}, port


def test_vlm_loss_and_grads_match_jax(model):
    """Loss within 1e-5 relative; every projector and LM gradient within
    1e-4 relative plus 1e-5 of its leaf's largest magnitude (fp32 through
    the backward of 2 layers). The tied `wte` takes both its gradients."""
    cfg = model["cfg"]
    jb, pb = _train_batch(cfg, 0)
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: jax_vlm_loss(p, model["cfg_j"], jb), has_aux=True)(model["tree"])
    params = params_from_jax(model["tree"], cfg)
    named = [(path, p) for path, p in leaves_with_paths(params) if path[0] != "vision"]
    for _, p in named:
        p.requires_grad_(True)
    loss, _ = vlm_loss(params, cfg, pb)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for (path, _), g in zip(named, grads):
        # the JAX tree stacks the layers on a leading axis: lm/layers/i/... is
        # lm/layers/...[i] there
        keys = path[:2] + path[3:] if "layers" in path else path
        w = want_g
        for key in keys:
            w = w[key]
        w = np.asarray(w)[path[2]] if "layers" in path else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg="/".join(map(str, path)))
    wte = dict(zip([p for p, _ in named], grads))[("lm", "wte")]
    assert wte.abs().sum() > 0


# -- serving --------------------------------------------------------------------------


def test_prefill_and_decode_steps_match_jax(model):
    """`generate.prefill` and 3 `decode_step`s (K3's slopes form over the
    bucketed layout) against the JAX engine's logits."""
    cfg, cfg_j, params, tree = model["cfg"], model["cfg_j"], model["params"], model["tree"]
    batch = _batch(cfg)
    l, s_max = 24, 28
    jl, jc = jax_generate.prefill(tree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), s_max)
    tl, tc = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), s_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    lengths = _t(batch["lengths"])
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(3):
        jl, jc = jax_generate.decode_step(tree, cfg_j, jc, jnp.asarray(tok),
                                          jnp.asarray(batch["lengths"]),
                                          jnp.asarray(step, jnp.int32), l)
        tl, tc = generate.decode_step(params, cfg, tc, _t(tok).long(), lengths, step, l)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_generator_tokens_equal_jax(model):
    """Greedy tokens of a batch of 2 equal the JAX Generator's; batch 1
    with `speculative=3` equals plain decoding and the JAX engine."""
    cfg, params = model["cfg"], model["params"]
    batch = _batch(cfg)
    got = generate.Generator(params, cfg).generate(batch, max_new_tokens=10)
    want = jax_generate.Generator(model["tree"], model["cfg_j"]).generate(batch, max_new_tokens=10)
    assert got.sequences == want.sequences
    one = _request(cfg, 3, repeat=True)
    gen = generate.Generator(params, cfg)
    spec = gen.generate(one, max_new_tokens=12, speculative=3)
    plain = gen.generate(one, max_new_tokens=12)
    want = jax_generate.Generator(model["tree"], model["cfg_j"]).generate(one, max_new_tokens=12)
    assert spec.sequences == plain.sequences == want.sequences
    assert spec.stats["verify_rounds"] > 0


@pytest.mark.parametrize("mode", ["plain", "chunked speculative"])
def test_continuous_batcher_tokens_equal_generator(model, mode):
    """3 requests through 2 slots (a mid-flight admission): whole-prompt
    or chunked (chunks of 8) admissions, plain steps (K3's slopes form) or
    verify rounds, equal to each request's `Generator` tokens."""
    cfg, params = model["cfg"], model["params"]
    reqs = [_request(cfg, 0, repeat=True), _request(cfg, 1, extra=3), _request(cfg, 2, extra=6)]
    want = [generate.Generator(params, cfg).generate(r, max_new_tokens=6).sequences[0]
            for r in reqs]
    kw = {} if mode == "plain" else {"prefill_chunk_size": 8, "speculative_k": 3}
    batcher = ContinuousBatcher(params, cfg, device="cpu", num_slots=2, max_seq_len=64, **kw)
    batcher.start()
    try:
        got = [f.result(timeout=300) for f in [batcher.submit(r, 6) for r in reqs]]
    finally:
        batcher.stop()
    assert got == want
    if mode != "plain":
        assert batcher.stats["verify_rounds"] > 0


# -- training ---------------------------------------------------------------------------


@pytest.fixture
def tiny_data(tmp_path):
    """8 image records of 40x52 pixels with short answers."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(
            img_dir / f"im{i}.png")
        records.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat is this"},
            {"from": "gpt", "value": f"object {i}"}]})
    (tmp_path / "data.json").write_text(json.dumps(records))
    return str(tmp_path / "data.json"), str(img_dir)


def _cropped(base, size):
    class Cropped(base):
        """Crops the 336 pad-mode view to the tiny tower's input size."""

        def __getitem__(self, i):
            item = super().__getitem__(i)
            item["image"] = item["image"][:, :, :size, :size].copy()
            return item

    return Cropped


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_trainer_matches_jax_trainer(model, tiny_data, tmp_path, stage, caplog):
    """Two steps (2 epochs of one batch of 8) of each stage from the same
    weights: the losses equal the JAX Trainer's as it logs them (4
    decimals), the trained parameters within 1e-4 relative plus 5e-5 (5%
    of the peak lr; Adam divides by the root of the second moment)."""
    cfg, cfg_j = model["cfg"], model["cfg_j"]
    data_path, img_dir = tiny_data
    size = cfg.vision.image_size
    version = "plain" if stage == "pretrain" else "v1"
    tcfg = TrainConfig(stage=stage, learning_rate=1e-3)
    common = dict(num_train_epochs=2, save_steps=100, seq_pad_to=64, seed=3)
    jds = _cropped(JaxDataset, size)(data_path, Tok(), image_folder=img_dir, version=version)
    jt = JaxTrainer(cfg_j, jax_step.TrainConfig(**dataclasses.asdict(tcfg)),
                    JaxRunConfig(output_dir=str(tmp_path / "jax"), per_device_batch_size=1,
                                 **common), jax.tree.map(jnp.asarray, model["tree"]), jds, Tok())
    with caplog.at_level("INFO"):
        want = jax.device_get(jt.train())
    jax_losses = [float(x) for x in re.findall(r"step \d+/\d+ loss ([0-9.]+)", caplog.text)]
    ds = _cropped(SupervisedDataset, size)(data_path, Tok(), image_folder=img_dir, version=version)
    trainer = Trainer(cfg, tcfg, RunConfig(output_dir=str(tmp_path / "port"),
                                           per_device_batch_size=8, **common),
                      params_from_jax(model["tree"], cfg), ds, Tok(), device="cpu")
    got = params_to_jax(trainer.train())
    losses = [r["loss"] for r in trainer.history]
    assert len(jax_losses) == 2 and np.allclose(losses, jax_losses, atol=1e-4)
    for part in ("projector", "lm"):
        for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(got[part]),
                                jax.tree.leaves(want[part])):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=5e-5,
                                       err_msg=f"{part}{path}")
    lm_moved = any(np.abs(a - np.asarray(b)).max() > 0 for a, b in
                   zip(jax.tree.leaves(got["lm"]), jax.tree.leaves(model["tree"]["lm"])))
    assert lm_moved == (stage == "finetune")


# -- init schemes --------------------------------------------------------------------


@pytest.mark.parametrize("scheme", jax_init_fns.INIT_SCHEMES)
def test_init_schemes_match_jax_distributions(scheme):
    """The same 10 names; per scheme the std of a [512, 384] kernel within
    3% of the JAX initializer's and of its formula, and the truncated ones
    within 2 std (the JAX package's truncation), on an MPT tree whose norms
    stay as they were."""
    assert init_fns.INIT_SCHEMES == jax_init_fns.INIT_SCHEMES
    kw = dict(d_model=64, n_layers=2)
    shape = (512, 384)
    got = init_fns.make_init(scheme, **kw)(shape, torch.Generator().manual_seed(0))
    want = np.asarray(jax_init_fns._make(scheme, **kw)(jax.random.PRNGKey(0), shape))
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.std().item(), want.std(), rtol=0.03)
    if scheme in ("baseline_", "default_", "small_init_", "neox_init_", "trunc_normal_"):
        std = {"small_init_": (2 / (5 * 64)) ** 0.5, "neox_init_": 2 / (2 * 64**0.5)}.get(scheme,
                                                                                       0.02)
        assert got.abs().max().item() <= 2 * std + 1e-7
        assert abs(np.abs(want).max() - got.abs().max().item()) < 0.05 * std
    params = mpt.init_mpt(mpt.mpt_config(d_model=64, n_heads=4, n_layers=2, vocab_size=128),
                          torch.Generator().manual_seed(1))
    p = init_fns.reinit_kernels(params, torch.Generator().manual_seed(2), scheme, **kw)
    w = p["layers"][0]["attn"]["wqkv"]["kernel"]
    assert torch.isfinite(w).all() and w.std() > 0
    assert not torch.equal(w, params["layers"][0]["attn"]["wqkv"]["kernel"])
    assert p["layers"][0]["norm_1"]["scale"] is params["layers"][0]["norm_1"]["scale"]
    assert p["wte"] is params["wte"]


def test_unknown_init_scheme_raises():
    with pytest.raises(ValueError, match="unknown init scheme"):
        init_fns.make_init("nope_")


# -- what MPT refuses ---------------------------------------------------------------------


def test_mpt_refuses_int8_cache_paged_adapters_remat_and_quantization(model, tiny_data):
    """The JAX package keeps float caches for MPT (it ignores
    TOKENPACKER_KV_CACHE there); the port raises on an int8 cache instead.
    The paged pool and multi-LoRA serving are llama-only in both packages;
    MPT has no rematerialization. Quantization is no longer refused: the
    int8 and 4-bit forms quantize the unfused tree and keep the tied `wte`
    dense, as the JAX api does (their parity with JAX is in
    `test_torch_checkpoint.py`)."""
    cfg, params = model["cfg"], model["params"]
    batch = _batch(cfg)
    with pytest.raises(ValueError, match="model dtype"):
        generate.Generator(params, cfg, kv_cache_dtype=torch.int8).generate(batch, 2)
    with pytest.raises(ValueError, match="model dtype"):
        ContinuousBatcher(params, cfg, device="cpu", kv_cache_dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="llama-only"):
        PagedContinuousBatcher(params, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="llama-only"):
        ContinuousBatcher(params, cfg, device="cpu", adapters={"a": object()})
    with pytest.raises(ValueError, match="rematerialization"):
        mpt.mpt_apply(params["lm"], cfg.lm, torch.zeros(1, 4, 64), remat="full")
    data_path, img_dir = tiny_data
    ds = SupervisedDataset(data_path, Tok(), image_folder=img_dir)
    with pytest.raises(ValueError, match="rematerialization"):
        Trainer(cfg, TrainConfig(), RunConfig(remat="full"), params, ds, Tok(), device="cpu")
    for quantize in (quantize_lm_int8, quantize_lm_4bit):
        lm = dict(params["lm"], layers=list(params["lm"]["layers"]))
        got = quantize({"lm": lm}, min_size=1024)["lm"]
        assert got["wte"] is params["lm"]["wte"]
        assert isinstance(got["layers"][0]["attn"]["wqkv"]["kernel"], dict)


def test_params_from_jax_carries_a_jax_init_vlm_tree(model):
    """The JAX package's own MPT `init_vlm` tree through `params_from_jax`:
    prefill logits within LOGIT_TOL of the JAX engine's, and equal greedy
    tokens."""
    cfg, cfg_j = model["cfg"], model["cfg_j"]
    tree = jax.tree.map(np.asarray, jax_init_vlm(jax.random.PRNGKey(3), cfg_j))
    params = params_from_jax(tree, cfg)
    assert params_to_jax(params)["lm"]["layers"]["attn"]["wqkv"]["kernel"].shape == (2, 64, 192)
    batch = _batch(cfg)
    want, _ = jax_generate.prefill(tree, cfg_j, jax_generate.device_batch(batch, cfg_j.dtype), 32)
    got, _ = generate.prefill(params, cfg, generate.device_batch(batch, cfg.dtype, "cpu"), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    seqs = generate.Generator(params, cfg).generate(batch, max_new_tokens=6).sequences
    assert seqs == jax_generate.Generator(tree, cfg_j).generate(batch, max_new_tokens=6).sequences


def test_new_modules_import_no_jax():
    """MPT's modules import neither JAX nor the JAX package."""
    code = ("import sys, tokenpacker_tpu_torch.models.mpt, tokenpacker_tpu_torch.models.init_fns, "
            "tokenpacker_tpu_torch.io.tokenizer, tokenpacker_tpu_torch.models.lm_api; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tokenpacker_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


class _StubTokenizer:
    """Enough of a tokenizer for `adapt_tokenizer_for_denoising`: one id per
    added token, in order, and no pad token."""

    def __init__(self):
        self.vocab = {"<unk>": 0}
        self.pad_token = None

    def add_tokens(self, tokens):
        for t in [tokens] if isinstance(tokens, str) else tokens:
            self.vocab.setdefault(t, len(self.vocab))

    @property
    def pad_token_id(self):
        return self.vocab.get(self.pad_token)

    def __call__(self, text, add_special_tokens=True):
        ids = [self.vocab[t] for t in re.findall(r"<extra_id_\d+>", text)]
        return type("Enc", (), {"input_ids": ids})()


def test_adapt_tokenizer_for_denoising_matches_jax():
    got = tokenizer.adapt_tokenizer_for_denoising(_StubTokenizer())
    want = jax_tokenizer.adapt_tokenizer_for_denoising(_StubTokenizer())
    assert got.vocab == want.vocab and got.pad_token == want.pad_token == "<pad>"
    assert got.sentinel_token_ids == want.sentinel_token_ids == list(range(1, 101))
    assert tokenizer.NUM_SENTINELS == jax_tokenizer.NUM_SENTINELS
