"""K2's backward in the PyTorch port against the JAX package, on the CPU.

`flash_attention_bwd_plain` (what `flash_attention_bwd` runs on a CPU
tensor, and what `csrc/flash_bwd.cu` is held against on the card) is
compared with the TPU kernel `_flash_bwd_pallas` in interpret mode, and
`FlashAttention` through `torch.autograd.grad` with `jax.grad` through
`mha_flash(..., interpret=True)` (GQA by head repeat there, by group sum
here). Inputs are made with numpy from a seed. fp32 on both sides; the
sums run in another order, so values agree to 2e-5 (relative and
absolute), the bound the JAX package's own flash tests use for fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.ops.flash_attention import _flash_bwd_pallas, _flash_fwd, mha_flash
from tokenpacker_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(n, tq, tk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((n, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n, tk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((n, tq, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("n,tq,tk,h,causal", [
    (1, 100, 100, 2, True),  # ragged T (not a multiple of the 128 block)
    (2, 40, 100, 2, True),  # Tq < Tk: queries aligned to the end of the keys
    (1, 100, 40, 2, True),  # Tq > Tk: the first 60 rows see no key
    (1, 70, 70, 2, False),
])
def test_bwd_plain_matches_pallas_interpret(n, tq, tk, h, causal):
    """Same o and lse (the TPU kernel's forward) into both backwards."""
    q, k, v, do = _inputs(n, tq, tk, h, h, 32, seed=tq + tk)
    o, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, None,
                        128, 128, True)
    lse = np.asarray(res[-1])
    want = _flash_bwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, jnp.asarray(lse),
                             jnp.asarray(do), causal, None, 128, 128, True)
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)), causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    if tq > tk:
        # Rows that see no key get zero gradients. The port's forward marks
        # them lse = +inf, o = 0; the TPU kernel's forward leaves them at
        # lse ~ -1e30 (its masked logits are finite, so its +inf sentinel
        # never fires: ROADMAP R8). Both backwards zero them either way.
        assert not got[0][:, : tq - tk].any()
        _, port_lse = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
        assert torch.isinf(port_lse.view(n, h, tq)[:, :, : tq - tk]).all()
        port = flash_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                         torch.from_numpy(np.array(o)), port_lse,
                                         torch.from_numpy(do), causal)
        for g, w in zip(port, got):
            np.testing.assert_allclose(g.numpy()[:, tq - tk:], w.numpy()[:, tq - tk:], **TOL)


@pytest.mark.parametrize("tq,tk,h,hkv", [(50, 50, 4, 2), (30, 90, 4, 1), (64, 64, 4, 4)])
def test_autograd_matches_jax_grad_through_mha_flash(tq, tk, h, hkv):
    """GQA: JAX repeats the kv heads and sums their gradients back; the
    port sums over each group of query heads."""
    q, k, v, do = _inputs(2, tq, tk, h, hkv, 16, seed=h + hkv)

    def loss(q, k, v):
        return (mha_flash(q, k, v, causal=True, interpret=True) * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = flash_attention_bwd.launches
    o = FlashAttention.apply(qt, kt, vt, True)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert flash_attention_bwd.launches == before  # CPU tensors run the plain version
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def _softmax_attention(q, k, v, causal):
    """Autograd's own derivative of the textbook formula (float64)."""
    n, tq, h, d = q.shape
    tk, g = k.shape[1], h // k.shape[2]
    kr, vr = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("nqhd,nkhd->nhqk", q, kr) * d**-0.5
    if causal:
        visible = torch.arange(tk)[None, :] <= torch.arange(tq)[:, None] + (tk - tq)
        s = s.masked_fill(~visible, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    return torch.einsum("nhqk,nkhd->nqhd", p, vr)


@pytest.mark.parametrize("tq,tk,hkv,causal", [(13, 13, 2, True), (10, 4, 4, True),
                                             (5, 9, 1, True), (7, 7, 2, False)])
def test_autograd_equals_the_plain_formula(tq, tk, hkv, causal):
    q, k, v, do = (torch.from_numpy(x).double() for x in _inputs(2, tq, tk, 4, hkv, 16, seed=tq))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(_softmax_attention(*leaves, causal), leaves, do)
    leaves32 = [x.float().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves32, causal), leaves32, do.float())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), **TOL)


def test_plain_forward_is_not_in_place_on_its_softmax():
    """The plain forward can sit under autograd without an in-place op on
    the softmax output (autograd's version check would raise)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 12, 8, 2, 2, 16, seed=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    lse = flash_attention(q, k, v, causal=True)[1]
    for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, o.detach(), lse, do)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
