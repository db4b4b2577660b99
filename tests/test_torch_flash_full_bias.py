"""K2's full-bias form in the PyTorch port against the JAX package, on the
CPU, fp32, on the same numpy inputs: the plain forward against
`flash_attention(q, k, v, bias [N|1, H|1, Tq, Tk], ..., interpret=True)`,
and `FlashAttention.apply` under autograd (the plain forward, then
`flash_attention_bwd_reference`) against `jax.grad` through it, the bias's
gradient included, summed over its broadcast axes.

Tolerances, as the JAX package's own flash tests hold the kernel against
its reference (`tests/test_flash_attention.py`): forward 2e-5, gradients
2e-4 (fp32, sums in another order).

Rows whose biased logits all lie below the TPU kernel's NEG_INF (-1e30):
the port gives o = 0 and lse = +inf, the JAX kernel's rule where every key
it visits is a key of the row. Where its visited blocks also hold keys it
masks itself (the causal mask, or padding of Tk to its 128-key block),
those enter its softmax at -1e30 and the row gets lse = -1e30 and the mean
of V over them (ROADMAP R9, R8's sibling); on those rows the test asserts
JAX's value and the port's o = 0, lse = +inf side by side, the others
against JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokenpacker_tpu.models import mpt as jax_mpt
from tokenpacker_tpu.ops.flash_attention import _flash_fwd, mha_flash
from tokenpacker_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from tokenpacker_tpu_torch.models import mpt
from tokenpacker_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
F32_MIN = float(np.finfo(np.float32).min)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bias_shape(kind, n, h, tq, tk):
    return (n if "n" in kind else 1, h if "h" in kind else 1, tq, tk)


def _jax_fwd(q, k, v, bias, causal):
    o, res = _flash_fwd(*(jnp.asarray(x) for x in (q, k, v, bias)), causal, None, 128, 128, True)
    return np.asarray(o), np.asarray(res[-1])


def _grads_both(q, k, v, bias, do, causal):
    """(JAX's, the port's) gradients of sum(o * do) for q, k, v and bias."""

    def loss(q, k, v, b):
        return (jax_flash_attention(q, k, v, b, causal, None, 128, 128, True) * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    o = FlashAttention.apply(*leaves[:3], causal, leaves[3])
    got = torch.autograd.grad(o, leaves, _t(do))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("kind", ["11", "n1", "1h", "nh"])
@pytest.mark.parametrize("causal,tq,tk", [(False, 128, 128), (True, 128, 128), (False, 64, 192),
                                          (True, 64, 192), (False, 100, 70)])
def test_full_bias_forward_matches_pallas(kind, causal, tq, tk):
    """o and lse of the plain forward against `_flash_fwd(interpret=True)`
    for each broadcast form of the bias, causal and not, Tq = Tk, Tq < Tk
    (queries aligned to the end of the keys) and ragged Tq > Tk (non-causal
    only: under the causal mask its first rows see no key, R8). The same
    inputs without the bias, or with its last key tile dropped, move o."""
    n, h, d = 2, 4, 32
    q, k, v = _randn((n, tq, h, d), 0), _randn((n, tk, h, d), 1), _randn((n, tk, h, d), 2)
    bias = 2.0 * _randn(_bias_shape(kind, n, h, tq, tk), 3)
    want_o, want_lse = _jax_fwd(q, k, v, bias, causal)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), causal, _t(bias))
    np.testing.assert_allclose(got_o.numpy(), want_o, **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **FWD_TOL)
    dropped = bias.copy()
    dropped[..., -min(64, tk):] = 0
    for lossy in (flash_attention(_t(q), _t(k), _t(v), causal)[0],
                  flash_attention(_t(q), _t(k), _t(v), causal, _t(dropped))[0]):
        assert (lossy - got_o).abs().max() > 1e-2


@pytest.mark.parametrize("kind", ["11", "n1", "1h", "nh"])
@pytest.mark.parametrize("causal", [False, True])
def test_full_bias_grads_match_jax_grad(kind, causal):
    """dq, dk, dv and dbias of `FlashAttention.apply` (plain forward, then
    `flash_attention_bwd_reference`) against `jax.grad` through the JAX
    `flash_attention` (its backward is the XLA `_flash_bwd_reference`);
    dbias keeps the bias's shape, summed over its broadcast axes."""
    n, h, d, tq, tk = 2, 4, 16, 64, 96
    q, k, v = _randn((n, tq, h, d), 10), _randn((n, tk, h, d), 11), _randn((n, tk, h, d), 12)
    do = _randn((n, tq, h, d), 13)
    bias = 2.0 * _randn(_bias_shape(kind, n, h, tq, tk), 14)
    want, got = _grads_both(q, k, v, bias, do, causal)
    assert got[3].shape == bias.shape
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


def test_full_bias_through_gqa_matches_mha_flash():
    """GQA: 4 query heads on 2 kv heads with a per-head full bias, through
    `FlashAttention.apply` (grouped in place) against the JAX `mha_flash`
    (which repeats the kv heads), forward and every gradient."""
    n, tq, tk, d = 2, 64, 128, 16
    q, k, v = _randn((n, tq, 4, d), 20), _randn((n, tk, 2, d), 21), _randn((n, tk, 2, d), 22)
    do = _randn((n, tq, 4, d), 23)
    bias = 2.0 * _randn((n, 4, tq, tk), 24)

    def loss(q, k, v, b):
        return (mha_flash(q, k, v, b, causal=True, interpret=True) * do).sum()

    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    np.testing.assert_allclose(
        FlashAttention.apply(_t(q), _t(k), _t(v), True, _t(bias)).detach().numpy(),
        np.asarray(mha_flash(jq, jk, jv, jb, causal=True, interpret=True)), **FWD_TOL)
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jb)
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves[:3], True, leaves[3]), leaves,
                              _t(do))
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("masked", [F32_MIN, -1e38, -2e30])
def test_fully_masked_rows_match_pallas(masked):
    """Rows whose bias lies below -1e30 on every key (the fp32 minimum,
    which overflows to -inf in the kernel's log2 units, -1e38, and -2e30,
    which does not): o = 0 and lse = +inf, as the JAX kernel gives them
    (non-causal, Tk a multiple of its block), the other rows against JAX;
    every gradient finite and equal to `jax.grad`'s."""
    n, h, d, t = 2, 2, 32, 128
    q, k, v = _randn((n, t, h, d), 30), _randn((n, t, h, d), 31), _randn((n, t, h, d), 32)
    do = _randn((n, t, h, d), 33)
    bias = _randn((n, 1, t, t), 34)
    bias[0, 0, 5] = masked
    bias[1, 0, [0, 77]] = masked
    want_o, want_lse = _jax_fwd(q, k, v, bias, False)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), False, _t(bias))
    assert np.isinf(want_lse.reshape(n, h, t)[0, :, 5]).all()
    np.testing.assert_array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[finite], want_lse[finite], **FWD_TOL)
    np.testing.assert_allclose(got_o.numpy(), want_o, **FWD_TOL)
    assert not got_o[0, 5].any() and not got_o[1, [0, 77]].any()
    want, got = _grads_both(q, k, v, bias, do, False)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal,tk", [(True, 128), (False, 100)])
def test_fully_masked_rows_where_jax_visits_masked_keys(causal, tk):
    """R9: with the causal mask or a Tk that the JAX kernel pads, its
    fully masked row meets its own -1e30 fill: JAX gives it lse = -1e30
    and o = the sum of V over the keys it masks itself in the one 128-key
    block it visits (the causally masked keys; padded keys add zero rows)
    over their count. The port departs from that and gives the row o = 0
    and lse = +inf; both values are asserted, so the departure stays
    visible. Every other row equals JAX."""
    n, h, d, tq = 1, 2, 32, 100
    q, k, v = _randn((n, tq, h, d), 40), _randn((n, tk, h, d), 41), _randn((n, tk, h, d), 42)
    bias = _randn((n, 1, tq, tk), 43)
    bias[0, 0, 60] = F32_MIN
    want_o, want_lse = _jax_fwd(q, k, v, bias, causal)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), causal, _t(bias))
    lse, jlse = got_lse.view(n, h, tq).numpy(), want_lse.reshape(n, h, tq)
    # JAX's value: row 60 sees keys up to 60 + (tk - tq) under the causal
    # mask; the keys past it in its block and the padding to 128 enter at -1e30
    self_masked = np.arange(60 + (tk - tq) + 1, tk) if causal else np.arange(0)
    count = len(self_masked) + (128 - tk)
    np.testing.assert_allclose(jlse[0, :, 60], np.full(h, -1e30, np.float32), **FWD_TOL)
    np.testing.assert_allclose(want_o[0, 60], v[0, self_masked].sum(0) / count, **FWD_TOL)
    assert np.isinf(lse[0, :, 60]).all() and not got_o[0, 60].any()
    rows = np.arange(tq) != 60
    np.testing.assert_allclose(got_o.numpy()[:, rows], want_o[:, rows], **FWD_TOL)
    np.testing.assert_allclose(lse[:, :, rows], jlse[:, :, rows], **FWD_TOL)


def test_prefix_lm_alibi_bias_matches_jax():
    """MPT's prefix-LM mask (`make_prefix_lm_bias`, the port's against the
    JAX package's, bit for bit) plus ALiBi as one [N, H, T, S] bias,
    non-causal (the mask carries the causality), right-padded samples:
    forward and gradients against JAX."""
    n, h, d, t = 2, 4, 16, 96
    lengths, prefixes = np.array([96, 70]), np.array([40, 25])
    positions = np.broadcast_to(np.arange(t), (n, t))
    key_valid = np.arange(t)[None, :] < lengths[:, None]
    got_mask = mpt.make_prefix_lm_bias(_t(positions), _t(key_valid), _t(prefixes), t)
    want_mask = jax_mpt.make_prefix_lm_bias(jnp.asarray(positions), jnp.asarray(key_valid),
                                            jnp.asarray(prefixes), t)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    bias = (got_mask + mpt.alibi_bias(h, t)).numpy()
    assert bias.shape == (n, h, t, t)
    q, k, v = _randn((n, t, h, d), 50), _randn((n, t, h, d), 51), _randn((n, t, h, d), 52)
    do = _randn((n, t, h, d), 53)
    want_o, want_lse = _jax_fwd(q, k, v, bias, False)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), False, _t(bias))
    np.testing.assert_allclose(got_o.numpy(), want_o, **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **FWD_TOL)
    want, got = _grads_both(q, k, v, bias, do, False)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


def test_full_bias_counts_no_launch_on_the_cpu_and_the_bwd_wrapper_refuses_it():
    """On CPU tensors the plain versions run, so no launch is counted; K2's
    backward wrapper takes only the key-only form (the full form's backward
    is `flash_attention_bwd_reference`); a bias of neither shape raises."""
    q = _t(_randn((1, 8, 2, 16), 60))
    bias = _t(_randn((1, 2, 8, 8), 61))
    before = (flash_attention.launches, flash_attention.bias_launches,
              flash_attention.full_bias_launches)
    o, lse = flash_attention(q, q, q, True, bias)
    assert (flash_attention.launches, flash_attention.bias_launches,
            flash_attention.full_bias_launches) == before
    with pytest.raises(ValueError, match="key-only"):
        flash_attention_bwd(q, q, q, o, lse, q, True, bias)
    with pytest.raises(ValueError, match="is neither key-only"):
        flash_attention(q, q, q, True, _t(_randn((1, 2, 8, 7), 62)))
