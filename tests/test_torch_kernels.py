"""The port's attention kernels (K1 tower, K2 flash forward, K3 decode).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package's Pallas kernel in interpret mode
and its jnp reference, all in fp32, on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card by
`tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokenpacker_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference,
)
from tokenpacker_tpu.ops.flash_attention import _flash_fwd, attention_reference, mha_flash
from tokenpacker_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

# fp32 on both sides; the sums run in another order: 2e-5 as the JAX
# package's own kernel-vs-einsum tests use
TOL = dict(rtol=2e-5, atol=2e-5)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n,t,w,heads", [(2, 17, 32, 4), (1, 65, 128, 2)])
def test_vit_attention_plain_matches_pallas(n, t, w, heads):
    q, k, v = (_randn((n, t, w), s) for s in range(3))
    want = jax_vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, interpret=True)
    got = vit_attention(_t(q), _t(k), _t(v), heads)  # CPU tensors -> plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(128, 128), (64, 192), (200, 200)])
def test_flash_plain_matches_pallas(causal, tq, tk):
    n, h, d = 2, 2, 64
    q, k, v = _randn((n, tq, h, d), 0), _randn((n, tk, h, d), 1), _randn((n, tk, h, d), 2)
    want_o, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                             causal, None, 128, 128, True)
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[-1]), **TOL)
    ref = attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("t", [64, 77])
def test_flash_plain_gqa_matches_mha_flash(groups, t):
    n, hkv, d = 1, 2, 64
    q = _randn((n, t, hkv * groups, d), 0)
    k, v = _randn((n, t, hkv, d), 1), _randn((n, t, hkv, d), 2)
    want = mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, interpret=True)
    got, _ = flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_plain_fully_masked_rows():
    """Causal with Tq > Tk: the first rows see no key -> o = 0, lse = +inf."""
    q, k, v = _randn((1, 6, 2, 8), 0), _randn((1, 4, 2, 8), 1), _randn((1, 4, 2, 8), 2)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal=True)
    assert torch.all(o[:, :2] == 0) and torch.all(torch.isinf(lse[:, :2]))
    assert torch.isfinite(o).all() and torch.isfinite(lse[:, 2:]).all()


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("span_start", [0, 24])
def test_decode_plain_matches_pallas(groups, span_start):
    n, hkv, d, s = 3, 2, 32, 40
    q = _randn((n, hkv * groups, d), 0)
    ck, cv = _randn((n, s, hkv, d), 1), _randn((n, s, hkv, d), 2)
    lengths = np.array([5, 17, 24], np.int32) if span_start else np.array([5, 17, 40], np.int32)
    needed = np.full(n, span_start + 3, np.int32) if span_start else lengths
    args = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths), jnp.asarray(needed))
    want = jax_decode_attention(*args, groups=groups, span_start=span_start, interpret=True)
    ref = decode_attention_reference(*args, groups=groups, span_start=span_start)
    got = decode_attention(_t(q), _t(ck), _t(cv), _t(lengths), _t(needed), span_start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_decode_plain_ignores_keys_outside_ranges():
    """Keys in the gap [len, span_start) and past `needed` do not matter."""
    n, h, d, s = 2, 2, 16, 48
    q, ck, cv = _randn((n, h, d), 0), _randn((n, s, h, d), 1), _randn((n, s, h, d), 2)
    lengths, needed = _t(np.array([7, 20], np.int32)), _t(np.array([35, 35], np.int32))
    base = decode_attention_plain(_t(q), _t(ck), _t(cv), lengths, needed, span_start=32)
    ck2, cv2 = ck.copy(), cv.copy()
    ck2[0, 7:32] = 1e3
    cv2[:, 35:] = 1e3
    moved = decode_attention_plain(_t(q), _t(ck2), _t(cv2), lengths, needed, span_start=32)
    torch.testing.assert_close(moved, base, rtol=0, atol=0)
