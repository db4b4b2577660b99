"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no card. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` skips `tests/conftest.py`, which sets JAX up.) The first
case of each test is a shape the TokenPacker-7b serving path gives the
kernel; the others cover ragged lengths and groupings at the path's head
sizes (d=64 for the tower, d=128 for the LM), the only ones the kernels
take. K4 (the fused int8 decode step) runs at smaller widths than
Vicuna-7B's with the same head size; `chip_smoke.py` runs it at full
width.
"""

import pytest
import torch

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.io.weights import init_lm_on_device, quantize_lm_int8
from tokenpacker_tpu_torch.models.llama import KVCache
from tokenpacker_tpu_torch.ops import fused_decode as k4
from tokenpacker_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tokenpacker_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=torch.bfloat16)


def _close(got, want):
    """bf16 on the card: the kernels keep fp32 logits and round only the
    probabilities, the plain versions also round the logits, so allow
    1e-2 absolute plus 1e-2 of the largest reference value. Infinite
    entries (lse of a row with no key) must match exactly."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    err = (got[~inf] - want[~inf]).abs().max().item()
    assert err <= 1e-2 + 1e-2 * want[~inf].abs().max().item(), err


def _blocks_close(got, want, tile=64, limit=2e-2):
    """K2's outputs [N, T, H, d], held block by block: the relative RMS
    difference ||got - want|| / ||want|| of every (sample, 64-position
    tile, head) block within `limit`. Unlike `_close` it does not scale
    with the tensor's largest value, so blocks of small values (the last
    keys' dk/dv, late rows' dq) are held as tightly as large ones; bf16
    rounding of P, dS and the outputs gives ~2^-9 per element (K2 at
    the training shape reads 0.0031-0.0075 in `chip_smoke.py`). A block
    that is zero in the plain version must be zero in the kernel's."""
    n, t, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -t % tile)
    num = torch.nn.functional.pad((got.float() - want.float()).square(), pad)
    den = torch.nn.functional.pad(want.float().square(), pad)
    num, den = (x.view(n, -1, tile, h, d).sum((2, 4)) for x in (num, den))
    assert not num[den == 0].any()
    rel = (num[den > 0] / den[den > 0]).sqrt()
    assert rel.max().item() <= limit, rel.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,w,heads", [(2, 577, 1024, 16), (3, 17, 256, 4), (1, 130, 512, 8)])
def test_vit_attention_kernel_matches_plain(cuda, n, t, w, heads):
    q, k, v = (_bf16((n, t, w), s, cuda) for s in range(3))
    _close(vit_attention(q, k, v, heads), vit_attention_plain(q, k, v, heads))


@pytest.mark.cuda
@pytest.mark.parametrize("n,tq,tk,h,hkv,d,causal", [
    (2, 512, 512, 32, 32, 128, True),
    (2, 700, 700, 32, 32, 128, True),
    (2, 700, 700, 32, 8, 128, True),
    (1, 333, 333, 4, 4, 128, False),
    (2, 64, 300, 8, 2, 128, True),  # queries aligned to the end of the keys
    (1, 100, 40, 4, 4, 128, True),  # first 60 rows see no key
    (3, 1, 1, 4, 1, 128, True),
    (1, 17, 17, 8, 4, 128, False),
])
def test_flash_kernel_matches_plain(cuda, n, tq, tk, h, hkv, d, causal):
    q = _bf16((n, tq, h, d), 0, cuda)
    k, v = _bf16((n, tk, hkv, d), 1, cuda), _bf16((n, tk, hkv, d), 2, cuda)
    o, lse = flash_attention(q, k, v, causal=causal)
    want_o, want_lse = flash_attention_plain(q, k, v, causal=causal)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)


@pytest.mark.cuda
@pytest.mark.parametrize("n,tq,tk,h,hkv,causal", [
    (2, 512, 512, 32, 32, True),
    (1, 700, 700, 32, 8, True),
    (1, 333, 333, 4, 4, False),
    (2, 64, 300, 8, 2, True),  # queries aligned to the end of the keys
    (1, 100, 40, 4, 4, True),  # first 60 rows see no key: zero gradients there
    (1, 17, 17, 8, 4, False),
])
def test_flash_bwd_kernel_matches_plain(cuda, n, tq, tk, h, hkv, causal):
    """K2's backward against its plain version (fp32 from the same bf16
    inputs and the kernel forward's o and lse), within _close's and
    _blocks_close's bounds: the kernel rounds P and dS to bf16 as product
    operands. Two calls give the same bits (no float atomics)."""
    q = _bf16((n, tq, h, 128), 0, cuda)
    k, v = _bf16((n, tk, hkv, 128), 1, cuda), _bf16((n, tk, hkv, 128), 2, cuda)
    do = _bf16((n, tq, h, 128), 3, cuda)
    o, lse = flash_attention(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.equal(g, a)
        _close(g, w)
        _blocks_close(g, w)
    if tq > tk:
        assert not got[0][:, : tq - tk].any()


@pytest.mark.cuda
def test_flash_autograd_launches_both_kernels(cuda):
    q = _bf16((1, 256, 8, 128), 0, cuda).requires_grad_()
    k = _bf16((1, 256, 2, 128), 1, cuda).requires_grad_()
    v = _bf16((1, 256, 2, 128), 2, cuda).requires_grad_()
    do = _bf16((1, 256, 8, 128), 3, cuda)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    o = FlashAttention.apply(q, k, v, True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd) == (1, 1)
    o2, lse = flash_attention(q.detach(), k.detach(), v.detach())
    for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, o2, lse, do)):
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,d,span_start", [
    (32, 128, 1000), (32, 128, 0), (8, 128, 1000), (16, 128, 1000), (8, 128, 0), (4, 128, 1000),
])
def test_decode_kernel_matches_plain(cuda, hkv, d, span_start):
    n, s, h = 4, 1040, 32
    q = _bf16((n, h, d), 0, cuda)
    ck, cv = _bf16((n, s, hkv, d), 1, cuda), _bf16((n, s, hkv, d), 2, cuda)
    lengths = torch.tensor([1, 333, 650, 1000], dtype=torch.int32, device=cuda)
    if span_start:
        needed = torch.full((n,), span_start + 7, dtype=torch.int32, device=cuda)
    else:
        needed = torch.tensor([1, 40, 650, 1040], dtype=torch.int32, device=cuda)
    _close(decode_attention(q, ck, cv, lengths, needed, span_start),
           decode_attention_plain(q, ck, cv, lengths, needed, span_start))


@pytest.mark.cuda
def test_decode_kernel_reads_only_valid_keys(cuda):
    """Keys in the gap and past `needed` may hold anything, even NaN."""
    n, s, h, d = 2, 300, 8, 128
    q = _bf16((n, h, d), 0, cuda)
    ck, cv = _bf16((n, s, h, d), 1, cuda), _bf16((n, s, h, d), 2, cuda)
    lengths = torch.tensor([10, 150], dtype=torch.int32, device=cuda)
    needed = torch.tensor([205, 205], dtype=torch.int32, device=cuda)
    want = decode_attention_plain(q, ck, cv, lengths, needed, span_start=200)
    ck[0, 10:200] = float("nan")
    cv[:, 205:] = float("nan")
    got = decode_attention(q, ck, cv, lengths, needed, span_start=200)
    _close(got, want)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _bf16((1, 64, 4, 128), 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q[:, ::2], q, q)
    shifted = _bf16((64 * 4 * 128 + 4,), 1, cuda)[4:].view(1, 64, 4, 128)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, q, q)
    x = _bf16((1, 8, 128), 2, cuda)
    with pytest.raises(RuntimeError, match="not supported"):
        vit_attention(x, x, x, 1)  # head_dim 128: the tower's kernel takes 64
    q64 = _bf16((1, 64, 4, 64), 3, cuda)
    with pytest.raises(RuntimeError, match="not supported"):
        flash_attention(q64, q64, q64)  # head_dim 64: the LM's kernels take 128
    lse64 = torch.zeros((4, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="not supported"):
        flash_attention_bwd(q64, q64, q64, q64, lse64, q64)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_bwd(q, q, q, q, lse64.bfloat16(), q)
    with pytest.raises(RuntimeError, match="not supported"):
        decode_attention(q64[:, 0], q64, q64, torch.ones(1, dtype=torch.int32, device=cuda),
                         torch.ones(1, dtype=torch.int32, device=cuda))


def _k4_inputs(cuda, b, s, int8, layers=2, d=1024, f=2816, seed=0):
    """Random int8 fused layers, a random cache and HD-like ranges: prompt
    rows [0, len0), a decoded span [s - 24, s - 24 + 7), the new row at
    the span's end."""
    cfg = LMConfig(vocab_size=64, hidden_size=d, intermediate_size=f, num_hidden_layers=layers,
                   num_attention_heads=d // 128)
    lm = quantize_lm_int8({"lm": init_lm_on_device(cfg, seed, cuda, torch.bfloat16)})["lm"]
    cache = KVCache.create(cfg, b, s, dtype=torch.int8 if int8 else torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    if int8:
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=cuda))
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device=cuda) * 0.02)
    else:
        for t in (cache.k, cache.v):
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    lengths = torch.randint(1, s - 24, (b,), generator=g, device=cuda).int()
    start2 = torch.full_like(lengths, s - 24)
    end2 = start2 + 7
    h0 = (torch.randn((b, d), generator=g, device=cuda) * 0.05).bfloat16()
    return cfg, lm, cache, (h0, lengths, start2, end2, end2, lengths + 7)


def _k4_run(cfg, lm, cache, args, fn):
    h0, len0, start2, end2, wpos, pos = args
    c = KVCache(cache.k.clone(), cache.v.clone(), 0,
                None if cache.k_scale is None else cache.k_scale.clone(),
                None if cache.v_scale is None else cache.v_scale.clone())
    if fn is k4.fused_decode_hidden:
        out = fn(lm, cfg, h0, c.k, c.v, len0, start2, end2, wpos, pos,
                 k_scale=c.k_scale, v_scale=c.v_scale)
    else:
        out = k4.fused_decode_hidden_plain(lm["layers"], cfg, h0, c.k, c.v, len0, start2, end2,
                                           pos, c.k_scale, c.v_scale)
        k4.write_rows(c.k, c.v, c.k_scale, c.v_scale, out[1], out[2], wpos)
    return out, c


def _rows(c, wpos):
    rows = torch.arange(wpos.shape[0], device=wpos.device)
    k, v = c.k[:, rows, wpos.long()], c.v[:, rows, wpos.long()]
    if c.k_scale is not None:
        k = dequantize_kv(k, c.k_scale[:, rows, wpos.long()], torch.float32)
        v = dequantize_kv(v, c.v_scale[:, rows, wpos.long()], torch.float32)
    return k.float(), v.float()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,int8", [(4, 544, True), (4, 544, False), (1, 96, True),
                                      (10, 160, True), (6, 200, False)])
def test_fused_decode_kernel_matches_plain(cuda, b, s, int8):
    """hidden within 2e-2 of max|hidden| (the JAX fused-decode test's bound),
    the new cache rows within 0.05 after dequantization; the kernel is
    deterministic (fixed-order split-K sums) and writes nothing but the
    new rows (checked by the plain run on an untouched copy)."""
    cfg, lm, cache, args = _k4_inputs(cuda, b, s, int8)
    (h, kn, vn), c = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    (h2, _, _), _ = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    (hp, knp, vnp), cp = _k4_run(cfg, lm, cache, args, None)
    torch.cuda.synchronize()
    assert torch.equal(h, h2)
    err = (h.float() - hp.float()).abs().max().item()
    assert err <= 2e-2 * hp.float().abs().max().item(), err
    for got, want in zip((kn, vn), (knp, vnp)):
        assert (got.float() - want.float()).abs().max().item() < 0.05
    for got, want in zip(_rows(c, args[4]), _rows(cp, args[4])):
        assert (got - want).abs().max().item() < 0.05
    wpos = args[4].long()
    rows = torch.arange(b, device=cuda)
    for t in ((c.k, cp.k), (c.v, cp.v)) + (((c.k_scale, cp.k_scale),) if int8 else ()):
        a, w = t[0].clone(), t[1].clone()
        a[:, rows, wpos] = 0
        w[:, rows, wpos] = 0
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_fused_decode_reads_only_valid_rows(cuda):
    """Rows outside [0, len0) U [start2, end2) may hold anything, even NaN."""
    cfg, lm, cache, args = _k4_inputs(cuda, 3, 128, False, layers=1)
    (want, _, _), _ = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    len0, start2, end2 = args[1], args[2], args[3]
    for i in range(3):
        cache.k[:, i, int(len0[i]):int(start2[i])] = float("nan")
        cache.v[:, i, int(end2[i]):] = float("nan")
    (got, _, _), _ = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_decode_rejects_what_it_does_not_take(cuda):
    cfg, lm, cache, args = _k4_inputs(cuda, 2, 64, True, layers=1)
    h0, len0, start2, end2, wpos, pos = args
    with pytest.raises(ValueError, match="int32"):
        k4.fused_decode_hidden(lm, cfg, h0, cache.k, cache.v, len0.long(), start2, end2, wpos,
                               pos, k_scale=cache.k_scale, v_scale=cache.v_scale)
    with pytest.raises(ValueError, match="k_scale"):
        k4.fused_decode_hidden(lm, cfg, h0, cache.k, cache.v, len0, start2, end2, wpos, pos)
    with pytest.raises(NotImplementedError):
        k4.fused_decode_hidden(lm, cfg, h0, cache.k, cache.v, len0, start2, end2, wpos, pos,
                               k_scale=cache.k_scale, v_scale=cache.v_scale, slot_lora={})
