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
width. K5 (paged attention) runs at the paged serving path's shapes. K6
(4-bit GEMV), K7 (int8 GEMV) and K8 (w8a8 GEMM) run at Vicuna-7B's and
CLIP-L's product shapes and at ragged row counts. K9 (the fused CLIP
block) runs at CLIP-L's widths (1, 2 and 26 images) and at two small
ragged ones (W = 384 takes its 128-wide product tiles only); K4's verify
form (T = k+1 fed tokens a sample) at K4's test widths.

Outputs are held by block measures that do not scale with the tensor's
largest value: the relative RMS difference of every (sample, 64-row
tile, head) block (K1, K2) or of every (sample, head) row (K3, K4, K5).
Each check also shows that it fails an output that lost something: K1's
with its last tile zeroed, and the plain version of K3, K4 and K5 run
with the last valid range or page dropped. K6 is held per (row, 128-wide
output slice), and its plain version without the last 64 rows of the
weight must fail that; K7's int32 output and K8's int8 rows and int32
sums are held bit for bit (K8's bf16 output within one bf16 step), and
the product without the last 128 rows must differ. K9 is held by its
block's update out - x per (image, 64-row tile, 128-wide slice), which
its plain version must fail when its attention loses the last 64 keys or
its MLP the last 128 hidden units; K4's verify form per (sample, token,
128-wide slice) and per (sample, token, head) row, failing the plain
version without the last valid range or without the fed tokens before
each token. The int8 cache rows and scales that `quantize_kv` gives on
the card, and that K4 writes at T = 1 and T = k+1, are held bit for bit
against the CPU's and `quantize_kv`'s, as is the int4 code table.

MPT's forms (K2 with the key-only ALiBi bias in both directions, K3 with
the slopes) run at MPT-7B's 32 heads of 128 and at ragged lengths. Each
also fails a lossy output: K2's forward run without the bias and its
plain version with the last head's slopes zeroed; its backward without
the bias in the recompute and with dk/dv reading the bias by query; K3's
plain version with the keys at their slot indices instead of the
compacted token positions, and without slopes. The no-bias cases above
hold the same kernels' no-bias form.

K3 splits each (sample, kv head)'s valid keys across the blocks of one
cluster in whole tiles of 32: its edge cases put the run's end just below,
at and above a split boundary, with and without a decoded span, across a
wide gap, with lengths == needed and with rows that have no valid key (0),
at groups of 1, 2, 4 and 8, and two calls give the same bits. K8 quantizes
its rows in a pass of its own and then runs 128- or 192-row tiles: its
ragged cases run M = 1, 255, 257 and 15,002 at the products' K and N.

K1 works on 128 query rows a block and keys in tiles of 128 (d = 64): its
edge cases run lengths 1, 63-65, 127-129 and 577 at 1 and 26 images and 4
and 16 heads, each failing the plain output without its last key tile,
and two calls give the same bits.

K2's forward works on 128 query rows a block (two warpgroups of 64) and
keys in tiles of 128, its backward on tiles of 64: the edge cases run
both directions at lengths on either side of those tiles (127-129, 255,
2049, queries ending inside the keys across a 128-row edge), GQA with
groups of 4 at 2048 keys, full biases broadcast over N and over H, and
full-bias rows below -1e30 on either side of the tiles' edges (o = 0,
lse = +inf: ROADMAP R9, accepted for the port).

The eval harness's `DevicePrefetcher(to_device=True)` copies on a side
stream: its test holds that copy back on the card and checks that the
consumer's stream waits for it.
"""

import json

import numpy as np
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
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops import layers
from tokenpacker_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain
from tokenpacker_tpu_torch.ops.q8_matmul import s8_matmul, s8_matmul_plain, w8a8_matmul
from tokenpacker_tpu_torch.ops.quantize import quantize_4bit, quantize_int8
from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm, s8_gemm_plain, w8a8_gemm
from tokenpacker_tpu_torch.ops.quantize import dequantize_4bit
from tokenpacker_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from tokenpacker_tpu_torch.ops.vit_block import vit_block, vit_block_plain

# bf16 on the card: the kernels round the probabilities (as product
# operands) and the outputs to bf16, ~2^-9 per element; a lost tile, range
# or page reads O(0.1-1)
BLOCK_REL_RMS = 2e-2
# K4-LoRA is held by the adapters' update (hidden with them less without):
# a difference of two bf16 runs, each carrying the roundings that K4 and
# its plain version take in different places along the base path, which
# do not cancel in it. At Vicuna-7B's widths (chip_smoke.py phase 3) the
# update reads 0.015-0.018 on an H100 where a lossy update reads 0.40-1.8;
# at this file's widths 0.009-0.040 (T = 5 the highest), lossy 1.0-1.2
LORA_UPDATE_REL_RMS = 5e-2
# The edge cases' adapter entries: phase 3's serving size (chip_smoke.py
# LORA_SCALE). At `_lora_bundle`'s 0.15 the adapters lift the hidden state
# to ~40, where one bf16 step of a fed token's q or k (0.25) moves a logit
# by ~1, and at T >= 5 fed tokens (which then take most of the attention)
# kernel and plain version, which sum the term in different orders, read
# 0.02-0.06 apart per slice
LORA_EDGE_SCALE = 0.03


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
    """K2's lse and o, besides the block measure: 1e-2 absolute plus 1e-2
    of the largest reference value. Infinite entries (lse of a row with
    no key) must match exactly."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    err = (got[~inf] - want[~inf]).abs().max().item()
    assert err <= 1e-2 + 1e-2 * want[~inf].abs().max().item(), err


def _blocks_rel(got, want, tile=64):
    """[N, tiles, H]: ||got - want|| / ||want|| over every (sample, `tile`
    positions, head) block of [N, T, H, d] outputs; a block that is zero
    in `want` reads 0 if it is zero in `got` too, else inf."""
    n, t, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -t % tile)
    num = torch.nn.functional.pad((got.float() - want.float()).square(), pad)
    den = torch.nn.functional.pad(want.float().square(), pad)
    num, den = (x.view(n, -1, tile, h, d).sum((2, 4)) for x in (num, den))
    return torch.where(den > 0, (num / den.clamp_min(1e-30)).sqrt(),
                       torch.where(num > 0, torch.inf, 0.0))


def _blocks_close(got, want, tile=64, limit=BLOCK_REL_RMS):
    """[N, T, H, d] outputs held block by block (`_blocks_rel`): blocks of
    small values (the last keys' dk/dv, late rows' dq) are held as
    tightly as large ones (K2 at the training shape reads 0.0031-0.0075
    in `chip_smoke.py`)."""
    assert torch.isfinite(got.float()).all()
    rel = _blocks_rel(got, want, tile).max().item()
    assert rel <= limit, rel


def _rows_rel(got, want):
    """||got - want|| / ||want|| over the last axis: one reading per
    (sample, head) row of [..., d] outputs (0 where both rows are zero,
    inf where only `want`'s is)."""
    num = (got.float() - want.float()).square().sum(-1)
    den = want.float().square().sum(-1)
    return torch.where(den > 0, (num / den.clamp_min(1e-30)).sqrt(),
                       torch.where(num > 0, torch.inf, 0.0))


def _rows_close(got, want, lost, limit=BLOCK_REL_RMS):
    """Every (sample, head) row within `limit`; `lost`, the plain version's
    output for an input that lost its last valid range or page, must read
    above it (the measure sees such a loss). Returns both readings."""
    assert torch.isfinite(got.float()).all()
    worst = _rows_rel(got, want).max().item()
    assert worst <= limit, worst
    lost_reads = _rows_rel(lost, want).max().item()
    assert lost_reads > limit, lost_reads
    return worst, lost_reads


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,w,heads", [(2, 577, 1024, 16), (3, 17, 256, 4), (1, 130, 512, 8)])
def test_vit_attention_kernel_matches_plain(cuda, n, t, w, heads):
    """Held per (image, 64 rows, head); the output with its last 64 rows
    zeroed must fail that hold."""
    q, k, v = (_bf16((n, t, w), s, cuda) for s in range(3))
    got, want = (x.view(n, t, heads, w // heads) for x in
                 (vit_attention(q, k, v, heads), vit_attention_plain(q, k, v, heads)))
    _blocks_close(got, want)
    lost = got.clone()
    lost[:, -64:] = 0
    assert _blocks_rel(lost, want).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 4])
@pytest.mark.parametrize("n", [1, 26])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 577])
def test_vit_attention_kernel_at_tile_edges(cuda, t, n, heads):
    """K1 takes 128 query rows a block and keys in tiles of 128: lengths on
    both sides of those edges and the tower's 577, held per (image, 64
    rows, head). The plain output without the keys of the kernel's last
    key tile (no key at all where there is one tile: zeros) must fail
    that hold, and two calls give the same bits."""
    w = heads * 64
    q, k, v = (_bf16((n, t, w), s, cuda) for s in range(3))
    got, again = vit_attention(q, k, v, heads), vit_attention(q, k, v, heads)
    want = vit_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    kept = (t - 1) // 128 * 128  # the keys before the last key tile
    got, want = (x.view(n, t, heads, 64) for x in (got, want))
    if kept:  # the plain version's function over the first `kept` keys
        qh, kh, vh = (x.reshape(n, -1, heads, 64) for x in (q, k[:, :kept], v[:, :kept]))
        logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * 0.125
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        lost = torch.einsum("nhqk,nkhd->nqhd", probs, vh)
    else:
        lost = torch.zeros_like(want)
    _blocks_close(got, want)
    assert _blocks_rel(lost, want).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
def test_vit_attention_rejects_head_dim_128(cuda):
    x = _bf16((2, 577, 1024), 0, cuda)
    with pytest.raises(RuntimeError, match="not supported"):
        vit_attention(x, x, x, 8)


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


# K2's forward takes 128 query rows a block and keys in tiles of 128; its
# backward tiles of 64 keys and 64 queries: lengths on both sides of each
# edge, one past the longest bucket, and queries ending inside the keys
# across a 128-row edge
EDGE_LENGTHS = [(127, 127), (128, 128), (129, 129), (255, 255), (2049, 2049), (192, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("tq,tk", EDGE_LENGTHS)
def test_flash_kernel_at_tile_edges(cuda, tq, tk, bias):
    """K2's forward (no bias, and the key-only bias with noise) at lengths
    around its tiles' edges, causal: o and lse as the other cases."""
    n, h = 2, 4
    q = _bf16((n, tq, h, 128), 0, cuda)
    k, v = _bf16((n, tk, h, 128), 1, cuda), _bf16((n, tk, h, 128), 2, cuda)
    b = _alibi_rows(h, tk, cuda, 11) if bias else None
    o, lse = flash_attention(q, k, v, True, b)
    want_o, want_lse = flash_attention_plain(q, k, v, True, b)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("tq,tk", EDGE_LENGTHS)
def test_flash_bwd_kernel_at_tile_edges(cuda, tq, tk, bias):
    """K2's backward at the same lengths: dq, dk, dv as the other cases, and
    two calls give the same bits."""
    n, h = 2, 4
    q, do = _bf16((n, tq, h, 128), 0, cuda), _bf16((n, tq, h, 128), 3, cuda)
    k, v = _bf16((n, tk, h, 128), 1, cuda), _bf16((n, tk, h, 128), 2, cuda)
    b = _alibi_rows(h, tk, cuda, 12) if bias else None
    o, lse = flash_attention(q, k, v, True, b)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, b)
    again = flash_attention_bwd(q, k, v, o, lse, do, True, b)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True, b)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w)
        _blocks_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_group_of_4_at_2048(cuda, causal):
    """GQA with 4 query heads a kv head at 2048 keys, both directions: the
    backward sums each group inside its dk/dv block."""
    n, t, h, hkv = 1, 2048, 8, 2
    q, do = _bf16((n, t, h, 128), 0, cuda), _bf16((n, t, h, 128), 3, cuda)
    k, v = _bf16((n, t, hkv, 128), 1, cuda), _bf16((n, t, hkv, 128), 2, cuda)
    o, lse = flash_attention(q, k, v, causal)
    want_o, want_lse = flash_attention_plain(q, k, v, causal)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w)
        _blocks_close(g, w)


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
    """Held per (sample, head); the plain version without the decoded span
    (span_start > 0), or without the last 64 keys of samples that have
    more (span_start 0), must fail that hold."""
    n, s, h = 4, 1040, 32
    q = _bf16((n, h, d), 0, cuda)
    ck, cv = _bf16((n, s, hkv, d), 1, cuda), _bf16((n, s, hkv, d), 2, cuda)
    lengths = torch.tensor([1, 333, 650, 1000], dtype=torch.int32, device=cuda)
    if span_start:
        needed = torch.full((n,), span_start + 7, dtype=torch.int32, device=cuda)
        fewer = torch.full_like(needed, span_start)
    else:
        needed = torch.tensor([1, 40, 650, 1040], dtype=torch.int32, device=cuda)
        fewer = torch.where(needed > 64, needed - 64, needed)
    _rows_close(decode_attention(q, ck, cv, lengths, needed, span_start),
                decode_attention_plain(q, ck, cv, lengths, needed, span_start),
                decode_attention_plain(q, ck, cv, lengths, fewer, span_start))


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
    assert torch.isfinite(got.float()).all()
    assert _rows_rel(got, want).max().item() <= BLOCK_REL_RMS


def _split_edge_case(case, groups, device):
    """Lengths, needed and span_start of one K3 split-edge case at n = 4,
    S = 1040, where `decode_splits` gives 8 splits of whole 32-key tiles
    (a run of T valid keys: splits of ceil(ceil(T / 8) / 32) * 32). The
    first three samples put the run's end just below, at and just above
    256 keys (8 splits of 32: a split boundary), the last holds many."""
    n, span_start = 4, 0
    if case == "split_boundaries":  # one range; lengths == needed
        lengths = needed = [255, 256, 257, 1040]
    elif case == "boundaries_with_span":  # 17 keys of the span after the prompt
        span_start = 1000
        lengths, needed = [238, 239, 240, 900], [span_start + 17] * n
    elif case == "wide_gap":  # a few prompt keys, ~900 slots of gap, a span
        span_start = 1000
        lengths, needed = [1, 5, 40, 100], [1040, 1003, 1001, 1040]
    elif case == "lengths_equal_needed_with_span":
        span_start = 512
        lengths = needed = [100, 300, 511, 512]
    else:  # "rows_without_keys": samples 0 and 2 have no valid key
        span_start = 700
        lengths, needed = [0, 650, 0, 300], [0, 701, 700, 760]
    as_t = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    return as_t(lengths), as_t(needed), span_start


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["split_boundaries", "boundaries_with_span", "wide_gap",
                                  "lengths_equal_needed_with_span", "rows_without_keys"])
def test_decode_kernel_at_split_edges(cuda, case, groups):
    """K3 where its splits begin and end: each (sample, head) row within
    BLOCK_REL_RMS of the plain version, a row with no valid key exactly 0,
    two calls the same bits; the plain version without the last 64 valid
    keys of each sample (or its span) must fail the hold."""
    from tokenpacker_tpu_torch.ops.decode_attention import decode_splits

    n, s, h = 4, 1040, 32
    hkv = h // groups
    assert decode_splits(n, hkv, s) == 8
    q = _bf16((n, h, 128), groups, cuda)
    ck, cv = _bf16((n, s, hkv, 128), 10 + groups, cuda), _bf16((n, s, hkv, 128), 20 + groups, cuda)
    lengths, needed, span_start = _split_edge_case(case, groups, cuda)
    got, again = (decode_attention(q, ck, cv, lengths, needed, span_start) for _ in range(2))
    want = decode_attention_plain(q, ck, cv, lengths, needed, span_start)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if span_start:
        fewer = torch.where(needed > span_start, torch.full_like(needed, span_start),
                            (lengths - 64).clamp(min=0))
    else:
        fewer = (needed - 64).clamp(min=0)
    lost = decode_attention_plain(q, ck, cv, torch.minimum(lengths, fewer), fewer, span_start)
    # the plain softmax gives NaN where a row has no valid key; the kernel 0
    empty = (needed <= 0) | ((lengths <= 0) & (needed <= span_start))
    _rows_close(got[~empty], want[~empty], torch.nan_to_num(lost[~empty]))
    assert not got[empty].any()


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


# K4's cache values are scaled so that the layers' attention moves the
# hidden state about as much as the MLP does (random V of unit size
# averages to ~1/sqrt(keys), which the MLP's ~1 buries, and then no
# check of the hidden state could see a lost range)
K4_V_GAIN = 20.0


def _k4_inputs(cuda, b, s, int8, layers=2, d=1024, f=2816, seed=0):
    """Random int8 fused layers, a random cache (V scaled by K4_V_GAIN)
    and HD-like ranges: prompt rows [0, len0), a decoded span [s - 24,
    s - 24 + 7), the new row at the span's end."""
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
        cache.v_scale.mul_(K4_V_GAIN)
    else:
        for t in (cache.k, cache.v):
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
        cache.v.mul_(K4_V_GAIN)
    lengths = torch.randint(1, s - 24, (b,), generator=g, device=cuda).int()
    start2 = torch.full_like(lengths, s - 24)
    end2 = start2 + 7
    h0 = (torch.randn((b, d), generator=g, device=cuda) * 0.05).bfloat16()
    return cfg, lm, cache, (h0, lengths, start2, end2, end2, lengths + 7)


def _k4_run(cfg, lm, cache, args, fn):
    h0, len0, start2, end2, wpos, pos = args
    if fn == "lost":  # the plain version without the decoded span
        end2 = start2
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
    """The hidden state per (sample, 128-wide head slice), the new rows
    and the cache rows written per (layer, sample, head), each within
    BLOCK_REL_RMS; the plain version without the decoded span must fail
    the hidden state's and the new rows' hold. The kernel is deterministic
    (fixed-order split-K sums) and writes nothing but the new rows
    (checked by the plain run on an untouched copy)."""
    cfg, lm, cache, args = _k4_inputs(cuda, b, s, int8)
    (h, kn, vn), c = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    (h2, _, _), _ = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    (hp, knp, vnp), cp = _k4_run(cfg, lm, cache, args, None)
    (hl, knl, vnl), _ = _k4_run(cfg, lm, cache, args, "lost")
    torch.cuda.synchronize()
    assert torch.equal(h, h2)
    _rows_close(h.view(b, -1, 128), hp.view(b, -1, 128), hl.view(b, -1, 128))
    _rows_close(torch.stack((kn, vn)), torch.stack((knp, vnp)), torch.stack((knl, vnl)))
    for got, want in zip(_rows(c, args[4]), _rows(cp, args[4])):
        assert _rows_rel(got, want).max().item() <= BLOCK_REL_RMS
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
    # K4-LoRA's bundle must fit the tree: one with another layer count raises
    bundle = _lora_bundle(cfg, lm, ["a", None])
    bundle["a_f"] = bundle["a_f"][:0]
    with pytest.raises(ValueError, match="slot_lora a_f"):
        k4.fused_decode_hidden(lm, cfg, h0, cache.k, cache.v, len0, start2, end2, wpos, pos,
                               k_scale=cache.k_scale, v_scale=cache.v_scale, slot_lora=bundle)


# ---- K5: paged attention -------------------------------------------------------

# the paged serving path's shapes: 8 sequences over pages of 64, 40 blocks
# each, lengths 65-2080 (chip_smoke.py phase 3)
PAGED_LENGTHS = [65, 300, 701, 1000, 1200, 1500, 1751, 2080]


def _paged_inputs(cuda, n, h, hkv, ps, mp, lengths, int8, seed=0):
    """A pool of n * mp + 1 pages handed out in a shuffled order, so that
    no sequence's pages are contiguous; table entries past each length
    point at other sequences' pages."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p_total = n * mp + 1
    k = torch.randn((p_total, ps, hkv, 128), generator=g)
    v = torch.randn((p_total, ps, hkv, 128), generator=g)
    q = torch.randn((n, h, 128), generator=g).to(device=cuda, dtype=torch.bfloat16)
    table = (torch.randperm(n * mp, generator=g) + 1).view(n, mp).int().to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks.to(cuda), vs.to(cuda))
    else:
        k, v, scales = k.bfloat16(), v.bfloat16(), (None, None)
    return q, k.to(cuda), v.to(cuda), table, lens, scales


@pytest.mark.cuda
@pytest.mark.parametrize("n,hkv,ps,mp,int8", [
    (8, 32, 64, 40, True), (8, 32, 64, 40, False), (8, 8, 64, 40, True), (8, 8, 64, 40, False),
    (3, 16, 16, 12, True), (3, 4, 32, 6, False), (5, 16, 32, 8, False),
])
def test_paged_attention_kernel_matches_plain(cuda, n, hkv, ps, mp, int8):
    """Held per (sample, head); the plain version with each sequence's last
    valid page dropped must fail that hold. Two calls give the same bits."""
    lengths = (PAGED_LENGTHS if n == 8 else [1, ps, mp * ps - 3, ps + 1, 2 * ps][:n])
    q, k, v, table, lens, (ks, vs) = _paged_inputs(cuda, n, 32, hkv, ps, mp, lengths, int8)
    got = paged_attention(q, k, v, table, lens, ks, vs)
    again = paged_attention(q, k, v, table, lens, ks, vs)
    want = paged_attention_plain(q, k, v, table, lens, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    dropped = lens - ((lens - 1) % ps + 1)
    _rows_close(got, want, paged_attention_plain(q, k, v, table, dropped, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,mp,splits", [([1, 64, 130, 600], 10, 1),
                                               ([1, 700, 130, 2080], 64, 8)])
@pytest.mark.parametrize("int8", [True, False])
def test_paged_attention_reads_no_page_past_the_length(cuda, int8, lengths, mp, splits):
    """Pages past each length, the rows past it in its last page and the
    pages of stale table entries are poisoned with NaN: the output stays
    finite and equal to that of the clean pool. With mp = 64 each (sequence,
    kv head) at 8 kv heads is split over 8 blocks, and the 2,080-key
    sequence's last split ends inside its last page."""
    from tokenpacker_tpu_torch.ops.paged_attention import paged_splits

    n, ps = 4, 64
    assert paged_splits(n, 8, mp, ps) == splits
    q, k, v, table, lens, (ks, vs) = _paged_inputs(cuda, n, 32, 8, ps, mp, lengths, int8)
    want = paged_attention(q, k, v, table, lens, ks, vs)
    # past length 1: stale entries (two pages that sequence 2 does not
    # reach) and the null page 0
    table[0, 1:4] = torch.stack((table[2, 5], table[2, 6], torch.zeros_like(table[2, 6])))
    for i, length in enumerate(lens.tolist()):
        used = -(-length // ps)
        for j in range(used, mp):
            pid = int(table[i, j])
            if int8:
                ks[pid], vs[pid] = float("nan"), float("nan")
            else:
                k[pid], v[pid] = float("nan"), float("nan")
        last = int(table[i, used - 1])
        (ks if int8 else k)[last, length - (used - 1) * ps:] = float("nan")
        (vs if int8 else v)[last, length - (used - 1) * ps:] = float("nan")
    got = paged_attention(q, k, v, table, lens, ks, vs)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("n,hkv,positions,splits", [(8, 32, 2560, 2), (8, 8, 2560, 4),
                                                    (8, 8, 4096, 8), (2, 32, 4096, 8)])
@pytest.mark.parametrize("ps", [64, 32, 16])
def test_paged_attention_kernel_at_split_edges(cuda, ps, n, hkv, positions, splits, int8):
    """K5 where its splits begin and end: D's and F's pool (8 sequences,
    2,560 positions) at 32 and 8 kv heads, and tables of 4,096 positions
    that take 8 splits. Lengths 1, ps, ps + 1, two pages a split, mp * ps,
    one shorter than a split's share beside the 2,080-key one, and 0 (a
    row with no key gives exactly 0), the first n of them. Each (sequence,
    head) row within BLOCK_REL_RMS of the plain version, which without
    each sequence's last valid page must fail that; two calls the same
    bits."""
    from tokenpacker_tpu_torch.ops.paged_attention import paged_splits

    mp = positions // ps
    assert paged_splits(n, hkv, mp, ps) == splits
    lengths = ([1, ps, ps + 1, 2 * splits * ps, mp * ps, 100, 2080, 0] if n == 8
               else [100, 2080])
    q, k, v, table, lens, (ks, vs) = _paged_inputs(cuda, n, 32, hkv, ps, mp, lengths, int8,
                                                   seed=ps + hkv)
    got = paged_attention(q, k, v, table, lens, ks, vs)
    again = paged_attention(q, k, v, table, lens, ks, vs)
    want = paged_attention_plain(q, k, v, table, lens, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert n < 8 or not got[-1].any()
    dropped = (lens - ((lens - 1) % ps + 1)).clamp(min=0)
    _rows_close(got, want, paged_attention_plain(q, k, v, table, dropped, ks, vs))


@pytest.mark.cuda
def test_paged_attention_rejects_what_it_does_not_take(cuda):
    q, k, v, table, lens, _ = _paged_inputs(cuda, 2, 32, 8, 64, 4, [10, 100], False)
    with pytest.raises(RuntimeError, match="not supported"):
        paged_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                        v[..., :64].contiguous(), table, lens)  # head_dim 64
    small = k[:, :8].contiguous()
    with pytest.raises(RuntimeError, match="not supported"):
        paged_attention(q, small, small, table, lens)  # pages of 8
    q6 = q[:, :6].contiguous()
    with pytest.raises(RuntimeError, match="not supported"):
        paged_attention(q6, k[:, :, :2].contiguous(), v[:, :, :2].contiguous(), table, lens)
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attention(q, k.float(), v.float(), table, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, k, v, table.long(), lens)
    with pytest.raises(ValueError, match="scales"):
        paged_attention(q, k.to(torch.int8), v.to(torch.int8), table, lens)
    with pytest.raises(ValueError, match="shapes"):
        paged_attention(q, k, v, table[:1], lens)


# ---- K6, K7, K8: the quantized products -----------------------------------------


def _slices_rel(got, want):
    """||got - want|| / ||want|| of every (row, 128-wide output slice) of
    [M, N] outputs (`_rows_rel` over [M, N / 128, 128])."""
    m, n = want.shape
    return _rows_rel(got.reshape(m, n // 128, 128), want.reshape(m, n // 128, 128))


# every M up to 32 at Vicuna-7B's qkv and at down's K, whose 172
# quantization blocks the 8 splits do not divide evenly
Q4_EVERY_M = [(m, k, n) for m in (1, 2, 4, 8, 9, 16, 17, 24, 32)
              for k, n in ((4096, 12288), (11008, 4096)) if (m, k, n) != (32, 11008, 4096)]
# MPT-7B's up and down ([K, N]): K = 16384 splits K further than any
# Vicuna-7B product (its largest K is 11008)
MPT_PRODUCTS = ((4096, 16384), (16384, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["nf4", "int4"])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 12288), (1, 4096, 4096), (32, 11008, 4096),
                                   (3, 1024, 640), (17, 512, 1024), (8, 4096, 32000)]
                         + [c for c in Q4_EVERY_M if c not in ((4, 4096, 12288),)]
                         + [(m, k, n) for m in (1, 4, 32) for k, n in MPT_PRODUCTS])
def test_q4_matmul_kernel_matches_plain(cuda, quant_type, m, k, n):
    """One launch a call; per (row, 128-wide slice) within BLOCK_REL_RMS;
    the plain version without the weight's last 64 rows must fail that.
    Two calls give the same bits."""
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_splits

    assert k != 11008 or (k // 64) % q4_splits(k, n)
    g = torch.Generator(device=cuda).manual_seed(m + k)
    w = torch.randn((k, n), generator=g, device=cuda) * 0.02
    leaf = quantize_4bit(w, 64, quant_type)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    before = q4_matmul.launches
    got, again = q4_matmul(x, leaf), q4_matmul(x, leaf)
    assert q4_matmul.launches == before + 2
    want = q4_matmul_plain(x, leaf)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and got.dtype == torch.bfloat16
    lost_x = x.clone()
    lost_x[:, -64:] = 0
    assert torch.isfinite(got.float()).all()
    assert _slices_rel(got, want).max().item() <= BLOCK_REL_RMS
    assert _slices_rel(q4_matmul_plain(lost_x, leaf), want).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 12288), (64, 11008, 4096), (1, 4096, 32000),
                                   (5, 96, 48), (17, 1024, 1040), (40, 4096, 22016)]
                         + [(m, k, n) for m in (8, 64) for k, n in MPT_PRODUCTS])
def test_s8_matmul_kernel_bit_equal_plain(cuda, m, k, n):
    """int32 output bit-equal to the plain (float64) product; the product
    without the last 128 rows (or 32 for k < 256) must differ."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    got = s8_matmul(xq, wq)
    want = s8_matmul_plain(xq, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    cut = 128 if k >= 256 else 32
    lost = s8_matmul_plain(xq[:, :-cut], wq[:-cut])
    assert not torch.equal(lost, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(32, 16), (1440, 16), (1440, 1040)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 33, 63, 64])
def test_s8_matmul_kernel_at_every_row_tile(cuda, m, k, n):
    """One launch at every row count around the kernel's 8-row tiles, at the
    smallest K and N it takes (one half-full stage, one 16-column group)
    and at K = 1440 (23 stages, the last half full, over 8 uneven splits,
    `s8_splits`), bit-equal to the plain product; two calls give the same
    bits and each adds one launch."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    before = s8_matmul.launches
    got, again = s8_matmul(xq, wq), s8_matmul(xq, wq)
    torch.cuda.synchronize()
    assert s8_matmul.launches == before + 2
    assert torch.equal(got, s8_matmul_plain(xq, wq)) and torch.equal(got, again)


@pytest.mark.cuda
def test_s8_matmul_takes_at_most_64_rows(cuda):
    xq = torch.zeros((65, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="M <= 64"):
        s8_matmul(xq, torch.zeros((64, 64), dtype=torch.int8, device=cuda))


def _bf16_steps(got, want):
    """How many bf16 steps apart two bf16 tensors are, element by element
    (signs equal or both zero on the serving values)."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 4096, 12288), (300, 1024, 4096), (2048, 11008, 4096),
                                   (577 * 3, 1024, 1024), (129, 4096, 128)])
def test_s8_gemm_kernel_matches_plain(cuda, m, k, n):
    """The kernel's int8 rows, their scales and its int32 sums bit-equal to
    the plain version's, the bf16 output within one bf16 step; the sums
    without the last 128 rows must differ."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    x[3] *= 50
    wq, scale = quantize_int8(torch.randn((k, n), generator=g, device=cuda) * 0.02)
    y, xq, ax, acc = s8_gemm(x, wq, scale, parts=True)
    py, pxq, pax, pacc = s8_gemm_plain(x, wq, scale, parts=True)
    torch.cuda.synchronize()
    assert torch.equal(ax, pax), (ax - pax).abs().max().item()
    assert torch.equal(xq, pxq), int((xq != pxq).sum())
    assert torch.equal(acc, pacc)
    assert _bf16_steps(y, py).max().item() <= 1
    assert torch.equal(s8_gemm(x, wq, scale), y)
    assert not torch.equal(s8_matmul_plain(pxq[:, :-128], wq[:-128]), pacc)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 4096), (4096, 12288), (11008, 4096),
                                 (4096, 22016)])
@pytest.mark.parametrize("m", [1, 255, 257, 15002])
def test_s8_gemm_ragged_rows_bit_equal_plain(cuda, m, k, n):
    """Ragged M around K8's 128-row tiles (and the tower's 26 x 577 rows)
    at the products' K and N: the int8 rows, their scales and the int32
    sums bit-equal to the plain version's, and two calls the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    x[-1] *= 30
    wq, scale = quantize_int8(torch.randn((k, n), generator=g, device=cuda) * 0.02)
    y, xq, ax, acc = s8_gemm(x, wq, scale, parts=True)
    again = s8_gemm(x, wq, scale)
    py, pxq, pax, pacc = s8_gemm_plain(x, wq, scale, parts=True)
    torch.cuda.synchronize()
    assert torch.equal(ax, pax) and torch.equal(xq, pxq)
    assert torch.equal(acc, pacc)
    assert _bf16_steps(y, py).max().item() <= 1
    assert torch.equal(again, y)


@pytest.mark.cuda
def test_quantized_linear_routes_on_the_card(cuda):
    """`linear` launches K6 for M <= 32 rows of a 4-bit leaf and K7 / K8 in
    the w8a8 mode; M = 33 (4-bit) and M = 100 (w8a8) launch none."""
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((1024, 2048), generator=g, device=cuda) * 0.02
    q, scale = quantize_int8(w)
    p4, p8 = {"kernel": quantize_4bit(w)}, {"kernel": {"q": q, "scale": scale}}
    counts = (q4_matmul, s8_matmul, s8_gemm)
    for fn in counts:
        fn.launches = 0
    for rows, p, w8a8, want in ((32, p4, False, (1, 0, 0)), (33, p4, False, (1, 0, 0)),
                                (8, p8, True, (1, 1, 0)), (100, p8, True, (1, 1, 0)),
                                (256, p8, True, (1, 1, 1)), (8, p8, False, (1, 1, 1))):
        x = torch.randn((rows, 1024), generator=g, device=cuda).bfloat16()
        y = layers.linear(p, x, w8a8)
        assert y.shape == (rows, 2048) and torch.isfinite(y.float()).all()
        assert tuple(fn.launches for fn in counts) == want, (rows, w8a8)
    x = torch.randn((3, 1024), generator=g, device=cuda).bfloat16()
    torch.testing.assert_close(w8a8_matmul(x, p8["kernel"]).float(),
                               (x.float() @ w).float(), rtol=0.05, atol=0.05)
    x = torch.randn((256, 1024), generator=g, device=cuda).bfloat16()
    torch.testing.assert_close(w8a8_gemm(x, p8["kernel"]).float(),
                               (x.float() @ w).float(), rtol=0.05, atol=0.05)


@pytest.mark.cuda
def test_quantized_products_reject_what_the_kernels_do_not_take(cuda):
    w = torch.randn((256, 200), device=cuda)
    x = torch.randn((2, 256), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="N % 16"):
        q4_matmul(x, quantize_4bit(w[:, :200]))
    with pytest.raises(ValueError, match="blocks of 64"):
        q4_matmul(x, quantize_4bit(w[:, :192], block=128))
    with pytest.raises(ValueError, match="bfloat16"):
        q4_matmul(x.float(), quantize_4bit(w[:, :192]))
    with pytest.raises(ValueError, match="M <= 32"):
        q4_matmul(torch.zeros((33, 256), dtype=torch.bfloat16, device=cuda), quantize_4bit(w[:, :192]))
    xq = torch.zeros((2, 80), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="K % 32"):
        s8_matmul(xq, torch.zeros((80, 64), dtype=torch.int8, device=cuda))
    q, scale = quantize_int8(w[:, :192])
    with pytest.raises(ValueError, match="multiples of 128"):
        s8_gemm(torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda), q, scale)


# ---- K9: the fused CLIP block ----------------------------------------------------

# the block's o product is scaled by this gain so that attention moves the
# update as much as the MLP does: with random weights the attention output
# averages ~577 values and is ~1/20 of the MLP's, and no measure of the
# update could see lost keys
VIT_O_GAIN = 20.0


def _vit_layer(cuda, w, f, seed):
    """One CLIP layer of random bf16 params: kernels ~N(0, 1/fan_in), random
    biases and LayerNorm scales (the o kernel times VIT_O_GAIN)."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.0, mean=0.0):
        return (mean + scale * torch.randn(shape, generator=g)).to(cuda, torch.bfloat16)

    def lin(k, n, gain=1.0):
        return {"kernel": rnd(k, n, scale=gain / k**0.5), "bias": rnd(n, scale=0.1)}

    return {"ln1": {"scale": rnd(w, scale=0.1, mean=1.0), "bias": rnd(w, scale=0.1)},
            "attn": {"q": lin(w, w), "k": lin(w, w), "v": lin(w, w), "o": lin(w, w, VIT_O_GAIN)},
            "ln2": {"scale": rnd(w, scale=0.1, mean=1.0), "bias": rnd(w, scale=0.1)},
            "mlp": {"fc1": lin(w, f), "fc2": lin(f, w)}}


def vit_lossy(x, p, heads, eps):
    """The plain block's update with its attention losing the last 64 keys
    (rows [0, T - 64) from the block run on x[:, :T - 64]; the last rows
    as the full block) and with its MLP losing the last 128 hidden units."""
    t = x.shape[1]
    full = vit_block_plain(x, p, heads, eps)
    keys = full.clone()
    keys[:, :t - 64] = vit_block_plain(x[:, :t - 64].contiguous(), p, heads, eps)
    mlp = {**p, "mlp": {"fc1": {"kernel": p["mlp"]["fc1"]["kernel"][:, :-128],
                                "bias": p["mlp"]["fc1"]["bias"][:-128]},
                        "fc2": {"kernel": p["mlp"]["fc2"]["kernel"][:-128],
                                "bias": p["mlp"]["fc2"]["bias"]}}}
    return keys - x, vit_block_plain(x, mlp, heads, eps) - x


def _slices(u):
    """[N, T, W] -> [N, T, W / 128, 128]: (image, row, 128-wide slice)."""
    return u.view(*u.shape[:2], -1, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,w,f,heads", [(2, 577, 1024, 4096, 16), (3, 130, 256, 512, 4),
                                           (1, 577, 1024, 4096, 16),
                                           (26, 577, 1024, 4096, 16),
                                           (2, 70, 384, 640, 6)])  # 128-wide tiles only
def test_vit_block_kernel_matches_plain(cuda, n, t, w, f, heads):
    """The update out - x per (image, 64 rows, 128-wide slice); the plain
    version that lost the last 64 keys, or the last 128 MLP units, must
    fail that hold. Two calls give the same bits."""
    p = _vit_layer(cuda, w, f, seed=n)
    x = _bf16((n, t, w), 7, cuda)
    got, again, want = vit_block(x, p, heads, 1e-5), vit_block(x, p, heads, 1e-5), \
        vit_block_plain(x, p, heads, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _blocks_close(_slices(got - x), _slices(want - x))
    for lost in vit_lossy(x, p, heads, 1e-5):
        assert _blocks_rel(_slices(lost), _slices(want - x)).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
def test_vit_block_rejects_what_it_does_not_take(cuda):
    from tokenpacker_tpu_torch.models.clip_vit import quantize_tower_int8

    p = _vit_layer(cuda, 256, 512, seed=0)
    x = _bf16((1, 17, 256), 1, cuda)
    with pytest.raises(ValueError, match="quantized"):
        vit_block(x, quantize_tower_int8({"layers": [p]})["layers"][0], 4, 1e-5)
    with pytest.raises(RuntimeError, match="not supported"):
        vit_block(x, p, 2, 1e-5)  # head_dim 128
    with pytest.raises(ValueError, match="bfloat16"):
        vit_block(x.float(), p, 4, 1e-5)


# ---- K4's verify form (T = k+1) --------------------------------------------------


def _verify_run(cfg, lm, cache, args, fn):
    """K4-verify ("kernel"), its plain version ("plain"), the plain version
    without the last valid range ("lost range") or with each fed token alone
    ("lost fed"), on a copy of the cache. Returns ((hidden, k_new, v_new),
    cache copy)."""
    h0, len0, start2, end2, wpos0, pos = args
    c = KVCache(cache.k.clone(), cache.v.clone(), 0,
                None if cache.k_scale is None else cache.k_scale.clone(),
                None if cache.v_scale is None else cache.v_scale.clone())
    if fn == "kernel":
        out = k4.fused_verify_hidden(lm, cfg, h0, c.k, c.v, len0, start2, end2, wpos0, pos,
                                     k_scale=c.k_scale, v_scale=c.v_scale)
    elif fn == "lost fed":
        outs = [k4.fused_decode_hidden_plain(lm["layers"], cfg, h0[:, t], c.k, c.v, len0, start2,
                                             end2, pos[:, t], c.k_scale, c.v_scale)
                for t in range(h0.shape[1])]
        out = (torch.stack([o[0] for o in outs], 1), torch.stack([o[1] for o in outs], 2),
               torch.stack([o[2] for o in outs], 2))
    else:
        end = start2 if fn == "lost range" else end2
        out = k4.fused_verify_hidden_plain(lm["layers"], cfg, h0, c.k, c.v, len0, start2, end,
                                           pos, c.k_scale, c.v_scale)
        k4.write_rows(c.k, c.v, c.k_scale, c.v_scale, out[1], out[2], wpos0)
    return out, c


def _verify_inputs(cuda, b, t, s, int8):
    """K4's test inputs with T fed tokens a sample at positions len0 + 7 + j,
    written from the decoded span's end, and short prompts (1-4 rows): the
    fed tokens then hold a large share of each query's attention, so the
    plain version with each fed token alone reads far off."""
    cfg, lm, cache, (_, _, start2, end2, wpos, _) = _k4_inputs(cuda, b, s, int8)
    g = torch.Generator(device=cuda).manual_seed(5)
    len0 = torch.randint(1, 5, (b,), generator=g, device=cuda).int()
    h0 = (torch.randn((b, t, cfg.hidden_size), generator=g, device=cuda) * 0.05).bfloat16()
    positions = (len0[:, None] + 7 + torch.arange(t, device=cuda)).int()
    return cfg, lm, cache, (h0, len0, start2, end2, wpos, positions)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,int8", [(4, 5, 544, True), (4, 5, 544, False), (1, 9, 96, True),
                                        (3, 2, 160, False)])
def test_fused_verify_kernel_matches_plain(cuda, b, t, s, int8):
    """The hidden state per (sample, token, 128-wide slice) and the new rows
    per (layer, sample, token, head) within BLOCK_REL_RMS, the hidden
    state failing the plain version without the decoded span and with each
    fed token alone; the cache equal to the plain version's outside the
    written rows, and the written int8 rows and scales equal to
    `quantize_kv` of the rows the kernel returns."""
    cfg, lm, cache, args = _verify_inputs(cuda, b, t, s, int8)
    (h, kn, vn), c = _verify_run(cfg, lm, cache, args, "kernel")
    (hp, knp, vnp), cp = _verify_run(cfg, lm, cache, args, "plain")
    (hl, knl, vnl), _ = _verify_run(cfg, lm, cache, args, "lost range")
    (hf, _, _), _ = _verify_run(cfg, lm, cache, args, "lost fed")
    torch.cuda.synchronize()

    def slices(x):
        return x.view(b, t, -1, 128)

    _rows_close(slices(h), slices(hp), slices(hl))
    if t > 1:
        _rows_close(slices(h), slices(hp), slices(hf))
    _rows_close(torch.stack((kn, vn)), torch.stack((knp, vnp)), torch.stack((knl, vnl)))
    cols = args[4].long()[:, None] + torch.arange(t, device=cuda)
    rows = torch.arange(b, device=cuda)[:, None].expand(b, t)
    for a, w in ((c.k, cp.k), (c.v, cp.v)) + (((c.k_scale, cp.k_scale),) if int8 else ()):
        a, w = a.clone(), w.clone()
        a[:, rows, cols] = 0
        w[:, rows, cols] = 0
        assert torch.equal(a, w)
    if int8:
        for cache_rows, scales, new in ((c.k, c.k_scale, kn), (c.v, c.v_scale, vn)):
            q, sc = quantize_kv(new)
            assert torch.equal(cache_rows[:, rows, cols], q)
            assert torch.equal(scales[:, rows, cols], sc)


def _lora_bundle(cfg, lm, slots, scale=0.15, wide=False):
    """K4-LoRA's bundle over lm (`serve/multi_lora.SlotLora`) for adapters
    "a" (rank 16, all seven targets) and "b" (rank 2, q and down: mixed
    ranks, padded columns) and, with `wide`, "c" (rank 192, all seven
    targets, entries scaled by sqrt(16 / 192): every target wider than the
    512 columns an epilogue stages at a time), slot i on slots[i] (None: no
    adapter), with its selection rows."""
    from types import SimpleNamespace

    from tokenpacker_tpu_torch.serve.multi_lora import Adapter, SlotLora, target_dims

    g = torch.Generator(device="cpu").manual_seed(9)
    dims = target_dims(cfg)

    def make(r, targets, sc=scale):
        n = cfg.num_hidden_layers
        return Adapter({t: ((sc * torch.randn((n, dims[t][0], r), generator=g)).numpy(),
                            (sc * torch.randn((n, r, dims[t][1]), generator=g)).numpy())
                        for t in targets}, r)

    ads = {"a": make(16, list(dims)), "b": make(2, [("attn", "q"), ("mlp", "down")])}
    if wide:
        ads["c"] = make(192, list(dims), scale * (16 / 192) ** 0.5)
    sl = SlotLora({"lm": lm}, SimpleNamespace(lm=cfg), ads, len(slots))
    for i, name in enumerate(slots):
        sl.set_slot(i, name)
    return sl.overlay({"lm": lm})["lm"]["fd_slot_lora"]


def _lora_run(cfg, lm, cache, args, bundle, kernel):
    """K4 (h0 [B, D]) or K4-verify (h0 [B, T, D]), the kernel or its plain
    version, with the bundle or without (None), on a copy of the cache.
    Returns (hidden as [B, T, D], k_new, v_new, cache copy)."""
    h0, len0, start2, end2, wpos, pos = args
    c = KVCache(cache.k.clone(), cache.v.clone(), 0,
                None if cache.k_scale is None else cache.k_scale.clone(),
                None if cache.v_scale is None else cache.v_scale.clone())
    verify = h0.dim() == 3
    if kernel:
        fn = k4.fused_verify_hidden if verify else k4.fused_decode_hidden
        h, kn, vn = fn(lm, cfg, h0, c.k, c.v, len0, start2, end2, wpos, pos, k_scale=c.k_scale,
                       v_scale=c.v_scale, slot_lora=bundle)
    else:
        fn = k4.fused_verify_hidden_plain if verify else k4.fused_decode_hidden_plain
        h, kn, vn = fn(lm["layers"], cfg, h0, c.k, c.v, len0, start2, end2, pos, c.k_scale,
                       c.v_scale, bundle)
    if not verify:
        h, kn, vn = h[:, None], kn[:, :, None], vn[:, :, None]
    return h, kn, vn, c


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,int8,wide", [(4, 1, 544, True, False), (4, 1, 544, False, False),
                                             (4, 5, 544, True, False), (3, 3, 160, False, False),
                                             (4, 1, 160, True, True), (4, 3, 160, True, True)])
def test_fused_decode_lora_kernel_matches_plain(cuda, b, t, s, int8, wide):
    """K4-LoRA at T = 1 and its verify form, slots on "a", "b", none, "a"
    (with `wide`: "a", "b", none, "c", three adapters whose targets are
    576-1728 columns wide) (adapter entries of 0.15, so that the update
    stands well above the base path's roundings at these widths): the
    adapters' update (the
    hidden state with the bundle less the one without, each from the same
    implementation) per (sample, token, 128-wide slice) within
    LORA_UPDATE_REL_RMS of the plain version's update,
    which must fail with slot 0's selection zeroed or with the down
    target's term dropped; the written int8 rows equal `quantize_kv` of
    the returned rows; with every selection row zero the kernel gives K4's
    bits."""
    if t == 1:
        cfg, lm, cache, args = _k4_inputs(cuda, b, s, int8)
    else:
        cfg, lm, cache, args = _verify_inputs(cuda, b, t, s, int8)
    slots = ["a", "b", None, "c" if wide else "a"][:b]
    bundle = _lora_bundle(cfg, lm, slots, wide=wide)
    hk, kn, vn, c = _lora_run(cfg, lm, cache, args, bundle, True)
    hk0 = _lora_run(cfg, lm, cache, args, None, True)[0]
    hp = _lora_run(cfg, lm, cache, args, bundle, False)[0]
    hp0 = _lora_run(cfg, lm, cache, args, None, False)[0]
    lost_sel = {**bundle, "sel": bundle["sel"].clone()}
    lost_sel["sel"][0] = 0
    lost_down = {**bundle, "b_down": torch.zeros_like(bundle["b_down"])}
    torch.cuda.synchronize()

    def update(h, h0):
        return (h.float() - h0.float()).view(b, t, -1, 128)

    want = update(hp, hp0)
    reads = {}
    for name, lost in (("slot 0 zeroed", lost_sel), ("down dropped", lost_down)):
        worst, reads[name] = _rows_close(
            update(hk, hk0), want, update(_lora_run(cfg, lm, cache, args, lost, False)[0], hp0),
            LORA_UPDATE_REL_RMS)
    print(f"K4-LoRA B={b} T={t} S={s} {'int8' if int8 else 'bf16'} wide={wide}: worst update "
          f"{worst:.4f} (limit {LORA_UPDATE_REL_RMS}), lossy plain versions {reads}")
    if int8:
        cols = args[4].long()[:, None] + torch.arange(t, device=cuda)
        rows = torch.arange(b, device=cuda)[:, None].expand(b, t)
        for cache_rows, scales, new in ((c.k, c.k_scale, kn), (c.v, c.v_scale, vn)):
            q, sc = quantize_kv(new)
            assert torch.equal(cache_rows[:, rows, cols], q)
            assert torch.equal(scales[:, rows, cols], sc)
    empty = _lora_bundle(cfg, lm, [None] * b, wide=wide)
    assert torch.equal(_lora_run(cfg, lm, cache, args, empty, True)[0], hk0)


@pytest.mark.cuda
def test_fused_verify_at_one_token_is_the_decode_step(cuda):
    """T = 1 through the verify entry gives the decode step's bits."""
    cfg, lm, cache, args = _k4_inputs(cuda, 3, 160, True)
    h0, len0, start2, end2, wpos, pos = args
    (h, kn, _), _ = _k4_run(cfg, lm, cache, args, k4.fused_decode_hidden)
    (hv, knv, _), _ = _verify_run(cfg, lm, cache, (h0[:, None], len0, start2, end2, wpos,
                                                   pos[:, None]), "kernel")
    torch.cuda.synchronize()
    assert torch.equal(h, hv[:, 0]) and torch.equal(kn, knv[:, :, 0])


# cache lengths whose valid rows (len0 plus a decoded span of 7) total 32,
# 33, 256, 257, 512, 8, 31 and 63: on and around the attention's 32-key
# tiles and, at S = 544 (2 splits, `att_splits`), its split edges
EDGE_LEN0 = (25, 26, 249, 250, 505, 1, 24, 56)


def _edge_inputs(cuda, b, t, int8):
    """K4's rig (`_k4_inputs`, 2 layers, d 1024, f 2816) at S = 544 with
    EDGE_LEN0's lengths, a decoded span [520, 527), T fed tokens a sample
    written from 527 on (h0 [B, D] at T = 1, [B, T, D] above)."""
    cfg, lm, cache, _ = _k4_inputs(cuda, b, 544, int8)
    len0 = torch.tensor([EDGE_LEN0[i % len(EDGE_LEN0)] for i in range(b)], dtype=torch.int32,
                        device=cuda)
    start2 = torch.full_like(len0, 520)
    end2 = start2 + 7
    g = torch.Generator(device=cuda).manual_seed(11 * b + t)
    h0 = (torch.randn((b, t, cfg.hidden_size), generator=g, device=cuda) * 0.05).bfloat16()
    pos = (len0[:, None] + 7 + torch.arange(t, device=cuda)).int()
    if t == 1:
        h0, pos = h0[:, 0], pos[:, 0]
    return cfg, lm, cache, (h0, len0, start2, end2, end2, pos)


def _written_rows_are_quantize_kv(c, kn, vn, wpos, b, t):
    cols = wpos.long()[:, None] + torch.arange(t, device=wpos.device)
    rows = torch.arange(b, device=wpos.device)[:, None].expand(b, t)
    for cache_rows, scales, new in ((c.k, c.k_scale, kn), (c.v, c.v_scale, vn)):
        q, sc = quantize_kv(new)
        assert torch.equal(cache_rows[:, rows, cols], q)
        assert torch.equal(scales[:, rows, cols], sc)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("t", [1, 2, 5, 16])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_fused_decode_at_row_and_token_edges(cuda, b, t, int8):
    """K4 (T = 1) and K4-verify at 1-128 rows (B x T: one to four GEMV
    passes of 32, every row tile of the tensor-core GEMV) and 1-16 fed
    tokens, cache lengths on the attention's tile and split edges: the
    hidden state per (sample, token, 128-wide slice) and the new rows per
    (layer, sample, token, head) within BLOCK_REL_RMS of the plain version,
    two calls bit-identical, the written int8 rows equal to `quantize_kv` of
    the returned rows."""
    cfg, lm, cache, args = _edge_inputs(cuda, b, t, int8)
    (h, kn, vn, c), (h2, _, _, _) = (_lora_run(cfg, lm, cache, args, None, True) for _ in range(2))
    hp, knp, vnp, _ = _lora_run(cfg, lm, cache, args, None, False)
    torch.cuda.synchronize()
    assert torch.equal(h, h2)
    assert torch.isfinite(h.float()).all()
    assert _rows_rel(h.view(b, t, -1, 128), hp.view(b, t, -1, 128)).max().item() <= BLOCK_REL_RMS
    for got, want in ((kn, knp), (vn, vnp)):
        assert _rows_rel(got, want).max().item() <= BLOCK_REL_RMS
    if int8:
        _written_rows_are_quantize_kv(c, kn, vn, args[4], b, t)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("t", [1, 2, 5, 16])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_fused_decode_lora_at_row_and_token_edges(cuda, b, t, int8):
    """K4-LoRA at the same edges, slots cycling "a", "b", none, adapter
    entries of LORA_EDGE_SCALE: the hidden state per (sample, token,
    128-wide slice) and the new rows within BLOCK_REL_RMS of the plain
    version's with the same bundle (which the plain version without the
    bundle must fail), two calls bit-identical, and a sample with no
    adapter (an all-zero mask row) gets K4's bits without the bundle."""
    cfg, lm, cache, args = _edge_inputs(cuda, b, t, int8)
    slots = [("a", "b", None)[i % 3] for i in range(b)]
    bundle = _lora_bundle(cfg, lm, slots, scale=LORA_EDGE_SCALE)
    hk, kn, vn, c = _lora_run(cfg, lm, cache, args, bundle, True)
    hk2 = _lora_run(cfg, lm, cache, args, bundle, True)[0]
    hk0 = _lora_run(cfg, lm, cache, args, None, True)[0]
    hp, knp, vnp, _ = _lora_run(cfg, lm, cache, args, bundle, False)
    hp0 = _lora_run(cfg, lm, cache, args, None, False)[0]
    torch.cuda.synchronize()
    assert torch.equal(hk, hk2)
    adapted = [i for i, sl in enumerate(slots) if sl is not None]

    def slices(h):
        return h[adapted].view(len(adapted), t, -1, 128)

    _rows_close(slices(hk), slices(hp), slices(hp0))  # the plain version without the term fails
    assert _rows_rel(hk.view(b, t, -1, 128), hp.view(b, t, -1, 128)).max().item() <= BLOCK_REL_RMS
    for got, want in ((kn, knp), (vn, vnp)):
        assert _rows_rel(got, want).max().item() <= BLOCK_REL_RMS
    for i, sl in enumerate(slots):
        if sl is None:
            assert torch.equal(hk[i], hk0[i])
    if int8:
        _written_rows_are_quantize_kv(c, kn, vn, args[4], b, t)


@pytest.mark.cuda
def test_fused_decode_launches_the_step_plan(cuda):
    """The splits K4's host code launches (`kernel_plan`) are `step_plan`'s,
    the mirror that the CPU tests check: B's and G's steps on this card, then
    a sweep of samples, fed tokens, widths and cache lengths at 132 and 114
    SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = [(4, 1, 4096, 11008, 32, 2080, sms), (4, 5, 4096, 11008, 32, 2080, sms)]
    cases += [(b, t, heads * 128, f, heads, s, n) for b in (1, 3, 4, 8) for t in (1, 5, 16)
              for heads in (8, 32) for f in (2816, 11008) for s in (160, 544, 2080)
              for n in (132, 114)]
    for case in cases:
        assert k4.kernel_plan(*case) == k4.step_plan(*case), case


# ---- item: int8 rows bit for bit -------------------------------------------------


@pytest.mark.cuda
def test_quantize_kv_on_the_card_equals_the_cpu(cuda):
    """200,000 random rows of 128 (bf16 rows at three magnitudes, an
    all-zero row): the int8 values and scales from the card equal the
    CPU's bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((200_000, 128), generator=g)
    x *= torch.logspace(-3, 2, 200_000)[:, None]
    x[0] = 0
    x = x.bfloat16()
    (qc, sc), (qg, sg) = quantize_kv(x), quantize_kv(x.to(cuda))
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)


@pytest.mark.cuda
def test_int4_codes_on_the_card_equal_the_cpu_and_k6(cuda):
    """dequantize_4bit of an int4 leaf on the card equals the CPU's bit for
    bit, and K6 with one-hot rows reads the same weights (its code table
    (i - 8) / 7 times the block's absmax, rounded to bf16)."""
    w = _bf16((256, 128), 3, "cpu").float()
    leaf = quantize_4bit(w, 64, "int4")
    gleaf = {k: v.to(cuda) for k, v in leaf.items()}
    want = dequantize_4bit(leaf, torch.float32)
    assert torch.equal(dequantize_4bit(gleaf, torch.float32).cpu(), want)
    eye = torch.eye(256, dtype=torch.bfloat16, device=cuda)
    got = torch.cat([q4_matmul(eye[i:i + 32], gleaf) for i in range(0, 256, 32)])
    assert torch.equal(got.cpu(), want.bfloat16())


# ---- MPT: K2's key-only bias (both directions) and K3's slopes -------------------


def _alibi_rows(h, t, device, noise_seed=None):
    """MPT's ALiBi as the key-only bias [1, H, 1, T] fp32 (MPT-7B's slopes at
    32 heads); with `noise_seed` plus N(0, 0.3^2), so that a bias read at
    the wrong key or head shows."""
    from tokenpacker_tpu_torch.models.mpt import alibi_bias

    bias = alibi_bias(h, t, device)
    if noise_seed is not None:
        g = torch.Generator(device="cpu").manual_seed(noise_seed)
        bias = bias + 0.3 * torch.randn(bias.shape, generator=g).to(device)
    return bias


def _bwd_bias_by_query(q, k, v, o, lse, do, bias):
    """A lossy backward (fp32, MHA, Tq == Tk, causal): dq as it should be,
    dk and dv from P rebuilt with the bias indexed by the query instead of
    the key, as a dk/dv kernel that reads the wrong axis would give them."""
    n, t, h, d = q.shape
    dq = flash_attention_bwd_plain(q, k, v, o, lse, do, True, bias)[0]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    rows = bias.float().reshape(-1, t).expand(h, t)
    s = torch.einsum("nqhd,nkhd->nhqk", qf, kf) * d**-0.5 + rows[None, :, :, None]
    p = torch.exp(s - lse.view(n, h, t, 1))
    p = p.masked_fill(torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1), 0.0)
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qf) * d**-0.5
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,tq,tk,h,noise", [
    (1, 2048, 2048, 32, False),  # MPT-7B's prefill at the longest bucket
    (2, 700, 700, 32, True),
    (2, 64, 300, 8, True),  # queries aligned to the end of the keys
    (1, 100, 40, 4, True),  # first 60 rows see no key
    (3, 17, 17, 4, True),
])
def test_flash_bias_kernel_matches_plain(cuda, n, tq, tk, h, noise):
    """K2's key-only bias form against its plain version: o per (sample, 64
    rows, head) block and lse, as the no-bias form; the kernel run without
    the bias, and the plain version with the last head's slopes zeroed,
    must fail the block hold."""
    q = _bf16((n, tq, h, 128), 0, cuda)
    k, v = _bf16((n, tk, h, 128), 1, cuda), _bf16((n, tk, h, 128), 2, cuda)
    bias = _alibi_rows(h, tk, cuda, 5 if noise else None)
    before = (flash_attention.launches, flash_attention.bias_launches)
    o, lse = flash_attention(q, k, v, True, bias)
    assert (flash_attention.launches, flash_attention.bias_launches) == (before[0], before[1] + 1)
    want_o, want_lse = flash_attention_plain(q, k, v, True, bias)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)
    unbiased, _ = flash_attention(q, k, v, True)
    zeroed = bias.clone()
    zeroed[:, -1] = 0
    last_head_lost, _ = flash_attention_plain(q, k, v, True, zeroed)
    for lossy in (unbiased, last_head_lost):
        assert _blocks_rel(lossy, want_o).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h", [(1, 2048, 32), (2, 333, 8), (1, 70, 4)])
def test_flash_bias_bwd_kernel_matches_plain(cuda, n, t, h):
    """K2's backward with the key-only bias against its plain version, dq,
    dk and dv per block; two calls give the same bits. A backward whose
    recompute drops the bias, and one whose dk/dv reads the bias by query,
    must fail the hold."""
    q = _bf16((n, t, h, 128), 0, cuda)
    k, v = _bf16((n, t, h, 128), 1, cuda), _bf16((n, t, h, 128), 2, cuda)
    do = _bf16((n, t, h, 128), 3, cuda)
    bias = _alibi_rows(h, t, cuda, 6)
    o, lse = flash_attention(q, k, v, True, bias)
    before = flash_attention_bwd.bias_launches
    got = flash_attention_bwd(q, k, v, o, lse, do, True, bias)
    again = flash_attention_bwd(q, k, v, o, lse, do, True, bias)
    assert flash_attention_bwd.bias_launches == before + 2
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True, bias)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w)
        _blocks_close(g, w)
    # without the bias the saved lse no longer matches the logits: far keys'
    # P overflows to inf (NaN gradients), which must read as a failure too
    dropped = flash_attention_bwd(q, k, v, o, lse, do, True)
    by_query = _bwd_bias_by_query(q, k, v, o, lse, do, bias)
    for lossy in (dropped, by_query):
        readings = [_blocks_rel(g, w).max().item() for g, w in zip(lossy, want)]
        assert any(not r <= BLOCK_REL_RMS for r in readings), readings
    assert _blocks_rel(by_query[0], want[0]).max().item() <= BLOCK_REL_RMS  # only dk/dv lost


@pytest.mark.cuda
def test_flash_bias_autograd_launches_both_bias_kernels(cuda):
    q = _bf16((1, 256, 8, 128), 0, cuda).requires_grad_()
    k = _bf16((1, 256, 8, 128), 1, cuda).requires_grad_()
    v = _bf16((1, 256, 8, 128), 2, cuda).requires_grad_()
    do = _bf16((1, 256, 8, 128), 3, cuda)
    bias = _alibi_rows(8, 256, cuda)
    counts = (flash_attention.launches, flash_attention.bias_launches,
              flash_attention_bwd.launches, flash_attention_bwd.bias_launches)
    o = FlashAttention.apply(q, k, v, True, bias)
    grads = torch.autograd.grad(o, (q, k, v), do)
    now = (flash_attention.launches, flash_attention.bias_launches,
           flash_attention_bwd.launches, flash_attention_bwd.bias_launches)
    assert tuple(b - a for a, b in zip(counts, now)) == (0, 1, 0, 1)
    o2, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), True, bias)
    for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, o2, lse, do, True, bias)):
        _close(g, w)


def _decode_alibi_slots(q, ck, cv, lengths, needed, span_start, slopes):
    """A lossy K3-ALiBi (fp32): the slopes times the keys' cache slot
    indices, where the decoded span's keys sit at compacted positions."""
    n, h, d = q.shape
    s = ck.shape[1]
    logits = torch.einsum("nhd,nshd->nhs", q.float(), ck.float()) * d**-0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = (kpos < needed[:, None]) & ((kpos < lengths[:, None]) | (kpos >= span_start))
    logits = logits + slopes[None, :, None] * kpos[:, None, :].float()
    probs = torch.softmax(logits.masked_fill(~valid[:, None], float("-inf")), -1).to(q.dtype)
    return torch.einsum("nhs,nshd->nhd", probs, cv)


@pytest.mark.cuda
@pytest.mark.parametrize("s,span_start", [(2080, 2048), (1040, 1000), (1040, 0)])
def test_decode_alibi_kernel_matches_plain(cuda, s, span_start):
    """K3's slopes form (MPT-7B's 32 slopes) against its plain version, per
    (sample, head) row, at the bucketed layout of the HD requests' lengths
    (span_start = the bucket) and the contiguous one. The plain version
    with the keys at their slot indices instead of the compacted token
    positions (span_start > 0), and the plain version without slopes, must
    fail the hold."""
    from tokenpacker_tpu_torch.models.mpt import alibi_slopes

    n, h = 4, 32
    q = _bf16((n, h, 128), 0, cuda)
    ck, cv = _bf16((n, s, h, 128), 1, cuda), _bf16((n, s, h, 128), 2, cuda)
    slopes = alibi_slopes(h, device=cuda)
    if span_start:
        lengths = torch.tensor([1751, 1379, 701, 939], dtype=torch.int32, device=cuda)
        lengths = lengths.clamp(max=span_start)
        needed = torch.full((n,), span_start + 31, dtype=torch.int32, device=cuda)
    else:
        lengths = torch.tensor([1, 333, 650, 1040], dtype=torch.int32, device=cuda)
        needed = lengths
    before = (decode_attention.launches, decode_attention.alibi_launches)
    got = decode_attention(q, ck, cv, lengths, needed, span_start, slopes)
    assert (decode_attention.launches, decode_attention.alibi_launches) == (before[0],
                                                                            before[1] + 1)
    want = decode_attention_plain(q, ck, cv, lengths, needed, span_start, slopes)
    no_slopes = decode_attention_plain(q, ck, cv, lengths, needed, span_start)
    _rows_close(got, want, no_slopes)
    if span_start:
        slots = _decode_alibi_slots(q, ck, cv, lengths, needed, span_start, slopes)
        assert _rows_rel(slots, want).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
def test_bias_and_slopes_forms_reject_what_they_do_not_take(cuda):
    q = _bf16((1, 64, 4, 128), 0, cuda)
    with pytest.raises(ValueError, match="key-only"):
        flash_attention(q, q, q, True, torch.zeros((1, 4, 64, 63), device=cuda))
    qd = _bf16((2, 8, 128), 1, cuda)
    ck = _bf16((2, 16, 2, 128), 2, cuda)  # GQA: slopes are MHA-only
    ones = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slopes"):
        decode_attention(qd, ck, ck, ones, ones, 0, torch.ones(8, device=cuda))


# -- K2's full-bias form ------------------------------------------------------------


def _full_bias(kind, n, h, tq, tk, device, seed):
    """A full bias [N|1, H|1, Tq, Tk] fp32 of N(0, 2^2) ("prefix": MPT-7B's
    prefix-LM mask over right-padded samples plus its ALiBi, [N, H, T, T])."""
    from tokenpacker_tpu_torch.models.mpt import alibi_bias, make_prefix_lm_bias

    if kind == "prefix":
        lengths = torch.tensor([tk, tk * 3 // 4, tk // 2, tk // 3][:n], device=device)
        positions = torch.arange(tq, device=device).expand(n, tq)
        key_valid = torch.arange(tk, device=device)[None, :] < lengths[:, None]
        return make_prefix_lm_bias(positions, key_valid, lengths // 2, tk) + alibi_bias(h, tk,
                                                                                       device)
    shape = (n if "n" in kind else 1, h if "h" in kind else 1, tq, tk)
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (2.0 * torch.randn(shape, generator=g)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,tq,tk,h,hkv,causal,kind", [
    (1, 2048, 2048, 32, 32, False, "prefix"),  # MPT-7B's prefix-LM + ALiBi, one sample
    (4, 300, 300, 32, 32, False, "prefix"),
    (2, 700, 700, 32, 8, True, "nh"),
    (2, 64, 300, 8, 2, True, "1h"),  # queries aligned to the end of the keys
    (1, 333, 333, 4, 4, False, "n1"),
    (3, 17, 17, 4, 4, False, "11"),
    (1, 100, 40, 4, 4, True, "11"),  # first 60 rows see no key
])
def test_flash_full_bias_kernel_matches_plain(cuda, n, tq, tk, h, hkv, causal, kind):
    """K2's full-bias form against its plain version: o per (sample, 64
    rows, head) block and lse; the kernel without the bias, and the plain
    version with the bias's last key tile dropped, must fail the hold."""
    q = _bf16((n, tq, h, 128), 0, cuda)
    k, v = _bf16((n, tk, hkv, 128), 1, cuda), _bf16((n, tk, hkv, 128), 2, cuda)
    bias = _full_bias(kind, n, h, tq, tk, cuda, 7)
    before = (flash_attention.launches, flash_attention.bias_launches,
              flash_attention.full_bias_launches)
    o, lse = flash_attention(q, k, v, causal, bias)
    assert (flash_attention.launches, flash_attention.bias_launches,
            flash_attention.full_bias_launches) == (before[0], before[1], before[2] + 1)
    want_o, want_lse = flash_attention_plain(q, k, v, causal, bias)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)
    dropped = bias.clone()
    dropped[..., -64:] = 0
    for lossy in (flash_attention(q, k, v, causal)[0],
                  flash_attention_plain(q, k, v, causal, dropped)[0]):
        assert _blocks_rel(lossy, want_o).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [float(torch.finfo(torch.float32).min), -1e38, -2e30])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_full_bias_masked_rows(cuda, masked, causal):
    """Rows whose bias lies below -1e30 on every key: o = 0 and lse = +inf
    in the kernel and its plain version alike (the TPU kernel's rule: its
    online max starts at -1e30); the other rows held as usual."""
    n, t, h = 2, 256, 4
    q = _bf16((n, t, h, 128), 0, cuda)
    k, v = _bf16((n, t, h, 128), 1, cuda), _bf16((n, t, h, 128), 2, cuda)
    bias = _full_bias("n1", n, h, t, t, cuda, 8)
    rows = [(0, 5), (0, 200), (1, 0), (1, 255)]
    for i, r in rows:
        bias[i, 0, r] = masked
    o, lse = flash_attention(q, k, v, causal, bias)
    want_o, want_lse = flash_attention_plain(q, k, v, causal, bias)
    lse = lse.view(n, h, t)
    for i, r in rows:
        assert not o[i, r].any() and torch.isinf(lse[i, :, r]).all() and (lse[i, :, r] > 0).all()
    _close(o, want_o)
    _close(lse.view(n * h, t), want_lse)
    _blocks_close(o, want_o)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h,causal,kind", [
    (3, 255, 4, True, "1h"),  # broadcast over N
    (3, 129, 4, False, "1h"),
    (3, 255, 4, True, "n1"),  # broadcast over H
    (2, 2049, 4, False, "n1"),
])
def test_flash_full_bias_broadcast_at_tile_edges(cuda, n, t, h, causal, kind):
    """The full-bias form with a bias broadcast over N, then over H, read in
    place (stride 0), at lengths around the forward's 128-row tiles."""
    q = _bf16((n, t, h, 128), 0, cuda)
    k, v = _bf16((n, t, h, 128), 1, cuda), _bf16((n, t, h, 128), 2, cuda)
    bias = _full_bias(kind, n, h, t, t, cuda, 13)
    o, lse = flash_attention(q, k, v, causal, bias)
    want_o, want_lse = flash_attention_plain(q, k, v, causal, bias)
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)
    dropped = bias.clone()
    dropped[..., -64:] = 0
    assert _blocks_rel(flash_attention_plain(q, k, v, causal, dropped)[0],
                       want_o).max().item() > BLOCK_REL_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_full_bias_masked_rows_at_tile_edges(cuda, causal):
    """ROADMAP R9, as accepted for the port: rows whose biased logits all lie
    below -1e30 get o = 0 and lse = +inf, also where they lie on either side
    of the forward's 128-row block edges and its warpgroups' 64-row halves,
    and with a bias that is -1e38 only on the keys that row can see."""
    n, t, h = 2, 300, 4
    q = _bf16((n, t, h, 128), 0, cuda)
    k, v = _bf16((n, t, h, 128), 1, cuda), _bf16((n, t, h, 128), 2, cuda)
    bias = _full_bias("nh", n, h, t, t, cuda, 14)
    rows = [(0, 63), (0, 64), (0, 127), (0, 128), (1, 129), (1, 255), (1, 256), (1, 299)]
    for i, r in rows:
        bias[i, :, r] = float(torch.finfo(torch.float32).min)
    # row 200: below -1e30 on every key it sees, ordinary values above the
    # diagonal, which the causal form masks itself
    bias[0, :, 200, :201] = -1e38
    dead = rows + ([(0, 200)] if causal else [])
    o, lse = flash_attention(q, k, v, causal, bias)
    want_o, want_lse = flash_attention_plain(q, k, v, causal, bias)
    lse3 = lse.view(n, h, t)
    for i, r in dead:
        assert not o[i, r].any() and bool((lse3[i, :, r] == torch.inf).all())
    _close(o, want_o)
    _close(lse, want_lse)
    _blocks_close(o, want_o)


@pytest.mark.cuda
def test_flash_full_bias_autograd_runs_the_reference_backward(cuda):
    """`FlashAttention.apply` with a full bias launches the full-bias form
    forward and no backward kernel (its backward is the plain
    `flash_attention_bwd_reference` on the card); every gradient, the
    bias's included, equals that function's on the kernel's own o and lse."""
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

    n, t, h = 2, 256, 8
    q, k, v = (_bf16((n, t, h, 128), i, cuda).requires_grad_() for i in range(3))
    do = _bf16((n, t, h, 128), 3, cuda)
    bias = _full_bias("1h", n, h, t, t, cuda, 9).requires_grad_()
    counts = (flash_attention.full_bias_launches, flash_attention_bwd.launches,
              flash_attention_bwd.bias_launches)
    o = FlashAttention.apply(q, k, v, True, bias)
    grads = torch.autograd.grad(o, (q, k, v, bias), do)
    now = (flash_attention.full_bias_launches, flash_attention_bwd.launches,
           flash_attention_bwd.bias_launches)
    assert tuple(b - a for a, b in zip(counts, now)) == (1, 0, 0)
    o2, lse = flash_attention(q.detach(), k.detach(), v.detach(), True, bias.detach())
    want = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o2, lse, do, True,
                                         bias.detach())
    assert grads[3].shape == bias.shape
    for g, w in zip(grads, want):
        assert torch.isfinite(g.float()).all()
        _close(g, w)


# -- the card probes P1-P4 -------------------------------------------------------------


def _int8(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(device)


def _value_close(got, want, limit=1e-4):
    """A GEMV chain's value [B, 1] within `limit` of the largest |value|:
    fp32 sums of 512 products a column, then a block's columns, against the
    plain version's float64 (~1e-6 expected); a lost chunk reads ~0.1-1."""
    err = (got.double() - want.double()).abs().max().item()
    assert torch.isfinite(got).all() and err <= limit * want.double().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("copies,col_off,width", [(1, 0, 11008), (2, 0, 22016),
                                                  (2, 11008, 22016)])
def test_dma_stride_kernel_matches_plain(cuda, copies, col_off, width):
    from tokenpacker_tpu_torch.probes import dma_stride

    src = _int8((copies, 4096, width), 10, cuda)
    before = dma_stride.stream.launches
    for reps in (21, 64):
        got = dma_stride.stream(src, col_off, reps)
        assert torch.equal(got, dma_stride.stream_plain(src, col_off, reps))
    assert dma_stride.stream.launches == before + 2
    other = dma_stride.stream(src, col_off, 20)  # one chunk fewer: another sum
    assert not torch.equal(other, dma_stride.stream_plain(src, col_off, 21))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_int4_ring_kernel_matches_plain(cuda, b, mode):
    from tokenpacker_tpu_torch.probes import int4_ring

    k, n = 1024, 4096
    w = _int8((2, k if mode == "int8" else k // 2, n), 11, cuda)
    x = _bf16((b, k), 12, cuda) * 0.1
    got = int4_ring.chain(x, w, 3, mode)
    want = int4_ring.chain_plain(x, w, 3, mode)
    _value_close(got, want)
    again = int4_ring.chain(x, w, 3, mode)
    assert torch.equal(got, again)
    lossy = int4_ring.chain_plain(x[:, :512], w[:, :w.shape[1] // 2], 3, mode)
    err = (lossy.double() - want.double()).abs().max().item()
    assert err > 1e-4 * want.double().abs().max().item()


@pytest.mark.cuda
def test_bitcast_pack_kernels_match_plain(cuda):
    from tokenpacker_tpu_torch.probes import bitcast_pack

    w8 = _int8((2, 1024, 4352), 13, cuda)
    packed = bitcast_pack.pack_rows(w8)
    assert torch.equal(packed, bitcast_pack.pack_rows_plain(w8))
    assert torch.equal(bitcast_pack.unpack_rows(packed), w8)
    labels = torch.arange(64, dtype=torch.int8, device=cuda)[:, None].expand(64, 256).contiguous()
    lab = bitcast_pack.pack_rows(labels)[:, 0].to(torch.int32) & 0xFFFF
    assert [(int(v) & 0xFF, int(v) >> 8) for v in lab] == [(2 * r, 2 * r + 1) for r in range(32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 8])
def test_bitcast_stream_kernel_matches_plain(cuda, b):
    from tokenpacker_tpu_torch.probes import bitcast_pack

    w8 = _int8((2, 1024, 12288), 14, cuda)
    wp = bitcast_pack.pack_rows(w8)
    x = _bf16((b, 1024), 15, cuda) * 0.1
    outs = []
    for w, packed in ((w8, False), (wp, True)):
        value, checksum = bitcast_pack.stream(x, w, 3, packed)
        want_value, want_checksum = bitcast_pack.stream_plain(x, w, 3, packed)
        _value_close(value, want_value)
        assert torch.equal(checksum, want_checksum)
        outs.append((value, checksum))
    assert torch.equal(outs[0][1], outs[1][1])
    _value_close(outs[1][0], outs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "int16", "uint16", "int32", "bf16"])
@pytest.mark.parametrize("vector", [False, True])
def test_stream_dtype_kernel_matches_plain(cuda, name, vector):
    from tokenpacker_tpu_torch.probes import stream_dtype

    g = torch.Generator(device=cuda).manual_seed(16)
    x, w = stream_dtype.make_case(name, cuda, g)
    w = w[:2, :, :1024].contiguous()
    value, checksum = stream_dtype.stream(x, w, 3, vector)
    want_value, want_checksum = stream_dtype.stream_plain(x, w, 3)
    assert torch.equal(checksum, want_checksum)
    torch.testing.assert_close(value, want_value, rtol=1e-6, atol=0)
    fewer = stream_dtype.stream(x, w, 2, vector)[1]
    assert not torch.equal(fewer, want_checksum)


@pytest.mark.cuda
def test_probe_kernels_reject_what_they_do_not_take(cuda):
    from tokenpacker_tpu_torch.probes import bitcast_pack, dma_stride, int4_ring

    with pytest.raises(ValueError):
        dma_stride.stream(_int8((4096, 11008), 0, cuda), 8, 4)  # offset not 16-byte aligned
    with pytest.raises(ValueError):
        int4_ring.chain(_bf16((1, 1024), 0, cuda), _int8((2, 1024, 4096), 0, cuda), 3, "int4")
    with pytest.raises(ValueError, match="rows are not taken"):
        int4_ring.chain(_bf16((3, 1024), 0, cuda), _int8((2, 1024, 4096), 0, cuda), 3, "int8")
    with pytest.raises(ValueError):
        bitcast_pack.stream(_bf16((2, 1024), 0, cuda), _int8((2, 1024, 4096), 0, cuda), 3, True)


# -- sampling, penalties, logprobs and the beam reorder on the card ---------------------
# (no kernel of their own: plain PyTorch ops that must stay on the device)


def _sampling_rows(device, n=4, vocab=32000):
    """A [n, vocab] bf16 step's inputs as the batchers make them: per-row
    settings, the seed keys (`generate.seed_keys`), penalty counts and
    prompt presence, all on `device`."""
    from tokenpacker_tpu_torch.generate import seed_keys

    g = torch.Generator(device="cpu").manual_seed(21)
    logits = (torch.randn((n, vocab), generator=g) * 3).to(device=device, dtype=torch.bfloat16)
    rows = {
        "temperature": torch.tensor([0.0, 0.7, 1.0, 0.8], device=device)[:n],
        "top_p": torch.tensor([1.0, 0.9, 0.95, 1.0], device=device)[:n],
        "top_k": torch.tensor([0, 50, 0, 40], device=device)[:n],
        "min_p": torch.tensor([0.0, 0.05, 0.1, 0.0], device=device)[:n],
        "keys": torch.as_tensor(seed_keys([-1, -1, 1234, 7], [0, 3, 5, 0]), device=device)[:n],
    }
    counts = torch.randint(0, 3, (n, vocab), generator=g, dtype=torch.int32).to(device)
    presence = (torch.rand((n, vocab), generator=g) < 0.01).to(device)
    return logits, rows, counts, presence


@pytest.mark.cuda
def test_sampler_runs_without_a_host_sync(cuda):
    """Penalties, the four filters, the seeded and unseeded draw and the
    logprob rows on a [4, 32000] bf16 step under the sync debug mode
    "error": none of them waits for the device."""
    from tokenpacker_tpu_torch.generate import apply_penalties, logprob_rows, sample_tokens

    logits, rows, counts, presence = _sampling_rows(cuda)
    rep = torch.tensor([[1.0], [1.1], [1.2], [1.0]], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pen = apply_penalties(logits, counts, presence, rep, 0.1, 0.2)
        toks = sample_tokens(pen, rows["temperature"], rows["top_p"], rows["top_k"],
                             rows["min_p"], gen, rows["keys"])
        chosen, top_lps, top_ids = logprob_rows(logits, toks, 5)
        greedy = sample_tokens(logits, 0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert toks.device.type == "cuda" and toks[0] == pen[0].argmax()
    assert greedy.shape == (4,) and top_ids.shape == (4, 5)


@pytest.mark.cuda
def test_sampler_on_the_card_matches_the_cpu(cuda):
    """On the same logits the card's filters keep the CPU's entries, its
    penalties and seeded noise are the CPU's bit for bit, its draws lie in
    the filters' support, and a seeded row draws the CPU's token."""
    from tokenpacker_tpu_torch.generate import (
        apply_penalties,
        filter_logits,
        sample_tokens,
        seeded_uniform,
    )

    logits, rows, counts, presence = _sampling_rows(cuda)
    cpu_rows = {k: v.cpu() for k, v in rows.items()}
    pen = apply_penalties(logits, counts, presence, 1.2, 0.3, 0.1)
    pen_cpu = apply_penalties(logits.cpu(), counts.cpu(), presence.cpu(), 1.2, 0.3, 0.1)
    assert torch.equal(pen.cpu(), pen_cpu)
    args = [rows[k] for k in ("temperature", "top_k", "top_p", "min_p")]
    kept = torch.isfinite(filter_logits(pen, *args))
    assert torch.equal(kept.cpu(), torch.isfinite(filter_logits(
        pen_cpu, *[cpu_rows[k] for k in ("temperature", "top_k", "top_p", "min_p")])))
    u = seeded_uniform(rows["keys"], 32000)
    assert torch.equal(u.cpu(), seeded_uniform(cpu_rows["keys"], 32000))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(20):
        toks = sample_tokens(pen, rows["temperature"], rows["top_p"], rows["top_k"],
                             rows["min_p"], gen, rows["keys"])
        assert kept[torch.arange(4, device=cuda), toks].all()
    cpu_toks = sample_tokens(pen_cpu, cpu_rows["temperature"], cpu_rows["top_p"],
                             cpu_rows["top_k"], cpu_rows["min_p"], torch.Generator(),
                             cpu_rows["keys"])
    assert torch.equal(toks[2:].cpu(), cpu_toks[2:])  # the seeded rows


@pytest.mark.cuda
def test_beam_reorder_moves_int8_scales_on_the_card(cuda):
    """The beam reorder of an int8 cache on the card: k, v and both scales
    of the decoded span come from the source rows, the prompt's rows stay."""
    from tokenpacker_tpu_torch.beam import _gather_cache

    lc = LMConfig(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                  num_attention_heads=4)
    cache = KVCache.create(lc, 6, 64, dtype=torch.int8, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(cache, name)
        a.copy_(torch.randint(-100, 100, a.shape, device=cuda, generator=g).to(a.dtype))
    before = {name: getattr(cache, name).clone() for name in ("k", "v", "k_scale", "v_scale")}
    idx = torch.tensor([2, 2, 0, 5, 3, 3], device=cuda)
    _gather_cache(cache, idx, 32, 48)
    for name, old in before.items():
        a = getattr(cache, name)
        assert torch.equal(a[:, :, :32], old[:, :, :32]) and torch.equal(a[:, :, 48:], old[:, :, 48:])
        assert torch.equal(a[:, :, 32:48], old[:, idx, 32:48])


class _WordTokenizer:
    """BOS, then one id a word from 100 up in order of first sight; decode
    writes "<id>" for every id, so texts compare ids."""

    bos_token_id, pad_token_id = 1, 0

    def __init__(self):
        self.vocab = {}

    def convert_tokens_to_ids(self, token):
        return self.vocab.setdefault(token, 100 + len(self.vocab))

    def __call__(self, text):
        from types import SimpleNamespace

        return SimpleNamespace(input_ids=[1] + [self.convert_tokens_to_ids(w)
                                                for w in text.replace("\n", " \n ").split(" ")
                                                if w])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"<{int(i)}>" for i in ids)


@pytest.mark.cuda
def test_paged_worker_on_the_card_matches_generator(cuda):
    """The HTTP worker's paged scheduler on the card at tiny geometry (the
    tower's heads of 64, the LM's of 128, an int8 pool): a greedy request
    with an image streams through K1 and K5 (their counters move), and its
    ids, read from its logprob entries, equal those of a `Generator` over
    the same weights wherever the Generator's top-2 margin exceeds 0.1
    (bf16 roundings differ between K5 and the dense decode attention)."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    from tokenpacker_tpu_torch.config import VisionConfig, tiny_vlm_config
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.serve.model_worker import ModelWorker

    vc = VisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                      num_attention_heads=2, image_size=112, patch_size=14,
                      multi_layers=(1, 2, 3, 4))
    lc = LMConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=1024)
    cfg = tiny_vlm_config(vision=vc, lm=lc, dtype=torch.bfloat16)
    params = init_vlm_on_device(cfg, seed=3, device=cuda, dtype=torch.bfloat16)
    tok = _WordTokenizer()
    worker = ModelWorker.from_params(params, cfg, tok, "tiny", 1024, scheduler="paged",
                                     scheduler_slots=2, scheduler_max_len=256,
                                     kv_cache_dtype=torch.int8, warmup=True)
    try:
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (90, 120, 3), np.uint8)).save(
            buf, format="PNG")
        payload = {"prompt": "USER: <image>\nwhat is in the picture ASSISTANT:",
                   "images": [base64.b64encode(buf.getvalue()).decode()],
                   "temperature": 0.0, "max_new_tokens": 12, "logprobs": 0}
        k1, k5 = vit_attention.launches, paged_attention.launches
        chunks = [json.loads(c[:-1]) for c in worker.generate_stream(dict(payload))]
        assert all(c["error_code"] == 0 for c in chunks)
        assert vit_attention.launches > k1 and paged_attention.launches > k5
        ids = [e["id"] for c in chunks for e in c.get("logprobs", [])]
        batch, spliced = worker.plan(payload["prompt"], payload["images"])
        assert chunks[-1]["usage"]["prompt_tokens"] == spliced
        ref = Generator(params, cfg, tok, kv_cache_dtype=torch.int8)
        entries = [e for _, e in ref.generate_stream(batch, max_new_tokens=12, logprobs=2)]
        want = [e["id"] for e in entries]
        assert len(ids) > 1
        for j, (a, b) in enumerate(zip(ids, want)):
            if a != b:
                (_, lp0), (_, lp1) = entries[j]["top"]
                assert lp0 - lp1 <= 0.1, (j, ids, want)
                break
    finally:
        worker.batcher.stop()


@pytest.mark.cuda
def test_worker_without_a_card_raises(cuda, tmp_path):
    """With no card visible, a worker made for the card raises: it never
    loads onto the CPU instead."""
    import os
    import subprocess
    import sys

    code = ("from tokenpacker_tpu_torch.serve.model_worker import ModelWorker\n"
            f"ModelWorker('http://localhost:1', 'http://localhost:2', {str(tmp_path)!r}, "
            "no_register=True, warmup=False)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def _rel_rms(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).square().sum().sqrt() / want.square().sum().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nf4", "int8"])
def test_quantized_product_keeps_dx_on_the_card(cuda, form):
    """`linear` over a frozen quantized leaf under autograd on the card (the
    QLoRA base product): nf4 at M = 4 through K6 (its launch counted), int8
    through the weight-only product. The output stays on the graph and dx
    equals the dequantized product's: for nf4 the same dy @ deq(W)^T in
    bf16, bit for bit; for int8 (dy * scale) @ q^T against dy @ bf16(q *
    scale)^T, within 1e-2 relative RMS (bf16 rounds the dequantized weight
    only in the second). The forward within BLOCK_REL_RMS of the dense
    bf16 product."""
    g = torch.Generator().manual_seed(7)
    w = (torch.randn(4096, 1024, generator=g) * 0.02).to(cuda)
    if form == "nf4":
        leaf = quantize_4bit(w, 64, "nf4")
        dense = dequantize_4bit(leaf, torch.bfloat16)
    else:
        q, scale = quantize_int8(w)
        leaf = {"q": q, "scale": scale}
        dense = (q.float() * scale).to(torch.bfloat16)
    x = torch.randn(4, 4096, generator=g).to(cuda, torch.bfloat16).requires_grad_(True)
    dy = torch.randn(4, 1024, generator=g).to(cuda, torch.bfloat16)
    before = q4_matmul.launches
    y = layers.linear({"kernel": leaf}, x)
    assert y.grad_fn is not None
    assert q4_matmul.launches == before + (form == "nf4")
    (dx,) = torch.autograd.grad(y, x, dy)
    x2 = x.detach().clone().requires_grad_(True)
    want_y = x2 @ dense
    (want,) = torch.autograd.grad(want_y, x2, dy)
    if form == "nf4":
        assert torch.equal(dx, want)
    else:
        assert _rel_rms(dx, want) < 1e-2
    assert _rel_rms(y, want_y) < BLOCK_REL_RMS


@pytest.mark.cuda
def test_qlora_step_on_the_card_matches_the_cpu(cuda):
    """One QLoRA step at a small size (the tower's heads of 64, the LM's of
    128, its kernels nf4): loss and the gradients of every adapter and
    projector leaf, card bf16 (K1, K2 both ways) against CPU fp32 (plain
    versions). Bands as chip_smoke.py phase 9's: the loss within 1e-2
    relative, each adapter leaf's gradient within 5e-2 relative RMS and
    each projector leaf's within 1e-1 of its own norm or, for a leaf
    below 1e-3 of the projector's gradient norm, of that share."""
    import numpy as np

    from tokenpacker_tpu_torch.config import VisionConfig, tiny_vlm_config
    from tokenpacker_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to
    from tokenpacker_tpu_torch.models.splice import build_splice_plan
    from tokenpacker_tpu_torch.ops.quantize import quantize_tree_4bit
    from tokenpacker_tpu_torch.train.lora import (
        LoraConfig,
        adapter_leaves,
        init_lora,
        lora_loss,
    )
    from tokenpacker_tpu_torch.train.step import leaves_with_paths

    vc = VisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                      num_attention_heads=2, image_size=112, patch_size=14,
                      multi_layers=(1, 2, 3, 4))
    lc = LMConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=1024)
    cfg = tiny_vlm_config(vision=vc, lm=lc, dtype=torch.bfloat16)
    params = init_vlm_on_device(cfg, seed=5, device=cuda, dtype=torch.bfloat16)
    params = {**params, "lm": quantize_tree_4bit(params["lm"])}
    lcfg = LoraConfig(r=8, alpha=16)
    lora = init_lora(1, params, lcfg)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in adapter_leaves(lora)[1::2]:
            t.copy_(torch.randn(t.shape, generator=g) * 0.01)
    rng = np.random.default_rng(0)
    ids, labels = [], []
    for n in (90, 60):
        text = rng.integers(3, lc.vocab_size, n)
        ids.append(np.concatenate([[1, IMAGE_TOKEN_INDEX], text]).astype(np.int64))
        labels.append(np.concatenate([[IGNORE_INDEX] * 2, text]).astype(np.int64))
    plan = build_splice_plan(ids, [[(1, 1)]] * 2, cfg.tokens_per_view, labels=labels, pad_to=128)
    host = {"images": torch.from_numpy(rng.standard_normal((2, 112, 112, 3)).astype(np.float32)),
            "token_ids": torch.from_numpy(plan.token_ids).long(),
            "is_image": torch.from_numpy(plan.is_image),
            "image_slot": torch.from_numpy(plan.image_slot).long(),
            "positions": torch.arange(128).expand(2, 128).contiguous(),
            "labels": torch.from_numpy(plan.labels).long()}

    def step(p, ad, dev, dtype):
        leaves = adapter_leaves(ad) + [t for _, t in leaves_with_paths(p["projector"])]
        for t in leaves:
            t.requires_grad_(True)
        batch = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                 for k, v in host.items()}
        loss, _ = lora_loss(ad, p, cfg if dtype == torch.bfloat16 else
                            tiny_vlm_config(vision=vc, lm=lc, dtype=torch.float32), lcfg, batch)
        return loss.item(), [x.float().cpu() for x in torch.autograd.grad(loss, leaves)]

    cpu_loss, cpu_grads = step(params_to(params, "cpu", torch.float32),
                               params_to(lora, "cpu", torch.float32), "cpu", torch.float32)
    before = flash_attention_bwd.launches
    loss, grads = step(params, lora, cuda, torch.bfloat16)
    assert flash_attention_bwd.launches == before + 2
    assert abs(loss - cpu_loss) <= 1e-2 * abs(cpu_loss)
    n_ad = len(adapter_leaves(lora))
    proj_norm = float(sum(x.square().sum() for x in cpu_grads[n_ad:]).sqrt())
    # the key bias of the projector's attention and ln_k's bias have an exact
    # gradient of 0 (chip_smoke.py ZERO_GRAD_LEAVES): held to the projector's
    zero = {i + n_ad for i, (path, _) in enumerate(leaves_with_paths(params["projector"]))
            if path in (("attn", "k", "bias"), ("ln_k", "bias"))}
    for i, (got, want) in enumerate(zip(grads, cpu_grads)):
        diff = float((got - want).square().sum().sqrt())
        if i < n_ad:
            assert diff <= 5e-2 * float(want.norm()), (i, diff, float(want.norm()))
        elif i in zero:
            assert diff <= 1e-1 * proj_norm, (i, diff)
        else:
            assert diff <= 1e-1 * max(float(want.norm()), 1e-3 * proj_norm), (i, diff)


@pytest.mark.cuda
def test_prefetcher_copies_to_the_card_before_the_consumer_reads(cuda, monkeypatch):
    """`DevicePrefetcher(to_device=True)` on the card: nested items (dict,
    namedtuple, list, numpy arrays and tensors) arrive on the card with
    their values and structure, and the consumer's stream waits for each
    item's side-stream copy. The copy is held back behind a ~0.1 s spin on
    the side stream, so work the consumer queues right after the yield
    finishes before that copy only if the wait is missing."""
    from collections import namedtuple

    from tokenpacker_tpu_torch.data import prefetch

    pair = namedtuple("pair", "ids masks")
    copied = []
    move = prefetch._move

    def slow_move(item, device, pin):
        if not (isinstance(item, dict) and "step" in item):  # nested parts
            return move(item, device, pin)
        torch.cuda._sleep(200_000_000)  # on the prefetcher's side stream
        moved = move(item, device, pin)
        done = torch.cuda.Event()
        done.record()
        copied.append(done)
        return moved

    monkeypatch.setattr(prefetch, "_move", slow_move)

    def make(i):
        return {"step": i, "x": np.full((1024, 1024), i + 0.5, np.float32),
                "pair": pair(torch.arange(4096, dtype=torch.int32) * (i + 1),
                             [np.arange(8) + i, torch.ones(3, dtype=torch.bool)]),
                "name": f"batch{i}"}

    got = []
    for i, item in enumerate(prefetch.DevicePrefetcher(range(4), transform=make, depth=1,
                                                       to_device=True, device=cuda)):
        read = item["x"].sum()  # queued on the consumer's stream at once
        after = torch.cuda.Event()
        after.record()
        after.synchronize()
        assert copied[i].query(), f"item {i}: the consumer read before the copy ended"
        assert read.item() == (i + 0.5) * 1024 * 1024
        assert isinstance(item["pair"], pair) and isinstance(item["pair"].masks, list)
        assert item["name"] == f"batch{i}" and item["step"] == i
        tensors = (item["x"], item["pair"].ids, *item["pair"].masks)
        assert all(t.device.type == "cuda" for t in tensors)
        want = make(i)
        assert torch.equal(item["pair"].ids.cpu(), want["pair"].ids)
        assert torch.equal(item["pair"].masks[0].cpu(), torch.from_numpy(want["pair"].masks[0]))
        got.append(i)
    assert got == [0, 1, 2, 3]
