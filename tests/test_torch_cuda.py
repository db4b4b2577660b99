"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no card. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` skips `tests/conftest.py`, which sets JAX up.) The first
case of each test is a shape the TokenPacker-7b serving path gives the
kernel; the others cover ragged lengths and groupings at the path's head
sizes (d=64 for the tower, d=128 for the LM), the only ones the kernels
take.
"""

import pytest
import torch

from tokenpacker_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
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
    with pytest.raises(RuntimeError, match="not supported"):
        decode_attention(q64[:, 0], q64, q64, torch.ones(1, dtype=torch.int32, device=cuda),
                         torch.ones(1, dtype=torch.int32, device=cuda))
