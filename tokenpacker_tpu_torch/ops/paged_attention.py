"""K5: single-query decode attention through a page table (counterpart of
`tokenpacker_tpu/ops/paged_attention.py`).

q [N, H, d]; one layer's pool k/v_pages [P, ps, Hkv, d]; page_table
[N, MP] int32 (the physical page of each logical block); lengths [N]
int32, the valid keys including the token written this step. Sequence n's
key at position i lives in page `page_table[n, i // ps]`, row `i % ps`;
only positions below `lengths[n]` are attended, and no page at or past
ceil(lengths[n] / ps) is read (those table entries may be stale or 0).
An int8 pool comes with k/v_scales [P, ps, Hkv] f32 (`ops/kv_quant`): the
scales fold into the logits and the probabilities, K and V are never
dequantized. A row with no valid key gives 0.

On a CUDA tensor `paged_attention` launches `csrc/paged_attention.cu`
(bf16 q, a bf16 or int8 pool, d=128, ps 16/32/64, groups 1/2/4/8), which
splits each (sequence, kv head)'s valid pages across the `paged_splits`
blocks of one cluster and merges their partials in split order; on a CPU
tensor it runs `paged_attention_plain`.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.splits import MAX_SPLITS, sm_count

# the table positions a split keeps at least: on an H100 (phase 3's pools,
# lengths 65-2080 in 40 pages of 64) 32 kv heads ran fastest at 2-4 splits
# and 8 kv heads at 4, 7-12% ahead of 8 splits of 320 positions
MIN_SPLIT_POSITIONS = 512


def paged_splits(n: int, hkv: int, mp: int, ps: int, sms: int = 132) -> int:
    """The blocks that share one (sequence, kv head)'s pages in the kernel,
    chosen as `decode_splits` chooses K3's over the table's mp * ps
    positions: a power of two up to MAX_SPLITS, doubled while the grid
    holds fewer than two blocks an SM, as long as each split keeps a whole
    page and MIN_SPLIT_POSITIONS positions. The kernel hands each split
    whole pages of the true length, balanced."""
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits <= mp
           and mp * ps >= 2 * MIN_SPLIT_POSITIONS * splits and n * hkv * splits < 2 * sms):
        splits *= 2
    return splits


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          k_scales: torch.Tensor | None = None,
                          v_scales: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic on pages gathered through the table: fp32
    logits from (q * d^-0.5) and K, times the K scales of an int8 pool; an
    fp32 softmax; probabilities times the V scales (int8 pool) or cast to
    the pool's dtype (float pool) before the product with V. Positions at
    or past `lengths` are masked and their V rows zeroed."""
    n, h, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    s = page_table.shape[1] * ps
    table = page_table.long()
    kg = k_pages[table].reshape(n, s, hkv, d).float()
    vg = v_pages[table].reshape(n, s, hkv, d)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]  # [N, S]
    qg = (q.float() * d**-0.5).view(n, hkv, h // hkv, d)
    logits = torch.einsum("nkgd,nskd->nkgs", qg, kg)
    if k_scales is not None:
        logits = logits * k_scales[table].reshape(n, s, hkv).transpose(1, 2)[:, :, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True).clamp(min=torch.finfo(torch.float32).min)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scales is not None:
        p = p * v_scales[table].reshape(n, s, hkv).transpose(1, 2)[:, :, None]
    else:
        p = p.to(v_pages.dtype).float()
    vf = torch.where(valid[:, :, None, None], vg.float(), 0.0)
    o = torch.einsum("nkgs,nskd->nkgd", p, vf)
    o = torch.where(l > 0, o / l.clamp(min=torch.finfo(torch.float32).tiny), 0.0)
    return o.reshape(n, h, d).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    k_scales: torch.Tensor | None = None,
                    v_scales: torch.Tensor | None = None) -> torch.Tensor:
    """q [N, H, d]; k/v_pages [P, ps, Hkv, d]; page_table [N, MP] int32;
    lengths [N] int32; k/v_scales [P, ps, Hkv] f32 with an int8 pool.
    Returns [N, H, d] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    n, h, d = q.shape
    p_total, ps, hkv, dk = k_pages.shape
    mp = page_table.shape[1] if page_table.dim() == 2 else -1
    int8 = k_pages.dtype == torch.int8
    if (dk != d or v_pages.shape != k_pages.shape or h % hkv or page_table.shape != (n, mp)
            or lengths.shape != (n,)):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if int8 != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention: an int8 pool needs k_scales and v_scales, a float "
                         "pool takes none")
    pool = torch.int8 if int8 else torch.bfloat16
    tensors = dict(q=(q, torch.bfloat16), k_pages=(k_pages, pool), v_pages=(v_pages, pool),
                   page_table=(page_table, torch.int32), lengths=(lengths, torch.int32))
    if int8:
        if k_scales.shape != (p_total, ps, hkv) or v_scales.shape != k_scales.shape:
            raise ValueError(f"paged_attention: scales {tuple(k_scales.shape)} "
                             f"{tuple(v_scales.shape)}, expected {(p_total, ps, hkv)}")
        tensors.update(k_scales=(k_scales, torch.float32), v_scales=(v_scales, torch.float32))
    stream = _build.cuda_args("paged_attention", **tensors)
    out = torch.empty_like(q)
    splits = paged_splits(n, hkv, mp, ps, sm_count(q.device.index))
    rc = _build.library().tp_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if int8 else None, v_scales.data_ptr() if int8 else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), n, h, hkv, d, ps, mp,
        int(int8), splits, stream,
    )
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
