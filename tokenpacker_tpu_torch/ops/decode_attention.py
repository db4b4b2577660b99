"""K3: single-query decode attention over the dense KV cache (counterpart
of `tokenpacker_tpu/ops/decode_attention.py`).

Per sample n, keys are valid in `[0, lengths[n])` plus, when
`span_start > 0`, the decoded span `[span_start, needed[n])` (the bucketed
layout of `generate.decode_step`); with `span_start == 0` keys
`[0, needed[n])` are valid. No key at or past `needed[n]` is valid
(callers keep lengths <= needed). `lengths`/`needed` are int32 device
tensors; the kernel reads them itself and reads no key outside the valid
ranges. On a CUDA tensor it launches `csrc/decode_attention.cu`, which
splits each (sample, kv head)'s valid keys across the `decode_splits`
blocks of one cluster and merges their partials in split order; on a CPU
tensor it runs `decode_attention_plain`.

With `slopes` [H] fp32 (MPT's ALiBi, MHA only) each logit gains
slope[head] * tok_pos, the key's true token position: its slot index in
the prompt range, and kpos - span_start + lengths[n] in the decoded span
(the bucket's gap compacted away, as `models/mpt.alibi_bias_from_positions`
over `generate.decode_step`'s key positions).
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.splits import MAX_SPLITS, sm_count

MIN_SPLIT_KEYS, MAX_SPLIT_KEYS = 64, 256  # cache slots a split


def decode_splits(n: int, hkv: int, s: int, sms: int = 132) -> int:
    """The blocks that share one (sample, kv head)'s keys in the kernel: a
    power of two up to MAX_SPLITS, doubled while the grid holds fewer than
    two blocks an SM or a split would hold more than MAX_SPLIT_KEYS of the
    S cache slots, as long as each split keeps MIN_SPLIT_KEYS of them."""
    splits = 1
    while (splits < MAX_SPLITS and s >= 2 * MIN_SPLIT_KEYS * splits
           and (n * hkv * splits < 2 * sms or s > MAX_SPLIT_KEYS * splits)):
        splits *= 2
    return splits


def _token_positions(lengths: torch.Tensor, s: int, span_start: int) -> torch.Tensor:
    """[N, S] true token position of each cache slot under K3's layout: the
    slot index, and in the decoded span [span_start, ...) of the bucketed
    layout kpos - span_start + lengths[n]."""
    kpos = torch.arange(s, device=lengths.device)[None, :]
    if span_start <= 0:
        return kpos.expand(lengths.shape[0], s)
    return torch.where(kpos >= span_start, kpos - span_start + lengths[:, None].long(), kpos)


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           lengths: torch.Tensor, needed: torch.Tensor,
                           span_start: int = 0, slopes: torch.Tensor | None = None) -> torch.Tensor:
    """`decode_attention_reference` semantics: fp32 logits (plus slopes x
    token positions) and softmax, probabilities cast to the input dtype for
    the value product."""
    n, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    qg = q.view(n, hkv, h // hkv, d).float()
    logits = torch.einsum("nkgd,nskd->nkgs", qg, ck.float()) * (d**-0.5)
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = kpos < needed[:, None]
    if span_start > 0:
        valid &= (kpos < lengths[:, None]) | (kpos >= span_start)
    if slopes is not None:
        pos = _token_positions(lengths, s, span_start).float()
        logits = logits + slopes.float().view(1, hkv, h // hkv, 1) * pos[:, None, None, :]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("nkgs,nskd->nkgd", probs, cv).reshape(n, h, d)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     lengths: torch.Tensor, needed: torch.Tensor,
                     span_start: int = 0, slopes: torch.Tensor | None = None) -> torch.Tensor:
    """q [N, H, d]; ck/cv [N, S, Hkv, d]; lengths/needed [N] int32; slopes
    None or [H] f32 (H == Hkv) -> [N, H, d]. Launches with slopes count on
    `decode_attention.alibi_launches`, the others on `.launches`."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, lengths, needed, span_start, slopes)
    n, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    if ck.shape != (n, s, hkv, d) or cv.shape != ck.shape or h % hkv:
        raise ValueError(f"decode_attention: shapes {q.shape} {ck.shape} {cv.shape}")
    if lengths.shape != (n,) or needed.shape != (n,):
        raise ValueError("decode_attention: lengths and needed must be [N]")
    if slopes is not None and (slopes.shape != (h,) or hkv != h):
        raise ValueError(f"decode_attention: slopes {tuple(slopes.shape)} need [H] and H == Hkv")
    bf, i32 = torch.bfloat16, torch.int32
    extra = {} if slopes is None else {"slopes": (slopes, torch.float32)}
    stream = _build.cuda_args(
        "decode_attention", q=(q, bf), ck=(ck, bf), cv=(cv, bf),
        lengths=(lengths, i32), needed=(needed, i32), **extra,
    )
    out = torch.empty_like(q)
    splits = decode_splits(n, hkv, s, sm_count(q.device.index))
    rc = _build.library().tp_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), lengths.data_ptr(), needed.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(), n, s, h, hkv, d,
        span_start, splits, stream,
    )
    _build.check(rc, "decode_attention")
    if slopes is None:
        decode_attention.launches += 1
    else:
        decode_attention.alibi_launches += 1
    return out


decode_attention.launches = 0
decode_attention.alibi_launches = 0
