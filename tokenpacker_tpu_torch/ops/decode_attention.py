"""K3: single-query decode attention over the dense KV cache (counterpart
of `tokenpacker_tpu/ops/decode_attention.py`).

Per sample n, keys are valid in `[0, lengths[n])` plus, when
`span_start > 0`, the decoded span `[span_start, needed[n])` (the bucketed
layout of `generate.decode_step`); with `span_start == 0` keys
`[0, needed[n])` are valid. No key at or past `needed[n]` is valid
(callers keep lengths <= needed). `lengths`/`needed` are int32 device
tensors; the kernel reads them itself and reads no key outside the valid
ranges. On a CUDA tensor it launches `csrc/decode_attention.cu`; on a
CPU tensor it runs `decode_attention_plain`. ALiBi slopes (MPT) are not
ported yet.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           lengths: torch.Tensor, needed: torch.Tensor,
                           span_start: int = 0) -> torch.Tensor:
    """`decode_attention_reference` semantics: fp32 logits and softmax,
    probabilities cast to the input dtype for the value product."""
    n, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    qg = q.view(n, hkv, h // hkv, d).float()
    logits = torch.einsum("nkgd,nskd->nkgs", qg, ck.float()) * (d**-0.5)
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = kpos < needed[:, None]
    if span_start > 0:
        valid &= (kpos < lengths[:, None]) | (kpos >= span_start)
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("nkgs,nskd->nkgd", probs, cv).reshape(n, h, d)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     lengths: torch.Tensor, needed: torch.Tensor,
                     span_start: int = 0) -> torch.Tensor:
    """q [N, H, d]; ck/cv [N, S, Hkv, d]; lengths/needed [N] int32 -> [N, H, d]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, lengths, needed, span_start)
    n, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    if ck.shape != (n, s, hkv, d) or cv.shape != ck.shape or h % hkv:
        raise ValueError(f"decode_attention: shapes {q.shape} {ck.shape} {cv.shape}")
    if lengths.shape != (n,) or needed.shape != (n,):
        raise ValueError("decode_attention: lengths and needed must be [N]")
    bf, i32 = torch.bfloat16, torch.int32
    stream = _build.cuda_args(
        "decode_attention", q=(q, bf), ck=(ck, bf), cv=(cv, bf),
        lengths=(lengths, i32), needed=(needed, i32),
    )
    out = torch.empty_like(q)
    rc = _build.library().tp_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), lengths.data_ptr(), needed.data_ptr(),
        out.data_ptr(), n, s, h, hkv, d, span_start, stream,
    )
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
