"""K2 forward: prefill attention (counterpart of the forward of
`tokenpacker_tpu/ops/flash_attention.py` and its GQA wrapper `mha_flash`).

`flash_attention` returns (o, lse) like the TPU kernel: o `[N, Tq, H, D]`
and the natural-log log-sum-exp `[N*H, Tq]` in fp32, +inf for a row that
sees no key. Causal masking is aligned bottom-right (query i sees keys
<= i + Tk - Tq). k/v may have fewer heads than q (GQA): query head h reads
kv head h // (H // Hkv). On a CUDA tensor it launches `csrc/flash_fwd.cu`;
on a CPU tensor it runs `flash_attention_plain`.

The additive-bias forms (key-only ALiBi and full [Tq, Tk]) and the
backward are not ported yet.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention_reference` semantics with grouped kv heads: logits in the
    input dtype, fp32 softmax, probabilities cast to the input dtype."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.view(n, tq, hkv, g, d)
    logits = torch.einsum("nqkgd,nskd->nkgqs", qg, k).float() * (d**-0.5)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)  # -inf where no key is visible
    probs = torch.softmax(logits, dim=-1).nan_to_num_(0.0).to(q.dtype)
    o = torch.einsum("nkgqs,nskd->nqkgd", probs, v).reshape(n, tq, h, d)
    lse = torch.where(torch.isneginf(lse), torch.inf, lse)
    return o, lse.reshape(n * h, tq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """q [N, Tq, H, D], k/v [N, Tk, Hkv, D] -> (o [N, Tq, H, D], lse [N*H, Tq])."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != (n, tk, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    bf = torch.bfloat16
    stream = _build.cuda_args("flash_attention", q=(q, bf), k=(k, bf), v=(v, bf))
    o = torch.empty_like(q)
    lse = torch.empty((n * h, tq), dtype=torch.float32, device=q.device)
    rc = _build.library().tp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        n, tq, tk, h, hkv, d, int(causal), stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
