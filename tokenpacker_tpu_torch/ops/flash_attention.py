"""K2: prefill and training attention (counterpart of
`tokenpacker_tpu/ops/flash_attention.py` and its GQA wrapper `mha_flash`).

`flash_attention` returns (o, lse) like the TPU kernel's forward: o
`[N, Tq, H, D]` and the natural-log log-sum-exp `[N*H, Tq]` in fp32, +inf
for a row that sees no key. Causal masking is aligned bottom-right (query
i sees keys <= i + Tk - Tq). k/v may have fewer heads than q (GQA): query
head h reads kv head h // (H // Hkv). On a CUDA tensor it launches
`csrc/flash_fwd.cu`; on a CPU tensor it runs `flash_attention_plain`.

`flash_attention_bwd` is the backward from that lse (`_flash_bwd_pallas`):
`csrc/flash_bwd.cu` on a CUDA tensor, `flash_attention_bwd_plain` on a
CPU tensor. `FlashAttention` is the autograd function that pairs the
two; nothing differentiates through the plain forward.

Both directions take the TPU kernel's key-only additive bias (`bias`
[1, H|1, 1, Tk] fp32, the shape of MPT's ALiBi, `models/mpt.py`): the
logits are q k^T * scale + bias[head, key] before the causal mask, and
the backward rebuilds P with the same bias. The bias is a constant: it
gets no gradient (the TPU package's `custom_vjp` returns zeros for it).
[Tq, Tk] is never built on the card. The full [N|1, H|1, Tq, Tk] bias
form, which no path of the JAX package reaches, is not ported (ROADMAP
queue 2).
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build


def _visible(tq: int, tk: int, device) -> torch.Tensor:
    """[Tq, Tk] bool: key j is visible to query i iff j <= i + Tk - Tq."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    return torch.arange(tk, device=device)[None, :] <= qpos


def key_bias_rows(bias: torch.Tensor, h: int, tk: int) -> torch.Tensor:
    """A key-only bias [1, H|1, 1, Tk] as the kernels take it: [H, Tk]
    fp32, one row per query head, contiguous. Any other shape raises."""
    if bias.dim() != 4 or bias.shape[0] != 1 or bias.shape[2] != 1 or bias.shape[3] != tk \
            or bias.shape[1] not in (1, h):
        raise ValueError(f"flash_attention: bias {tuple(bias.shape)} is not key-only "
                         f"[1, {h}|1, 1, {tk}]")
    return bias.float().reshape(-1, tk).expand(h, tk).contiguous()


def _grouped_bias(bias, n_kv: int, tk: int) -> torch.Tensor:
    """[H, Tk] -> [1, Hkv, G, 1, Tk], to add to [N, Hkv, G, Tq, Tk] logits."""
    return bias.reshape(1, n_kv, -1, 1, tk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention_reference` semantics with grouped kv heads: logits in the
    input dtype, then fp32 times the scale plus the key-only bias, fp32
    softmax, probabilities cast to the input dtype."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.view(n, tq, hkv, g, d)
    logits = torch.einsum("nqkgd,nskd->nkgqs", qg, k).float() * (d**-0.5)
    if bias is not None:
        logits = logits + _grouped_bias(key_bias_rows(bias, h, tk), hkv, tk)
    if causal:
        logits = logits.masked_fill(~_visible(tq, tk, q.device), float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)  # -inf where no key is visible
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0).to(q.dtype)
    o = torch.einsum("nkgqs,nskd->nqkgd", probs, v).reshape(n, tq, h, d)
    lse = torch.where(torch.isneginf(lse), torch.inf, lse)
    return o, lse.reshape(n * h, tq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """q [N, Tq, H, D], k/v [N, Tk, Hkv, D], bias None or key-only [1, H|1,
    1, Tk] -> (o [N, Tq, H, D], lse [N*H, Tq]). Launches of the bias form
    count on `flash_attention.bias_launches`, the others on `.launches`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, bias)
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != (n, tk, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    bf, f32 = torch.bfloat16, torch.float32
    rows = None if bias is None else key_bias_rows(bias, h, tk)
    extra = {} if rows is None else {"bias": (rows, f32)}
    stream = _build.cuda_args("flash_attention", q=(q, bf), k=(k, bf), v=(v, bf), **extra)
    o = torch.empty_like(q)
    lse = torch.empty((n * h, tq), dtype=f32, device=q.device)
    rc = _build.library().tp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if rows is None else rows.data_ptr(), n, tq, tk, h, hkv, d, int(causal), stream,
    )
    _build.check(rc, "flash_attention")
    if rows is None:
        flash_attention.launches += 1
    else:
        flash_attention.bias_launches += 1
    return o, lse


flash_attention.launches = 0
flash_attention.bias_launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True, bias=None):
    """The math of `_flash_bwd_reference` in fp32: P rebuilt from the saved
    lse and the key-only bias (0 on masked keys and on rows with lse =
    +inf), dS = P (dP - rowsum(dO o)), dq = dS k scale, dk = dS^T q scale,
    dv = P^T dO, dk/dv summed over each GQA group. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5
    qg, dog = (x.float().reshape(n, tq, hkv, g, d) for x in (q, do))
    kf, vf = k.float(), v.float()
    s = torch.einsum("nqkgd,nskd->nkgqs", qg, kf) * scale
    if bias is not None:
        s = s + _grouped_bias(key_bias_rows(bias, h, tk), hkv, tk)
    p = torch.exp(s - lse.reshape(n, hkv, g, tq, 1))
    if causal:
        p = p.masked_fill(~_visible(tq, tk, q.device), 0.0)
    dp = torch.einsum("nqkgd,nskd->nkgqs", dog, vf)
    delta = (do.float() * o.float()).sum(-1).reshape(n, tq, hkv, g).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("nkgqs,nskd->nqkgd", ds, kf).reshape(n, tq, h, d) * scale
    dk = torch.einsum("nkgqs,nqkgd->nskd", ds, qg) * scale
    dv = torch.einsum("nkgqs,nqkgd->nskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        bias: torch.Tensor | None = None):
    """(dq [N, Tq, H, D], dk, dv [N, Tk, Hkv, D]) from the forward's inputs
    (bias: the forward's key-only bias or None), its output o, its lse
    [N*H, Tq] and the output gradient do. Launches of the bias form count
    on `flash_attention_bwd.bias_launches`, the others on `.launches`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, bias)
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if (k.shape != (n, tk, hkv, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (n * h, tq) or h % hkv):
        raise ValueError(f"flash_attention_bwd: shapes q {q.shape} k {k.shape} v {v.shape} "
                         f"o {o.shape} lse {lse.shape} do {do.shape}")
    bf, f32 = torch.bfloat16, torch.float32
    rows = None if bias is None else key_bias_rows(bias, h, tk)
    extra = {} if rows is None else {"bias": (rows, f32)}
    stream = _build.cuda_args("flash_attention_bwd", q=(q, bf), k=(k, bf), v=(v, bf), o=(o, bf),
                              lse=(lse, f32), do=(do, bf), **extra)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((n * h, tq), dtype=f32, device=q.device)
    rc = _build.library().tp_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        None if rows is None else rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), n, tq, tk, h, hkv, d, int(causal), stream,
    )
    _build.check(rc, "flash_attention_bwd")
    if rows is None:
        flash_attention_bwd.launches += 1
    else:
        flash_attention_bwd.bias_launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.bias_launches = 0


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with K2's forward, and K2's backward from the
    saved lse (the TPU package's `custom_vjp`). `FlashAttention.apply(q,
    k, v, causal, bias=None)` -> o [N, Tq, H, D]; the key-only bias is a
    constant (its gradient is None)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, bias=None):
        o, lse = flash_attention(q, k, v, causal, bias)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, bias)
        return dq, dk, dv, None, None
