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
[Tq, Tk] is never built on the card.

The forward also takes a full additive bias [N|1, H|1, Tq, Tk] (any
other shape with Tq > 1 or N > 1 in its first and third axes, as the TPU
package tells the two apart), which no model of either package reaches
(a prefix-LM MPT's `make_prefix_lm_bias` runs on `sdpa`). Its kernel
reads the bias in place, never expanded over a broadcast axis, and
follows the TPU kernel's rule for a row whose biased logits all lie
below -1e30 (its NEG_INF, where the online max starts): o = 0 and lse =
+inf. Its backward is `flash_attention_bwd_reference`, the TPU package's
XLA recompute `_flash_bwd_reference` in plain PyTorch on every device
(the TPU package has no Pallas kernel for it), which also returns the
bias's gradient, summed over its broadcast axes.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build

# the TPU kernel's NEG_INF: its online max starts there, so a row whose
# biased logits all lie below it keeps l = 0 (o = 0, lse = +inf)
NEG_INF = -1e30


def is_key_bias(bias: torch.Tensor) -> bool:
    """The TPU package's test (`_is_key_bias`): [1, *, 1, Tk] is a key-only
    bias (one value per head and key); any other bias is a full one."""
    return bias.shape[0] == 1 and bias.shape[-2] == 1


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


def full_bias(bias: torch.Tensor, n: int, h: int, tq: int, tk: int) -> torch.Tensor:
    """A full bias [N|1, H|1, Tq, Tk] as fp32, contiguous, still unexpanded
    over its broadcast axes; any other shape raises."""
    if bias.dim() != 4 or bias.shape[0] not in (1, n) or bias.shape[1] not in (1, h) \
            or bias.shape[2:] != (tq, tk):
        raise ValueError(f"flash_attention: bias {tuple(bias.shape)} is neither key-only "
                         f"[1, {h}|1, 1, {tk}] nor full [{n}|1, {h}|1, {tq}, {tk}]")
    return bias.float().contiguous()


def _grouped_full_bias(bias: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[N|1, H|1, Tq, Tk] -> [N|1, Hkv|1, G|1, Tq, Tk] for grouped logits."""
    nb, hb, tq, tk = bias.shape
    return bias.reshape(nb, n_kv, -1, tq, tk) if hb > 1 else bias.reshape(nb, 1, 1, tq, tk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention_reference` semantics with grouped kv heads: logits in the
    input dtype, then fp32 times the scale plus the bias (key-only or
    full), fp32 softmax, probabilities cast to the input dtype. With a full
    bias a row whose logits all lie below NEG_INF gets o = 0, lse = +inf."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.view(n, tq, hkv, g, d)
    logits = torch.einsum("nqkgd,nskd->nkgqs", qg, k).float() * (d**-0.5)
    full = bias is not None and not is_key_bias(bias)
    if full:
        logits = logits + _grouped_full_bias(full_bias(bias, n, h, tq, tk), hkv)
    elif bias is not None:
        logits = logits + _grouped_bias(key_bias_rows(bias, h, tk), hkv, tk)
    if causal:
        logits = logits.masked_fill(~_visible(tq, tk, q.device), float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)  # -inf where no key is visible
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    if full:
        dead = logits.amax(-1) < NEG_INF
        probs = probs.masked_fill(dead[..., None], 0.0)
        lse = lse.masked_fill(dead, float("-inf"))
    o = torch.einsum("nkgqs,nskd->nqkgd", probs.to(q.dtype), v).reshape(n, tq, h, d)
    lse = torch.where(torch.isneginf(lse), torch.inf, lse)
    return o, lse.reshape(n * h, tq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """q [N, Tq, H, D], k/v [N, Tk, Hkv, D], bias None, key-only [1, H|1,
    1, Tk] or full [N|1, H|1, Tq, Tk] -> (o [N, Tq, H, D], lse [N*H, Tq]).
    Launches of the key-only form count on `flash_attention.bias_launches`,
    of the full form on `.full_bias_launches`, the others on `.launches`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, bias)
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != (n, tk, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if bias is not None and not is_key_bias(bias):
        return _flash_full_bias(q, k, v, causal, full_bias(bias, n, h, tq, tk))
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


def _flash_full_bias(q, k, v, causal: bool, bias: torch.Tensor):
    """K2's full-bias form on the card: bias [N|1, H|1, Tq, Tk] fp32,
    contiguous; a broadcast axis gets a stride of 0."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    bf = torch.bfloat16
    stream = _build.cuda_args("flash_attention", q=(q, bf), k=(k, bf), v=(v, bf),
                              bias=(bias, torch.float32))
    s_n = bias.stride(0) if bias.shape[0] > 1 else 0
    s_h = bias.stride(1) if bias.shape[1] > 1 else 0
    o = torch.empty_like(q)
    lse = torch.empty((n * h, tq), dtype=torch.float32, device=q.device)
    rc = _build.library().tp_flash_fwd_full_bias(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bias.data_ptr(),
        s_n, s_h, n, tq, tk, h, hkv, d, int(causal), stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.full_bias_launches += 1
    return o, lse


flash_attention.launches = 0
flash_attention.bias_launches = 0
flash_attention.full_bias_launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True, bias=None):
    """The math of `_flash_bwd_reference` in fp32: P rebuilt from the saved
    lse and the key-only bias (0 on masked keys and on rows with lse =
    +inf), dS = P (dP - rowsum(dO o)), dq = dS k scale, dk = dS^T q scale,
    dv = P^T dO, dk/dv summed over each GQA group. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    h, tk, hkv = q.shape[2], k.shape[1], k.shape[2]
    add = None if bias is None else _grouped_bias(key_bias_rows(bias, h, tk), hkv, tk)
    return _backward(q, k, v, o, lse, do, causal, add)[:3]


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool, bias: torch.Tensor):
    """The backward of the full-bias form: `_flash_bwd_reference` of the
    TPU package in plain PyTorch (fp32, on any device; [N, H, Tq, Tk] is
    built). Returns (dq, dk, dv, dbias): dbias is dS summed over the
    bias's broadcast axes, in the bias's dtype."""
    n, tq, h, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    add = _grouped_full_bias(full_bias(bias, n, h, tq, tk), hkv)
    dq, dk, dv, ds = _backward(q, k, v, o, lse, do, causal, add)
    ds = ds.reshape(n, h, tq, tk)
    if bias.shape[0] == 1:
        ds = ds.sum(0, keepdim=True)
    if bias.shape[1] == 1:
        ds = ds.sum(1, keepdim=True)
    return dq, dk, dv, ds.to(bias.dtype)


def _backward(q, k, v, o, lse, do, causal: bool, add):
    """(dq, dk, dv, dS [N, Hkv, G, Tq, Tk] fp32) with `add` (None, or
    broadcastable to [N, Hkv, G, Tq, Tk]) added to the scaled logits."""
    n, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5
    qg, dog = (x.float().reshape(n, tq, hkv, g, d) for x in (q, do))
    kf, vf = k.float(), v.float()
    s = torch.einsum("nqkgd,nskd->nkgqs", qg, kf) * scale
    if add is not None:
        s = s + add
    p = torch.exp(s - lse.reshape(n, hkv, g, tq, 1))
    if causal:
        p = p.masked_fill(~_visible(tq, tk, q.device), 0.0)
    dp = torch.einsum("nqkgd,nskd->nkgqs", dog, vf)
    delta = (do.float() * o.float()).sum(-1).reshape(n, tq, hkv, g).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("nkgqs,nskd->nqkgd", ds, kf).reshape(n, tq, h, d) * scale
    dk = torch.einsum("nkgqs,nqkgd->nskd", ds, qg) * scale
    dv = torch.einsum("nkgqs,nqkgd->nskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


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
    constant (its gradient is None); a full bias takes the plain
    `flash_attention_bwd_reference`, which gives its gradient too."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, bias=None):
        o, lse = flash_attention(q, k, v, causal, bias)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        if bias is not None and not is_key_bias(bias):
            dq, dk, dv, dbias = flash_attention_bwd_reference(q, k, v, o, lse, do, ctx.causal,
                                                              bias)
            return dq, dk, dv, None, dbias if ctx.needs_input_grad[4] else None
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, bias)
        return dq, dk, dv, None, None
