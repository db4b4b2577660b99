"""K4: the whole int8 weight-only LLaMA decode step (counterpart of
`tokenpacker_tpu/ops/fused_decode.py`, T = 1 and the T = k+1 verify form).

For B samples and one token each, every layer runs RMSNorm -> fused qkv
GEMV (int8 weights, f32 per-column scales) -> RoPE -> with an int8 cache,
quantize-dequantize of the new k/v -> attention over the cache ranges
[0, len0) U [start2, end2) plus the current token -> o GEMV, residual ->
RMSNorm -> gate/up GEMV -> SiLU * up -> down GEMV, residual. The final
norm and the LM head stay outside, as in the JAX package.

On CUDA tensors `fused_decode_hidden` makes one call into
`csrc/fused_decode.cu`, which loops over the layers and enqueues five
kernels a layer (qkv, o, gate/up and down GEMVs, each with its epilogue
and its K split over a thread-block cluster, and the attention, its keys
split over a cluster: `step_plan`), each launched with programmatic
dependent launch; on CPU tensors it runs `fused_decode_hidden_plain`,
the same function in plain PyTorch. Either way the new k/v rows are
written into the cache **in place** at `write_pos` (the JAX function
returns updated copies): int8 rows with their scales from
`kv_quant.quantize_kv` of the quantize-dequantized rows, or the rows
themselves in a float cache.

The kernel takes per-layer weight pointers from a table
(`FusedWeights`) that the caller builds once per parameter tree, rather
than requiring the four matrices stacked [L, K, N]: the per-layer tree of
`io/weights` stays the one layout that llama.py, the weight bridge and the
tests share, and no stacked second copy of 6.5 GB is made.

`fused_verify_hidden` is the T = k+1 verify form of speculation (K4-verify):
the same call with T fed tokens a sample, causal among themselves.

K4-LoRA (multi-LoRA serving, `serve/multi_lora`): with `slot_lora`, the
bundle of `build_fd_lora` and its selection rows, both forms add every
slot's adapter term beside each of the four products, as the TPU
kernel's `lora` form does: u = x @ A (bf16 operands, f32 sums), um =
bf16(u * mask), term = um @ B (f32 sums), added in f32 to the scaled
base product (qkv before RoPE and the qdq of the new rows, o and down
before the bf16 cast and the residual, gate and up before SiLU). An
all-zero selection row adds an exact zero.

Not ported: the u16-row-packed `qp` storage. The TPU-only switches
(FD_PACK, FD_W8A8, FD_DEBUG, FD_CACHE, FD_RING, FD_ATTN, FD_LORA) have
no counterpart: the LoRA form runs whenever a bundle is given.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models.llama import rope_cos_sin
from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from tokenpacker_tpu_torch.ops.quantize import is_qleaf
from tokenpacker_tpu_torch.ops.splits import MAX_SPLITS, cluster_splits

HEAD_DIM = 128
BLOCK_COLS = 128  # columns a GEMV block (gate/up: 64 gate and the same 64 up)


def gemv_tiles(d: int, f: int) -> dict:
    """K4's column tiles a product: qkv and o, down 128 columns a tile;
    gate/up 64 gate columns and the same 64 up columns."""
    return {"qkv": 3 * d // BLOCK_COLS, "o": d // BLOCK_COLS, "gateup": -(-f // 64),
            "down": d // BLOCK_COLS}


def att_splits(b: int, heads: int, s: int, t: int = 1, sms: int = 132) -> int:
    """The blocks that share one (head, sample)'s cache keys in K4's
    attention (`fused_decode.cu:att_splits`): a power of two up to
    MAX_SPLITS, doubled while each split keeps 256 of the S cache slots
    and the grid, at T = 1, stays within one wave of two blocks an SM or,
    at T > 1 fed tokens, holds fewer than one block an SM."""
    splits = 1
    while (splits < MAX_SPLITS and s >= 2 * 256 * splits
           and (b * heads * 2 * splits <= 2 * sms if t == 1 else b * heads * splits < sms)):
        splits *= 2
    return splits


PLAN_KEYS = ("qkv", "o", "gateup", "down", "attention")


def step_plan(b: int, t: int, d: int, f: int, heads: int, s: int, sms: int = 132) -> dict:
    """The splits of each of K4's five launches a layer for B samples of T
    fed tokens, hidden d, MLP f, over a cache of S slots, on a card of
    `sms` SMs: the GEMVs' `splits.cluster_splits` over their tiles and the
    attention's `att_splits`. The kernel computes them in its host code;
    `kernel_plan` reads that back."""
    tiles = gemv_tiles(d, f)
    plan = {name: cluster_splits(f if name == "down" else d, tiles[name], sms)
            for name in PLAN_KEYS[:4]}
    plan["attention"] = att_splits(b, heads, s, t, sms)
    return plan


def kernel_plan(b: int, t: int, d: int, f: int, heads: int, s: int, sms: int) -> dict:
    """What `tp_fused_decode` launches for the same step (card only: it
    loads the built library)."""
    out = (ctypes.c_int * 5)()
    _build.library().tp_fused_decode_plan(b, t, d, f, heads, s, sms, ctypes.addressof(out))
    return dict(zip(PLAN_KEYS, out))


def pdl_probe(device) -> int:
    """0 where the CUDA runtime takes the launch attributes K4 uses (a cluster
    and programmatic stream serialization) on `device`, else its
    cudaError_t code; no fallback: a refused attribute fails K4's call."""
    with torch.cuda.device(device):
        rc = _build.library().tp_fused_decode_pdl_probe(torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    return rc
# per layer: ln1, qkv q/scale, o q/scale, ln2, gateup q/scale, down q/scale
_MATRICES = (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"), ("mlp", "down"))


def fused_eligible(lm_params, cfg: LMConfig) -> bool:
    """The kernel serves llama-family MHA with head_dim 128 whose every
    layer has the fused `qkv` / `gateup` layout with int8 {q, scale}
    kernels (`io/weights.quantize_lm_int8`). The TPU's geometry gates
    (mosaic lane widths) do not apply; the kernel's 16-byte column groups
    need hidden and intermediate sizes that are multiples of 16."""
    if cfg.model_family != "llama":
        return False
    if cfg.num_attention_heads != cfg.kv_heads or cfg.head_dim != HEAD_DIM:
        return False
    if cfg.hidden_size % 16 or cfg.intermediate_size % 16:
        return False
    layers = lm_params.get("layers") or []
    if not layers:
        return False
    for layer in layers:
        if "qkv" not in layer.get("attn", {}) or "gateup" not in layer.get("mlp", {}):
            return False
        for group, name in _MATRICES:
            k = layer[group][name].get("kernel")
            if not is_qleaf(k) or k["q"].dtype != torch.int8:
                return False
    return True


class FusedWeights:
    """K4's pointer table for one parameter tree on the card: per layer the
    device addresses of ln1, qkv q/scale, o q/scale, ln2, gateup q/scale
    and down q/scale, in the order `tp_fused_decode` reads them. It holds
    the tensors, so the addresses stay valid while the table lives."""

    def __init__(self, lm_params, cfg: LMConfig):
        if not fused_eligible(lm_params, cfg):
            raise ValueError("fused_decode: the tree is not an int8 fused-layout llama tree")
        d, f = cfg.hidden_size, cfg.intermediate_size
        widths = {"qkv": (d, 3 * d), "o": (d, d), "gateup": (d, 2 * f), "down": (f, d)}
        self.layers = len(lm_params["layers"])
        pairs = []  # (tensor, dtype) in the kernel's order
        for layer in lm_params["layers"]:
            pairs.append((layer["input_ln"]["scale"], torch.bfloat16))
            for group, name in _MATRICES:
                if name == "gateup":
                    pairs.append((layer["post_ln"]["scale"], torch.bfloat16))
                k = layer[group][name]["kernel"]
                if k["q"].shape != widths[name] or k["scale"].shape != (1, widths[name][1]):
                    raise ValueError(f"fused_decode: {name} is {tuple(k['q'].shape)}, "
                                     f"scale {tuple(k['scale'].shape)}")
                pairs += [(k["q"], torch.int8), (k["scale"], torch.float32)]
        _build.cuda_args("fused_decode", **{f"weight{i}": p for i, p in enumerate(pairs)})
        self.tensors = [t for t, _ in pairs]
        self.table = (ctypes.c_void_p * len(self.tensors))(*(t.data_ptr() for t in self.tensors))


def build_fd_lora(stacks, cfg: LMConfig, dtype=torch.bfloat16) -> dict:
    """K4-LoRA's bundle from the per-layer `serve/multi_lora.SlotLora`
    stacks of a fused-layout tree: stacks[i] = {("attn", "qkv"): (a [n,
    d, rcat], b [n, rcat, 3d]), ("attn", "o"), ("mlp", "gateup"),
    ("mlp", "down")}.

    As in the TPU kernel's layout, each target's n adapters flatten into
    one A [in, W] (adapter j's rcat columns at j * rcat) and one B [W,
    out] (its rows at the same offsets), W = n * rcat; the three d-input
    A's concatenate along columns (qkv | o | gateup) into `a_d` [L, d, Wq
    + Wo + Wg], down's stays alone as `a_f` [L, f, Wd]; `expand` [n, Wq +
    Wo + Wg + Wd] f32 maps a [rows, n] one-hot selection to the column
    mask in the same order. Unlike the TPU layout nothing is padded: the
    CUDA kernel reads A and B element by element, masked at each target's
    W, so neither the 128-lane padding of W nor the restacking of wide B
    blocks applies. Returns {"a_d", "a_f", "b_qkv", "b_o", "b_gu",
    "b_down", "expand", "widths": (Wq, Wo, Wg, Wd)}; the caller adds the
    selection rows as "sel" [B, n]."""
    out, widths = {}, []
    n = None
    for key, name in ((("attn", "qkv"), "qkv"), (("attn", "o"), "o"),
                      (("mlp", "gateup"), "gu"), (("mlp", "down"), "down")):
        a = torch.stack([s[key][0] for s in stacks])  # [L, n, in, rcat]
        b = torch.stack([s[key][1] for s in stacks])  # [L, n, rcat, out]
        layers, n, din, rcat = a.shape
        out["a_" + name] = a.permute(0, 2, 1, 3).reshape(layers, din, n * rcat).to(dtype)
        out["b_" + name] = b.reshape(layers, n * rcat, b.shape[-1]).to(dtype).contiguous()
        widths.append((n * rcat, rcat))
    expand = torch.zeros((n, sum(w for w, _ in widths)), dtype=torch.float32)
    off = 0
    for w, rcat in widths:
        for j in range(n):
            expand[j, off + j * rcat:off + (j + 1) * rcat] = 1.0
        off += w
    return {
        "a_d": torch.cat([out.pop("a_qkv"), out.pop("a_o"), out.pop("a_gu")], dim=2).contiguous(),
        "a_f": out.pop("a_down").contiguous(),
        **out,
        "expand": expand.to(stacks[0][("attn", "qkv")][0].device),
        "widths": tuple(w for w, _ in widths),
    }


def _lora_args(slot_lora, rows_rep: int) -> torch.Tensor:
    """The column mask selm [B * rows_rep, Wm] f32 of a bundle with its
    selection rows "sel" [B, n]: sel @ expand, each sample's row repeated
    rows_rep times (sample-major, the verify form's row order)."""
    selm = slot_lora["sel"].float() @ slot_lora["expand"]
    if rows_rep > 1:
        selm = selm.repeat_interleave(rows_rep, dim=0)
    return selm.contiguous()


def _lora_term(x: torch.Tensor, a: torch.Tensor, mask: torch.Tensor, b: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """K4-LoRA's term: u = x @ a in f32, um = (u * mask) rounded to dt,
    um @ b in f32."""
    u = x.float() @ a.float()
    return (u * mask).to(dt).float() @ b.float()


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm as the TPU kernel computes it: f32 statistics, the normalized
    row rounded to the working dtype, then times the scale in that dtype."""
    h32 = h.float()
    y = (h32 * torch.rsqrt(h32.square().mean(-1, keepdim=True) + eps)).to(h.dtype)
    return y * w.to(h.dtype)


def _gemv(x: torch.Tensor, leaf) -> torch.Tensor:
    """x [B, K] times an int8 {q, scale} kernel: f32 sums of exact products,
    times the f32 per-column scale -> f32 [B, N]."""
    return (x.float() @ leaf["q"].float()) * leaf["scale"].float().squeeze(-2)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., H, d] f32, rotate-half RoPE in f32; cos/sin [..., 1, d]."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _qdq(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize per (row, head) as the int8-cache kernel does:
    the current token is attended through its int8 value."""
    q, scale = quantize_kv(x)
    return dequantize_kv(q, scale, x.dtype)


def fused_verify_hidden_plain(layers, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2,
                              end2, positions, k_scale=None, v_scale=None, slot_lora=None):
    """K4's function for T fed tokens per sample in plain PyTorch, rounding
    to h0's dtype where the kernel rounds to bf16. layers: the tree's layer
    list; h0 [B, T, D]; cache_k/v [L, B, S, H, d] (int8 with k_scale/v_scale
    [L, B, S, H] f32, or float); lengths0/start2/end2 [B], the cache ranges
    every fed token attends; positions [B, T]. Fed token t also attends fed
    tokens 0..t. As in the TPU kernel's T > 1 form, the fed tokens'
    probabilities are rounded to h0's dtype for the value product like the
    cache's; at T = 1 the current token's is not. Reads the cache, never
    writes it. slot_lora: `build_fd_lora`'s bundle with "sel" [B, n], whose
    terms are added as K4-LoRA adds them (module docstring). Returns
    (hidden [B, T, D] before the final norm, k_new, v_new [L, B, T, H, d]:
    the new rows as attended)."""
    dt = h0.dtype
    b, t, d = h0.shape
    heads, hd, f = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    s = cache_k.shape[2]
    scale = hd**-0.5
    cos, sin = (c[:, :, None] for c in rope_cos_sin(positions, hd, cfg.rope_theta))
    kpos = torch.arange(s, device=h0.device)[None, :]
    valid = (kpos < lengths0[:, None]) | ((kpos >= start2[:, None]) & (kpos < end2[:, None]))
    causal = torch.ones(t, t, dtype=torch.bool, device=h0.device).tril()
    if slot_lora is not None:
        widths = list(slot_lora["widths"])
        masks = _lora_args(slot_lora, t).view(b, t, -1).split(widths, dim=-1)

    def lora_at(i):
        """Layer i's (A, B) of qkv, o, gateup and down; Nones without a
        bundle."""
        if slot_lora is None:
            return [None] * 4
        a = slot_lora["a_d"][i].split(widths[:3], dim=-1) + (slot_lora["a_f"][i],)
        return list(zip(a, (slot_lora[n][i] for n in ("b_qkv", "b_o", "b_gu", "b_down"))))

    def term(x, j, ab):
        return 0.0 if ab is None else _lora_term(x, ab[0], masks[j], ab[1], dt)

    h = h0
    k_rows, v_rows = [], []
    for i, p in enumerate(layers):
        lo = lora_at(i)
        x1 = _rms(h, p["input_ln"]["scale"], cfg.rms_norm_eps)
        qkv = _gemv(x1, p["attn"]["qkv"]["kernel"]) + term(x1, 0, lo[0])
        q, k, v = qkv.view(b, t, 3, heads, hd).unbind(2)
        q, k, v = _rope(q, cos, sin).to(dt), _rope(k, cos, sin).to(dt), v.to(dt)
        ck, cv = cache_k[i], cache_v[i]
        if k_scale is not None:
            k, v = _qdq(k), _qdq(v)
            ck, cv = dequantize_kv(ck, k_scale[i], dt), dequantize_kv(cv, v_scale[i], dt)
        logits = torch.einsum("bthd,bshd->bhts", q.float(), ck.float()) * scale
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        fed = torch.einsum("bthd,buhd->bhtu", q.float(), k.float()) * scale
        fed = fed.masked_fill(~causal, float("-inf"))
        m = torch.maximum(logits.amax(-1), fed.amax(-1))  # [B, H, T]
        p_ = torch.exp(logits - m[..., None])
        p_fed = torch.exp(fed - m[..., None])
        den = p_.sum(-1) + p_fed.sum(-1)
        ctx = torch.einsum("bhts,bshd->bthd", p_.to(dt).float(), cv.float())
        ctx = ctx + torch.einsum("bhtu,buhd->bthd", p_fed.to(dt).float() if t > 1 else p_fed,
                                 v.float())
        attn = (ctx / den.transpose(1, 2)[..., None]).to(dt).reshape(b, t, d)
        h = h + (_gemv(attn, p["attn"]["o"]["kernel"]) + term(attn, 1, lo[1])).to(dt)
        x2 = _rms(h, p["post_ln"]["scale"], cfg.rms_norm_eps)
        gate, up = (_gemv(x2, p["mlp"]["gateup"]["kernel"]) + term(x2, 2, lo[2])).split(f, dim=-1)
        xm = (F.silu(gate) * up).to(dt)
        h = h + (_gemv(xm, p["mlp"]["down"]["kernel"]) + term(xm, 3, lo[3])).to(dt)
        k_rows.append(k)
        v_rows.append(v)
    return h, torch.stack(k_rows), torch.stack(v_rows)


def fused_decode_hidden_plain(layers, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2,
                              end2, positions, k_scale=None, v_scale=None, slot_lora=None):
    """K4's one-token function in plain PyTorch: `fused_verify_hidden_plain`
    at T = 1. h0 [B, D]; positions [B]. Returns (hidden [B, D] before the
    final norm, k_new, v_new [L, B, H, d]: the new rows as attended)."""
    hidden, k_new, v_new = fused_verify_hidden_plain(
        layers, cfg, h0[:, None], cache_k, cache_v, lengths0, start2, end2, positions[:, None],
        k_scale, v_scale, slot_lora)
    return hidden[:, 0], k_new[:, :, 0], v_new[:, :, 0]


def write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos) -> None:
    """Store the new rows [L, B, T, H, d] (or [L, B, H, d], T = 1) at cache
    slots write_pos[b] + t, in place; slots at or past the cache's end are
    dropped, as the kernel drops them."""
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, :, None], v_new[:, :, None]
    b, t = k_new.shape[1:3]
    cols = write_pos.long()[:, None] + torch.arange(t, device=k_new.device)
    rows = torch.arange(b, device=k_new.device)[:, None].expand(b, t)
    keep = cols < cache_k.shape[2]
    rows, cols = rows[keep], cols[keep]
    k_new, v_new = k_new[:, keep], v_new[:, keep]
    if k_scale is not None:
        for cache, scales, new in ((cache_k, k_scale, k_new), (cache_v, v_scale, v_new)):
            cache[:, rows, cols], scales[:, rows, cols] = quantize_kv(new)
    else:
        cache_k[:, rows, cols] = k_new.to(cache_k.dtype)
        cache_v[:, rows, cols] = v_new.to(cache_v.dtype)


def _fused_call(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                write_pos, positions, k_scale, v_scale, weights, t_tok: int, slot_lora=None):
    """One `tp_fused_decode` call over h0 [B * t_tok, D] (sample-major),
    positions [B * t_tok], with K4-LoRA's terms when a bundle is given;
    returns (hidden, k_new, v_new [L, B * t_tok, H, d])."""
    weights = weights or FusedWeights(lm_params, cfg)
    layers, b, s, hkv, hd = cache_k.shape
    d, f, heads = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    rows = b * t_tok
    if (h0.shape != (rows, d) or positions.shape != (rows,) or cache_v.shape != cache_k.shape
            or weights.layers != layers):
        raise ValueError(f"fused_decode: h0 {tuple(h0.shape)}, positions "
                         f"{tuple(positions.shape)}, cache {tuple(cache_k.shape)}, "
                         f"{weights.layers} weight layers, {t_tok} tokens a sample")
    int8 = cache_k.dtype == torch.int8
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    cache_dt = torch.int8 if int8 else bf
    tensors = dict(h0=(h0, bf), cache_k=(cache_k, cache_dt), cache_v=(cache_v, cache_dt),
                   lengths0=(lengths0, i32), start2=(start2, i32), end2=(end2, i32),
                   write_pos=(write_pos, i32), positions=(positions, i32))
    if int8:
        if k_scale is None or v_scale is None or k_scale.shape != cache_k.shape[:-1]:
            raise ValueError("fused_decode: an int8 cache needs k_scale/v_scale [L, B, S, H]")
        tensors.update(k_scale=(k_scale, f32), v_scale=(v_scale, f32))
    widths = (0, 0, 0, 0)
    lora = {}
    if slot_lora is not None:
        widths = tuple(slot_lora["widths"])
        wq, wo, wg, wd = widths
        lora = {"a_d": (layers, d, wq + wo + wg), "a_f": (layers, f, wd),
                "b_qkv": (layers, wq, 3 * d), "b_o": (layers, wo, d),
                "b_gu": (layers, wg, 2 * f), "b_down": (layers, wd, d)}
        for name, shape in lora.items():
            if tuple(slot_lora[name].shape) != shape:
                raise ValueError(f"fused_decode: slot_lora {name} is "
                                 f"{tuple(slot_lora[name].shape)}, expected {shape}")
        lora = {name: slot_lora[name] for name in lora}
        lora["selm"] = _lora_args(slot_lora, t_tok)
        if lora["selm"].shape != (rows, sum(widths)):
            raise ValueError(f"fused_decode: slot_lora sel gives a mask of "
                             f"{tuple(lora['selm'].shape)}, expected ({rows}, {sum(widths)})")
        tensors.update({"lora_" + k: (v, f32 if k == "selm" else bf) for k, v in lora.items()})
    stream = _build.cuda_args("fused_decode", **tensors)
    lib = _build.library()
    hidden = h0.clone()
    k_new = torch.empty((layers, rows, hkv, hd), dtype=bf, device=h0.device)
    v_new = torch.empty_like(k_new)
    work = torch.empty(lib.tp_fused_decode_workspace(rows, d, f, max(widths[:3]), widths[3]),
                       dtype=torch.uint8, device=h0.device)
    lora_ptrs = [lora[k].data_ptr() if lora else None
                 for k in ("a_d", "a_f", "b_qkv", "b_o", "b_gu", "b_down", "selm")]
    rc = lib.tp_fused_decode(
        weights.table, layers, b, t_tok, d, f, heads, hd, s, cfg.rms_norm_eps, cfg.rope_theta,
        hidden.data_ptr(), lengths0.data_ptr(), start2.data_ptr(), end2.data_ptr(),
        write_pos.data_ptr(), positions.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None, int(int8),
        k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(), *lora_ptrs, *widths, stream,
    )
    _build.check(rc, "fused_decode")
    return hidden, k_new, v_new


def _check_tree(lm_params, cfg: LMConfig, weights) -> None:
    if weights is None and not fused_eligible(lm_params, cfg):  # a table was checked when built
        raise NotImplementedError("K4 takes llama MHA trees with head_dim 128 and int8 fused "
                                  "{q, scale} kernels (no u16-packed qp storage)")


def fused_decode_hidden(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                        write_pos, positions, *, k_scale=None, v_scale=None, slot_lora=None,
                        weights: FusedWeights | None = None):
    """One decode step of the whole decoder stack.

    h0 [B, D] embedded tokens; cache_k/v [L, B, S, H, 128] int8 (with
    k_scale/v_scale [L, B, S, H] f32) or bf16; lengths0/start2/end2 the
    attendable cache ranges [0, len0) U [start2, end2) (the current token
    is always attended); write_pos the cache slot of the new row; positions
    the RoPE positions; all [B] int32. weights: `FusedWeights` of
    `lm_params`, built here when not given. slot_lora: `build_fd_lora`'s
    bundle with the selection rows "sel" [B, n] (K4-LoRA). Writes the new
    rows into the cache in place and returns (hidden [B, D] before the
    final norm, k_new, v_new [L, B, H, 128])."""
    if h0.dim() != 2:
        raise ValueError(f"fused_decode_hidden: h0 is {tuple(h0.shape)}, expected [B, D]; "
                         "T fed tokens a sample go through fused_verify_hidden")
    _check_tree(lm_params, cfg, weights)
    if h0.device.type == "cpu":
        hidden, k_new, v_new = fused_decode_hidden_plain(
            lm_params["layers"], cfg, h0, cache_k, cache_v, lengths0, start2, end2, positions,
            k_scale, v_scale, slot_lora,
        )
        write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos)
        return hidden, k_new, v_new
    out = _fused_call(lm_params, cfg, h0, cache_k, cache_v, lengths0, start2, end2, write_pos,
                      positions, k_scale, v_scale, weights, 1, slot_lora)
    if slot_lora is None:
        fused_decode_hidden.launches += 1
    else:
        fused_decode_hidden.lora_launches += 1
    return out


def fused_verify_hidden(lm_params, cfg: LMConfig, h0, cache_k, cache_v, lengths0, start2, end2,
                        write_pos0, positions, *, k_scale=None, v_scale=None, slot_lora=None,
                        weights: FusedWeights | None = None):
    """The whole decoder stack for T fed tokens a sample (speculative
    verify: the last accepted token and its drafts, through one pass of the
    weights).

    h0 [B, T, D] embedded tokens; positions [B, T] their RoPE positions;
    lengths0/start2/end2 [B] the cache ranges [0, len0) U [start2, end2)
    that all T queries attend; fed token t also attends fed tokens 0..t and
    writes its row at cache slot write_pos0 + t (a slot past the cache's
    end is dropped). The cache as in `fused_decode_hidden`, written in
    place; slot_lora as there, one selection row a sample. Returns (hidden
    [B, T, D] before the final norm, k_new, v_new [L, B, T, H, 128])."""
    if h0.dim() != 3:
        raise ValueError(f"fused_verify_hidden: h0 is {tuple(h0.shape)}, expected [B, T, D]")
    _check_tree(lm_params, cfg, weights)
    b, t, d = h0.shape
    if h0.device.type == "cpu":
        hidden, k_new, v_new = fused_verify_hidden_plain(
            lm_params["layers"], cfg, h0, cache_k, cache_v, lengths0, start2, end2, positions,
            k_scale, v_scale, slot_lora,
        )
        write_rows(cache_k, cache_v, k_scale, v_scale, k_new, v_new, write_pos0)
        return hidden, k_new, v_new
    hidden, k_new, v_new = _fused_call(
        lm_params, cfg, h0.reshape(b * t, d), cache_k, cache_v, lengths0, start2, end2,
        write_pos0, positions.reshape(b * t).contiguous(), k_scale, v_scale, weights, t,
        slot_lora)
    if slot_lora is None:
        fused_verify_hidden.launches += 1
    else:
        fused_verify_hidden.lora_launches += 1
    layers = k_new.shape[0]
    return (hidden.view(b, t, d), k_new.view(layers, b, t, *k_new.shape[2:]),
            v_new.view(layers, b, t, *v_new.shape[2:]))


# launch counts: `launches` without a LoRA bundle, `lora_launches` with one
# (K4-LoRA, T = 1 and the verify form)
fused_verify_hidden.launches = 0
fused_decode_hidden.launches = 0
fused_decode_hidden.lora_launches = 0
fused_verify_hidden.lora_launches = 0
