"""K9: one whole pre-LN CLIP block (counterpart of
`tokenpacker_tpu/ops/vit_block.py`).

`vit_block(x, p, num_heads, eps)` runs LN1 -> q/k/v with bias -> softmax
attention -> o with bias, + residual -> LN2 -> fc1 with bias ->
quick-GELU -> fc2 with bias, + residual on x [N, T, W], with one layer's
dense params `p` (the `models/clip_vit` layer tree). On a CUDA tensor it
makes one call into `csrc/vit_block.cu`, which enqueues the block's seven
kernels (two LayerNorm row passes, four wgmma products fed by TMA tiles
with their bias, GELU and residual epilogues, and K1's attention); on a
CPU tensor it runs `vit_block_plain`, the same function in plain
PyTorch.

Numerics are the TPU kernel's (`_kernel`), which differ from the per-op
block of `models/clip_vit` in three places: LayerNorm in fp32 cast to x's
dtype before each product; each product a dot with f32 sums, plus the f32
bias, then cast; attention logits in f32 scaled by d^-0.5 * log2(e),
exp2 against the row maximum, the probabilities cast to x's dtype and
their row sum taken over those rounded values, the output divided by it
once; quick-GELU in f32 before the cast (the per-op block computes it in
the compute dtype). The residual adds are in x's dtype.

The kernel reads every product's weight as a dense array: an int8 tower
(`clip_vit.quantize_tower_int8`) raises.
"""

from __future__ import annotations

import ctypes

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.quantize import is_qleaf

_LOG2E = 1.4426950408889634
# the order of `tp_vit_block`'s parameter table
_PARAMS = (("ln1", "scale"), ("ln1", "bias"), ("attn", "q"), ("attn", "k"), ("attn", "v"),
           ("attn", "o"), ("ln2", "scale"), ("ln2", "bias"), ("mlp", "fc1"), ("mlp", "fc2"))


def _leaves(p):
    """(name, tensor) of the table in `tp_vit_block`'s order: LN params,
    then kernel and bias of each product."""
    out = []
    for group, name in _PARAMS:
        if group.startswith("ln"):
            out.append((f"{group}.{name}", p[group][name]))
        else:
            leaf = p[group][name]
            if is_qleaf(leaf["kernel"]):
                raise ValueError(f"vit_block: {group}.{name} is quantized; the fused block "
                                 "takes a dense tower (the int8 tower runs per op)")
            out += [(f"{group}.{name}.kernel", leaf["kernel"]),
                    (f"{group}.{name}.bias", leaf["bias"])]
    return out


def _ln(x: torch.Tensor, lp, eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis (the TPU kernel's `_ln`)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * lp["scale"].float() + lp["bias"].float()


def _dot(a: torch.Tensor, leaf) -> torch.Tensor:
    """a times a dense kernel with f32 sums, plus the f32 bias -> f32."""
    return a.float() @ leaf["kernel"].float() + leaf["bias"].float()


def vit_block_plain(x: torch.Tensor, p, num_heads: int, eps: float) -> torch.Tensor:
    """The TPU kernel's block in plain PyTorch: x [N, T, W] -> [N, T, W]."""
    _leaves(p)  # dense only, as the kernel
    dt = x.dtype
    n, t, w = x.shape
    d = w // num_heads
    xn = _ln(x, p["ln1"], eps).to(dt)
    q, k, v = (_dot(xn, p["attn"][name]).to(dt).view(n, t, num_heads, d)
               for name in ("q", "k", "v"))
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * (d**-0.5 * _LOG2E)
    probs = torch.exp2(s - s.amax(-1, keepdim=True)).to(dt).float()
    out = torch.einsum("nhqk,nkhd->nqhd", probs, v.float())
    row_sum = probs.sum(-1).transpose(1, 2)[..., None]  # [N, T, H, 1]
    attn = (out * (1.0 / row_sum)).to(dt).reshape(n, t, w)
    x1 = x + _dot(attn, p["attn"]["o"]).to(dt)
    h32 = _dot(_ln(x1, p["ln2"], eps).to(dt), p["mlp"]["fc1"])
    h1 = (h32 * (1.0 / (1.0 + torch.exp(-1.702 * h32)))).to(dt)
    return x1 + _dot(h1, p["mlp"]["fc2"]).to(dt)


def vit_block(x: torch.Tensor, p, num_heads: int, eps: float) -> torch.Tensor:
    """One pre-LN CLIP block on x [N, T, W] with one layer's dense params
    (module docstring). On the card: bf16 x and params, head_dim 64, W and
    the MLP width F multiples of 128."""
    if x.device.type == "cpu":
        return vit_block_plain(x, p, num_heads, eps)
    n, t, w = x.shape
    leaves = _leaves(p)
    f = p["mlp"]["fc1"]["kernel"].shape[-1]
    dims = {"q": (w, w), "k": (w, w), "v": (w, w), "o": (w, w), "fc1": (w, f), "fc2": (f, w)}
    for name, tensor in leaves:
        group, what = name.split(".")[-2:]
        want = (w,) if group not in dims else dims[group] if what == "kernel" else dims[group][1:]
        if tuple(tensor.shape) != want:
            raise ValueError(f"vit_block: {name} is {tuple(tensor.shape)}, expected {want}")
    bf = torch.bfloat16
    m = n * t
    bufs = [x] + [torch.empty((m, w), dtype=bf, device=x.device) for _ in range(5)]
    bufs += [torch.empty((m, f), dtype=bf, device=x.device), torch.empty_like(x)]
    stream = _build.cuda_args("vit_block", **{name: (tensor, bf) for name, tensor in leaves},
                              **{f"buffer{i}": (b, bf) for i, b in enumerate(bufs)})
    table = (ctypes.c_void_p * len(leaves))(*(tensor.data_ptr() for _, tensor in leaves))
    buffers = (ctypes.c_void_p * len(bufs))(*(b.data_ptr() for b in bufs))
    rc = _build.library().tp_vit_block(table, buffers, n, t, w, f, num_heads, eps, stream)
    _build.check(rc, "vit_block")
    vit_block.launches += 1
    return bufs[-1]


vit_block.launches = 0
