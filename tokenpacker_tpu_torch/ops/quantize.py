"""Weight-only quantization (counterpart of
`tokenpacker_tpu/ops/quantize.py`): int8 and the 4-bit nf4/int4 formats.

Per-output-channel symmetric int8: W ~ q * scale, q int8 [in, out], scale
f32 [1, out]. A quantized kernel is the leaf {"q": int8, "scale": f32},
recognised by exactly those keys (`ops/layers.linear`).

4-bit (the `load_4bit` slot): blockwise absmax over the in axis, each
column's consecutive `block` rows sharing one f32 absmax, and each value
the nearest of 16 codes (nf4: the QLoRA NormalFloat4 codebook; int4:
round(w / absmax * 7) in [-7, 7], stored + 8). Two codes per byte, row 2i
in the low nibble and 2i+1 in the high one. The leaf is
{"q4:<type>:<block>": uint8 [in/2, out], "absmax": f32 [in/block, out]},
the format carried in the key, exactly as the JAX package makes it, so
the weight bridge moves it unchanged.

The JAX package stacks the decoder layers on a leading axis; the port
keeps a list of per-layer dicts. Quantization is per layer and per column
either way, so the two give the same bytes. `quantize_tree`'s size
threshold applies to the stacked size (layers x in x out), as in JAX, so
both packages quantize the same leaves.
"""

from __future__ import annotations

import torch


def quantize_int8(w: torch.Tensor, axis: int = -2):
    """w: [..., in, out] -> (q int8 [..., in, out], scale f32 [..., 1, out]),
    symmetric over the reduction (in) axis. Rounds half to even, as
    `jnp.round` does."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    # a divisor on w's device: CUDA divides by a Python scalar through its
    # reciprocal, which is not amax / 127 in every bit
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / w32.new_full((), 127.0))
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


# NormalFloat4 codebook (QLoRA, appendix E; bitsandbytes create_normal_map):
# 16 quantiles of N(0, 1) normalized to [-1, 1]
NF4_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
# elements of the [in, columns, 16] distance tensor of one nf4 chunk: the
# nearest-code search runs over column chunks of this size (the whole of
# Vicuna-7B's gateup at once would be 5.8 GB of f32)
_NF4_CHUNK_ELEMS = 1 << 26


def quantize_4bit(w: torch.Tensor, block: int = 64, quant_type: str = "nf4") -> dict:
    """w: [in, out] -> {"q4:<quant_type>:<block>": uint8 [in/2, out],
    "absmax": f32 [in/block, out]}. nf4 picks the nearest code by f32
    |norm - code|, ties to the lower index (`jnp.argmin`'s rule); int4
    rounds half to even. Same bytes as the JAX package."""
    k, n = w.shape
    if k % block or k % 2:
        raise ValueError(f"quantize_4bit: in dim {k} is not a multiple of {block} and 2")
    wf = w.float().reshape(k // block, block, n)
    absmax = wf.abs().amax(dim=1)  # [k/block, n]
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    norm = (wf / safe[:, None, :]).reshape(k, n)  # in [-1, 1]
    del wf
    if quant_type == "nf4":
        code = torch.tensor(NF4_VALUES, dtype=torch.float32, device=w.device)
        step = max(1, _NF4_CHUNK_ELEMS // (k * 16))
        idx = torch.cat([(norm[:, j:j + step, None] - code).abs().argmin(dim=-1).to(torch.uint8)
                         for j in range(0, n, step)], dim=1)
    elif quant_type == "int4":
        idx = (torch.round(norm * 7.0).clamp(-7, 7) + 8).to(torch.uint8)
    else:
        raise ValueError(f"unknown quant_type {quant_type}")
    packed = idx[0::2] | (idx[1::2] << 4)  # [k/2, n]
    return {f"q4:{quant_type}:{block}": packed.contiguous(), "absmax": absmax}


def q4_meta(q: dict):
    """(packed key, quant_type, block) of a 4-bit leaf."""
    key = next(k for k in q if k.startswith("q4:"))
    _, quant_type, block = key.split(":")
    return key, quant_type, int(block)


def is_q4leaf(x) -> bool:
    return isinstance(x, dict) and any(k.startswith("q4:") for k in x)


def dequantize_4bit(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_4bit -> dense [in, out] (leading dims pass
    through): code (f32) times the block's absmax, then cast."""
    key, quant_type, block = q4_meta(q)
    packed = q[key]
    k2, n = packed.shape[-2:]
    lead = packed.shape[:-2]
    k = 2 * k2
    idx = torch.stack([packed & 0xF, packed >> 4], dim=-2).reshape(*lead, k, n).long()
    if quant_type == "nf4":
        norm = torch.tensor(NF4_VALUES, dtype=torch.float32, device=packed.device)[idx]
    else:
        # a device-tensor divisor, as in kv_quant.quantize_kv
        norm = (idx.float() - 8.0) / packed.new_full((), 7.0, dtype=torch.float32)
    w = norm.reshape(*lead, k // block, block, n) * q["absmax"][..., :, None, :]
    return w.reshape(*lead, k, n).to(dtype)


def quantize_tree_4bit(params, quant_type: str = "nf4", block: int = 64,
                       min_size: int = 1 << 16):
    """4-bit analog of `quantize_tree`: every 2D+ "kernel" leaf with at
    least `min_size` elements (counted over all layers of a layer list)
    whose in dim divides by `block` and 2 becomes a 4-bit leaf; the others
    are shared."""

    def quant(node):
        if node.shape[-2] % block or node.shape[-2] % 2:
            return node
        if node.dim() == 2:
            return quantize_4bit(node, block, quant_type)
        slices = [quant(s) for s in node]
        return {key: torch.stack([s[key] for s in slices]) for key in slices[0]}

    return _map_kernels(params, min_size, quant)


def dequantize_tree_4bit(params, dtype=torch.bfloat16):
    return _map_leaves(params, is_q4leaf, lambda leaf: dequantize_4bit(leaf, dtype))


def fuse_llama_layers(lm_params):
    """q/k/v -> qkv and gate/up -> gateup kernels (concatenated along the
    output axis) in every layer of a LLaMA parameter tree. The other keys
    are shared with the input tree, not copied."""
    layers = []
    for layer in lm_params["layers"]:
        attn, mlp = layer["attn"], layer["mlp"]
        qkv = torch.cat([attn["q"]["kernel"], attn["k"]["kernel"], attn["v"]["kernel"]], dim=-1)
        gateup = torch.cat([mlp["gate"]["kernel"], mlp["up"]["kernel"]], dim=-1)
        layers.append({
            **layer,
            "attn": {"qkv": {"kernel": qkv}, "o": attn["o"]},
            "mlp": {"gateup": {"kernel": gateup}, "down": mlp["down"]},
        })
    return {**lm_params, "layers": layers}


def _map_kernels(params, min_size: int, quant):
    """`quant(tensor)` applied to every 2D+ "kernel" leaf with at least
    `min_size` elements, counted over all layers of a layer list as the
    JAX package counts its stacked leaves; other leaves are shared."""

    def walk(node, in_kernel: bool, repeat: int):
        if isinstance(node, dict):
            return {k: walk(v, in_kernel or k == "kernel", repeat) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_kernel, repeat * len(node)) for v in node]
        if (node is None or not in_kernel or node.dim() < 2
                or node.numel() * repeat < min_size):
            return node
        return quant(node)

    return walk(params, False, 1)


def _map_leaves(params, is_leaf, fn):
    """`fn(leaf)` on every quantized leaf that `is_leaf` recognises."""
    if is_leaf(params):
        return fn(params)
    if isinstance(params, dict):
        return {k: _map_leaves(v, is_leaf, fn) for k, v in params.items()}
    if isinstance(params, list):
        return [_map_leaves(v, is_leaf, fn) for v in params]
    return params


def quantize_tree(params, min_size: int = 1 << 16):
    """Quantize every 2D+ "kernel" leaf with at least `min_size` elements
    (counted over all layers of a layer list, as the JAX package counts
    its stacked leaves) into {"q", "scale"}. Other leaves are shared."""

    def quant(node):
        q, scale = quantize_int8(node)
        return {"q": q, "scale": scale}

    return _map_kernels(params, min_size, quant)


def dequantize_tree(params, dtype=torch.bfloat16):
    return _map_leaves(params, is_qleaf,
                       lambda leaf: dequantize_int8(leaf["q"], leaf["scale"], dtype))


def tree_bytes(params) -> int:
    """Bytes held by the tensors of a parameter tree."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(tree_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
