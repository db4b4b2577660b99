"""Weight-only int8 quantization (the int8 half of
`tokenpacker_tpu/ops/quantize.py`; the 4-bit formats come with K6).

Per-output-channel symmetric int8: W ~ q * scale, q int8 [in, out], scale
f32 [1, out]. A quantized kernel is the leaf {"q": int8, "scale": f32},
recognised by exactly those keys (`ops/layers.linear`).

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
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


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


def quantize_tree(params, min_size: int = 1 << 16):
    """Quantize every 2D+ "kernel" leaf with at least `min_size` elements
    (counted over all layers of a layer list, as the JAX package counts
    its stacked leaves) into {"q", "scale"}. Other leaves are shared."""

    def walk(node, in_kernel: bool, repeat: int):
        if isinstance(node, dict):
            return {k: walk(v, in_kernel or k == "kernel", repeat) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_kernel, repeat * len(node)) for v in node]
        if (node is None or not in_kernel or node.dim() < 2
                or node.numel() * repeat < min_size):
            return node
        q, scale = quantize_int8(node)
        return {"q": q, "scale": scale}

    return walk(params, False, 1)


def dequantize_tree(params, dtype=torch.bfloat16):
    if is_qleaf(params):
        return dequantize_int8(params["q"], params["scale"], dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_tree(v, dtype) for v in params]
    return params


def tree_bytes(params) -> int:
    """Bytes held by the tensors of a parameter tree."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(tree_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
