"""The port's parameters: the bridge from the JAX package's pytree, and
random weights made on the device.

Parameters are nested dicts of tensors with the JAX package's key names.
Linear kernels keep JAX's **[in, out]** layout (y = x @ W): nothing is
transposed. The JAX package stacks each tower's and the LM's layers on a
leading axis; here `"layers"` is a list with one dict per layer.
`patch_embed.kernel` is the `[3*p*p, W]` conv-flatten matmul of
`clip_vit.patchify`, in both packages. An int8 kernel is the leaf
{"q": int8 [in, out], "scale": f32 [1, out]} of `ops/quantize` in both.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.ops.quantize import fuse_llama_layers, is_qleaf, quantize_tree


def to_tensors(node):
    """A pytree of numpy arrays -> the same nesting of CPU tensors (copies)."""
    if isinstance(node, dict):
        return {k: to_tensors(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_tensors(v) for v in node]
    if node is None:
        return None
    arr = np.array(node, copy=True)
    if arr.dtype.name == "bfloat16":  # JAX's bf16 arrays (ml_dtypes)
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _layer_slice(node, i: int):
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    return node[i]


def params_from_jax(tree, cfg: TokenPackerVLMConfig):
    """The JAX `init_vlm`-shaped pytree (leaves as numpy arrays; any of its
    "vision" / "projector" / "lm" parts) -> the port's parameters as CPU
    tensors of the same dtypes; `params_to` moves and casts them."""
    if cfg.lm.model_family != "llama":
        raise NotImplementedError("only the llama family is ported")
    depth = {"vision": cfg.vision.num_hidden_layers, "lm": cfg.lm.num_hidden_layers}
    out = {}
    for part in ("vision", "projector", "lm"):
        if part not in tree:  # a partial tree, e.g. the LM alone
            continue
        node = dict(tree[part])
        if part in depth:
            stacked = node["layers"]
            n_layers = len(np.asarray(stacked["ln1" if part == "vision" else "input_ln"]["scale"]))
            if n_layers != depth[part]:
                raise ValueError(f"{part}: {n_layers} stacked layers, config says {depth[part]}")
            node["layers"] = [_layer_slice(stacked, i) for i in range(n_layers)]
        out[part] = to_tensors(node)
    return out


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack([params_to_jax(t) for t in layers])


def params_to_jax(params):
    """Inverse of `params_from_jax`: numpy leaves (fp32 for bf16 tensors),
    the per-layer lists stacked again."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, list):
        return _stack(params)
    if params is None:
        return None
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to(params, device: torch.device | str, dtype: torch.dtype):
    """A copy of the parameters on `device`, floating-point tensors cast to
    `dtype`, except the f32 scales of int8 kernels (int8 stays int8)."""
    if is_qleaf(params):
        return {"q": params["q"].to(device), "scale": params["scale"].to(device)}
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    if params is None:
        return None
    return params.to(device=device, dtype=dtype if params.is_floating_point() else None)


def quantize_lm_int8(params, min_size: int = 1 << 16):
    """The `load_8bit` serving form of the LM, in place: fuse q/k/v and
    gate/up, then quantize every kernel of at least `min_size` elements
    (counted over all layers, as the JAX package counts its stacked
    leaves) to int8 {q, scale}. The layers are replaced one by one, so on
    the card the bf16 and the int8 LM never coexist whole (once the caller
    holds no other reference to the bf16 layers). Returns `params`."""
    lm = params["lm"]
    layers = lm["layers"]
    per_layer = -(-min_size // len(layers))
    for i, layer in enumerate(layers):
        layers[i] = quantize_tree(fuse_llama_layers({"layers": [layer]}), per_layer)["layers"][0]
    lm.update(quantize_tree({k: v for k, v in lm.items() if k != "layers"}, min_size))
    return params


def _normal_fn(seed: int, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape, std=0.02, mean=0.0):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std).add_(mean).to(dtype)

    return normal


def _init_lm(lc, normal):
    def scale(n):
        return normal(n, std=0.1, mean=1.0)

    def lin(i, o):
        return {"kernel": normal(i, o)}

    d, kvd, f = lc.hidden_size, lc.kv_heads * lc.head_dim, lc.intermediate_size
    return {
        "embed": normal(lc.vocab_size, d),
        "layers": [
            {
                "input_ln": {"scale": scale(d)},
                "attn": {"q": lin(d, d), "k": lin(d, kvd), "v": lin(d, kvd), "o": lin(d, d)},
                "post_ln": {"scale": scale(d)},
                "mlp": {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)},
            }
            for _ in range(lc.num_hidden_layers)
        ],
        "norm": {"scale": scale(d)},
        "lm_head": lin(d, lc.vocab_size),
    }


def init_lm_on_device(lm_cfg, seed: int = 0, device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.bfloat16):
    """The LM part of `init_vlm_on_device` alone, from its own seed."""
    if lm_cfg.model_family != "llama":
        raise NotImplementedError("only the llama family is ported")
    return _init_lm(lm_cfg, _normal_fn(seed, device, dtype))


def init_vlm_on_device(cfg: TokenPackerVLMConfig, seed: int = 0,
                       device: torch.device | str = "cuda",
                       dtype: torch.dtype = torch.bfloat16):
    """Random weights with the shapes of the JAX `init_vlm`, made directly on
    `device` from a `torch.Generator` seeded with `seed` (no host copy of
    the model is built). Linear kernels, embeddings and biases are
    N(0, 0.02^2); norm scales are 1 + N(0, 0.1^2). Unlike the JAX init
    (biases 0, scales 1), every bias and scale differs, so a parity check
    on these weights also sees a norm or bias that is dropped or swapped."""
    if cfg.lm.model_family != "llama":
        raise NotImplementedError("only the llama family is ported")
    normal = _normal_fn(seed, device, dtype)

    def scale(n):
        return normal(n, std=0.1, mean=1.0)

    def lin(i, o, bias=True):
        p = {"kernel": normal(i, o)}
        if bias:
            p["bias"] = normal(o)
        return p

    def ln(n):
        return {"scale": scale(n), "bias": normal(n)}

    vc, pc = cfg.vision, cfg.projector
    w = vc.hidden_size
    vision = {
        "class_embedding": normal(w),
        "patch_embed": {"kernel": normal(3 * vc.patch_size**2, w)},
        "pos_embed": normal(vc.seq_len, w),
        "pre_ln": ln(w),
        "post_ln": ln(w),
        "layers": [
            {
                "ln1": ln(w),
                "attn": {name: lin(w, w) for name in ("q", "k", "v", "o")},
                "ln2": ln(w),
                "mlp": {"fc1": lin(w, vc.intermediate_size), "fc2": lin(vc.intermediate_size, w)},
            }
            for _ in range(vc.num_hidden_layers)
        ],
    }
    e = pc.embed_dim
    projector = {
        "q_proj": lin(pc.kv_dim, e, bias=False),
        "k_proj": {"fc1": lin(pc.kv_input_dim, e), "fc2": lin(e, e)},
        "v_proj": {"fc1": lin(pc.kv_input_dim, e), "fc2": lin(e, e)},
        "ln_q": ln(e),
        "ln_k": ln(e),
        "ln_v": ln(e),
        "attn": {name: lin(e, e) for name in ("q", "k", "v", "o")},
        "mlp": {"fc1": lin(e, pc.hidden_size), "fc2": lin(pc.hidden_size, pc.hidden_size)},
    }
    return {"vision": vision, "projector": projector, "lm": _init_lm(cfg.lm, normal)}
