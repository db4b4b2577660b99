"""The port's parameters: the bridge from the JAX package's pytree, and
random weights made on the device.

Parameters are nested dicts of tensors with the JAX package's key names,
for both LM families (llama; MPT: `wte`, `layers[*].{norm_1, attn.{wqkv,
out}, norm_2, ffn.{up, down}}`, `norm_f`).
Linear kernels keep JAX's **[in, out]** layout (y = x @ W): nothing is
transposed. The JAX package stacks each tower's and the LM's layers on a
leading axis; here `"layers"` is a list with one dict per layer.
`patch_embed.kernel` is the `[3*p*p, W]` conv-flatten matmul of
`clip_vit.patchify`, in both packages. An int8 kernel is the leaf
{"q": int8 [in, out], "scale": f32 [1, out]} of `ops/quantize` in both,
a 4-bit one {"q4:<type>:<block>": uint8 [in/2, out], "absmax": f32
[in/block, out]}.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.mpt import init_mpt
from tokenpacker_tpu_torch.ops.quantize import (
    fuse_llama_layers,
    is_q4leaf,
    is_qleaf,
    quantize_tree,
    quantize_tree_4bit,
)


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
    first_norm = {"vision": "ln1", "lm": "norm_1" if cfg.lm.model_family == "mpt" else "input_ln"}
    depth = {"vision": cfg.vision.num_hidden_layers, "lm": cfg.lm.num_hidden_layers}
    out = {}
    for part in ("vision", "projector", "lm"):
        if part not in tree:  # a partial tree, e.g. the LM alone
            continue
        node = dict(tree[part])
        if part in depth:
            stacked = node["layers"]
            n_layers = len(np.asarray(stacked[first_norm[part]]["scale"]))
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


def lora_from_jax(tree, n_layers: int) -> dict:
    """The JAX package's adapter tree (`train/lora.init_lora`: the params'
    nesting, None off the targets, {"a": [L, in, r], "b": [L, r, out]} at
    each target kernel; numpy or JAX arrays) -> the port's per-layer tree
    {"layers": [{group: {name: {"a", "b"}}}]} of CPU tensors, dtypes
    kept."""
    from tokenpacker_tpu_torch.train.lora import TARGETS

    layers = [{} for _ in range(n_layers)]
    stacked = (tree.get("lm") or {}).get("layers") or {}
    found = []
    for group, sub in stacked.items():
        for name, mod in (sub or {}).items():
            ab = mod.get("kernel") if isinstance(mod, dict) else None
            if isinstance(ab, dict) and "a" in ab:
                found.append((TARGETS.index(name), group, name, ab))
    for _, group, name, ab in sorted(found, key=lambda x: x[0]):  # `init_lora`'s order
        a, b = to_tensors(ab["a"]), to_tensors(ab["b"])
        for i in range(n_layers):
            layers[i].setdefault(group, {})[name] = {"a": a[i].clone(), "b": b[i].clone()}
    return {"layers": layers}


def lora_to_jax(lora) -> dict:
    """Inverse of `lora_from_jax`, the parts off the targets left out:
    {"lm": {"layers": {group: {name: {"kernel": {"a", "b"}}}}}} of numpy
    arrays stacked over the layers (fp32 for bf16 tensors, as
    `params_to_jax`)."""
    layers = lora["layers"]
    out: dict = {}
    for group, sub in layers[0].items():
        for name in sub:
            out.setdefault(group, {})[name] = {"kernel": {
                part: np.stack([params_to_jax(layer[group][name][part]) for layer in layers])
                for part in ("a", "b")}}
    return {"lm": {"layers": out}}


def paged_from_jax(paged):
    """The JAX package's `PagedKV` (or its fields in order: k_pages,
    v_pages, page_table, lengths[, k_scales, v_scales]) -> the port's
    `ops/paged_kv.PagedKV` on the CPU, same dtypes."""
    from tokenpacker_tpu_torch.ops.paged_kv import PagedKV

    return PagedKV(*(None if x is None else to_tensors(np.asarray(x)) for x in paged))


def paged_to_jax(paged) -> tuple:
    """Inverse of `paged_from_jax`: the pool's fields as numpy arrays in
    the JAX `PagedKV` order (fp32 for a bf16 pool; None for the scales of
    a float pool), so that `PagedKV(*map(jnp.asarray, ...))` rebuilds it."""
    fields = (paged.k_pages, paged.v_pages, paged.page_table, paged.lengths, paged.k_scales,
              paged.v_scales)
    return tuple(params_to_jax(x) for x in fields)


def params_to(params, device: torch.device | str, dtype: torch.dtype):
    """A copy of the parameters on `device`, floating-point tensors cast to
    `dtype`, except inside quantized kernels: the int8 and uint8 codes and
    their f32 scales keep their dtypes."""
    if is_qleaf(params) or is_q4leaf(params):
        return {k: v.to(device) for k, v in params.items()}
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    if params is None:
        return None
    return params.to(device=device, dtype=dtype if params.is_floating_point() else None)


def _quantize_lm(params, quantize, min_size: int):
    """`quantize(tree, min_size)` over the LM, in place, layer by layer (the
    layer threshold is min_size over the layer count, as the JAX package
    counts its stacked leaves), so on the card the bf16 and the quantized
    LM never coexist whole (once the caller holds no other reference to
    the bf16 layers). A llama LM has its q/k/v and gate/up fused first; an
    MPT LM is quantized as it is (its `wqkv` is fused already, and its tied
    `wte` is no kernel, so it stays dense), as the JAX `api.py` does.
    Returns `params`."""
    lm = params["lm"]
    fuse = "wte" not in lm
    layers = lm["layers"]
    per_layer = -(-min_size // max(len(layers), 1))
    for i, layer in enumerate(layers):
        tree = {"layers": [layer]}
        layers[i] = quantize(fuse_llama_layers(tree) if fuse else tree, per_layer)["layers"][0]
    lm.update(quantize({k: v for k, v in lm.items() if k != "layers"}, min_size))
    return params


def quantize_lm_int8(params, min_size: int = 1 << 16):
    """The `load_8bit` serving form of the LM, in place: every kernel of at
    least `min_size` elements (counted over all layers) becomes int8
    {q, scale} (`_quantize_lm`). Returns `params`."""
    return _quantize_lm(params, quantize_tree, min_size)


def quantize_lm_4bit(params, quant_type: str = "nf4", min_size: int = 1 << 16):
    """The `load_4bit` serving form of the LM (the JAX `api.py` slot), in
    place: every kernel of at least `min_size` elements (counted over all
    layers) whose in dim divides by 64 becomes a 4-bit leaf (nf4 or int4,
    blocks of 64; `_quantize_lm`). Returns `params`."""
    return _quantize_lm(params, lambda tree, size: quantize_tree_4bit(tree, quant_type,
                                                                      min_size=size), min_size)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _normal_fn(gen: torch.Generator, dtype):
    device = gen.device

    def normal(*shape, std=0.02, mean=0.0):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std).add_(mean).to(dtype)

    return normal


def _init_lm(lc, normal, gen, dtype):
    def scale(n):
        return normal(n, std=0.1, mean=1.0)

    if lc.model_family == "mpt":
        lm = init_mpt(lc, gen, dtype)
        for norm in [layer[k] for layer in lm["layers"] for k in ("norm_1", "norm_2")] + [
                lm["norm_f"]]:
            norm.update(scale=scale(lc.hidden_size), bias=normal(lc.hidden_size))
        return lm

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
    gen = _generator(seed, device)
    return _init_lm(lm_cfg, _normal_fn(gen, dtype), gen, dtype)


def _init_tower(vc, normal) -> dict:
    def scale(n):
        return normal(n, std=0.1, mean=1.0)

    def lin(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def ln(n):
        return {"scale": scale(n), "bias": normal(n)}

    w = vc.hidden_size
    return {
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


def init_tower_on_device(vision_cfg, seed: int = 0, device: torch.device | str = "cuda",
                         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tower part of `init_vlm_on_device` alone, from its own seed (the
    same values as the tower of `init_vlm_on_device(cfg, seed)`)."""
    return _init_tower(vision_cfg, _normal_fn(_generator(seed, device), dtype))


def init_vlm_on_device(cfg: TokenPackerVLMConfig, seed: int = 0,
                       device: torch.device | str = "cuda",
                       dtype: torch.dtype = torch.bfloat16):
    """Random weights with the shapes of the JAX `init_vlm`, made directly on
    `device` from a `torch.Generator` seeded with `seed` (no host copy of
    the model is built). Linear kernels, embeddings and biases are
    N(0, 0.02^2); norm scales are 1 + N(0, 0.1^2). Unlike the JAX init
    (biases 0, scales 1), every bias and scale differs, so a parity check
    on these weights also sees a norm or bias that is dropped or swapped.
    An MPT LM is `models/mpt.init_mpt`'s (no biases) with its norms drawn
    as above."""
    gen = _generator(seed, device)
    normal = _normal_fn(gen, dtype)

    def scale(n):
        return normal(n, std=0.1, mean=1.0)

    def lin(i, o, bias=True):
        p = {"kernel": normal(i, o)}
        if bias:
            p["bias"] = normal(o)
        return p

    def ln(n):
        return {"scale": scale(n), "bias": normal(n)}

    vision = _init_tower(cfg.vision, normal)
    pc = cfg.projector
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
    return {"vision": vision, "projector": projector, "lm": _init_lm(cfg.lm, normal, gen, dtype)}
