"""A configuration file as the program's config, and its weights from the seed.

The weights are the benchmark's input, handed alike to the program and to
the plain reference: made on the device from one `torch.Generator`, in the
type they are served in, in a few large calls (one flat buffer per kind of
leaf, filled in chunks), and laid out as the program's parameter tree.
Linear kernels are N(0, 0.02^2), biases N(0, 0.02^2), LayerNorm scales
1 + N(0, 0.1^2); MPT-7B's LayerNorms have no bias (`no_bias`), so theirs
are zero.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
CHUNK = 1 << 30  # elements filled per generator call


def dtype_of(conf: dict) -> torch.dtype:
    return DTYPES[conf["dtype"]]


def program_config(conf: dict):
    """The program's `TokenPackerVLMConfig` for a configuration file."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig, VisionConfig
    from tokenpacker_tpu_torch.models.mpt import mpt_config

    lm = conf["lm"]
    if lm["family"] != "mpt":
        raise NotImplementedError(f"LM family {lm['family']!r}: this harness knows mpt")
    v = conf["vision"]
    vision = VisionConfig(hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                          num_hidden_layers=v["num_hidden_layers"],
                          num_attention_heads=v["num_attention_heads"],
                          image_size=v["image_size"], patch_size=v["patch_size"],
                          layer_norm_eps=v["layer_norm_eps"], select_layer=v["select_layer"],
                          multi_layers=tuple(v["multi_layers"]))
    cfg = TokenPackerVLMConfig(
        vision=vision,
        lm=mpt_config(d_model=lm["d_model"], n_heads=lm["n_heads"], n_layers=lm["n_layers"],
                      expansion_ratio=lm["expansion_ratio"], vocab_size=lm["vocab_size"],
                      max_seq_len=lm["max_seq_len"]),
        scale_factor=conf["projector"]["scale_factor"], patch_num=conf["patch_num"],
        image_aspect_ratio=conf["image_aspect_ratio"], dtype=dtype_of(conf))
    pc = cfg.projector
    p = conf["projector"]
    if (pc.num_heads, pc.embed_dim, pc.ln_eps) != (p["num_heads"], p["embed_dim"], p["ln_eps"]):
        raise ValueError(f"the program's projector ({pc}) is not the configuration's ({p})")
    if cfg.lm.eos_token_id != lm["eos_token_id"]:
        raise ValueError("the program's MPT EOS id differs from the configuration's")
    return cfg


def _specs(conf: dict) -> dict:
    """The parameter tree as (shape, kind) leaves, in the program's layout:
    kernels [in, out]."""
    v, lm, p = conf["vision"], conf["lm"], conf["projector"]
    w = v["hidden_size"]

    def lin(i, o, bias=True):
        out = {"kernel": ((i, o), "w")}
        if bias:
            out["bias"] = ((o,), "bias")
        return out

    def ln(n, bias="bias"):
        return {"scale": ((n,), "scale"), "bias": ((n,), bias)}

    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    vision = {
        "class_embedding": ((w,), "w"),
        "patch_embed": {"kernel": ((3 * v["patch_size"] ** 2, w), "w")},
        "pos_embed": ((seq, w), "w"),
        "pre_ln": ln(w), "post_ln": ln(w),
        "layers": [{"ln1": ln(w), "attn": {n: lin(w, w) for n in ("q", "k", "v", "o")},
                    "ln2": ln(w), "mlp": {"fc1": lin(w, v["intermediate_size"]),
                                          "fc2": lin(v["intermediate_size"], w)}}
                   for _ in range(v["num_hidden_layers"])],
    }
    e, d = p["embed_dim"], lm["d_model"]
    kv_in = w * len(v["multi_layers"])
    projector = {
        "q_proj": lin(w, e, bias=False),
        "k_proj": {"fc1": lin(kv_in, e), "fc2": lin(e, e)},
        "v_proj": {"fc1": lin(kv_in, e), "fc2": lin(e, e)},
        "ln_q": ln(e), "ln_k": ln(e), "ln_v": ln(e),
        "attn": {n: lin(e, e) for n in ("q", "k", "v", "o")},
        "mlp": {"fc1": lin(e, d), "fc2": lin(d, d)},
    }
    f = lm["expansion_ratio"] * d
    norm_bias = "zero" if lm["no_bias"] else "bias"
    lmt = {
        "wte": ((lm["vocab_size"], d), "w"),
        "layers": [{"norm_1": ln(d, norm_bias),
                    "attn": {"wqkv": {"kernel": ((d, 3 * d), "w")}, "out": {"kernel": ((d, d), "w")}},
                    "norm_2": ln(d, norm_bias),
                    "ffn": {"up": {"kernel": ((d, f), "w")}, "down": {"kernel": ((f, d), "w")}}}
                   for _ in range(lm["n_layers"])],
        "norm_f": ln(d, norm_bias),
    }
    return {"vision": vision, "projector": projector, "lm": lmt}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _place(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


KINDS = {"w": (0.0, 0.02), "bias": (0.0, 0.02), "scale": (1.0, 0.1)}


def make_weights(conf: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The parameter tree of `conf` from `seed`, on `device`. Every leaf of a
    kind is a view into that kind's flat buffer; the projector's leaves
    (the ones a recipe trains) are tensors of their own."""
    dtype = dtype or dtype_of(conf)
    specs = _specs(conf)
    tree = _copy_structure(specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves = list(_leaves(specs))
    for kind in ("w", "bias", "scale", "zero"):
        mine = [(path, shape) for path, (shape, k) in leaves if k == kind]
        total = sum(_numel(s) for _, s in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        if kind == "zero":
            flat.zero_()
        else:
            mean, std = KINDS[kind]
            if kind == "w":
                std = conf["assumed"].get("kernel_std", std)
            for a in range(0, total, CHUNK):
                flat[a:a + CHUNK].normal_(mean, std, generator=gen)
        at = 0
        for path, shape in mine:
            n = _numel(shape)
            leaf = flat[at:at + n].view(shape)
            _place(tree, path, leaf.clone() if path[0] == "projector" else leaf)
            at += n
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None


def leaves(tree):
    """(path, tensor) of every leaf of a parameter tree, in a fixed order."""
    return list(_leaves(tree))
