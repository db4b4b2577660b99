"""The work a request or a step needs, counted from the traffic and the
published widths: floating-point operations (a multiply-add is two) and
bytes. They count what the model needs, not what an implementation
launches: padding, recomputation and layers whose output nobody reads are
not work.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Widths:
    d: int  # LM width
    heads: int
    layers: int
    ffn: int
    vocab: int
    vw: int  # tower width
    vffn: int
    vlayers: int  # tower blocks whose output is read
    vseq: int  # tower positions a view (patches + CLS)
    patch_in: int  # 3 * patch^2
    e: int  # projector width
    kv_in: int  # projector key/value input width (the multi-level concat)
    queries: int  # visual tokens a view
    region: int  # keys a query attends (scale_factor^2)
    kv_bytes: int  # bytes of one cached K or V element

    @classmethod
    def of(cls, conf: dict) -> "Widths":
        lm, v, p = conf["lm"], conf["vision"], conf["projector"]
        grid = v["image_size"] // v["patch_size"]
        sel = v["select_layer"] % (v["num_hidden_layers"] + 1)
        return cls(d=lm["d_model"], heads=lm["n_heads"], layers=lm["n_layers"],
                   ffn=lm["expansion_ratio"] * lm["d_model"], vocab=lm["vocab_size"],
                   vw=v["hidden_size"], vffn=v["intermediate_size"],
                   vlayers=max([sel, *v["multi_layers"]]), vseq=grid * grid + 1,
                   patch_in=3 * v["patch_size"] ** 2, e=p["embed_dim"],
                   kv_in=v["hidden_size"] * len(v["multi_layers"]),
                   queries=(grid // p["scale_factor"]) ** 2, region=p["scale_factor"] ** 2,
                   kv_bytes=2 if conf["kv_cache_dtype"] in ("bfloat16", "float16") else 4)

    @property
    def lm_matmul_params(self) -> int:
        """Weights of the decoder's products, the LM head excluded."""
        d, f = self.d, self.ffn
        return self.layers * (3 * d * d + d * d + 2 * d * f)


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def tower_flops(w: Widths, views: int) -> float:
    """The tower's forward over `views` crops, through the blocks whose
    output the projector reads."""
    t = w.vseq
    per_block = 2 * t * (4 * w.vw * w.vw + 2 * w.vw * w.vffn) + 4 * w.vw * t * t
    patch = 2 * (t - 1) * w.patch_in * w.vw
    return views * (patch + w.vlayers * per_block)


def projector_flops(w: Widths, views: int) -> float:
    """The TokenPacker projector's forward over `views` crops."""
    p = w.queries * w.region  # fine positions
    kv = 2 * (2 * p * (w.kv_in * w.e + w.e * w.e))  # k_proj and v_proj MLPs
    q = 2 * w.queries * w.vw * w.e + 2 * w.queries * w.e * w.e  # q_proj, attention's q
    attn = 2 * 2 * p * w.e * w.e + 4 * w.queries * w.region * w.e + 2 * w.queries * w.e * w.e
    mlp = 2 * w.queries * (w.e * w.d + w.d * w.d)
    return views * (kv + q + attn + mlp)


def prefill_flops(w: Widths, t: int, logits: int = 1) -> float:
    """The decoder's causal forward over t positions, the head at `logits`
    of them."""
    return (2 * w.lm_matmul_params * t + w.layers * 4 * w.d * causal_pairs(t)
            + 2 * w.d * w.vocab * logits)


def decode_flops(w: Widths, keys: int) -> float:
    """One token's step over a cache of `keys` positions (its own included)."""
    return 2 * w.lm_matmul_params + w.layers * 4 * w.d * keys + 2 * w.d * w.vocab


def train_lm_flops(w: Widths, t: int, targets: int) -> float:
    """Stage 1's decoder work for one sequence of t valid positions and
    `targets` predicted tokens: the forward, and the backward for the input
    gradients alone (the LM is frozen; its weights take no gradient). The
    attention backward makes four products to the forward's two."""
    fwd = 2 * w.lm_matmul_params * t + w.layers * 4 * w.d * causal_pairs(t)
    bwd = 2 * w.lm_matmul_params * t + w.layers * 8 * w.d * causal_pairs(t)
    head = 2 * (2 * w.d * w.vocab * targets)
    return fwd + bwd + head


def train_projector_flops(w: Widths, views: int) -> float:
    """The trained projector's forward and backward (input and weight
    gradients: twice the forward)."""
    return 3 * projector_flops(w, views)


def kv_bytes(w: Widths, keys: int) -> float:
    """The K and V bytes one layer's decode attention reads over `keys`
    cached positions."""
    return 2 * keys * w.d * w.kv_bytes


def attention_fwd_work(w: Widths, t: int) -> tuple[float, float]:
    """One layer's causal attention forward over t positions: (operations,
    bytes of q, k, v and o)."""
    return 4 * w.d * causal_pairs(t), 4 * t * w.d * 2
