"""Parameter sharding rules for the TokenPacker VLM (counterpart of
`tokenpacker_tpu/parallel/sharding.py`).

The rules are the JAX package's, leaf for leaf (`_spec_for`; kernels are
[in, out]):
- column-parallel (q/k/v/qkv/wqkv, gate/up/gateup): out over 'model', in
  over 'data';
- row-parallel (o/out, down): in over 'model', out over 'data';
- `embed` / `wte` and `lm_head`: (data, model);
- norms, biases and quantized `scale` / `absmax`: replicated (a
  quantized lm_head's `scale` takes lm_head's rule, as in JAX);
- tower and projector kernels: the largest dim over 'data';
- an axis that does not divide falls back to replication (`_fits`).
The port's layers are a list, so JAX's leading L axis (`off`) is gone.

`shard_params(params, mesh, cfg)` keeps each rank's local shard of every
leaf and tags it with its `Placement`. What XLA does with a
NamedSharding the port does explicitly:
- over 'data' a leaf is ZeRO-3-sharded: `gathered` all-gathers it where
  it is used (a layer at a time), and its gradient is reduce-scattered;
- over 'model' a block whose heads and widths divide the axis runs
  tensor-parallel on its local slice (`local_config` gives the local
  head and width counts, the layers all-reduce after the row-parallel
  products). Its fused `qkv` / `gateup` (and MPT's `wqkv`) leaves are
  split by part, q, k and v (gate and up) each by its own columns, since
  a contiguous split would hand rank 0 all of q and half of k; a
  column-parallel int8 `scale` or 4-bit `absmax` is sliced with its
  columns where it is used, a row-parallel 4-bit `absmax` with its
  blocks of rows (the shard must start on a block edge);
- a block whose heads or widths do not divide the axis (or a 4-bit
  row-parallel leaf whose shard would split a block) runs replicated:
  its leaves are gathered over 'model' too, and no all-reduce runs;
- the embedding's features and the vocab-parallel logits are gathered
  over 'model' after the lookup and the head.

The presets are reckoned for one H100 80GB (not the v5e's 16 GiB):
`PARALLEL_PRESETS`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.ops.quantize import is_q4leaf, is_qleaf, q4_meta
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    P,
    make_mesh,
    world_size,
)

COLUMN_ROLES = ("q", "k", "v", "qkv", "wqkv")
ROW_ROLES = ("o", "out")


def _fits(dim: int, mesh: Mesh, axis: str | None) -> bool:
    if axis is None:
        return True
    return dim % mesh.shape[axis] == 0


def _spec_for(names: list, shape: tuple, mesh: Mesh) -> tuple:
    """The placement spec of the leaf at path `names` (keys, list indices
    as strings) with `shape`: JAX's rules without the layer axis."""
    joined = "/".join(names)
    ndim = len(shape)

    def spec(*axes):
        full = list(axes) + [None] * (ndim - len(axes))
        return P(*[a if _fits(shape[i], mesh, a) else None for i, a in enumerate(full)])

    if joined.startswith("lm/"):
        if joined.endswith("embed") or joined.endswith("wte"):
            return spec(DATA_AXIS, MODEL_AXIS)
        if "lm_head" in names:
            return spec(DATA_AXIS, MODEL_AXIS)
        if "kernel" in names and ndim >= 2:
            ki = names.index("kernel")
            role = names[ki - 1]
            sub = names[ki + 1] if ki + 1 < len(names) else None
            if sub in ("scale", "absmax"):
                return P()
            if "attn" in names and role in COLUMN_ROLES:
                return spec(DATA_AXIS, MODEL_AXIS)
            if "attn" in names and role in ROW_ROLES:
                return spec(MODEL_AXIS, DATA_AXIS)
            if ("mlp" in names or "ffn" in names) and role in ("gate", "up", "gateup"):
                return spec(DATA_AXIS, MODEL_AXIS)
            if ("mlp" in names or "ffn" in names) and role == "down":
                return spec(MODEL_AXIS, DATA_AXIS)
        return P()
    if "kernel" in names and ndim >= 2:
        big = int(np.argmax(shape))
        axes = [None] * ndim
        if _fits(shape[big], mesh, DATA_AXIS):
            axes[big] = DATA_AXIS
        return P(*axes)
    return P()


def _walk(node, path=()):
    """(path of strings, leaf) for every tensor of a params tree."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, path + (str(i),))
    elif isinstance(node, torch.Tensor):
        yield path, node


def _map(node, fn, path=()):
    if isinstance(node, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(node)]
    if isinstance(node, torch.Tensor):
        return fn(list(path), node)
    return node


def vlm_param_shardings(params, mesh: Mesh):
    """The tree of placement specs matching `params`' structure."""
    return _map(params, lambda names, leaf: _spec_for(names, tuple(leaf.shape), mesh))


def batch_shardings(batch_spec: dict, mesh: Mesh) -> dict:
    """Every batch array's leading axis over 'data' (None stays replicated)."""
    return {k: (P(DATA_AXIS) if v is not None else P()) for k, v in batch_spec.items()}


# -- placements ---------------------------------------------------------------


@dataclass(eq=False)
class Placement:
    """How a rank holds a leaf: the JAX rule's `spec`, the `full` shape,
    and `keep`, the dimension that stays split over 'model' where it is
    used (a tensor-parallel block's leaf, the vocab-parallel head, the
    embedding's features), None when every split dimension is gathered on
    use. `parts`: the part widths of a fused leaf split by part along
    `keep`."""

    mesh: Mesh
    spec: tuple
    full: tuple
    keep: int | None = None
    parts: tuple | None = None

    def axes(self) -> set:
        return {a for a in self.spec if a is not None}

    def local_index(self, dim: int) -> torch.Tensor:
        """The full-width indices along `dim` that this rank holds."""
        axis = self.mesh.axis(self.spec[dim])
        widths = self.parts or (self.full[dim],)
        idx, start = [], 0
        for w in widths:
            n = w // axis.size
            idx.append(torch.arange(start + axis.index * n, start + (axis.index + 1) * n))
            start += w
        return torch.cat(idx)


def placement(t: torch.Tensor) -> Placement | None:
    return getattr(t, "_placement", None)


def _local(full: torch.Tensor, pl: Placement) -> torch.Tensor:
    out = full
    for d, a in enumerate(pl.spec):
        if a is None:
            continue
        if d == pl.keep and pl.parts:
            out = out.index_select(d, pl.local_index(d).to(out.device))
        else:
            axis = pl.mesh.axis(a)
            out = out.chunk(axis.size, dim=d)[axis.index]
    return out.contiguous()


def _layer_plan(lm_cfg: LMConfig, layer: dict, mesh: Mesh) -> dict:
    """Which blocks of a decoder layer run tensor-parallel: {"attn": parts
    or None, "mlp": parts or None}, where parts are the fused leaf's part
    widths (None for a replicated block)."""
    tp = mesh.shape[MODEL_AXIS]
    out = {"attn": None, "mlp": None}
    if tp == 1:
        return out
    hd = lm_cfg.hidden_size // lm_cfg.num_attention_heads
    h, kv = lm_cfg.num_attention_heads, lm_cfg.kv_heads

    def row_ok(leaf, width):
        if width % tp:
            return False
        if isinstance(leaf, dict) and is_q4leaf(leaf):
            return (width // tp) % q4_meta(leaf)[1] == 0
        return True

    attn = layer.get("attn", {})
    o = attn.get("o", attn.get("out"))
    if h % tp == 0 and kv % tp == 0 and o is not None and row_ok(o["kernel"], h * hd):
        out["attn"] = (h * hd, kv * hd, kv * hd)
    mlp = layer.get("mlp", layer.get("ffn", {}))
    down = mlp.get("down")
    if down is not None:
        f = _dense_shape(down["kernel"])[0]
        if f % tp == 0 and row_ok(down["kernel"], f):
            out["mlp"] = (f, f)
    return out


def _dense_shape(leaf) -> tuple:
    """The [in, out] shape of a dense or quantized kernel."""
    if isinstance(leaf, dict):
        if is_qleaf(leaf):
            return tuple(leaf["q"].shape)
        if is_q4leaf(leaf):
            key = next(k for k in leaf if k.startswith("q4:"))
            return (leaf[key].shape[0] * 2, leaf[key].shape[1])
    return tuple(leaf.shape)


def shard_params(params, mesh: Mesh, cfg=None):
    """Each rank's local shard of the port's params tree, every leaf tagged
    with its `Placement` (module docstring). `cfg` (TokenPackerVLMConfig or
    LMConfig) gives the heads for the tensor-parallel blocks; without it
    every block runs replicated. The input tree is not changed."""
    lm_cfg = getattr(cfg, "lm", cfg)
    plans = {}
    lm = params.get("lm", {})
    if lm_cfg is not None:
        for i, layer in enumerate(lm.get("layers", [])):
            plans[str(i)] = _layer_plan(lm_cfg, layer, mesh)

    def place(names, leaf):
        spec = _spec_for(names, tuple(leaf.shape), mesh)
        keep, parts = None, None
        if names[0] == "lm" and MODEL_AXIS in spec:
            dim = spec.index(MODEL_AXIS)
            if "layers" in names:
                plan = plans.get(names[names.index("layers") + 1], {})
                block = plan.get("attn" if "attn" in names else "mlp")
                if block is not None:
                    keep = dim
                    role = names[names.index("kernel") - 1]
                    if role in ("qkv", "wqkv", "gateup") and dim == len(spec) - 1:
                        parts = block
            else:
                keep = dim  # vocab-parallel head, embedding features
        pl = Placement(mesh, spec, tuple(leaf.shape), keep, parts)
        if mesh.size == 1 or not pl.axes():
            return leaf
        local = _local(leaf, pl)
        local._placement = pl
        return local

    return _map(params, place)


# -- on use -------------------------------------------------------------------


def gathered_leaf(t: torch.Tensor, full: bool = False) -> torch.Tensor:
    """The leaf with its 'data' dims (and 'model' dims outside a
    tensor-parallel block; all of them with `full`) all-gathered, under
    autograd: over 'data' the gradient is reduce-scattered, over 'model'
    sliced (every rank of a replicated block computes it alike)."""
    pl = placement(t)
    if pl is None:
        return t
    out = t
    for d, a in enumerate(pl.spec):
        if a is None or (d == pl.keep and not full):
            continue
        out = comm.gather(out, d, pl.mesh.axis(a), "sum" if a == DATA_AXIS else "slice")
        if d == pl.keep and pl.parts:
            out = _unsplit_parts(out, d, pl)
    return out


def _unsplit_parts(x: torch.Tensor, dim: int, pl: Placement) -> torch.Tensor:
    """Rank-major [part0_r0 part1_r0 .. | part0_r1 ..] back to part-major."""
    n = pl.mesh.axis(MODEL_AXIS).size
    local = [w // n for w in pl.parts]
    chunks = [c.split(local, dim=dim) for c in x.chunk(n, dim=dim)]
    return torch.cat([torch.cat([c[p] for c in chunks], dim=dim)
                      for p in range(len(pl.parts))], dim=dim)


def _gathered_quant(leaf: dict) -> dict:
    """A quantized kernel leaf on use: the payload gathered as its
    placement says, the replicated scale / absmax sliced to the payload's
    tensor-parallel columns (or 4-bit blocks of rows)."""
    key = "q" if "q" in leaf else next(k for k in leaf if k.startswith("q4:"))
    payload = leaf[key]
    pl = placement(payload)
    out = {k: gathered_leaf(v) if isinstance(v, torch.Tensor) else v for k, v in leaf.items()}
    if pl is None or pl.keep is None:
        return out
    comp = "scale" if key == "q" else "absmax"
    c = out[comp]
    if placement(leaf[comp]) is not None:
        return out  # a quantized lm_head's scale follows lm_head's rule
    if key == "q" and pl.keep != len(pl.spec) - 1:
        return out  # a row-parallel int8 leaf's scale is per output column: whole
    idx = pl.local_index(pl.keep).to(c.device)
    if pl.keep == len(pl.spec) - 1:
        out[comp] = c.index_select(-1, idx)
    else:  # a row-parallel 4-bit leaf: its blocks of rows
        block = q4_meta(leaf)[1]
        rows = idx[::block // 2] // (block // 2)
        out[comp] = c.index_select(0, rows)
    return out


def gathered(node):
    """A params subtree with every tagged leaf as `gathered_leaf` gives it
    (quantized leaves with their scales sliced); untagged leaves and other
    keys pass through. A no-op on a tree `shard_params` never saw."""
    if isinstance(node, dict):
        if is_qleaf(node) or is_q4leaf(node):
            return _gathered_quant(node)
        return {k: gathered(v) for k, v in node.items()}
    if isinstance(node, list):
        return [gathered(v) for v in node]
    if isinstance(node, torch.Tensor):
        return gathered_leaf(node)
    return node


def gather_features(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The last dim of x gathered over 'model' where `table` (the embedding
    or the head) keeps its last dim split: the embedding's features and
    the vocab-parallel logits."""
    axis = head_axis(table)
    return x if axis is None else comm.gather(x, x.dim() - 1, axis, "slice")


def head_axis(table: torch.Tensor):
    """The 'model' axis a vocab-parallel head (or an embedding whose
    features stay split) keeps its last dim over, else None."""
    pl = placement(table)
    if pl is None or pl.keep != len(pl.spec) - 1:
        return None
    return pl.mesh.axis(MODEL_AXIS)


def kernel_placement(leaf: dict) -> Placement | None:
    """The placement of a linear leaf's kernel (a quantized kernel's
    payload)."""
    k = leaf["kernel"]
    if isinstance(k, dict):
        k = k["q" if "q" in k else next(x for x in k if x.startswith("q4:"))]
    return placement(k)


def _first_kernel_placement(block: dict, roles) -> Placement | None:
    for role in roles:
        if block.get(role) is not None:
            return kernel_placement(block[role])
    return None


def local_slot_lora(leaf: dict, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """A slot-LoRA stack of the target `leaf` (`serve/multi_lora.SlotLora`:
    a [n, in, r], b [n, r, out] at the model's widths) cut to what this
    rank holds, as `_gathered_quant` cuts an int8 `scale` with its columns.
    A column-parallel target keeps b's columns of the kernel's own
    (`Placement.local_index`: a fused qkv or gateup part by part); a
    row-parallel one keeps a's rows of the kernel's rows, so each rank's
    term is a partial sum that `row_linear`'s reduction over 'model' adds
    up with the base product. A replicated block (or an unsharded leaf)
    keeps the whole stack."""
    pl = kernel_placement(leaf)
    if pl is None or pl.keep is None:
        return a, b
    if pl.keep == len(pl.spec) - 1:
        return a, b.index_select(-1, pl.local_index(pl.keep).to(b.device))
    axis = pl.mesh.axis(MODEL_AXIS)
    return a.chunk(axis.size, dim=1)[axis.index].contiguous(), b


@dataclass(frozen=True)
class LocalLMConfig(LMConfig):
    """The LM config one rank runs: head counts and the MLP width of its
    tensor-parallel blocks, the 'model' axes the layers all-reduce over
    (None for a replicated block), the model's own head count (head_dim
    and ALiBi's slopes read it) and this rank's first head."""

    full_heads: int = 0
    head_offset: int = 0
    attn_axis: object = None
    mlp_axis: object = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.full_heads


def local_lm_config(lm_cfg: LMConfig, lm_params) -> LMConfig:
    """`lm_cfg` as this rank runs `lm_params`: unchanged for a tree with no
    tensor-parallel block; idempotent."""
    if isinstance(lm_cfg, LocalLMConfig) or not lm_params.get("layers"):
        return lm_cfg
    layer = lm_params["layers"][0]
    pa = _first_kernel_placement(layer.get("attn", {}), ("q", "qkv", "wqkv"))
    pm = _first_kernel_placement(layer.get("mlp", layer.get("ffn", {})), ("gate", "gateup", "up"))
    pa = pa if pa is not None and pa.keep is not None else None
    pm = pm if pm is not None and pm.keep is not None else None
    if pa is None and pm is None:
        return lm_cfg
    fields = {f.name: getattr(lm_cfg, f.name) for f in dataclasses.fields(LMConfig)}
    fields["full_heads"] = lm_cfg.num_attention_heads
    if pa is not None:
        ax = pa.mesh.axis(MODEL_AXIS)
        fields["num_attention_heads"] = lm_cfg.num_attention_heads // ax.size
        fields["num_key_value_heads"] = lm_cfg.kv_heads // ax.size
        fields["head_offset"] = ax.index * fields["num_attention_heads"]
        fields["attn_axis"] = ax
    if pm is not None:
        ax = pm.mesh.axis(MODEL_AXIS)
        fields["intermediate_size"] = lm_cfg.intermediate_size // ax.size
        fields["mlp_axis"] = ax
    return LocalLMConfig(**fields)


def local_config(cfg, params):
    """A TokenPackerVLMConfig with its LM as `local_lm_config` gives it."""
    lm = local_lm_config(cfg.lm, params["lm"])
    return cfg if lm is cfg.lm else dataclasses.replace(cfg, lm=lm)


def mesh_of(params) -> Mesh | None:
    """The mesh a sharded tree lives on (None for a tree `shard_params`
    never saw)."""
    for _, leaf in _walk(params):
        pl = placement(leaf)
        if pl is not None:
            return pl.mesh
    return None


# -- whole trees ----------------------------------------------------------------


def unshard_leaf(t: torch.Tensor, pl: Placement | None = None) -> torch.Tensor:
    """The whole leaf from its shards (every rank gets it; no autograd)."""
    pl = pl or placement(t)
    if pl is None:
        return t.detach()
    out = t.detach()
    for d, a in enumerate(pl.spec):
        if a is None:
            continue
        out = comm.all_gather(out, d, pl.mesh.axis(a))
        if d == pl.keep and pl.parts:
            out = _unsplit_parts(out, d, pl)
    return out


def unshard_params(params):
    """The whole tree from a sharded one (plain tensors, no tags)."""
    return _map(params, lambda names, leaf: unshard_leaf(leaf))


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of `full`, placed as the shard `like` is."""
    pl = placement(like)
    return full if pl is None else _local(full, pl)


# -- deployment presets ------------------------------------------------------------

# One H100 80GB HBM3 (79.2 GiB as torch reports it). `preset_footprint`
# reckons each preset's weights and the bf16 KV of 16 requests of 2,048
# positions (an HD prompt of 9 crops and the global view is ~1,500): the
# largest, 13B HD bf16, holds ~50 GiB. Every preset fits one card at
# tp = 1 (the v5e's 16 GiB forced tp = 2-4), so tp > 1 buys throughput or
# longer batches, never fit.
CARD_GIB = 79.2
PARALLEL_PRESETS: dict[str, dict] = {
    "7b-bf16": dict(tp=1),
    "7b-hd-bf16": dict(tp=1),
    "7b-int8": dict(tp=1),
    "7b-int4": dict(tp=1),
    "13b-bf16": dict(tp=1),
    "13b-int8": dict(tp=1),
    "13b-int4": dict(tp=1),
    "13b-hd-bf16": dict(tp=1),
}


def preset_footprint(preset: str, slots: int = 16, positions: int = 2048) -> dict:
    """GiB of a preset's weights (the LM's kernels at the preset's bits with
    their scales or absmax, everything else bf16; counted on the shapes of
    `io/weights.init_vlm_on_device`, meta tensors, no memory) and of the bf16
    KV of `slots` requests of `positions`."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig, vicuna_13b
    from tokenpacker_tpu_torch.io import weights

    cfg = TokenPackerVLMConfig(lm=vicuna_13b()) if preset.startswith("13b") else \
        TokenPackerVLMConfig()
    bits = {"bf16": 16, "int8": 8, "int4": 4}[preset.rsplit("-", 1)[1]]

    def normal(*shape, std=0.02, mean=0.0):
        return torch.empty(shape, device="meta")

    lm = weights._init_lm(cfg.lm, normal, None, torch.bfloat16)
    total = 0.0
    for names, leaf in _walk({"vision": weights._init_tower(cfg.vision, normal), "lm": lm}):
        n = leaf.numel()
        if names[0] == "lm" and names[-1] == "kernel" and bits < 16:
            total += n * bits / 8 + (leaf.shape[-1] * 4 if bits == 8 else n / 64 * 4)
        else:
            total += 2 * n
    pc = cfg.projector
    total += 2 * (pc.kv_dim * pc.embed_dim + 2 * (pc.kv_input_dim + pc.embed_dim) * pc.embed_dim
                  + 4 * pc.embed_dim ** 2 + pc.embed_dim * pc.hidden_size + pc.hidden_size ** 2)
    kv = 2 * cfg.lm.num_hidden_layers * cfg.lm.kv_heads * cfg.lm.head_dim * 2 * positions * slots
    return {"weights_gib": total / 2**30, "kv_gib": kv / 2**30, "total_gib": (total + kv) / 2**30}


def recommended_mesh(preset: str, device=None, backend: str | None = None) -> Mesh:
    """The preset's ('data', 'model') mesh over the world."""
    if preset not in PARALLEL_PRESETS:
        raise KeyError(f"unknown preset {preset!r}; known: {sorted(PARALLEL_PRESETS)}")
    tp = PARALLEL_PRESETS[preset]["tp"]
    n = world_size()
    if n % tp:
        raise ValueError(f"{n} devices not divisible by preset tp={tp}")
    return make_mesh(dp=n // tp, tp=tp, device=device, backend=backend)


# -- gradients -------------------------------------------------------------------


def sync_grads(grads, leaves, mesh: Mesh | None):
    """Gradients of the trained `leaves` made whole for their shards: a
    leaf that is replicated over 'data' has its gradient all-reduced over
    it (a 'data'-sharded leaf's came reduce-scattered out of its gather).
    Nothing runs over 'model': its ranks compute replicated values alike."""
    if mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1:
        return list(grads)
    axis = mesh.axis(DATA_AXIS)
    out = []
    for g, leaf in zip(grads, leaves):
        pl = placement(leaf)
        out.append(g if pl is not None and DATA_AXIS in pl.axes() else comm.all_reduce(g, axis))
    return out


def global_norm(grads, leaves, mesh: Mesh | None = None) -> torch.Tensor:
    """The L2 norm of the whole gradients of sharded `leaves` (fp32): each
    leaf's squares summed over the axes it is split on, so a leaf
    replicated over an axis counts once."""
    sums: dict = {}
    for g, leaf in zip(grads, leaves):
        pl = placement(leaf) if mesh is not None else None
        key = tuple(sorted(pl.axes())) if pl is not None else ()
        sq = g.float().square().sum()
        sums[key] = sums[key] + sq if key in sums else sq
    total = None
    for key, sq in sums.items():
        if key:
            sq = comm.all_reduce(sq, mesh.axis(key[0]) if len(key) == 1 else mesh.world_axis)
        total = sq if total is None else total + sq
    return torch.sqrt(total)
