"""GPipe-style pipeline parallelism for the decoder stack (counterpart of
`tokenpacker_tpu/parallel/pipeline.py`).

A ('data', 'stage') mesh (`make_pp_mesh`) runs dp independent pipelines of
pp stages, one process a rank. Stage s holds the contiguous layers [s L/S,
(s + 1) L/S) (`shard_pp_params`) and runs them on its 'data' row's share
of the batch, split into M microbatches: at tick t it runs microbatch
t - s and passes the activations to stage s + 1 with `comm.ring` (JAX's
`ppermute` ring; its backward is the reverse ring, so autograd runs the
reverse pipeline). M + S - 1 ticks drain the pipe.

JAX runs every tick on every stage in SPMD lockstep and discards the
bubble ticks' results (`tokenpacker_tpu/parallel/pipeline.py:153-161`).
The port's stages are separate processes, so a stage skips the compute
of a bubble tick (it passes zeros on) and still takes part in that tick's
ring exchange, which keeps the stages' exchanges paired. Each tick's
output keeps zero-weighted links to the tick's input and to what the
stage differentiates (its layers and the embeddings), so that on every
rank every exchange is recorded and lies on a path to the requested
gradients: each rank's backward then runs every reverse exchange, in the
same order.

As in JAX the last stage's outputs are summed over the stages so that the
final norm and whatever follows (the head, the loss) run replicated. The
sum's backward is the identity: each stage computes the same loss, and
the last stage's gradient into the stack counts that head once. The
result is the whole batch [B, T, D] on every rank (the 'data' rows
gathered, each taking its own rows' gradient back), so the stack's
layers are replicated over 'data': their gradients are summed over it
(`sync_stage_grads`).

Layers run through the port's `_layer` with K2's causal attention (the
batch must be right-padded, as `build_splice_plan` makes it: the valid
rows are exact) and are checkpointed one by one, as JAX's
`jax.checkpoint` per layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tokenpacker_tpu_torch.config import LMConfig
from tokenpacker_tpu_torch.models.llama import _layer, rope_cos_sin
from tokenpacker_tpu_torch.ops.layers import rms_norm
from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, P, default_device, world_size

STAGE_AXIS = "stage"


def make_pp_mesh(pp: int, dp: int | None = None, device=None, backend: str | None = None) -> Mesh:
    """A ('data', 'stage') mesh over the world: dp pipelines of pp stages,
    with JAX's strictness (dp * pp must be the world)."""
    n = world_size()
    if dp is None:
        if n % pp != 0:
            raise ValueError(f"{n} devices not divisible by pp={pp}")
        dp = n // pp
    if dp * pp != n:
        raise ValueError(f"dp*pp = {dp * pp} != {n} devices")
    return Mesh((DATA_AXIS, STAGE_AXIS), (dp, pp), device or default_device(), backend)


def pp_param_shardings(params, mesh: Mesh) -> dict:
    """The layers split over 'stage', everything else replicated (the
    embedding, norm and head are small beside the stack)."""
    return {k: ([P(STAGE_AXIS)] * len(v) if k == "layers" else P()) for k, v in params.items()}


def shard_pp_params(params, mesh: Mesh) -> dict:
    """This stage's contiguous block of layers; the rest as it is."""
    s, n = mesh.coords[STAGE_AXIS], mesh.shape[STAGE_AXIS]
    n_layers = len(params["layers"])
    if n_layers % n:
        raise ValueError(f"{n_layers} layers not divisible by {n} stages")
    per = n_layers // n
    return {**params, "layers": params["layers"][s * per:(s + 1) * per]}


def _leaves(node) -> list:
    if isinstance(node, dict):
        return [t for v in node.values() for t in _leaves(v)]
    if isinstance(node, list):
        return [t for v in node for t in _leaves(v)]
    return [node] if isinstance(node, torch.Tensor) else []


def _stage(layers, cfg: LMConfig, x, cos, sin):
    for p in layers:
        x = checkpoint(_layer, p, cfg, x, cos, sin, None, 0, use_reentrant=False)
    return x


def pipeline_llama_hidden(params, cfg: LMConfig, inputs_embeds: torch.Tensor,
                          positions: torch.Tensor, key_valid: torch.Tensor, mesh: Mesh,
                          num_microbatches: int) -> torch.Tensor:
    """The decoder stack (training path, no cache) pipelined over 'stage'
    and batch-parallel over 'data'. params: this stage's tree
    (`shard_pp_params`); inputs_embeds [B, T, D], positions and key_valid
    [B, T], the whole batch on every rank. Equivalent to `llama_apply`
    without a cache; returns the final-norm hidden states [B, T, D]."""
    stage = mesh.axis(STAGE_AXIS)
    data = mesh.axis(DATA_AXIS)
    n_stages, s, m = stage.size, stage.index, num_microbatches
    b = inputs_embeds.shape[0]
    if b % (data.size * m):
        raise ValueError(f"batch {b} not divisible by dp*microbatches {data.size * m}")
    rows = b // data.size
    mine = slice(data.index * rows, (data.index + 1) * rows)
    x = inputs_embeds[mine]
    cos, sin = (c.to(x.dtype) for c in
                rope_cos_sin(positions[mine], cfg.head_dim, cfg.rope_theta))
    x_mb, cos_mb, sin_mb = (a.reshape((m, rows // m) + a.shape[1:]) for a in (x, cos, sin))

    ticks = m + n_stages - 1
    state = torch.zeros_like(x_mb[0])
    tied = [t for t in _leaves(params["layers"]) + [inputs_embeds]
            if t.requires_grad and t.is_floating_point()]
    anchor = sum(0 * t.reshape(-1)[0] for t in tied) if tied else 0
    outputs = []
    for t in range(ticks):
        mb = t - s
        inp = x_mb[mb] + 0 * state if s == 0 and mb < m else state
        if 0 <= mb < m:
            out = _stage(params["layers"], cfg, inp, cos_mb[mb], sin_mb[mb]) + anchor
            if s == n_stages - 1:
                outputs.append(out)
        else:
            out = 0 * inp + anchor  # a bubble: nothing to compute, the ring still turns
        if t < ticks - 1:
            (state,) = comm.ring(stage, out)
    if s == n_stages - 1:
        local = torch.cat(outputs) + 0 * out.sum()
    else:
        local = torch.zeros_like(x) + 0 * out.sum()
    hidden = comm.reduce_from(local, stage)
    hidden = comm.gather(hidden, 0, data, "slice")
    return rms_norm(params["norm"], hidden, cfg.rms_norm_eps)


def sync_stage_grads(grads: dict, mesh: Mesh) -> dict:
    """{name: grad} of a stage's leaves: the layers' summed over 'data'
    (each pipeline saw its own rows); the replicated leaves as they are."""
    data = mesh.axis(DATA_AXIS)
    return {k: (comm.all_reduce(g, data) if k.startswith("layers") else g)
            for k, g in grads.items()}
