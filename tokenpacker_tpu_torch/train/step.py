"""Training step: per-group AdamW with the JAX package's optax chain, and
the step itself (counterpart of `tokenpacker_tpu/train/step.py`).

Recipe (scripts/v1_5/pretrain.sh, finetune.sh, llava_trainer.py:150-237):
stage 1 ("pretrain") trains the projector only; stage 2 ("finetune") the
LM and the projector, with an optional `mm_projector_lr`; the vision
tower never trains. Each trained group runs the optax chain
`clip_by_global_norm(max_grad_norm)` then `adamw(warmup_cosine_decay)`
on its own gradients, so the clip is per group. The LoRA path
(`train/lora`, `Trainer._train_lora`) runs the same update over the
adapters and the projector with one clip over both (`global_clip`), as
the JAX package's single optax chain does. The update is written
out here (not `torch.optim.AdamW`) to compute what optax computes:

- the schedule is evaluated at the group's update count before the
  increment, so the first update has lr = 0 (the warmup starts at 0);
- clip: g * max / |g| when |g| >= max (optax's rule; torch's
  `clip_grad_norm_` uses max / (|g| + 1e-6));
- AdamW: mu, nu with optax's bias correction, update
  mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, times -lr;
- `gradient_accumulation_steps` = k works as `optax.MultiSteps`: the
  running mean of k micro-step gradients, then one update; the schedule
  advances per update.

Parameters stay the port's plain dicts. `make_optimizer` marks the
trained leaves with `requires_grad_(True)` and the rest with False, and
updates them in place. Moments and accumulators are kept in the
parameter dtype, as optax and torch.optim keep them; the arithmetic of
an update runs in fp32.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.models.vlm import vlm_loss
from tokenpacker_tpu_torch.parallel.sharding import global_norm, sync_grads


@dataclass(frozen=True)
class TrainConfig:
    stage: str = "finetune"  # "pretrain" | "finetune"
    learning_rate: float = 2e-5
    mm_projector_lr: float | None = None  # None -> same as learning_rate
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    gradient_accumulation_steps: int = 1


def leaves_with_paths(node, path=()):
    """(path, tensor) for every tensor of a params tree, in a fixed order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from leaves_with_paths(v, path + (i,))
    elif isinstance(node, torch.Tensor):
        yield path, node


def group_of(path) -> str:
    top = path[0]
    if top == "vision":
        return "frozen"
    if top == "projector":
        return "projector"
    return "lm"


def param_groups(params) -> dict[str, list[torch.Tensor]]:
    """{"frozen" | "projector" | "lm": the leaves of that group, in order}."""
    groups: dict[str, list[torch.Tensor]] = {}
    for path, leaf in leaves_with_paths(params):
        groups.setdefault(group_of(path), []).append(leaf)
    return groups


def warmup_cosine(base_lr: float, warmup: int, decay_steps: int):
    """`optax.warmup_cosine_decay_schedule(0, base_lr, warmup, decay_steps)`
    as a function of the update count: linear from 0 over `warmup` updates,
    then a cosine to 0 at `decay_steps`."""
    decay = decay_steps - warmup

    def lr(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        c = min(count - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr


def warmup_cosine_decay(base_lr: float, tcfg: TrainConfig):
    """The full path's schedule: warmup over max(int(total * warmup_ratio),
    1) updates, cosine to 0 at total."""
    warmup = max(int(tcfg.total_steps * tcfg.warmup_ratio), 1)
    return warmup_cosine(base_lr, warmup, max(tcfg.total_steps, warmup + 1))


def _clip(grads: list[torch.Tensor], max_norm: float, leaves=None, mesh=None) -> list[torch.Tensor]:
    """optax's clip_by_global_norm over `grads` (fp32), the norm over the
    whole gradients of sharded `leaves` on a mesh."""
    norm = global_norm(grads, leaves or [None] * len(grads), mesh)
    if not norm < max_norm:
        return [g / norm * max_norm for g in grads]
    return grads


class Optimizer:
    """An optax chain of clip_by_global_norm and AdamW over named groups of
    leaves, each group with its schedule. The clip is per group
    (`make_optimizer`, the full path) or over every group at once
    (`global_clip`, the LoRA path). `init()` makes the state;
    `update(grads, state)` applies one micro-step in place (the parameters
    move on every k-th). On a `mesh` (`parallel/mesh`) the leaves are this
    rank's shards, the state is sharded like them, and the clip's norm is
    over the whole gradients (`parallel/sharding.global_norm`)."""

    def __init__(self, tcfg: TrainConfig, groups: dict[str, list[torch.Tensor]],
                 schedules: dict, global_clip: bool = False, mesh=None):
        self.tcfg = tcfg
        self.groups = groups
        self.schedules = schedules
        self.global_clip = global_clip
        self.mesh = mesh

    @property
    def params(self) -> list[torch.Tensor]:
        """Every trained leaf, group by group (the order of `update`'s grads)."""
        return [p for leaves in self.groups.values() for p in leaves]

    def init(self) -> dict:
        state = {
            "count": {name: 0 for name in self.groups},
            "mu": {name: [torch.zeros_like(p) for p in ps] for name, ps in self.groups.items()},
            "nu": {name: [torch.zeros_like(p) for p in ps] for name, ps in self.groups.items()},
            "mini_step": 0,
        }
        if self.tcfg.gradient_accumulation_steps > 1:
            state["acc"] = [torch.zeros_like(p) for p in self.params]
        return state

    @torch.no_grad()
    def update(self, grads, state: dict) -> None:
        tcfg = self.tcfg
        k = tcfg.gradient_accumulation_steps
        if k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.copy_(acc.float() + (g.float() - acc.float()) / (n + 1))
            if n < k - 1:
                state["mini_step"] = n + 1
                return
            state["mini_step"] = 0
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
        grads = [g.float() for g in grads]
        if self.global_clip:
            grads = _clip(grads, tcfg.max_grad_norm, self.params, self.mesh)
        b1, b2, eps, wd = tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps, tcfg.weight_decay
        start = 0
        for name, leaves in self.groups.items():
            group_grads = grads[start:start + len(leaves)]
            start += len(leaves)
            if not self.global_clip:
                group_grads = _clip(group_grads, tcfg.max_grad_norm, leaves, self.mesh)
            count = state["count"][name]
            lr = self.schedules[name](count)
            c1, c2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
            for p, g, mu, nu in zip(leaves, group_grads, state["mu"][name], state["nu"][name]):
                m = (1.0 - b1) * g + b1 * mu.float()
                v = (1.0 - b2) * g.square() + b2 * nu.float()
                mu.copy_(m)
                nu.copy_(v)
                upd = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p.float()
                p.copy_(p.float() - lr * upd)
            state["count"][name] = count + 1


def make_optimizer(tcfg: TrainConfig, params, mesh=None) -> Optimizer:
    """The full path's optimizer: the projector (stage 1) or the projector
    and the LM (stage 2), each group clipped on its own, marked
    `requires_grad_(True)` and every other leaf False."""
    trained = ("projector",) if tcfg.stage == "pretrain" else ("projector", "lm")
    groups = param_groups(params)
    for name, leaves in groups.items():
        for leaf in leaves:
            leaf.requires_grad_(name in trained)
    proj_lr = tcfg.mm_projector_lr or tcfg.learning_rate
    schedules = {"projector": warmup_cosine_decay(proj_lr, tcfg),
                 "lm": warmup_cosine_decay(tcfg.learning_rate, tcfg)}
    return Optimizer(tcfg, {name: groups[name] for name in trained if name in groups}, schedules,
                     mesh=mesh)


def mesh_grads(loss, opt: Optimizer):
    """The gradients of `loss` for the optimizer's leaves, made whole for
    their shards on the optimizer's mesh (`sync_grads`), and their global
    norm."""
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True, materialize_grads=True)
    grads = sync_grads(grads, opt.params, opt.mesh)
    return grads, global_norm(grads, opt.params, opt.mesh)


def make_train_step(cfg: TokenPackerVLMConfig, opt: Optimizer, remat: str = ""):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and its gradients for the trained leaves, then one optimizer
    micro-step in place. `grad_norm` is the global norm of the trained
    groups' gradients (the JAX step's norm also counts the frozen LM's
    gradients in stage 1, which the update never reads: ROADMAP R7). On
    the optimizer's mesh the batch is this rank's 'data' rows and the
    params its shards (`parallel/sharding.shard_params`): the step runs
    under the mesh, and `loss` is the global batch's."""

    def step(params, opt_state, batch):
        with opt.mesh if opt.mesh is not None else contextlib.nullcontext():
            loss, metrics = vlm_loss(params, cfg, batch, remat=remat)
            grads, grad_norm = mesh_grads(loss, opt)
            opt.update(grads, opt_state)
        return params, opt_state, {"loss": metrics["loss"].detach(),
                                   "n_tokens": metrics["n_tokens"], "grad_norm": grad_norm}

    return step
