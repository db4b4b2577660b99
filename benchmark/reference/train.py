"""Stage 1 (LLaVA's scripts/v1_5/pretrain.sh): the projector trains, the tower
and the LM are frozen. Per micro-batch the loss is the shifted next-token
cross-entropy over the caption's labels (the image's positions carry none),
averaged over them; the optimizer takes the mean of a number of
micro-batches' gradients (their running mean), clips their global norm to 1 and makes one AdamW
step (b1 0.9, b2 0.999, eps 1e-8, no weight decay) at the learning rate of
optax's warmup_cosine_decay_schedule(0, lr, warmup, updates), warmup =
max(int(updates * warmup_ratio), 1), evaluated at the update count before
it is incremented."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import clip, mpt, projector, splice

IGNORE = -100


def lr_at(count: int, lr: float, updates: int, warmup_ratio: float) -> float:
    warmup = max(int(updates * warmup_ratio), 1)
    if count < warmup:
        return lr * count / warmup
    decay = max(updates, warmup + 1) - warmup
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def sequences(samples: list, visual: torch.Tensor, wte: torch.Tensor):
    """samples: (ids with the image hole, labels); visual [N, tokens, D].
    Returns right-padded embeddings [N, T, D] and labels [N, T]."""
    embs, labs = [], []
    for i, (ids, labels) in enumerate(samples):
        items = splice.order(ids, None, 0, 0)
        embs.append(splice.embed(items, visual[i:i + 1], wte))
        lab = []
        for t, l in zip(ids, labels):
            lab += [IGNORE] * visual.shape[1] if int(t) == splice.IMAGE_TOKEN_INDEX else [int(l)]
        labs.append(lab)
    t = max(e.shape[0] for e in embs)
    x = torch.zeros(len(embs), t, embs[0].shape[1], device=wte.device)
    y = torch.full((len(embs), t), IGNORE, dtype=torch.long, device=wte.device)
    for i, (e, lab) in enumerate(zip(embs, labs)):
        x[i, :e.shape[0]] = e
        y[i, :len(lab)] = torch.tensor(lab, device=wte.device)
    return x, y


def micro_loss(pp: dict, conf: dict, lm32: dict, feats, multi, samples, prec) -> torch.Tensor:
    visual = projector.project(pp, conf["projector"], feats, multi, prec)
    x, y = sequences(samples, visual, lm32["wte"])
    hid = mpt.hidden(lm32, conf["lm"], x, prec)
    lg = mpt.logits(lm32, hid[:, :-1], prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), y[:, 1:].reshape(-1),
                           ignore_index=IGNORE)


def follow(weights: dict, conf: dict, recipe: dict, micro_batches: list, prec,
           lm32: dict | None = None, store=None) -> dict:
    """The first updates of stage 1 from the benchmark's weights.

    micro_batches: per micro-step (pixels [N, H, W, 3], [(ids, labels)] * N),
    `recipe["gradient_accumulation_steps"]` of them an update. Returns the
    loss of every micro-step, the first update's clipped mean gradient and
    the projector's change after the last update, both by leaf path.
    `store`: a dtype that the projector, the moments and the running mean
    of the gradients are rounded to after every change (a diagnosis of
    storage in that type; the reference proper keeps float32)."""
    k = recipe["gradient_accumulation_steps"]
    lm32 = lm32 or mpt.upcast(weights["lm"])
    paths = [p for p, _ in _tree_leaves(weights["projector"])]
    p0 = {p: t.detach().float().clone() for p, t in _tree_leaves(weights["projector"])}
    p = {q: t.clone().requires_grad_(True) for q, t in p0.items()}
    mu = {q: torch.zeros_like(t) for q, t in p0.items()}
    nu = {q: torch.zeros_like(t) for q, t in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    updates = len(micro_batches) // k
    for u in range(updates):
        acc = {q: torch.zeros_like(t) for q, t in p0.items()}
        for m in range(k):
            pixels, samples = micro_batches[u * k + m]
            with torch.no_grad():
                feats, multi = clip.tower(weights["vision"], conf["vision"], pixels, prec)
            loss = micro_loss(_rebuild(weights["projector"], p), conf, lm32, feats, multi,
                              samples, prec)
            grads = torch.autograd.grad(loss, [p[q] for q in paths])
            losses.append(float(loss.detach()))
            for q, g in zip(paths, grads):
                acc[q] += (g - acc[q]) / (m + 1)  # the running mean of the micro-steps
                if store is not None:
                    acc[q] = acc[q].to(store).float()
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in acc.values()))
            if norm >= recipe["max_grad_norm"]:
                acc = {q: g * (recipe["max_grad_norm"] / norm) for q, g in acc.items()}
            if first is None:
                first = {q: g.clone() for q, g in acc.items()}
            lr = lr_at(u, recipe["learning_rate"], recipe["updates"], recipe["warmup_ratio"])
            c1, c2 = 1 - b1 ** (u + 1), 1 - b2 ** (u + 1)
            for q in paths:
                mu[q] = b1 * mu[q] + (1 - b1) * acc[q]
                nu[q] = b2 * nu[q] + (1 - b2) * acc[q].square()
                if store is not None:
                    mu[q], nu[q] = mu[q].to(store).float(), nu[q].to(store).float()
                p[q] -= lr * (mu[q] / c1) / (torch.sqrt(nu[q] / c2) + eps)
                if store is not None:
                    p[q].copy_(p[q].to(store).float())
    return {"losses": losses, "first_grad": first,
            "change": {q: (p[q].detach() - p0[q]) for q in paths}}


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf: |norm(got) - norm(want)| over the larger of the
    leaf's reference norm and the median leaf's, over the leaves `keep`."""
    norms = {q: float(want[q].norm()) for q in keep}
    median = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(got[q].float().norm()) - norms[q]) / max(norms[q], median)
               for q in keep)


def kept_leaves(first_grad: dict) -> list:
    """The leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others (a key's bias under softmax) move under Adam
    by round-off alone."""
    norms = {q: float(g.norm()) for q, g in first_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [q for q, n in norms.items() if n > 1e-3 * median]
