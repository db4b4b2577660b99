"""Named parameter-initialization schemes (counterpart of
`tokenpacker_tpu/models/init_fns.py`).

The reference MPT ships 10 init schemes (mpt/param_init_fns.py:10-180)
selected by `init_config.name`. The same names map here to initializers
drawn from an explicit `torch.Generator`, applied to every linear kernel
of a params tree; embeddings and norms keep their values. Fan-in and
fan-out follow the [in, out] kernel layout. The draws differ from
`jax.random`'s; the distributions (std, truncation at 2 std, bounds) are
the JAX package's.
"""

from __future__ import annotations

import math

import torch

INIT_SCHEMES = (
    "baseline_", "default_", "small_init_", "neox_init_", "kaiming_normal_",
    "kaiming_uniform_", "xavier_normal_", "xavier_uniform_", "normal_", "trunc_normal_",
)


def _fans(shape):
    # kernels are [..., in, out]
    return shape[-2], shape[-1]


def make_init(name: str, init_std: float = 0.02, init_gain: float = 0.0,
              d_model: int | None = None, n_layers: int | None = None):
    """fn(shape, generator, dtype=float32, device=None) -> tensor for the
    scheme `name`; raises ValueError on an unknown one."""

    def trunc(std):
        def fn(shape, gen, dtype=torch.float32, device=None):
            x = torch.empty(shape, dtype=torch.float32, device=device)
            return torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                               generator=gen).to(dtype)
        return fn

    def normal(std_of):
        def fn(shape, gen, dtype=torch.float32, device=None):
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return (x * std_of(shape)).to(dtype)
        return fn

    def uniform(bound_of):
        def fn(shape, gen, dtype=torch.float32, device=None):
            bound = bound_of(shape)
            x = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            return (x * (2 * bound) - bound).to(dtype)
        return fn

    def d_of(shape):
        return d_model or shape[-2]

    def sized_trunc(std_of):
        def fn(shape, gen, dtype=torch.float32, device=None):
            return trunc(std_of(shape))(shape, gen, dtype, device)
        return fn

    baseline = trunc(init_std)
    table = {
        "baseline_": baseline,
        "default_": baseline,
        # small_init_fn_: std = sqrt(2 / (5 d))
        "small_init_": sized_trunc(lambda s: math.sqrt(2.0 / (5.0 * d_of(s)))),
        # wang-style scaled output init: 2 / (L sqrt(d))
        "neox_init_": sized_trunc(lambda s: 2.0 / ((n_layers or 24) * math.sqrt(d_of(s)))),
        "kaiming_normal_": normal(lambda s: math.sqrt(2.0 / _fans(s)[0])),
        "kaiming_uniform_": uniform(lambda s: math.sqrt(6.0 / _fans(s)[0])),
        "xavier_normal_": normal(lambda s: math.sqrt(2.0 / sum(_fans(s)))),
        "xavier_uniform_": uniform(lambda s: math.sqrt(6.0 / sum(_fans(s)))),
        "normal_": normal(lambda s: init_std),
        "trunc_normal_": baseline,
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown init scheme {name!r}; known: {sorted(table)}") from None


def reinit_kernels(params, generator: torch.Generator, name: str = "kaiming_normal_", **kwargs):
    """A copy of `params` in which every "kernel" leaf of two or more
    dimensions is drawn anew by the scheme `name` (same dtype and device);
    every other leaf is the same tensor."""
    fn = make_init(name, **kwargs)

    def walk(node, in_kernel: bool):
        if isinstance(node, dict):
            return {k: walk(v, in_kernel or k == "kernel") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_kernel) for v in node]
        if in_kernel and isinstance(node, torch.Tensor) and node.dim() >= 2:
            return fn(tuple(node.shape), generator, node.dtype, node.device)
        return node

    return walk(params, False)
