"""The check that no JAX module was loaded in the run that prints a result.

Names are compared by their top-level part (before the first dot), whole:
`tokenpacker_tpu_torch` is the measured program, `tokenpacker_tpu` the JAX
package it was ported from.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tokenpacker_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
