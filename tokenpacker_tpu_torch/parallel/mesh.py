"""Rank grids over `torch.distributed` (counterpart of
`tokenpacker_tpu/parallel/mesh.py`).

The JAX package runs one process over a mesh of local devices and lets
XLA insert the collectives. The port runs one process per rank, PyTorch's
idiom: a `Mesh` is the grid of ranks of the world group with named axes,

  'data'  - batch parallelism and ZeRO-3 parameter sharding (a leaf's
            shards are all-gathered on use, `parallel/sharding`);
  'model' - Megatron tensor parallelism (heads and MLP width),

and a process group for each row and each column, which `parallel/comm`
runs the collectives on. Rank r sits at (r // tp, r % tp), as JAX's
`np.asarray(devices).reshape(dp, tp)` places device r.

The device is explicit: `cuda:LOCAL_RANK` by default, or what the caller
names (`"cpu"` for the CPU tests). The backend follows the device, NCCL
for CUDA and gloo for the CPU, unless the caller names one: two ranks on
one card take `backend="gloo"`, and `parallel/comm` stages their CUDA
tensors through pinned host memory. Without an initialized process group
(and without `torchrun`'s environment) the world is one rank.

`with mesh:` makes the mesh the active one (`active()`), as
`jax.set_mesh` does: the loss reads its 'data' axis, and the tower splits
image crops over it (`models/vlm`).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def P(*axes) -> tuple:
    """A placement spec: one mesh-axis name (or None) per dimension, JAX's
    `PartitionSpec` as a tuple."""
    return tuple(axes)


@dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its size, this rank's index
    along it, the global ranks of its group (in index order) and the group
    (None for a size of 1)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object
    backend: str


class Mesh:
    """A grid of ranks with named axes (`make_mesh`, `pipeline.make_pp_mesh`).
    `rank` builds the mesh as that rank of a world that is not running
    (no groups: for slicing host arrays into a rank's shards)."""

    def __init__(self, names: tuple, sizes: tuple, device, backend: str | None = None,
                 rank: int | None = None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.device = torch.device(device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        if rank is not None and not dist.is_initialized():
            world, self.rank = sizes[0] * sizes[1], rank
        self.size = world
        self.backend = backend or (dist.get_backend() if dist.is_initialized() else "none")
        n0, n1 = sizes
        i, j = divmod(self.rank, n1)
        self.coords = {names[0]: i, names[1]: j}
        rows = [[a * n1 + b for b in range(n1)] for a in range(n0)]
        cols = [[a * n1 + b for a in range(n0)] for b in range(n1)]
        # every rank makes every group, in the same order (new_group's rule)
        row_groups = [self._group(r) for r in rows]
        col_groups = [self._group(c) for c in cols]
        self.world = self._group(list(range(world)))
        self.axes = {
            names[1]: Axis(names[1], n1, j, tuple(rows[i]), row_groups[i], self.backend),
            names[0]: Axis(names[0], n0, i, tuple(cols[j]), col_groups[j], self.backend),
        }
        self.world_axis = Axis("world", world, self.rank, tuple(range(world)), self.world,
                               self.backend)

    def _group(self, ranks):
        if len(ranks) == 1 or not dist.is_initialized():
            return None
        if len(ranks) == dist.get_world_size() and self.backend == dist.get_backend():
            return dist.group.WORLD
        return dist.new_group(ranks, backend=self.backend)

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, backend={self.backend})"

    def __enter__(self):
        _ACTIVE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()


class _Active(threading.local):
    def __init__(self):
        self.stack = []


_ACTIVE = _Active()


def active() -> Mesh | None:
    """The innermost mesh entered with `with mesh:` on this thread, or None."""
    return _ACTIVE.stack[-1] if _ACTIVE.stack else None


def default_device() -> torch.device:
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def ensure_process_group(device: torch.device, backend: str | None = None) -> None:
    """Initialize the default group from `torchrun`'s environment
    (`env://`) when it names a world of more than one rank; otherwise the
    world stays one rank."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dist.init_process_group(backend or backend_for(device), init_method="env://")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: int | None = None, tp: int = 1, device=None, backend: str | None = None,
              names: tuple = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A ('data', 'model') mesh over the world. dp defaults to world // tp;
    JAX's errors for a world `tp` does not divide and for dp * tp != world."""
    device = torch.device(device) if device is not None else default_device()
    ensure_process_group(device, backend)
    n = world_size()
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != {n} devices")
    return Mesh(names, (dp, tp), device, backend)


def single_device_mesh(device=None) -> Mesh:
    """A world-of-one mesh on `device`: no collective ever runs on it."""
    device = torch.device(device) if device is not None else default_device()
    if world_size() != 1:
        raise ValueError("single_device_mesh needs a world of one rank")
    return Mesh((DATA_AXIS, MODEL_AXIS), (1, 1), device)


def replicated(mesh: Mesh | None = None) -> tuple:
    """Every rank holds the whole array."""
    return P()


def batch_sharding(mesh: Mesh | None = None) -> tuple:
    """The leading (batch) axis split over 'data'."""
    return P(DATA_AXIS)
