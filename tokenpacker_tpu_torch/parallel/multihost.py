"""Training across processes and hosts (counterpart of
`tokenpacker_tpu/parallel/multihost.py`).

The JAX package joins hosts with `jax.distributed.initialize` and builds
one global mesh over every device. The port runs one process a rank:
every process calls `init_process` (`torch.distributed` over TCP, or
`env://` under torchrun), builds the same ('data', 'model') mesh
(`parallel/mesh.make_mesh`) and takes its shards of the params and of
the batch. NCCL carries the collectives between cards; `--device cpu`
runs gloo.

`run_dryrun` is the runnable template and the smoke: one dp x tp train
step of the tiny config on the global mesh; every process must print the
same loss as a world of one.

Usage (once per process):
  python -m tokenpacker_tpu_torch.parallel.multihost \\
      --coordinator HOST0:12345 --num-processes N --process-id I [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tokenpacker_tpu_torch.parallel.mesh import backend_for


def init_process(coordinator: str | None, num_processes: int, process_id: int,
                 device="cuda", backend: str | None = None) -> None:
    """Join the world: TCP rendezvous at `coordinator` (host:port), or
    torchrun's environment when it is None or "env://". The backend
    follows the device (NCCL for CUDA, gloo for the CPU) unless named. A
    world of one initializes nothing."""
    if num_processes <= 1 or dist.is_initialized():
        return
    init = "env://" if coordinator in (None, "env://") else f"tcp://{coordinator}"
    kwargs = {} if init == "env://" else {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend or backend_for(device), init_method=init, **kwargs)


def host_to_global(host_tree, specs, mesh):
    """Each array of a host tree replicated on every process, cut to this
    rank's shard along the mesh axes its spec names (a tree of spec
    tuples of the same structure, `parallel/sharding.vlm_param_shardings`
    or `batch_shardings`). Every process passes the same full values."""
    if isinstance(host_tree, dict):
        return {k: host_to_global(v, specs[k], mesh) for k, v in host_tree.items()}
    if isinstance(host_tree, list):
        return [host_to_global(v, s, mesh) for v, s in zip(host_tree, specs)]
    if host_tree is None:
        return None
    x = host_tree
    for d, a in enumerate(specs):
        if a is not None:
            ax = mesh.axis(a)
            x = x[(slice(None),) * d + (slice(ax.index * (x.shape[d] // ax.size),
                                              (ax.index + 1) * (x.shape[d] // ax.size)),)]
    return x


def dryrun_batch(cfg, rows: int) -> dict:
    """JAX's dryrun batch: `rows` copies of one spliced sample with one
    image, labels on its last three tokens, padded to 32, as numpy."""
    from tokenpacker_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    ids = np.array([1, 5, IMAGE_TOKEN_INDEX, 9, 10, 11], dtype=np.int64)
    labels = np.array([IGNORE_INDEX] * 3 + [9, 10, 11], dtype=np.int64)
    plan = build_splice_plan([ids] * rows, [[(1, 1)]] * rows, cfg.tokens_per_view, "single",
                             0, 0, 0, labels=[labels] * rows, pad_to=32)
    n = plan.token_ids.shape[1]
    imgs = np.random.default_rng(0).standard_normal(
        (rows, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    return {"images": imgs, "token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot,
            "positions": np.broadcast_to(np.arange(n), (rows, n)).copy(),
            "key_valid": plan.attn_mask, "labels": plan.labels}


def run_dryrun(tp: int = 2, seed: int = 0, device=None, backend: str | None = None) -> float:
    """One ZeRO-3 x TP train step of the tiny config on the global mesh
    (on cuda:LOCAL_RANK unless `device` names another); returns the
    (global) loss. The weights come from one seeded CPU
    generator (`io/weights.init_vlm_on_device`), the same on every
    process; the port cannot reproduce JAX's threefry init."""
    from tokenpacker_tpu_torch.config import tiny_vlm_config
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, default_device, make_mesh
    from tokenpacker_tpu_torch.parallel.sharding import batch_shardings, shard_params
    from tokenpacker_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step

    device = torch.device(device) if device is not None else default_device()
    mesh = make_mesh(tp=tp, device=device, backend=backend)
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed, "cpu", torch.float32)
    params = shard_params(params, mesh, cfg) if mesh.size > 1 else params
    params = _to(params, device)
    dp = mesh.shape[DATA_AXIS]
    host = dryrun_batch(cfg, dp)
    local = host_to_global({k: v for k, v in host.items() if k != "images"},
                           batch_shardings(host, mesh), mesh)
    batch = {k: torch.as_tensor(v).to(device) for k, v in local.items() if k != "key_valid"}
    for k in ("token_ids", "image_slot", "positions", "labels"):
        batch[k] = batch[k].long()
    batch["images"] = torch.as_tensor(host["images"]).to(device)  # crops split over 'data'
    tcfg = TrainConfig(stage="finetune", total_steps=10, mm_projector_lr=1e-4)
    opt = make_optimizer(tcfg, params, mesh if mesh.size > 1 else None)
    step = make_train_step(cfg, opt)
    _, _, metrics = step(params, opt.init(), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    print(f"multihost_dryrun: pid={mesh.rank}/{mesh.size} mesh={dict(mesh.shape)} "
          f"loss={loss:.6f} OK", flush=True)
    return loss


def _to(node, device):
    """A params tree on `device`, each leaf's placement kept."""
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    if isinstance(node, torch.Tensor):
        out = node.to(device)
        if out is not node and hasattr(node, "_placement"):
            out._placement = node._placement
        return out
    return node


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default="localhost:12357")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, cuda:LOCAL_RANK) or cpu (gloo); the JAX CLI's "
                         "--cpu-local-devices")
    ap.add_argument("--backend", default=None, help="name the backend (default: by device)")
    ap.add_argument("--tp", type=int, default=2)
    args = ap.parse_args(argv)
    init_process(args.coordinator, args.num_processes, args.process_id, args.device,
                 args.backend)
    try:
        run_dryrun(tp=args.tp, device=None if args.device == "cuda" else args.device,
                   backend=args.backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
