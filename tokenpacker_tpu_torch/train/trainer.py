"""Training loop: the two-stage recipe and its checkpoints (counterpart
of `tokenpacker_tpu/train/trainer.py`) on one device.

- stage 1 `pretrain` (scripts/v1_5/pretrain.sh): projector only, saves the
  reference-format `mm_projector.bin` (llava_trainer.py:239-264);
- stage 2 `finetune` (finetune.sh): LM and projector, optional
  `mm_projector_lr`; the checkpoint is the port's own format, a
  `torch.save` of {"params", "opt_state", "step"} under
  `checkpoint-N/state.pt` (orbax, the JAX package's format, is not a
  dependency of the port);
- resume from the latest `checkpoint-*` (reference train.py:990-993).

The checkpoint write runs on a writer thread from a host copy taken
before `save_checkpoint` returns, one write in flight at a time
(`async_save`), as the JAX package's orbax AsyncCheckpointer does.

Both LM families train (MPT through K2's key-only ALiBi form in both
directions; its tied `wte` takes the embedding's and the head's
gradients in stage 2). `remat` is llama's: MPT has none, as in the JAX
package, and a non-empty one raises.

LoRA and QLoRA (`rcfg.lora`, a `train/lora.LoraConfig`; `bits` 8 or 4
quantize the frozen LM unfused with `ops/quantize.quantize_tree(_4bit)`
when the Trainer is made) train the adapters and the projector with one
clip over both, AdamW and optax's `warmup_cosine_decay_schedule(0, lr,
max(warmup, 1), total + 1)` (`_train_lora`, the JAX package's LoRA loop),
and write the reference's LoRA layout (`save_lora_checkpoint`). Unlike
the JAX package's loop (ROADMAP R15) it applies `weight_decay`,
`mm_projector_lr` and `gradient_accumulation_steps`, and resumes from the
latest LoRA checkpoint; with weight_decay 1e-4 (optax's default, which
JAX always applies), no `mm_projector_lr` and no accumulation the two
compute the same steps.

`Trainer.train()` runs on the device the parameters live on, CUDA unless
the caller asks for the CPU (`device="cpu"`); a parameter on another
device raises, and so does `bits` 8 or 4 without `lora` (the full path
would train a quantized base).

Across ranks the Trainer builds `parallel/mesh.make_mesh(tp=rcfg.tp)`
over the world (one process a rank, `torchrun` or `parallel/multihost`),
as the JAX Trainer builds its mesh over every device. Every rank collates
the same global batch of `per_device_batch_size x dp` rows from the same
seed and takes its 'data' rows (the image crops split over 'data' as
well, `models/vlm`). The full path shards the params
(`parallel/sharding.shard_params`: ZeRO-3 over 'data', tensor-parallel
blocks over 'model'), so each gradient reaches its shard reduce-scattered
and the optimizer state is sharded like the params; the clip's norm is
over the whole gradients. The LoRA path keeps JAX's meaning: no
parameter is sharded, the mesh splits the global batch over 'data' and
the adapters' gradients are all-reduced. Rank 0 writes the same
checkpoint files as a single process does (the shards gathered first);
every rank resumes from them.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
from tokenpacker_tpu_torch.data.dataset import LengthGroupedSampler, SupervisedDataset, collate
from tokenpacker_tpu_torch.generate import device_batch
from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker, import_tokenpacker, strip_prefix
from tokenpacker_tpu_torch.ops import quantize
from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from tokenpacker_tpu_torch.parallel.sharding import (
    placement,
    shard_like,
    shard_params,
    unshard_leaf,
    unshard_params,
)
from tokenpacker_tpu_torch.train.lora import (
    LoraConfig,
    export_lora_state_dict,
    import_lora_state_dict,
    init_lora,
    make_lora_optimizer,
    make_lora_train_step,
)
from tokenpacker_tpu_torch.train.step import (
    TrainConfig,
    leaves_with_paths,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger(__name__)

# the projector's keys in non_lora_trainables.bin
LORA_PROJECTOR_PREFIX = "base_model.model.model.mm_projector."


@dataclass
class RunConfig:
    output_dir: str = "./checkpoints/run"
    num_train_epochs: int = 1
    per_device_batch_size: int = 16
    save_steps: int = 500
    save_total_limit: int = 1
    async_save: bool = True
    logging_steps: int = 1
    group_by_modality_length: bool = False
    seed: int = 42
    tp: int = 1
    seq_pad_to: int = 2048
    bits: int = 16  # 8 / 4: the frozen LM quantized for LoRA (QLoRA)
    lora: LoraConfig | None = None
    remat: str = ""  # models/llama.llama_apply's per-layer rematerialization


def _latest_checkpoint(output_dir: str) -> str | None:
    cands = glob.glob(os.path.join(output_dir, "checkpoint-*"))
    steps = [(int(m.group(1)), p) for p in cands if (m := re.search(r"checkpoint-(\d+)$", p))]
    return max(steps)[1] if steps else None


def _to_host(node):
    """A CPU copy of a tree of tensors (dicts, lists, numbers)."""
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_host(v) for v in node]
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    return node


@torch.no_grad()
def _copy_into(dst, src):
    """Copy a tree of host tensors into the same tree of tensors, in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    if isinstance(dst, list):
        for i in range(len(dst)):
            dst[i] = _copy_into(dst[i], src[i])
        return dst
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    return src


def device_train_batch(batch: dict, dtype: torch.dtype, device) -> dict:
    """A `collate` batch (numpy) as the tensors `vlm_loss` reads: the
    serving batch of `generate.device_batch` plus positions and labels."""
    out = device_batch(batch, dtype, device)
    for name in ("positions", "labels"):
        out[name] = torch.as_tensor(np.asarray(batch[name])).to(device=device, dtype=torch.int64)
    return out


class Trainer:
    def __init__(self, cfg: TokenPackerVLMConfig, tcfg: TrainConfig, rcfg: RunConfig, params,
                 dataset: SupervisedDataset, tokenizer, device: str | torch.device = "cuda"):
        if rcfg.bits not in (16, 8, 4):
            raise ValueError(f"bits={rcfg.bits}: expected 16, 8 or 4")
        if rcfg.bits != 16 and rcfg.lora is None:
            raise ValueError(f"bits={rcfg.bits} quantizes a frozen base and needs lora "
                             "(QLoRA); the full path trains the LM itself")
        if rcfg.lora is not None and not isinstance(rcfg.lora, LoraConfig):
            raise TypeError(f"lora: expected a train.lora.LoraConfig, got {type(rcfg.lora)}")
        if rcfg.remat and cfg.lm.model_family == "mpt":
            raise ValueError(f"remat={rcfg.remat!r}: MPT has no rematerialization (nor has the "
                             "JAX package's mpt_apply)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.rcfg = rcfg
        self.device = torch.device(device)
        self.mesh = make_mesh(tp=rcfg.tp, device=self.device)
        self.dp = self.mesh.shape[DATA_AXIS]
        self.rank0 = self.mesh.rank == 0
        for path, leaf in leaves_with_paths(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameter {'/'.join(map(str, path))} is on {leaf.device}, "
                                 f"the trainer runs on {self.device}")
        if rcfg.lora is not None and rcfg.bits != 16:
            # unfused (a fused qkv / gateup leaf is never a target), as the
            # JAX package's loop quantizes; the dense LM is dropped here
            quant = quantize.quantize_tree if rcfg.bits == 8 else quantize.quantize_tree_4bit
            params = {**params, "lm": quant(params["lm"])}
        self.params = params
        self.lora = None  # the adapter tree after a LoRA train()
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.sep_id = tokenizer.convert_tokens_to_ids(",")
        self.ret_id = tokenizer.convert_tokens_to_ids("\n")
        self.pad_id = tokenizer.pad_token_id or 0
        self._writer: threading.Thread | None = None
        self._write_error: Exception | None = None
        # one entry per micro-step of the last train(): step, loss, seconds
        # (host clock, synchronized), valid and padded tokens, grad_norm,
        # and on CUDA the step's peak allocated bytes
        self.history: list[dict] = []
        self.opt_state = None  # the optimizer state after the last train()
        self._opt = None  # the full path's optimizer (its leaves place the state's shards)

    @property
    def _step_mesh(self):
        """The mesh the step runs on; None for a world of one."""
        return self.mesh if self.mesh.size > 1 else None

    # -- data --------------------------------------------------------------

    def _batches(self):
        """Global batches of per_device_batch_size x dp rows, the same on
        every rank."""
        rcfg = self.rcfg
        bs = rcfg.per_device_batch_size * self.dp
        if len(self.dataset) < bs:
            raise ValueError(f"dataset ({len(self.dataset)} samples) smaller than one global "
                             f"batch ({rcfg.per_device_batch_size} x {self.dp} devices = {bs}); "
                             "training would silently run zero steps")
        if rcfg.group_by_modality_length:
            order = list(iter(LengthGroupedSampler(rcfg.per_device_batch_size, self.dp,
                                                   self.dataset.modality_lengths,
                                                   group_by_modality=True, seed=rcfg.seed)))
        else:
            order = np.random.default_rng(rcfg.seed).permutation(len(self.dataset)).tolist()
        for i in range(0, len(order) - bs + 1, bs):
            items = [self.dataset[j] for j in order[i:i + bs]]
            yield collate(items, self.cfg.tokens_per_view, self.sep_id, self.ret_id, self.pad_id,
                          pad_to=rcfg.seq_pad_to)

    # -- checkpointing -----------------------------------------------------

    def _write(self, state: dict, path: str):
        try:
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
        except Exception as e:  # re-raised by finish_pending_saves
            self._write_error = e

    def _local_rows(self, batch: dict) -> dict:
        """This rank's 'data' rows of a global device batch (the images stay
        whole: the tower splits its crops over 'data' itself)."""
        if self.dp == 1:
            return batch
        n = batch["token_ids"].shape[0]
        i, per = self.mesh.coords[DATA_AXIS], n // self.dp
        return {k: (v[i * per:(i + 1) * per] if isinstance(v, torch.Tensor) and k != "images"
                    and v.dim() and v.shape[0] == n else v) for k, v in batch.items()}

    def _whole_opt_state(self, opt_state):
        """The optimizer state with every moment gathered from its shards
        (collective: every rank calls it)."""
        opt = self._opt
        if self._step_mesh is None or opt is None:
            return opt_state
        out = dict(opt_state)
        for key in ("mu", "nu"):
            out[key] = {name: [unshard_leaf(m, placement(p))
                               for m, p in zip(opt_state[key][name], opt.groups[name])]
                        for name in opt_state[key]}
        if "acc" in opt_state:
            out["acc"] = [unshard_leaf(a, placement(p))
                          for a, p in zip(opt_state["acc"], opt.params)]
        return out

    def save_checkpoint(self, step: int, opt_state=None):
        out = os.path.join(self.rcfg.output_dir, f"checkpoint-{step}")
        if self.rank0:
            os.makedirs(out, exist_ok=True)
        if self.tcfg.stage == "pretrain":
            self.save_mm_projector(os.path.join(out, "mm_projector.bin"))
        else:
            # one write in flight: the host copy is taken here, so training
            # may update the parameters in place while the file is written
            self.finish_pending_saves()
            params = unshard_params(self.params) if self._step_mesh else self.params
            whole = self._whole_opt_state(opt_state) if opt_state is not None else None
            if not self.rank0:
                return
            state = {"params": _to_host(params), "step": step}
            if whole is not None:
                state["opt_state"] = _to_host(whole)
            self._writer = threading.Thread(target=self._write,
                                            args=(state, os.path.join(out, "state.pt")))
            self._writer.start()
            if not self.rcfg.async_save:
                self.finish_pending_saves()
        self._prune_checkpoints()
        logger.info("saved checkpoint-%d%s", step,
                    " (writing in background)" if self.rcfg.async_save
                    and self.tcfg.stage != "pretrain" else "")

    def finish_pending_saves(self):
        """Block until the in-flight checkpoint write has committed; raise
        if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("checkpoint write failed") from err

    def save_mm_projector(self, path: str):
        proj = self.params["projector"]
        sd = export_tokenpacker(unshard_params(proj) if self._step_mesh else proj)
        if not self.rank0:
            return
        torch.save({f"model.mm_projector.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)

    def _prune_checkpoints(self):
        if not self.rank0:
            return
        cands = sorted(
            glob.glob(os.path.join(self.rcfg.output_dir, "checkpoint-*")),
            key=lambda p: int(re.search(r"checkpoint-(\d+)$", p).group(1)),
        )
        while len(cands) > self.rcfg.save_total_limit:
            shutil.rmtree(cands.pop(0), ignore_errors=True)

    def try_resume(self, opt_state=None):
        """Resume params (and optimizer state and step) from the latest
        checkpoint-*, copied into the live tensors in place. Returns
        (step, opt_state); (0, opt_state) when there is nothing to resume."""
        ckpt = _latest_checkpoint(self.rcfg.output_dir)
        if ckpt is None or self.tcfg.stage == "pretrain":
            return 0, opt_state
        path = os.path.join(ckpt, "state.pt")
        if not os.path.isfile(path):
            return 0, opt_state
        restored = torch.load(path, map_location="cpu", weights_only=True)
        if self._step_mesh is not None:
            restored["params"] = shard_params(restored["params"], self.mesh, self.cfg)
            if "opt_state" in restored and self._opt is not None:
                st, opt = restored["opt_state"], self._opt
                for key in ("mu", "nu"):
                    st[key] = {name: [shard_like(m, p) for m, p in zip(st[key][name],
                                                                        opt.groups[name])]
                               for name in st[key]}
                if "acc" in st:
                    st["acc"] = [shard_like(a, p) for a, p in zip(st["acc"], opt.params)]
        _copy_into(self.params, restored["params"])
        if opt_state is not None and "opt_state" in restored:
            opt_state = _copy_into(opt_state, restored["opt_state"])
        step = restored.get("step") or int(re.search(r"checkpoint-(\d+)$", ckpt).group(1))
        logger.info("resumed from %s at step %d", ckpt, step)
        return int(step), opt_state

    def save_lora_checkpoint(self, step: int, lora, lcfg: LoraConfig, opt_state=None):
        """The reference's LoRA layout (train.py:998-1008) under
        checkpoint-{step}: `adapter_config.json` (r, lora_alpha,
        lora_dropout, peft_type), `adapter_model.bin` (`export_lora_state_dict`)
        and `non_lora_trainables.bin` (the projector under
        `base_model.model.model.mm_projector.`), as the JAX package writes
        them; `config.json` (the reference's LoRA run saves the model's
        config beside them), so that `api.load_pretrained_model(ckpt,
        model_base=...)` reads the directory as it is; with `opt_state`,
        also `optimizer.pt` (the step and the optimizer state, the port's
        own, for `try_resume_lora`). Pruned to save_total_limit."""
        out = os.path.join(self.rcfg.output_dir, f"checkpoint-{step}")
        if not self.rank0:
            return
        os.makedirs(out, exist_ok=True)

        def tensors(sd):
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

        proj = export_tokenpacker(self.params["projector"])
        with open(os.path.join(out, "config.json"), "w") as f:
            json.dump(self.cfg.to_hf_dict(), f, indent=2)
        with open(os.path.join(out, "adapter_config.json"), "w") as f:
            json.dump({"r": lcfg.r, "lora_alpha": lcfg.alpha, "lora_dropout": lcfg.dropout,
                       "peft_type": "LORA"}, f)
        torch.save(tensors(export_lora_state_dict(lora, lcfg)),
                   os.path.join(out, "adapter_model.bin"))
        torch.save(tensors({f"{LORA_PROJECTOR_PREFIX}{k}": v for k, v in proj.items()}),
                   os.path.join(out, "non_lora_trainables.bin"))
        if opt_state is not None:
            torch.save({"step": step, "opt_state": _to_host(opt_state)},
                       os.path.join(out, "optimizer.pt"))
        self._prune_checkpoints()
        logger.info("saved LoRA checkpoint-%d", step)

    def try_resume_lora(self, lora, opt_state=None):
        """Resume the adapters and the projector (copied into the live
        tensors in place) from the latest checkpoint-* in the LoRA layout,
        and the optimizer state and step from its `optimizer.pt` (without
        one: the step of its name, `opt_state` as given). Returns (step,
        opt_state); (0, opt_state) when there is nothing to resume."""
        ckpt = _latest_checkpoint(self.rcfg.output_dir)
        if ckpt is None or not os.path.isfile(os.path.join(ckpt, "adapter_model.bin")):
            return 0, opt_state
        import_lora_state_dict(torch.load(os.path.join(ckpt, "adapter_model.bin"),
                                          map_location="cpu", weights_only=True), lora)
        nlt = torch.load(os.path.join(ckpt, "non_lora_trainables.bin"), map_location="cpu",
                         weights_only=True)
        proj = self.params["projector"]
        dtype = next(t for _, t in leaves_with_paths(proj)).dtype
        _copy_into(proj, import_tokenpacker(strip_prefix(nlt, LORA_PROJECTOR_PREFIX),
                                            self.cfg.projector, dtype))
        step = int(re.search(r"checkpoint-(\d+)$", ckpt).group(1))
        state_path = os.path.join(ckpt, "optimizer.pt")
        if opt_state is not None and os.path.isfile(state_path):
            restored = torch.load(state_path, map_location="cpu", weights_only=True)
            opt_state = _copy_into(opt_state, restored["opt_state"])
            step = int(restored["step"])
        logger.info("resumed LoRA from %s at step %d", ckpt, step)
        return step, opt_state

    # -- main loop ---------------------------------------------------------

    def _loop(self, run_step, save, start_step: int, total_steps: int) -> None:
        """The epochs over `_batches()`: `run_step(device batch)` returns a
        step's metrics; `save(step)` at every save_steps and at the end
        (once where the last step was a save step). Fills `history`."""
        rcfg = self.rcfg
        step, saved = start_step, None
        cuda = self.device.type == "cuda"
        self.history = []
        for _ in range(rcfg.num_train_epochs):
            for batch in self._batches():
                if cuda:
                    torch.cuda.reset_peak_memory_stats(self.device)
                t0 = time.perf_counter()
                metrics = run_step(self._local_rows(device_train_batch(batch, self.cfg.dtype,
                                                                       self.device)))
                loss = float(metrics["loss"])  # waits for the step
                if cuda:
                    torch.cuda.synchronize(self.device)
                record = {"step": step + 1, "loss": loss, "seconds": time.perf_counter() - t0,
                          "valid_tokens": int(batch["lengths"].sum()),
                          "padded_tokens": int(batch["token_ids"].size),
                          "grad_norm": float(metrics["grad_norm"])}
                if cuda:
                    record["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
                self.history.append(record)
                step += 1
                if step % rcfg.logging_steps == 0:
                    logger.info("step %d/%d loss %.4f (%.2fs)", step, total_steps, loss,
                                record["seconds"])
                if step % rcfg.save_steps == 0:
                    save(step)
                    saved = step
        if saved != step:
            save(step)

    def _total_steps(self) -> tuple[int, int]:
        """(micro-steps of the run, optimizer updates: the micro-steps over
        gradient_accumulation_steps, at least 1)."""
        rcfg = self.rcfg
        n_batches = len(self.dataset) // (rcfg.per_device_batch_size * self.dp)
        total = max(n_batches * rcfg.num_train_epochs, 1)
        return total, max(total // max(self.tcfg.gradient_accumulation_steps, 1), 1)

    def _train_lora(self):
        """The LoRA / QLoRA loop (the JAX package's `_train_lora`, with R15's
        settings applied): the adapters of `init_lora` over the frozen (and,
        with bits 8 / 4, quantized) LM and the projector train; the tower
        and the base stay as they are. Returns (adapter tree, projector)."""
        rcfg, lcfg = self.rcfg, self.rcfg.lora
        total, updates = self._total_steps()
        for _, leaf in leaves_with_paths(self.params):
            leaf.requires_grad_(False)
        lora = init_lora(rcfg.seed, self.params, lcfg)
        opt = make_lora_optimizer(self.tcfg, lcfg, lora, self.params["projector"], updates,
                                  self._step_mesh)
        opt_state = opt.init()
        start_step, opt_state = self.try_resume_lora(lora, opt_state)
        step_fn = make_lora_train_step(self.cfg, lcfg, opt, rcfg.remat)
        self.lora = lora
        self._loop(lambda b: step_fn(lora, self.params, opt_state, b)[2],
                   lambda step: self.save_lora_checkpoint(step, lora, lcfg, opt_state),
                   start_step, total)
        self.opt_state = opt_state
        return lora, self.params["projector"]

    def train(self):
        """Train as `rcfg` says: the LoRA loop when `rcfg.lora` is set, else
        the stage's full path. Returns the params (LoRA: the adapter tree
        and the projector)."""
        if self.rcfg.lora is not None:
            return self._train_lora()
        total, updates = self._total_steps()
        # the schedule advances once per optimizer update (every k micro-steps)
        tcfg = dataclasses.replace(self.tcfg, total_steps=updates)
        if self._step_mesh is not None:
            self.params = shard_params(self.params, self.mesh, self.cfg)
        opt = make_optimizer(tcfg, self.params, self._step_mesh)
        self._opt = opt
        opt_state = opt.init()
        step_fn = make_train_step(self.cfg, opt, self.rcfg.remat)
        start_step, opt_state = self.try_resume(opt_state)
        self._loop(lambda b: step_fn(self.params, opt_state, b)[2],
                   lambda step: self.save_checkpoint(step, opt_state), start_step, total)
        self.finish_pending_saves()
        self.opt_state = opt_state
        return self.params
