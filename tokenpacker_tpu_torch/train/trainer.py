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

`Trainer.train()` runs on the device the parameters live on, CUDA unless
the caller asks for the CPU (`device="cpu"`); a parameter on another
device raises. Tensor parallelism (`tp > 1`) and LoRA / QLoRA
(`lora`, `bits`) are not ported yet (ROADMAP queue 1) and raise.
"""

from __future__ import annotations

import dataclasses
import glob
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
from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker
from tokenpacker_tpu_torch.train.step import (
    TrainConfig,
    leaves_with_paths,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger(__name__)


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
    bits: int = 16
    lora: object = None
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
        if rcfg.tp > 1:
            raise NotImplementedError("tp > 1: tensor parallelism is not ported yet "
                                      "(ROADMAP queue 1, training and parallelism)")
        if rcfg.lora is not None or rcfg.bits != 16:
            raise NotImplementedError("LoRA / QLoRA training is not ported yet "
                                      "(ROADMAP queue 1, with K6 and train/lora)")
        if rcfg.remat and cfg.lm.model_family == "mpt":
            raise ValueError(f"remat={rcfg.remat!r}: MPT has no rematerialization (nor has the "
                             "JAX package's mpt_apply)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.rcfg = rcfg
        self.device = torch.device(device)
        for path, leaf in leaves_with_paths(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameter {'/'.join(map(str, path))} is on {leaf.device}, "
                                 f"the trainer runs on {self.device}")
        self.params = params
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

    # -- data --------------------------------------------------------------

    def _batches(self):
        rcfg = self.rcfg
        bs = rcfg.per_device_batch_size
        if len(self.dataset) < bs:
            raise ValueError(f"dataset ({len(self.dataset)} samples) smaller than one batch "
                             f"({bs}); training would silently run zero steps")
        if rcfg.group_by_modality_length:
            order = list(iter(LengthGroupedSampler(bs, 1, self.dataset.modality_lengths,
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

    def save_checkpoint(self, step: int, opt_state=None):
        out = os.path.join(self.rcfg.output_dir, f"checkpoint-{step}")
        os.makedirs(out, exist_ok=True)
        if self.tcfg.stage == "pretrain":
            self.save_mm_projector(os.path.join(out, "mm_projector.bin"))
        else:
            # one write in flight: the host copy is taken here, so training
            # may update the parameters in place while the file is written
            self.finish_pending_saves()
            state = {"params": _to_host(self.params), "step": step}
            if opt_state is not None:
                state["opt_state"] = _to_host(opt_state)
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
        sd = export_tokenpacker(self.params["projector"])
        torch.save({f"model.mm_projector.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)

    def _prune_checkpoints(self):
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
        _copy_into(self.params, restored["params"])
        if opt_state is not None and "opt_state" in restored:
            opt_state = _copy_into(opt_state, restored["opt_state"])
        step = restored.get("step") or int(re.search(r"checkpoint-(\d+)$", ckpt).group(1))
        logger.info("resumed from %s at step %d", ckpt, step)
        return int(step), opt_state

    # -- main loop ---------------------------------------------------------

    def train(self):
        rcfg, tcfg = self.rcfg, self.tcfg
        n_batches = len(self.dataset) // rcfg.per_device_batch_size
        total_steps = max(n_batches * rcfg.num_train_epochs, 1)
        # the schedule advances once per optimizer update (every k micro-steps)
        accum = max(tcfg.gradient_accumulation_steps, 1)
        tcfg = dataclasses.replace(tcfg, total_steps=max(total_steps // accum, 1))

        opt = make_optimizer(tcfg, self.params)
        opt_state = opt.init()
        step_fn = make_train_step(self.cfg, opt, rcfg.remat)
        start_step, opt_state = self.try_resume(opt_state)
        step = start_step
        cuda = self.device.type == "cuda"
        self.history = []
        for _ in range(rcfg.num_train_epochs):
            for batch in self._batches():
                if cuda:
                    torch.cuda.reset_peak_memory_stats(self.device)
                t0 = time.perf_counter()
                dev_batch = device_train_batch(batch, self.cfg.dtype, self.device)
                _, opt_state, metrics = step_fn(self.params, opt_state, dev_batch)
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
                    self.save_checkpoint(step, opt_state)
        self.save_checkpoint(step, opt_state)
        self.finish_pending_saves()
        self.opt_state = opt_state
        return self.params
