"""The port's `dryrun_multichip(n)`: the sharded programs of the JAX
package's `__graft_entry__.dryrun_multichip` on n ranks, one process a
rank, each held to the port's world-of-one result:

- `train`: a Trainer over a ('data', 'model') mesh (tp = 2 where n is
  even): two stage-2 steps of the tiny config from a tiny dataset, then
  two LoRA steps (weight decay 1e-4, one lr: where the JAX LoRA loop
  computes the same), against the same steps without a mesh on the same
  global batches;
- `hd`: HD prefill (slice mode, 4 crops and the global view a sample)
  with the crops split over 'data', logits within 2e-5;
- `serving`: tensor-parallel `Generator` greedy and speculative tokens on
  the tiny config, greedy on its MPT form (ALiBi slopes of the rank's
  heads) and on a 13B-width int8 fused tree at 2 layers (hidden 5120, 40
  heads, intermediate 13824, vocab 512);
- `pipeline`: dp x pp (pp = 4 where n divides by 4, else 2) forward and
  backward against the layer stack on one rank (rtol 1e-5 on the loss,
  3e-4 / 3e-5 on the gradients);
- `batcher`: the paged batcher over a sharded int8 fused tree (prefix
  cache, chunked admission, a cancellation, a concurrent request, no
  page leaked), token for token against the unsharded batcher;
- `lora_batcher`: two adapters and the base model through both batchers
  over the sharded dense and int8 fused trees (`serve_adapters`: on the
  paged batcher the base takes none of an adapter's cached pages), token
  for token against the unsharded batchers;
- `ring`: ring attention over 'data' (causal and not) against full
  attention.

    python -m tokenpacker_tpu_torch.parallel.dryrun --n 4 --device cpu

spawns the n processes (by default on CUDA, where each rank takes
cuda:rank and NCCL; gloo with `--device cpu`; `--one-device --backend
gloo` puts every rank on cuda:0, which NCCL refuses). Rank 0 prints one
OK line a scenario. A caller with scenarios of its own spawns itself
(`launch(script=...)`) and runs them through `main(argv, runners)`. `--weights FILE` (a
`torch.save` of {name: params tree}) replaces the seeded weights, and
`--out FILE` writes rank 0's results, which the CPU tests hold against
the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue as _queue
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from tokenpacker_tpu_torch.parallel.multihost import _to

SCENARIOS = ("train", "hd", "serving", "pipeline", "batcher", "lora_batcher", "ring")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(n: int, argv: list, timeout: float = 120.0,
           module: str = "tokenpacker_tpu_torch.parallel.dryrun",
           env: dict | None = None, rank_flags=None, script: str | None = None) -> list:
    """Run `python -m module --rank r --world n --port P *argv` (or `python
    script ...`) for r < n (`rank_flags(r, n, port)` replaces the three
    flags), one process group each; return their outputs. Every child is killed (its whole group)
    when one fails or the timeout passes, and the error carries the
    outputs' tails."""
    port = free_port()
    rank_flags = rank_flags or (lambda r, n, port: ["--rank", str(r), "--world", str(n),
                                                    "--port", str(port)])
    procs = []
    logs = []
    for r in range(n):
        log = tempfile.TemporaryFile(mode="w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, *([script] if script else ["-m", module]), *rank_flags(r, n, port),
             *argv],
            stdout=log, stderr=subprocess.STDOUT, text=True, start_new_session=True,
            env={**os.environ, **(env or {})}))
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            failed = f"timed out after {timeout:.0f} s"
            break
        bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is None and any(p.returncode != 0 for p in procs):
        failed = "a rank failed"
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs))
        raise RuntimeError(f"dryrun on {n} ranks: {failed}\n{tails}")
    return outs


# -- weights ---------------------------------------------------------------------


def _tiny(**lm):
    from tokenpacker_tpu_torch.config import tiny_vlm_config

    cfg = tiny_vlm_config()
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, **lm)) if lm else cfg


def wide_13b_config():
    """The 13B-width LM of `__graft_entry__._dryrun_13b_tp2_serving`: full
    widths at 2 layers and a vocab of 512, under the tiny tower."""
    from tokenpacker_tpu_torch.config import LMConfig

    return _tiny(**{f.name: getattr(LMConfig(vocab_size=512, hidden_size=5120,
                                             intermediate_size=13824, num_hidden_layers=2,
                                             num_attention_heads=40,
                                             max_position_embeddings=512), f.name)
                    for f in dataclasses.fields(LMConfig)})


def mpt_tiny_config():
    """The tiny config with an MPT LM (ALiBi, tied embedding, MHA)."""
    return _tiny(intermediate_size=256, num_key_value_heads=None, model_family="mpt",
                 alibi=True, tie_word_embeddings=True)


def int8_fused(params):
    """JAX's serving form: fused qkv / gateup, int8 where a stacked leaf has
    at least 2^12 elements (`quantize_tree(fuse_llama_layers(lm), 1 << 12)`)."""
    from tokenpacker_tpu_torch.ops.quantize import fuse_llama_layers, quantize_tree

    return {**params, "lm": quantize_tree(fuse_llama_layers(params["lm"]), min_size=1 << 12)}


def seeded_weights(name: str):
    """The scenario's weights from one seeded CPU generator (the same on
    every rank): fp32."""
    from tokenpacker_tpu_torch.io.weights import init_lm_on_device, init_vlm_on_device
    from tokenpacker_tpu_torch.ops.quantize import fuse_llama_layers, quantize_tree

    seeds = {"train": 0, "hd": 1, "tiny": 3, "wide": 7, "batcher": 11, "pipeline": 3, "mpt": 5}
    if name == "mpt":
        return init_vlm_on_device(mpt_tiny_config(), 5, "cpu", torch.float32)
    if name == "wide":
        return int8_fused(init_vlm_on_device(wide_13b_config(), 7, "cpu", torch.float32))
    if name == "pipeline":
        return init_lm_on_device(_tiny(num_hidden_layers=8).lm, 3, "cpu", torch.float32)
    params = init_vlm_on_device(_tiny(), seeds[name], "cpu", torch.float32)
    if name == "batcher":
        params = {**params, "lm": quantize_tree(fuse_llama_layers(params["lm"]), min_size=1)}
    return params


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.clone() if isinstance(node, torch.Tensor) else node


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tree_np(node):
    if isinstance(node, dict):
        return {k: _tree_np(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_np(v) for v in node]
    return _np(node)


def _close(got, want, rtol, atol, what):
    for (pa, a), (_, b) in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=f"{what}{pa}")


def _flat(node, path=""):
    if isinstance(node, dict):
        for k in node:
            yield from _flat(node[k], f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flat(v, f"{path}/{i}")
    elif node is not None:
        yield path, node


# -- scenarios -------------------------------------------------------------------


class WordTokenizer:
    """A word tokenizer for the dryrun's dataset: BOS and one id a word
    ('</s>', ':' and '<' apart), ids given in order of first sight."""

    bos_token_id = 1
    pad_token_id = 0
    model_max_length = 2048

    def __init__(self):
        import re

        self._pat = re.compile(r"</s>|:|<|[^\s:<]+")
        self.vocab = {}

    def _id(self, w):
        return self.vocab.setdefault(w, 10 + len(self.vocab))

    def __call__(self, text):
        class R:
            pass

        r = R()
        r.input_ids = [self.bos_token_id] + [self._id(w) for w in self._pat.findall(text)]
        return r

    def convert_tokens_to_ids(self, t):
        return self._id(t)


def write_dataset(folder: str, n_images: int = 8) -> tuple[str, str]:
    """A tiny dataset: n_images images of 40 x 52 with one-turn
    conversations (their images cropped to the tiny tower's 56 by the
    loader), as json records and png files."""
    from PIL import Image

    img_dir = os.path.join(folder, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"im{i}.png"))
        records.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat is this"},
            {"from": "gpt", "value": f"object {i} " * (1 + i % 3)}]})
    path = os.path.join(folder, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path, img_dir


def scenario_train(ctx):
    """Two stage-2 Trainer steps and a LoRA step over the mesh, each
    against the same steps without one on rank 0."""
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
    from tokenpacker_tpu_torch.train.lora import LoraConfig, init_lora, make_lora_optimizer
    from tokenpacker_tpu_torch.train.lora import make_lora_train_step
    from tokenpacker_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step
    from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer, device_train_batch
    from tokenpacker_tpu_torch.parallel.sharding import unshard_params

    n, device = ctx["n"], ctx["device"]
    tp = 2 if n % 2 == 0 else 1
    cfg = _tiny()
    work = tempfile.mkdtemp(prefix=f"dryrun-train-{ctx['rank']}-")
    data_path, img_dir = write_dataset(work, 4 * n // tp)
    ds = SupervisedDataset(data_path, WordTokenizer(), image_folder=img_dir,
                           image_size=cfg.vision.image_size)
    tcfg = TrainConfig(stage="finetune", learning_rate=1e-3, mm_projector_lr=2e-3,
                       max_grad_norm=0.5)
    out = {}
    for kind in ("finetune", "lora"):
        lora = LoraConfig(r=4, alpha=8) if kind == "lora" else None
        if lora is not None:  # the settings where the JAX LoRA loop computes the same (R15)
            tcfg = dataclasses.replace(tcfg, weight_decay=1e-4, mm_projector_lr=None)
        rcfg = RunConfig(output_dir=os.path.join(work, kind), per_device_batch_size=2,
                         save_steps=100, seq_pad_to=64, seed=3, tp=tp, lora=lora)
        weights = ctx["weights"]("train")
        trainer = Trainer(cfg, tcfg, rcfg, _to(weights, device), ds, WordTokenizer(),
                          device=device)
        batches = []
        inner = trainer._batches

        def recorded():
            for b in inner():
                batches.append(b)
                yield b

        trainer._batches = recorded
        result = trainer.train()
        if kind == "lora":
            got = {"lora": result[0], "projector": result[1]}
        else:
            got = unshard_params(result)
        losses = [r["loss"] for r in trainer.history]
        if ctx["rank"] == 0:
            ref = _to(ctx["weights"]("train"), device)
            ref_tcfg = dataclasses.replace(tcfg, total_steps=len(batches))
            if kind == "lora":
                for leaf in _leaves(ref):
                    leaf.requires_grad_(False)
                adapters = init_lora(rcfg.seed, ref, lora)
                opt = make_lora_optimizer(tcfg, lora, adapters, ref["projector"], len(batches))
                step = make_lora_train_step(cfg, lora, opt)
                state = opt.init()
                ref_losses = [float(step(adapters, ref, state, device_train_batch(
                    b, cfg.dtype, device))[2]["loss"]) for b in batches]
                want = {"lora": adapters, "projector": ref["projector"]}
            else:
                opt = make_optimizer(ref_tcfg, ref)
                step = make_train_step(cfg, opt)
                state = opt.init()
                ref_losses = [float(step(ref, state, device_train_batch(b, cfg.dtype, device))[2]
                                    ["loss"]) for b in batches]
                want = ref
            np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, err_msg=kind)
            _close(got, want, 3e-4, 3e-5, kind)
            out[kind] = {"losses": losses, "params": _tree_np(got),
                         "batches": [{k: v for k, v in b.items() if k != "mode"}
                                     for b in batches]}
        ctx["say"](f"dryrun train[{kind}]: mesh={dict(trainer.mesh.shape)} "
                   f"losses={[round(x, 6) for x in losses]} == world of one OK")
    return out


def _leaves(node):
    return [t for _, t in _flat(node)]


def hd_batch(cfg, dp: int, seed: int = 1):
    """JAX's `_dryrun_hd_prefill` batch: dp samples of a 2 x 2 grid and the
    global view, slice mode, padded to 64."""
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    ids = np.concatenate([[1], [30, 31], [IMAGE_TOKEN_INDEX], [40, 41, 42]]).astype(np.int64)
    plan = build_splice_plan([ids] * dp, [[(2, 2)]] * dp, cfg.tokens_per_view, "slice",
                             sep_id=3, newline_id=4, pad_id=0, pad_to=64)
    n, l = plan.token_ids.shape
    imgs = np.random.default_rng(seed).standard_normal(
        (dp * 5, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    return {"images": imgs, "token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "positions": np.broadcast_to(np.arange(l), (n, l)).copy(),
            "key_valid": plan.attn_mask, "lengths": plan.lengths}


def hd_logits(params, cfg, batch: dict, device):
    """Next-token logits of each sample after its HD prefill."""
    from tokenpacker_tpu_torch.models.lm_api import lm_logits
    from tokenpacker_tpu_torch.models.vlm import vlm_hidden

    dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "key_valid"}
    for k in ("token_ids", "image_slot", "positions", "lengths"):
        dev[k] = dev[k].long()
    hidden = vlm_hidden(params, cfg, dev)
    idx = (dev["lengths"] - 1).clamp(min=0)
    last = hidden[torch.arange(hidden.shape[0], device=device), idx]
    return lm_logits(params["lm"], cfg.lm, last)


def _mesh(ctx):
    n = ctx["n"]
    return make_mesh(tp=2 if n % 2 == 0 else 1, device=ctx["device"], backend=ctx["backend"])


def scenario_hd(ctx):
    from tokenpacker_tpu_torch.parallel.sharding import shard_params

    mesh, cfg, device = _mesh(ctx), _tiny(), ctx["device"]
    batch = hd_batch(cfg, mesh.shape[DATA_AXIS])
    weights = ctx["weights"]("hd")
    sharded = _to(shard_params(weights, mesh, cfg), device)
    with torch.no_grad(), mesh:
        got = hd_logits(sharded, cfg, batch, device)
    out = {}
    if ctx["rank"] == 0:
        with torch.no_grad():
            want = hd_logits(_to(weights, device), cfg, batch, device)
        _close(got, want, 2e-5, 2e-5, "hd logits")
        out = {"logits": _np(got), "batch": batch}
    ctx["say"](f"dryrun hd: mesh={dict(mesh.shape)} crops={batch['images'].shape[0]} "
               f"sharded == world of one OK")
    return out


def serving_batch(cfg, seed: int, mode: str = "single"):
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    rng = np.random.default_rng(seed)
    if mode == "single":
        ids = np.array([1, 17, 23, IMAGE_TOKEN_INDEX, 40, 41], dtype=np.int64)
        plan = build_splice_plan([ids], [[(1, 1)]], cfg.tokens_per_view, "single", 7, 8, 0,
                                 pad_to=24)
        views = 1
    else:  # JAX's 13B dryrun: HD 2 x 2 and the global view
        ids = np.concatenate([[1], [30, 31], [IMAGE_TOKEN_INDEX], [40, 41, 42]]).astype(np.int64)
        plan = build_splice_plan([ids], [[(2, 2)]], cfg.tokens_per_view, "slice", sep_id=3,
                                 newline_id=4, pad_id=0, pad_to=96)
        views = 5
    imgs = rng.standard_normal((views, cfg.vision.image_size, cfg.vision.image_size, 3))
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths,
            "images": imgs.astype(np.float32)}


def scenario_serving(ctx):
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.parallel.sharding import shard_params

    mesh, device = _mesh(ctx), ctx["device"]
    out = {}
    cases = (("tiny", _tiny(), "single", 5, 0), ("tiny_spec", _tiny(), "single", 8, 3),
             ("mpt", mpt_tiny_config(), "single", 5, 0),
             ("wide", wide_13b_config(), "slice", 4, 0))
    for name, cfg, mode, new, spec in cases:
        weights = ctx["weights"]("tiny" if name.startswith("tiny") else name)
        batch = serving_batch(cfg, 7 if name == "wide" else (3 if spec else 0), mode)
        sharded = _to(shard_params(weights, mesh, cfg), device)
        with mesh:
            got = Generator(sharded, cfg).generate(batch, max_new_tokens=new,
                                                   speculative=spec).sequences[0]
        del sharded
        if ctx["rank"] == 0:
            want = Generator(_to(weights, device), cfg).generate(batch, max_new_tokens=new,
                                                                 speculative=spec).sequences[0]
            assert got == want, f"{name}: {got} vs {want}"
            out[name] = {"tokens": got, "batch": batch}
        ctx["say"](f"dryrun serving[{name}]: mesh={dict(mesh.shape)} tokens={got} == world "
                   "of one OK")
    return out


def text_request(prompt) -> dict:
    ids = np.asarray(prompt, np.int64)[None]
    return {"token_ids": ids, "is_image": np.zeros_like(ids, bool),
            "image_slot": np.zeros_like(ids, np.int32), "lengths": np.array([ids.shape[1]]),
            "images": None}


def batcher_scenario(params, cfg, device, leader: bool = True, page_size: int = 4,
                     chunk: int = 8, prompts=(list(range(2, 10)), list(range(3, 15))),
                     new: int = 6):
    """`__graft_entry__._dryrun_tp_serving_batcher`'s run: a cold admission,
    a warm one (prefix hit), a cancellation beside a concurrent request,
    then the pages leaked. On a lockstep batcher's other ranks: start and
    wait for rank 0's stop."""
    from tokenpacker_tpu_torch.serve.scheduler import PagedContinuousBatcher

    req = text_request
    p1, p2 = prompts
    batcher = PagedContinuousBatcher(params, cfg, num_slots=2, num_pages=64, page_size=page_size,
                                     max_pages_per_seq=16, prefix_cache=True,
                                     prefill_chunk_size=chunk, device=device)
    free0 = batcher.allocator.available()
    batcher.start()
    if not leader:
        batcher.stop()
        return None
    try:
        cold = batcher.submit(req(p1), max_new_tokens=new, temperature=0.0).result(timeout=300)
        warm = batcher.submit(req(p1), max_new_tokens=new, temperature=0.0).result(timeout=300)
        reused = batcher.prefix.tokens_reused
        q: _queue.Queue = _queue.Queue()
        fut_c = batcher.submit(req(p2), max_new_tokens=64, temperature=0.0, on_token=q.put)
        fut_d = batcher.submit(req(p1), max_new_tokens=new, temperature=0.0)
        for _ in range(2):
            q.get(timeout=300)
        batcher.cancel(fut_c)
        cancelled = fut_c.result(timeout=300)
        other = fut_d.result(timeout=300)
        leaked = pages_leaked(batcher, free0)
    finally:
        batcher.stop()
    return {"cold": cold, "warm": warm, "cancelled": cancelled, "other": other,
            "reused": reused, "leaked": leaked}


def pages_leaked(batcher, free0: int) -> int:
    """The pages a paged batcher holds beyond its prefix cache's once its
    slots drain (waits up to 120 s for them to)."""
    deadline = time.time() + 120
    retained = len(batcher.prefix.blocks)  # one page a block
    while batcher.allocator.available() != free0 - retained and time.time() < deadline:
        time.sleep(0.05)
        retained = len(batcher.prefix.blocks)
    return free0 - retained - batcher.allocator.available()


def lora_adapters(lm_cfg, seed: int = 21, ranks=None, scales=None) -> dict:
    """{name: (lora, r)}, float32 numpy from one seeded generator, each over
    the seven targets: by default "ad_a" of rank 4 at scale 0.3 and "ad_b"
    of rank 2 at scale 0.02 (the mixed-rank pair of the JAX package's
    multi-LoRA tests), else one adapter per name of `ranks` at
    `scales[name]`. `serve/multi_lora.Adapter(lora, r)` takes them, as the
    JAX package's Adapter does."""
    from tokenpacker_tpu_torch.serve.multi_lora import TARGETS, target_dims

    ranks = ranks or {"ad_a": 4, "ad_b": 2}
    scales = scales or {"ad_a": 0.3, "ad_b": 0.02}
    rng = np.random.default_rng(seed)
    dims, n_layers = target_dims(lm_cfg), lm_cfg.num_hidden_layers

    def make(r, scale):
        return {t: ((scale * rng.standard_normal((n_layers, dims[t][0], r))).astype(np.float32),
                    (scale * rng.standard_normal((n_layers, r, dims[t][1]))).astype(np.float32))
                for t in TARGETS}

    return {name: (make(r, scales[name]), r) for name, r in ranks.items()}


def serve_adapters(batcher, prompts, new: int, paged: bool, base_only: bool = False) -> dict:
    """Multi-LoRA traffic through a started batcher (either package's):
    adapter "ad_a" on prompts[0] beside "ad_b" on prompts[1], then the base
    model on prompts[0], then "ad_a" on prompts[0] again. Returns the four
    requests' greedy tokens and, on a paged batcher, the prompt tokens the
    last two took from the prefix cache (the base none of ad_a's pages,
    the repeat ad_a's) and the pages leaked. `base_only` (a batcher with
    no adapter loaded): the base request alone."""
    p1, p2 = prompts
    free0 = batcher.allocator.available() if paged else 0

    def base():
        return batcher.submit(text_request(p1), max_new_tokens=new,
                              temperature=0.0).result(timeout=300)

    if base_only:
        return {"tokens": [base()], "reused": [],
                "leaked": pages_leaked(batcher, free0) if paged else 0}
    futs = [batcher.submit(text_request(p), max_new_tokens=new, temperature=0.0, adapter=a)
            for p, a in ((p1, "ad_a"), (p2, "ad_b"))]
    tokens = [f.result(timeout=300) for f in futs]
    reused = []
    for adapter in (None, "ad_a"):
        before = batcher.prefix.tokens_reused if paged else 0
        tokens.append(batcher.submit(text_request(p1), max_new_tokens=new, temperature=0.0,
                                     adapter=adapter).result(timeout=300))
        reused.append(batcher.prefix.tokens_reused - before if paged else 0)
    return {"tokens": tokens, "reused": reused,
            "leaked": pages_leaked(batcher, free0) if paged else 0}


LORA_PROMPTS = (list(range(2, 10)), list(range(30, 42)))


def lora_batcher(params, cfg, kind: str, adapters: dict | None, device, page_size: int = 4,
                 chunk: int = 8, max_seq_len: int = 64):
    """The port's dense ("dense") or paged ("paged": prefix cache, chunked
    admission) batcher of the `lora_batcher` scenario, over 2 slots."""
    from tokenpacker_tpu_torch.serve.scheduler import ContinuousBatcher, PagedContinuousBatcher

    if kind == "dense":
        return ContinuousBatcher(params, cfg, num_slots=2, max_seq_len=max_seq_len,
                                 adapters=adapters, device=device)
    return PagedContinuousBatcher(params, cfg, num_slots=2, num_pages=64, page_size=page_size,
                                  max_pages_per_seq=max_seq_len // page_size, prefix_cache=True,
                                  prefill_chunk_size=chunk, adapters=adapters, device=device)


def lora_batcher_scenario(params, cfg, kind: str, adapters: dict | None, device,
                          leader: bool = True, prompts=LORA_PROMPTS, new: int = 6, **sizes):
    """`serve_adapters` through `lora_batcher(..., **sizes)` (with adapters
    None: the base request alone, no adapter loaded); on a lockstep
    batcher's other ranks: start and wait for rank 0's stop."""
    batcher = lora_batcher(params, cfg, kind, adapters, device, **sizes)
    batcher.start()
    if not leader:
        batcher.stop()
        return None
    try:
        return serve_adapters(batcher, prompts, new, kind == "paged", adapters is None)
    finally:
        batcher.stop()


def check_batcher(got: dict, ref: dict):
    assert got["cold"] == ref["cold"], (got["cold"], ref["cold"])
    assert got["warm"] == ref["warm"] == ref["cold"], got["warm"]
    assert got["other"] == ref["other"], (got["other"], ref["other"])
    n = min(len(got["cancelled"]), len(ref["cancelled"]))
    assert n >= 2 and got["cancelled"][:n] == ref["cancelled"][:n], (got["cancelled"],
                                                                     ref["cancelled"])
    assert got["reused"] > 0 and ref["reused"] > 0, "prefix cache never hit"
    assert got["leaked"] == 0 and ref["leaked"] == 0, (got["leaked"], ref["leaked"])


def scenario_batcher(ctx):
    from tokenpacker_tpu_torch.parallel.sharding import shard_params

    mesh, cfg, device = _mesh(ctx), _tiny(), ctx["device"]
    weights = ctx["weights"]("batcher")
    leader = ctx["rank"] == 0
    ref = batcher_scenario(_to(weights, device), cfg, device) if leader else None
    got = batcher_scenario(_to(shard_params(weights, mesh, cfg), device), cfg, device, leader)
    if not leader:
        return {}
    check_batcher(got, ref)
    ctx["say"](f"dryrun batcher: mesh={dict(mesh.shape)} paged batcher (prefix cache, chunked "
               f"admission, cancellation) sharded == world of one OK (tokens={got['cold']}, "
               f"reused={got['reused']})")
    return {"got": got, "ref": ref}


def lora_trees(weights) -> dict:
    """The `lora_batcher` scenario's trees, {name: (params, cfg)}: the tiny
    config's dense tree ("fp32", the `tiny` weights) and its int8 fused
    tree ("int8", the `batcher` weights). Both keep the tiny config's fp32
    activations: in bf16 the tiny LM's top-2 logits lie within a rounding
    of each other (0.002 apart under ad_a), so a rank's partial sums flip
    tokens that no exact comparison could hold."""
    cfg = _tiny()
    return {"fp32": (weights("tiny"), cfg), "int8": (weights("batcher"), cfg)}


def scenario_lora_batcher(ctx):
    from tokenpacker_tpu_torch.parallel.sharding import shard_params
    from tokenpacker_tpu_torch.serve.multi_lora import Adapter

    mesh, device = _mesh(ctx), ctx["device"]
    adapters = {n: Adapter(lora, r) for n, (lora, r) in lora_adapters(_tiny().lm).items()}
    leader = ctx["rank"] == 0
    out = {}
    for tree, (weights, cfg) in lora_trees(ctx["weights"]).items():
        sharded = _to(shard_params(weights, mesh, cfg), device)
        for kind in ("dense", "paged"):
            got = lora_batcher_scenario(sharded, cfg, kind, adapters, device, leader)
            if not leader:
                continue
            ref = lora_batcher_scenario(_to(weights, device), cfg, kind, adapters, device)
            assert got == ref, (tree, kind, got, ref)
            assert got["leaked"] == 0 and got["tokens"][0] == got["tokens"][3], got
            if kind == "paged":
                assert got["reused"][0] == 0 < got["reused"][1], got["reused"]
            out[f"{tree}/{kind}"] = got
    ctx["say"](f"dryrun lora_batcher: mesh={dict(mesh.shape)} two adapters and the base through "
               f"both batchers on the dense and the int8 fused tree, sharded == world of one OK "
               f"({out.get('int8/paged')})")
    return out


def pipeline_inputs(lm_cfg, b: int, t: int = 16, seed: int = 3):
    x = np.random.default_rng(seed).standard_normal((b, t, lm_cfg.hidden_size))
    return x.astype(np.float32)


def pipeline_grads(params, lm_cfg, x, mesh, m: int, device):
    """(loss, {leaf path: grad}) of mean(h^2) through the pipeline on this
    stage's tree; the layers' paths are global ('layers/i/...')."""
    from tokenpacker_tpu_torch.parallel.pipeline import (
        STAGE_AXIS,
        pipeline_llama_hidden,
        shard_pp_params,
        sync_stage_grads,
    )

    local = _to(shard_pp_params(params, mesh), device)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=device).expand(b, t)
    key_valid = torch.ones((b, t), dtype=torch.bool, device=device)
    leaves = dict(_flat(local))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    h = pipeline_llama_hidden(local, lm_cfg, torch.as_tensor(x).to(device), positions, key_valid,
                              mesh, num_microbatches=m)
    loss = h.float().square().mean()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    per = len(local["layers"])
    first = mesh.coords[STAGE_AXIS] * per
    named = {}
    for path, g in zip(leaves, grads):
        parts = path.strip("/").split("/")
        if parts[0] == "layers":
            parts[1] = str(int(parts[1]) + first)
        named["/".join(parts)] = g
    return loss, sync_stage_grads(named, mesh)


def reference_stack_grads(params, lm_cfg, x, device):
    """The same loss through `llama_apply` on one rank."""
    from tokenpacker_tpu_torch.models.llama import llama_apply

    p = _to(params, device)
    leaves = dict(_flat(p))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    b, t = x.shape[:2]
    h = llama_apply(p, lm_cfg, torch.as_tensor(x).to(device),
                    torch.arange(t, device=device).expand(b, t))
    loss = h.float().square().mean()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return loss, {path.strip("/"): g for path, g in zip(leaves, grads)}


def scenario_pipeline(ctx):
    from tokenpacker_tpu_torch.parallel.pipeline import make_pp_mesh

    n, device = ctx["n"], ctx["device"]
    pp = 4 if n % 4 == 0 and ctx.get("pp", 0) != 2 else 2
    mesh = make_pp_mesh(pp=pp, dp=n // pp, device=device, backend=ctx["backend"])
    lm = _tiny(num_hidden_layers=2 * pp).lm
    params = ctx["weights"]("pipeline")
    params = {**params, "layers": params["layers"][:2 * pp]}
    m = 2
    x = pipeline_inputs(lm, (n // pp) * m * 2)
    loss, grads = pipeline_grads(params, lm, x, mesh, m, device)
    everything = [None] * n
    dist.all_gather_object(everything, {k: _np(g) for k, g in grads.items()})
    out = {}
    if ctx["rank"] == 0:
        merged = {}
        for part in everything:
            merged.update(part)
        want_loss, want = reference_stack_grads(params, lm, x, device)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()), rtol=1e-5)
        assert sorted(merged) == sorted(want), (sorted(merged), sorted(want))
        for k in want:
            np.testing.assert_allclose(merged[k], _np(want[k]), rtol=3e-4, atol=3e-5, err_msg=k)
        out = {"loss": float(loss.detach()), "grads": merged, "x": x, "pp": pp, "dp": n // pp,
               "layers": 2 * pp}
    ctx["say"](f"dryrun pipeline: dp={n // pp} x pp={pp} fwd+bwd == one rank OK "
               f"(loss={float(loss.detach()):.5f})")
    return out


def full_attention(q, k, v, causal: bool):
    """[N, T, H, D] attention in fp32 (the reference of the ring)."""
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=q.device).tril(), -1e30)
    return torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1), v.float())


def scenario_ring(ctx):
    from tokenpacker_tpu_torch.ops.ring_attention import ring_attention
    from tokenpacker_tpu_torch.parallel import comm

    n, device = ctx["n"], ctx["device"]
    mesh = make_mesh(dp=n, tp=1, device=device, backend=ctx["backend"])
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 16 * n, 4, 16)), dtype=torch.float32)
               .to(device) for _ in range(3))
    ax = mesh.axis(DATA_AXIS)
    out = {}
    for causal in (True, False):
        mine = [t.chunk(n, dim=1)[ax.index].contiguous() for t in (q, k, v)]
        got = comm.all_gather(ring_attention(*mine, mesh, "data", causal), 1, ax)
        want = full_attention(q, k, v, causal)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
        out[causal] = _np(got)
    out["qkv"] = [_np(t) for t in (q, k, v)]
    ctx["say"](f"dryrun ring: {n} ranks, causal and not == full attention OK")
    return out


def scenario_probe(ctx):
    """One all-reduce over the world (does the backend take these ranks?)."""
    t = torch.ones(4, device=ctx["device"])
    dist.all_reduce(t)
    assert t.tolist() == [float(ctx["n"])] * 4
    ctx["say"](f"dryrun probe: all_reduce over {ctx['n']} ranks on {ctx['device']} OK")
    return {}


RUNNERS = {"train": scenario_train, "hd": scenario_hd, "serving": scenario_serving,
           "pipeline": scenario_pipeline, "batcher": scenario_batcher, "ring": scenario_ring,
           "lora_batcher": scenario_lora_batcher, "probe": scenario_probe}


def child(args, runners: dict = RUNNERS):
    from tokenpacker_tpu_torch.parallel.multihost import init_process

    device = args.device
    if device == "cuda":
        device = f"cuda:{0 if args.one_device else args.rank}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_process(f"127.0.0.1:{args.port}", args.world, args.rank, device, args.backend)
    loaded = torch.load(args.weights, map_location="cpu", weights_only=True,
                        mmap=True) if args.weights else {}

    def weights(name):
        # a private copy (a run updates its tree in place), but the wide
        # tree is only read, and shared through the file's mapping
        if name not in loaded:
            return seeded_weights(name)
        return loaded[name] if name == "wide" else _clone(loaded[name])

    results = {}
    ctx = {"n": args.world, "rank": args.rank, "device": device, "backend": args.backend,
           "weights": weights, "pp": args.pp,
           "say": (lambda msg: print(msg, flush=True)) if args.rank == 0 else (lambda msg: None)}
    try:
        for name in args.scenarios.split(","):
            t0 = time.perf_counter()
            results[name] = runners[name](ctx)
            dist.barrier()
            if args.rank == 0:
                print(f"  ({name}: {time.perf_counter() - t0:.2f} s)", flush=True)
        if args.rank == 0 and args.out:
            torch.save(results, args.out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda", backend: str | None = None,
                     scenarios=SCENARIOS, timeout: float = 900.0) -> str:
    """Run the scenarios on n ranks (spawned here); returns rank 0's
    output, raising if a rank fails."""
    argv = ["--device", device, "--scenarios", ",".join(scenarios)]
    if backend:
        argv += ["--backend", backend]
    return launch(n, argv, timeout)[0]


def main(argv=None, runners: dict = RUNNERS):
    """The CLI; a spawned rank (`--rank`) runs `runners`' scenarios."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=4, help="ranks to spawn")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--backend", default=None, help="name the backend (default: by device)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pp", type=int, default=0, help="2: the pipeline at pp = 2 on any n")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--one-device", action="store_true",
                    help="every rank on cuda:0 (two ranks on one card: name --backend gloo)")
    # a spawned rank's own flags
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        child(args, runners)
        return
    extra = ["--device", args.device, "--scenarios", args.scenarios, "--pp", str(args.pp)]
    if args.one_device:
        extra.append("--one-device")
    for flag in ("backend", "weights", "out"):
        if getattr(args, flag):
            extra += [f"--{flag}", getattr(args, flag)]
    print(launch(args.n, extra, args.timeout)[0], end="")


if __name__ == "__main__":
    main()
