"""Stage-1 pretraining through `train/trainer.Trainer.train()`, as
`python -m tokenpacker_tpu_torch.train.train` runs it (sequences padded to
model_max_length), over caption records written from the seed.

One trainer object, one `train()` call: set-up drives its first updates
(the ones the reference follows) through the same call and feed as the
window, and the window opens when they are done. The feed (the dataset the
trainer reads) watches the records it hands out: it notes the first update's
optimizer state and the projector after the followed updates, and closes the
window at the first update boundary after `seconds`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from types import SimpleNamespace

import numpy as np

from benchlib import stats
from benchlib.checks import train_readings
from benchlib.drivers import Outcome, free_device, memory_peak, now
from benchlib.model import leaves, make_weights, program_config
from benchlib.trace import DeviceTrace
from benchlib.traffic import caption_records, image_sizes, subseed


class WordIds:
    """The tokenizer of the caption records: a word "t<n>" is token n; "," and
    a newline are the configuration's separator and newline ids. No BOS, as
    MPT's GPT-NeoX tokenizer adds none."""

    bos_token_id = None

    def __init__(self, tok: dict):
        self.pad_token_id = tok["pad_id"]
        self.special = {",": tok["sep_id"], "\n": tok["newline_id"]}

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.special[token]

    def __call__(self, text: str):
        words = re.findall(r"\n|[^\s]+", text)
        return SimpleNamespace(input_ids=[self.special.get(w) or int(w[1:]) for w in words])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids)


class WindowClosed(Exception):
    """Raised from the feed to end `train()` at the window's close."""


def visit_order(n: int, seed: int) -> np.ndarray:
    """The trainer's record order without length grouping: one numpy
    permutation from its seed (`Trainer._batches`)."""
    return np.random.default_rng(seed).permutation(n)


def write_records(root: str, traffic: dict, conf: dict, seed: int) -> tuple[str, list]:
    """Caption records and their pictures under `root`: `distinct_images`
    smooth pictures of the mix's sizes (a coarse random field, bicubic-
    resized), shared round-robin, each record with its own caption."""
    from PIL import Image

    per_update = traffic["per_device_batch_size"] * traffic["gradient_accumulation_steps"]
    n = per_update * traffic["updates"]
    records = caption_records(traffic, conf, seed, visit_order(n, traffic["trainer_seed"]))
    rng = np.random.default_rng(subseed(seed, 9))
    sizes = image_sizes(traffic["images"], traffic["distinct_images"])
    for k, (w, h) in enumerate(sizes):
        coarse = rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BICUBIC).save(os.path.join(root, f"im{k}.png"))
    rows = [{"id": str(i), "image": f"im{r['image']}.png",
             "conversations": [{"from": "human", "value": "<image>\n"},
                               {"from": "gpt", "value": " ".join(f"t{t}" for t in r["caption_ids"])}]}
            for i, r in enumerate(records)]
    path = os.path.join(root, "captions.json")
    with open(path, "w") as f:
        json.dump(rows, f)
    return path, records


def run(ctx) -> Outcome:
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
    from tokenpacker_tpu_torch.train.step import TrainConfig
    from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer

    conf, traffic, device = ctx.conf, ctx.traffic, ctx.device
    cfg = program_config(conf)
    tok = WordIds(conf["assumed"]["tokenizer"])
    k = traffic["gradient_accumulation_steps"]
    bs = traffic["per_device_batch_size"]
    setup_micro = traffic["setup_updates"] * k
    root = tempfile.mkdtemp(prefix="bench-pretrain-")
    try:
        path, records = write_records(root, traffic, conf, ctx.seed)
        weights = make_weights(conf, subseed(ctx.seed, 100), device)
        proj_leaves = leaves(weights["projector"])
        p0 = [t.detach().clone() for _, t in proj_leaves]
        ds = SupervisedDataset(path, tok, image_folder=root, version="plain",
                               image_size=conf["vision"]["image_size"],
                               model_max_length=traffic["seq_pad_to"])
        marks = {"taken": []}
        tracer = DeviceTrace(device) if ctx.trace else None
        trace_from = setup_micro + traffic["trace"]["skip_micro_steps"]

        class Observed(Trainer):
            """The trainer as it is, with its live optimizer state in view."""

            def try_resume(self, opt_state=None):
                step, state = super().try_resume(opt_state)
                marks["opt_state"] = state
                return step, state

        def on_item(pos: int):
            if pos % bs:
                return
            m = pos // bs  # micro-steps completed
            if m == k:
                marks["mu"] = [t.detach().clone() for t in marks["opt_state"]["mu"]["projector"]]
            if m == setup_micro:
                marks["p_end"] = [t.detach().clone() for _, t in proj_leaves]
                marks["start"] = now()
            if tracer is not None and m == trace_from:
                t = now()
                tracer.start()
                tracer.begin()
                marks["trace_cost"] = now() - t
            if tracer is not None and m == trace_from + traffic["trace"]["micro_steps"]:
                t = now()
                tracer.stop()
                marks["trace_cost"] += now() - t
            if m > setup_micro and (m - setup_micro) % k == 0 and \
                    now() - marks["start"] >= ctx.seconds and \
                    (tracer is None or m >= trace_from + traffic["trace"]["micro_steps"]):
                marks["end"] = now()
                raise WindowClosed

        class Feed:
            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                on_item(len(marks["taken"]))
                marks["taken"].append(i)
                return ds[i]

        rcfg = RunConfig(output_dir=os.path.join(root, "out"), per_device_batch_size=bs,
                         seq_pad_to=traffic["seq_pad_to"], save_steps=10**9,
                         seed=traffic["trainer_seed"])
        tcfg = TrainConfig(stage="pretrain", learning_rate=traffic["learning_rate"],
                           warmup_ratio=traffic["warmup_ratio"],
                           max_grad_norm=traffic["max_grad_norm"],
                           gradient_accumulation_steps=k)
        trainer = Observed(cfg, tcfg, rcfg, weights, Feed(), tok, device=device)
        try:
            trainer.train()
        except WindowClosed:
            pass
        history = trainer.history
        if "end" not in marks:
            raise RuntimeError(f"the {len(ds)} records ran out before the window of "
                               f"{ctx.seconds} s closed")
        peak = memory_peak(device)
        del trainer, marks["opt_state"]
        free_device(device)
        taken = marks["taken"]
        window = [r for r in history if r["step"] > setup_micro]
        n_steps = len(window)
        valid = sum(_valid(records[i], cfg.tokens_per_view) for i in taken[setup_micro * bs:
                                                                            (setup_micro + n_steps) * bs])
        length = marks["end"] - marks["start"] - marks.get("trace_cost", 0.0)
        out = Outcome(window_start=marks["start"], attempted=n_steps,
                      failed=sum(1 for r in window if not np.isfinite(r["loss"])), checks=[],
                      memory_peak=peak,
                      e2e={"train_tok_per_s": stats.per_second(valid, 0.0, length)})
        seqs = [[(_valid(records[i], cfg.tokens_per_view), len(records[i]["caption_ids"]) + 1)
                 for i in taken[(setup_micro + j) * bs:(setup_micro + j + 1) * bs]]
                for j in range(n_steps)]
        out.data = {"window_s": length, "steps": seqs,
                    "peak_bytes": [r["peak_bytes"] for r in window if "peak_bytes" in r]}
        if tracer is not None:
            out.trace = tracer.summary()
        out.checks += _check(ctx, weights, conf, traffic, root, records, taken, history,
                             [t for t in p0], marks, proj_leaves)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _valid(record: dict, tokens_per_view: int) -> int:
    """Spliced positions of a record: the view, the caption and the newline."""
    return tokens_per_view + len(record["caption_ids"]) + 1


def micro_batches(traffic, conf, root, records, taken, n_micro) -> list:
    """The reference's inputs of the first micro-steps, worked out from the
    record files: pad-mode pixels and (ids with the image hole, labels)."""
    import torch

    from reference.image import pad_mode_pixels

    bs = traffic["per_device_batch_size"]
    nl = conf["assumed"]["tokenizer"]["newline_id"]
    size = conf["vision"]["image_size"]
    out = []
    for m in range(n_micro):
        idx = taken[m * bs:(m + 1) * bs]
        pix = np.stack([pad_mode_pixels(os.path.join(root, f"im{records[i]['image']}.png"), size)
                        for i in idx])
        samples = []
        for i in idx:
            cap = [int(t) for t in records[i]["caption_ids"]]
            ids = [-200] + cap + [nl]
            samples.append((ids, [-100] + cap + [nl]))
        out.append((torch.from_numpy(pix), samples))
    return out


def _check(ctx, weights, conf, traffic, root, records, taken, history, p0, marks,
           proj_leaves) -> list:
    """The followed updates against the reference: each micro-step's loss,
    the first update's gradient (the optimizer's first moment over 1 - b1),
    the projector's change after the last followed update, each by its worst
    leaf."""
    from reference import exact_float32, train
    from reference.precision import Float32

    exact_float32()
    k = traffic["gradient_accumulation_steps"]
    n_micro = traffic["setup_updates"] * k
    if len(set(taken[:n_micro * traffic["per_device_batch_size"]])) != \
            n_micro * traffic["per_device_batch_size"]:
        return [("distinct_rows", 0, 1, ">=")]
    batches = [(px.to(ctx.device), s) for px, s in
               micro_batches(traffic, conf, root, records, taken, n_micro)]
    recipe = {"gradient_accumulation_steps": k, "learning_rate": traffic["learning_rate"],
              "updates": traffic["updates"], "warmup_ratio": traffic["warmup_ratio"],
              "max_grad_norm": traffic["max_grad_norm"]}
    start = _with_projector(weights, proj_leaves, p0)
    ref = train.follow(start, conf, recipe, batches, Float32())
    paths = [p for p, _ in proj_leaves]
    b1 = 0.9  # the first moment after one update is (1 - b1) times its gradient
    got = {"losses": [r["loss"] for r in history[:n_micro]],
           "first_grad": {q: m.float() / (1 - b1) for q, m in zip(paths, marks["mu"])},
           "change": {q: a.float() - b.float() for q, a, b in zip(paths, marks["p_end"], p0)}}
    readings = train_readings(got, ref)
    ctx.cases = (start, recipe, batches, ref, got)
    free_device(ctx.device)
    lim = ctx.limits
    return [(name, value, lim[f"train_{name}"], "<=") for name, value in readings.items()]


def _with_projector(weights, proj_leaves, p0):
    """The weights with the projector as it was before training."""
    tree = _copy(weights["projector"])
    for (path, _), t in zip(proj_leaves, p0):
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = t
    return {**weights, "projector": tree}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree
