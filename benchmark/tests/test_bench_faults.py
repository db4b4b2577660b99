"""The harness drives a whole run on the CPU (past its look for a card) with
the timed path broken underneath, and `correct` comes out false: once for
each fault the cell can have. The cells run on one card, so no exchange
between cards exists to leave out."""

from __future__ import annotations

import copy

import pytest

import run as bench_run


def cache_copy(cache):
    """The same cache object over copies of its rows: a step that writes
    here leaves the batcher's or engine's own cache unchanged."""
    c = copy.copy(cache)
    c.k, c.v = cache.k.clone(), cache.v.clone()
    return c


def step_unchanged(monkeypatch, module, name):
    real = getattr(module, name)

    def broken(params, cfg, cache, *args, **kwargs):
        logits, _ = real(params, cfg, cache_copy(cache), *args, **kwargs)
        return logits, cache

    monkeypatch.setattr(module, name, broken)


def token_altered(monkeypatch, module):
    real = module.sample_tokens

    def broken(logits, *args, **kwargs):
        tok = real(logits, *args, **kwargs)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(module, "sample_tokens", broken)


def chat_faults(monkeypatch, fault):
    from tokenpacker_tpu_torch.serve import scheduler

    if fault == "step_unchanged":
        step_unchanged(monkeypatch, scheduler, "decode_step_cb")
    elif fault == "token_altered":
        token_altered(monkeypatch, scheduler)
    else:  # half_batch: the second half of the slots gets the first half's logits
        real = scheduler.decode_step_cb

        def broken(*args, **kwargs):
            logits, cache = real(*args, **kwargs)
            n = logits.shape[0] // 2
            logits = logits.clone()
            logits[n:2 * n] = logits[:n]
            return logits, cache

        monkeypatch.setattr(scheduler, "decode_step_cb", broken)


def offline_faults(monkeypatch, fault):
    from tokenpacker_tpu_torch import generate

    if fault == "step_unchanged":
        step_unchanged(monkeypatch, generate, "decode_step")
    elif fault == "token_altered":
        token_altered(monkeypatch, generate)
    else:  # half_batch: the second half of the batch answers from the first half's logits
        real = generate.prefill

        def broken(*args, **kwargs):
            logits, cache = real(*args, **kwargs)
            n = logits.shape[0] // 2
            logits = logits.clone()
            logits[n:2 * n] = logits[:n]
            return logits, cache

        monkeypatch.setattr(generate, "prefill", broken)


def pretrain_faults(monkeypatch, fault):
    from tokenpacker_tpu_torch.train import step, trainer

    if fault == "step_unchanged":
        monkeypatch.setattr(step.Optimizer, "update", lambda self, grads, state: None)
    elif fault == "half_batch":  # the loss of the first half of the rows, their mean
        real = step.vlm_loss

        def broken(params, cfg, batch, remat=""):
            n = batch["token_ids"].shape[0] // 2
            half = {k: (v[:n] if hasattr(v, "shape") and k != "images" and v.dim()
                        and v.shape[0] == 2 * n else v) for k, v in batch.items()}
            return real(params, cfg, half, remat)

        monkeypatch.setattr(step, "vlm_loss", broken)
    else:  # token_altered: one caption token of the first row, as the collator makes it
        real = trainer.collate

        def broken(items, *args, **kwargs):
            batch = real(items, *args, **kwargs)
            i = int(batch["lengths"][0]) - 2
            batch["token_ids"][0, i] = (batch["token_ids"][0, i] + 1) % 250 or 1
            return batch

        monkeypatch.setattr(trainer, "collate", broken)


CASES = [("llava-mpt-7b-hd9.chat", chat_faults), ("llava-mpt-7b-hd9.vqa-offline", offline_faults),
         ("llava-mpt-7b-stage1.pretrain", pretrain_faults)]


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("cell,plant", CASES, ids=[c for c, _ in CASES])
def test_fault_makes_run_incorrect(tiny_root, monkeypatch, cell, plant, fault):
    plant(monkeypatch, fault)
    args = bench_run.parse(["--workload", cell, "--seed", "4242424242", "--seconds", "1.5",
                            "--trace", "0"])
    result, _ = bench_run.measure(args, root=tiny_root, device="cpu")
    assert result["correct"] is False, result["checks"]
