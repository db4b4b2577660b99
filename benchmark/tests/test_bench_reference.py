"""The plain reference against the program (`tokenpacker_tpu_torch`) on the
CPU at a tiny size, both in float32 from the benchmark's weights: the tower,
the projector, the splice order, MPT's logits and stage 1's loss."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchlib.manifest import BENCH_DIR
from benchlib.model import make_weights, program_config
from conftest import tiny_config
from reference import clip, mpt, projector, splice, train
from reference.precision import Float8, Float32

HD = tiny_config(json.loads((BENCH_DIR / "configs" / "llava-mpt-7b-hd9.json").read_text()))
PAD = tiny_config(json.loads((BENCH_DIR / "configs" / "llava-mpt-7b-stage1.json").read_text()))


def close(a, b, tol=1e-4):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.fixture(scope="module")
def weights():
    return make_weights(HD, 11, "cpu")


def test_tower_and_projector(weights):
    from tokenpacker_tpu_torch.models.clip_vit import clip_tower_features
    from tokenpacker_tpu_torch.models.tokenpacker import tokenpacker_forward

    cfg = program_config(HD)
    px = torch.randn(5, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    f_ref, m_ref = clip.tower(weights["vision"], HD["vision"], px, Float32())
    f, m = clip_tower_features(weights["vision"], cfg.vision, px)
    assert close(f_ref, f) and close(m_ref, m)
    got = tokenpacker_forward(weights["projector"], cfg.projector, f, m)
    want = projector.project(weights["projector"], HD["projector"], f_ref, m_ref, Float32())
    assert got.shape == want.shape == (5, 4, 64)
    assert close(want, got)
    # the control is a different computation: float8 moves the result
    ctl = projector.project(weights["projector"], HD["projector"], f_ref, m_ref, Float8())
    assert not close(want, ctl, 1e-3)


@pytest.mark.parametrize("grid", [(1, 1), (2, 3), (3, 3)])
def test_splice_order_and_logits(weights, grid):
    from tokenpacker_tpu_torch.models.mpt import mpt_apply, mpt_logits
    from tokenpacker_tpu_torch.models.splice import assemble_embeds, build_splice_plan

    cfg = program_config(HD)
    tok = HD["assumed"]["tokenizer"]
    views = grid[0] * grid[1] + (1 if grid != (1, 1) else 0)
    ids = np.array([11, 12, -200, tok["newline_id"], 20, 21, 22], np.int64)
    plan = build_splice_plan([ids], [[grid]], 4, "slice", tok["sep_id"], tok["newline_id"])
    visual = torch.randn(views, 4, 64, generator=torch.Generator().manual_seed(2))
    got = assemble_embeds(weights["lm"], visual, torch.as_tensor(plan.token_ids).long(),
                          torch.as_tensor(plan.is_image), torch.as_tensor(plan.image_slot).long(),
                          cfg.lm)
    want = splice.embed(splice.order(ids, grid, tok["sep_id"], tok["newline_id"]), visual,
                        weights["lm"]["wte"])
    assert got.shape[1] == want.shape[0]
    assert close(want, got[0])
    hid = mpt_apply(weights["lm"], cfg.lm, got)
    ref = mpt.logits(weights["lm"], mpt.hidden(weights["lm"], HD["lm"], want[None], Float32()),
                     Float32())
    assert close(ref, mpt_logits(weights["lm"], hid), 1e-4)


def test_stage1_loss():
    from tokenpacker_tpu_torch.data.dataset import collate
    from tokenpacker_tpu_torch.models.vlm import vlm_loss
    from tokenpacker_tpu_torch.train.trainer import device_train_batch

    w = make_weights(PAD, 5, "cpu")
    cfg = program_config(PAD)
    nl = PAD["assumed"]["tokenizer"]["newline_id"]
    caps = [[30, 31, 32], [40, 41, 42, 43, 44]]
    px = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(3))
    items = [{"input_ids": np.array([-200] + c + [nl]), "labels": np.array([-100] + c + [nl]),
              "image": px[i].permute(2, 0, 1).numpy()[None], "h_block": 1, "w_block": 1,
              "mode": "single"} for i, c in enumerate(caps)]
    batch = device_train_batch(collate(items, 4, 5, nl, 0, pad_to=32), torch.float32, "cpu")
    got, _ = vlm_loss(w, cfg, batch)
    f, m = clip.tower(w["vision"], PAD["vision"], px, Float32())
    lm32 = mpt.upcast(w["lm"])
    want = train.micro_loss(w["projector"], PAD, lm32, f, m,
                            [([-200] + c + [nl], [-100] + c + [nl]) for c in caps], Float32())
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_lr_schedule_starts_at_zero():
    assert train.lr_at(0, 1e-3, 24, 0.03) == 0.0
    assert train.lr_at(1, 1e-3, 24, 0.03) == pytest.approx(1e-3)
    assert train.lr_at(24, 1e-3, 24, 0.03) == pytest.approx(0.0, abs=1e-12)


def test_bf16_storage_leaves_scales_unmoved():
    """The witness of the held-out stage-1 cell's fault: at lr 1e-3 an AdamW
    step is below half a bf16 ulp of a value near 1, so stored in bf16 the
    projector's LayerNorm scales never move, while float32 storage moves them."""
    w = make_weights(PAD, 6, "cpu", torch.bfloat16)
    nl = PAD["assumed"]["tokenizer"]["newline_id"]
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(2, 56, 56, 3, generator=g),
                [([-200, 30 + m, 31, nl], [-100, 30 + m, 31, nl]) for _ in range(2)])
               for m in range(4)]
    recipe = {"gradient_accumulation_steps": 2, "learning_rate": 1e-3, "updates": 24,
              "warmup_ratio": 0.03, "max_grad_norm": 1.0}
    f32 = train.follow(w, PAD, recipe, batches, Float32())
    b16 = train.follow(w, PAD, recipe, batches, Float32(), store=torch.bfloat16)
    scale = ("ln_q", "scale")
    assert float(f32["change"][scale].norm()) > 1e-3
    assert float(b16["change"][scale].norm()) == 0.0
    kernel = ("mlp", "fc2", "kernel")
    assert float(b16["change"][kernel].norm()) > 0.5 * float(f32["change"][kernel].norm())
