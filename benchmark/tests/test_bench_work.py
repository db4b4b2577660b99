"""The work counts against a hand count and against the FLOPs the plain
reference runs (torch's FLOP counter over its products), and the readers'
arithmetic on a made-up run."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import peaks, stats, work
from benchlib.manifest import BENCH_DIR, load_module
from benchlib.model import make_weights
from benchlib.trace import TraceSummary
from conftest import tiny_config
from reference import clip, mpt, projector
from reference.precision import Float32

W = work.Widths(d=8, heads=2, layers=1, ffn=32, vocab=10, vw=4, vffn=16, vlayers=2, vseq=5,
                patch_in=12, e=4, kv_in=8, queries=1, region=4, kv_bytes=2)
TINY = tiny_config(json.loads((BENCH_DIR / "configs" / "llava-mpt-7b-hd9.json").read_text()))


def test_hand_counts():
    assert W.lm_matmul_params == 3 * 64 + 64 + 2 * 8 * 32
    assert work.prefill_flops(W, 3) == 2 * 768 * 3 + 4 * 8 * 6 + 2 * 8 * 10
    assert work.decode_flops(W, 4) == 2 * 768 + 4 * 8 * 4 + 2 * 8 * 10
    assert work.kv_bytes(W, 10) == 2 * 10 * 8 * 2
    assert work.attention_fwd_work(W, 3) == (4 * 8 * 6, 4 * 3 * 8 * 2)
    # fwd 2*768*3 + 4*8*6; bwd 2*768*3 + 8*8*6; head fwd+bwd at 2 targets
    assert work.train_lm_flops(W, 3, 2) == 4608 + 192 + 4608 + 384 + 2 * 2 * 8 * 10 * 2


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_counts_match_the_reference_products():
    w = work.Widths.of(TINY)
    weights = make_weights(TINY, 3, "cpu")
    views = 3
    px = torch.randn(views, 56, 56, 3)
    assert counted(lambda: clip.tower(weights["vision"], TINY["vision"], px, Float32())) == \
        work.tower_flops(w, views)
    feats, multi = clip.tower(weights["vision"], TINY["vision"], px, Float32())
    assert counted(lambda: projector.project(weights["projector"], TINY["projector"], feats, multi,
                                             Float32())) == work.projector_flops(w, views)
    t = 7
    x = torch.randn(1, t, w.d)
    # the reference computes the full t x t attention; the count keeps the causal half
    full = work.prefill_flops(w, t, logits=0) + w.layers * 4 * w.d * (t * t - work.causal_pairs(t))
    assert counted(lambda: mpt.hidden(weights["lm"], TINY["lm"], x, Float32())) == full


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", name)


def fake_run(data, trace=None):
    return SimpleNamespace(data=data, trace=trace, widths=W, peaks=peaks, work=work, stats=stats)


def test_k3_roofline_reader():
    # two steps in the slice: step 5 emitted token 1 of a 10-position prompt
    # and token 3 of a 20-position one; step 6 token 2 of the first
    data = {"trace_step_range": (4, 6), "num_slots": 4,
            "tokens": [(10, 0, 3), (10, 1, 5), (20, 3, 5), (10, 2, 6), (20, 4, 7)]}
    trace = TraceSummary(window_s=1.0, busy_s=0.5, ops={"decode_attention_kernel<1>": [2e-6, 2]})
    step5 = work.kv_bytes(W, 11 + 23 + 2) + 2 * 4 * 8 * 2
    step6 = work.kv_bytes(W, 12 + 3) + 2 * 4 * 8 * 2
    want = 100 * ((step5 + step6) / 2 * 2 / peaks.HBM_BYTES_PER_S) / 2e-6
    assert reader("k3_alibi.roofline.chat").read(fake_run(data, trace)) == pytest.approx(want)
    assert reader("k3_alibi.roofline.chat").read(fake_run(data, None)) is None


def test_mfu_and_step_readers():
    data = {"window_step_range": (4, 6), "window_decode_s": 0.5, "window_steps": 2,
            "tokens": [(10, 1, 5), (20, 3, 5), (10, 2, 6), (10, 3, 7)]}
    want = 100 * (work.decode_flops(W, 11) + work.decode_flops(W, 23) + work.decode_flops(W, 12)) / (
        0.5 * peaks.BF16_FLOPS)
    assert reader("mfu.chat").read(fake_run(data)) == pytest.approx(want)
    assert reader("batcher.step_ms.chat").read(fake_run(data)) == pytest.approx(250.0)
    ttft = {"ttft_s": [0.1 * i for i in range(1, 101)]}
    assert reader("batcher.ttft_p95_ms.chat").read(fake_run(ttft)) == pytest.approx(9505.0)
    assert reader("batcher.ttft_p50_ms.chat").read(fake_run(ttft)) == pytest.approx(5050.0)
    idle = reader("idle_share.chat").read(fake_run({}, TraceSummary(window_s=2.0, busy_s=1.5)))
    assert idle == pytest.approx(25.0)


def test_offline_and_pretrain_readers():
    batches = [{"prompt_lens": [3, 5], "views": [1, 2], "answer_lens": [2, 1], "prefill_s": 0.1}]
    want = (work.tower_flops(W, 1) + work.projector_flops(W, 1) + work.prefill_flops(W, 3)
            + work.decode_flops(W, 4) + work.tower_flops(W, 2) + work.projector_flops(W, 2)
            + work.prefill_flops(W, 5))
    run = fake_run({"batches": batches, "window_s": 2.0, "traced_batches": batches},
                   TraceSummary(window_s=1.0, busy_s=1.0, ops={"flash_fwd_kernel<1>": [1e-6, 1]}))
    assert reader("mfu.offline").read(run) == pytest.approx(100 * want / (2.0 * peaks.BF16_FLOPS))
    assert reader("engine.prefill_ms.offline").read(run) == pytest.approx(100.0)
    ops = work.attention_fwd_work(W, 3)[0] + work.attention_fwd_work(W, 5)[0]
    nbytes = work.attention_fwd_work(W, 3)[1] + work.attention_fwd_work(W, 5)[1]
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    assert reader("k2_bias_fwd.roofline.offline").read(run) == pytest.approx(100 * bound / 1e-6)
    steps = [[(150, 20), (160, 30)]]
    pre = fake_run({"steps": steps, "window_s": 1.0, "peak_bytes": [2**30, 3 * 2**30]})
    want = sum(work.tower_flops(W, 1) + work.train_projector_flops(W, 1)
               + work.train_lm_flops(W, v, t) for v, t in steps[0])
    assert reader("mfu.pretrain").read(pre) == pytest.approx(100 * want / peaks.BF16_FLOPS)
    assert reader("trainer.peak_gib.pretrain").read(pre) == 3.0


def test_kv_in_use_counts_the_decoding_slots():
    from benchlib.drivers.chat import kv_in_use

    # window steps 5 and 6: step 5 decoded a 10-position prompt's token 1 and
    # a 20-position prompt's token 3, step 6 the first prompt's token 2; a
    # first token (k = 0, from the prefill) and step 7 lie outside
    tokens = [(10, 0, 3), (10, 1, 5), (20, 3, 5), (10, 2, 6), (20, 4, 7)]
    conf = {"lm": {"n_layers": 2, "d_model": 8}, "kv_cache_dtype": "bfloat16"}
    got = kv_in_use(tokens, (4, 6), {"num_slots": 4, "max_seq_len": 64}, conf)
    per_position = 2 * 2 * 8 * 2
    assert got["kv_live_slots_mean"] == 1.5 and got["kv_live_slots_peak"] == 2
    assert got["kv_in_use_gb_mean"] == pytest.approx(per_position * (34 + 12) / 2 / 1e9)
    assert got["kv_in_use_gb_peak"] == pytest.approx(per_position * 34 / 1e9)
    assert got["kv_reserved_gb"] == pytest.approx(per_position * 4 * 64 / 1e9)
    assert kv_in_use(tokens, (7, 9), {"num_slots": 4, "max_seq_len": 64}, conf) == {}

