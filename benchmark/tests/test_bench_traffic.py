"""The traffic generator: the same seed gives the same requests, and every
seed the same set of sizes in another order."""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from benchlib import traffic as tr
from benchlib.manifest import BENCH_DIR

CONF = json.loads((BENCH_DIR / "configs" / "llava-mpt-7b-hd9.json").read_text())
STAGE1 = json.loads((BENCH_DIR / "configs" / "llava-mpt-7b-stage1.json").read_text())


def load(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def shape(r):
    return (r["segment"], r["grid"], r["prompt_len"], r["max_new_tokens"], r["greedy"])


def test_chat_same_seed_same_requests():
    t = load("chat")
    a = tr.chat_schedule(t, CONF, 2**31 + 5, 40, 144)
    b = tr.chat_schedule(t, CONF, 2**31 + 5, 40, 144)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert shape(x) == shape(y) and x["due"] == y["due"] and x["sample_seed"] == y["sample_seed"]
        assert np.array_equal(x["ids"], y["ids"])


def test_chat_seeds_share_the_work():
    """The same requests in the same order; only their token ids differ."""
    t = load("chat")
    a = tr.chat_schedule(t, CONF, 11, 40, 144)
    b = tr.chat_schedule(t, CONF, 12, 40, 144)
    for field in ("grid", "prompt_len", "max_new_tokens", "greedy"):
        for seg in ("pre", "win"):
            assert Counter(r[field] for r in a if r["segment"] == seg) == \
                Counter(r[field] for r in b if r["segment"] == seg)
    assert [r["due"] for r in a] == [r["due"] for r in b]  # one arrival order for all seeds
    assert any(not np.array_equal(x["ids"], y["ids"]) for x, y in zip(a, b))
    win = [r for r in a if r["segment"] == "win"]
    assert len(win) == round(t["rate_per_s"] * 40)
    assert all(0 <= r["due"] < 40 for r in win)
    assert all(r["prompt_len"] + r["max_new_tokens"] < CONF["lm"]["max_seq_len"] for r in a)
    grids = {r["grid"] for r in a}
    assert (1, 1) in grids and (3, 3) in grids
    ids = np.concatenate([r["ids"] for r in win])
    text = ids[ids >= 0]
    assert text.min() >= 1 and text.max() < CONF["assumed"]["tokenizer"]["text_vocab"]



def test_chat_drain_offers_the_windows_load():
    """After the window, the arrivals go on at the window's rate and in its
    pattern (a drain whose first arrivals came closer together would pile
    requests up behind the window's last ones)."""
    t = load("chat")
    a = tr.chat_schedule(t, CONF, 11, 40, 144)
    win = [r for r in a if r["segment"] == "win"]
    drain = [r for r in a if r["segment"] == "drain"]
    assert len(drain) >= round(t["rate_per_s"] * t["drain_limit_s"])
    dues = [r["due"] for r in drain]
    assert dues == sorted(dues) and dues[0] >= 40
    for r, w in zip(drain, win):
        assert r["due"] - 40 == pytest.approx(w["due"]) and r["prompt_len"] == w["prompt_len"]
    for span in (10, 20):  # the same count of arrivals in the drain's first seconds
        assert sum(d < 40 + span for d in dues) == sum(w["due"] < span for w in win)

def test_offline_cycle_fixed_compositions():
    t = load("vqa-offline")
    a = tr.offline_cycle(t, CONF, 5, 0, 144)
    b = tr.offline_cycle(t, CONF, 6, 0, 144)
    key = lambda bt: (tuple(sorted(r["prompt_len"] for r in bt["requests"])), bt["max_new_tokens"])
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert [key(x) for x in a] != [key(x) for x in b] or \
        [r["prompt_len"] for r in a[0]["requests"]] != [r["prompt_len"] for r in b[0]["requests"]]
    assert all(len(bt["requests"]) == t["batch_size"] for bt in a)
    assert {bt["max_new_tokens"] for bt in a} == set(range(t["max_new_tokens"][0], t["max_new_tokens"][1] + 1))
    again = tr.offline_cycle(t, CONF, 5, 0, 144)
    assert all(np.array_equal(x["ids"], y["ids"]) for p, q in zip(a, again)
               for x, y in zip(p["requests"], q["requests"]))


def test_captions_same_lengths_every_update():
    t = load("pretrain")
    per = t["per_device_batch_size"] * t["gradient_accumulation_steps"]
    n = per * t["updates"]
    order = np.random.default_rng(t["trainer_seed"]).permutation(n)
    recs = tr.caption_records(t, STAGE1, 99, order)
    blocks = [sorted(len(recs[i]["caption_ids"]) for i in order[u * per:(u + 1) * per])
              for u in range(t["updates"])]
    assert all(b == blocks[0] for b in blocks)
    assert min(blocks[0]) == t["caption_tokens"][0] and max(blocks[0]) <= t["caption_tokens"][1]
    again = tr.caption_records(t, STAGE1, 99, order)
    assert all(np.array_equal(x["caption_ids"], y["caption_ids"]) for x, y in zip(recs, again))
    other = tr.caption_records(t, STAGE1, 100, order)
    assert any(not np.array_equal(x["caption_ids"], y["caption_ids"]) for x, y in zip(recs, other))


def test_grid_rule_and_positions():
    from benchlib.grid import choose_grid, spliced_image_len, views

    assert choose_grid(480, 640) == (2, 3) and choose_grid(300, 300) == (1, 1)
    assert choose_grid(2048, 2048) == (3, 3) and choose_grid(1080, 1920) == (2, 4)
    assert views(1, 1) == 1 and views(3, 3) == 10
    assert spliced_image_len(1, 1, 144) == 145 and spliced_image_len(3, 3, 144) == 1450
