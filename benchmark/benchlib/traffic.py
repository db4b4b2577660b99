"""The one traffic generator: a traffic file's parameters and a seed in,
requests out.

Every seed gets the same set of sizes (image sizes, question, answer and
caption lengths, arrival gaps, greedy rows): the set is laid out once from
quantiles of the file's distributions, and the seed draws the content
(token ids, pixels, sampling seeds) and, where the order does not move the
work (offline batches, caption records), shuffles it. Open-loop arrivals
keep one order for every seed. So two seeds give the same work, and a run's
spread is the system's, not the draw's.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

from benchlib.grid import choose_grid, spliced_image_len, views

IMAGE_TOKEN_INDEX = -200  # the hole the splice fills (LLaVA's)


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and tags."""
    s = int(seed) % 2**128
    ss = np.random.SeedSequence([s & (2**64 - 1), s >> 64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _unit_quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def spread_ints(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi]."""
    return np.floor(lo + _unit_quantiles(n) * (hi - lo + 1)).astype(np.int64)


def lognormal_ints(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    z = np.array([statistics.NormalDist().inv_cdf(u) for u in _unit_quantiles(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def exponential_gaps(n: int, total: float) -> np.ndarray:
    """n gaps from exponential quantiles (Poisson arrivals), scaled so that
    they sum to `total`."""
    g = -np.log1p(-_unit_quantiles(n))
    return g * (total / g.sum())


def image_sizes(mix: list, n: int) -> list[tuple[int, int]]:
    """n (w, h) sizes in the mix's shares (largest remainders), in mix order."""
    shares = np.array([m[2] for m in mix], dtype=np.float64)
    raw = shares / shares.sum() * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts))[: n - counts.sum()]:
        counts[i] += 1
    return [(int(m[0]), int(m[1])) for m, c in zip(mix, counts) for _ in range(c)]


def template_ids(template: dict, text_vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """The conversation template's fixed token ids before the image and after
    the question (the same for every request, as a real template is)."""
    rng = np.random.default_rng(0)
    return (rng.integers(1, text_vocab, template["prefix_tokens"]),
            rng.integers(1, text_vocab, template["suffix_tokens"]))


def prompt_ids(question: np.ndarray, template: dict, text_vocab: int, newline_id: int) -> np.ndarray:
    """Template prefix, the image hole and a newline, the question, the
    template's assistant turn (`mpt` conversation layout)."""
    pre, post = template_ids(template, text_vocab)
    return np.concatenate([pre, [IMAGE_TOKEN_INDEX, newline_id], question, post]).astype(np.int64)


def _requests(traffic: dict, conf: dict, n: int, order: np.ndarray, content_seed: int,
              tokens_per_view: int) -> list[dict]:
    """n requests of the image/question mix: the fixed set of (image size,
    question length) pairs in `order`, ids drawn from `content_seed`."""
    tok = conf["assumed"]["tokenizer"]
    sizes = image_sizes(traffic["images"], n)
    q_lo, q_hi = traffic["question_tokens"]
    # which question length goes with which image is fixed; the seed orders the pairs
    questions = spread_ints(n, q_lo, q_hi)[np.random.default_rng(0).permutation(n)]
    rng = np.random.default_rng(content_seed)
    out = []
    for i in order:
        w, h = sizes[i]
        hb, wb = choose_grid(h, w, conf["patch_num"])
        ids = prompt_ids(rng.integers(1, tok["text_vocab"], int(questions[i])),
                         traffic["template"], tok["text_vocab"], tok["newline_id"])
        out.append({"ids": ids, "size": (w, h), "grid": (hb, wb), "views": views(hb, wb),
                    "prompt_len": len(ids) - 1 + spliced_image_len(hb, wb, tokens_per_view)})
    return out


def chat_schedule(traffic: dict, conf: dict, seed: int, window_s: float, tokens_per_view: int,
                  rate: float | None = None) -> list[dict]:
    """Open-loop arrivals at a fixed rate: a pre-roll before the window
    (t < 0, part of set-up), the window [0, window_s) and a drain after it
    that keeps the load on until the window's requests have finished (it
    replays the window's requests and arrivals, and is never measured). Each
    segment's count and gaps are fixed by the rate and its length; the
    sizes and gaps come in one order for every seed, the ids and sampling
    seeds from the seed."""
    rate = rate or traffic["rate_per_s"]
    segs = [("pre", -traffic["preroll_s"], traffic["preroll_s"]), ("win", 0.0, window_s)]
    a = traffic["answer_tokens"]
    s = traffic["sampling"]
    out = []
    for k, (seg, start, length) in enumerate(segs):
        n = max(1, round(rate * length))
        # one fixed order of the set for every seed: where requests queue behind
        # each other depends on the order, and a tail over ~100 requests would
        # follow the seed's order, not the system
        order = np.random.default_rng(1 + k).permutation(n)
        reqs = _requests(traffic, conf, n, order, subseed(seed, 2, k), tokens_per_view)
        answers = lognormal_ints(n, a["median"], a["sigma"], a["min"], a["max"])[
            np.random.default_rng(1).permutation(n)][order]
        greedy = (np.arange(n) % s["greedy_every"] == 0)[order]
        gaps = exponential_gaps(n, length)[np.random.default_rng(3 + k).permutation(n)]
        due = start + np.cumsum(gaps) - gaps  # first at the segment's start
        for i, r in enumerate(reqs):
            cap = conf["lm"]["max_seq_len"] - r["prompt_len"] - 1
            r.update(segment=seg, due=float(due[i]), max_new_tokens=int(min(answers[i], cap)),
                     greedy=bool(greedy[i]), sample_seed=subseed(seed, 4, k, i))
            out.append(r)
    for i, r in enumerate(out):
        r["source"] = i  # the request whose prompt and pixels it carries
    # the drain replays the window, arrivals and all, so that it offers the
    # window's load
    win = [r for r in out if r["segment"] == "win"]
    for i in range(max(1, math.ceil(rate * traffic["drain_limit_s"]))):
        src = win[i % len(win)]
        out.append(dict(src, segment="drain", due=window_s * (1 + i // len(win)) + src["due"]))
    for i, r in enumerate(out):
        r["index"] = i
    return out


def offline_cycle(traffic: dict, conf: dict, seed: int, cycle: int,
                  tokens_per_view: int) -> list[dict]:
    """One cycle of offline batches: the cycle's fixed batch compositions
    (which sizes go together, each batch's answer budget) in the seed's
    order, with the seed's ids. Returns [{"requests", "max_new_tokens"}]."""
    bs, nb = traffic["batch_size"], traffic["cycle_batches"]
    n = bs * nb
    reqs = _requests(traffic, conf, n, np.random.default_rng(0).permutation(n),
                     subseed(seed, 5, cycle), tokens_per_view)
    lo, hi = traffic["max_new_tokens"]
    budgets = spread_ints(nb, lo, hi)
    order = np.random.default_rng(subseed(seed, 6, cycle))
    batches = []
    for b in order.permutation(nb):
        members = [reqs[bs * b + j] for j in order.permutation(bs)]
        batches.append({"requests": members, "max_new_tokens": int(budgets[b]),
                        "pixel_seed": subseed(seed, 7, cycle, int(b))})
    return batches


def caption_records(traffic: dict, conf: dict, seed: int, visit_order: np.ndarray) -> list[dict]:
    """Stage-1 caption records: caption lengths laid out so that every block
    of one optimizer update (per-device batch x accumulation), in the order
    the trainer visits the records, holds the same set of lengths; the
    content of each from the seed. `visit_order[j]` is the record the
    trainer takes j-th."""
    tok = conf["assumed"]["tokenizer"]
    per_update = traffic["per_device_batch_size"] * traffic["gradient_accumulation_steps"]
    n = per_update * traffic["updates"]
    lo, hi = traffic["caption_tokens"]
    block = spread_ints(per_update, lo, hi)
    rng = np.random.default_rng(subseed(seed, 8))
    lengths = np.empty(n, np.int64)
    for u in range(traffic["updates"]):
        lengths[visit_order[u * per_update:(u + 1) * per_update]] = block[rng.permutation(per_update)]
    n_img = traffic["distinct_images"]
    records = []
    for i in range(n):
        caption = rng.integers(1, tok["text_vocab"], int(lengths[i]))
        records.append({"caption_ids": caption, "image": i % n_img})
    return records
