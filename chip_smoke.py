"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py              # the smoke run, phases 1-7
    python3 chip_smoke.py --profile    # phases 1-2, then the profile below

Phases, one result line each or more (every failure raises, so any
failure exits non-zero and prints no final line):
  1. environment: card name and power limit, torch / CUDA / nvcc / triton;
     raises when no CUDA device is visible (there is no CPU fallback);
  2. build: nvcc compiles tokenpacker_tpu_torch/csrc/*.cu, one process per
     source, all at once;
  3. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes: max error against the stated tolerance, the
     median time of kernel, plain version and, where one PyTorch call
     computes the same function, that call (CUDA events), and the least
     time the card could take (bound). K4 runs at the last decode step of
     phase 6: random Vicuna-7B layers quantized to int8, 4 requests,
     S=2080, the HD requests' ranges, int8 and bf16 caches;
  4. TokenPacker-7b (ViT-L/14-336, projector s=2, Vicuna-7B) in bf16 with
     random weights made on the card from a seed answers 4 requests (one
     synthetic image each, different prompt lengths) with 32 greedy
     tokens through `Generator.generate`; checks the kernels' launch
     counts, the tokens, finite logits and determinism;
  5. full widths at 2 LM layers: prefill logits on the card (bf16,
     kernels) against the CPU (fp32, plain versions) from the same weights;
  6. TokenPacker-HD-7b (preset tokenpacker-hd-7b-9patch-144token) with
     int8 weights (`quantize_lm_int8`, the load_8bit form) and an int8 KV
     cache answers 4 requests, one synthetic HD image each (grids 3x3,
     2x3, 3x1, 2x2, so ~1.5k visual positions for the largest), with 32
     greedy tokens: one K4 call per decode step, no K3; checks as in 4;
  7. full widths at 2 LM layers, int8 weights and int8 cache: prefill and
     4 decode steps on the card (bf16, K4) against the CPU (fp32, K4's
     plain version).
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.

`--profile` instead traces phase 6's model and requests with
torch.profiler over 8 decode steps after the prefill: device time per
step by kernel family, the host-clock time per step and the device's busy
share of it. It prints no final "ok" line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# kernel vs plain version in bf16: the kernels keep fp32 logits and round
# only the probabilities to bf16, the plain versions also round the
# logits, so the outputs may differ by a few bf16 ulps of their magnitude
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 1e-2
# K4 vs its plain version at 2 layers, the JAX package's own check of its
# fused kernel: the hidden state within 2e-2 of its largest magnitude (the
# probabilities are rounded to bf16 against the running max in the kernel
# and the global max in the plain version, the sums run in another
# order); the new rows within the kernel tolerance above. Over 32 layers
# of random weights these differences grow with depth (relative RMS
# ~0.006 after one layer, ~0.045 after 32 on the H100); a wrong layer,
# range or row gives O(1), so the 32-layer run is held to a relative RMS
# difference of 0.1.
K4_HIDDEN_RTOL, K4_DEEP_REL_RMS = 2e-2, 0.1
# card bf16 vs CPU fp32 next-token logits through the full tower, the
# projector and 2 LM layers (phases 5 and 7)
LOGIT_BAND = 0.1
SEED = 0  # random weights, images and token ids
HD_PRESET = "tokenpacker-hd-7b-9patch-144token"
# stand-ins for the Vicuna (LLaMA SentencePiece) ids of "," and "\n",
# the slice-mode row separator and row end; no tokenizer is loaded
SEP_ID, NEWLINE_ID = 29892, 13
NEW_TOKENS = 32
# NVIDIA's H100 SXM datasheet: HBM3 rate and
# the dense bf16 tensor-core rate, at a 700 W power limit
HBM_BYTES_PER_S, BF16_FLOP_PER_S = 3.35e12, 989e12


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        return f"{cmd[0]}: not found"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the HBM rate or operations
    over the bf16 tensor-core rate, whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol=KERNEL_ATOL,
            rtol=KERNEL_RTOL) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = atol + rtol * scale
    ok = err <= tol and torch.isfinite(got.float()).all().item()
    print(f"  {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} tol={tol:.3e} "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")
    return err


def bf16(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


def sdpa(q, k, v, **kw):
    """The library yardstick: one scaled_dot_product_attention call on
    [N, T, H, d] views of the kernel's inputs (timed only, never used)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)


def make_requests(cfg, seed: int):
    """4 requests: one synthetic image each (numpy, pad-mode preprocessing)
    and token ids in place of text; prompt lengths differ."""
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.generate import pick_bucket
    from tokenpacker_tpu_torch.image.processing import process_image
    from tokenpacker_tpu_torch.models.splice import build_splice_plan
    from PIL import Image

    rng = np.random.default_rng(seed)
    sizes = [(480, 360), (336, 336), (300, 500), (640, 427)]
    text_lens = [24, 61, 150, 290]
    crops, ids = [], []
    for (w, h), n_text in zip(sizes, text_lens):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        crops.append(process_image(img, "pad", image_size=cfg.vision.image_size)[0])
        text = rng.integers(3, cfg.lm.vocab_size, n_text)
        ids.append(np.concatenate([[1], text[:8], [IMAGE_TOKEN_INDEX], text[8:]]).astype(np.int64))
    longest = max(len(x) - 1 + cfg.tokens_per_view for x in ids)
    plan = build_splice_plan(ids, [[(1, 1)]] * 4, cfg.tokens_per_view, pad_to=pick_bucket(longest))
    images = np.concatenate(crops).transpose(0, 2, 3, 1).copy()  # [4, 336, 336, 3]
    return {
        "token_ids": plan.token_ids,
        "is_image": plan.is_image,
        "image_slot": plan.image_slot,
        "lengths": plan.lengths,
        "images": images,
    }


def make_hd_requests(cfg, seed: int, sizes=((1008, 1008), (900, 600), (400, 1100), (500, 500)),
                     text_lens=(300, 200, 120, 40)):
    """One synthetic HD image per request, slice-mode preprocessing and
    splice; token ids in place of text. The default sizes give the grids
    3x3, 2x3, 3x1 and 2x2 (10, 7, 4 and 5 crops)."""
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.generate import pick_bucket
    from tokenpacker_tpu_torch.image.hd_tiler import num_visual_tokens
    from tokenpacker_tpu_torch.image.processing import process_images
    from tokenpacker_tpu_torch.models.splice import build_splice_plan
    from PIL import Image

    rng = np.random.default_rng(seed)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for w, h in sizes]
    crops, blocks = process_images(images, "slice", cfg.patch_num, cfg.vision.image_size)
    ids = []
    for n_text in text_lens:
        text = rng.integers(3, cfg.lm.vocab_size, n_text)
        ids.append(np.concatenate([[1], text[:8], [IMAGE_TOKEN_INDEX], text[8:]]).astype(np.int64))
    longest = max(len(x) - 1 + num_visual_tokens(hb, wb, cfg.tokens_per_view)
                  for x, (hb, wb) in zip(ids, blocks))
    plan = build_splice_plan(ids, [[b] for b in blocks], cfg.tokens_per_view, "slice", SEP_ID,
                             NEWLINE_ID, pad_to=pick_bucket(longest))
    return {
        "token_ids": plan.token_ids,
        "is_image": plan.is_image,
        "image_slot": plan.image_slot,
        "lengths": plan.lengths,
        "images": crops.transpose(0, 2, 3, 1).copy(),
    }, blocks


def k4_bytes_flops(lc, b: int, keys: int, int8: bool) -> tuple[float, float]:
    """What one K4 call must move and compute: every weight once (int8 +
    f32 scales + bf16 norms), each valid cache row once (K and V, int8 +
    f32 scale or bf16), h in and out, the new rows out (k/v bf16 rows and
    the cache rows). `keys`: valid cache rows summed over the samples."""
    d, f, h, layers = lc.hidden_size, lc.intermediate_size, lc.num_attention_heads, lc.num_hidden_layers
    weights = d * 3 * d + d * d + d * 2 * f + f * d
    scales = 4 * (3 * d + d + 2 * f + d) + 2 * 2 * d
    row = d * (1 if int8 else 2) + (4 * h if int8 else 0)  # one position, K or V
    per_layer = weights + scales + 2 * keys * row + 2 * b * (2 * d + row)
    nbytes = layers * per_layer + 2 * b * d * 2
    flops = layers * (2 * b * weights + 4 * keys * d)
    return nbytes, flops


def phase_kernels(device, hd_lengths: np.ndarray, s_hd: int, span: tuple[int, int]) -> dict:
    """Phase 3: every kernel vs its plain version at the paths' shapes."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_lm_on_device, quantize_lm_int8
    from tokenpacker_tpu_torch.models.llama import KVCache
    from tokenpacker_tpu_torch.ops import decode_attention as k3
    from tokenpacker_tpu_torch.ops import flash_attention as k2
    from tokenpacker_tpu_torch.ops import fused_decode as k4
    from tokenpacker_tpu_torch.ops import vit_attention as k1
    from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv

    rows = {}

    def case(name, kernel, plain, args, pick=lambda x: x, library=None, work=None):
        out, want = kernel(*args), plain(*args)
        err = compare(name, pick(out), pick(want))
        if isinstance(out, tuple):  # flash: also the log-sum-exp
            err = max(err, compare(name + " lse", out[1], want[1]))
        ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args))
        lib_ms = time_ms(library) if library else None
        b_ms, b_by = bound(*work)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by}

    def first_and_worst(cases):
        row = dict(cases[0])
        row["max_abs_err"] = max(c["max_abs_err"] for c in cases)
        return row

    print("phase 3: kernels vs plain versions (bf16, median of 20 CUDA-event-timed calls)")
    n, t, w, heads = 8, 577, 1024, 16
    q, k, v = (bf16((n, t, w), s, device) for s in range(3))
    qh, kh, vh = (x.view(n, t, heads, w // heads) for x in (q, k, v))
    rows["vit_attention"] = first_and_worst([case(
        "K1 vit_attention [8,577,1024] 16 heads", k1.vit_attention, k1.vit_attention_plain,
        (q, k, v, heads), library=lambda: sdpa(qh, kh, vh),
        work=(4 * n * t * w * 2, 4 * n * heads * t * t * (w // heads)))])

    cases = []
    for t, hkv in ((512, 32), (700, 32), (700, 8)):
        q = bf16((2, t, 32, 128), 10, device)
        kk, vv = bf16((2, t, hkv, 128), 11, device), bf16((2, t, hkv, 128), 12, device)
        nbytes = 2 * (2 * t * 32 * 128) * 2 + 2 * (2 * t * hkv * 128) * 2 + 2 * 32 * t * 4
        cases.append(case(
            f"K2 flash causal q[2,{t},32,128] kv heads {hkv}", k2.flash_attention,
            k2.flash_attention_plain, (q, kk, vv, True), pick=lambda x: x[0],
            library=lambda q=q, kk=kk, vv=vv: sdpa(q, kk, vv, is_causal=True,
                                                   enable_gqa=hkv != 32),
            work=(nbytes, 4 * 2 * 32 * 128 * t * (t + 1) / 2)))
    rows["flash_attention"] = first_and_worst(cases)

    cases = []
    n, s = 4, 1040
    lengths = torch.tensor([100, 333, 650, 1000], dtype=torch.int32, device=device)
    kpos = torch.arange(s, device=device)[None, :]
    for hkv, span_start in ((32, 1000), (32, 0), (8, 1000)):
        q = bf16((n, 32, 128), 20, device)
        ck, cv = bf16((n, s, hkv, 128), 21, device), bf16((n, s, hkv, 128), 22, device)
        needed = (torch.full((n,), span_start + 17, dtype=torch.int32, device=device)
                  if span_start else lengths)
        valid = kpos < needed[:, None]
        if span_start:
            valid &= (kpos < lengths[:, None]) | (kpos >= span_start)
        keys = int(valid.sum())
        mask = valid[:, None, None, :]
        cases.append(case(
            f"K3 decode q[4,32,128] cache S={s} kv heads {hkv} span_start={span_start}",
            k3.decode_attention, k3.decode_attention_plain,
            (q, ck, cv, lengths, needed, span_start),
            library=lambda q=q, ck=ck, cv=cv, mask=mask, hkv=hkv: sdpa(
                q[:, None], ck, cv, attn_mask=mask, enable_gqa=hkv != 32),
            work=(2 * keys * hkv * 128 * 2 + 2 * n * 32 * 128 * 2 + 2 * n * 4,
                  4 * keys * 32 * 128)))
    rows["decode_attention"] = first_and_worst(cases)

    # K4 at phase 6's last decode step: the HD requests' prompt rows
    # [0, len0) plus the decoded span [L, L + 30), the new row at L + 30.
    # Held against the plain version at 2 full-width layers (the JAX
    # package's own depth and bound for this check); timed at all 32.
    lc = preset_config(HD_PRESET).lm
    layers = quantize_lm_int8({"lm": init_lm_on_device(lc, SEED + 5, device)})["lm"]["layers"]
    b = len(hd_lengths)
    len0 = torch.as_tensor(hd_lengths, dtype=torch.int32, device=device)
    start2 = torch.full_like(len0, span[0])
    end2 = torch.full_like(len0, span[1])
    args = (len0, start2, end2, end2, len0 + (span[1] - span[0]))
    h0 = (0.02 * torch.randn((b, lc.hidden_size), device=device,
                             generator=torch.Generator(device=device).manual_seed(SEED + 6))).bfloat16()
    keys = int(np.minimum(hd_lengths, s_hd).sum()) + b * (span[1] - span[0])
    cases = []
    for int8 in (True, False):
        cache = KVCache.create(lc, b, s_hd, dtype=torch.int8 if int8 else torch.bfloat16,
                               device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 7)
        if int8:
            for c in (cache.k, cache.v):
                c.copy_(torch.randint(-127, 128, c.shape, generator=g, device=device,
                                      dtype=torch.int8))
            for c in (cache.k_scale, cache.v_scale):
                c.copy_(torch.rand(c.shape, generator=g, device=device) * 0.02 + 0.001)
        else:
            for c in (cache.k, cache.v):
                c.copy_(torch.randn(c.shape, generator=g, device=device))
        tag = f"K4 fused_decode B={b} S={s_hd} {'int8' if int8 else 'bf16'} cache"

        # 2 layers: kernel on the cache, plain on an untouched copy
        lc2 = dataclasses.replace(lc, num_hidden_layers=2)
        c2 = KVCache(cache.k[:2], cache.v[:2], 0, *((cache.k_scale[:2], cache.v_scale[:2])
                                                    if int8 else (None, None)))
        kc, vc = c2.k.clone(), c2.v.clone()
        hidden, k_new, v_new = k4.fused_decode_hidden(
            {"layers": layers[:2]}, lc2, h0, c2.k, c2.v, *args, k_scale=c2.k_scale,
            v_scale=c2.v_scale)
        p_hidden, p_k, p_v = k4.fused_decode_hidden_plain(
            layers[:2], lc2, h0, kc, vc, *args[:3], args[4], c2.k_scale, c2.v_scale)
        err = compare(tag + " 2 layers hidden", hidden, p_hidden, atol=0.0, rtol=K4_HIDDEN_RTOL)
        compare(tag + " 2 layers new k rows", k_new, p_k)
        compare(tag + " 2 layers new v rows", v_new, p_v)
        rows_b, wp = torch.arange(b, device=device), end2.long()
        written = c2.k[:, rows_b, wp]
        if int8:
            written = dequantize_kv(written, c2.k_scale[:, rows_b, wp], torch.float32)
        compare(tag + " 2 layers cache row written", written, p_k)

        # 32 layers: deterministic, no gross error, timed
        lm = {"layers": layers}
        weights = k4.FusedWeights(lm, lc)
        kc, vc = cache.k.clone(), cache.v.clone()

        def kernel():
            return k4.fused_decode_hidden(lm, lc, h0, cache.k, cache.v, *args,
                                          k_scale=cache.k_scale, v_scale=cache.v_scale,
                                          weights=weights)[0]

        def plain():
            return k4.fused_decode_hidden_plain(layers, lc, h0, kc, vc, *args[:3], args[4],
                                                cache.k_scale, cache.v_scale)[0]

        hidden, again, p_hidden = kernel(), kernel(), plain()
        if not torch.equal(again, hidden):
            raise AssertionError(f"{tag}: two identical calls differ")
        rel = ((hidden.float() - p_hidden.float()).pow(2).mean().sqrt()
               / p_hidden.float().pow(2).mean().sqrt()).item()
        print(f"  {tag} {lc.num_hidden_layers} layers hidden: relative RMS difference "
              f"{rel:.4f} (bound {K4_DEEP_REL_RMS}), max_abs_err "
              f"{(hidden.float() - p_hidden.float()).abs().max().item():.3e}, "
              f"two calls identical")
        if not rel <= K4_DEEP_REL_RMS:
            raise AssertionError(f"{tag}: 32-layer hidden differs from the plain version ({rel})")
        ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5, warmup=1)
        b_ms, b_by = bound(*k4_bytes_flops(lc, b, keys, int8))
        print(f"  {tag} {lc.num_hidden_layers} layers: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library none, bound {b_ms:.4f} ms ({b_by}; {keys} valid cache rows)")
        cases.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by})
        del cache, c2, kc, vc, weights, lm
    rows["fused_decode"] = first_and_worst(cases)  # the int8 cache: phase 6's
    del layers
    torch.cuda.empty_cache()
    return rows


def tower_blocks(cfg) -> int:
    vc = cfg.vision  # blocks past the deepest consumed layer are skipped
    return max(vc.num_hidden_layers + 1 + vc.select_layer, *vc.multi_layers)


def check_generation(name, gen, batch, cfg, want: dict, counters: dict) -> dict:
    """Two identical greedy calls: launch counts of the first against
    `want`, tokens in the vocabulary, finite logits, identical tokens.
    Prints TTFT, decode rate and peak memory of the second."""
    n, l = batch["token_ids"].shape
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first = gen.generate(batch, max_new_tokens=NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches {launches}, expected {want} (1 tower pass, 1 prefill, "
          f"{first.stats['decode_steps']} decode steps)")
    if launches != want:
        raise AssertionError(f"{name}: kernel launch counts {launches} != {want}")
    second = gen.generate(batch, max_new_tokens=NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    toks = first.sequences
    if any(not all(0 <= t < cfg.lm.vocab_size for t in seq) for seq in toks):
        raise AssertionError(f"{name}: a generated token is out of the vocabulary")
    if any(len(seq) == 0 for seq in toks):
        raise AssertionError(f"{name}: a request got no token")
    if not torch.isfinite(first.last_logits.float()).all():
        raise AssertionError(f"{name}: non-finite logits")
    if second.sequences != toks:
        raise AssertionError(f"{name}: two identical greedy calls returned different tokens")
    st = second.stats
    new_tokens = n * st["decode_steps"]
    print(f"  tokens per request {[len(s) for s in toks]}, first request {toks[0][:8]}..., "
          f"logits finite, second call identical")
    print(f"  TTFT (vision + prefill of {n}x{l} + first token, host clock) "
          f"{st['prefill_s'] * 1e3:.2f} ms; decode {st['decode_steps']} steps x {n} requests "
          f"in {st['decode_s'] * 1e3:.2f} ms = {new_tokens / st['decode_s']:.2f} tok/s aggregate "
          f"({st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step); "
          f"peak memory {peak / 2**30:.3f} GiB")
    return launches


def phase_end_to_end(device, seed: int) -> dict:
    """Phase 4: TokenPacker-7b bf16 serves 4 requests, 32 greedy tokens."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    cfg = TokenPackerVLMConfig()
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"phase 4: TokenPacker-7b bf16, random weights from seed {seed} made on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    batch = make_requests(cfg, seed)
    n, l = batch["token_ids"].shape
    print(f"  requests: {n}, spliced lengths {batch['lengths'].tolist()}, bucket {l}")
    depth = cfg.lm.num_hidden_layers
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention}
    want = {"vit_attention": tower_blocks(cfg), "flash_attention": depth,
            "decode_attention": depth * (NEW_TOKENS - 1)}
    launches = check_generation("phase 4", Generator(params, cfg), batch, cfg, want, counters)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_parity(device, seed: int) -> None:
    """Phase 5: full widths, 2 LM layers; card bf16 vs CPU fp32 logits.
    Biases and norm scales are random, so the check also sees them."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
    from tokenpacker_tpu_torch.generate import device_batch, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to

    full = TokenPackerVLMConfig()
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    batch = make_requests(cfg, seed + 1)
    batch = {k: v[:2] for k, v in batch.items()}  # 2 requests keep the CPU side short
    s_max = batch["token_ids"].shape[1] + 1
    gpu_logits, _ = prefill(params, cfg, device_batch(batch, torch.bfloat16, device), s_max)
    gpu_logits = gpu_logits.float().cpu()
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_logits, _ = prefill(cpu_params, cpu_cfg, device_batch(batch, torch.float32, "cpu"), s_max)
    diff, margins, agree = band_check("phase 5", gpu_logits, cpu_logits)
    print(f"phase 5: full widths, 2 LM layers, 2 requests: card bf16 vs CPU fp32 "
          f"(CPU side {time.perf_counter() - t0:.1f} s) max|dlogit|={diff:.4f} band={LOGIT_BAND} "
          f"max|logit|={cpu_logits.abs().max().item():.3f}; top-1 margins "
          f"{[round(m, 4) for m in margins]}, top-1 agree {agree}")


def band_check(name, gpu_logits, cpu_logits):
    """Card logits within LOGIT_BAND of the CPU's; top-1 equal where the CPU
    margin exceeds the band."""
    diff = (gpu_logits - cpu_logits).abs().max().item()
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = gpu_logits.argmax(-1) == cpu_logits.argmax(-1)
    if diff > LOGIT_BAND:
        raise AssertionError(f"{name}: card vs CPU logits differ by {diff} > {LOGIT_BAND}")
    if not bool(agree[margin > LOGIT_BAND].all()):
        raise AssertionError(f"{name}: top-1 differs where the CPU margin exceeds the band")
    return diff, margin.tolist(), agree.tolist()


def phase_hd_int8(device, seed: int, batch, blocks) -> dict:
    """Phase 6: TokenPacker-HD-7b, int8 weights and int8 KV cache, 4 HD
    requests, 32 greedy tokens; K4 once per decode step, K3 never."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    cfg = preset_config(HD_PRESET)
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    bf16_lm = tree_bytes(params["lm"])
    quantize_lm_int8(params)
    torch.cuda.synchronize()
    print(f"phase 6: {HD_PRESET}, random weights from seed {seed}, LM quantized to int8 on the "
          f"card ({bf16_lm / 2**30:.3f} -> {tree_bytes(params['lm']) / 2**30:.3f} GiB) in "
          f"{time.perf_counter() - t0:.2f} s; int8 KV cache")
    n, l = batch["token_ids"].shape
    print(f"  requests: {n}, grids {blocks}, crops {batch['images'].shape[0]}, spliced lengths "
          f"{batch['lengths'].tolist()}, bucket {l}, sep/newline stand-in ids {SEP_ID}/{NEWLINE_ID}")
    gen = Generator(params, cfg, kv_cache_dtype=torch.int8)
    if gen.fused is False:
        raise AssertionError("phase 6: the int8 tree is not K4-eligible")
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_decode": fused_decode_hidden}
    want = {"vit_attention": tower_blocks(cfg), "flash_attention": cfg.lm.num_hidden_layers,
            "decode_attention": 0, "fused_decode": NEW_TOKENS - 1}
    launches = check_generation("phase 6", gen, batch, cfg, want, counters)
    del params, gen
    torch.cuda.empty_cache()
    return launches


def phase_int8_parity(device, seed: int) -> None:
    """Phase 7: full widths, 2 LM layers, int8 weights and int8 cache;
    prefill and 4 decode steps on the card (bf16, K4) against the CPU
    (fp32, K4's plain version). Both sides are fed the CPU's greedy
    tokens."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, fused_weights, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden

    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    batch, blocks = make_hd_requests(cfg, seed + 1, sizes=((672, 336), (336, 336)),
                                     text_lens=(40, 70))
    l = batch["token_ids"].shape[1]
    s_max = l + 8
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    lengths = {"gpu": torch.as_tensor(batch["lengths"], device=device),
               "cpu": torch.as_tensor(batch["lengths"])}
    sides = {
        "gpu": (params, cfg, device_batch(batch, torch.bfloat16, device), fused_weights(params, cfg)),
        "cpu": (cpu_params, cpu_cfg, device_batch(batch, torch.float32, "cpu"), True),
    }
    fused_decode_hidden.launches = 0
    t0 = time.perf_counter()
    state = {k: prefill(p, c, b, s_max, kv_cache_dtype=torch.int8) for k, (p, c, b, _) in sides.items()}
    results = []
    for step in range(5):
        gpu_logits, cpu_logits = state["gpu"][0].float().cpu(), state["cpu"][0].float()
        results.append(band_check(f"phase 7 step {step}", gpu_logits, cpu_logits))
        if step == 4:
            break
        tok = cpu_logits.argmax(-1)
        for k, (p, c, _, fw) in sides.items():
            cache = state[k][1]
            state[k] = decode_step(p, c, cache, tok.to(lengths[k].device), lengths[k], step, l, fw)
    if fused_decode_hidden.launches != 4:
        raise AssertionError(f"phase 7: {fused_decode_hidden.launches} K4 launches on the card, "
                             "expected 4")
    print(f"phase 7: full widths, 2 LM layers, int8 weights + int8 cache, 2 HD requests (grids "
          f"{blocks}): card bf16 (K4) vs CPU fp32 (plain K4), prefill + 4 decode steps "
          f"({time.perf_counter() - t0:.1f} s) max|dlogit| per step "
          f"{[round(r[0], 4) for r in results]} band={LOGIT_BAND}; top-1 margins "
          f"{[[round(m, 4) for m in r[1]] for r in results]}, top-1 agree "
          f"{[r[2] for r in results]}")
    del params, state, sides
    torch.cuda.empty_cache()


def profile_hd_decode(device, seed: int, batch, steps: int = 8) -> None:
    """`--profile`: phase 6's model and requests; torch.profiler over
    `steps` decode steps after the prefill (two warm steps first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, fused_weights, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8

    cfg = preset_config(HD_PRESET)
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    fused = fused_weights(params, cfg)
    dev = device_batch(batch, cfg.dtype, device)
    l = batch["token_ids"].shape[1]
    logits, cache = prefill(params, cfg, dev, l + steps + 2, kv_cache_dtype=torch.int8)
    tok = logits.argmax(-1)
    for step in range(2):
        logits, cache = decode_step(params, cfg, cache, tok, dev["lengths"], step, l, fused)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(2, 2 + steps):
            logits, cache = decode_step(params, cfg, cache, tok, dev["lengths"], step, l, fused)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies); CPU ops also carry the
    # device time of what they launched
    kernels = [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    families = {}
    for name, ms, count in kernels:
        fam = next((f for f in ("gemv_partial", "qkv_epilogue", "attention_kernel",
                                "residual_epilogue", "gateup_epilogue") if f in name), "other")
        t, c = families.get(fam, (0.0, 0))
        families[fam] = (t + ms, c + count)
    print(f"profile: {HD_PRESET} int8, B={dev['token_ids'].shape[0]}, S={cache.k.shape[2]}, "
          f"{steps} decode steps: host clock {wall / steps * 1e3:.3f} ms/step, device busy "
          f"{busy / steps:.3f} ms/step (idle share {1 - busy / (wall * 1e3):.3f})")
    for fam, (ms, count) in sorted(families.items(), key=lambda x: -x[1][0]):
        print(f"  {fam}: {ms / steps:.4f} ms/step, {count / steps:.1f} launches/step")
    for name, ms, count in sorted(kernels, key=lambda x: -x[1])[:12]:
        print(f"    {ms / steps:.4f} ms/step {count / steps:6.1f}/step  {name[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this check runs only on a GPU")
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0] if card else "nvidia-smi: no output")
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    nvcc = sh([_build.find_nvcc(), "--version"]).splitlines()
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc {nvcc[-1] if nvcc else '?'}, "
          f"triton {triton_v}, device {torch.cuda.get_device_name(0)}")

    path, seconds = _build.build()
    _build.library()
    print(f"phase 2: built {path.name} in {seconds:.2f} s (0 = already built)")

    hd_cfg = preset_config(HD_PRESET)
    hd_batch, hd_blocks = make_hd_requests(hd_cfg, SEED)
    if "--profile" in sys.argv[1:]:
        profile_hd_decode(device, SEED, hd_batch)
        return
    l = hd_batch["token_ids"].shape[1]
    s_hd = -(-(l + NEW_TOKENS) // 32) * 32  # generate.prefill's int8 cache length
    # the last decode step writes slot l + NEW_TOKENS - 2 and attends the
    # decoded span [l, l + NEW_TOKENS - 2) besides the prompt
    rows = phase_kernels(device, hd_batch["lengths"], s_hd, (l, l + NEW_TOKENS - 2))
    runs = [phase_end_to_end(device, SEED)]
    phase_parity(device, SEED)
    runs.append(phase_hd_int8(device, SEED, hd_batch, hd_blocks))
    phase_int8_parity(device, SEED)

    meta = {
        "vit_attention": ("tokenpacker_tpu_torch/csrc/vit_attention.cu",
                          "tokenpacker_tpu/ops/vit_attention.py:75"),
        "flash_attention": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                            "tokenpacker_tpu/ops/flash_attention.py:183"),
        "decode_attention": ("tokenpacker_tpu_torch/csrc/decode_attention.cu",
                             "tokenpacker_tpu/ops/decode_attention.py:120"),
        "fused_decode": ("tokenpacker_tpu_torch/csrc/fused_decode.cu",
                         "tokenpacker_tpu/ops/fused_decode.py:1295"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        # launches: summed over the two main-path runs (phases 4 and 6),
        # each counted from 0 just before its run and read just after
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(r.get(name, 0) for r in runs), **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
