"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one result line each (every failure raises, so any failure exits
non-zero and prints no final line):
  1. environment: card name and power limit, torch / CUDA / nvcc / triton;
     raises when no CUDA device is visible (there is no CPU fallback);
  2. build: nvcc compiles tokenpacker_tpu_torch/csrc/*.cu;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes: max error against the stated tolerance, and
     the median time of kernel and plain version (CUDA events);
  4. TokenPacker-7b (ViT-L/14-336, projector s=2, Vicuna-7B) in bf16 with
     random weights made on the card from a seed answers 4 requests (one
     synthetic image each, different prompt lengths) with 32 greedy
     tokens through `Generator.generate`; checks the kernels' launch
     counts, the tokens, finite logits and determinism;
  5. full widths at 2 LM layers: prefill logits on the card (bf16,
     kernels) against the CPU (fp32, plain versions) from the same weights.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.
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
# card bf16 vs CPU fp32 next-token logits through the full tower, the
# projector and 2 LM layers
LOGIT_BAND = 0.1
SEED = 0  # random weights, images and token ids


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = KERNEL_ATOL + KERNEL_RTOL * scale
    ok = err <= tol and torch.isfinite(got.float()).all().item()
    print(f"  {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} tol={tol:.3e} "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")
    return err


def bf16(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


def phase_kernels(device) -> dict:
    """Phase 3: every kernel vs its plain version at the path's shapes."""
    from tokenpacker_tpu_torch.ops import decode_attention as k3
    from tokenpacker_tpu_torch.ops import flash_attention as k2
    from tokenpacker_tpu_torch.ops import vit_attention as k1

    rows = {}

    def case(name, kernel, plain, args, pick=lambda x: x):
        out, want = kernel(*args), plain(*args)
        err = compare(name, pick(out), pick(want))
        if isinstance(out, tuple):  # flash: also the log-sum-exp
            err = max(err, compare(name + " lse", out[1], want[1]))
        ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args))
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        return err, ms, plain_ms

    print("phase 3: kernels vs plain versions (bf16, median of 20 CUDA-event-timed calls)")
    q, k, v = (bf16((8, 577, 1024), s, device) for s in range(3))
    rows["vit_attention"] = [case("K1 vit_attention [8,577,1024] 16 heads",
                                  k1.vit_attention, k1.vit_attention_plain, (q, k, v, 16))]

    rows["flash_attention"] = []
    for t, hkv in ((512, 32), (700, 32), (700, 8)):
        q = bf16((2, t, 32, 128), 10, device)
        kk, vv = bf16((2, t, hkv, 128), 11, device), bf16((2, t, hkv, 128), 12, device)
        rows["flash_attention"].append(case(
            f"K2 flash causal q[2,{t},32,128] kv heads {hkv}", k2.flash_attention,
            k2.flash_attention_plain, (q, kk, vv, True), pick=lambda x: x[0]))

    rows["decode_attention"] = []
    n, s = 4, 1040
    lengths = torch.tensor([100, 333, 650, 1000], dtype=torch.int32, device=device)
    for hkv, span in ((32, 1000), (32, 0), (8, 1000)):
        q = bf16((n, 32, 128), 20, device)
        ck, cv = bf16((n, s, hkv, 128), 21, device), bf16((n, s, hkv, 128), 22, device)
        needed = torch.full((n,), span + 17, dtype=torch.int32, device=device) if span else lengths
        rows["decode_attention"].append(case(
            f"K3 decode q[4,32,128] cache S={s} kv heads {hkv} span_start={span}",
            k3.decode_attention, k3.decode_attention_plain, (q, ck, cv, lengths, needed, span)))
    return rows


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
    gen = Generator(params, cfg)

    for fn in (vit_attention, flash_attention, decode_attention):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first = gen.generate(batch, max_new_tokens=32, temperature=0.0)
    torch.cuda.synchronize()
    launches = {
        "vit_attention": vit_attention.launches,
        "flash_attention": flash_attention.launches,
        "decode_attention": decode_attention.launches,
    }
    peak = torch.cuda.max_memory_allocated()
    steps = first.stats["decode_steps"]
    depth = cfg.lm.num_hidden_layers
    vc = cfg.vision  # blocks past the deepest consumed layer are skipped
    tower_blocks = max(vc.num_hidden_layers + 1 + vc.select_layer, *vc.multi_layers)
    want = {"vit_attention": tower_blocks, "flash_attention": depth,
            "decode_attention": depth * steps}
    print(f"  launches {launches}, expected {want} (1 tower pass, 1 prefill, {steps} decode steps)")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")

    second = gen.generate(batch, max_new_tokens=32, temperature=0.0)
    torch.cuda.synchronize()
    toks = first.sequences
    if any(not all(0 <= t < cfg.lm.vocab_size for t in seq) for seq in toks):
        raise AssertionError("a generated token is out of the vocabulary")
    if any(len(seq) == 0 for seq in toks):
        raise AssertionError("a request got no token")
    if not torch.isfinite(first.last_logits.float()).all():
        raise AssertionError("non-finite logits")
    if second.sequences != toks:
        raise AssertionError("two identical greedy calls returned different tokens")
    st = second.stats
    new_tokens = n * st["decode_steps"]
    print(f"  tokens per request {[len(s) for s in toks]}, first request {toks[0][:8]}..., "
          f"logits finite, second call identical")
    print(f"  TTFT (vision + prefill of {n}x{l} + first token, host clock) "
          f"{st['prefill_s'] * 1e3:.2f} ms; decode {st['decode_steps']} steps x {n} requests "
          f"in {st['decode_s'] * 1e3:.2f} ms = {new_tokens / st['decode_s']:.2f} tok/s aggregate "
          f"({st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step); "
          f"peak memory {peak / 2**30:.3f} GiB")
    del params, gen
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
    diff = (gpu_logits - cpu_logits).abs().max().item()
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    sure = margin > LOGIT_BAND
    agree = gpu_logits.argmax(-1) == cpu_logits.argmax(-1)
    print(f"phase 5: full widths, 2 LM layers, 2 requests: card bf16 vs CPU fp32 "
          f"(CPU side {time.perf_counter() - t0:.1f} s) max|dlogit|={diff:.4f} band={LOGIT_BAND} "
          f"max|logit|={cpu_logits.abs().max().item():.3f}; top-1 margins "
          f"{[round(m, 4) for m in margin.tolist()]}, top-1 agree {agree.tolist()}")
    if diff > LOGIT_BAND:
        raise AssertionError(f"card vs CPU logits differ by {diff} > {LOGIT_BAND}")
    if not bool(agree[sure].all()):
        raise AssertionError("top-1 differs where the CPU margin exceeds the band")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this check runs only on a GPU")
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

    rows = phase_kernels(device)
    launches = phase_end_to_end(device, SEED)
    phase_parity(device, SEED)

    meta = {
        "vit_attention": ("tokenpacker_tpu_torch/csrc/vit_attention.cu",
                          "tokenpacker_tpu/ops/vit_attention.py:75"),
        "flash_attention": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                            "tokenpacker_tpu/ops/flash_attention.py:183"),
        "decode_attention": ("tokenpacker_tpu_torch/csrc/decode_attention.cu",
                             "tokenpacker_tpu/ops/decode_attention.py:120"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        cases = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c[0] for c in cases),
            "ms": cases[0][1], "plain_ms": cases[0][2],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
