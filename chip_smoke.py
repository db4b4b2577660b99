"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py              # the smoke run, phases 1-35 (25-35 before 24)
    python3 chip_smoke.py --profile    # phases 1-2, then the profile below
    python3 chip_smoke.py --profile-train  # phases 1-2, then a traced training step
    python3 chip_smoke.py --profile-paged  # phases 1-2, then traced paged decode steps
    python3 chip_smoke.py --profile-quantized  # phases 1-2, traced E and F decode steps
    python3 chip_smoke.py --kernels        # phases 1-3 only
    python3 chip_smoke.py --quantized      # phases 1-2, K3 and K6-K8 of phase 3, phases 12-15
    python3 chip_smoke.py --speculative    # phases 1-2, K9 and K4-verify of phase 3, 16-17
    python3 chip_smoke.py --lora           # phases 1-2, K4-LoRA of phase 3, phases 18-19
    python3 chip_smoke.py --mpt            # phases 1-2, K2-bias and K3-ALiBi of phase 3, 20-23
    python3 chip_smoke.py --probes         # phases 1-2, K2 full-bias of phase 3, phase 24
    python3 chip_smoke.py --flash          # phases 1-2, every K2 row of phase 3, 8-9, 22-23
    python3 chip_smoke.py --tower          # phases 1-2, K1 and K9 of phase 3, 4-5, 8-9, 16-17
    python3 chip_smoke.py --sampling       # phases 1-2, then 25-27
    python3 chip_smoke.py --checkpoints    # phases 1-2, K6 and K7 at MPT-7B's up/down, 28-30
    python3 chip_smoke.py --serving        # phases 1-2, phase 28's checkpoint write, 31
    python3 chip_smoke.py --lora-train     # phases 1-2, K1 and K2 (training shape) of phase 3,
                                           # phase 28's checkpoint write, 32-33
    python3 chip_smoke.py --eval           # phases 1-2, K1, K2-fwd, K4 and K4-verify of
                                           # phase 3, phase 28's checkpoint write, 34
    python3 chip_smoke.py --parallel       # phases 1-2, phase 3's per-rank rows, 35

Phases, one result line each or more (every failure raises, so any
failure exits non-zero and prints no final line):
  1. environment: card name and power limit, torch / CUDA / nvcc / triton;
     raises when no CUDA device is visible (there is no CPU fallback);
  2. build: nvcc compiles tokenpacker_tpu_torch/csrc/*.cu, one process per
     source, all at once;
  3. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes, held by a block measure (relative RMS of every
     64-position tile of each head for K1 and K2, of every (sample, head)
     row for K3, K4 and K5) that must also fail an output that lost a
     tile, range or page; the median time of kernel, plain version and,
     where one PyTorch call computes the same function, that call (CUDA
     events), and the least time the card could take (bound). K4 runs at
     the last decode step of phase 6: random Vicuna-7B layers quantized to
     int8, 4 requests, S=2080, the HD requests' ranges, int8 and bf16
     caches, and at phase 34's 16 and 14 rows with a bf16 cache. K5 runs
     at phase 10's pool shape: 8 sequences of 65-2080 keys over shuffled
     pages of 64, 32 and 8 kv heads, int8 and bf16 pools. K6 (nf4 and
     int4), K7 and K8 run at TokenPacker-HD-7b's product shapes
     (`quantized_kernel_cases`): K6 held per (row, 128-wide slice), K7's int32 and K8's int8 rows and int32 sums bit
     for bit, each shown to fail the product without the last 64 or 128
     rows of K; their bound is at the int8 rate for K7 and K8, their
     library yardstick torch._int_mm (K7, K8) or the bf16 product with
     the dequantized weight (K6). K2's forward is also timed, and its backward checked
     and timed, at phase 8's training shape [8, 2048, 32, 128], causal
     (the backward's plain version runs sample by sample, its library
     yardstick is the backward alone of one causal
     scaled_dot_product_attention); two backward calls must give the
     same bits;
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
     plain version);
  8. stage 1 of TokenPacker-7b (the projector trains, tower and LM
     frozen) at full width and depth through `Trainer.train()`: random
     bf16 weights from the seed, a synthetic dataset of 24 records (random
     images, plain-template captions, a stand-in word tokenizer), batch
     8 padded to 2048, remat "full", 3 steps. Per step: loss, seconds,
     valid and padded tokens/s, peak memory. Checks: finite losses, tower
     and LM bitwise unchanged, projector unchanged after step 1 (lr = 0)
     and changed after step 3, launches per step K1 23, K2-fwd 64 (32 +
     32 recomputed), K2-bwd 32, and `mm_projector.bin` loads back;
  9. full widths at 2 LM layers: one stage-2 step (LM and projector train)
     on the card (bf16, kernels) and on the CPU (fp32, plain versions)
     from the same weights and batch; the loss and every trained leaf's
     gradient within the stated bands (a leaf below SMALL_LEAF_SHARE of
     its group's gradient norm held against that share of it), which the
     same step with K2's backward losing dq, or dk and dv, must fail;
 10. TokenPacker-HD-7b with int8 weights serves 10 HD requests through
     `PagedContinuousBatcher` (the JAX worker's paged settings: 8 slots,
     an int8 pool of 641 pages of 64, chunked admissions of 256, the
     prefix cache on), 32 greedy tokens each: phase 6's 4 requests, 2
     repeats and 2 shared-prefix variants of the 3x3 one, a 1x1-grid
     request and one cancelled after its 4th token. Per request the
     admission latency; decode ms per step, tok/s, peak memory, pages in
     use against a dense cache, the prefix cache's counters. Checks: K5 32
     times per decode step, the warm requests hit the cache and skip the
     vision encode, their first-token logits within the band of the cold
     request's and their tokens equal wherever its margin is decisive, 0
     pages leaked;
 11. full widths at 2 LM layers, int8 weights and an int8 pool: one HD
     request admitted cold and one warm on its pages (`prefix_admit`),
     then 8 paged decode steps on the card (bf16, K5) against the CPU
     (fp32, K5's plain version);
 12. TokenPacker-HD-7b with its LM quantized to nf4 (`quantize_lm_4bit`,
     the load_4bit form) and a bf16 cache answers phase 6's 4 HD requests
     with 32 greedy tokens (configuration E): per-layer decode, K3 for
     attention, K6 for every product of a step; checks as in 4;
 13. full widths at 2 LM layers, 4-bit LM: prefill and 8 decode steps
     (nf4), prefill and 1 step (int4) on the card (K6) against the CPU;
 14. phase 10's batcher and requests with the tower quantized too
     (`quantize_tower_int8`) and `w8a8=True` (configuration F): K8 for
     the tower and the admission chunks of 256 rows, K7 for every decode
     step and first-token head, the launch counts checked against the
     chunks' rows (shorter chunks' products take the weight-only route);
 15. phase 11 in the w8a8 mode with the quantized tower, card vs CPU:
     first the tower's features per view (W8A8_TOWER_REL_RMS), then the
     admissions and 8 steps in W8A8_LOGIT_BAND (the w8a8 scheme spreads
     bf16-vs-fp32 logits 3-4x wider than weight-only int8); each band
     fails the same run with the w8a8 products losing their last 128
     rows of K;
 16. TokenPacker-HD-7b with its LM from `quantize_lm_int8`, an int8 cache
     and the fused tower (`vit_block=True`) through `ContinuousBatcher`
     (4 slots, the worker's default; max_seq_len 2080; chunks of 256;
     speculative_k 4): phase 6's 4 HD requests, a repeat of the 3x3 one
     and one cancelled after its 4th token, 32 greedy tokens each. Checks:
     K9 23 times per admission, K4 once per plain step, K4's verify form
     once per verify round, K1 and K3 never; tokens equal phase 6's plain
     run (recorded on the same weights with the same fused tower, so that
     the two differ only in chunked admission, K4's verify form and
     speculation) wherever its top-2 margin exceeds LOGIT_BAND, the
     repeat's too; no state left in the batcher. Printed:
     rounds, tokens a round, tok/s, ms per verify round and per plain
     step, admission latency, peak memory. Then the rigged repeater (64
     tokens, at least 3 tokens a forward, tokens equal its plain decode),
     `Generator.generate(speculative=4)` and phase 10's paged batcher with
     `speculative_k=4` on the 3x3 request and its repeat;
 17. full widths at 2 LM layers, card bf16 vs CPU fp32: the fused tower's
     update of the patch rows per view within K9_TOWER_REL_RMS (failing K9
     with its MLP's last 128 units lost), then one HD admission and 4
     verify rounds at k = 4 within LOGIT_BAND, which the verify without
     its fed keys (each fed token alone) must fail;
 18. TokenPacker-HD-7b with an int8 LM and an int8 cache serving two LoRA
     adapters of rank 16 over all seven targets (configuration H), written
     as PEFT directories and read by `load_adapter`, one with a projector:
     `ContinuousBatcher(num_slots=4, max_seq_len=2080, prefill_chunk_size=
     256, speculative_k=4, adapters=...)`, phase 6's 4 HD requests under
     ad0, ad1, none and ad0, the 3x3 one again under ad1 and one cancelled
     after its 4th token. Checks: K4-LoRA once per plain step and its
     verify form once per round, K4 without the term never; ad1's
     projector in its admissions only; tokens equal a recorded per-layer
     run (the `linear` term) of each request wherever its margin is
     decisive. Printed: admission latency, ms a step and a round, tok/s,
     peak memory. Then phase 10's paged batcher with the adapters: the
     3x3 request under ad0, ad1 and ad0 maps cached pages for the repeat
     under ad0 only, K5 32 times a step;
 19. full widths at 2 LM layers, int8 weights and cache, with adapters,
     card bf16 (K4-LoRA) vs CPU fp32: one HD admission under ad1, 4 decode
     steps and one verify round within LOGIT_BAND, which the card's run
     with the slot's adapter term dropped must fail by several bands;
 20. configuration I: MPT-7B (`models/mpt.mpt_config`: d 4096, 32 heads of
     128, 32 layers, vocab 50432, ALiBi, tied embeddings) behind the
     HD-7b tower and projector, bf16 weights and cache: `Generator` answers
     phase 6's 4 HD requests with 32 greedy tokens (K2-bias 32 a prefill,
     K3-ALiBi 32 a decode step, K1 23 a tower pass, no other attention
     kernel; checks as in 4), then `ContinuousBatcher` in G's settings
     (4 slots, S = 2080, chunks of 256, speculative_k 4) serves 6 requests
     (the 4, a repeat of the 3x3, one cancelled after its 4th token):
     chunks and verify rounds through `sdpa` with ALiBi, K3-ALiBi 32 a
     plain step, tokens equal to the batched run's up to the first
     near-tie; TTFT, ms a step and a round, tok/s, admission latency,
     peak memory;
 21. full widths at 2 MPT layers: prefill and 4 decode steps card bf16
     (K2-bias, K3-ALiBi) vs CPU fp32 within LOGIT_BAND;
 22. configuration J: stage 1 of MPT-7B behind TokenPacker-7b's tower and
     projector through `Trainer.train()`, C's synthetic dataset, batch 4
     padded to 2048, no remat, 3 steps: per step K2-bias forward and
     backward 32 each, K1 23; finite losses, tower and LM bitwise frozen,
     the projector changed; loss, s and tok/s a step, peak memory;
 23. full widths at 2 MPT layers: one stage-2 step card vs CPU in phase
     9's bands, which the same step with K2-bias's backward dropping the
     bias must fail;
 24. the card probes P1-P4 (`tokenpacker_tpu_torch/probes`) at their
     scripts' geometry, every input byte read once a call: P1 over copies
     of at least 4x the L2 (and one copy, L2-resident, labelled), P2 int8
     and int4 at B = 1, P3a's packing, P3b int8 and packed at B = 8, P4
     in five element types at their own load width and as 16-byte vectors;
     checksums and packed rows bit-equal to the plain versions, the GEMV
     chains' values within GEMV_REL, each check failing a lossy output
     (a chunk, layer or byte order lost); GB/s and the share of 3.35 TB/s,
     the decision ratios of P2 (int4/int8) and P3b (packed/int8).
 25. configuration K: B's model (TokenPacker-HD-7b, the LM in int8, an
     int8 cache) and phase 6's 4 HD requests through `Generator.generate`
     at temperature 0.7, top_p 0.9, top_k 50, min_p 0.05,
     repetition_penalty 1.1 with an explicit generator, 32 tokens: K4 once
     a decode step; every token in the support of the filters applied to
     the penalized logits of its step (the sampler wrapped here); top_k 1
     gives the greedy tokens up to a bf16 tie; the sampler alone on a [4,
     32000] bf16 step under the sync debug mode "error"; 4,096 draws from
     one 16-token distribution within total variation 0.05, unseeded and
     over 4,096 seeds. Printed: ms a step, greedy and sampled in turns;
 26. configuration L: G's dense batcher (fused tower, chunks of 256,
     speculative_k 4) and D's paged batcher (prefix cache on) each serve 8
     requests of phase 6's images (2 greedy, 2 sampled at temperature 0.8
     and top_p 0.95, 1 with min_p 0.1, 1 greedy with repetition_penalty
     1.2, 1 greedy with logprobs=3, 1 sampled with seed 1234, which is
     also submitted alone first): the greedy requests' tokens, in this
     run and in a greedy-only run, equal a recorded plain run's wherever
     its margin is decisive (so each other up to where either parts from
     it at a near-tie), the seeded request's two runs up to a draw within
     the band, logprob entries within 1e-3 of log_softmax of the recorded raw
     logits with sorted top lists; the dense batcher runs verify rounds
     only while a greedy slot is active, and every other slot takes one
     token a round; K4, K4-verify, K5 and K9 counted against the steps;
 27. configuration M: phase 6's first 2 HD requests through
     `beam.beam_generate` with 4 beams, 16 tokens and length_penalty 1:
     K4 at 8 rows once a step, each score within 0.02 a token of a
     teacher-forced prefill of prompt + beam (K2), whether the batch
     equals each request searched alone printed, num_beams 17 refused;
 28. TokenPacker-HD-7b's weights from phase 6's seed written in the
     reference's layout (`export_vlm_state_dict` cast to bf16, two
     `pytorch_model-0000k-of-00002.bin` shards, `config.json` from
     `to_hf_dict`; the LM's depth cut only if no disk holds it), then
     `api.load_pretrained_model(dir, load_8bit=True)` and `load_4bit=True`
     (nf4): every tensor bit-equal to `quantize_lm_int8` / `quantize_lm_4bit`
     of the weights in memory, phase 6's 4 HD requests' 32 greedy tokens
     equal to a `Generator` over those, one K4 call a decode step (8-bit)
     or K6 for every decode product and K3 (4-bit); the write's and each
     load's seconds and GB/s, the host's peak resident set and the card's
     peak memory over the load;
 29. full widths at 2 LM layers: a stage-1 delta (LM-only base,
     `mm_projector.bin`, the tower through TOKENPACKER_CLIP_PATH) and a
     rank-16 LoRA adapter with a projector (`write_peft`) load through the
     API, `io/surgery`'s extract-mm-projector, merge-lora and consolidate
     write what loads back, each held against the weights it was made
     from (bit-equal; LoRA targets within one bf16 step of W + (alpha / r)
     B A); `serve/cli.main --load-8bit` chats two turns through a patched
     `input`, each answer equal to `generate_stream`'s text;
 30. MPT-7B behind the HD-7b tower with an nf4 LM answers phase 6's 4 HD
     requests with 32 greedy tokens (K6 four times a layer a step,
     K3-ALiBi once, K2-bias at the prefill; checks as in 4), then card vs
     CPU at 2 MPT layers for the nf4, int8 weight-only and w8a8 forms in
     the bands of phases 13, 7 and 15, each failing the same run with
     every quantized product losing the last 128 rows of K;
 31. configuration P, the HTTP serving stack over phase 28's directory:
     the port's controller, a paged `ModelWorker` (load_8bit, int8 pool,
     4 slots, 2,048 positions, chunks of 256) that registers and beats
     itself, the OpenAI gateway and the web server on localhost ports;
     phase 6's images as base64 PNG through the gateway, 4 at once (2
     greedy, one streamed with top_logprobs 3; one sampled; one seeded),
     the seeded one again alone, one request straight to the worker, one
     web chat turn in "Pad" mode; then a direct worker (speculative_k 4)
     with one greedy and one sampled request. Error codes, usage and
     finish_reason, greedy ids against a plain run over the loaded
     weights where its margin is decisive, the seeded runs up to a draw
     within the band, logprob entries within 1e-3 of their raw logits,
     /metrics, the web server's logs, and K1, K2, K4, K4-verify and K5
     counted against the steps; TTFT and ms a token at the client beside
     the batcher's, the loads' seconds and the phase timings printed;
 32. configuration Q, QLoRA of TokenPacker-HD-7b from phase 28's directory
     through `python -m tokenpacker_tpu_torch.train.train`'s `main`
     (LLaVA's finetune_qlora.sh: --bits 4 --lora-enable, rank 128, alpha
     256, lr 2e-4, mm_projector_lr 2e-5; slice mode, 9 patches, remat
     full), 3 steps of 8 HD caption records padded to 2048, then 2 with
     --bits 8: step ms, tok/s, peak GiB; K1, K2-fwd and K2-bwd against the
     expected counts; the quantized base and the tower bitwise unchanged;
     every B zero after step 1 (lr 0) and non-zero after the last; the
     reference files with every target's keys. The nf4 run's checkpoint
     then loads through `load_pretrained_model(ckpt, model_base=...,
     load_8bit=True)` (its int8 codes within one step of the card's own
     merge; greedy decoding, K4) and is served over the load_8bit base
     through `load_adapter` and the dense batcher (K4-LoRA); first-step
     logits of both against plain bf16 runs of the weights they stand for
     (QLORA_DEEP_BAND, which the served run without its term must fail);
 33. full widths, 2 LM layers: one LoRA step over an nf4 base, card bf16
     vs CPU fp32 (phase 9's bands, the adapters at the LM's), failing K2's
     backward without dq, or dk and dv;
 34. configuration R, the evaluation harness over phase 28's directory
     (before it is deleted): the port's eval CLIs through their `main`s
     with --load-8bit, each loading the model anew: `benchmarks vqa` with
     gqa.sh's flags over 32 GQA-style questions (batch 16, 128 new tokens,
     PNGs of 320-800 px), `mmbench --all-rounds --single-pred-prompt`
     over a 4-row TSV, `docvqa` (1700 x 2200 pages), `ocrbench`, `textqa`,
     `run_demo` with 4 beams and with --speculative-k 4, `mmmu.run` over 4
     records from a list, then `mmmu score`, `convert` and `score_cli`.
     Answers files one line a question in order; each run's K1, K2-fwd,
     K4 and K4-verify launches against its `generate` calls (real views
     only, K4 at the batch's rows, none of K1 for textqa); GQA answers
     0-3 and 12-15 (both of K4's 8-row tiles at 16 rows) by token id
     against batch-1 `Generator.generate` runs where their margin is
     decisive; the load, questions/s, ms a question, peak
     GiB and each batch's host preparation and its overlap printed.
 35. configuration S, the sharded programs as two ranks on the one card
     (`phase_parallel`): the native library against numpy and PIL, NCCL
     at a world of one, NCCL asked for two ranks on cuda:0 (its answer
     printed, choosing nothing), then two gloo ranks staged through
     pinned host memory (this script spawned twice with `--rank`, `--device
     cuda --one-device --backend gloo`): HD-13b int8 at 8
     layers, tp 2 (tokens against one rank's where its margin is
     decisive), a 7B stage-2 step at 2 layers, tp 2 (phase 9's bands),
     the pipeline at pp 2 (4 layers of 7B width), ring attention [1,
     4096, 32, 128] against K2 block by block, the paged batcher scenario
     at HD-7b width, and two LoRA adapters (ranks 16 and 8) and the base
     model served over HD-7b int8 at 8 layers, tp 2, through both
     batchers (tokens against one rank's where its margin is decisive,
     the base against a run with no adapter, the paged prefix cache
     keeping the adapters apart); the `*_rank` kernels' launches read on
     rank 0.
Phase 3 also holds K2's full-bias form (no serving or training path
reaches it) at MPT-7B's prefix-LM attention, [4, 2048, 32, 128], not
causal: the prefix-LM mask with B's prompt lengths plus ALiBi as a [4, 32,
2048, 2048] fp32 bias, the mask alone as [4, 1, 2048, 2048], and that one
with rows below -1e30 (o = 0, lse = +inf), each failing the plain version
with the bias's last key tile dropped; SDPA with the bias as a bf16 mask is
its library column. The six kernels no path reaches (K2 full-bias and the
probes' five) are counted over phases 4-23 and 25-34: 0.
Phase 3 also holds K9 at [8, 577, 1024] and [26, 577, 1024] by its
block's update out - x per (image, 64 rows, 128-wide slice), failing the
plain block that lost its last 64 keys or its MLP's last 128 units, with
the per-op block (cuBLAS products, SDPA, F.layer_norm: several calls) as
its library column, and times the 23-block tower fused against per op;
K4-LoRA at T = 1 and 5 (B = 4, S = 2080, slots on two adapters, none
and the first again) by the adapters' update per (sample, token, 128-wide
slice) at 2 layers, failing three lossy plain versions (a slot's
selection zeroed, a slot on the other adapter, the down term dropped),
its written int8 rows bit-equal to `quantize_kv`'s, timed at 32 layers
beside K4 and K4-verify without the term;
K4's verify form (B = 4, T = 5, S = 2080, int8 and bf16 caches) per
(sample, token, 128-wide slice) and per (sample, token, head) row,
failing the plain version without the last range or (at 1-4 row prompts)
with each fed token alone, timed beside K4's T = 1 step in the same
call; and the int8 rows that `quantize_kv` gives on the card, and K4
writes at T = 1 and T = 5, bit-equal to the CPU's and `quantize_kv`'s.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.

`--profile` instead times phase 6's model and requests over 8 decode
steps after the prefill, untraced and then under torch.profiler: the
host-clock time per step both ways, the device's busy share of it and
the device time per step by kernel family, each kernel counted from the
end of the one before it (K4 launches overlap their predecessors); then
the same on that cache for G's verify step (T = 5) and H's plain and
verify steps with two adapters (K4-LoRA). `--profile-train` traces one stage-1 step of phase 8's
configuration (after one untraced step) the same way; `--profile-paged`
traces 8 paged decode steps of phase 10's model and pool (8 slots at
K5's phase-3 lengths); `--profile-quantized` traces 8 decode steps of
phase 12's nf4 model (as `--profile`) and 8 paged steps in phase 14's
w8a8 mode (as `--profile-paged`); `--splits` times K5 and K6 at phase
3's shapes with each split count 1-8 (the planners' table); `--kernels`
stops after phase 3; `--quantized`
runs only the quantized slice's checks (K3, which E launches, and K6-K8
in phase 3, and K5, which F launches; phases 12-15)
`--speculative` only the speculative slice's (the int8 rows' bit
check, K9 and K4-verify in phase 3, phases 16-17) and `--lora` only the
multi-LoRA slice's (K4-LoRA in phase 3, phases 18-19) and `--mpt` only
the MPT slice's (K2-bias forward at [1|4, 2048, 32, 128] and backward at
[4, 2048, 32, 128], K3-ALiBi at [4, 32, 128], S = 2080, in phase 3, each
failing two lossy outputs; phases 20-23) and `--probes` only K2's
full-bias rows of phase 3 and phase 24, and `--flash` every K2 row of
phase 3 (serving, training, key-only bias forward and backward, full-bias;
with K3-ALiBi, which shares their function) and phases 8-9 and 22-23,
each printing their kernel rows, and `--tower` K1's and K9's rows of
phase 3 (with the 23-block tower fused and per op) and phases 4-5, 8-9
and 16-17 (A, C and G, the paths that launch K1 and K9), and
`--checkpoints` K6's and K7's rows at MPT-7B's up and down and phases
28-30, and `--lora-train` K1's row and K2's training-shape rows of phase
3, phase 28's checkpoint write and phases 32-33 (configuration Q: QLoRA
of TokenPacker-HD-7b from that checkpoint through the training CLI, nf4
then int8, the round trip of its adapter through `load_pretrained_model`
and `load_adapter`; then the card-vs-CPU LoRA step at 2 layers). None
prints the final "ok" line; nor do `--sampling` (phases
25-27, no phase 3) and `--serving` (phase 28's write and phase 31),
which print their launch counts. `--eval` (K1's row, K2's serving rows,
K4's and K4-verify's of phase 3, phase 28's write and phase 34) ends with
the kernels line of those four and the "ok" line. `--parallel` (phase
3's per-rank rows: K2 both ways, K3 and K5 at one rank's heads of a tp =
2 run, K7 and K8 at Vicuna-13B's per-rank widths; then phase 35) prints
its rows with their launches. Every K1, K2 and K9 row of phase 3 also prints its
achieved TFLOP/s (the operations its bound counts over the kernel's
time), every K8 row its TOPS and every K3, K5 and K6 row its TB/s, each
against the card's rate, and the bound's share of the kernel's time (K3,
K5, K8 and their library calls, and K6, timed as CUDA graphs of 20
calls). The kernels line keeps every phase-3 case of K5, K6 and K7 (all
four pools, every M, both codes, MPT-7B's up and down) under "cases". `--flash
--kernels`, `--tower --kernels`, `--quantized --kernels` and `--mpt
--kernels` also run against the parent's package when this file is
copied into an unpacked parent tree (its `tokenpacker_tpu_torch/` is the
one imported).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tokenpacker_tpu_torch.timing import (
    BF16_FLOP_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    time_ms,
)

# K4 over 32 layers of random weights against its plain version: the
# differences grow with depth (relative RMS ~0.006 after one layer,
# ~0.045 after 32 on the H100); a wrong layer, range or row gives O(1), so
# the 32-layer run is held to a relative RMS difference of 0.1. Its
# 2-layer check is held row by row (below).
K4_DEEP_REL_RMS = 0.1
# K4's 2-layer check scales the cache's V by this gain, so that the
# layers' attention moves the hidden state about as much as the MLP: with
# V of unit size the attention output averages to ~1/sqrt(keys), the
# MLP's ~1 buries it, and no measure of the hidden state could see a
# lost range
K4_V_GAIN = 30.0
# card bf16 vs CPU fp32 next-token logits through the full tower, the
# projector and 2 LM layers (phases 5, 7, 11, 13 and 15)
LOGIT_BAND = 0.1
# phase 15, the int8 tower in the w8a8 mode: card bf16 vs CPU fp32
# features, relative RMS per view. The card rounds every activation to
# bf16 before quantizing it to int8, and an activation within that
# rounding of a half step takes the other int8 step, so the w8a8 tower's
# spread is twice the dense tower's (0.030 against 0.014, both measured
# on the CPU at full width, bf16 against fp32); through the projector and
# the LM that is 0.24 in the logits (H100), outside LOGIT_BAND. The
# same tower with K8 losing the last 128 rows of K reads 0.54.
W8A8_TOWER_REL_RMS = 0.1
# phase 15's logits in the w8a8 mode, card bf16 vs CPU fp32: each int8
# activation step is ~8 bf16 roundings of a typical activation, so the
# activations that the two sides round to different steps spread the
# logits 3-4x wider than the weight-only path's. Phase 15 run on the CPU
# at full width, bf16 against fp32, reads max |dlogit| 0.23-0.28 over the
# admission and 8 steps (one top-1 flip at a margin of 0.15); the same
# run with every w8a8 product losing the last 128 rows of K reads 2.8-3.4.
W8A8_LOGIT_BAND = 0.5
# Every kernel against its plain version, by a block measure: the relative
# RMS difference ||got - plain|| / ||plain|| of every (sample, 64-position
# tile, head) block (K1, and K2's o, dq, dk, dv: `tile_rel_rms`) or of
# every (sample, head) row (K3, K4's hidden state in 128-wide slices and
# its new rows, K5: `row_rel_rms`), the worst one held. The measure does
# not scale with the largest value of the tensor, so blocks of small
# values (the last keys' dk/dv, late rows' dq) are held as tightly as
# the large ones, and a lost or garbled tile, range or page reads
# O(0.1-1); each check shows that on an output that lost one (K1, K2:
# the last tile zeroed; K3, K4, K5: the plain version run without the
# last valid range or page). bf16 rounding of P and dS as product
# operands and of the outputs gives ~2^-9 per element: on an H100 K2's
# worst block reads 0.0075 for o and 0.0031-0.0038 for dq, dk and dv.
# lse is a log, so its absolute error is P's relative one: held
# absolutely (0.009 read).
TILE_REL_RMS, LSE_ATOL = 2e-2, 2e-2
# phase 9, card bf16 vs CPU fp32 through the same chain and its backward:
# the loss within 1% (relative) and the gradient of every trained leaf
# within its group's band of relative RMS difference, the worst leaf
# held (a pooled number would let lm_head and the embedding, whose
# gradients do not pass through K2's backward, hide the attention
# projections). bf16 rounds every activation and gradient to 8 bits of
# mantissa (2^-9 relative) and K2 rounds P and dS to bf16 as product
# operands. On an H100 the LM's leaves read 0.011-0.026 and the
# projector's 0.035-0.067: its weight gradients are products with the
# tower's features, which come through 23 bf16 blocks, and its key-path
# biases keep little of their gradient after the softmax's cancellation.
# K2's backward losing dq, or dk and dv, reads 1.0 on the LM's q, or k
# and v, projections and 0.21, or 1.0, on the projector.
LOSS_BAND, GRAD_REL_RMS_BANDS = 1e-2, {"projector": 0.1, "lm": 0.05}
# leaves whose exact gradient is 0: the key bias of the projector's
# softmax attention, and the bias of the key LayerNorm that reaches only
# it, add one constant to all of a query's logits, which the softmax
# ignores. Both sides hold rounding noise there, so these two are held
# relative to the projector's whole gradient instead of their own.
ZERO_GRAD_LEAVES = ("projector.attn.k.bias", "projector.ln_k.bias")
# leaves whose CPU gradient norm lies below this share of their group's
# (projector.k_proj.fc2.bias: ~1e-5 of the projector's) are held relative
# to this share of the group's norm, not to their own: such a leaf adds
# under 1e-6 of its group's squared norm, and its reading against its own
# size is the rounding noise of the 23 bf16 tower blocks and the
# softmax's cancellation amplified 1e3-1e5 times (0.067-0.098 of the 0.1
# band over earlier H100 runs of unchanged code), so a new rounding
# upstream moves it without anything being wrong. Every leaf at or above
# the share keeps its own size; no band changes.
SMALL_LEAF_SHARE = 1e-3
TRAIN_SEQ, TRAIN_BATCH, TRAIN_RECORDS = 2048, 8, 24
# phases 32-33 (configuration Q): LLaVA's scripts/v1_5/finetune_qlora.sh,
# --bits 4 --lora_r 128 --lora_alpha 256 --learning_rate 2e-4
# --mm_projector_lr 2e-5 --weight_decay 0.; 3 steps over the nf4 LM, then
# 2 over the int8 one
QLORA_RANK, QLORA_ALPHA, QLORA_LR, QLORA_PROJECTOR_LR = 128, 256, 2e-4, 2e-5
QLORA_STEPS = {"4": 3, "8": 2}
# phase 33's b: entries of this size, so that a's gradient is not 0 (b = 0
# at init) and the adapters' term moves the hidden state as a trained one
QLORA_B_SCALE = 0.01
# phase 32's round trip: first-step logits (the prefill's and one decode
# step's) of the trained adapter, served over the load_8bit base
# (`load_adapter`, K4-LoRA) and merged into a load_8bit checkpoint (K4),
# each against a plain bf16 run of the weights it holds (the int8 base
# dequantized plus the delta; the merged int8 weights dequantized). At 32
# layers a plain bf16 run of dequantized int8 weights and the int8
# products (x @ q, then the scale) read 0.19 apart at the prefill with no
# adapter at all (H100 80GB HBM3, 700 W), where LOGIT_BAND (0.1) was set
# for 2 layers; that spread is printed beside each reading. The band must
# fail the served run with the adapter's term dropped (8.9-9.5 there). The merge itself is held by its int8 codes, equal to
# `quantize_lm_int8` of the card's own merge within one step, and its
# projector, bit-equal to the trained one; the merged run against the
# bf16 W + delta before the int8 rounding is printed, not held.
QLORA_DEEP_BAND = 0.5
SEED = 0  # random weights, images and token ids
HD_PRESET = "tokenpacker-hd-7b-9patch-144token"
# stand-ins for the Vicuna (LLaMA SentencePiece) ids of "," and "\n",
# the slice-mode row separator and row end; no tokenizer is loaded
SEP_ID, NEWLINE_ID = 29892, 13
NEW_TOKENS = 32


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        return f"{cmd[0]}: not found"


def bound(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the HBM rate or operations
    over the tensor-core rate of their type (bf16 by default, int8 for K7
    and K8), whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def achieved_tflops(flops: float, ms: float) -> str:
    """The operations a row's bound counts over the kernel's time."""
    return f"achieved {flops / ms / 1e9:.1f} TFLOP/s"


def achieved_rate(what: str, work: tuple, rate: float, ms: float, bound_ms: float) -> str:
    """A row's operations ("ops": TFLOP/s at the bf16 rate, TOPS at the
    int8 one) or bytes ("bytes": K3's TB/s) over the kernel's time, against
    the card's rate for them, and the bound's share of the kernel's time."""
    if what == "ops":
        unit = "TOPS" if rate == INT8_OPS_PER_S else "TFLOP/s"
        got, peak = work[1] / ms / 1e9, rate / 1e12
    else:
        got, unit, peak = work[0] / ms / 1e9, "TB/s", HBM_BYTES_PER_S / 1e12
    return (f"achieved {got:.2f} {unit} of {peak:g} ({got / peak:.0%}), "
            f"at {bound_ms / ms:.0%} of the bound")


def row_rel_rms(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| over the last axis of [..., d] tensors:
    one reading per (sample, head) row; a row that is zero in `want` reads
    0 if it is zero in `got` too, else inf."""
    num = (got.float() - want.float()).square().sum(-1)
    den = want.float().square().sum(-1)
    return torch.where(den > 0, (num / den.clamp_min(1e-30)).sqrt(),
                       torch.where(num > 0, torch.inf, 0.0))


def compare_rows(name: str, got: torch.Tensor, want: torch.Tensor, lost: torch.Tensor,
                 lost_what: str = "the last range or page") -> float:
    """Hold [..., d] kernel outputs to TILE_REL_RMS row by row
    (`row_rel_rms`), and show the measure's power: `lost`, the plain
    version's output for the same input without `lost_what` (its last
    valid range or page, K6's last 64 weight rows), must fail. Returns the
    largest absolute error."""
    rel = row_rel_rms(got, want)
    worst = rel.max().item()
    where = np.unravel_index(int(rel.argmax()), tuple(rel.shape))
    lost_reads = row_rel_rms(lost, want).max().item()
    err = (got.float() - want.float()).abs().max().item()
    ok = worst <= TILE_REL_RMS and bool(torch.isfinite(got.float()).all())
    print(f"  {name}: worst row relative RMS {worst:.4e} (at {tuple(int(i) for i in where)}), "
          f"median {rel.median().item():.4e}, limit {TILE_REL_RMS}; without {lost_what} "
          f"{lost_reads:.4f}; max_abs_err {err:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({worst})")
    if not lost_reads > TILE_REL_RMS:
        raise AssertionError(f"{name}: the row measure does not see the loss of {lost_what}")
    return err


def compare_exact(name: str, got: torch.Tensor, want: torch.Tensor, lost: torch.Tensor) -> float:
    """K7: the int32 products bit-equal to the plain version's, and the
    product without the last 128 rows of K (`lost`) must not be. Returns
    the largest absolute error (0)."""
    ok, lost_equal = torch.equal(got, want), torch.equal(lost, want)
    print(f"  {name}: int32 bit-equal {ok}; without the last 128 rows of K bit-equal "
          f"{lost_equal} {'OK' if ok and not lost_equal else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: int32 products differ from the plain version's")
    if lost_equal:
        raise AssertionError(f"{name}: the check does not see the last 128 rows lost")
    return 0.0


def compare_s8_gemm(name: str, x, wq, wscale) -> float:
    """K8: the kernel's int8 rows, their scales and its int32 sums bit-equal
    to the plain version's, its bf16 output within one bf16 step; the sums
    without the last 128 rows of K must differ. Returns the largest
    absolute error of the output."""
    from tokenpacker_tpu_torch.ops.q8_matmul import s8_matmul_plain
    from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm, s8_gemm_plain

    y, xq, ax, acc = s8_gemm(x, wq, wscale, parts=True)
    py, pxq, pax, pacc = s8_gemm_plain(x, wq, wscale, parts=True)
    rows_eq = torch.equal(xq, pxq) and torch.equal(ax, pax)
    acc_eq = torch.equal(acc, pacc)
    steps = (y.view(torch.int16).int() - py.view(torch.int16).int()).abs().max().item()
    lost_eq = torch.equal(s8_matmul_plain(pxq[:, :-128], wq[:-128]), pacc)
    ok = rows_eq and acc_eq and steps <= 1 and bool(torch.isfinite(y.float()).all())
    err = (y.float() - py.float()).abs().max().item()
    print(f"  {name}: int8 rows and scales bit-equal {rows_eq}, int32 sums bit-equal {acc_eq}, "
          f"output within {steps} bf16 steps (limit 1), max_abs_err {err:.3e}; without the last "
          f"128 rows of K the sums bit-equal {lost_eq} {'OK' if ok and not lost_eq else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    if lost_eq:
        raise AssertionError(f"{name}: the check does not see the last 128 rows lost")
    return err


def tile_rel_rms(got: torch.Tensor, want: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """[N, tiles, H]: ||got - want|| / ||want|| over each (sample, `tile`
    positions, head) block of [N, T, H, d] tensors; a block whose plain
    values are all zero reads 0 if the kernel's are too, else inf."""
    n, t, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -t % tile)

    def blocks(x):
        return torch.nn.functional.pad(x, pad).view(n, -1, tile, h, d).sum((2, 4))

    num, den = blocks((got.float() - want.float()).square()), blocks(want.float().square())
    return torch.where(den > 0, (num / den.clamp_min(1e-30)).sqrt(),
                       torch.where(num > 0, torch.inf, 0.0))


def compare_tiles(name: str, got: torch.Tensor, want: torch.Tensor, tile: int = 64,
                  losts: dict | None = None) -> float:
    """Hold [N, T, H, d] kernel outputs to TILE_REL_RMS block by block
    (`tile_rel_rms`), and show the measure's power: the same output with
    its last tile zeroed, as a kernel that loses that tile would give it,
    must fail, and so must every output of `losts` ({what it lost: a lossy
    output}; a non-finite reading fails). Returns the largest absolute
    error."""
    rel = tile_rel_rms(got, want, tile)
    worst = rel.max().item()
    where = np.unravel_index(int(rel.argmax()), tuple(rel.shape))
    lost = got.clone()
    lost[:, -tile:] = 0
    lost_reads = tile_rel_rms(lost, want, tile).max().item()
    lossy = {what: tile_rel_rms(out, want, tile).max().item() for what, out in (losts or {}).items()}
    err = (got.float() - want.float()).abs().max().item()
    ok = worst <= TILE_REL_RMS and bool(torch.isfinite(got.float()).all())
    print(f"  {name}: worst {tile}-position block relative RMS {worst:.4e} (sample {where[0]}, "
          f"positions from {where[1] * tile}, head {where[2]}), median {rel.median().item():.4e}, "
          f"limit {TILE_REL_RMS}; with the last {tile} positions zeroed {lost_reads:.4f} (their "
          f"largest plain value {want[:, -tile:].abs().max().item():.3e})"
          + "".join(f"; {what} {r:.4f}" for what, r in lossy.items())
          + f"; max_abs_err {err:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({worst})")
    if lost_reads <= TILE_REL_RMS:
        raise AssertionError(f"{name}: the block measure does not see a lost tile")
    for what, r in lossy.items():
        if r <= TILE_REL_RMS:
            raise AssertionError(f"{name}: the block measure does not see {what} ({r})")
    return err


def compare_flash_fwd(name: str, out, want, losts: dict | None = None) -> float:
    """K2's forward (o, lse) against its plain version: o block by block
    (`losts`: lossy o's that must fail it), lse absolutely; an infinite lse
    (a row that sees no key, or whose biased logits all lie below -1e30)
    must be the same infinity in both. Returns the largest absolute error."""
    err = compare_tiles(name + " o", out[0], want[0], losts=losts)
    inf = torch.isinf(want[1])
    same_inf = torch.equal(torch.isinf(out[1]), inf) and torch.equal(out[1][inf], want[1][inf])
    lse_err = (out[1][~inf] - want[1][~inf]).abs().max().item()
    ok = same_inf and lse_err <= LSE_ATOL
    print(f"  {name} lse: max_abs_err={lse_err:.3e} limit {LSE_ATOL}, {int(inf.sum())} infinite "
          f"entries {'the same' if same_inf else 'DIFFERENT'} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: lse differs from the plain version's by {lse_err} "
                             f"(infinities the same: {same_inf})")
    return max(err, lse_err)


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


HD_SIZES = ((1008, 1008), (900, 600), (400, 1100), (500, 500))  # phase 6's images (w, h)


def make_hd_requests(cfg, seed: int, sizes=HD_SIZES, text_lens=(300, 200, 120, 40)):
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


def k4_bytes_flops(lc, b: int, keys: int, int8: bool, t: int = 1) -> tuple[float, float]:
    """What one K4 call must move and compute: every weight once (int8 +
    f32 scales + bf16 norms), each valid cache row once (K and V, int8 +
    f32 scale or bf16), h in and out, the new rows out (k/v bf16 rows and
    the cache rows). `keys`: valid cache rows summed over the samples,
    which all t fed tokens of a sample attend (the verify form, t > 1)."""
    d, f, h, layers = lc.hidden_size, lc.intermediate_size, lc.num_attention_heads, lc.num_hidden_layers
    rows = b * t
    weights = d * 3 * d + d * d + d * 2 * f + f * d
    scales = 4 * (3 * d + d + 2 * f + d) + 2 * 2 * d
    row = d * (1 if int8 else 2) + (4 * h if int8 else 0)  # one position, K or V
    per_layer = weights + scales + 2 * keys * row + 2 * rows * (2 * d + row)
    nbytes = layers * per_layer + 2 * rows * d * 2
    fed = b * t * (t - 1) // 2  # (query, earlier fed key) pairs
    flops = layers * (2 * rows * weights + 4 * (keys * t + fed) * d)
    return nbytes, flops


def phase_kernels(device, hd_lengths: np.ndarray, s_hd: int, span: tuple[int, int],
                  only: str = "") -> dict:
    """Phase 3: every kernel vs its plain version at the paths' shapes
    (`only` "checkpoints": K6 and K7 at MPT-7B's up and down alone;
    "quantized": K6-K8 alone; "speculative": the int8 rows' bit
    check, K9 and K4's verify form alone; "lora": K4-LoRA alone; "mpt":
    K2-bias and K3-ALiBi alone; "flash": every K2 row, and K3-ALiBi;
    "tower": K1 and K9, with the 23-block tower fused and per op; "eval":
    K1, K2's forward at the serving shapes, K4 and K4-verify)."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_lm_on_device, quantize_lm_int8

    rows = {}

    def case(name, kernel, plain, args, library=None, work=None, check=None,
             rate=BF16_FLOP_PER_S, graph=False, library_graph=False, achieved=None):
        out, want = kernel(*args), plain(*args)
        err = check(name, out, want)
        ms = time_ms(lambda: kernel(*args), graph=graph)
        plain_ms = time_ms(lambda: plain(*args))
        lib_ms = time_ms(library, graph=library_graph) if library else None
        b_ms, b_by = bound(*work, rate)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms:.0%} of the kernel's time)"
              + (f", {achieved_rate(achieved, work, rate, ms, b_ms)}" if achieved else ""))
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "case": name}

    def first_and_worst(cases):
        row = dict(cases[0])
        row["max_abs_err"] = max(c["max_abs_err"] for c in cases)
        return row

    def every_case(cases):  # K4-K7: the first row, and every case's own times
        keep = ("case", "ms", "library_ms", "bound_ms", "max_abs_err")
        return {**first_and_worst(cases), "cases": [
            {k: round(c[k], 5) if isinstance(c[k], float) else c[k] for k in keep} for c in cases]}

    print("phase 3: kernels vs plain versions (bf16; times: the median of 3 runs of back-to-back "
          "calls between one CUDA event pair; K3, K5, K6, K7 and K8 a CUDA graph of 20 "
          "launches, K3's, K5's and K8's library calls too)")
    if only in ("", "probes", "flash"):
        rows["flash_attention_full_bias"] = first_and_worst(
            full_bias_kernel_cases(device, case, hd_lengths))
    if only == "probes":
        return rows
    if only in ("", "parallel"):  # configuration S's per-rank shapes
        rows.update(rank_kernel_rows(device, case, every_case))
    if only == "parallel":
        rows.update({name: every_case(cases)
                     for name, cases in rank_quantized_cases(device, case).items()})
        return rows
    if only in ("", "mpt", "flash"):
        rows.update(mpt_kernel_cases(device, case, hd_lengths, span))
    if only == "mpt":
        return rows
    if only == "flash":
        rows.update(k2_kernel_rows(device, case, first_and_worst))
        return rows
    if only == "lora-train":  # the kernels configuration Q launches: K1, K2 at the training shape
        rows.update(k1_kernel_rows(device, case, first_and_worst))
        rows.update(phase_kernels_training_shape(device, case))
        return rows
    if only == "tower":
        rows.update(k1_kernel_rows(device, case, first_and_worst))
        rows["vit_block"] = first_and_worst(k9_cases(device, case))
        return rows
    if only == "eval":  # configuration R's kernels: K1, K2's forward, then K4 and K4-verify
        rows.update(k1_kernel_rows(device, case, first_and_worst))
        rows.update(k2_serving_rows(device, case, first_and_worst))
    if only == "checkpoints":  # K6 and K7 at MPT-7B's up and down, which phase 30 launches
        return {name: every_case(cases)
                for name, cases in quantized_kernel_cases(device, case, ("mpt",)).items()}
    if only == "quantized":  # and K3 and K5, which E and F (phases 12, 14) launch
        rows.update(k3_kernel_rows(device, case, first_and_worst))
        rows.update(k5_to_k8_rows(device, case, first_and_worst, every_case))
        return rows
    if only == "":
        rows.update(earlier_kernel_rows(device, case, first_and_worst, every_case))
        # K7's and K8's per-rank cases (configuration S) join their rows' cases
        for name, cases in rank_quantized_cases(device, case).items():
            rows[name].setdefault("cases", []).extend(every_case(cases)["cases"])
    if only in ("", "speculative"):
        check_int8_rows(device)
        rows["vit_block"] = first_and_worst(k9_cases(device, case))
    # K4, its verify form and K4-LoRA at phase 6's last decode step: random
    # Vicuna-7B layers quantized to int8, the HD requests' ranges
    lc = preset_config(HD_PRESET).lm
    layers = quantize_lm_int8({"lm": init_lm_on_device(lc, SEED + 5, device)})["lm"]["layers"]
    if only in ("", "eval"):  # and at phase 34's batches of 16 and 14 rows
        rows["fused_decode"] = every_case(
            k4_cases(device, lc, layers, hd_lengths, s_hd, span)
            + k4_batch_cases(device, lc, layers, hd_lengths, s_hd, span))
    if only in ("", "speculative", "eval"):
        rows["fused_verify"] = verify_kernel_cases(device, lc, layers, hd_lengths, s_hd, span)
    if only in ("", "lora"):
        rows.update(lora_kernel_cases(device, lc, layers, hd_lengths, s_hd, span))
    del layers
    torch.cuda.empty_cache()
    return rows


def k1_kernel_rows(device, case, first_and_worst) -> dict:
    """Phase 3's row of K1: the tower's attention at 8 views, [8, 577, 1024]
    with 16 heads of 64, against its plain version block by block, SDPA
    as its library column, with its achieved TFLOP/s."""
    from tokenpacker_tpu_torch.ops import vit_attention as k1

    n, t, w, heads = 8, 577, 1024, 16
    q, k, v = (bf16((n, t, w), s, device) for s in range(3))
    qh, kh, vh = (x.view(n, t, heads, w // heads) for x in (q, k, v))
    return {"vit_attention": first_and_worst([case(
        "K1 vit_attention [8,577,1024] 16 heads", k1.vit_attention, k1.vit_attention_plain,
        (q, k, v, heads), library=lambda: sdpa(qh, kh, vh),
        work=(4 * n * t * w * 2, 4 * n * heads * t * t * (w // heads)),
        check=lambda name, out, want: compare_tiles(name, out.view(n, t, heads, -1),
                                                    want.view(n, t, heads, -1)),
        achieved="ops")])}


def earlier_kernel_rows(device, case, first_and_worst, every_case) -> dict:
    """Phase 3's rows of K1, K2 (both directions), K3, K5 and K6-K8."""
    rows = k1_kernel_rows(device, case, first_and_worst)
    rows.update(k2_kernel_rows(device, case, first_and_worst))
    rows.update(k3_kernel_rows(device, case, first_and_worst))
    rows.update(k5_to_k8_rows(device, case, first_and_worst, every_case))
    return rows


def k5_to_k8_rows(device, case, first_and_worst, every_case) -> dict:
    """Phase 3's rows of K5 and K6-K8; K5's, K6's and K7's keep every case's
    row."""
    rows = {"paged_attention": every_case(paged_kernel_cases(device, case))}
    for name, cases in quantized_kernel_cases(device, case).items():
        rows[name] = (every_case if name in ("q4_matmul", "s8_matmul") else first_and_worst)(cases)
    return rows


def k3_kernel_rows(device, case, first_and_worst) -> dict:
    """Phase 3's rows of K3: q [4, 32, 128] over a cache of S = 1040, 32 kv
    heads with a decoded span after slot 1000 and without one, and 8 kv
    heads with the span; per (sample, head) row, failing the plain version
    without the span (or the last 64 keys). Kernel and SDPA each timed as a
    CUDA graph of 20 calls: at ~0.02 ms a call, back-to-back calls would
    time the host's launch cost."""
    from tokenpacker_tpu_torch.ops import decode_attention as k3

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
        # the lost version: without the decoded span, or without the last
        # 64 keys where there is one range
        fewer = (torch.full_like(needed, span_start) if span_start
                 else torch.where(needed > 64, needed - 64, needed))
        lost_args = (q, ck, cv, lengths, fewer, span_start)
        cases.append(case(
            f"K3 decode q[4,32,128] cache S={s} kv heads {hkv} span_start={span_start}",
            k3.decode_attention, k3.decode_attention_plain,
            (q, ck, cv, lengths, needed, span_start),
            library=lambda q=q, ck=ck, cv=cv, mask=mask, hkv=hkv: sdpa(
                q[:, None], ck, cv, attn_mask=mask, enable_gqa=hkv != 32),
            work=(2 * keys * hkv * 128 * 2 + 2 * n * 32 * 128 * 2 + 2 * n * 4,
                  4 * keys * 32 * 128),
            check=lambda name, out, want, lost_args=lost_args: compare_rows(
                name, out, want, k3.decode_attention_plain(*lost_args)),
            graph=True, library_graph=True, achieved="bytes"))
    return {"decode_attention": first_and_worst(cases)}


def k4_cases(device, lc, layers, hd_lengths: np.ndarray, s_hd: int,
             span: tuple[int, int], caches: tuple = (True, False)) -> list[dict]:
    """Phase 3, K4 at phase 6's last decode step, at int8 and bf16 caches
    (`caches`: int8 or not, in turn), one row a request of `hd_lengths`."""
    from tokenpacker_tpu_torch.models.llama import KVCache
    from tokenpacker_tpu_torch.ops import fused_decode as k4
    from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv

    # K4 at phase 6's last decode step: the HD requests' prompt rows
    # [0, len0) plus the decoded span [L, L + 30), the new row at L + 30.
    # Held against the plain version at 2 full-width layers (the JAX
    # package's own depth and bound for this check); timed at all 32.
    b = len(hd_lengths)
    len0 = torch.as_tensor(hd_lengths, dtype=torch.int32, device=device)
    start2 = torch.full_like(len0, span[0])
    end2 = torch.full_like(len0, span[1])
    args = (len0, start2, end2, end2, len0 + (span[1] - span[0]))
    h0 = (0.02 * torch.randn((b, lc.hidden_size), device=device,
                             generator=torch.Generator(device=device).manual_seed(SEED + 6))).bfloat16()
    keys = int(np.minimum(hd_lengths, s_hd).sum()) + b * (span[1] - span[0])
    cases = []
    for int8 in caches:
        cache = random_cache(lc, b, s_hd, int8, SEED + 7, device)
        tag = f"K4 fused_decode B={b} S={s_hd} {'int8' if int8 else 'bf16'} cache"

        # 2 layers on a copy of the first 2 with V scaled by K4_V_GAIN:
        # kernel on the copy, plain on an untouched clone of it, and plain
        # without the decoded span (end2 = start2) for the measure's power
        lc2 = dataclasses.replace(lc, num_hidden_layers=2)
        c2 = KVCache(cache.k[:2].clone(), cache.v[:2].clone(), 0,
                     *((cache.k_scale[:2].clone(), cache.v_scale[:2].clone())
                       if int8 else (None, None)))
        (c2.v_scale if int8 else c2.v).mul_(K4_V_GAIN)
        kc, vc = c2.k.clone(), c2.v.clone()
        hidden, k_new, v_new = k4.fused_decode_hidden(
            {"layers": layers[:2]}, lc2, h0, c2.k, c2.v, *args, k_scale=c2.k_scale,
            v_scale=c2.v_scale)

        def plain2(end):
            return k4.fused_decode_hidden_plain(layers[:2], lc2, h0, kc, vc, args[0], args[1],
                                                end, args[4], c2.k_scale, c2.v_scale)

        (p_hidden, p_k, p_v), (l_hidden, l_k, l_v) = plain2(args[2]), plain2(args[1])

        def heads(x):  # [B, D] -> [B, 32, 128] (sample, 128-wide slice)
            return x.view(b, -1, 128)

        err = compare_rows(tag + " 2 layers hidden per (sample, head slice)", heads(hidden),
                           heads(p_hidden), heads(l_hidden))
        compare_rows(tag + " 2 layers new k, v rows per (k|v, layer, sample, head)",
                     torch.stack((k_new, v_new)), torch.stack((p_k, p_v)),
                     torch.stack((l_k, l_v)))
        rows_b, wp = torch.arange(b, device=device), end2.long()
        written = c2.k[:, rows_b, wp]
        if int8:
            written = dequantize_kv(written, c2.k_scale[:, rows_b, wp], torch.float32)
        compare_rows(tag + " 2 layers cache k row written", written, p_k, l_k)

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
              f"ms, library none, bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of the kernel's "
              f"time; {keys} valid cache rows)")
        cases.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by, "case": tag})
        del cache, c2, kc, vc, weights, lm
    return cases


def k4_batch_cases(device, lc, layers, hd_lengths: np.ndarray, s_hd: int,
                   span: tuple[int, int]) -> list[dict]:
    """Phase 3, K4 at the rows of phase 34's batches: 16 (a GQA batch) and
    14 (MMBench's rounds), where the kernel takes two 8-row tiles of x a
    pass, the second ragged at 14. The bf16 cache of `load_pretrained_model`'s
    Generator; the prompt lengths are the HD requests' repeated, 37 shorter
    at each repeat, so that no two tiles see the same rows."""
    cases = []
    for rows in (16, 14):
        lengths = np.array([hd_lengths[i % len(hd_lengths)] - 37 * (i // len(hd_lengths))
                            for i in range(rows)], dtype=hd_lengths.dtype)
        cases += k4_cases(device, lc, layers, lengths, s_hd, span, caches=(False,))
        torch.cuda.empty_cache()
    return cases


PAGED_LENGTHS = (65, 300, 701, 1000, 1200, 1500, 1751, 2080)
PAGE_SIZE, PAGES_PER_SEQ, PAGED_SLOTS = 64, 40, 8  # the JAX worker's paged settings


def paged_kernel_cases(device, case) -> list[dict]:
    """Phase 3, K5 at the paged path's shapes: 8 sequences of lengths
    65-2080 over pages of 64 handed out in a shuffled order (no
    sequence's pages are contiguous), 40 blocks each, 32 query heads;
    32 and 8 kv heads, int8 and bf16 pools. Held per (sample, head), the
    plain version with each sequence's last valid page dropped must fail.
    The library yardstick reads the pages already gathered into a dense
    [8, 2560, Hkv, 128] view (dequantized for an int8 pool) with a mask:
    the gather is not timed. Kernel and library each timed as a CUDA graph
    of 20 calls, with the kernel's achieved TB/s."""
    from tokenpacker_tpu_torch.ops import paged_attention as k5
    from tokenpacker_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv

    n, h, d, ps, mp = PAGED_SLOTS, 32, 128, PAGE_SIZE, PAGES_PER_SEQ
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=device)
    dropped = lengths - ((lengths - 1) % ps + 1)
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    table = (torch.randperm(n * mp, generator=g, device=device) + 1).view(n, mp).int()
    gather = table.long()
    valid = torch.arange(mp * ps, device=device)[None, :] < lengths[:, None]
    keys = int(lengths.sum())
    cases = []
    for hkv, int8 in ((32, True), (32, False), (8, True), (8, False)):
        q = bf16((n, h, d), 40, device)
        kf, vf = (torch.randn((n * mp + 1, ps, hkv, d), generator=g, device=device)
                  for _ in range(2))
        if int8:
            (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
            kd, vd = (dequantize_kv(x[gather].view(n, -1, hkv, d), sc[gather].view(n, -1, hkv))
                      for x, sc in ((kp, ks), (vp, vs)))
        else:
            kp, vp, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            kd, vd = (x[gather].view(n, -1, hkv, d) for x in (kp, vp))
        del kf, vf
        args = (q, kp, vp, table, lengths, ks, vs)
        row = hkv * d * (1 if int8 else 2) + (4 * hkv if int8 else 0)  # one position's K or V
        nbytes = 2 * keys * row + 2 * n * h * d * 2 + table.numel() * 4 + n * 4
        cases.append(case(
            f"K5 paged_attention q[{n},{h},{d}] pages of {ps} x {mp} blocks, {hkv} kv heads, "
            f"{'int8' if int8 else 'bf16'} pool, {keys} valid keys",
            k5.paged_attention, k5.paged_attention_plain, args,
            library=lambda q=q, kd=kd, vd=vd, hkv=hkv: sdpa(
                q[:, None], kd, vd, attn_mask=valid[:, None, None, :], enable_gqa=hkv != h),
            work=(nbytes, 4 * keys * h * d),
            check=lambda name, out, want, args=args: compare_rows(
                name, out, want, k5.paged_attention_plain(*args[:4], dropped, *args[5:])),
            graph=True, library_graph=True, achieved="bytes"))
        del kp, vp, ks, vs, kd, vd, args
    torch.cuda.empty_cache()
    return cases


def split_sweep(device) -> None:
    """`--splits`: K5 and K6 at phase 3's shapes (K5's four pools; K6 nf4 at
    qkv for M = 1, 4, 8, 16, 32 and at o, gateup, down and lm_head for M =
    4) launched with each split count 1-8 through the library's entry
    points, each timed as a CUDA graph of 20 calls beside its relative
    error against the plain version; the split count that
    `paged_splits` / `q4_splits` choose is marked. The planners' constants
    are read from this table."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.ops import _build
    from tokenpacker_tpu_torch.ops import paged_attention as k5
    from tokenpacker_tpu_torch.ops import q4_matmul as k6
    from tokenpacker_tpu_torch.ops.kv_quant import quantize_kv
    from tokenpacker_tpu_torch.ops.quantize import q4_meta, quantize_4bit

    lib = _build.library()

    def stream():  # the current one: a graph capture runs on its own
        return torch.cuda.current_stream().cuda_stream

    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def sweep(name, launch, out, want, nbytes, chosen):
        cells = []
        for splits in (1, 2, 4, 8):
            def call(splits=splits):
                _build.check(launch(splits), name)
            call()
            rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
            ms = time_ms(call, graph=True)
            cells.append(f"{'*' if splits == chosen else ''}{splits}: {ms:.4f} ms "
                         f"{nbytes / ms / 1e9:.2f} TB/s (rel {rel:.1e})")
        print(f"  {name}: " + "; ".join(cells))

    print("splits: each split count, CUDA graphs of 20 calls (* the planner's choice)")
    n, h, d, ps, mp = PAGED_SLOTS, 32, 128, PAGE_SIZE, PAGES_PER_SEQ
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=device)
    table = (torch.randperm(n * mp, generator=g, device=device) + 1).view(n, mp).int()
    keys = int(lengths.sum())
    for hkv, int8 in ((32, True), (32, False), (8, True), (8, False)):
        q = bf16((n, h, d), 40, device)
        kf, vf = (torch.randn((n * mp + 1, ps, hkv, d), generator=g, device=device)
                  for _ in range(2))
        if int8:
            (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        else:
            kp, vp, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
        del kf, vf
        out = torch.empty_like(q)
        row = hkv * d * (1 if int8 else 2) + (4 * hkv if int8 else 0)
        sweep(f"K5 {hkv} kv heads {'int8' if int8 else 'bf16'} pool",
              lambda splits, q=q, kp=kp, vp=vp, ks=ks, vs=vs, out=out, hkv=hkv, int8=int8:
              lib.tp_paged_attention(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                     ks.data_ptr() if int8 else None,
                                     vs.data_ptr() if int8 else None, table.data_ptr(),
                                     lengths.data_ptr(), out.data_ptr(), n, h, hkv, d, ps, mp,
                                     int(int8), splits, stream()),
              out, k5.paged_attention_plain(q, kp, vp, table, lengths, ks, vs), 2 * keys * row,
              k5.paged_splits(n, hkv, mp, ps, sms))
        del kp, vp, ks, vs
    cfg_lm = preset_config(HD_PRESET).lm
    dm, f, vocab = cfg_lm.hidden_size, cfg_lm.intermediate_size, cfg_lm.vocab_size
    shapes = {"qkv": (dm, 3 * dm), "o": (dm, dm), "gateup": (dm, 2 * f), "down": (f, dm),
              "lm_head": (dm, vocab)}
    for name, (k, nn) in shapes.items():
        leaf = quantize_4bit(torch.randn((k, nn), generator=g, device=device) * 0.02, 64, "nf4")
        packed, absmax = leaf[q4_meta(leaf)[0]], leaf["absmax"]
        for m in ((1, 4, 8, 16, 32) if name == "qkv" else (4,)):
            x = torch.randn((m, k), generator=g, device=device).bfloat16()
            out = torch.empty((m, nn), dtype=torch.bfloat16, device=device)
            sweep(f"K6 nf4 {name} x[{m},{k}]",
                  lambda splits, x=x, out=out, m=m, k=k, nn=nn, packed=packed, absmax=absmax:
                  lib.tp_q4_matmul(x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
                                   out.data_ptr(), m, k, nn, 1, splits, stream()),
                  out, k6.q4_matmul_plain(x, leaf), k * nn // 2 + k // 64 * nn * 4,
                  k6.q4_splits(k, nn, sms))
        del leaf, packed, absmax
    torch.cuda.empty_cache()


def int_mm_call(xq: torch.Tensor, wq: torch.Tensor):
    """The library yardstick of K7 and K8: one torch._int_mm on the same
    int8 operands (rows zero-padded to 32 where there are 16 or fewer,
    which it refuses), or None where it refuses the shapes."""
    a = xq if xq.shape[0] > 16 else torch.nn.functional.pad(xq, (0, 0, 0, 32 - xq.shape[0]))
    try:
        torch._int_mm(a, wq)
    except RuntimeError as e:
        print(f"  torch._int_mm refuses [{a.shape[0]},{a.shape[1]}] x [{wq.shape[0]},"
              f"{wq.shape[1]}]: {str(e).splitlines()[0]}")
        return None
    return lambda: torch._int_mm(a, wq)


def quantized_kernel_cases(device, case, which: tuple = ("hd", "mpt")) -> dict:
    """Phase 3, K6, K7 and K8 at TokenPacker-HD-7b's product shapes (the
    fused Vicuna-7B layout, [K, N]: qkv, o, gateup, down, lm_head; CLIP-L's
    q/k/v/o, fc1, fc2), random weights quantized on the card. K6, nf4 and
    int4, at M = 4 (E's decode), 1, 8, 32, held per (row, 128-wide output
    slice) against its plain version, which must fail that hold without
    the last 64 rows of K; library: x @ the already dequantized bf16
    weight. K7 at M = 8 (F's decode), 64, 1, 16 and 32, K8 at M = 256 (F's admission
    chunks) and 2048 on the LM and 26 x 577 (B's 26 crops) on the tower,
    held bit for bit (`compare_exact`, `compare_s8_gemm`); library:
    torch._int_mm on the same int8 operands; bound at the int8 rate. K6's
    rows print their achieved TB/s (above 3.35 where the graph's 20 calls
    find the weight in the 50 MB L2). `which` "mpt" adds (alone: only)
    MPT-7B's two products that no HD-7b product has the shape of, up
    [4096, 16384] and down [16384, 4096] (K = 16384 splits K further than
    Vicuna's largest, 11008): K6 nf4 at M = 4 and 32 (phase 30's decode
    and K6's largest M), K7 at M = 8 and 64, held as above. Returns
    {kernel name: [case rows]}, the first row the main path's."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.models.mpt import mpt_config
    from tokenpacker_tpu_torch.ops import q4_matmul as k6
    from tokenpacker_tpu_torch.ops import q8_matmul as k7
    from tokenpacker_tpu_torch.ops import s8_gemm as k8
    from tokenpacker_tpu_torch.ops.quantize import dequantize_4bit, quantize_4bit, quantize_int8

    cfg = preset_config(HD_PRESET)
    d, f, vocab = cfg.lm.hidden_size, cfg.lm.intermediate_size, cfg.lm.vocab_size
    lm_shapes = {"qkv": (d, 3 * d), "o": (d, d), "gateup": (d, 2 * f), "down": (f, d),
                 "lm_head": (d, vocab)}
    mc = mpt_config()
    mpt_f = mc.intermediate_size
    mpt_shapes = {"MPT-7B up": (mc.hidden_size, mpt_f), "MPT-7B down": (mpt_f, mc.hidden_size)}
    w, wi = cfg.vision.hidden_size, cfg.vision.intermediate_size
    tower_shapes = {"tower q/k/v/o": (w, w), "tower fc1": (w, wi), "tower fc2": (wi, w)}
    g = torch.Generator(device=device).manual_seed(SEED + 11)

    def weight(k, n):
        return torch.randn((k, n), generator=g, device=device) * 0.02

    def acts(m, k):
        return torch.randn((m, k), generator=g, device=device).bfloat16()

    def slices(y):  # [M, N] -> [M, N / 128, 128]
        return y.view(y.shape[0], -1, 128)

    def k6_cases(qt, name, k, n, ms):
        leaf = quantize_4bit(weight(k, n), 64, qt)
        dense = dequantize_4bit(leaf, torch.bfloat16)
        for m in ms:
            x = acts(m, k)
            lost = x.clone()
            lost[:, -64:] = 0
            out["q4_matmul"].append(case(
                f"K6 q4_matmul {qt} {name} x[{m},{k}] W[{k},{n}]", k6.q4_matmul,
                k6.q4_matmul_plain, (x, leaf), library=lambda x=x, dense=dense: x @ dense,
                graph=True, achieved="bytes",
                work=(m * k * 2 + k * n // 2 + k // 64 * n * 4 + m * n * 2, 2 * m * k * n),
                check=lambda nm, got, want, lost=lost, leaf=leaf: compare_rows(
                    nm + " per (row, 128-wide slice)", slices(got), slices(want),
                    slices(k6.q4_matmul_plain(lost, leaf)), "the last 64 rows of K")))

    def k7_cases(name, k, n, ms):
        wq, _ = quantize_int8(weight(k, n))
        for m in ms:
            xq, _ = k7.quantize_activations(acts(m, k))
            out["s8_matmul"].append(case(
                f"K7 s8_matmul {name} xq[{m},{k}] wq[{k},{n}]", k7.s8_matmul, k7.s8_matmul_plain,
                (xq, wq), library=int_mm_call(xq, wq), rate=INT8_OPS_PER_S, graph=True,
                work=(m * k + k * n + m * n * 4, 2 * m * k * n),
                check=lambda nm, got, want, xq=xq, wq=wq: compare_exact(
                    nm, got, want, k7.s8_matmul_plain(xq[:, :-128], wq[:-128]))))

    out = {"q4_matmul": [], "s8_matmul": [], "s8_gemm": []}
    if "hd" in which:
        for qt in ("nf4", "int4"):
            for name, (k, n) in lm_shapes.items():
                k6_cases(qt, name, k, n, (4, 1, 8, 32))
        for name, (k, n) in lm_shapes.items():
            k7_cases(name, k, n, (8, 64, 1, 16, 32))
        k8_shapes = [(nm, sh, (256, 2048)) for nm, sh in lm_shapes.items() if nm != "lm_head"]
        k8_shapes += [(nm, sh, (26 * 577,)) for nm, sh in tower_shapes.items()]
        for name, (k, n), ms in k8_shapes:
            wq, ws = quantize_int8(weight(k, n))
            for m in ms:
                x = acts(m, k)
                xq, _ = k7.quantize_activations(x)
                out["s8_gemm"].append(case(
                    f"K8 s8_gemm {name} x[{m},{k}] wq[{k},{n}]", k8.s8_gemm, k8.s8_gemm_plain,
                    (x, wq, ws), library=int_mm_call(xq, wq), rate=INT8_OPS_PER_S,
                    work=(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n),
                    check=lambda nm, got, want, args=(x, wq, ws): compare_s8_gemm(nm, *args),
                    graph=True, library_graph=True, achieved="ops"))
                del x, xq
            del wq, ws
    if "mpt" in which:
        for name, (k, n) in mpt_shapes.items():
            k6_cases("nf4", name, k, n, (4, 32))
        for name, (k, n) in mpt_shapes.items():
            k7_cases(name, k, n, (8, 64))
    torch.cuda.empty_cache()
    return {name: cases for name, cases in out.items() if cases}


def k2_kernel_rows(device, case, first_and_worst) -> dict:
    """Phase 3's rows of K2 without a bias: the forward at the serving
    shapes (`k2_serving_rows`), then both directions at the training shape
    (`phase_kernels_training_shape`)."""
    rows = k2_serving_rows(device, case, first_and_worst)
    rows.update(phase_kernels_training_shape(device, case))
    return rows


def k2_serving_rows(device, case, first_and_worst) -> dict:
    """Phase 3's row of K2's forward at the serving shapes: A's bucket of
    512, and 700 with 32 and 8 kv heads."""
    from tokenpacker_tpu_torch.ops import flash_attention as k2

    cases = []
    for t, hkv in ((512, 32), (700, 32), (700, 8)):
        q = bf16((2, t, 32, 128), 10, device)
        kk, vv = bf16((2, t, hkv, 128), 11, device), bf16((2, t, hkv, 128), 12, device)
        nbytes = 2 * (2 * t * 32 * 128) * 2 + 2 * (2 * t * hkv * 128) * 2 + 2 * 32 * t * 4
        cases.append(case(
            f"K2 flash causal q[2,{t},32,128] kv heads {hkv}", k2.flash_attention,
            k2.flash_attention_plain, (q, kk, vv, True), check=compare_flash_fwd,
            library=lambda q=q, kk=kk, vv=vv: sdpa(q, kk, vv, is_causal=True,
                                                   enable_gqa=hkv != 32),
            work=(nbytes, 4 * 2 * 32 * 128 * t * (t + 1) / 2), achieved="ops"))
    return {"flash_attention": first_and_worst(cases)}


def phase_kernels_training_shape(device, case) -> dict:
    """Phase 3, K2 at phase 8's training shape: the forward checked and
    timed against its plain version; the backward checked (dq, dk, dv
    block by block), run twice for determinism, and timed. Its plain version runs one sample at a time (fp32 [32,
    2048, 2048] scores are 512 MB a sample); the timed plain call is that
    whole loop."""
    from tokenpacker_tpu_torch.ops import flash_attention as k2

    n, t, h, d = TRAIN_BATCH, TRAIN_SEQ, 32, 128
    q, k, v, do = (bf16((n, t, h, d), 30 + i, device) for i in range(4))
    pairs = n * h * t * (t + 1) / 2  # visible (query, key) pairs
    elems = n * t * h * d
    fwd = case(f"K2 flash causal q[{n},{t},{h},{d}] (training shape)", k2.flash_attention,
               k2.flash_attention_plain, (q, k, v, True), check=compare_flash_fwd,
               library=lambda: sdpa(q, k, v, is_causal=True),
               work=(4 * elems * 2 + n * h * t * 4, 4 * d * pairs), achieved="ops")
    torch.cuda.empty_cache()
    o, lse = k2.flash_attention(q, k, v, True)

    def kernel():
        return k2.flash_attention_bwd(q, k, v, o, lse, do, True)

    def plain():
        parts = [k2.flash_attention_bwd_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1],
                                              lse[i * h:(i + 1) * h], do[i:i + 1], True)
                 for i in range(n)]
        return tuple(torch.cat(x) for x in zip(*parts))

    tag = f"K2-bwd flash causal q[{n},{t},{h},{d}]"
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two identical calls differ")
    want = plain()
    err = max(compare_tiles(f"{tag} {name}", g, w)
              for g, w, name in zip(got, want, ("dq", "dk", "dv")))
    del got, again, want
    print(f"  {tag}: two calls identical")
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    dol = do.transpose(1, 2)
    ms, plain_ms = time_ms(kernel), time_ms(plain, iters=3, warmup=1)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True))
    b_ms, b_by = bound(8 * elems * 2 + n * h * t * 4, 5 * 2 * d * pairs)
    print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (8 samples one by one), library "
          f"{lib_ms:.4f} ms (SDPA backward alone), bound {b_ms:.4f} ms ({b_by}), "
          f"{achieved_tflops(5 * 2 * d * pairs, ms)} (the bound's five products; the kernels "
          f"run seven)")
    del q, k, v, do, o, lse, ql, kl, vl, out
    torch.cuda.empty_cache()
    return {"flash_attention_train": fwd,
            "flash_attention_bwd": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}}


def tower_blocks(cfg) -> int:
    vc = cfg.vision  # blocks past the deepest consumed layer are skipped
    return max(vc.num_hidden_layers + 1 + vc.select_layer, *vc.multi_layers)


def counter(c) -> tuple:
    """(wrapper, attribute) of a launch counter: a kernel wrapper counts on
    `launches`, and a kernel form of its own on another attribute
    (`flash_attention.bias_launches`, ...)."""
    return c if isinstance(c, tuple) else (c, "launches")


def reset_counts(counters: dict) -> None:
    for c in counters.values():
        setattr(*counter(c), 0)


def read_counts(counters: dict) -> dict:
    return {k: getattr(*counter(c)) for k, c in counters.items()}


def check_generation(name, gen, batch, cfg, want: dict, counters: dict,
                     tokens: list | None = None) -> dict:
    """Two identical greedy calls: launch counts of the first against
    `want` (`counters`: {name: wrapper or (wrapper, attribute)}), tokens in
    the vocabulary, finite logits, identical tokens (appended to `tokens`
    if given). Prints TTFT, decode rate and peak memory of the second."""
    n, l = batch["token_ids"].shape
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    first = gen.generate(batch, max_new_tokens=NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    launches = read_counts(counters)
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
    if tokens is not None:
        tokens.append(toks)
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


def band_check(name, gpu_logits, cpu_logits, band: float = LOGIT_BAND):
    """Card logits within `band` of the CPU's; top-1 equal where the CPU
    margin exceeds the band."""
    diff = (gpu_logits - cpu_logits).abs().max().item()
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = gpu_logits.argmax(-1) == cpu_logits.argmax(-1)
    if diff > band:
        raise AssertionError(f"{name}: card vs CPU logits differ by {diff} > {band}")
    if not bool(agree[margin > band].all()):
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


def phase_hd_4bit(device, seed: int, batch, blocks) -> dict:
    """Phase 12 (configuration E): TokenPacker-HD-7b with its LM quantized
    by `quantize_lm_4bit` (nf4, blocks of 64; the load_4bit form) and a
    bf16 KV cache (the JAX default) answers phase 6's 4 HD requests with 32
    greedy tokens: the per-layer decode, K3 for attention and K6 for every
    product of a step (4 a layer and the LM head), besides the prefill's
    LM head over the 4 last positions."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_4bit
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    cfg = preset_config(HD_PRESET)
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    bf16_lm = tree_bytes(params["lm"])
    quantize_lm_4bit(params, "nf4")
    torch.cuda.synchronize()
    print(f"phase 12: {HD_PRESET}, random weights from seed {seed}, LM quantized to nf4 on the "
          f"card ({bf16_lm / 2**30:.3f} -> {tree_bytes(params['lm']) / 2**30:.3f} GiB) in "
          f"{time.perf_counter() - t0:.2f} s; bf16 KV cache")
    n, l = batch["token_ids"].shape
    print(f"  requests: {n}, grids {blocks}, crops {batch['images'].shape[0]}, spliced lengths "
          f"{batch['lengths'].tolist()}, bucket {l}")
    gen = Generator(params, cfg)
    if gen.fused is not False:
        raise AssertionError("phase 12: a 4-bit tree must decode per layer")
    depth = cfg.lm.num_hidden_layers
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_decode": fused_decode_hidden,
                "q4_matmul": q4_matmul}
    want = {"vit_attention": tower_blocks(cfg), "flash_attention": depth,
            "decode_attention": depth * (NEW_TOKENS - 1), "fused_decode": 0,
            "q4_matmul": (4 * depth + 1) * (NEW_TOKENS - 1) + 1}
    launches = check_generation("phase 12", gen, batch, cfg, want, counters)
    del params, gen
    torch.cuda.empty_cache()
    return launches


def phase_4bit_parity(device, seed: int) -> None:
    """Phase 13: full widths, 2 LM layers, the LM 4-bit, a bf16 cache:
    prefill and 8 decode steps (nf4), prefill and 1 step (int4) on the
    card (bf16, K6) against the CPU (fp32, K6's plain version) from the
    same 4-bit leaves; both sides fed the CPU's greedy tokens."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_4bit
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul

    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    batch, blocks = make_hd_requests(cfg, seed + 1, sizes=((672, 336), (336, 336)),
                                     text_lens=(40, 70))
    l = batch["token_ids"].shape[1]
    lengths = {"gpu": torch.as_tensor(batch["lengths"], device=device),
               "cpu": torch.as_tensor(batch["lengths"])}
    for quant_type, steps in (("nf4", 8), ("int4", 1)):
        params = quantize_lm_4bit(init_vlm_on_device(cfg, seed=seed, device=device,
                                                     dtype=torch.bfloat16), quant_type)
        sides = {
            "gpu": (params, cfg, device_batch(batch, torch.bfloat16, device)),
            "cpu": (params_to(params, "cpu", torch.float32), cpu_cfg,
                    device_batch(batch, torch.float32, "cpu")),
        }
        q4_matmul.launches = 0
        t0 = time.perf_counter()
        state = {k: prefill(p, c, b, l + steps) for k, (p, c, b) in sides.items()}
        results = []
        for step in range(steps + 1):
            gpu_logits, cpu_logits = state["gpu"][0].float().cpu(), state["cpu"][0].float()
            results.append(band_check(f"phase 13 {quant_type} step {step}", gpu_logits,
                                      cpu_logits))
            if step == steps:
                break
            tok = cpu_logits.argmax(-1)
            for k, (p, c, _) in sides.items():
                state[k] = decode_step(p, c, state[k][1], tok.to(lengths[k].device), lengths[k],
                                       step, l)
        want = 1 + steps * (4 * 2 + 1)
        if q4_matmul.launches != want:
            raise AssertionError(f"phase 13: {q4_matmul.launches} K6 launches on the card, "
                                 f"expected {want}")
        print(f"phase 13: full widths, 2 LM layers, {quant_type} LM + bf16 cache, 2 HD requests "
              f"(grids {blocks}): card bf16 (K6) vs CPU fp32 (plain K6), prefill + {steps} decode "
              f"steps ({time.perf_counter() - t0:.1f} s, {want} K6 launches) max|dlogit| per step "
              f"{[round(r[0], 4) for r in results]} band={LOGIT_BAND}; top-1 margins "
              f"{[[round(m, 4) for m in r[1]] for r in results]}, top-1 agree "
              f"{[r[2] for r in results]}")
        del params, state, sides
        torch.cuda.empty_cache()


class WordTokenizer:
    """Stand-in for the Vicuna tokenizer (no tokenizer is loaded): BOS, then
    one id per word or newline, ids given in order of first sight from 100
    up; "," and "\\n" keep their Vicuna ids SEP_ID and NEWLINE_ID."""

    bos_token_id, pad_token_id = 1, 0

    def __init__(self):
        self.vocab = {",": SEP_ID, "\n": NEWLINE_ID}

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.vocab.setdefault(token, 100 + len(self.vocab))

    def __call__(self, text: str):
        words = re.findall(r"\n|[^\s]+", text)
        return SimpleNamespace(input_ids=[1] + [self.convert_tokens_to_ids(w) for w in words])

    def decode(self, ids, skip_special_tokens=True):
        """Words it has seen, "<id>" for the others (phases 28-29's texts)."""
        words = {i: w for w, i in self.vocab.items()}
        return " ".join(words.get(int(i), f"<{int(i)}>") for i in ids)


def write_caption_dataset(root: Path, n: int, seed: int) -> Path:
    """n records of the stage-1 (LCS-558K) form: a random RGB image of 240 to
    720 pixels a side and a caption of 8 to 63 words from a 2,000-word list,
    as "<image>\\n" / caption turns. Returns the JSON path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2000)]
    records = []
    for i in range(n):
        w, h = (int(x) for x in rng.integers(240, 721, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"im{i}.png")
        caption = " ".join(rng.choice(words, int(rng.integers(8, 64))))
        records.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\n"}, {"from": "gpt", "value": caption}]})
    path = root / "data.json"
    path.write_text(json.dumps(records))
    return path


def fingerprints(tree) -> list[int]:
    """A position-weighted sum (mod 2^64) of every leaf's bit patterns, leaf
    by leaf: any change of a single value changes its leaf's sum."""
    from tokenpacker_tpu_torch.train.step import leaves_with_paths

    out = []
    for _, t in leaves_with_paths(tree):
        bits = t.detach().reshape(-1).view(torch.uint8).to(torch.int64)
        weights = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        out.append(int((bits * weights).sum()))
    return out


def phase_train_stage1(device, seed: int, rows: dict) -> dict:
    """Phase 8: stage 1 of TokenPacker-7b at full width and depth through
    `Trainer.train()`, 3 steps of 8 x 2048 with remat "full"."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
    from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker, import_tokenpacker, strip_prefix
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.train.step import TrainConfig
    from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer

    cfg = TokenPackerVLMConfig()
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    frozen = {part: fingerprints(params[part]) for part in ("vision", "lm")}
    projector0 = export_tokenpacker(params["projector"])
    torch.cuda.synchronize()
    print(f"phase 8: TokenPacker-7b stage 1 (projector trains) through Trainer.train(), random bf16 "
          f"weights from seed {seed} in {time.perf_counter() - t0:.2f} s")
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd}
    steps = TRAIN_RECORDS // TRAIN_BATCH
    depth = cfg.lm.num_hidden_layers
    per_step = {"vit_attention": tower_blocks(cfg), "flash_attention": 2 * depth,
                "flash_attention_bwd": depth}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        tok = WordTokenizer()
        ds = SupervisedDataset(str(write_caption_dataset(root, TRAIN_RECORDS, seed)), tok,
                               image_folder=str(root), version="plain",
                               image_size=cfg.vision.image_size)
        out = root / "out"
        rcfg = RunConfig(output_dir=str(out), per_device_batch_size=TRAIN_BATCH,
                         seq_pad_to=TRAIN_SEQ, remat="full", save_steps=1,
                         save_total_limit=steps, seed=seed)
        trainer = Trainer(cfg, TrainConfig(stage="pretrain", learning_rate=1e-3), rcfg, params,
                          ds, tok)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: steps * v for k, v in per_step.items()}
        print(f"  {TRAIN_RECORDS} records, batch {TRAIN_BATCH} padded to {TRAIN_SEQ}, remat full, "
              f"{steps} steps in {wall:.2f} s (checkpoint writes included); launches {launches}, "
              f"expected {want} (per step: 1 tower pass, 32 K2-fwd + 32 recomputed, 32 K2-bwd)")
        if launches != want:
            raise AssertionError(f"phase 8: kernel launch counts {launches} != {want}")
        for r in trainer.history:
            print(f"  step {r['step']}: loss {r['loss']:.4f}, {r['seconds'] * 1e3:.1f} ms, "
                  f"{r['valid_tokens']} valid / {r['padded_tokens']} padded tokens = "
                  f"{r['valid_tokens'] / r['seconds']:.1f} / {r['padded_tokens'] / r['seconds']:.1f} "
                  f"tok/s, grad_norm {r['grad_norm']:.4f}, peak {r['peak_bytes'] / 2**30:.3f} GiB")
        if not all(np.isfinite(r["loss"]) for r in trainer.history):
            raise AssertionError("phase 8: a non-finite loss")
        for part, before in frozen.items():
            if fingerprints(params[part]) != before:
                raise AssertionError(f"phase 8: the frozen {part} tensors changed")
        saved = [torch.load(out / f"checkpoint-{i}" / "mm_projector.bin", weights_only=True)
                 for i in (1, steps)]
        prefix = "model.mm_projector."
        same1 = all(np.array_equal(saved[0][prefix + k].numpy(), v) for k, v in projector0.items())
        moved3 = any(not np.array_equal(saved[1][prefix + k].numpy(), v) for k, v in projector0.items())
        if not (same1 and moved3):
            raise AssertionError(f"phase 8: projector unchanged after step 1: {same1}, "
                                 f"changed after step {steps}: {moved3}")
        back = import_tokenpacker(strip_prefix(saved[1], prefix), cfg.projector, torch.bfloat16)
        if fingerprints(back) != fingerprints(params["projector"]):
            raise AssertionError("phase 8: mm_projector.bin does not load back to the live projector")
        print(f"  frozen tower and LM bitwise unchanged; projector unchanged after step 1 (lr 0), "
              f"changed after step {steps}; mm_projector.bin ({len(saved[1])} reference keys) "
              f"loads back bit for bit")
    step_s = statistics.median(r["seconds"] for r in trainer.history[1:])
    parts = {label: rows[name]["ms"] * per_step[kernel]
             for label, name, kernel in (("K1", "vit_attention", "vit_attention"),
                                         ("K2-fwd", "flash_attention_train", "flash_attention"),
                                         ("K2-bwd", "flash_attention_bwd", "flash_attention_bwd"))
             if name in rows}  # `--flash` times no K1, `--tower` no K2
    print(f"  step time (median of steps 2-{steps}) {step_s * 1e3:.1f} ms; kernel time x launches "
          f"from phase 3: " + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
          + f" = {sum(parts.values()) / (step_s * 1e3):.3f} of the step")
    del params, trainer
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(device, seed: int) -> None:
    """Phase 9: full widths, 2 LM layers; one stage-2 step (loss, the
    gradient of every trained leaf, the optimizer update) on the card
    (bf16, kernels) and on the CPU (fp32, plain versions) from the same
    weights and batch; then the card's step with K2's backward losing dq,
    or dk and dv, which the bands must fail."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention_bwd

    full = TokenPackerVLMConfig()
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    stage2_parity("phase 9", cfg, device, seed, ("dq", "dk, dv"),
                  (flash_attention_bwd, "launches"), r"lm\.layers\.\d+\.attn\.[qkvo]\.kernel", 8)


def stage2_parity(tag: str, cfg, device, seed: int, lossy: tuple, bwd_counter: tuple,
                  attn_pattern: str, n_attn: int, qlora: bool = False) -> None:
    """One stage-2 step of `cfg` (2 LM layers) on the card and on the CPU
    from the same weights and batch: the loss within LOSS_BAND and every
    trained leaf's gradient within its group's band; the card's step with
    K2's backward made lossy in each way of `lossy` (`lossy_flash_bwd`)
    must fail the bands. `bwd_counter`: the (wrapper, attribute) that
    counts the card step's K2 backward launches, one a layer;
    `attn_pattern`: the attention projections' leaf names (n_attn of
    them), printed one by one. `qlora`: a LoRA step instead, over the LM
    quantized to nf4 (`quantize_tree_4bit`, unfused) with QLORA_RANK
    adapters (b drawn at QLORA_B_SCALE, so that a's gradient is not 0;
    bf16 on both sides, the CPU computing in fp32), the adapters' leaves
    named `lm.layers.i.<group>.<name>.<a|b>` and held at the LM's band,
    the projector at its own."""
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset, collate
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to
    from tokenpacker_tpu_torch.models.vlm import vlm_loss
    from tokenpacker_tpu_torch.ops.quantize import quantize_tree_4bit
    from tokenpacker_tpu_torch.train.lora import (
        LoraConfig,
        init_lora,
        lora_loss,
        make_lora_optimizer,
    )
    from tokenpacker_tpu_torch.train.step import TrainConfig, leaves_with_paths, make_optimizer
    from tokenpacker_tpu_torch.train.trainer import device_train_batch

    params = init_vlm_on_device(cfg, seed=seed + 2, device=device, dtype=torch.bfloat16)
    lcfg = LoraConfig(r=QLORA_RANK, alpha=QLORA_ALPHA)
    adapters = {}
    if qlora:
        params = {**params, "lm": quantize_tree_4bit(params["lm"])}
        lora = init_lora(seed + 4, params, lcfg)
        g = torch.Generator().manual_seed(seed + 5)
        with torch.no_grad():
            for layer in lora["layers"]:
                for sub in layer.values():
                    for ab in sub.values():
                        ab["b"].copy_(torch.randn(ab["b"].shape, generator=g) * QLORA_B_SCALE)
        adapters = {"gpu": lora, "cpu": params_to(lora, "cpu", torch.float32)}
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        tok = WordTokenizer()
        ds = SupervisedDataset(str(write_caption_dataset(Path(tmp), 2, seed + 3)), tok,
                               image_folder=tmp, version="plain", image_size=cfg.vision.image_size)
        batch = collate([ds[0], ds[1]], cfg.tokens_per_view, SEP_ID, NEWLINE_ID, 0, pad_to=256)
    tcfg = TrainConfig(stage="finetune", learning_rate=2e-5)

    def step(p, c, dev, update=True):
        """Loss and {leaf path: fp32 CPU gradient} of every trained leaf."""
        names = {id(t): ".".join(map(str, path)) for path, t in leaves_with_paths(p)}
        if qlora:
            lora = adapters["cpu" if dev == "cpu" else "gpu"]
            opt = make_lora_optimizer(tcfg, lcfg, lora, p["projector"], 1)
            names.update({id(ab[part]): f"lm.layers.{i}.{group}.{name}.{part}"
                          for i, layer in enumerate(lora["layers"])
                          for group, sub in layer.items() for name, ab in sub.items()
                          for part in ("a", "b")})
            loss, _ = lora_loss(lora, p, c, lcfg, device_train_batch(batch, c.dtype, dev))
        else:
            opt = make_optimizer(tcfg, p)
            loss, _ = vlm_loss(p, c, device_train_batch(batch, c.dtype, dev))
        grads = torch.autograd.grad(loss, opt.params)
        if update:
            opt.update(grads, opt.init())
        return loss.item(), {names[id(t)]: g.float().cpu() for t, g in zip(opt.params, grads)}

    def scale_of(k):
        """What leaf k's difference is divided by: its group's norm for the
        zero-gradient leaves, SMALL_LEAF_SHARE of it for a leaf below that
        share, else the leaf's own CPU gradient norm."""
        group = groups[k.split(".")[0]]
        if k in ZERO_GRAD_LEAVES:
            return group
        return max(float(cpu_grads[k].norm()), SMALL_LEAF_SHARE * group)

    def leaf_rel_rms(got, want):
        return {k: float((got[k] - w).square().sum()) ** 0.5 / scale_of(k)
                for k, w in want.items()}

    def by_kind(rel):
        """The worst reading of each leaf kind (layer indices merged)."""
        kinds = {}
        for k, r in rel.items():
            kind = re.sub(r"\.\d+\.", ".*.", k)
            kinds[kind] = max(kinds.get(kind, 0.0), r)
        return kinds

    def beyond(rel):
        """The leaves outside their group's band (a non-finite reading is)."""
        return [k for k, r in rel.items() if not r <= GRAD_REL_RMS_BANDS[k.split(".")[0]]]

    t0 = time.perf_counter()
    cl, cpu_grads = step(cpu_params, cpu_cfg, "cpu")
    groups = {g: float(sum(w.square().sum() for k, w in cpu_grads.items()
                           if k.startswith(g + "."))) ** 0.5 for g in GRAD_REL_RMS_BANDS}
    # the band's power: the card's step with a lossy K2 backward must fail it
    lost = {}
    for which in lossy:
        with lossy_flash_bwd(which):
            lost[which] = leaf_rel_rms(step(params, cfg, device, update=False)[1], cpu_grads)
    setattr(*bwd_counter, 0)
    gl, gpu_grads = step(params, cfg, device)
    torch.cuda.synchronize()
    if getattr(*bwd_counter) != 2:
        raise AssertionError(f"{tag}: {getattr(*bwd_counter)} K2-bwd launches on the card, "
                             "expected 2")
    rel = leaf_rel_rms(gpu_grads, cpu_grads)
    worst = {g: max((k for k in rel if k.startswith(g + ".")), key=rel.get)
             for g in GRAD_REL_RMS_BANDS}
    loss_rel = abs(gl - cl) / abs(cl)
    attn = [k for k in rel if re.fullmatch(attn_pattern, k)]
    if len(attn) != n_attn:
        raise AssertionError(f"{tag}: attention projection leaves {attn}, expected {n_attn}")
    kind = (f"one LoRA step (rank {QLORA_RANK}, nf4 LM)" if qlora else "one stage-2 step")
    print(f"{tag}: full widths, 2 LM layers, 2 records padded to 256, {kind}: card bf16 "
          f"vs CPU fp32 ({time.perf_counter() - t0:.1f} s): loss {gl:.5f} vs {cl:.5f} (relative "
          f"{loss_rel:.2e}, band {LOSS_BAND}); gradient relative RMS difference of {len(rel)} "
          f"leaves, worst " + ", ".join(f"{k} {rel[k]:.4f} (band {GRAD_REL_RMS_BANDS[g]})"
                                        for g, k in worst.items()) + "; 2 K2-bwd launches")
    print("  worst 12 leaf kinds: " + ", ".join(
        f"{k} {r:.4f}" for k, r in sorted(by_kind(rel).items(), key=lambda x: -x[1])[:12]))
    print("  attention projections: " + ", ".join(f"{k} {rel[k]:.4f}" for k in attn))
    # the leaves below SMALL_LEAF_SHARE of their group's gradient norm, and
    # what each would read against its own size
    small = [k for k in cpu_grads if k not in ZERO_GRAD_LEAVES
             and float(cpu_grads[k].norm()) < SMALL_LEAF_SHARE * groups[k.split(".")[0]]]
    print(f"  {len(small)} leaves below {SMALL_LEAF_SHARE} of their group's gradient norm, held "
          f"against that share of it: " + (", ".join(
              f"{k} ({float(cpu_grads[k].norm()) / groups[k.split('.')[0]]:.2e} of its group's) "
              f"{rel[k]:.4f}, against its own size "
              f"{float((gpu_grads[k] - cpu_grads[k]).norm() / cpu_grads[k].norm()):.4f}"
              for k in small) or "none"))
    for which, r in lost.items():
        w = max(r, key=lambda k: r[k] if r[k] == r[k] else np.inf)
        print(f"  K2-bwd losing {which}: {len(beyond(r))} leaves outside their band, worst {w} "
              f"{r[w]:.4f}; attention projections "
              + ", ".join(f"{k} {r[k]:.4f}" for k in attn)
              + f"; projector worst {max(v for k, v in r.items() if k.startswith('projector')):.4f}")
    if not loss_rel <= LOSS_BAND:
        raise AssertionError(f"{tag}: card vs CPU loss differ by {loss_rel} > {LOSS_BAND}")
    if beyond(rel):
        raise AssertionError(f"{tag}: gradients outside their band: "
                             + ", ".join(f"{k} {rel[k]}" for k in beyond(rel)))
    for which, r in lost.items():
        if not beyond(r):
            raise AssertionError(f"{tag}: the bands do not see K2-bwd losing {which}")
    del params, cpu_params, cpu_grads, gpu_grads, adapters
    torch.cuda.empty_cache()


def w8a8_tower_parity(phase: str, vision_q, cfg, images: np.ndarray, device) -> None:
    """Phase 15's first part: the int8 tower (`quantize_tower_int8`, made on
    the card) in the w8a8 mode over one request's views, the card (bf16,
    K8) against the CPU (fp32, K8's plain version) on the same int8 bytes:
    the features of every view within W8A8_TOWER_REL_RMS, and the card's
    tower with K8 losing the last 128 rows of K outside it."""
    from tokenpacker_tpu_torch.io.weights import params_to
    from tokenpacker_tpu_torch.models.clip_vit import clip_tower_features
    from tokenpacker_tpu_torch.ops import q8_matmul as k7
    from tokenpacker_tpu_torch.ops import s8_gemm as k8

    vc = cfg.vision
    imgs = torch.as_tensor(images)
    route = w8a8_route(imgs.shape[0] * vc.seq_len, vc.hidden_size, vc.hidden_size)
    counters = {"s8_gemm": k8.s8_gemm, "s8_matmul": k7.s8_matmul}
    for fn in counters.values():
        fn.launches = 0
    got = clip_tower_features(vision_q, vc, imgs.to(device, torch.bfloat16), w8a8=True)[0]
    launches = {name: fn.launches for name, fn in counters.items()}
    want = clip_tower_features(params_to(vision_q, "cpu", torch.float32), vc, imgs.float(),
                               w8a8=True)[0]
    with lossy_w8a8_products():
        lost = clip_tower_features(vision_q, vc, imgs.to(device, torch.bfloat16), w8a8=True)[0]

    def per_view(x):
        x = x.float().cpu()
        return ((x - want).square().sum((1, 2)) / want.square().sum((1, 2))).sqrt()

    rel, lost_rel = per_view(got), per_view(lost)
    expected = {name: 6 * tower_blocks(cfg) * (route == name) for name in counters}
    print(f"  {phase}: int8 tower, w8a8, {imgs.shape[0]} views x {vc.seq_len} rows: card "
          f"({route}, launches {launches}) vs CPU features, relative RMS per view "
          f"{[round(x, 4) for x in rel.tolist()]} (band {W8A8_TOWER_REL_RMS}); with K8 losing "
          f"the last 128 rows of K {[round(x, 4) for x in lost_rel.tolist()]}")
    if launches != expected:
        raise AssertionError(f"{phase}: tower launches {launches}, expected {expected}")
    if not rel.max().item() <= W8A8_TOWER_REL_RMS:
        raise AssertionError(f"{phase}: w8a8 tower features differ by {rel.max().item()}")
    if not lost_rel.min().item() > W8A8_TOWER_REL_RMS:
        raise AssertionError(f"{phase}: the tower band does not see K8 losing its last rows")
    dev_imgs = imgs.to(device, torch.bfloat16)
    ms = time_ms(lambda: clip_tower_features(vision_q, vc, dev_imgs, w8a8=True), iters=6,
                 warmup=1)
    print(f"  {phase}: one pass of the int8 tower over {imgs.shape[0]} views ({route}, "
          f"{6 * tower_blocks(cfg)} products): {ms:.3f} ms")


@contextlib.contextmanager
def lossy_w8a8_products():
    """Within the block, every product of the w8a8 mode (`ops/layers`' K7
    and K8 routes) loses the last 128 rows of K, as a kernel that drops
    its last K block would: phase 15 shows that its band fails that."""
    from tokenpacker_tpu_torch.ops import layers

    real = {name: getattr(layers, name) for name in ("w8a8_matmul", "w8a8_gemm")}

    def lossy(fn):
        def run(x, leaf):
            x = x.clone()
            x[..., -128:] = 0
            return fn(x, leaf)
        return run

    for name, fn in real.items():
        setattr(layers, name, lossy(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)


@contextlib.contextmanager
def lossy_flash_bwd(which: str):
    """Within the block, K2's backward returns zeros for dq ("dq") or for
    dk and dv ("dk, dv"), as a kernel that loses those outputs would, or
    ("the bias") recomputes P without the key-only bias: phases 9 and 23
    show that their bands fail such a kernel."""
    from tokenpacker_tpu_torch.ops import flash_attention as k2

    kernel = k2.flash_attention_bwd

    def lossy(*args):
        if which == "the bias":
            return kernel(*args[:7])  # q, k, v, o, lse, do, causal
        dq, dk, dv = kernel(*args)
        if which == "dq":
            return torch.zeros_like(dq), dk, dv
        return dq, torch.zeros_like(dk), torch.zeros_like(dv)

    # the kernel counts its launches on the name it is bound to
    lossy.launches = lossy.bias_launches = 0
    k2.flash_attention_bwd = lossy
    try:
        yield
    finally:
        k2.flash_attention_bwd = kernel


def hd_request(cfg, image, text) -> dict:
    """One request's splice plan (batch 1, unpadded) for the batcher: BOS,
    8 text ids, the image (slice mode), the rest of the text."""
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.image.processing import process_images
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    crops, blocks = process_images([image], "slice", cfg.patch_num, cfg.vision.image_size)
    ids = np.concatenate([[1], text[:8], [IMAGE_TOKEN_INDEX], text[8:]]).astype(np.int64)
    plan = build_splice_plan([ids], [blocks], cfg.tokens_per_view, "slice", SEP_ID, NEWLINE_ID)
    return {"token_ids": plan.token_ids, "is_image": plan.is_image, "image_slot": plan.image_slot,
            "lengths": plan.lengths, "images": crops.transpose(0, 2, 3, 1).copy(),
            "grid": blocks[0]}


def paged_requests(cfg, seed: int) -> list[dict]:
    """Phase 10's 10 requests: phase 6's 4 HD requests (the same images and
    text, grids 3x3, 2x3, 3x1, 2x2); 2 repeats of the 3x3 one; 2 that share
    its image and first 200 text ids, then differ; 1 whose 336x336 image
    gives the fewest crops the preset allows (grid 1x1); 1 (a 2x2 image
    with other text) that phase 10 cancels after its 4th token."""
    from PIL import Image

    rng = np.random.default_rng(seed)  # drawn in make_hd_requests' order
    sizes = ((1008, 1008), (900, 600), (400, 1100), (500, 500))
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for w, h in sizes]
    texts = [rng.integers(3, cfg.lm.vocab_size, n) for n in (300, 200, 120, 40)]
    reqs = [hd_request(cfg, im, t) for im, t in zip(images, texts)]
    reqs += [reqs[0], reqs[0]]
    reqs += [hd_request(cfg, images[0], np.concatenate([texts[0][:200],
                                                        rng.integers(3, cfg.lm.vocab_size, 60)]))
             for _ in range(2)]
    small = Image.fromarray(rng.integers(0, 256, (336, 336, 3), dtype=np.uint8))
    reqs.append(hd_request(cfg, small, rng.integers(3, cfg.lm.vocab_size, 60)))
    reqs.append(hd_request(cfg, images[3], rng.integers(3, cfg.lm.vocab_size, 80)))
    return reqs


CANCEL_AFTER = 4  # phase 10 cancels its last request after this many tokens


def w8a8_route(rows: int, k: int = 4096, n: int = 4096) -> str:
    """Where `ops/layers.linear` sends an int8 product of `rows` rows in the
    w8a8 mode (Vicuna-7B's widths are multiples of 128)."""
    if rows <= 64:
        return "s8_matmul"
    if rows >= 256 and k % 128 == 0 and n % 128 == 0:
        return "s8_gemm"
    return "weight-only"


def phase_paged_serving(device, seed: int, w8a8: bool = False) -> dict:
    """Phase 10 (configuration D): TokenPacker-HD-7b with int8 weights
    serves phase 10's 10 requests through `PagedContinuousBatcher.submit`
    -> `Future.result()` over an int8 paged pool, with the JAX worker's
    paged settings (8 slots, pages of 64, 40 pages a sequence, 2 x 8 x 40
    + 1 pages, chunked admissions of 256, the prefix cache on), 32 greedy
    tokens each, one request cancelled after its 4th token. With `w8a8`,
    phase 14 (configuration F): the same with the tower quantized by
    `quantize_tower_int8` and the batcher in the w8a8 mode (K8 for the
    tower and the admission chunks of 256, K7 for every decode step and
    first-token head)."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import pick_bucket
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8
    from tokenpacker_tpu_torch.models.clip_vit import quantize_tower_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
    from tokenpacker_tpu_torch.ops.q8_matmul import s8_matmul
    from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.serve import scheduler as sched

    phase = "phase 14" if w8a8 else "phase 10"
    cfg = preset_config(HD_PRESET)
    t0 = time.perf_counter()
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    if w8a8:
        params["vision"] = quantize_tower_int8(params["vision"])
    num_pages = 2 * PAGED_SLOTS * PAGES_PER_SEQ + 1
    batcher = sched.PagedContinuousBatcher(
        params, cfg, num_slots=PAGED_SLOTS, num_pages=num_pages, page_size=PAGE_SIZE,
        max_pages_per_seq=PAGES_PER_SEQ, prefill_chunk_size=256, prefix_cache=True,
        kv_cache_dtype=torch.int8, w8a8=w8a8, device=device)
    torch.cuda.synchronize()
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        batcher.paged.k_pages, batcher.paged.v_pages, batcher.paged.k_scales,
        batcher.paged.v_scales))
    reqs = paged_requests(cfg, seed)
    lens = [int(r["lengths"][0]) for r in reqs]
    print(f"{phase}: {HD_PRESET} int8 weights{' (LM and tower), w8a8 mode' if w8a8 else ''} "
          f"from seed {seed} through PagedContinuousBatcher "
          f"({time.perf_counter() - t0:.2f} s to build): {PAGED_SLOTS} slots, {num_pages} pages "
          f"of {PAGE_SIZE}, {PAGES_PER_SEQ} a sequence, int8 pool {pool_bytes / 2**30:.3f} GiB, "
          f"chunks of 256, prefix cache on; {len(reqs)} requests, grids "
          f"{[r['grid'] for r in reqs]}, lengths {lens}, {NEW_TOKENS} greedy tokens each, "
          f"the last cancelled after its {CANCEL_AFTER}th")

    # the first-token logits of each admission and every decode step's
    # logits, recorded by reference (no extra device work) for the checks,
    # and the rows of every admission chunk
    first_logits, step_logits, chunks, tower_rows = {}, [], [], []
    real_step, real_lm_logits = sched.paged_decode_step, sched.lm_logits
    real_chunk, real_encode = sched.prefill_chunk, sched.encode_images

    def recording_chunk(*args):
        chunks.append(args[4].shape[1])  # token_ids [1, chunk_len]
        return real_chunk(*args)

    def recording_encode(*args):
        tower_rows.append(args[2].shape[0] * cfg.vision.seq_len)  # views x positions
        return real_encode(*args)

    def recording_step(*args):
        logits, paged = real_step(*args)
        step_logits.append((logits, {id(r): i for i, r in enumerate(batcher.slots)
                                     if r is not None}))
        return logits, paged

    def recording_lm_logits(*args):
        out = real_lm_logits(*args)
        first_logits[id(batcher._pending["req"])] = out[0]
        return out

    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_decode": fused_decode_hidden,
                "paged_attention": paged_attention, "q4_matmul": q4_matmul,
                "s8_matmul": s8_matmul, "s8_gemm": s8_gemm}
    submitted, first_at, futs = {}, {}, []

    def on_token(i):
        def hook(tok):
            first_at.setdefault(i, time.perf_counter())
            if i == len(reqs) - 1 and len(futs[i]._tp_request.tokens) == CANCEL_AFTER:
                batcher.cancel(futs[i])
        return hook

    sched.paged_decode_step, sched.lm_logits = recording_step, recording_lm_logits
    sched.prefill_chunk, sched.encode_images = recording_chunk, recording_encode
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        batcher.start()
        t0 = time.perf_counter()
        for i, r in enumerate(reqs):
            submitted[i] = time.perf_counter()
            futs.append(batcher.submit(r, max_new_tokens=NEW_TOKENS, on_token=on_token(i)))
        tokens = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        batcher.stop()
        torch.cuda.synchronize()
    finally:
        sched.paged_decode_step, sched.lm_logits = real_step, real_lm_logits
        sched.prefill_chunk, sched.encode_images = real_chunk, real_encode
        batcher.stop()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    st, pc = batcher.stats, batcher.prefix.stats()
    steps = st["decode_steps"]
    decode_tokens = sum(len(t) for t in tokens) - sum(1 for t in tokens if t)
    retained = len(batcher.prefix.blocks)
    leaked = num_pages - 1 - retained - batcher.allocator.available()
    # what Generator's dense cache would hold for the same requests in one
    # batch: every request padded to the longest's bucket plus the new
    # tokens, rounded to the int8 cache's 32 rows
    dense_rows = len(reqs) * (-(-(pick_bucket(max(lens)) + NEW_TOKENS) // 32) * 32)
    latency = [first_at[i] - submitted[i] for i in range(len(reqs))]
    print(f"  served in {wall:.3f} s (host clock): tokens per request "
          f"{[len(t) for t in tokens]}; admission latency (submit -> first token, host clock) "
          f"{[round(x * 1e3, 2) for x in latency]} ms")
    print(f"  decode {steps} steps in {st['decode_s'] * 1e3:.2f} ms = "
          f"{st['decode_s'] / steps * 1e3:.3f} ms/step (admission chunks interleaved), "
          f"{decode_tokens} decode tokens = {decode_tokens / st['decode_s']:.2f} tok/s aggregate; "
          f"the {st['alone_steps']} steps with no admission work "
          f"{st['alone_s'] / max(st['alone_steps'], 1) * 1e3:.3f} ms/step; all "
          f"{sum(map(len, tokens))} tokens over the run {sum(map(len, tokens)) / wall:.2f} tok/s; "
          f"peak memory {peak / 2**30:.3f} GiB")
    print(f"  pages in use at the peak {st['pages_peak']} ({st['pages_peak'] * PAGE_SIZE} rows) "
          f"against {dense_rows} rows of a dense cache for the same requests "
          f"({st['pages_peak'] * PAGE_SIZE / dense_rows:.3f}); prefix cache {pc}; "
          f"{retained} blocks retained, {leaked} pages leaked")
    print(f"  launches {launches} ({launches['paged_attention'] / steps:.2f} K5 per decode step)")

    layers = cfg.lm.num_hidden_layers
    encodes = len(reqs) - pc["prefix_vision_encodes_skipped"]
    routes = [w8a8_route(c) for c in chunks]
    # every admission's first token comes from one LM head over one row
    heads = len(first_logits)
    want = {"vit_attention": tower_blocks(cfg) * encodes,
            "flash_attention": 0, "decode_attention": 0, "fused_decode": 0,
            "paged_attention": layers * steps, "q4_matmul": 0, "s8_matmul": 0, "s8_gemm": 0}
    if w8a8:
        towers = [w8a8_route(r, cfg.vision.hidden_size, cfg.vision.hidden_size)
                  for r in tower_rows]
        tower_products = 6 * tower_blocks(cfg)
        want["s8_gemm"] = (tower_products * towers.count("s8_gemm")
                           + 4 * layers * routes.count("s8_gemm"))
        want["s8_matmul"] = ((4 * layers + 1) * steps + heads
                             + tower_products * towers.count("s8_matmul")
                             + 4 * layers * routes.count("s8_matmul"))
        print(f"  admission chunks (rows) {chunks}: {routes.count('s8_gemm')} of 256+ rows (K8), "
              f"{routes.count('s8_matmul')} of 64 or fewer (K7), {routes.count('weight-only')} "
              f"of 65-255 rows whose {4 * layers * routes.count('weight-only')} products take the "
              f"weight-only route; tower passes of {tower_rows} rows take {towers} "
              f"({tower_blocks(cfg)} blocks x 6 products each); {heads} first-token heads and "
              f"{steps} steps x {4 * layers + 1} products on K7")
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches} != {want}")
    if leaked:
        raise AssertionError(f"{phase}: {leaked} pages leaked")
    if pc["prefix_vision_encodes_skipped"] < 1 or pc["prefix_cache_hits"] < 4:
        raise AssertionError(f"{phase}: the warm requests did not hit the prefix cache: {pc}")
    if not (0 < len(tokens[-1]) < NEW_TOKENS) or any(
            not all(0 <= t < cfg.lm.vocab_size for t in seq) for seq in tokens):
        raise AssertionError(f"{phase}: tokens {[len(t) for t in tokens]}")

    # the warm repeats against the cold request: first-token logits within
    # the band, tokens equal wherever the cold request's top-2 margin is
    # decisive (until the first token that differs)
    def record(i):
        rid = id(futs[i]._tp_request)
        rows = [first_logits[rid]] + [lg[m[rid]] for lg, m in step_logits if rid in m]
        return torch.stack(rows).float().cpu()

    cold = record(0)
    top2 = cold.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    for i in (4, 5):
        warm = record(i)
        diff = (warm[0] - cold[0]).abs().max().item()
        agree = 0
        for j, (a, b) in enumerate(zip(tokens[i], tokens[0])):
            if a != b:
                if margins[j] > LOGIT_BAND:
                    raise AssertionError(f"{phase}: warm request {i} token {j} differs where "
                                         f"the cold margin {margins[j]} is decisive")
                break
            agree += 1
        print(f"  warm repeat {i}: first-token max|dlogit| {diff:.4f} against the cold "
              f"request (band {LOGIT_BAND}); {agree} of {len(tokens[0])} tokens equal")
        if not diff <= LOGIT_BAND:
            raise AssertionError(f"{phase}: warm first-token logits differ by {diff}")
    del params, batcher, step_logits, first_logits
    torch.cuda.empty_cache()
    return launches


def phase_paged_parity(device, seed: int, w8a8: bool = False) -> None:
    """Phase 11: full widths, 2 LM layers, int8 weights and an int8 pool on
    the card (bf16, K5) and on the CPU (fp32, K5's plain version): request
    A admitted cold (prefill, insert_prefill), request B (A's image and
    first 30 text ids, then its own) warm from A's pages (prefix_admit),
    then 8 paged decode steps; both sides fed the CPU's greedy tokens.
    With `w8a8`, phase 15 (F at 2 layers): first A's images through the
    int8 tower in the w8a8 mode (K8), card against CPU features per view
    (W8A8_TOWER_REL_RMS), which the same tower with K8 losing the last 128
    rows of K must fail; then the admissions and steps above with the int8
    tower, in the w8a8 mode (K7 and K8 on the card, their plain versions
    on the CPU), held to W8A8_LOGIT_BAND, which the card's admissions with
    every w8a8 product losing the last 128 rows of K must fail."""
    from PIL import Image

    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import device_batch, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.models.clip_vit import quantize_tower_int8
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.paged_kv import (PagedKV, insert_prefill, map_page,
                                                    paged_decode_step, prefix_admit)
    from tokenpacker_tpu_torch.ops.q8_matmul import s8_matmul
    from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm

    phase = "phase 15" if w8a8 else "phase 11"
    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    if w8a8:
        params["vision"] = quantize_tower_int8(params["vision"])
    band = W8A8_LOGIT_BAND if w8a8 else LOGIT_BAND
    rng = np.random.default_rng(seed + 9)
    image = Image.fromarray(rng.integers(0, 256, (336, 672, 3), dtype=np.uint8))
    text = rng.integers(3, cfg.lm.vocab_size, 40)
    a = hd_request(cfg, image, text)
    b = hd_request(cfg, image, np.concatenate([text[:30], rng.integers(3, cfg.lm.vocab_size, 50)]))
    ps, steps = PAGE_SIZE, 8
    len_a, len_b = int(a["lengths"][0]), int(b["lengths"][0])
    pad_a, pad_b = (-(-n // ps) * ps for n in (len_a, len_b))
    # B's blocks shared with A: the full pages B's prompt agrees on, short
    # of its last token
    same = int(np.argmin(np.append(a["token_ids"][0, :min(len_a, len_b)]
                                   == b["token_ids"][0, :min(len_a, len_b)], False)))
    m = min(same, len_b - 1) // ps
    mp = (max(pad_a, pad_b) + steps) // ps + 1
    pages_a = list(range(1, 1 + pad_a // ps))
    fresh_b = list(range(pages_a[-1] + 1, pages_a[-1] + 1 + pad_b // ps - m))
    spare = iter(range(fresh_b[-1] + 1, fresh_b[-1] + 1 + 2 * mp))

    def padded(r, l_pad, dtype, dev):
        out = {k: np.zeros((1, l_pad), np.asarray(r[k]).dtype)
               for k in ("token_ids", "is_image", "image_slot")}
        for k in out:
            out[k][:, :r["token_ids"].shape[1]] = r[k]
        return device_batch({**out, "lengths": r["lengths"], "images": r["images"]}, dtype, dev)

    def side(p, c, dev):
        """First-token logits of A and B [2, V], then each step's [2, V]."""
        pool = PagedKV.create(c.lm, 1 + pages_a[-1] + len(fresh_b) + 2 * mp, ps, 2, mp,
                              torch.int8, dev)
        la, small = prefill(p, c, padded(a, pad_a, c.dtype, dev), pad_a, torch.int8, w8a8)
        insert_prefill(pool, small, 0, pages_a, len_a)
        db = padded(b, pad_b, c.dtype, dev)
        visual = torch.zeros((1, c.tokens_per_view, c.lm.hidden_size), dtype=c.dtype, device=dev)
        lb, _ = prefix_admit(pool, p, c, pages_a[:m], fresh_b, visual,
                             db["token_ids"][:, m * ps:], db["is_image"][:, m * ps:],
                             db["image_slot"][:, m * ps:], 1, len_b, m, pad_b - m * ps, w8a8)
        return pool, torch.cat([la, lb]).float().cpu()

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    if b["is_image"][0, m * ps:len_b].any():
        raise AssertionError(f"{phase}: B's suffix holds image positions")
    if w8a8:
        w8a8_tower_parity(phase, params["vision"], cfg, a["images"], device)
    t0 = time.perf_counter()
    for fn in (paged_attention, s8_matmul, s8_gemm):
        fn.launches = 0
    sides = {"gpu": (params, cfg, device), "cpu": (cpu_params, cpu_cfg, "cpu")}
    state = {k: side(*v) for k, v in sides.items()}
    cpu_first = state["cpu"][1]
    results = [band_check(f"{phase} admission", state["gpu"][1], cpu_first, band)]
    lens, held = [len_a, len_b], [pad_a // ps, pad_b // ps]
    active = torch.ones(2, dtype=torch.bool)
    for step in range(steps):
        tok = state["cpu"][1].argmax(-1)
        for i in range(2):  # map the block of the next write, as _grow_pages does
            while held[i] <= lens[i] // ps:
                pid = next(spare)
                for k in sides:
                    map_page(state[k][0], i, held[i], pid)
                held[i] += 1
        for k, (p, c, dev) in sides.items():
            logits, _ = paged_decode_step(p, c, state[k][0], tok.to(dev), active.to(dev), w8a8)
            state[k] = (state[k][0], logits.float().cpu())
        lens = [x + 1 for x in lens]
        results.append(band_check(f"{phase} step {step}", state["gpu"][1], state["cpu"][1],
                                  band))
    if paged_attention.launches != 2 * steps:
        raise AssertionError(f"{phase}: {paged_attention.launches} K5 launches on the card, "
                             f"expected {2 * steps}")
    if w8a8:
        # A's prefill (pad_a rows) and B's suffix chunk each run 2 layers x 4
        # products on the route their rows pick; the tower (A only: B's
        # image positions are all cached) 6 products a block on K8; the 2
        # first-token heads and each step's 2 x 4 + 1 products on K7
        routes = [w8a8_route(pad_a), w8a8_route(pad_b - m * ps)]
        rows_a = a["images"].shape[0] * cfg.vision.seq_len
        tower = w8a8_route(rows_a, cfg.vision.hidden_size, cfg.vision.hidden_size)
        want = {"s8_gemm": 6 * tower_blocks(cfg) * (tower == "s8_gemm")
                + 8 * routes.count("s8_gemm"),
                "s8_matmul": 2 + steps * 9 + 6 * tower_blocks(cfg) * (tower == "s8_matmul")
                + 8 * routes.count("s8_matmul")}
        got = {"s8_gemm": s8_gemm.launches, "s8_matmul": s8_matmul.launches}
        print(f"  {phase}: tower of {rows_a} rows takes {tower}, prefill of {pad_a} rows and "
              f"suffix of {pad_b - m * ps} rows take {routes}; launches {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{phase}: launches {got} != {want}")
        with lossy_w8a8_products():
            lost = side(params, cfg, device)[1]
        lost_diff = (lost - cpu_first).abs().max().item()
        print(f"  {phase}: the card's admissions with every w8a8 product losing the last 128 "
              f"rows of K: max|dlogit| {lost_diff:.4f} (band {band})")
        if not lost_diff > band:
            raise AssertionError(f"{phase}: the band does not see w8a8 products losing rows")
    print(f"{phase}: full widths, 2 LM layers, int8 weights{', w8a8' if w8a8 else ''} "
          f"+ int8 pool, request A (grid "
          f"{a['grid']}, {len_a} positions) cold, B ({len_b} positions) warm on {m} of A's pages: "
          f"card bf16 (kernels) vs CPU fp32 (plain versions), admission + {steps} paged decode steps "
          f"({time.perf_counter() - t0:.1f} s) max|dlogit| {[round(r[0], 4) for r in results]} "
          f"band={band}; top-1 margins {[[round(x, 4) for x in r[1]] for r in results]}, "
          f"top-1 agree {[r[2] for r in results]}")
    del params, state, sides
    torch.cuda.empty_cache()


# ---- K9, K4's verify form and speculative serving (phases 3, 16, 17) --------


def check_int8_rows(device) -> None:
    """Phase 3: the int8 cache rows and the int4 codes are the same bytes
    on the card as on the CPU. `quantize_kv` over 200,000 random bf16 rows
    of 128 (magnitudes 1e-3 to 1e2, one zero row): int8 values and scales
    bit-equal to the CPU's. `dequantize_4bit` of an int4 leaf: bit-equal
    to the CPU's, and K6 fed one-hot rows reads the same weights (its code
    table times the block's absmax, rounded to bf16)."""
    from tokenpacker_tpu_torch.ops.kv_quant import quantize_kv
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
    from tokenpacker_tpu_torch.ops.quantize import dequantize_4bit, quantize_4bit

    g = torch.Generator().manual_seed(SEED + 30)
    x = torch.randn((200_000, 128), generator=g) * torch.logspace(-3, 2, 200_000)[:, None]
    x[0] = 0
    x = x.bfloat16()
    (qc, sc), (qg, sg) = quantize_kv(x), quantize_kv(x.to(device))
    rows_eq = torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    leaf = quantize_4bit(torch.randn((256, 256), generator=g), 64, "int4")
    gleaf = {key: v.to(device) for key, v in leaf.items()}
    want = dequantize_4bit(leaf, torch.float32)
    deq_eq = torch.equal(dequantize_4bit(gleaf, torch.float32).cpu(), want)
    eye = torch.eye(256, dtype=torch.bfloat16, device=device)
    k6 = torch.cat([q4_matmul(eye[i:i + 32], gleaf) for i in range(0, 256, 32)]).cpu()
    k6_eq = torch.equal(k6, want.bfloat16())
    print(f"  int8 rows: quantize_kv of 200000 rows of 128 on the card bit-equal to the CPU's "
          f"{rows_eq}; int4 dequantize_4bit bit-equal {deq_eq}, K6's code table bit-equal {k6_eq}")
    if not (rows_eq and deq_eq and k6_eq):
        raise AssertionError("int8 rows or int4 codes differ between the card and the CPU")


# K9's phase-3 check scales the block's o product by this gain, so that
# attention moves the block's update about as much as the MLP: with
# random weights the attention output averages ~577 values and is ~1/20
# of the MLP's, and no measure of the update could see lost keys
K9_O_GAIN = 20.0
# phase 17: the fused tower's update of the patch rows (its features less
# the embedded input) per view, card bf16 (K9) against CPU fp32 (its plain
# version), relative RMS. The dense tower's bf16 spread in its features is
# 0.014 at full width (the note on W8A8_TOWER_REL_RMS); the band must fail
# K9 with its MLP's last 128 hidden units lost
K9_TOWER_REL_RMS = 0.05
SPEC_K = 4  # draft length of phases 16-17 (and T = 5 in phase 3's K4-verify row)
SPEC_SLOTS, SPEC_SEQ = 4, 2080  # the worker's default slots; phase 6's cache length


def vit_layer(vc, seed: int, device, o_gain: float = 1.0) -> dict:
    """One CLIP layer of random bf16 params: kernels ~N(0, 1/fan_in),
    random biases and LayerNorm scales, the o kernel times `o_gain`."""
    g = torch.Generator(device=device).manual_seed(seed)
    w, f = vc.hidden_size, vc.intermediate_size

    def rnd(*shape, scale=1.0, mean=0.0):
        return (mean + scale * torch.randn(shape, generator=g, device=device)).bfloat16()

    def lin(k, n, gain=1.0):
        return {"kernel": rnd(k, n, scale=gain / k**0.5), "bias": rnd(n, scale=0.1)}

    return {"ln1": {"scale": rnd(w, scale=0.1, mean=1.0), "bias": rnd(w, scale=0.1)},
            "attn": {"q": lin(w, w), "k": lin(w, w), "v": lin(w, w), "o": lin(w, w, o_gain)},
            "ln2": {"scale": rnd(w, scale=0.1, mean=1.0), "bias": rnd(w, scale=0.1)},
            "mlp": {"fc1": lin(w, f), "fc2": lin(f, w)}}


def mlp_lost(p: dict) -> dict:
    """The CLIP layer `p` with its MLP's last 128 hidden units dropped."""
    fc1, fc2 = p["mlp"]["fc1"], p["mlp"]["fc2"]
    return {**p, "mlp": {"fc1": {"kernel": fc1["kernel"][:, :-128].contiguous(),
                                 "bias": fc1["bias"][:-128].contiguous()},
                         "fc2": {"kernel": fc2["kernel"][:-128].contiguous(),
                                 "bias": fc2["bias"]}}}


def per_op_block(x, p, heads: int, eps: float):
    """K9's library yardstick, several calls (timed only, never used): the
    block per op with F.layer_norm, cuBLAS products (addmm) and one
    scaled_dot_product_attention."""
    fn = torch.nn.functional
    n, t, w = x.shape

    def ln(v, lp):
        return fn.layer_norm(v, (w,), lp["scale"], lp["bias"], eps)

    def lin(v, lp):
        return torch.addmm(lp["bias"], v.reshape(n * t, -1), lp["kernel"]).view(n, t, -1)

    h = ln(x, p["ln1"])
    q, k, v = (lin(h, p["attn"][name]).view(n, t, heads, -1).transpose(1, 2) for name in "qkv")
    a = fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, w)
    x1 = x + lin(a, p["attn"]["o"])
    g = lin(ln(x1, p["ln2"]), p["mlp"]["fc1"])
    return x1 + lin(g * torch.sigmoid(1.702 * g), p["mlp"]["fc2"])


def k9_bytes_flops(n: int, t: int, w: int, f: int) -> tuple[float, float]:
    """What one K9 call must move and compute: x in and out (bf16), every
    weight, bias and LayerNorm parameter once; the six products and the
    attention's two."""
    m = n * t
    params = 2 * (4 * w * w + 2 * w * f + 9 * w + f)
    return 2 * 2 * m * w + params, 2 * m * (4 * w * w + 2 * w * f) + 4 * n * t * t * w


def compare_update(name: str, got, want, x, losts: dict) -> float:
    """K9: the block's update out - x held per (image, 64-row tile,
    128-wide slice) block (`tile_rel_rms`), not the output, in which the
    residual would hide a lost term; each of `losts` (the plain block's
    output after losing what its key names) must fail. Returns the largest
    absolute error."""
    def update(out):
        return (out.float() - x.float()).view(*x.shape[:2], -1, 128)

    rel = tile_rel_rms(update(got), update(want))
    worst = rel.max().item()
    reads = {what: tile_rel_rms(update(out), update(want)).max().item()
             for what, out in losts.items()}
    err = (got.float() - want.float()).abs().max().item()
    ok = worst <= TILE_REL_RMS and bool(torch.isfinite(got.float()).all())
    print(f"  {name}: update out - x, worst (image, 64 rows, 128-wide slice) block relative RMS "
          f"{worst:.4e}, median {rel.median().item():.4e}, limit {TILE_REL_RMS}; "
          + ", ".join(f"without {what} {r:.4f}" for what, r in reads.items())
          + f"; max_abs_err {err:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({worst})")
    for what, r in reads.items():
        if not r > TILE_REL_RMS:
            raise AssertionError(f"{name}: the block measure does not see {what} lost")
    return err


def k9_cases(device, case) -> list[dict]:
    """Phase 3, K9 at the tower's shapes: [8, 577, 1024] and [26, 577,
    1024] (B's crops) with CLIP-L's F = 4096 and 16 heads, against its
    plain version by the update measure, failing the plain block whose
    attention lost the last 64 keys (rows [0, 513) of the block run on
    x[:, :513]) and whose MLP lost the last 128 hidden units; then the
    tower's 23 blocks fused (K9) against per op (K1 and cuBLAS products),
    timed."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.models import clip_vit
    from tokenpacker_tpu_torch.ops import vit_block as k9

    cfg = preset_config(HD_PRESET)
    vc = cfg.vision
    t, w, f, heads, eps = (vc.seq_len, vc.hidden_size, vc.intermediate_size,
                           vc.num_attention_heads, vc.layer_norm_eps)
    p = vit_layer(vc, SEED + 20, device, K9_O_GAIN)

    def losts(x, want):
        keys = want.clone()
        keys[:, :t - 64] = k9.vit_block_plain(x[:, :t - 64].contiguous(), p, heads, eps)
        return {"the last 64 keys": keys,
                "the last 128 MLP units": k9.vit_block_plain(x, mlp_lost(p), heads, eps)}

    cases = []
    for n in (8, 26):
        x = bf16((n, t, w), SEED + 21, device)
        cases.append(case(
            f"K9 vit_block [{n},{t},{w}] F {f}, {heads} heads", k9.vit_block, k9.vit_block_plain,
            (x, p, heads, eps), library=lambda x=x: per_op_block(x, p, heads, eps),
            work=k9_bytes_flops(n, t, w, f), achieved="ops",
            check=lambda name, out, want, x=x: compare_update(name, out, want, x,
                                                              losts(x, want))))
        print(f"  (K9's library column is the per-op block: 3 LayerNorm/activation passes, 6 "
              f"cuBLAS products, 1 scaled_dot_product_attention, 2 adds: several calls)")
    layer = vit_layer(vc, SEED + 22, device)
    blocks = tower_blocks(cfg)
    for n in (8, 26):
        x = bf16((n, t, w), SEED + 23, device)

        def tower(fused, x=x):
            h = x
            for _ in range(blocks):
                h = clip_vit._block(layer, h, vc, vit_block=fused)
            return h

        fused_ms = time_ms(lambda: tower(True), iters=5, warmup=1)
        per_op_ms = time_ms(lambda: tower(False), iters=5, warmup=1)
        b_ms, b_by = bound(*(blocks * v for v in k9_bytes_flops(n, t, w, f)))
        print(f"  tower of {blocks} blocks on [{n},{t},{w}]: fused (K9) {fused_ms:.3f} ms, per op "
              f"(K1 and cuBLAS products) {per_op_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    del p, layer
    torch.cuda.empty_cache()
    return cases


def random_cache(lc, b: int, s: int, int8: bool, seed: int, device):
    """A [L, b, s] KV cache of random rows (int8 with random scales, or
    bf16), as phase 3's K4 check makes it."""
    from tokenpacker_tpu_torch.models.llama import KVCache

    cache = KVCache.create(lc, b, s, dtype=torch.int8 if int8 else torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    if int8:
        for c in (cache.k, cache.v):
            c.copy_(torch.randint(-127, 128, c.shape, generator=g, device=device,
                                  dtype=torch.int8))
        for c in (cache.k_scale, cache.v_scale):
            c.copy_(torch.rand(c.shape, generator=g, device=device) * 0.02 + 0.001)
    else:
        for c in (cache.k, cache.v):
            c.copy_(torch.randn(c.shape, generator=g, device=device))
    return cache


def written_rows_equal(cache, k_new, v_new, write_pos0) -> bool:
    """The int8 rows and scales that K4 wrote for fed tokens [L, B, T, H,
    d] from write_pos0 equal `quantize_kv` of the rows it returned."""
    from tokenpacker_tpu_torch.ops.kv_quant import quantize_kv

    b, t = k_new.shape[1:3]
    rows = torch.arange(b, device=k_new.device)[:, None].expand(b, t)
    cols = write_pos0.long()[:, None] + torch.arange(t, device=k_new.device)
    ok = True
    for c, sc, new in ((cache.k, cache.k_scale, k_new), (cache.v, cache.v_scale, v_new)):
        q, scale = quantize_kv(new)
        ok &= torch.equal(c[:, rows, cols], q) and torch.equal(sc[:, rows, cols], scale)
    return ok


def verify_kernel_cases(device, lc, layers, hd_lengths: np.ndarray, s_hd: int,
                        span: tuple[int, int]) -> dict:
    """Phase 3, K4's verify form at B = 4, T = SPEC_K + 1, phase 6's ranges
    and cache length (the decoded span k rows shorter, so that the round's
    rows end where phase 6's last step writes), int8 and bf16 caches. At 2 full-width layers (V
    scaled by K4_V_GAIN) the hidden state per (sample, token, 128-wide
    slice) and the new rows per (k|v, layer, sample, token, head) against
    the plain version, failing it without the decoded span; at prompts of
    1-4 rows (where the fed tokens hold a large share of the attention)
    the hidden state failing the plain version with each fed token alone;
    with an int8 cache the written rows and scales bit-equal to
    `quantize_kv` of the returned rows, at T = 5 and at T = 1 (K4). At 32
    layers: deterministic, within K4_DEEP_REL_RMS, and timed with K4's
    T = 1 step on the same cache in the same call. Returns the int8
    cache's row (the path's)."""
    from tokenpacker_tpu_torch.models.llama import KVCache
    from tokenpacker_tpu_torch.ops import fused_decode as k4

    b, t = len(hd_lengths), SPEC_K + 1
    gap = span[1] - span[0] - (t - 1)  # the round's t rows end where phase 6's last step writes
    len0 = torch.as_tensor(hd_lengths, dtype=torch.int32, device=device)
    start2 = torch.full_like(len0, span[0])
    end2 = start2 + gap
    short = torch.tensor([1, 2, 3, 4][:b], dtype=torch.int32, device=device)
    offs = torch.arange(t, device=device, dtype=torch.int32)
    h0 = (0.02 * torch.randn((b, t, lc.hidden_size), device=device,
                             generator=torch.Generator(device=device).manual_seed(SEED + 31))
          ).bfloat16()
    keys = int(np.minimum(hd_lengths, s_hd).sum()) + b * gap
    lc2 = dataclasses.replace(lc, num_hidden_layers=2)
    out = {}
    for int8 in (True, False):
        cache = random_cache(lc, b, s_hd, int8, SEED + 7, device)
        tag = f"K4-verify B={b} T={t} S={s_hd} {'int8' if int8 else 'bf16'} cache"

        def copy(c, n_layers=None):
            sl = slice(None, n_layers)
            return KVCache(c.k[sl].clone(), c.v[sl].clone(), 0,
                           *((c.k_scale[sl].clone(), c.v_scale[sl].clone()) if int8
                             else (None, None)))

        c2 = copy(cache, 2)
        (c2.v_scale if int8 else c2.v).mul_(K4_V_GAIN)

        def run(lens, end, fn="kernel"):
            """2 layers on a copy of c2: the kernel, its plain version, or
            each fed token alone through the plain version."""
            c = copy(c2)
            pos = (lens + gap)[:, None] + offs
            if fn == "kernel":
                return k4.fused_verify_hidden({"layers": layers[:2]}, lc2, h0, c.k, c.v, lens,
                                              start2, end, end2, pos, k_scale=c.k_scale,
                                              v_scale=c.v_scale), c
            if fn == "plain":
                return k4.fused_verify_hidden_plain(layers[:2], lc2, h0, c.k, c.v, lens, start2,
                                                    end, pos, c.k_scale, c.v_scale), c
            alone = [k4.fused_decode_hidden_plain(layers[:2], lc2, h0[:, j], c.k, c.v, lens,
                                                  start2, end, pos[:, j], c.k_scale, c.v_scale)
                     for j in range(t)]
            return (torch.stack([a[0] for a in alone], 1), None, None), c

        def slices(hidden):  # [B, T, D] -> (sample, token, 128-wide slice)
            return hidden.view(b, t, -1, 128)

        (hidden, k_new, v_new), ck = run(len0, end2)
        (p_hidden, p_k, p_v), _ = run(len0, end2, "plain")
        (l_hidden, l_k, l_v), _ = run(len0, start2, "plain")
        err = compare_rows(tag + " 2 layers hidden per (sample, token, 128-wide slice)",
                           slices(hidden), slices(p_hidden), slices(l_hidden))
        compare_rows(tag + " 2 layers new k, v rows per (k|v, layer, sample, token, head)",
                     torch.stack((k_new, v_new)), torch.stack((p_k, p_v)),
                     torch.stack((l_k, l_v)))
        (s_hidden, _, _), _ = run(short, end2)
        (sp_hidden, _, _), _ = run(short, end2, "plain")
        (sa_hidden, _, _), _ = run(short, end2, "alone")
        compare_rows(tag + " 2 layers, prompts of 1-4 rows, hidden", slices(s_hidden),
                     slices(sp_hidden), slices(sa_hidden), "the fed tokens before each token")
        if int8:
            c1 = copy(c2)
            pos1 = len0 + gap
            _, k1_new, v1_new = k4.fused_decode_hidden(
                {"layers": layers[:2]}, lc2, h0[:, 0].contiguous(), c1.k, c1.v, len0, start2, end2,
                end2, pos1,
                k_scale=c1.k_scale, v_scale=c1.v_scale)
            eq5 = written_rows_equal(ck, k_new, v_new, end2)
            eq1 = written_rows_equal(c1, k1_new[:, :, None], v1_new[:, :, None], end2)
            print(f"  {tag}: int8 rows and scales written bit-equal to quantize_kv of the "
                  f"returned rows at T = {t} {eq5}, at T = 1 (K4) {eq1}")
            if not (eq5 and eq1):
                raise AssertionError(f"{tag}: written int8 rows differ from quantize_kv's")
        del c2, ck

        lm = {"layers": layers}
        weights = k4.FusedWeights(lm, lc)
        kc, vc_ = cache.k.clone(), cache.v.clone()
        pos = (len0 + gap)[:, None] + offs
        h1, pos1 = h0[:, 0].contiguous(), pos[:, 0].contiguous()

        def kernel():
            return k4.fused_verify_hidden(lm, lc, h0, cache.k, cache.v, len0, start2, end2, end2,
                                          pos, k_scale=cache.k_scale, v_scale=cache.v_scale,
                                          weights=weights)[0]

        def step():
            return k4.fused_decode_hidden(lm, lc, h1, cache.k, cache.v, len0, start2, end2,
                                          end2, pos1, k_scale=cache.k_scale,
                                          v_scale=cache.v_scale, weights=weights)[0]

        def plain():
            return k4.fused_verify_hidden_plain(layers, lc, h0, kc, vc_, len0, start2, end2, pos,
                                                cache.k_scale, cache.v_scale)[0]

        hidden, again, p_hidden = kernel(), kernel(), plain()
        if not torch.equal(again, hidden):
            raise AssertionError(f"{tag}: two identical calls differ")
        rel = ((hidden.float() - p_hidden.float()).pow(2).mean().sqrt()
               / p_hidden.float().pow(2).mean().sqrt()).item()
        print(f"  {tag} {lc.num_hidden_layers} layers hidden: relative RMS difference {rel:.4f} "
              f"(bound {K4_DEEP_REL_RMS}), two calls identical")
        if not rel <= K4_DEEP_REL_RMS:
            raise AssertionError(f"{tag}: 32-layer hidden differs from the plain version ({rel})")
        ms, step_ms = time_ms(kernel), time_ms(step)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        b_ms, b_by = bound(*k4_bytes_flops(lc, b, keys, int8, t))
        print(f"  {tag} {lc.num_hidden_layers} layers: kernel {ms:.4f} ms (K4 at T = 1 on the same "
              f"cache in this call {step_ms:.4f} ms, ratio {ms / step_ms:.3f}), plain "
              f"{plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of "
              f"the kernel's time; {keys} valid cache rows)")
        out[int8] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "t1_ms": step_ms}
        del cache, kc, vc_, weights, lm
    torch.cuda.empty_cache()
    return out[True]


def plain_reference(params, cfg, batch, device, kv_cache_dtype=torch.int8,
                    vit_block: bool = False, repetition_penalty: float = 1.0,
                    new_tokens: int = NEW_TOKENS) -> tuple[list, list]:
    """Phase 6's plain run of the HD requests, recorded: a batched prefill
    (the per-op tower, or the fused one with `vit_block`) and decode steps
    (K4 on an int8 tree, else per layer), `new_tokens` greedy tokens (of the
    logits penalized by `repetition_penalty`, `generate.apply_penalties`).
    Per request its tokens and the top-2 margin of the logits behind
    each."""
    from tokenpacker_tpu_torch.generate import (
        apply_penalties,
        decode_step,
        device_batch,
        fused_weights,
        prefill,
        prompt_presence_mask,
    )

    n, l = batch["token_ids"].shape
    dev = device_batch(batch, torch.bfloat16, device)
    logits, cache = prefill(params, cfg, dev, l + new_tokens, kv_cache_dtype,
                            vit_block=vit_block)
    fused = fused_weights(params, cfg)
    presence = torch.as_tensor(prompt_presence_mask(batch, cfg.lm.vocab_size), device=device)
    counts = torch.zeros((n, cfg.lm.vocab_size), dtype=torch.int32, device=device)
    toks, margins = [], []
    for step in range(new_tokens):
        if repetition_penalty != 1.0:
            logits = apply_penalties(logits, counts, presence, repetition_penalty)
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(logits.argmax(dim=-1))
        counts[torch.arange(n, device=device), toks[-1]] += 1
        if step < new_tokens - 1:
            logits, cache = decode_step(params, cfg, cache, toks[-1], dev["lengths"], step, l,
                                        fused)
    del cache
    return torch.stack(toks, 1).tolist(), torch.stack(margins, 1).tolist()


def decisive_agree(name: str, got: list, want: list, margins: list) -> int:
    """`got` equals `want` token by token up to the first difference, which
    must come where the reference's top-2 margin is within LOGIT_BAND (bf16
    roundings that differ, here the fused tower's and the verify form's,
    may flip such a token, and the sequences part there). Returns how many
    leading tokens are equal."""
    agree = 0
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if margins[j] > LOGIT_BAND:
                raise AssertionError(f"{name}: token {j} differs where the reference margin "
                                     f"{margins[j]:.4f} is decisive")
            break
        agree += 1
    return agree


def phase_spec_serving(device, seed: int) -> dict:
    """Phase 16: TokenPacker-HD-7b with the LM from `quantize_lm_int8`, an
    int8 cache and the fused tower (`vit_block=True`) through
    `ContinuousBatcher(num_slots=4, max_seq_len=2080, prefill_chunk_size=
    256, speculative_k=4)`: phase 6's 4 HD requests, a repeat of the 3x3
    one and one cancelled after its 4th token, 32 greedy tokens each. K9
    runs tower_blocks times per admission, K4 once per plain step, K4's
    verify form once per verify round, K1 and K3 never; the tokens equal
    phase 6's plain run (recorded here on the same weights, through the
    same fused tower) wherever its margin is decisive, the repeat's as
    well; nothing is left in a slot.
    Then three short runs: the rigged repeater (o and down zeroed, the head
    tied to the embedding) with one request of 64 tokens, whose drafts
    must land (produced / rounds >= 3) with tokens equal to its plain
    decode; `Generator.generate(speculative=4)` on the 3x3 request; phase
    10's paged batcher with `speculative_k=4` on the 3x3 request and its
    repeat."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden, fused_verify_hidden
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.ops.vit_block import vit_block
    from tokenpacker_tpu_torch.serve import scheduler as sched

    cfg = preset_config(HD_PRESET)
    t0 = time.perf_counter()
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    batch, blocks = make_hd_requests(cfg, seed)
    # the reference runs G's own tower, K9, so that phase 16 holds what it
    # is for (chunked admission, K4's verify form, speculation); the fused
    # tower against the per-op one is phase 17's and K9's phase-3 check
    ref_tokens, ref_margins = plain_reference(params, cfg, batch, device, vit_block=True)
    torch.cuda.synchronize()
    reqs = paged_requests(cfg, seed)
    reqs = reqs[:4] + [reqs[0], reqs[-1]]
    print(f"phase 16: {HD_PRESET} int8 LM, int8 cache, fused tower (K9) from seed {seed} through "
          f"ContinuousBatcher: {SPEC_SLOTS} slots, max_seq_len {SPEC_SEQ}, chunks of 256, "
          f"speculative_k {SPEC_K}; {len(reqs)} requests, grids {[r['grid'] for r in reqs]}, "
          f"lengths {[int(r['lengths'][0]) for r in reqs]}, {NEW_TOKENS} greedy tokens each, the "
          f"last cancelled after its {CANCEL_AFTER}th ({time.perf_counter() - t0:.2f} s to build "
          f"and record phase 6's plain run with the fused tower)")
    batcher = sched.ContinuousBatcher(
        params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ, prefill_chunk_size=256,
        speculative_k=SPEC_K, kv_cache_dtype=torch.int8, vit_block=True, device=device)
    views, real_encode = [], sched.encode_images

    def recording_encode(*args):
        views.append(args[2].shape[0])
        return real_encode(*args)

    counters = {"vit_block": vit_block, "vit_attention": vit_attention,
                "flash_attention": flash_attention, "decode_attention": decode_attention,
                "fused_decode": fused_decode_hidden, "fused_verify": fused_verify_hidden}
    submitted, first_at, futs = {}, {}, []

    def on_token(i):
        def hook(tok):
            first_at.setdefault(i, time.perf_counter())
            if i == len(reqs) - 1 and len(futs[i]._tp_request.tokens) == CANCEL_AFTER:
                batcher.cancel(futs[i])
        return hook

    sched.encode_images = recording_encode
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        batcher.start()
        t0 = time.perf_counter()
        for i, r in enumerate(reqs):
            submitted[i] = time.perf_counter()
            futs.append(batcher.submit(r, max_new_tokens=NEW_TOKENS, on_token=on_token(i)))
        tokens = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        batcher.stop()
        torch.cuda.synchronize()
    finally:
        sched.encode_images = real_encode
        batcher.stop()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    st = batcher.stats
    steps, rounds = st["decode_steps"], st["verify_rounds"]
    latency = [first_at[i] - submitted[i] for i in range(len(reqs))]
    n_tok = sum(map(len, tokens))
    print(f"  served in {wall:.3f} s (host clock): tokens per request {[len(t) for t in tokens]}, "
          f"{n_tok / wall:.2f} tok/s over the run; admission latency (submit -> first token, "
          f"host clock) {[round(x * 1e3, 2) for x in latency]} ms; peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"  {rounds} verify rounds emitted {st['verify_tokens']} tokens "
          f"({st['verify_tokens'] / max(rounds, 1):.3f} a round), "
          f"{st['verify_s'] / max(rounds, 1) * 1e3:.3f} ms a round; {steps} plain steps after the "
          f"backoff, {st['decode_s'] / max(steps, 1) * 1e3:.3f} ms a step (host clock, to the "
          f"argmax on the host)")
    print(f"  launches {launches}; tower passes of {views} views")
    want = {"vit_block": tower_blocks(cfg) * len(views), "vit_attention": 0,
            "flash_attention": 0, "decode_attention": 0, "fused_decode": steps,
            "fused_verify": rounds}
    if launches != want:
        raise AssertionError(f"phase 16: launch counts {launches} != {want}")
    if rounds == 0:
        raise AssertionError("phase 16: no verify round ran")
    leftover = ([s for s in batcher.slots if s is not None], batcher.lengths.any(),
                batcher._pending, batcher.queue.qsize())
    if leftover != ([], False, None, 0):
        raise AssertionError(f"phase 16: the batcher holds state after the run: {leftover}")
    if not 0 < len(tokens[-1]) < NEW_TOKENS:
        raise AssertionError(f"phase 16: the cancelled request got {len(tokens[-1])} tokens")
    agree = [decisive_agree(f"phase 16 request {i}", tokens[i], ref_tokens[j], ref_margins[j])
             for i, j in ((0, 0), (1, 1), (2, 2), (3, 3), (4, 0))]
    agree.append(decisive_agree("phase 16 repeat against the original", tokens[4], tokens[0],
                                ref_margins[0]))
    print(f"  tokens equal to phase 6's plain run (per request, then the repeat against the "
          f"original) for the first {agree} of {NEW_TOKENS}; reference margins at the first "
          f"difference within the band {LOGIT_BAND}")

    # the same batcher without speculation on phase 6's 4 requests: its
    # plain steps against the verify rounds above, in this call
    plain = sched.ContinuousBatcher(
        params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ, prefill_chunk_size=256,
        kv_cache_dtype=torch.int8, vit_block=True, device=device)
    plain.start()
    try:
        t0 = time.perf_counter()
        p_toks = [f.result(timeout=600) for f in
                  [plain.submit(r, max_new_tokens=NEW_TOKENS) for r in reqs[:4]]]
        p_wall = time.perf_counter() - t0
    finally:
        plain.stop()
    pst = plain.stats
    print(f"  without speculation (speculative_k 0), phase 6's 4 requests: {pst['decode_steps']} "
          f"plain steps, {pst['decode_s'] / max(pst['decode_steps'], 1) * 1e3:.3f} ms a step "
          f"({pst['alone_s'] / max(pst['alone_steps'], 1) * 1e3:.3f} with no admission work); "
          f"{sum(map(len, p_toks)) / p_wall:.2f} tok/s over the run (the speculative run "
          f"above: {n_tok / wall:.2f} over its 6 requests)")
    del plain

    # Generator with speculation, and the paged batcher with speculation
    gen = Generator(params, cfg, kv_cache_dtype=torch.int8, vit_block=True)
    fused_verify_hidden.launches = 0
    res = gen.generate(reqs[0], max_new_tokens=NEW_TOKENS, speculative=SPEC_K)
    g_agree = decisive_agree("phase 16 Generator(speculative=4)", res.sequences[0],
                             ref_tokens[0], ref_margins[0])
    print(f"  Generator.generate(speculative={SPEC_K}) on the 3x3 request: "
          f"{res.stats['verify_rounds']} rounds ({fused_verify_hidden.launches} K4-verify "
          f"launches) for {len(res.sequences[0])} tokens, {g_agree} equal to phase 6's")
    paged = sched.PagedContinuousBatcher(
        params, cfg, num_slots=PAGED_SLOTS, num_pages=2 * PAGED_SLOTS * PAGES_PER_SEQ + 1,
        page_size=PAGE_SIZE, max_pages_per_seq=PAGES_PER_SEQ, prefill_chunk_size=256,
        speculative_k=SPEC_K, kv_cache_dtype=torch.int8, vit_block=True, device=device)
    paged.start()
    try:
        p_tokens = [paged.submit(r, max_new_tokens=NEW_TOKENS).result(timeout=600)
                    for r in (reqs[0], reqs[0])]
    finally:
        paged.stop()
    p_agree = [decisive_agree("phase 16 paged speculation", t, ref_tokens[0], ref_margins[0])
               for t in p_tokens]
    print(f"  PagedContinuousBatcher(speculative_k={SPEC_K}) on the 3x3 request and its warm "
          f"repeat: {paged.stats['verify_rounds']} rounds, {paged.stats['verify_tokens']} tokens "
          f"from rounds, {p_agree} equal to phase 6's; prefix cache {paged.prefix.stats()}")
    if paged.prefix.stats()["prefix_cache_hits"] < 1:
        raise AssertionError("phase 16: the paged repeat did not hit the prefix cache")
    del gen, paged

    # the repeater: attention and MLP outputs zeroed, the head tied to the
    # embedding, so that it predicts its input token and every draft lands
    for layer in params["lm"]["layers"]:
        layer["attn"]["o"]["kernel"]["q"].zero_()
        layer["mlp"]["down"]["kernel"]["q"].zero_()
    params["lm"]["lm_head"] = {"kernel": params["lm"]["embed"].T.contiguous()}
    want = Generator(params, cfg, kv_cache_dtype=torch.int8, vit_block=True).generate(
        reqs[1], max_new_tokens=64).sequences[0]
    rep = sched.ContinuousBatcher(
        params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ, prefill_chunk_size=256,
        speculative_k=SPEC_K, kv_cache_dtype=torch.int8, vit_block=True, device=device)
    rep.start()
    try:
        got = rep.submit(reqs[1], max_new_tokens=64).result(timeout=600)
    finally:
        rep.stop()
    ratio = (rep.stats["verify_tokens"] + rep.stats["decode_steps"]) / max(
        rep.stats["verify_rounds"] + rep.stats["decode_steps"], 1)
    print(f"  repeater: 64 tokens in {rep.stats['verify_rounds']} verify rounds and "
          f"{rep.stats['decode_steps']} plain steps, {ratio:.3f} tokens a forward, "
          f"{rep.stats['verify_s'] / max(rep.stats['verify_rounds'], 1) * 1e3:.3f} ms a round; "
          f"tokens equal to its plain decode {got == want}")
    if got != want or ratio < 3:
        raise AssertionError(f"phase 16: repeater tokens equal {got == want}, {ratio} tokens a "
                             "forward (at least 3 expected)")
    del params, batcher, rep
    torch.cuda.empty_cache()
    return launches


def phase_spec_parity(device, seed: int) -> None:
    """Phase 17: full widths, 2 LM layers, int8 weights and cache, card bf16
    (kernels) against CPU fp32 (plain versions). The fused tower's update of
    the patch rows per view within K9_TOWER_REL_RMS, which K9 with its
    MLP's last 128 hidden units lost must fail; one HD admission then 4 verify rounds at
    k = 4 (fed: the CPU's greedy token and 4 prompt tokens), every
    position's logits within LOGIT_BAND, which the verify without its fed
    keys (each fed token through K4 alone) must fail."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import device_batch, fused_weights, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.models.clip_vit import _embed, clip_tower_features
    from tokenpacker_tpu_torch.models.lm_api import lm_embed, lm_logits
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden, fused_verify_hidden_plain
    from tokenpacker_tpu_torch.ops.layers import rms_norm
    from tokenpacker_tpu_torch.speculative import verify_step

    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    batch, blocks = make_hd_requests(cfg, seed + 1, sizes=((672, 336),), text_lens=(40,))
    vc = cfg.vision
    t0 = time.perf_counter()
    imgs = torch.as_tensor(batch["images"])

    def update(vision, images):
        """The tower's update of the patch rows: the selected features less
        the embedded input (the residual stream would hide a lost term)."""
        x0 = _embed(vision, vc, images)[:, 1:]
        return (clip_tower_features(vision, vc, images, vit_block=True)[0] - x0).float().cpu()

    gpu_imgs = imgs.to(device, torch.bfloat16)
    got = update(params["vision"], gpu_imgs)
    want = update(cpu_params["vision"], imgs.float())
    lost = update({**params["vision"],
                   "layers": [mlp_lost(p) for p in params["vision"]["layers"]]}, gpu_imgs)

    def per_view(x):
        return ((x - want).square().sum((1, 2)) / want.square().sum((1, 2))).sqrt()

    rel, lost_rel = per_view(got), per_view(lost)
    print(f"phase 17: full widths, 2 LM layers, int8 weights + int8 cache, 1 HD request (grid "
          f"{blocks}): the fused tower's update of the patch rows (features less the embedded "
          f"input), card bf16 (K9) vs CPU fp32 (plain), relative RMS per view {[round(x, 4) for x in rel.tolist()]} (band {K9_TOWER_REL_RMS}); with "
          f"K9's MLP losing its last 128 units {[round(x, 4) for x in lost_rel.tolist()]}")
    if not rel.max().item() <= K9_TOWER_REL_RMS:
        raise AssertionError(f"phase 17: fused tower features differ by {rel.max().item()}")
    if not lost_rel.min().item() > K9_TOWER_REL_RMS:
        raise AssertionError("phase 17: the tower band does not see K9 losing MLP units")

    def sides_for(b):
        return {"gpu": (params, cfg, device_batch(b, torch.bfloat16, device),
                        fused_weights(params, cfg)),
                "cpu": (cpu_params, cpu_cfg, device_batch(b, torch.float32, "cpu"), True)}

    def fed_alone(cache, fed, lengths, step, l):
        """The card's verify logits with each fed token attending the cache
        and itself only (K4, T = 1, per token, on a copy of the cache)."""
        lm = params["lm"]
        c = [x.clone() for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
        emb = lm_embed(lm, cfg.lm, fed.to(device))
        start2 = torch.full_like(lengths, l)
        out = []
        for j in range(fed.shape[1]):
            hidden, _, _ = fused_decode_hidden(
                lm, cfg.lm, emb[:, j], c[0], c[1], lengths, start2, start2 + step,
                start2 + step + j, lengths + step + j, k_scale=c[2], v_scale=c[3])
            out.append(lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps)))
        return torch.stack(out, 1).float().cpu()

    def plain_on_card(cache, fed, lengths, step, l):
        """The same round through K4-verify's plain version on the card."""
        lm = params["lm"]
        start2 = torch.full_like(lengths, l)
        pos = (lengths + step)[:, None] + torch.arange(fed.shape[1], device=device)
        hidden = fused_verify_hidden_plain(
            lm["layers"], cfg.lm, lm_embed(lm, cfg.lm, fed.to(device)), cache.k, cache.v,
            lengths, start2, start2 + step, pos.int(), cache.k_scale, cache.v_scale)[0]
        return lm_logits(lm, cfg.lm, rms_norm(lm["norm"], hidden, cfg.lm.rms_norm_eps))[0]

    def rounds(b, n_rounds, tag):
        """Admission, then n_rounds verify rounds on both sides, held to
        LOGIT_BAND; returns the readings, the fed-alone reading and the
        kernel against its plain version on the card, each round."""
        sides = sides_for(b)
        l = b["token_ids"].shape[1]
        lengths = {k: v[2]["lengths"] for k, v in sides.items()}
        state = {k: prefill(p, c, d, l + 5 * n_rounds + 8, torch.int8, vit_block=True)
                 for k, (p, c, d, _) in sides.items()}
        res = [band_check(f"phase 17 {tag} admission", state["gpu"][0].float().cpu(),
                          state["cpu"][0].float())]
        drafts = torch.as_tensor(np.asarray(b["token_ids"])[0, 1:1 + SPEC_K])
        tok, step, alone, vs_plain = state["cpu"][0].argmax(-1), 0, [], []
        for r in range(n_rounds):
            fed = torch.cat([tok, drafts])[None]
            alone.append(fed_alone(state["gpu"][1], fed, lengths["gpu"], step, l))
            vs_plain.append(plain_on_card(state["gpu"][1], fed, lengths["gpu"], step, l))
            out = {k: verify_step(p, c, state[k][1], fed.to(lengths[k].device), lengths[k], step,
                                  l, fw)[0][0].float().cpu()
                   for k, (p, c, _, fw) in sides.items()}
            res.append(band_check(f"phase 17 {tag} round {r}", out["gpu"], out["cpu"]))
            alone[-1] = (alone[-1][0] - out["cpu"]).abs().max().item()
            vs_plain[-1] = (vs_plain[-1].float().cpu() - out["gpu"]).abs().max().item()
            step += fed.shape[1]
            tok = out["cpu"][-1:].argmax(-1)
        return res, alone, vs_plain

    res, alone, vs_plain = rounds(batch, 4, "HD")
    print(f"  1 HD admission + 4 verify rounds at k = {SPEC_K}, card bf16 (K4-verify) vs CPU fp32 "
          f"(plain) ({time.perf_counter() - t0:.1f} s): max|dlogit| "
          f"{[round(r[0], 4) for r in res]} band={LOGIT_BAND}; the fed tokens each alone (must "
          f"fail the band) {[round(x, 4) for x in alone]}; top-1 agree {[r[2] for r in res]}; K4-verify vs "
          f"its plain version on the card (bf16 both) {[round(x, 4) for x in vs_plain]}")
    if not min(alone) > LOGIT_BAND:
        raise AssertionError("phase 17: the band does not see a verify without its fed keys")
    del params, cpu_params
    torch.cuda.empty_cache()


# ---- K4-LoRA and multi-LoRA serving (phases 3, 18, 19) ------------------------

# the adapters of phases 3, 18 and 19: two of rank 16 over all seven targets,
# alpha 32 (alpha / r = 2, folded into B exactly). Phase 3's hold their
# entries at LORA_SCALE; at that size the adapters move each layer's
# products by ~1/3 of the base's (u ~ 64 x 0.03 per column at d = 4096, the
# term ~ 2 x sqrt(16) x 0.03 x u), so that the update that phase 3 holds
# stands well above the bf16 roundings that the kernel and its plain
# version take in different places.
LORA_RANK, LORA_ALPHA, LORA_SCALE = 16, 32, 0.03
# phase 18 serves adapters of the same rank at LORA_SERVE_SCALE, a term of
# ~1/10 of the base products: the streams leave the base model's without
# turning the random model's logits flat
LORA_SERVE_SCALE = 0.015
LORA_SLOTS = ("ad0", "ad1", None, "ad0")  # phase 3's and phase 18's 4 slots
# phase 3 holds K4-LoRA by the adapters' update (hidden with them less
# without), per (sample, token, 128-wide slice): a difference of two bf16
# runs, each carrying the roundings that K4 and its plain version take in
# different places along the base path, which do not cancel in it. On an
# H100 80GB HBM3 (700 W) the update reads 0.0148-0.0176 at 2 layers
# (against TILE_REL_RMS's 0.02, too close a margin to hold) and the three
# lossy plain versions 0.40-1.82
LORA_UPDATE_REL_RMS = 5e-2


def random_adapters(lc, seed: int, scale: float, names=("ad0", "ad1")) -> dict:
    """{name: serve.multi_lora.Adapter} of rank LORA_RANK over all seven
    targets of every layer of `lc`, normal entries of size `scale` (B's
    already times alpha / r), float32 numpy from the seed."""
    from tokenpacker_tpu_torch.serve.multi_lora import TARGETS, Adapter, target_dims

    rng = np.random.default_rng(seed)
    dims = target_dims(lc)
    out = {}
    for name in names:
        lora = {}
        for t in TARGETS:
            din, dout = dims[t]
            a = rng.standard_normal((lc.num_hidden_layers, din, LORA_RANK), np.float32) * scale
            b = rng.standard_normal((lc.num_hidden_layers, LORA_RANK, dout), np.float32) * scale
            lora[t] = (a, b * (LORA_ALPHA / LORA_RANK))
        out[name] = Adapter(lora, LORA_RANK)
    return out


def write_peft(path: Path, adapter, projector=None) -> None:
    """An adapter as the PEFT directory that `load_adapter` reads (the
    reference's names, torch [r, in] lora_A and [out, r] lora_B, alpha /
    r undone on B) and, with `projector`, its non_lora_trainables.bin."""
    from tokenpacker_tpu_torch.io.hf_import import export_tokenpacker
    from tokenpacker_tpu_torch.serve.multi_lora import _TORCH_NAMES

    names = {t: n for n, t in _TORCH_NAMES.items()}
    sd = {}
    for t, (a, b) in adapter.lora.items():
        for i in range(a.shape[0]):
            key = f"base_model.model.model.layers.{i}.{names[t]}"
            sd[f"{key}.lora_A.weight"] = torch.from_numpy(np.ascontiguousarray(a[i].T))
            sd[f"{key}.lora_B.weight"] = torch.from_numpy(
                np.ascontiguousarray(b[i].T / (LORA_ALPHA / LORA_RANK)))
    path.mkdir(parents=True)
    torch.save(sd, path / "adapter_model.bin")
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": LORA_RANK, "lora_alpha": LORA_ALPHA, "peft_type": "LORA"}))
    if projector is not None:
        torch.save({f"base_model.model.model.mm_projector.{k}": torch.from_numpy(v)
                    for k, v in export_tokenpacker(projector).items()},
                   path / "non_lora_trainables.bin")


def fd_lora_bytes_flops(bundle, rows: int) -> tuple[float, float]:
    """What K4-LoRA adds to K4's work: the adapter entries that this run's
    bundle holds read once (bf16), the mask rows once (f32); 2 x rows
    operations per entry. Only the non-zero entries count: the zero blocks
    of the fused targets' block-diagonal B (and the columns that pad a
    lower rank) hold no work, though the kernel reads them."""
    mats = ("a_d", "a_f", "b_qkv", "b_o", "b_gu", "b_down")
    elems = sum(int(torch.count_nonzero(bundle[m])) for m in mats)
    return 2 * elems + 4 * rows * sum(bundle["widths"]), 2 * rows * elems


def compare_lora_update(name: str, got, want, losts: dict) -> float:
    """The adapters' update (hidden with them less without, [B, T, D]) held
    per (sample, token, 128-wide slice) by `row_rel_rms` to
    LORA_UPDATE_REL_RMS;
    each lossy plain version's update in `losts` must fail that. Returns
    the largest absolute error of the update."""
    def slices(x):
        return x.float().reshape(*x.shape[:2], -1, 128)

    rel = row_rel_rms(slices(got), slices(want))
    worst = rel.max().item()
    reads = {k: round(row_rel_rms(slices(v), slices(want)).max().item(), 4)
             for k, v in losts.items()}
    size = (want.float().norm() / want.float().numel() ** 0.5).item()
    err = (got.float() - want.float()).abs().max().item()
    ok = worst <= LORA_UPDATE_REL_RMS and bool(torch.isfinite(got.float()).all())
    print(f"  {name}: the adapters' update (RMS {size:.4f}) per (sample, token, 128-wide slice): "
          f"worst relative RMS {worst:.4e}, median {rel.median().item():.4e}, limit "
          f"{LORA_UPDATE_REL_RMS}; lossy plain versions {reads}; "
          f"max_abs_err {err:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: K4-LoRA's update disagrees with its plain version ({worst})")
    for k, v in reads.items():
        if not v > LORA_UPDATE_REL_RMS:
            raise AssertionError(f"{name}: the update measure does not see {k} ({v})")
    return err


def lora_kernel_cases(device, lc, layers, hd_lengths: np.ndarray, s_hd: int,
                      span: tuple[int, int]) -> dict:
    """Phase 3, K4-LoRA at phase 6's last decode step (B = 4, S = 2080, the
    HD requests' ranges), T = 1 and T = SPEC_K + 1, int8 cache (and a bf16
    one at T = 1): two random adapters of rank 16 over all seven targets
    (`random_adapters`, LORA_SCALE), slots on ad0, ad1, none and ad0.
    At 2 full-width layers (V scaled by K4_V_GAIN) the adapters' update
    (`compare_lora_update`) against the plain version's, which must fail with
    slot 0's selection zeroed, with slot 1 on the other adapter and with
    the down target's term dropped; the int8 rows and scales written
    bit-equal to `quantize_kv` of the returned rows; an all-zero selection
    gives K4's bits. At 32 layers: deterministic, the hidden state within
    K4_DEEP_REL_RMS of the plain version's, and timed beside K4 (or
    K4-verify) without the term on the same cache in the same call; bound:
    K4's bytes and the bundle's non-zero entries. Returns the "fused_decode_lora" (T = 1)
    and "fused_verify_lora" (T = 5) rows, int8 cache."""
    from tokenpacker_tpu_torch.models.llama import KVCache
    from tokenpacker_tpu_torch.ops import fused_decode as k4
    from tokenpacker_tpu_torch.serve.multi_lora import SlotLora

    b = len(hd_lengths)
    adapters = random_adapters(lc, SEED + 40, LORA_SCALE)
    lc2 = dataclasses.replace(lc, num_hidden_layers=2)

    def bundle_of(n_layers, slots=LORA_SLOTS[:b]):
        sl = SlotLora({"lm": {"layers": layers[:n_layers]}}, SimpleNamespace(lm=lc), adapters, b)
        for i, name in enumerate(slots):
            sl.set_slot(i, name)
        return sl._fd | {"sel": sl.sel}

    bundles = {2: bundle_of(2), 32: bundle_of(32)}
    lost = {"slot 0's selection zeroed": {**bundles[2], "sel": bundles[2]["sel"].clone()},
            "slot 1 on the other adapter": {**bundles[2], "sel": bundles[2]["sel"].clone()},
            "the down target's term dropped": {**bundles[2],
                                               "b_down": torch.zeros_like(bundles[2]["b_down"])}}
    lost["slot 0's selection zeroed"]["sel"][0] = 0
    swapped = lost["slot 1 on the other adapter"]["sel"]
    swapped[1] = swapped[1].flip(0)
    empty = {**bundles[2], "sel": torch.zeros_like(bundles[2]["sel"])}
    len0 = torch.as_tensor(hd_lengths, dtype=torch.int32, device=device)
    start2 = torch.full_like(len0, span[0])
    keys1 = int(np.minimum(hd_lengths, s_hd).sum()) + b * (span[1] - span[0])
    g = torch.Generator(device=device).manual_seed(SEED + 41)
    out = {}
    for t, int8 in ((1, True), (SPEC_K + 1, True), (1, False)):
        gap = span[1] - span[0] - (t - 1)  # the round's rows end where phase 6's last step writes
        end2 = start2 + gap
        pos = (len0 + gap)[:, None] + torch.arange(t, device=device, dtype=torch.int32)
        h0 = (0.02 * torch.randn((b, t, lc.hidden_size), generator=g, device=device)).bfloat16()
        keys = int(np.minimum(hd_lengths, s_hd).sum()) + b * gap
        cache = random_cache(lc, b, s_hd, int8, SEED + 7, device)
        form = "K4-LoRA" if t == 1 else "K4-LoRA verify"
        tag = f"{form} B={b} T={t} S={s_hd} {'int8' if int8 else 'bf16'} cache, n=2 r={LORA_RANK}"

        def copy(c, n_layers=None):
            sl = slice(None, n_layers)
            return KVCache(c.k[sl].clone(), c.v[sl].clone(), 0,
                           *((c.k_scale[sl].clone(), c.v_scale[sl].clone()) if int8
                             else (None, None)))

        def run(lm_layers, lcx, c, slot_lora, kernel=True, weights=None):
            """One call on cache c in place: (hidden [B, T, D], k_new, v_new
            as [L, B, T, H, d])."""
            x = h0[:, 0].contiguous() if t == 1 else h0
            p = pos[:, 0].contiguous() if t == 1 else pos
            if kernel:
                fn = k4.fused_decode_hidden if t == 1 else k4.fused_verify_hidden
                hid, kn, vn = fn({"layers": lm_layers}, lcx, x, c.k, c.v, len0, start2, end2,
                                 end2, p, k_scale=c.k_scale, v_scale=c.v_scale,
                                 slot_lora=slot_lora, weights=weights)
            else:
                fn = k4.fused_decode_hidden_plain if t == 1 else k4.fused_verify_hidden_plain
                hid, kn, vn = fn(lm_layers, lcx, x, c.k, c.v, len0, start2, end2, p, c.k_scale,
                                 c.v_scale, slot_lora)
            if t == 1:
                hid, kn, vn = hid[:, None], kn[:, :, None], vn[:, :, None]
            return hid, kn, vn

        c2 = copy(cache, 2)
        (c2.v_scale if int8 else c2.v).mul_(K4_V_GAIN)
        ck = copy(c2)
        hk, kn, vn = run(layers[:2], lc2, ck, bundles[2])
        hk0 = run(layers[:2], lc2, copy(c2), None)[0]
        hp0 = run(layers[:2], lc2, copy(c2), None, kernel=False)[0]
        hp = run(layers[:2], lc2, copy(c2), bundles[2], kernel=False)[0]
        losts = {k: run(layers[:2], lc2, copy(c2), v, kernel=False)[0] - hp0.float()
                 for k, v in lost.items()}
        err = compare_lora_update(tag + " 2 layers", hk.float() - hk0.float(),
                                  hp.float() - hp0.float(), losts)
        he = run(layers[:2], lc2, copy(c2), empty)[0]
        if not torch.equal(he, hk0):
            raise AssertionError(f"{tag}: an all-zero selection does not give K4's bits")
        if int8:
            eq = written_rows_equal(ck, kn, vn, end2)
            print(f"  {tag}: int8 rows and scales written bit-equal to quantize_kv of the returned "
                  f"rows {eq}; all-zero selection gives K4's hidden state bit for bit True")
            if not eq:
                raise AssertionError(f"{tag}: written int8 rows differ from quantize_kv's")
        del c2, ck

        weights = k4.FusedWeights({"layers": layers}, lc)
        kc, vc = cache.k.clone(), cache.v.clone()
        pc = KVCache(kc, vc, 0, cache.k_scale, cache.v_scale)

        def kernel(slot_lora=bundles[32]):
            return run(layers, lc, cache, slot_lora, weights=weights)[0]

        def plain():
            return run(layers, lc, pc, bundles[32], kernel=False)[0]

        hidden, again, p_hidden = kernel(), kernel(), plain()
        if not torch.equal(again, hidden):
            raise AssertionError(f"{tag}: two identical calls differ")
        rel = ((hidden.float() - p_hidden.float()).pow(2).mean().sqrt()
               / p_hidden.float().pow(2).mean().sqrt()).item()
        base = kernel(None)
        moved = ((hidden.float() - base.float()).pow(2).mean().sqrt()
                 / base.float().pow(2).mean().sqrt()).item()
        print(f"  {tag} {lc.num_hidden_layers} layers hidden: relative RMS difference {rel:.4f} "
              f"(bound {K4_DEEP_REL_RMS}), the adapters move it by {moved:.4f} (relative RMS), "
              f"two calls identical")
        if not rel <= K4_DEEP_REL_RMS:
            raise AssertionError(f"{tag}: 32-layer hidden differs from the plain version ({rel})")
        ms, base_ms = time_ms(kernel), time_ms(lambda: kernel(None))
        plain_ms = time_ms(plain, iters=3, warmup=1)
        nbytes, flops = k4_bytes_flops(lc, b, keys, int8, t)
        lbytes, lflops = fd_lora_bytes_flops(bundles[32], b * t)
        b_ms, b_by = bound(nbytes + lbytes, flops + lflops)
        k4_name = "K4" if t == 1 else "K4-verify"
        print(f"  {tag} {lc.num_hidden_layers} layers: kernel {ms:.4f} ms ({k4_name} without the "
              f"term on the same cache in this call {base_ms:.4f} ms, +{ms - base_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of "
              f"the kernel's time, ratio {ms / base_ms:.3f}; the adapters "
              f"{lbytes / 1e6:.1f} MB of {(nbytes + lbytes) / 1e9:.3f} GB; {keys} valid cache "
              f"rows)")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "base_ms": base_ms}
        if int8:
            out["fused_decode_lora" if t == 1 else "fused_verify_lora"] = row
        else:
            out["fused_decode_lora"]["max_abs_err"] = max(out["fused_decode_lora"]["max_abs_err"],
                                                          err)
        del cache, kc, vc, pc, weights
    del bundles, lost, empty
    torch.cuda.empty_cache()
    return out


def per_layer_reference(params, cfg, slot_lora, req: dict, adapter, device) -> tuple[list, list]:
    """One request under one adapter on the per-layer path, recorded: its
    whole prompt prefilled under `prefill_params` (batch 1), then NEW_TOKENS
    - 1 per-layer decode steps (K3, `ops/layers.linear`'s slot term) on the
    same params. Returns (tokens, top-2 margins)."""
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, prefill

    pp = slot_lora.prefill_params(params, adapter)
    dev = device_batch(req, torch.bfloat16, device)
    l = req["token_ids"].shape[1]
    logits, cache = prefill(pp, cfg, dev, l + NEW_TOKENS, torch.int8)
    toks, margins = [], []
    for step in range(NEW_TOKENS):
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float(top2[0, 0] - top2[0, 1]))
        toks.append(int(logits[0].argmax()))
        if step < NEW_TOKENS - 1:
            logits, cache = decode_step(pp, cfg, cache, logits.argmax(-1), dev["lengths"], step, l,
                                        fused=False)
    del cache
    return toks, margins


def phase_lora_serving(device, seed: int) -> dict:
    """Phase 18 (configuration H): TokenPacker-HD-7b with its LM from
    `quantize_lm_int8`, an int8 cache and two adapters of rank 16 over all
    seven targets, written as PEFT directories and read back by
    `load_adapter` (ad1 with a projector in non_lora_trainables.bin),
    through `ContinuousBatcher(num_slots=4, max_seq_len=2080,
    prefill_chunk_size=256, speculative_k=4, adapters=...)`: phase 6's 4 HD
    requests under ad0, ad1, none and ad0, the 3x3 one again under ad1 and
    one cancelled after its 4th token, 32 greedy tokens each. K4-LoRA once
    a plain step, its verify form once a round, K4 without the term, K3 and
    K9 never; ad1's admissions alone run on its projector; tokens equal a
    recorded per-layer run of each request under its adapter wherever
    its margin is decisive. Then phase 10's paged batcher with the same
    adapters: the 3x3 request under ad0, ad1 and ad0 again maps cached pages
    only for the repeat under ad0; K5 32 times a step."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden, fused_verify_hidden
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.ops.vit_block import vit_block
    from tokenpacker_tpu_torch.serve import scheduler as sched
    from tokenpacker_tpu_torch.serve.multi_lora import load_adapter

    cfg = preset_config(HD_PRESET)
    t0 = time.perf_counter()
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    proj = params_to(params["projector"], "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 42)
    for leaf in (proj["mlp"]["fc1"], proj["mlp"]["fc2"]):
        leaf["kernel"] = leaf["kernel"] * (1 + 0.05 * torch.randn(leaf["kernel"].shape,
                                                                  generator=g))
    made = random_adapters(cfg.lm, seed + 43, LORA_SERVE_SCALE)
    with tempfile.TemporaryDirectory() as tmp:
        for name, ad in made.items():
            write_peft(Path(tmp) / name, ad, proj if name == "ad1" else None)
        t1 = time.perf_counter()
        adapters = {name: load_adapter(str(Path(tmp) / name), cfg) for name in made}
        load_s = time.perf_counter() - t1
    del made, proj
    reqs = paged_requests(cfg, seed)
    work = list(zip(reqs[:4], LORA_SLOTS)) + [(reqs[0], "ad1"), (reqs[-1], None)]
    print(f"phase 18 (H): {HD_PRESET} int8 LM, int8 cache, 2 adapters of rank {LORA_RANK} over "
          f"all seven targets (entries {LORA_SERVE_SCALE}, alpha {LORA_ALPHA}; ad1 with a "
          f"projector) written as PEFT directories and read by load_adapter in {load_s:.2f} s, "
          f"from seed {seed} ({time.perf_counter() - t0:.2f} s to build), through "
          f"ContinuousBatcher: {SPEC_SLOTS} slots, max_seq_len {SPEC_SEQ}, chunks of 256, "
          f"speculative_k {SPEC_K}; {len(work)} requests, grids {[r['grid'] for r, _ in work]}, "
          f"adapters {[a for _, a in work]}, {NEW_TOKENS} greedy tokens each, the last "
          f"cancelled after its {CANCEL_AFTER}th")
    counters = {"vit_attention": (vit_attention, "launches"),
                "vit_block": (vit_block, "launches"),
                "flash_attention": (flash_attention, "launches"),
                "decode_attention": (decode_attention, "launches"),
                "fused_decode": (fused_decode_hidden, "launches"),
                "fused_verify": (fused_verify_hidden, "launches"),
                "fused_decode_lora": (fused_decode_hidden, "lora_launches"),
                "fused_verify_lora": (fused_verify_hidden, "lora_launches")}

    def serve(spec_k: int, items: list, cancel_last: bool):
        """One main-path run: a ContinuousBatcher with the adapters, the
        counts set to 0 just before and read just after. Returns (tokens,
        batcher, launches, admission latencies, wall seconds, peak bytes,
        which admissions ran on ad1's projector)."""
        batcher = sched.ContinuousBatcher(
            params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ, prefill_chunk_size=256,
            speculative_k=spec_k, kv_cache_dtype=torch.int8, adapters=adapters, device=device)
        sl = batcher.slot_lora
        projectors, real_encode = [], sched.encode_images

        def recording_encode(*args):
            projectors.append(args[0]["projector"] is sl.projectors["ad1"])
            return real_encode(*args)

        submitted, first_at, futs = {}, {}, []

        def on_token(i):
            def hook(tok):
                first_at.setdefault(i, time.perf_counter())
                if (cancel_last and i == len(items) - 1
                        and len(futs[i]._tp_request.tokens) == CANCEL_AFTER):
                    batcher.cancel(futs[i])
            return hook

        sched.encode_images = recording_encode
        try:
            torch.cuda.synchronize()
            for obj, attr in counters.values():
                setattr(obj, attr, 0)
            torch.cuda.reset_peak_memory_stats()
            batcher.start()
            t0 = time.perf_counter()
            for i, (r, a) in enumerate(items):
                submitted[i] = time.perf_counter()
                futs.append(batcher.submit(r, max_new_tokens=NEW_TOKENS, on_token=on_token(i),
                                           adapter=a))
            tokens = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            batcher.stop()
            torch.cuda.synchronize()
        finally:
            sched.encode_images = real_encode
            batcher.stop()
        launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        latency = [first_at[i] - submitted[i] for i in range(len(items))]
        return (tokens, batcher, launches, latency, wall, torch.cuda.max_memory_allocated(),
                projectors)

    tokens, batcher, launches, latency, wall, peak, projectors = serve(SPEC_K, work, True)
    st = batcher.stats
    rounds, n_tok = st["verify_rounds"], sum(map(len, tokens))
    print(f"  served in {wall:.3f} s (host clock): tokens per request {[len(t) for t in tokens]}, "
          f"{n_tok / wall:.2f} tok/s over the run; admission latency (submit -> first token, "
          f"host clock) {[round(x * 1e3, 2) for x in latency]} ms; peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"  {rounds} verify rounds emitted {st['verify_tokens']} tokens "
          f"({st['verify_tokens'] / max(rounds, 1):.3f} a round), "
          f"{st['verify_s'] / max(rounds, 1) * 1e3:.3f} ms a round; {st['decode_steps']} plain "
          f"steps after a backoff; launches {launches}; admissions on ad1's projector "
          f"{projectors}")
    want = {"vit_attention": tower_blocks(cfg) * len(projectors), "vit_block": 0,
            "flash_attention": 0, "decode_attention": 0, "fused_decode": 0, "fused_verify": 0,
            "fused_decode_lora": st["decode_steps"], "fused_verify_lora": rounds}
    if launches != want:
        raise AssertionError(f"phase 18: launch counts {launches} != {want}")
    if rounds == 0:
        raise AssertionError("phase 18: no verify round ran")
    if projectors != [a == "ad1" for _, a in work]:
        raise AssertionError(f"phase 18: ad1's projector ran in admissions {projectors}")
    if batcher.params["projector"] is not params["projector"]:
        raise AssertionError("phase 18: the step params do not hold the base projector")
    leftover = ([s for s in batcher.slots if s is not None], batcher.lengths.any(),
                batcher._pending, batcher.queue.qsize())
    if leftover != ([], False, None, 0):
        raise AssertionError(f"phase 18: the batcher holds state after the run: {leftover}")
    if not 0 < len(tokens[-1]) < NEW_TOKENS:
        raise AssertionError(f"phase 18: the cancelled request got {len(tokens[-1])} tokens")
    sl = batcher.slot_lora
    del batcher

    # the same batcher without speculation on the first 4 requests: its plain
    # steps (K4-LoRA at T = 1) beside the rounds above, in this call
    p_tokens, plain, p_launches, _, p_wall, _, _ = serve(0, work[:4], False)
    pst = plain.stats
    steps = pst["decode_steps"]
    print(f"  without speculation, the first 4 requests: {steps} plain steps, "
          f"{pst['decode_s'] / max(steps, 1) * 1e3:.3f} ms a step "
          f"({pst['alone_s'] / max(pst['alone_steps'], 1) * 1e3:.3f} with no admission work; host "
          f"clock, to the argmax on the host); {sum(map(len, p_tokens)) / p_wall:.2f} tok/s over "
          f"the run; launches {p_launches}")
    want = {**want, "vit_attention": tower_blocks(cfg) * 4, "fused_decode_lora": steps,
            "fused_verify_lora": 0}
    if p_launches != want or steps == 0:
        raise AssertionError(f"phase 18: launch counts {p_launches} != {want}")
    launches = {k: launches[k] + p_launches[k] for k in launches}
    del plain

    t0 = time.perf_counter()
    refs = [per_layer_reference(params, cfg, sl, r, a, device) for r, a in work[:5]]
    agree = [decisive_agree(f"phase 18 request {i} ({work[i][1]})", tokens[i], *refs[i])
             for i in range(5)]
    agree += [decisive_agree(f"phase 18 plain request {i}", p_tokens[i], *refs[i])
              for i in range(4)]
    differ = [sum(a != b for a, b in zip(refs[i][0], refs[j][0])) for i, j in ((0, 4), (0, 2))]
    print(f"  per-layer reference runs (the `linear` term, K3) of the first 5 requests under "
          f"their adapters ({time.perf_counter() - t0:.1f} s): tokens equal for the first "
          f"{agree} of {NEW_TOKENS} (5 speculative, 4 plain); reference margins at the first "
          f"difference within the band {LOGIT_BAND}; the 3x3 request's reference under ad0 "
          f"differs from ad1's in {differ[0]} tokens, from request 2's (none) in {differ[1]}")

    # D's paged batcher with the same adapters: the 3x3 request under ad0,
    # ad1 and ad0 again
    paged = sched.PagedContinuousBatcher(
        params, cfg, num_slots=PAGED_SLOTS, num_pages=2 * PAGED_SLOTS * PAGES_PER_SEQ + 1,
        page_size=PAGE_SIZE, max_pages_per_seq=PAGES_PER_SEQ, prefill_chunk_size=256,
        prefix_cache=True, kv_cache_dtype=torch.int8, adapters=adapters, device=device)
    paged_attention.launches = 0
    hits, p_tokens = [], []
    paged.start()
    try:
        t0 = time.perf_counter()
        for a in ("ad0", "ad1", "ad0"):
            p_tokens.append(paged.submit(reqs[0], max_new_tokens=NEW_TOKENS,
                                         adapter=a).result(timeout=600))
            hits.append(paged.prefix.stats()["prefix_cache_hits"])
        p_wall = time.perf_counter() - t0
    finally:
        paged.stop()
    pst = paged.stats
    launches["paged_attention"] = paged_attention.launches
    p_agree = [decisive_agree(f"phase 18 paged {a}", t, *refs[j])
               for t, a, j in zip(p_tokens, ("ad0", "ad1", "ad0"), (0, 4, 0))]
    print(f"  PagedContinuousBatcher (phase 10's settings) with the adapters, the 3x3 request "
          f"under ad0, ad1, ad0: prefix-cache hits after each {hits}, {pst['decode_steps']} steps "
          f"at {pst['decode_s'] / max(pst['decode_steps'], 1) * 1e3:.3f} ms a step (host clock), "
          f"{sum(map(len, p_tokens)) / p_wall:.2f} tok/s; K5 {paged_attention.launches} launches; "
          f"tokens equal to the per-layer reference for the first {p_agree}")
    if hits != [0, 0, 1]:
        raise AssertionError(f"phase 18: prefix-cache hits {hits}, expected [0, 0, 1]: pages must "
                             "be shared under one adapter only")
    if paged_attention.launches != cfg.lm.num_hidden_layers * pst["decode_steps"]:
        raise AssertionError(f"phase 18: {paged_attention.launches} K5 launches for "
                             f"{pst['decode_steps']} paged steps")
    del params, paged, adapters, sl
    torch.cuda.empty_cache()
    return launches


def phase_lora_parity(device, seed: int) -> None:
    """Phase 19: full widths, 2 LM layers, int8 weights and cache, phase
    18's kind of adapters (entries LORA_SCALE): card bf16 (K4-LoRA) against
    CPU fp32 (its plain version). One HD admission under ad1 (its
    `prefill_params`), then 4 decode steps (`decode_step_cb` on the slot's
    overlay) and one verify round at k = 4 (`verify_step_cb`), both sides
    fed the same prompt ids, every logit within LOGIT_BAND; the card's same
    run with the slot's adapter term dropped (its selection zeroed after
    the admission) must read several bands off."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import decode_step_cb, device_batch, fused_weights, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden, fused_verify_hidden
    from tokenpacker_tpu_torch.serve.multi_lora import SlotLora
    from tokenpacker_tpu_torch.speculative import verify_step_cb

    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = params_to(params, "cpu", torch.float32)
    adapters = random_adapters(cfg.lm, seed + 44, LORA_SCALE)
    batch, blocks = make_hd_requests(cfg, seed + 1, sizes=((672, 336),), text_lens=(40,))
    l = batch["token_ids"].shape[1]
    t0 = time.perf_counter()
    sides = {}
    for k, (p, c, dt, dev) in {"gpu": (params, cfg, torch.bfloat16, device),
                               "cpu": (cpu_params, cpu_cfg, torch.float32, "cpu")}.items():
        sl = SlotLora(p, c, adapters, 1, dtype=dt)
        sl.set_slot(0, "ad1")
        sides[k] = (sl, c, device_batch(batch, dt, dev), p)
    sides["dropped"] = sides["gpu"]

    ids = torch.as_tensor(batch["token_ids"][0])
    toks = [ids[10 + j:11 + j] for j in range(5)]  # text ids of the prompt

    def run(k):
        """Admission, 4 steps and a verify round on one side; `dropped`: the
        card with the slot's selection zeroed after the admission. Returns
        the logits of each."""
        sl, c, dev, p = sides[k]
        logits, cache = prefill(sl.prefill_params(p, "ad1"), c, dev, l + 16, torch.int8)
        over = sl.overlay(p)
        fused = fused_weights(over, c)
        if k == "dropped":
            sl.set_slot(0, None)
        out = [logits.float().cpu()]
        cur = dev["lengths"].clone().int()
        active = torch.ones(1, dtype=torch.bool, device=cur.device)
        for step in range(4):
            tok = toks[step].to(cur.device)
            logits, cache = decode_step_cb(over, c, cache, tok, cur, active, fused)
            cur = cur + 1
            out.append(logits.float().cpu())
        fed = torch.cat([toks[4], ids[1:1 + SPEC_K]])[None]
        logits, _ = verify_step_cb(over, c, cache, fed.to(cur.device), cur, fused)
        out.append(logits[0].float().cpu())
        sl.set_slot(0, "ad1")
        return out

    cpu = run("cpu")
    for fn in (fused_decode_hidden, fused_verify_hidden):
        fn.lora_launches = 0
    gpu = run("gpu")
    counts = (fused_decode_hidden.lora_launches, fused_verify_hidden.lora_launches)
    dropped = run("dropped")
    names = ["admission"] + [f"step {j}" for j in range(4)] + ["verify round"]
    res = [band_check(f"phase 19 {n}", gg, cc) for n, gg, cc in zip(names, gpu, cpu)]
    lost = [(dd - cc).abs().max().item() for dd, cc in zip(dropped[1:], cpu[1:])]
    print(f"phase 19: full widths, 2 LM layers, int8 weights + int8 cache, 2 adapters of rank "
          f"{LORA_RANK} (entries {LORA_SCALE}), 1 HD request (grid {blocks}) under ad1: card bf16 "
          f"(K4-LoRA, {counts[0]} steps and {counts[1]} verify form) vs CPU fp32 (plain) "
          f"({time.perf_counter() - t0:.1f} s): max|dlogit| {[round(r[0], 4) for r in res]} "
          f"band={LOGIT_BAND}; top-1 agree {[r[2] for r in res]}; the card's steps and round "
          f"with the slot's adapter term dropped (must read several bands) "
          f"{[round(x, 4) for x in lost]}")
    if counts != (4, 1):
        raise AssertionError(f"phase 19: K4-LoRA launches {counts}, expected (4, 1)")
    if not min(lost) > 3 * LOGIT_BAND:
        raise AssertionError("phase 19: the band does not see the adapter term dropped")
    del params, cpu_params, sides
    torch.cuda.empty_cache()


# ---- MPT: K2's key-only bias, K3's slopes, cells I and J ---------------------------

MPT_TRAIN_BATCH, MPT_TRAIN_STEPS = 4, 3  # phase 22: batch 4 padded to TRAIN_SEQ, no remat


# -- phases 25-27: the generation surface on B's model ------------------------------------

# phase 25's sampled requests: LLaVA's CLI temperature band with the OpenAI
# front end's filters and HF's repetition penalty
SAMPLED = dict(temperature=0.7, top_p=0.9, top_k=50, min_p=0.05, repetition_penalty=1.1)
SEED_REQ = 1234  # phase 26's seeded request
TV_LIMIT = 0.05  # total variation of 4,096 draws (sampling noise alone: ~0.03)
LP_BAND = 1e-3  # phase 26's logprob entries against log_softmax of the recorded raw logits
BEAMS, BEAM_TOKENS = 4, 16
# phase 27: a beam's score (sum of log-probabilities / len**lp) against one
# teacher-forced prefill of prompt + beam, per token: the beam decodes over
# an int8 cache (K4), the prefill attends the unquantized keys (K2) in bf16
BEAM_SCORE_BAND = 0.02


def sampling_counters() -> dict:
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden, fused_verify_hidden
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.ops.vit_block import vit_block

    return {"vit_attention": vit_attention, "vit_block": vit_block,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "fused_decode": fused_decode_hidden, "fused_verify": fused_verify_hidden,
            "paged_attention": paged_attention}


def tie_agree(name: str, got: list, want: list, margins: list) -> int:
    """`got` equals `want` up to the first difference, which must come
    where the reference's top-2 margin is 0: a bf16 tie, which a sampler
    keeps (top_k's `< kth` rule) and the argmax breaks by the lower id.
    Returns how many leading tokens are equal."""
    agree = 0
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if margins[j] != 0.0:
                raise AssertionError(f"{name}: token {j} differs where the greedy margin is "
                                     f"{margins[j]:.4f}, not a tie")
            break
        agree += 1
    return agree


def tv_distance(toks: torch.Tensor, p: torch.Tensor) -> float:
    freq = torch.bincount(toks, minlength=p.numel()).double() / toks.numel()
    return 0.5 * (freq - p.double()).abs().sum().item()


def phase_sampled_generator(device, seed: int, params, cfg, batch, card: str) -> dict:
    """Phase 25 (configuration K): B's model and requests through
    `Generator.generate` at SAMPLED with an explicit generator, 32 tokens.
    Checks: one K4 call a decode step; every token in the support of the
    filters applied to the penalized logits of its step (recorded by
    wrapping the sampler here); the same generator seed gives the same
    tokens; top_k = 1 at temperature 0.7 gives the greedy tokens up to a
    bf16 tie; the sampler on a [4, 32000] bf16 step under the sync debug
    mode "error"; 4,096 draws from one 16-token distribution within
    TV_LIMIT, unseeded and seeded (seeds 0-4095 at one step). Printed: ms a
    step, greedy and sampled in turns (host clock)."""
    from tokenpacker_tpu_torch import generate as gen_mod

    counters = sampling_counters()
    gen = gen_mod.Generator(params, cfg, kv_cache_dtype=torch.int8)
    ref_tokens, ref_margins = plain_reference(params, cfg, batch, device)

    def run(**kw):
        res = gen.generate(batch, max_new_tokens=NEW_TOKENS, **kw)
        torch.cuda.synchronize()
        return res

    def sampled():
        return run(generator=torch.Generator(device=device).manual_seed(seed), **SAMPLED)

    run()
    sampled()  # warm both paths
    order, res = ("greedy", "sampled", "sampled", "greedy"), []
    for i, label in enumerate(order):
        if i == 1:
            reset_counts(counters)
        res.append(sampled() if label == "sampled" else run())
        if i == 1:
            launches = read_counts(counters)
    steps = res[1].stats["decode_steps"]
    want = {"vit_attention": tower_blocks(cfg), "vit_block": 0,
            "flash_attention": cfg.lm.num_hidden_layers, "decode_attention": 0,
            "fused_decode": steps, "fused_verify": 0, "paged_attention": 0}
    print(f"phase 25: {HD_PRESET} int8 LM, int8 cache, phase 6's {batch['token_ids'].shape[0]} "
          f"HD requests through Generator.generate at {SAMPLED}, {NEW_TOKENS} tokens, an explicit "
          f"generator seeded {seed}: launches {launches} ({steps} decode steps)")
    if launches != want:
        raise AssertionError(f"phase 25: launch counts {launches} != {want}")
    if res[1].sequences != res[2].sequences:
        raise AssertionError("phase 25: two sampled calls with the same generator seed differ")
    ms = [r.stats["decode_s"] / r.stats["decode_steps"] * 1e3 for r in res]
    greedy_ms, sampled_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    print(f"  ms a decode step (host clock, greedy / sampled / sampled / greedy in turns): "
          f"{[round(m, 3) for m in ms]}; sampling adds {sampled_ms - greedy_ms:+.3f} ms a step "
          f"at B = {batch['token_ids'].shape[0]} ({card})")
    g_agree = [decisive_agree(f"phase 25 greedy request {i}", res[0].sequences[i], ref_tokens[i],
                              ref_margins[i]) for i in range(len(ref_tokens))]

    # every draw inside the filters' support of the logits it was drawn from
    real, held = gen_mod.sample_tokens, []

    def recording(logits, temperature, top_p=None, top_k=None, min_p=None, generator=None,
                  keys=None):
        toks = real(logits, temperature, top_p, top_k, min_p, generator, keys)
        kept = torch.isfinite(gen_mod.filter_logits(logits, temperature, top_k, top_p, min_p))
        held.append(kept.gather(-1, toks[:, None]).all())
        return toks

    gen_mod.sample_tokens = recording
    try:
        recorded = sampled()
    finally:
        gen_mod.sample_tokens = real
    inside = bool(torch.stack(held).all())
    if recorded.sequences != res[1].sequences or not inside or len(held) != steps + 1:
        raise AssertionError(f"phase 25: recorded run equal {recorded.sequences == res[1].sequences}"
                             f", every token in its step's support {inside}, {len(held)} draws")
    one = run(temperature=0.7, top_k=1, generator=torch.Generator(device=device).manual_seed(seed))
    k1 = [tie_agree(f"phase 25 top_k=1 request {i}", one.sequences[i], ref_tokens[i],
                    ref_margins[i]) for i in range(len(ref_tokens))]
    print(f"  tokens per request {[len(s) for s in res[1].sequences]}, first request "
          f"{res[1].sequences[0][:8]}...; all {len(held)} draws x {len(ref_tokens)} rows inside "
          f"the support of the filters on their penalized logits; greedy tokens equal the "
          f"recorded plain run for {g_agree} of {NEW_TOKENS}; top_k=1 at temperature 0.7 equals "
          f"them for {k1} (exactly: {one.sequences == res[0].sequences})")

    # the sampler alone on a [4, 32000] bf16 step: no host sync
    g = torch.Generator(device="cpu").manual_seed(seed)
    vocab = cfg.lm.vocab_size
    logits = (torch.randn((4, vocab), generator=g) * 3).to(device=device, dtype=torch.bfloat16)
    rows = [torch.tensor(x, device=device) for x in ([0.0, 0.7, 1.0, 0.8], [1.0, 0.9, 0.95, 1.0],
                                                    [0, 50, 0, 40], [0.0, 0.05, 0.1, 0.0])]
    rows.append(torch.as_tensor(gen_mod.seed_keys([-1, -1, SEED_REQ, 7], [0, 3, 5, 0]),
                                device=device))
    counts = torch.randint(0, 3, (4, vocab), generator=g, dtype=torch.int32).to(device)
    presence = (torch.rand((4, vocab), generator=g) < 0.01).to(device)
    rep = torch.tensor([[1.0], [1.1], [1.2], [1.0]], device=device)
    gen_d = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pen = gen_mod.apply_penalties(logits, counts, presence, rep, 0.1, 0.2)
        toks = gen_mod.sample_tokens(pen, *rows[:4], gen_d, rows[4])
        gen_mod.logprob_rows(logits, toks, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sampler_ms = time_ms(lambda: gen_mod.sample_tokens(
        gen_mod.apply_penalties(logits, counts, presence, rep, 0.1, 0.2), *rows[:4], gen_d,
        rows[4]))
    plain_ms = time_ms(lambda: gen_mod.sample_tokens(logits, 0.7, 0.9, 50, 0.05, gen_d))

    # the draw's distribution
    p_logits = (torch.randn(16, generator=g) * 1.5).to(device)
    p = torch.softmax(p_logits / 0.9, -1)
    n = 4096
    tiled = p_logits.expand(n, 16)
    tv_free = tv_distance(gen_mod.sample_tokens(tiled, 0.9, generator=gen_d), p)
    tv_seeded = tv_distance(gen_mod.sample_tokens(
        tiled, 0.9, keys=torch.as_tensor(gen_mod.seed_keys(np.arange(n), np.zeros(n)),
                                         device=device)), p)
    print(f"  the sampler alone (penalties, 4 filters, seeded and unseeded rows) on [4, {vocab}] "
          f"bf16 under sync debug mode 'error': no host sync, {sampler_ms:.4f} ms a call, "
          f"{plain_ms:.4f} for phase 25's settings without penalties or seeds (CUDA events over "
          f"back-to-back calls, launch-bound; {card}); {n} draws from a 16-token distribution: total variation "
          f"{tv_free:.4f} unseeded, {tv_seeded:.4f} over seeds 0-{n - 1} (limit {TV_LIMIT})")
    if max(tv_free, tv_seeded) > TV_LIMIT:
        raise AssertionError(f"phase 25: total variation {tv_free}, {tv_seeded} > {TV_LIMIT}")
    return launches


def row_setting(x, row: int):
    """One row's value of a sampler setting: None, a number, or a tensor of
    one value a row (or of one value for all)."""
    if isinstance(x, torch.Tensor) and x.numel() > 1:
        return x.reshape(-1)[row:row + 1]
    return x


def check_logprob_entries(name: str, entries: list, rows: list, n_top: int) -> float:
    """Each entry against log_softmax of the raw logits recorded for it: the
    chosen and the listed logprobs within LP_BAND, the list sorted and
    equal in value to the row's top n_top. Returns the worst difference."""
    if len(entries) != len(rows) or not entries:
        raise AssertionError(f"{name}: {len(entries)} logprob entries for {len(rows)} tokens")
    worst = 0.0
    for e, row in zip(entries, rows):
        lp = torch.log_softmax(row, dim=-1)
        values = [v for _, v in e["top"]]
        if values != sorted(values, reverse=True) or len(values) != n_top:
            raise AssertionError(f"{name}: a top list is not sorted or not {n_top} long")
        worst = max([worst, abs(e["logprob"] - lp[e["id"]].item())]
                    + [abs(v - lp[t].item()) for t, v in e["top"]]
                    + (torch.tensor(values) - lp.topk(n_top).values).abs().tolist())
    if worst > LP_BAND:
        raise AssertionError(f"{name}: logprob entries {worst} from the recomputed ones")
    return worst


def phase_sampling_batchers(device, seed: int, params, cfg, batch, card: str) -> list[dict]:
    """Phase 26 (configuration L): G's dense batcher (fused tower, chunks of
    256, speculative_k 4) and D's paged batcher (prefix cache on) serve 8
    requests of phase 6's images: 2 greedy, 2 sampled (temperature 0.8,
    top_p 0.95), 1 sampled with min_p 0.1, 1 greedy with
    repetition_penalty 1.2, 1 greedy with logprobs=3, 1 sampled with seed
    1234, which is also submitted alone first. Checks per batcher: the
    greedy requests' tokens, in this run and in a greedy-only run, equal
    the recorded plain run's wherever its margin is decisive (so each
    other up to where either parts from it at a near-tie); the seeded
    request's two runs equal up to a step where a draw's Gumbel margin is
    within the band; logprob entries within LP_BAND of log_softmax of the recorded
    raw logits; in the dense batcher, verify rounds while greedy slots are
    active and one token a round for every other slot. Launch counts of
    K4, K4-verify, K5 and K9 printed and checked against the steps."""
    from tokenpacker_tpu_torch.generate import filter_logits, gumbel_noise
    from tokenpacker_tpu_torch.generate import seed_keys as gen_mod_keys
    from tokenpacker_tpu_torch.serve import scheduler as sched

    reqs = paged_requests(cfg, seed)[:4]
    mix = [("greedy", 0, {}), ("greedy", 1, {}),
           ("sampled", 2, dict(temperature=0.8, top_p=0.95)),
           ("sampled", 3, dict(temperature=0.8, top_p=0.95)),
           ("min_p", 0, dict(temperature=0.8, min_p=0.1)),
           ("penalized", 1, dict(repetition_penalty=1.2)),
           ("logprobs", 2, dict(logprobs=3)),
           ("seeded", 3, dict(temperature=0.8, top_p=0.95, seed=SEED_REQ))]
    greedy = [i for i, (kind, _, _) in enumerate(mix)
              if kind in ("greedy", "penalized", "logprobs")]
    counters = sampling_counters()
    runs = []
    real_sample, real_lp, real_entry = (sched.sample_tokens, sched.logprob_rows,
                                        sched.token_logprob_entry)
    for kind in ("dense", "paged"):
        dense = kind == "dense"

        def make():
            if dense:
                return sched.ContinuousBatcher(
                    params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ,
                    prefill_chunk_size=256, speculative_k=SPEC_K, kv_cache_dtype=torch.int8,
                    vit_block=True, device=device)
            return sched.PagedContinuousBatcher(
                params, cfg, num_slots=PAGED_SLOTS, num_pages=2 * PAGED_SLOTS * PAGES_PER_SEQ + 1,
                page_size=PAGE_SIZE, max_pages_per_seq=PAGES_PER_SEQ, prefill_chunk_size=256,
                kv_cache_dtype=torch.int8, device=device)

        ref_tokens, ref_margins = plain_reference(params, cfg, batch, device, vit_block=dense)
        pen_tokens, pen_margins = plain_reference(params, cfg, batch, device, vit_block=dense,
                                                  repetition_penalty=1.2)
        live = {"batcher": None, "seeded": None, "lp": None}
        # the seeded request's key at each of its steps
        step_of = {int(k): step for step, k in enumerate(
            gen_mod_keys([SEED_REQ] * NEW_TOKENS, np.arange(NEW_TOKENS)))}

        def rec_sample(logits, temperature, top_p=None, top_k=None, min_p=None, generator=None,
                       keys=None):
            toks = real_sample(logits, temperature, top_p, top_k, min_p, generator, keys)
            if keys is not None:
                for r, key in enumerate(torch.as_tensor(keys).reshape(-1).tolist()):
                    if key not in step_of:
                        continue
                    f = filter_logits(logits[r:r + 1], row_setting(temperature, r),
                                      row_setting(top_k, r), row_setting(top_p, r),
                                      row_setting(min_p, r))
                    z = (f + gumbel_noise(f.shape, f.device, None, [key]))[0].topk(2).values
                    live["seeded"][step_of[key]] = (int(toks[r]), (z[0] - z[1]).item())
            return toks

        def rec_lp(logits, toks, n_top):
            for slot, r in enumerate(live["batcher"].slots):
                if r is not None and r.logprobs is not None:
                    live["lp"].append(logits[slot].float().cpu())
            return real_lp(logits, toks, n_top)

        def rec_entry(logits_row, tok, n_top):
            live["lp"].append(logits_row.float().cpu())
            return real_entry(logits_row, tok, n_top)

        def serve(batcher, items, seeded_log, advances=None):
            """Submit in order; the tokens, the futures, the stats' change."""
            live.update(batcher=batcher, seeded=seeded_log, lp=[])
            before = dict(batcher.stats)
            futs = [batcher.submit(reqs[j], max_new_tokens=NEW_TOKENS, **o) for _, j, o in items]
            tokens = [f.result(timeout=600) for f in futs]
            torch.cuda.synchronize()
            delta = {k: batcher.stats[k] - before[k] for k in ("decode_steps", "verify_rounds")}
            return tokens, futs, delta

        sched.sample_tokens, sched.logprob_rows, sched.token_logprob_entry = (
            rec_sample, rec_lp, rec_entry)
        try:
            batcher = make()
            advances = []
            if dense:  # the tokens a round of every slot that does not draft
                real_round = batcher._verify_round

                def counting_round(active, b=batcher, real_round=real_round):
                    before = {slot: len(r.tokens) for slot, r in enumerate(b.slots)
                              if r is not None and not r.plain_greedy}
                    if not any(r is not None and r.plain_greedy for r in b.slots):
                        raise AssertionError("phase 26: a verify round without a greedy slot")
                    held = list(b.slots)
                    real_round(active)
                    advances.extend(len(held[slot].tokens) - n for slot, n in before.items())

                batcher._verify_round = counting_round
            batcher.start()
            alone_log, mixed_log = {}, {}
            alone, _, _ = serve(batcher, [mix[-1]], alone_log)
            reset_counts(counters)
            t0 = time.perf_counter()
            mixed, futs, delta = serve(batcher, mix, mixed_log)
            wall = time.perf_counter() - t0
            launches = read_counts(counters)
            lp_rows = live["lp"]
            batcher.stop()
            only = make()
            only.start()
            greedy_only, g_futs, _ = serve(only, [mix[i] for i in greedy], {})
            g_lp_rows = live["lp"]
            only.stop()
        finally:
            sched.sample_tokens, sched.logprob_rows, sched.token_logprob_entry = (
                real_sample, real_lp, real_entry)
        runs.append(launches)
        name = f"phase 26 {kind}"
        steps, rounds = delta["decode_steps"], delta["verify_rounds"]
        layers = cfg.lm.num_hidden_layers
        if dense:
            ok = (launches["fused_decode"] == steps and launches["fused_verify"] == rounds
                  and launches["vit_block"] % tower_blocks(cfg) == 0
                  and launches["vit_attention"] == launches["paged_attention"] == 0)
        else:
            ok = (launches["paged_attention"] == layers * steps and launches["fused_decode"] == 0
                  and launches["fused_verify"] == 0 and launches["vit_block"] == 0)
        print(f"{name}: {'G' if dense else 'D'}'s batcher, 8 requests {[k for k, _, _ in mix]} "
              f"of phase 6's images (the seeded one also alone first): served in {wall:.3f} s "
              f"(host clock), tokens {[len(t) for t in mixed]}; {steps} plain steps, {rounds} "
              f"verify rounds; launches {launches} ({card})")
        if not ok:
            raise AssertionError(f"{name}: launch counts {launches} against {steps} steps and "
                                 f"{rounds} rounds")
        # both runs are held to the recorded plain run wherever its margin is
        # decisive, so they equal each other up to where either parts from it
        # at a near-tie (after that the plain run's margins are another
        # context's, and the two may part legitimately)
        agree = []
        for pos, i in enumerate(greedy):
            j = mix[i][1]
            toks, margins = ((pen_tokens[j], pen_margins[j]) if mix[i][0] == "penalized"
                             else (ref_tokens[j], ref_margins[j]))
            a = decisive_agree(f"{name} request {i}", mixed[i], toks, margins)
            b = decisive_agree(f"{name} greedy-only request {i}", greedy_only[pos], toks, margins)
            both = next((k for k, (x, y) in enumerate(zip(mixed[i], greedy_only[pos])) if x != y),
                        min(len(mixed[i]), len(greedy_only[pos])))
            agree.append((a, b, both))
        same = [mixed[i] == greedy_only[pos] for pos, i in enumerate(greedy)]
        print(f"  greedy, penalized and logprob requests: tokens equal to the recorded plain run "
              f"(mixed run, greedy-only run) and to each other for the first {agree} of "
              f"{NEW_TOKENS}; identical to the greedy-only run {same}")
        # the seeded request: its two runs, held where a draw's margin is decisive
        band = LOGIT_BAND / mix[-1][2]["temperature"]
        for log, toks in ((alone_log, alone[0]), (mixed_log, mixed[-1])):
            if [log[k][0] for k in range(len(toks))] != toks:
                raise AssertionError(f"{name}: the recorded seeded draws differ from the tokens")
        s_agree = 0
        for k, (a, b) in enumerate(zip(alone[0], mixed[-1])):
            if a != b:
                gap = min(alone_log[k][1], mixed_log[k][1])
                if gap > band:
                    raise AssertionError(f"{name}: seeded token {k} differs where the draw's "
                                         f"margin {gap:.4f} exceeds {band:.4f}")
                break
            s_agree += 1
        lp_worst = check_logprob_entries(f"{name} logprobs", futs[6]._tp_request.lp_entries,
                                         lp_rows, 3)
        g_lp = check_logprob_entries(f"{name} greedy-only logprobs",
                                     g_futs[greedy.index(6)]._tp_request.lp_entries, g_lp_rows, 3)
        print(f"  seeded request (seed {SEED_REQ}) alone in slot 0, then in a later slot among the "
              f"rest: identical {alone[0] == mixed[-1]}, {s_agree} of {NEW_TOKENS} equal (a "
              f"difference only where the draw's Gumbel margin is within {band:.3f}); logprob "
              f"entries within {max(lp_worst, g_lp):.2e} of log_softmax of the recorded raw "
              f"logits (band {LP_BAND}), top lists sorted")
        if dense:
            if rounds == 0 or not advances or set(advances) != {1}:
                raise AssertionError(f"{name}: {rounds} verify rounds, advances of non-drafting "
                                     f"slots {sorted(set(advances))}")
            print(f"  {rounds} verify rounds, every one with a greedy slot active; the other "
                  f"slots advanced {len(advances)} times, one token a round each")
        del batcher, only
        release_earlier_phases()
    return runs


def teacher_forced_sum(params, cfg, req: dict, seq: list, device) -> float:
    """Sum of log p(seq_j | prompt, seq_<j) by one prefill of the request's
    prompt followed by `seq` (K2, cache-less)."""
    from tokenpacker_tpu_torch.generate import device_batch
    from tokenpacker_tpu_torch.models.lm_api import lm_logits
    from tokenpacker_tpu_torch.models.vlm import vlm_hidden

    true_len = int(req["lengths"][0])
    extra = np.asarray(seq, np.int64)
    b = {"token_ids": np.concatenate([req["token_ids"][0, :true_len], extra])[None],
         "is_image": np.concatenate([req["is_image"][0, :true_len],
                                     np.zeros(len(extra), bool)])[None],
         "image_slot": np.concatenate([req["image_slot"][0, :true_len],
                                       np.zeros(len(extra), np.int64)])[None],
         "lengths": np.array([true_len + len(extra)]), "images": req["images"]}
    dev = device_batch(b, cfg.dtype, device)
    l = b["token_ids"].shape[1]
    hidden = vlm_hidden(params, cfg, {**dev, "positions": torch.arange(l, device=device)[None]})
    logits = lm_logits(params["lm"], cfg.lm, hidden[0, true_len - 1:l - 1]).float()
    lp = torch.log_softmax(logits, dim=-1)
    return lp.gather(-1, torch.as_tensor(extra, device=device)[:, None]).sum().item()


def phase_beams(device, seed: int, params, cfg, batch, card: str) -> dict:
    """Phase 27 (configuration M): phase 6's first 2 HD requests through
    `beam.beam_generate(num_beams=4, max_new_tokens=16, length_penalty=1)`
    over an int8 cache. Checks: K4 at 8 rows every step, once a step; each
    score equals the teacher-forced sum of log-probabilities of its
    sequence (one prefill of prompt + beam through K2) over its length
    within BEAM_SCORE_BAND; num_beams 17 raises ValueError. Printed: whether
    the batch equals each sample's batch-1 search (K4's plans at 4 and 8
    rows may round otherwise)."""
    from tokenpacker_tpu_torch import beam as beam_mod
    from tokenpacker_tpu_torch import generate as gen_mod

    counters = sampling_counters()
    views = int(batch["image_slot"][:2][batch["is_image"][:2]].max()) + 1
    two = {**{k: batch[k][:2] for k in ("token_ids", "is_image", "image_slot", "lengths")},
           "images": batch["images"][:views]}
    reqs = paged_requests(cfg, seed)[:2]
    rows, real = [], gen_mod.fused_decode_hidden

    def recording(lm, lc, emb, *args, **kw):
        rows.append(emb.shape[0])
        return real(lm, lc, emb, *args, **kw)

    gen_mod.fused_decode_hidden = recording
    try:
        reset_counts(counters)
        t0 = time.perf_counter()
        seqs, scores = beam_mod.beam_generate(params, cfg, two, BEAMS, BEAM_TOKENS, 1.0,
                                              kv_cache_dtype=torch.int8)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        gen_mod.fused_decode_hidden = real
    print(f"phase 27: {HD_PRESET} int8 LM, int8 cache, phase 6's first 2 HD requests through "
          f"beam_generate(num_beams={BEAMS}, max_new_tokens={BEAM_TOKENS}, length_penalty=1.0) in "
          f"{seconds:.3f} s (host clock, {card}): K4 rows per step {sorted(set(rows))}, "
          f"launches {launches}")
    if set(rows) != {2 * BEAMS} or launches["fused_decode"] != len(rows):
        raise AssertionError(f"phase 27: K4 ran at rows {sorted(set(rows))}, {len(rows)} steps, "
                             f"{launches['fused_decode']} launches")
    worst = 0.0
    for i, (seq, score) in enumerate(zip(seqs, scores)):
        tf = teacher_forced_sum(params, cfg, reqs[i], seq, device) / len(seq)
        worst = max(worst, abs(tf - score))
        if abs(tf - score) > BEAM_SCORE_BAND:
            raise AssertionError(f"phase 27: request {i} score {score} against the teacher-forced "
                                 f"{tf} (band {BEAM_SCORE_BAND} a token)")
    alone = [beam_mod.beam_generate(params, cfg, req, BEAMS, BEAM_TOKENS, 1.0,
                                    kv_cache_dtype=torch.int8) for req in reqs]
    try:
        beam_mod.beam_generate(params, cfg, two, 17, 2)
        raise AssertionError("phase 27: num_beams=17 was taken")
    except ValueError as e:
        refused = str(e)
    print(f"  beams {[len(s) for s in seqs]} tokens, scores {[round(s, 4) for s in scores]}, "
          f"within {worst:.4f} a token of the teacher-forced prefill (band {BEAM_SCORE_BAND}); "
          f"batched equal to batch-1 per sample: "
          f"{[a[0][0] == s for a, s in zip(alone, seqs)]} (scores "
          f"{[round(a[1][0], 4) for a in alone]}); num_beams=17: ValueError ({refused})")
    return launches


def phase_sampling(device, seed: int, batch, card: str) -> list[dict]:
    """Phases 25-27 on one build of B's model: TokenPacker-HD-7b, random
    weights from the seed, the LM quantized to int8, an int8 cache."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8

    release_earlier_phases()
    cfg = preset_config(HD_PRESET)
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    runs = [phase_sampled_generator(device, seed, params, cfg, batch, card)]
    runs += phase_sampling_batchers(device, seed, params, cfg, batch, card)
    runs.append(phase_beams(device, seed, params, cfg, batch, card))
    del params
    release_earlier_phases()
    return runs


def release_earlier_phases() -> None:
    """Free what earlier phases left in reference cycles (a batcher and the
    futures whose token callbacks hold it), so that a phase's peak memory
    is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def mpt_vlm_config(n_layers: int | None = None, hd: bool = True):
    """MPT-7B (`models/mpt.mpt_config`) behind the CLIP tower and the
    projector (s=2): in the HD-7b geometry (patch_num 9, slice mode) for
    serving, in TokenPacker-7b's (pad mode) for training; `n_layers` cuts
    the depth."""
    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig, preset_config
    from tokenpacker_tpu_torch.models.mpt import mpt_config

    lm = mpt_config() if n_layers is None else mpt_config(n_layers=n_layers)
    base = preset_config(HD_PRESET) if hd else TokenPackerVLMConfig()
    return dataclasses.replace(base, lm=lm)


def mpt_counters() -> dict:
    """Phases 20-23's launch counters: MPT's kernel forms, and the forms it
    must not launch."""
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    return {"vit_attention": vit_attention,
            "flash_attention_bias": (flash_attention, "bias_launches"),
            "flash_attention_bias_bwd": (flash_attention_bwd, "bias_launches"),
            "decode_attention_alibi": (decode_attention, "alibi_launches"),
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention, "fused_decode": fused_decode_hidden,
            "paged_attention": paged_attention}


def bwd_bias_by_query(q, k, v, o, lse, do, bias):
    """A lossy K2-bias backward (fp32, MHA, Tq == Tk, causal, one sample at a
    time): dq as it should be, dk and dv from P rebuilt with the bias indexed
    by the query instead of the key, as a dk/dv kernel that reads the wrong
    axis would give them."""
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, key_bias_rows

    n, t, h, d = q.shape
    rows = key_bias_rows(bias, h, t)
    above = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    out = []
    for i in range(n):
        sl = slice(i, i + 1)
        dq = flash_attention_bwd_plain(q[sl], k[sl], v[sl], o[sl], lse[i * h:(i + 1) * h], do[sl],
                                       True, bias)[0]
        qf, kf, vf, dof = (x[i].float() for x in (q, k, v, do))
        s = torch.einsum("qhd,khd->hqk", qf, kf) * d**-0.5 + rows[:, :, None]
        p = torch.exp(s - lse[i * h:(i + 1) * h, :, None]).masked_fill(above, 0.0)
        del s
        ds = p * (torch.einsum("qhd,khd->hqk", dof, vf)
                  - (dof * o[i].float()).sum(-1).T[:, :, None])
        dk = torch.einsum("hqk,qhd->khd", ds, qf) * d**-0.5
        dv = torch.einsum("hqk,qhd->khd", p, dof)
        del p, ds
        out.append((dq[0], dk.to(k.dtype), dv.to(v.dtype)))
    return tuple(torch.stack(x) for x in zip(*out))


def decode_alibi_slots(q, ck, cv, lengths, needed, span_start, slopes):
    """A lossy K3-ALiBi (fp32): the slopes times the keys' cache slot
    indices, where the decoded span's keys sit at compacted token
    positions."""
    n, h, d = q.shape
    s = ck.shape[1]
    logits = torch.einsum("nhd,nshd->nhs", q.float(), ck.float()) * d**-0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = (kpos < needed[:, None]) & ((kpos < lengths[:, None]) | (kpos >= span_start))
    logits = logits + slopes[None, :, None] * kpos[:, None, :].float()
    probs = torch.softmax(logits.masked_fill(~valid[:, None], float("-inf")), -1).to(q.dtype)
    return torch.einsum("nhs,nshd->nhd", probs, cv)


def mpt_kernel_cases(device, case, hd_lengths: np.ndarray, span: tuple[int, int]) -> dict:
    """Phase 3's MPT rows. K2-bias forward at the serving shape [1, 2048,
    32, 128] and the training shape [4, 2048, 32, 128], causal, MPT-7B's
    ALiBi: o per (sample, 64 positions, head) block, failing the kernel run
    without the bias and the plain version with the last head's slopes
    zeroed. K2-bias backward at the training shape: dq, dk, dv per block,
    two calls bit-equal, failing the kernel without the bias in its
    recompute and dk/dv with the bias indexed by query. K3-ALiBi at [4, 32,
    128], the HD requests' lengths, S = 2080 and phase 20's last decode step
    (the decoded span after the bucket): per (sample, head) row, failing the
    plain version with the keys at their slot indices and the one without
    slopes. The library column: one scaled_dot_product_attention call with
    the causal + ALiBi mask materialised as a bf16 `attn_mask` outside the
    timed region (K2-bias backward: that call's backward alone)."""
    from tokenpacker_tpu_torch.models.mpt import alibi_bias, alibi_slopes
    from tokenpacker_tpu_torch.ops import decode_attention as k3
    from tokenpacker_tpu_torch.ops import flash_attention as k2

    h, d, t = 32, 128, TRAIN_SEQ
    bias = alibi_bias(h, t, device)
    # SDPA's float mask, [1, H, T, T]: ALiBi where a key is visible, -inf above
    above = torch.ones(t, t, dtype=torch.bool, device=device).triu(1)
    mask = bias.expand(1, h, t, t).masked_fill(above, float("-inf")).to(torch.bfloat16)
    zeroed = bias.clone()
    zeroed[:, -1] = 0
    rows = {}
    for n in (1, MPT_TRAIN_BATCH):
        q, k, v = (bf16((n, t, h, d), 60 + i, device) for i in range(3))
        pairs = n * h * t * (t + 1) / 2
        elems = n * t * h * d

        def check(name, out, want, q=q, k=k, v=v):
            return compare_flash_fwd(name, out, want, losts={
                "without the bias": k2.flash_attention(q, k, v, True)[0],
                "the plain version with the last head's slopes zeroed":
                    k2.flash_attention_plain(q, k, v, True, zeroed)[0]})

        rows[n] = case(
            f"K2-bias flash causal q[{n},{t},{h},{d}], MPT-7B ALiBi",
            lambda *a: k2.flash_attention(*a, True, bias),
            lambda *a: k2.flash_attention_plain(*a, True, bias), (q, k, v), check=check,
            library=lambda q=q, k=k, v=v: sdpa(q, k, v, attn_mask=mask),
            work=(4 * elems * 2 + n * h * t * 4 + h * t * 4, 4 * d * pairs), achieved="ops")
        del q, k, v
        torch.cuda.empty_cache()
    out = {"flash_attention_bias": rows[1], "flash_attention_bias_train": rows[MPT_TRAIN_BATCH]}
    out["flash_attention_bias"]["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())

    # the backward at the training shape
    n = MPT_TRAIN_BATCH
    q, k, v, do = (bf16((n, t, h, d), 70 + i, device) for i in range(4))
    pairs, elems = n * h * t * (t + 1) / 2, n * t * h * d
    o, lse = k2.flash_attention(q, k, v, True, bias)

    def kernel():
        return k2.flash_attention_bwd(q, k, v, o, lse, do, True, bias)

    def plain():
        parts = [k2.flash_attention_bwd_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1],
                                              lse[i * h:(i + 1) * h], do[i:i + 1], True, bias)
                 for i in range(n)]
        return tuple(torch.cat(x) for x in zip(*parts))

    tag = f"K2-bias-bwd flash causal q[{n},{t},{h},{d}], MPT-7B ALiBi"
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two identical calls differ")
    want = plain()
    err = max(compare_tiles(f"{tag} {name}", g, w)
              for g, w, name in zip(got, want, ("dq", "dk", "dv")))
    lossy = {"without the bias in the recompute": k2.flash_attention_bwd(q, k, v, o, lse, do, True),
             "with dk/dv reading the bias by query": bwd_bias_by_query(q, k, v, o, lse, do, bias)}
    for what, outs in lossy.items():
        reads = [tile_rel_rms(g, w).max().item() for g, w in zip(outs, want)]
        print(f"  {tag} {what}: dq, dk, dv read {[round(r, 4) for r in reads]}")
        if all(r <= TILE_REL_RMS for r in reads):
            raise AssertionError(f"{tag}: the block measure does not see a backward {what}")
    del got, again, want, lossy
    print(f"  {tag}: two calls identical")
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sd_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    dol = do.transpose(1, 2)
    ms, plain_ms = time_ms(kernel), time_ms(plain, iters=3, warmup=1)
    lib_ms = time_ms(lambda: torch.autograd.grad(sd_out, (ql, kl, vl), dol, retain_graph=True))
    b_ms, b_by = bound(8 * elems * 2 + n * h * t * 4 + h * t * 4, 5 * 2 * d * pairs)
    print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({n} samples one by one), library "
          f"{lib_ms:.4f} ms (SDPA backward alone, float mask), bound {b_ms:.4f} ms ({b_by}), "
          f"{achieved_tflops(5 * 2 * d * pairs, ms)} (the bound's five products)")
    out["flash_attention_bias_bwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, do, o, lse, ql, kl, vl, sd_out, mask
    torch.cuda.empty_cache()

    # K3-ALiBi at phase 20's last decode step
    n, l = len(hd_lengths), span[0]
    s = -(-(l + NEW_TOKENS) // 8) * 8  # generate.prefill's bf16 cache length
    lengths = torch.as_tensor(hd_lengths, dtype=torch.int32, device=device)
    needed = torch.full((n,), span[1] + 1, dtype=torch.int32, device=device)
    q = bf16((n, h, d), 80, device)
    ck, cv = bf16((n, s, h, d), 81, device), bf16((n, s, h, d), 82, device)
    slopes = alibi_slopes(h, device=device)
    kpos = torch.arange(s, device=device)[None, :]
    valid = (kpos < needed[:, None]) & ((kpos < lengths[:, None]) | (kpos >= l))
    keys = int(valid.sum())
    tok_pos = torch.where(kpos >= l, kpos - l + lengths[:, None], kpos).float()
    dmask = (slopes[None, :, None] * tok_pos[:, None, :]).masked_fill(
        ~valid[:, None, :], float("-inf"))[:, :, None, :].to(torch.bfloat16)  # [N, H, 1, S]
    args = (q, ck, cv, lengths, needed, l, slopes)

    def check_rows(name, got, want):
        err = compare_rows(name, got, want, decode_alibi_slots(*args),
                           "compacted token positions (keys at their slot indices)")
        without = row_rel_rms(k3.decode_attention_plain(*args[:6]), want).max().item()
        print(f"  {name}: the plain version without slopes reads {without:.4f}")
        if without <= TILE_REL_RMS:
            raise AssertionError(f"{name}: the row measure does not see the slopes lost")
        return err

    out["decode_attention_alibi"] = case(
        f"K3-ALiBi decode q[{n},{h},{d}] cache S={s} span_start={l}, HD lengths "
        f"{hd_lengths.tolist()}", k3.decode_attention, k3.decode_attention_plain, args,
        library=lambda: sdpa(q[:, None], ck, cv, attn_mask=dmask),
        work=(2 * keys * h * d * 2 + 2 * n * h * d * 2 + 2 * n * 4 + h * 4, 4 * keys * h * d),
        check=check_rows, graph=True, library_graph=True, achieved="bytes")
    del q, ck, cv, dmask
    torch.cuda.empty_cache()
    return out


def full_bias_kernel_cases(device, case, hd_lengths: np.ndarray) -> list[dict]:
    """Phase 3's K2 full-bias rows, at MPT-7B's prefix-LM attention: q/k/v
    [4, 2048, 32, 128] bf16, not causal, the bias `make_prefix_lm_bias`
    with B's prompt lengths as the bidirectional prefixes (causal after
    them) plus MPT-7B's ALiBi as [4, 32, 2048, 2048] fp32 (2 GiB); the
    same mask alone as a head-broadcast [4, 1, 2048, 2048] bias; and that
    one with whole rows below -1e30 (the fp32 minimum, -1e38, -2e30), which
    must give o = 0 and lse = +inf in kernel and plain version alike. Each
    held by `compare_flash_fwd`, which the plain version with the bias's
    last key tile dropped must fail. Work: the products of the unmasked
    (query, key) pairs, the bias read once. Library: one
    scaled_dot_product_attention with the bias as a bf16 `attn_mask`
    (built outside the timed region; its fully masked rows give NaN there,
    timed only)."""
    from tokenpacker_tpu_torch.models.mpt import alibi_bias, make_prefix_lm_bias
    from tokenpacker_tpu_torch.ops import flash_attention as k2

    n, t, h, d = len(hd_lengths), TRAIN_SEQ, 32, 128
    prefixes = torch.as_tensor(hd_lengths, device=device)
    positions = torch.arange(t, device=device).expand(n, t)
    prefix_lm = make_prefix_lm_bias(positions, torch.ones((n, t), dtype=torch.bool, device=device),
                                    prefixes, t)  # [4, 1, T, T]
    masked = prefix_lm.clone()
    dead_rows = ((0, t // 20, torch.finfo(torch.float32).min), (1, t // 4, -1e38),
                 (2, t // 2, -2e30), (3, t - 1, torch.finfo(torch.float32).min))
    for i, r, value in dead_rows:
        masked[i, 0, r] = value
    q, k, v = (bf16((n, t, h, d), 90 + i, device) for i in range(3))
    cases = []
    for what, bias in ((f"prefix-LM + ALiBi bias [{n},{h},{t},{t}]",
                        prefix_lm + alibi_bias(h, t, device)),
                       (f"prefix-LM bias [{n},1,{t},{t}] (head-broadcast)", prefix_lm),
                       (f"prefix-LM bias [{n},1,{t},{t}] with rows below -1e30", masked)):
        dropped = bias.clone()
        dropped[..., -64:] = 0
        mask = bias.to(torch.bfloat16)
        # (sample, head, query, key) products that this bias leaves to compute
        allowed = int((bias >= -1e30).sum()) * (h // bias.shape[1])

        def check(name, out, want, dropped=dropped, bias=bias):
            err = compare_flash_fwd(name, out, want, losts={
                "the plain version with the bias's last key tile dropped":
                    k2.flash_attention_plain(q, k, v, False, dropped)[0]})
            if bias is masked:
                lse = (out[1].view(n, h, t), want[1].view(n, h, t))
                dead = all(not o[i, r].any() and bool((l[i, :, r] == torch.inf).all())
                           for o, l in zip((out[0], want[0]), lse) for i, r, _ in dead_rows)
                print(f"  {name}: rows below -1e30 (fp32 minimum, -1e38, -2e30) give o = 0 and "
                      f"lse = +inf in kernel and plain version: {dead}")
                if not dead:
                    raise AssertionError(f"{name}: a row below -1e30 is not o = 0, lse = +inf")
            return err

        cases.append(case(
            f"K2 full-bias flash q[{n},{t},{h},{d}], {what}",
            lambda q, k, v, bias=bias: k2.flash_attention(q, k, v, False, bias),
            lambda q, k, v, bias=bias: k2.flash_attention_plain(q, k, v, False, bias),
            (q, k, v), check=check,
            library=lambda mask=mask: sdpa(q, k, v, attn_mask=mask),
            work=(4 * n * t * h * d * 2 + n * h * t * 4 + bias.numel() * 4, 4 * d * allowed),
            achieved="ops"))
        del bias, dropped, mask
        torch.cuda.empty_cache()
    del q, k, v
    torch.cuda.empty_cache()
    return cases


def phase_mpt_serving(device, seed: int) -> dict:
    """Phase 20 (cell I): MPT-7B in the HD-7b geometry (`mpt_vlm_config`),
    bf16 weights and cache, random weights from the seed. `Generator`
    answers phase 6's 4 HD requests (`make_hd_requests`) with 32 greedy
    tokens: K2-bias 32 times a prefill, K3-ALiBi 32 times a decode step, K1
    23 times a tower pass, no other attention kernel. Then the dense
    `ContinuousBatcher` in G's settings (4 slots, S = 2080, chunks of 256,
    speculative_k = 4) serves 6 requests (the 4, a repeat of the 3x3, one
    cancelled after its 4th token): chunks and verify rounds through
    `sdpa` with ALiBi, K3-ALiBi 32 times a plain step; its greedy tokens
    equal the batched run's up to the first near-tie."""
    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.serve import scheduler as sched

    release_earlier_phases()
    cfg = mpt_vlm_config()
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    batch, blocks = make_hd_requests(cfg, seed)
    n, l = batch["token_ids"].shape
    longest = int(batch["lengths"].max())
    print(f"phase 20 (I): MPT-7B (d 4096, 32 heads of 128, 32 layers, vocab 50432, ALiBi) behind "
          f"{HD_PRESET}'s tower and projector, bf16 weights and cache, random weights from seed "
          f"{seed} in {time.perf_counter() - t0:.2f} s")
    print(f"  requests: {n}, grids {blocks}, crops {batch['images'].shape[0]}, spliced lengths "
          f"{batch['lengths'].tolist()}, bucket {l}")
    if longest + NEW_TOKENS > cfg.lm.max_position_embeddings:
        raise AssertionError(f"phase 20: {longest} + {NEW_TOKENS} positions exceed MPT-7B's "
                             f"max_seq_len {cfg.lm.max_position_embeddings}")
    depth = cfg.lm.num_hidden_layers
    counters = mpt_counters()
    want = {name: 0 for name in counters}
    want.update(vit_attention=tower_blocks(cfg), flash_attention_bias=depth,
                decode_attention_alibi=depth * (NEW_TOKENS - 1))
    launches = check_generation("phase 20", Generator(params, cfg), batch, cfg, want, counters)
    ref_tokens, ref_margins = plain_reference(params, cfg, batch, device, torch.bfloat16)

    reqs = paged_requests(cfg, seed)
    reqs = reqs[:4] + [reqs[0], reqs[-1]]
    batcher = sched.ContinuousBatcher(
        params, cfg, num_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ, prefill_chunk_size=256,
        speculative_k=SPEC_K, device=device)
    submitted, first_at, futs = {}, {}, []

    def on_token(i):
        def hook(tok):
            first_at.setdefault(i, time.perf_counter())
            if i == len(reqs) - 1 and len(futs[i]._tp_request.tokens) == CANCEL_AFTER:
                batcher.cancel(futs[i])
        return hook

    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    batcher.start()
    try:
        t0 = time.perf_counter()
        for i, r in enumerate(reqs):
            submitted[i] = time.perf_counter()
            futs.append(batcher.submit(r, max_new_tokens=NEW_TOKENS, on_token=on_token(i)))
        tokens = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        batcher.stop()
    served = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    st = batcher.stats
    steps, rounds = st["decode_steps"], st["verify_rounds"]
    latency = [first_at[i] - submitted[i] for i in range(len(reqs))]
    n_tok = sum(map(len, tokens))
    print(f"  ContinuousBatcher: {SPEC_SLOTS} slots, max_seq_len {SPEC_SEQ}, chunks of 256, "
          f"speculative_k {SPEC_K}; {len(reqs)} requests, lengths "
          f"{[int(r['lengths'][0]) for r in reqs]}, the last cancelled after its {CANCEL_AFTER}th "
          f"token: served in {wall:.3f} s (host clock), tokens per request "
          f"{[len(t) for t in tokens]}, {n_tok / wall:.2f} tok/s over the run; admission latency "
          f"(submit -> first token) {[round(x * 1e3, 2) for x in latency]} ms; peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"  {rounds} verify rounds emitted {st['verify_tokens']} tokens "
          f"({st['verify_tokens'] / max(rounds, 1):.3f} a round), "
          f"{st['verify_s'] / max(rounds, 1) * 1e3:.3f} ms a round; {steps} plain steps, "
          f"{st['decode_s'] / max(steps, 1) * 1e3:.3f} ms a step; launches {served}")
    want = {name: 0 for name in counters}
    # chunked admissions (sdpa) with one tower pass each; verify rounds (sdpa)
    want.update(decode_attention_alibi=depth * steps, vit_attention=tower_blocks(cfg) * len(reqs))
    if served != want:
        raise AssertionError(f"phase 20: batcher launch counts {served} != {want}")
    leftover = ([s for s in batcher.slots if s is not None], batcher.lengths.any(),
                batcher._pending, batcher.queue.qsize())
    if leftover != ([], False, None, 0):
        raise AssertionError(f"phase 20: the batcher holds state after the run: {leftover}")
    if not 0 < len(tokens[-1]) < NEW_TOKENS:
        raise AssertionError(f"phase 20: the cancelled request got {len(tokens[-1])} tokens")
    agree = [decisive_agree(f"phase 20 request {i}", tokens[i], ref_tokens[j], ref_margins[j])
             for i, j in ((0, 0), (1, 1), (2, 2), (3, 3), (4, 0))]
    print(f"  batcher tokens equal to the Generator's batched run for the first {agree} of "
          f"{NEW_TOKENS} (per request; the 5th is the repeat); reference margins at the first "
          f"difference within the band {LOGIT_BAND}")
    del params, batcher
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + served.get(k, 0) for k in counters}


def phase_mpt_parity(device, seed: int) -> None:
    """Phase 21: full widths at 2 MPT layers, phase 20's geometry: prefill
    and 4 decode steps on the card (bf16, K2-bias and K3-ALiBi) against the
    CPU (fp32, plain versions) from the same weights, both fed the CPU's
    greedy tokens, every step within LOGIT_BAND."""
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, prefill
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to

    cfg = mpt_vlm_config(n_layers=2)
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    batch, blocks = make_hd_requests(cfg, seed + 1, sizes=((672, 336), (336, 336)),
                                     text_lens=(40, 70))
    l = batch["token_ids"].shape[1]
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    sides = {"gpu": (params, cfg, device_batch(batch, torch.bfloat16, device)),
             "cpu": (params_to(params, "cpu", torch.float32), cpu_cfg,
                     device_batch(batch, torch.float32, "cpu"))}
    counters = mpt_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    state = {k: prefill(p, c, b, l + 8) for k, (p, c, b) in sides.items()}
    results = []
    for step in range(5):
        gpu_logits, cpu_logits = state["gpu"][0].float().cpu(), state["cpu"][0].float()
        results.append(band_check(f"phase 21 step {step}", gpu_logits, cpu_logits))
        if step == 4:
            break
        tok = cpu_logits.argmax(-1)
        for k, (p, c, b) in sides.items():
            state[k] = decode_step(p, c, state[k][1], tok.to(b["lengths"].device), b["lengths"],
                                   step, l)
    launches = read_counts(counters)
    if (launches["flash_attention_bias"], launches["decode_attention_alibi"]) != (2, 8):
        raise AssertionError(f"phase 21: launches on the card {launches}, expected 2 K2-bias and "
                             "8 K3-ALiBi")
    print(f"phase 21: full widths, 2 MPT layers, bf16 cache, 2 HD requests (grids {blocks}): card "
          f"bf16 (K2-bias, K3-ALiBi) vs CPU fp32 (plain versions), prefill + 4 decode steps "
          f"({time.perf_counter() - t0:.1f} s) max|dlogit| per step "
          f"{[round(r[0], 4) for r in results]} band={LOGIT_BAND}; top-1 margins "
          f"{[[round(m, 4) for m in r[1]] for r in results]}, top-1 agree "
          f"{[r[2] for r in results]}")
    del params, state, sides
    torch.cuda.empty_cache()


def phase_mpt_train(device, seed: int) -> dict:
    """Phase 22 (cell J): stage 1 of the MPT model (`mpt_vlm_config(hd=
    False)`: C's tower and projector, MPT-7B) through `Trainer.train()`,
    C's synthetic dataset, batch 4 padded to 2048, no remat (MPT has
    none), 3 steps. Checks: finite losses; tower and LM bitwise frozen;
    the projector changed after step 3; per step K1 23, K2-bias forward 32
    and K2-bias backward 32, no other attention kernel."""
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.train.step import TrainConfig
    from tokenpacker_tpu_torch.train.trainer import RunConfig, Trainer

    release_earlier_phases()
    cfg = mpt_vlm_config(hd=False)
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    frozen = {part: fingerprints(params[part]) for part in ("vision", "lm")}
    projector0 = fingerprints(params["projector"])
    torch.cuda.synchronize()
    print(f"phase 22 (J): stage 1 of MPT-7B behind TokenPacker-7b's tower and projector through "
          f"Trainer.train(), random bf16 weights from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s")
    counters = mpt_counters()
    depth = cfg.lm.num_hidden_layers
    per_step = {name: 0 for name in counters}
    per_step.update(vit_attention=tower_blocks(cfg), flash_attention_bias=depth,
                    flash_attention_bias_bwd=depth)
    records = MPT_TRAIN_BATCH * MPT_TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        tok = WordTokenizer()
        ds = SupervisedDataset(str(write_caption_dataset(root, records, seed)), tok,
                               image_folder=str(root), version="plain",
                               image_size=cfg.vision.image_size)
        rcfg = RunConfig(output_dir=str(root / "out"), per_device_batch_size=MPT_TRAIN_BATCH,
                         seq_pad_to=TRAIN_SEQ, save_steps=100, seed=seed)
        trainer = Trainer(cfg, TrainConfig(stage="pretrain", learning_rate=1e-3), rcfg, params,
                          ds, tok)
        reset_counts(counters)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    want = {k: MPT_TRAIN_STEPS * v for k, v in per_step.items()}
    print(f"  {records} records, batch {MPT_TRAIN_BATCH} padded to {TRAIN_SEQ}, no remat, "
          f"{MPT_TRAIN_STEPS} steps in {wall:.2f} s (checkpoint write included); launches "
          f"{launches}")
    if launches != want:
        raise AssertionError(f"phase 22: kernel launch counts {launches} != {want}")
    for r in trainer.history:
        print(f"  step {r['step']}: loss {r['loss']:.4f}, {r['seconds'] * 1e3:.1f} ms, "
              f"{r['valid_tokens']} valid / {r['padded_tokens']} padded tokens = "
              f"{r['valid_tokens'] / r['seconds']:.1f} / {r['padded_tokens'] / r['seconds']:.1f} "
              f"tok/s, grad_norm {r['grad_norm']:.4f}, peak {r['peak_bytes'] / 2**30:.3f} GiB")
    if not all(np.isfinite(r["loss"]) for r in trainer.history):
        raise AssertionError("phase 22: a non-finite loss")
    for part, before in frozen.items():
        if fingerprints(params[part]) != before:
            raise AssertionError(f"phase 22: the frozen {part} tensors changed")
    if fingerprints(params["projector"]) == projector0:
        raise AssertionError(f"phase 22: the projector did not change in {MPT_TRAIN_STEPS} steps")
    print(f"  frozen tower and LM bitwise unchanged; projector changed after step "
          f"{MPT_TRAIN_STEPS}")
    del params, trainer
    torch.cuda.empty_cache()
    return launches


def phase_mpt_train_parity(device, seed: int) -> None:
    """Phase 23: full widths at 2 MPT layers (phase 22's geometry), one
    stage-2 step on the card against the CPU within phase 9's bands; the
    same step with K2-bias's backward dropping the bias must fail them."""
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention_bwd

    stage2_parity("phase 23", mpt_vlm_config(n_layers=2, hd=False), device, seed, ("the bias",),
                  (flash_attention_bwd, "bias_launches"),
                  r"lm\.layers\.\d+\.attn\.(wqkv|out)\.kernel", 4)


GEMV_REL = 1e-4  # P2 and P3b: a chain's value within this of its largest |value|


def probe_gemv_check(name: str, got, want, lost) -> float:
    """A GEMV chain's value [B, 1] against its plain version's (float64):
    within GEMV_REL of the largest |value| (fp32 sums of 512 products a
    column, then a block's columns; ~1e-6 expected), which the plain
    version without its last 512-row chunk must fail. Returns the largest
    absolute error."""
    scale = want.double().abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    lost_err = (lost.double() - want.double()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= GEMV_REL * scale
    print(f"  {name}: value within {err / scale:.2e} of its largest |value| (limit {GEMV_REL}); "
          f"without the last 512-row chunk {lost_err / scale:.3f} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the chain's value differs from the plain version's")
    if not lost_err > GEMV_REL * scale:
        raise AssertionError(f"{name}: the check does not see a lost chunk")
    return err


def probe_equal(name: str, got, want, lost, what: str) -> None:
    """Checksums (or packed rows) bit-equal to the plain version's, and the
    plain version's `lost` (`what`) must differ."""
    ok, lost_equal = torch.equal(got, want), torch.equal(lost, want)
    print(f"  {name}: bit-equal to the plain version {ok}; {what} bit-equal {lost_equal} "
          f"{'OK' if ok and not lost_equal else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: differs from the plain version")
    if lost_equal:
        raise AssertionError(f"{name}: the check does not see {what}")


def phase_probes(device) -> dict:
    """Phase 24: the card probes P1-P4 (`tokenpacker_tpu_torch/probes`) at
    their scripts' geometry, each stream reading every input byte once a
    call (P1: 8 chunks of each of the copies that make 4x the L2, then as
    many chunks cycled over one copy, L2-resident, labelled; P2-P4: the 8
    layers once).
    Checksums and packed rows held bit for bit against the plain versions,
    the GEMV chains' values within GEMV_REL, each check failing a lossy
    output. Per probe: kernel, plain and library ms (`torch.sum` over the
    same view for P1 and P4, the bf16 product with the unpacked weight for
    P2 and P3b, a transpose of row pairs read as int16 for P3a), the bound (bytes), and the rate over the
    streamed bytes with its share of 3.35 TB/s."""
    from tokenpacker_tpu_torch.probes import (bitcast_pack, dma_stride, int4_ring, l2_copies,
                                              stream_dtype)

    print("phase 24: the card probes P1-P4 vs their plain versions (rates over the bytes streamed, "
          "share of 3.35 TB/s)")
    g = torch.Generator(device=device).manual_seed(SEED + 24)
    rows = {}

    def probe(name, kernel, plain, library, nbytes, flops=0.0, check=None):
        """Time kernel, plain and library; print the rate over nbytes."""
        out, want = kernel(), plain()
        err = check(name, out, want) if check else 0.0
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, iters=6, warmup=1)
        lib_ms = time_ms(library) if library else None
        b_ms, b_by = bound(nbytes, flops)
        print(f"  {name}: kernel {ms:.4f} ms -> {nbytes / ms / 1e6:.1f} GB/s "
              f"({nbytes / (ms / 1e3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), plain {plain_ms:.4f} "
              f"ms, library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by}

    # P1: contiguous against column slices, over >= 4x the L2
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    nrows, ncols, ck = dma_stride.NROWS, dma_stride.NCOLS, dma_stride.CK
    copies = l2_copies(nrows * ncols, l2)
    narrow = torch.randint(-127, 127, (copies, nrows, ncols), dtype=torch.int8, device=device,
                           generator=g)
    wide = torch.randint(-127, 127, (copies, nrows, 2 * ncols), dtype=torch.int8, device=device,
                         generator=g)
    print(f"  P1 working set: {copies} copies x [{nrows}, {ncols}] = "
          f"{copies * nrows * ncols / 1e6:.1f} MB, L2 {l2 / 1e6:.1f} MB")
    cases = []
    for what, src, off in (("contiguous [4096,11008]", narrow, 0),
                           ("column slice [*,0:11008] of [4096,22016]", wide, 0),
                           ("column slice [*,11008:] of [4096,22016]", wide, ncols)):
        # the one-copy case streams as many chunks from 45 MB, which the L2 holds
        for label, s_, reps in ((f"{copies} copies", src, (nrows // ck) * copies),
                                ("one copy, L2-resident", src[:1], (nrows // ck) * copies)):
            view = s_[:, :, off:off + ncols].view(torch.int32)
            row = probe(
                f"P1 dma_stride {what}, {label}, {reps} chunks",
                lambda s_=s_, off=off, reps=reps: dma_stride.stream(s_, off, reps),
                lambda s_=s_, off=off, reps=reps: dma_stride.stream_plain(s_, off, reps),
                lambda view=view: view.sum(), dma_stride.bytes_per_call(reps),
                check=lambda name, out, want, s_=s_, off=off, reps=reps: probe_equal(
                    name, out, want, dma_stride.stream_plain(s_, off, reps - 1),
                    "the sum without the last chunk") or 0.0)
            if label != "one copy, L2-resident":
                cases.append(row)
    rows["dma_stride"] = dict(cases[0], max_abs_err=0.0)
    del narrow, wide, view
    torch.cuda.empty_cache()

    # P2: int4 nibbles with their unpack against int8, B rows, the 8 layers once
    L, K, N, b = int4_ring.L, int4_ring.K, int4_ring.N, int4_ring.B
    x = (torch.randn((b, K), generator=g, device=device) * 0.1).to(torch.bfloat16)
    ms_by_mode = {}
    for mode in ("int8", "int4"):
        w = torch.randint(-127, 127, (L, int4_ring.source_rows(K, mode), N), dtype=torch.int8,
                          device=device, generator=g)
        dense = (int4_ring.unpack_planes(w) if mode == "int4" else w).to(torch.bfloat16)
        row = probe(
            f"P2 int4_ring {mode}: x[{b},{K}] @ {L} x [{K},{N}] from a {mode} source",
            lambda w=w, mode=mode: int4_ring.chain(x, w, L, mode),
            lambda w=w, mode=mode: int4_ring.chain_plain(x, w, L, mode),
            lambda dense=dense: torch.matmul(x, dense), w.numel() + x.numel() * 2 + b * 4,
            2.0 * b * K * N * L,
            check=lambda name, out, want, w=w, mode=mode: probe_gemv_check(
                name, out, want, int4_ring.chain_plain(
                    x[:, :-512], w[:, :w.shape[1] - int4_ring.source_rows(512, mode)], L, mode)))
        ms_by_mode[mode] = row["ms"]
        if mode == "int4":
            rows["int4_ring"] = row
        del w, dense
        torch.cuda.empty_cache()
    print(f"  P2 int4/int8 wall ratio: {ms_by_mode['int4'] / ms_by_mode['int8']:.3f} (0.5 = "
          f"perfect; >0.9 = not worth building)")

    # P3a: the row-pair packing; P3b: the chain over the packed source
    L, K, N, b = bitcast_pack.L, bitcast_pack.K, bitcast_pack.N, bitcast_pack.B
    w8 = torch.randint(-127, 127, (L, K, N), dtype=torch.int8, device=device, generator=g)
    def check_pack(name, out, want):
        swapped = w8.view(L, K // 2, 2, N).flip(2).reshape(L, K, N)
        probe_equal(name, out, want, bitcast_pack.pack_rows_plain(swapped),
                    "the packing with each pair's bytes swapped")
        probe_equal(name + " unpack_rows", bitcast_pack.unpack_rows(out), w8,
                    bitcast_pack.unpack_rows_plain(out.roll(1, dims=-2)),
                    "the unpacking of rows shifted by one")
        return 0.0

    # the library's packing: each pair of rows transposed into the last axis
    # and read as one little-endian 16-bit word (row 2r the low byte)
    def pack_library():
        pairs = w8.view(L, K // 2, 2, N).transpose(-1, -2).contiguous()
        return pairs.view(torch.int16).view(L, K // 2, N)

    probe_equal("P3a library packing", pack_library(), bitcast_pack.pack_rows_plain(w8),
                pack_library().roll(1, dims=-2), "its rows shifted by one")
    rows["bitcast_pack"] = probe(
        f"P3a bitcast_pack pack_rows int8 [{L},{K},{N}] -> u16 [{L},{K // 2},{N}]",
        lambda: bitcast_pack.pack_rows(w8), lambda: bitcast_pack.pack_rows_plain(w8),
        pack_library, 2 * w8.numel(), check=check_pack)
    wp = bitcast_pack.pack_rows(w8)
    x = (torch.randn((b, K), generator=g, device=device) * 0.1).to(torch.bfloat16)
    dense = w8[:, :, :bitcast_pack.GEMV_COLS].to(torch.bfloat16)
    outs, ms_by_mode = [], {}
    for mode, w, packed in (("int8", w8, False), ("packed", wp, True)):
        def check(name, out, want, w=w, packed=packed):
            lost = bitcast_pack.stream_plain(x[:, :-512], w[:, :w.shape[1] - 512 // (1 + packed)],
                                             L, packed)
            probe_equal(name + " checksum", out[1], want[1], lost[1],
                        "the checksum without the last chunk")
            return probe_gemv_check(name, out[0], want[0], lost[0])

        row = probe(
            f"P3b bitcast_stream {mode}: x[{b},{K}] @ {L} x [{K},{N}][:, :4096], all {N} "
            f"columns read", lambda w=w, packed=packed: bitcast_pack.stream(x, w, L, packed),
            lambda w=w, packed=packed: bitcast_pack.stream_plain(x, w, L, packed),
            lambda: torch.matmul(x, dense), w.numel() * w.element_size() + x.numel() * 2 + b * 4,
            2.0 * b * K * bitcast_pack.GEMV_COLS * L, check=check)
        outs.append(bitcast_pack.stream(x, w, L, packed))
        ms_by_mode[mode] = row["ms"]
        if packed:
            rows["bitcast_stream"] = row
    same_sum = torch.equal(outs[0][1], outs[1][1])
    value_rel = ((outs[0][0].double() - outs[1][0].double()).abs().max()
                 / outs[0][0].double().abs().max()).item()
    print(f"  P3b the two modes: checksums equal {same_sum}, values bit-equal "
          f"{torch.equal(outs[0][0], outs[1][0])} (relative {value_rel:.1e}, limit {GEMV_REL}); "
          f"packed/int8 wall ratio {ms_by_mode['packed'] / ms_by_mode['int8']:.3f} (< 1: the "
          f"packed stream is faster, worth building)")
    if not same_sum or not value_rel <= GEMV_REL:
        raise AssertionError("P3b: the int8 and packed modes disagree")
    del w8, wp, dense, outs
    torch.cuda.empty_cache()

    # P4: element types and load widths, the 8 layers once
    cases = []
    for name in stream_dtype.CASES:
        x, w = stream_dtype.make_case(name, device, g)
        L = w.shape[0]
        whole = w.view(torch.int16) if w.dtype == torch.uint16 else w
        for vector in (False, True):
            def check(label, out, want, x=x, w=w):
                probe_equal(label + " checksum", out[1], want[1],
                            stream_dtype.stream_plain(x, w, L - 1)[1],
                            "the checksum without the last layer")
                rel = ((out[0].double() - want[0].double()).abs()
                       / want[0].double().abs()).max().item()
                print(f"  {label}: value reps * N * sum(x) within {rel:.1e} (limit 1e-6)")
                if not rel <= 1e-6:
                    raise AssertionError(f"{label}: the value differs from the plain version's")
                return (out[0] - want[0]).abs().max().item()

            width = "16-byte vectors" if vector else f"{w.element_size()}-byte loads"
            cases.append(probe(
                f"P4 stream_dtype {name} [{L},{w.shape[1]},{w.shape[2]}], {width}",
                lambda x=x, w=w, vector=vector: stream_dtype.stream(x, w, L, vector),
                lambda x=x, w=w: stream_dtype.stream_plain(x, w, L), lambda whole=whole:
                whole.sum(), w.numel() * w.element_size() + x.numel() * x.element_size(),
                check=check))
        del x, w, whole
        torch.cuda.empty_cache()
    rows["stream_dtype"] = dict(cases[0], max_abs_err=max(c["max_abs_err"] for c in cases))
    return rows


def probe_counters() -> dict:
    """The counters of the kernels no serving or training path reaches: K2's
    full-bias form and the probes."""
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.probes import bitcast_pack, dma_stride, int4_ring, stream_dtype

    return {"flash_attention_full_bias": (flash_attention, "full_bias_launches"),
            "dma_stride": dma_stride.stream, "int4_ring": int4_ring.chain,
            "bitcast_pack": bitcast_pack.pack_rows, "bitcast_unpack": bitcast_pack.unpack_rows,
            "bitcast_stream": bitcast_pack.stream, "stream_dtype": stream_dtype.stream}


def device_kernels(prof):
    """(name, device ms, count) of every device-side event of a trace
    (kernels, copies); CPU ops also carry the device time they launched."""
    from torch.autograd import DeviceType

    return [(a.key, a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]


def print_families(kernels, rules, steps: int = 1, top: int = 15) -> None:
    """Device time per step, its share of the busy time and launches per
    step of each kernel family (the first rule (family, name parts) with a
    part in the kernel's name, else "other"), then the `top` kernels."""
    busy = sum(ms for _, ms, _ in kernels)
    families = {}
    for name, ms, count in kernels:
        fam = next((f for f, keys in rules if any(k in name.lower() for k in keys)), "other")
        t, c = families.get(fam, (0.0, 0))
        families[fam] = (t + ms, c + count)
    for fam, (ms, count) in sorted(families.items(), key=lambda x: -x[1][0]):
        print(f"  {fam}: {ms / steps:.4f} ms/step ({ms / busy:.3f} of busy), "
              f"{count / steps:.1f} launches/step")
    for name, ms, count in sorted(kernels, key=lambda x: -x[1])[:top]:
        print(f"    {ms / steps:9.4f} ms/step {count / steps:6.1f}/step  {name[:110]}")


def profile_train_step(device, seed: int) -> None:
    """`--profile-train`: phase 8's model, batch and step (stage 1, 8 x 2048,
    remat full), one untraced step, then torch.profiler over one step."""
    from torch.profiler import ProfilerActivity, profile

    from tokenpacker_tpu_torch.config import TokenPackerVLMConfig
    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset, collate
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step
    from tokenpacker_tpu_torch.train.trainer import device_train_batch

    cfg = TokenPackerVLMConfig()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        tok = WordTokenizer()
        ds = SupervisedDataset(str(write_caption_dataset(Path(tmp), TRAIN_BATCH, seed)), tok,
                               image_folder=tmp, version="plain", image_size=cfg.vision.image_size)
        batch = collate([ds[i] for i in range(TRAIN_BATCH)], cfg.tokens_per_view, SEP_ID,
                        NEWLINE_ID, 0, pad_to=TRAIN_SEQ)
    opt = make_optimizer(TrainConfig(stage="pretrain", learning_rate=1e-3), params)
    state = opt.init()
    step = make_train_step(cfg, opt, remat="full")
    dev = device_train_batch(batch, cfg.dtype, device)
    step(params, state, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step(params, state, dev)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels)
    print(f"profile-train: TokenPacker-7b stage 1, batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat full, "
          f"one step: host clock {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {1 - busy / wall:.3f})")
    print_families(kernels, (
        ("K2-bwd", ("flash_bwd",)), ("K2-fwd", ("flash_fwd",)), ("K1", ("vit_attention",)),
        ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
        ("cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
        ("reductions (norms, sums)", ("reduce_kernel",)),
        ("elementwise and copies", ("elementwise", "catarray", "copy_kernel", "index"))))


def exclusive_kernels(prof):
    """(name, device ms, count) of every device-side event of a trace (kernels,
    copies), each event's ms the time it adds to the device's busy span: its
    end less the later of its start and every earlier event's end. A kernel
    launched with programmatic dependent launch starts before its
    predecessor ends and counts only past that end, so the sum over the
    events is the busy time (the union of their spans), in either launch
    mode."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    out, last = {}, float("-inf")
    for start, end, name in spans:
        ms = max(0.0, end - max(start, last)) / 1e3
        last = max(last, end)
        t, c = out.get(name, (0.0, 0))
        out[name] = (t + ms, c + 1)
    return [(name, ms, count) for name, (ms, count) in out.items()]


# K4's inner kernels: the GEMV with its epilogue, the attention in either
# form and the first layer's lora_u; for a tree of the earlier design, its
# partial-sum GEMVs, epilogue kernels and row_rms
K4_FAMILIES = (
    ("K4 GEMV with epilogue", ("gemv_kernel",)), ("K4 attention T=1", ("attention_kernel",)),
    ("K4 attention T>1", ("attention_mma_kernel",)), ("K4 lora_u", ("lora_u",)),
    ("K4 GEMV partials (earlier design)", ("gemv_partial", "gemv_mma")),
    ("K4 epilogues (earlier design)", ("epilogue",)), ("K4 row_rms (earlier design)", ("row_rms",)),
    ("GEMM (cuBLAS: the LM head)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reductions (norm, argmax)", ("reduce",)), ("index (embedding)", ("index",)),
    ("elementwise and copies", ("elementwise", "copy")))


def profile_steps(label: str, run, steps: int, rules, top: int = 24) -> None:
    """`run(i)` for i < steps untraced, then the same steps under
    torch.profiler: the host clock a step both ways, the device's busy
    time a step (the union of its events' spans) and idle share of the
    traced steps, then the device time a step by kernel family
    (`exclusive_kernels`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        run(i)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = exclusive_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels) / steps
    print(f"profile: {label}, {steps} steps: host clock {untraced:.3f} ms/step untraced, "
          f"{wall:.3f} traced; device busy {busy:.3f} ms/step (idle share {1 - busy / wall:.3f})")
    print_families(kernels, rules, steps, top=top)


def profile_hd_decode(device, seed: int, batch, steps: int = 8, four_bit: bool = False) -> None:
    """`--profile`: phase 6's model and requests (B), the decode steps after
    the prefill (two warm steps first), each with K4's own launches
    (`profile_steps`); then, on the same cache, G's verify step (T = SPEC_K
    + 1: the last token and random drafts) and, with phase 3's two adapters
    on slots ad0, ad1, none and ad0, H's plain and verify steps (K4-LoRA).
    With `four_bit` (`--profile-quantized`), phase 12's: the nf4 LM and a
    bf16 cache, each step per layer with K6 and K3."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, fused_weights, prefill
    from tokenpacker_tpu_torch.io.weights import (init_vlm_on_device, quantize_lm_4bit,
                                                  quantize_lm_int8)
    from tokenpacker_tpu_torch.serve.multi_lora import SlotLora
    from tokenpacker_tpu_torch.speculative import verify_step

    cfg = preset_config(HD_PRESET)
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    params = quantize_lm_4bit(params) if four_bit else quantize_lm_int8(params)
    fused = fused_weights(params, cfg)
    dev = device_batch(batch, cfg.dtype, device)
    l = batch["token_ids"].shape[1]
    cache_dtype = None if four_bit else torch.int8
    logits, cache = prefill(params, cfg, dev, l + NEW_TOKENS, kv_cache_dtype=cache_dtype)
    tok = logits.argmax(-1)
    for step in range(2):
        logits, cache = decode_step(params, cfg, cache, tok, dev["lengths"], step, l, fused)
        tok = logits.argmax(-1)
    n = tok.shape[0]
    name = f"{HD_PRESET} {'nf4, bf16 cache' if four_bit else 'int8, int8 cache'}, B={n}, " \
           f"S={cache.k.shape[2]}"

    def plain(p, w):
        def run(i):
            decode_step(p, cfg, cache, tok, dev["lengths"], 2 + i, l, w)
        return run

    if four_bit:
        profile_steps(name + " decode", plain(params, fused), steps, (
            ("K6", ("q4_matmul", "q4_partial", "q4_epilogue")), ("K3", ("decode_attention",)),
            ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
            ("copies and casts", ("copy",)), ("reductions (norms, argmax)", ("reduce",)),
            ("index and scatter (embedding, cache writes)", ("index", "scatter")),
            ("elementwise", ("elementwise",))), top=15)
        return
    g = torch.Generator(device=device).manual_seed(seed + 44)
    drafts = torch.randint(3, cfg.lm.vocab_size, (n, SPEC_K), generator=g, device=device)
    fed = torch.cat([tok[:, None], drafts], 1)

    def verify(p, w):
        def run(i):
            verify_step(p, cfg, cache, fed, dev["lengths"], 2 + i, l, w)
        return run

    sl = SlotLora(params, cfg, random_adapters(cfg.lm, SEED + 40, LORA_SCALE), n)
    for i, slot in enumerate(LORA_SLOTS[:n]):
        sl.set_slot(i, slot)
    lp = {**params, "lm": {**params["lm"], "fd_slot_lora": sl._fd | {"sel": sl.sel}}}
    lfused = fused_weights(lp, cfg)
    for label, run in ((" decode (B)", plain(params, fused)),
                       (f" verify T={SPEC_K + 1} (G's step)", verify(params, fused)),
                       (f" decode, 2 adapters r={LORA_RANK} (H)", plain(lp, lfused)),
                       (f" verify T={SPEC_K + 1}, 2 adapters (H)", verify(lp, lfused))):
        run(0)  # warm
        profile_steps(name + label, run, steps, K4_FAMILIES)


def profile_paged_decode(device, seed: int, steps: int = 8, w8a8: bool = False) -> None:
    """`--profile-paged`: phase 10's model and pool, 8 slots at K5's phase-3
    lengths (less 10) over shuffled pages of random int8 rows; torch.profiler
    over `steps` paged decode steps after two untraced ones. With `w8a8`
    (`--profile-quantized`), phase 14's mode: every product on K7."""
    from torch.profiler import ProfilerActivity, profile

    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.paged_kv import PagedKV, paged_decode_step

    cfg = preset_config(HD_PRESET)
    params = quantize_lm_int8(init_vlm_on_device(cfg, seed=seed, device=device,
                                                 dtype=torch.bfloat16))
    n, mp = PAGED_SLOTS, PAGES_PER_SEQ
    paged = PagedKV.create(cfg.lm, 2 * n * mp + 1, PAGE_SIZE, n, mp, torch.int8, device)
    g = torch.Generator(device=device).manual_seed(seed)
    for pages in (paged.k_pages, paged.v_pages):
        pages.random_(-127, 128, generator=g)
    for scales in (paged.k_scales, paged.v_scales):
        scales.uniform_(0.001, 0.021, generator=g)
    paged.page_table.copy_((torch.randperm(n * mp, generator=g, device=device) + 1).view(n, mp))
    paged.lengths.copy_(torch.tensor(PAGED_LENGTHS, device=device) - 10)
    tok = torch.randint(3, cfg.lm.vocab_size, (n,), generator=g, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    for _ in range(2):
        logits, _ = paged_decode_step(params, cfg, paged, tok, active, w8a8)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, _ = paged_decode_step(params, cfg, paged, tok, active, w8a8)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels)
    print(f"profile-paged: {HD_PRESET} int8{', w8a8' if w8a8 else ''}, int8 pool, {n} slots, lengths "
          f"{paged.lengths.tolist()} at the end, {steps} decode steps: host clock "
          f"{wall / steps * 1e3:.3f} ms/step, device busy {busy / steps:.3f} ms/step (idle share "
          f"{1 - busy / (wall * 1e3):.3f})")
    print_families(kernels, (
        ("K5", ("paged_attention",)), ("K7", ("s8_matmul",)),
        ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
        ("casts and copies (int8 weights to bf16)", ("copy",)),
        ("reductions (norms, quantize_kv, argmax)", ("reduce",)),
        ("index and scatter (embedding, pool writes)", ("index", "scatter")),
        ("elementwise", ("elementwise",))), steps)


# -- phases 28-30: checkpoints, the public API and MPT's quantized forms --------

# the reference's 7B checkpoints ship as pytorch_model-0000k-of-0000n.bin
# shards of at most ~10 GB (HF's default max_shard_size)
CKPT_SHARD_BYTES = 10 * 10**9
CKPT_DIR = Path(__file__).resolve().parent / "_checkpoints"  # gitignored


def trees_equal(name: str, got, want, path: str = "") -> int:
    """Every tensor of `got` bit-equal to `want`'s, with the same keys,
    dtypes and shapes (a None leaf counts as absent). Returns the number of
    tensors compared; raises at the first difference."""
    if isinstance(want, dict):
        keys = {k for k, v in want.items() if v is not None}
        got_keys = {k for k, v in got.items() if v is not None}
        if keys != got_keys:
            raise AssertionError(f"{name}: {path} has keys {sorted(got_keys)}, expected "
                                 f"{sorted(keys)}")
        return sum(trees_equal(name, got[k], want[k], f"{path}.{k}") for k in sorted(keys))
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {path} has {len(got)} entries, expected {len(want)}")
        return sum(trees_equal(name, g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got,
                                                                                         want)))
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: {path} differs ({got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)})")
    return 1


def lm_copy(params) -> dict:
    """The params with a new LM dict and layer list (the layer dicts and
    every tensor shared), so that `quantize_lm_*` of the copy, which works
    in place, leaves `params` as it is."""
    lm = params["lm"]
    return {**params, "lm": {**lm, "layers": list(lm["layers"])}}


class PeakRss:
    """The process's peak resident set while the block runs (a thread reads
    /proc/self/status every 10 ms), and the resident set before it."""

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self):
        import threading

        self.before = self.peak = self.rss()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, self.rss())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


def checkpoint_place(need: int) -> tuple[Path, int]:
    """Where to write a checkpoint of `need` bytes: the checkout's
    `_checkpoints` directory, or the temporary directory if only that one
    has room; returns it and its free bytes (the larger where neither has
    room, for the caller to cut the depth)."""
    import shutil

    CKPT_DIR.mkdir(exist_ok=True)
    places = [(CKPT_DIR, shutil.disk_usage(CKPT_DIR).free),
              (Path(tempfile.gettempdir()), shutil.disk_usage(tempfile.gettempdir()).free)]
    print(f"  free disk: {', '.join(f'{p} {free / 1e9:.1f} GB' for p, free in places)}; "
          f"the checkpoint needs {need / 1e9:.2f} GB")
    for place, free in places:
        if free > 1.2 * need:
            return place, free
    return max(places, key=lambda x: x[1])


def write_hf_checkpoint(path: Path, params, cfg) -> dict:
    """The reference's layout from the port's params: `export_vlm_state_dict`
    (fp32 numpy, as the JAX package writes it) cast to bf16 (exact for bf16
    weights), as `pytorch_model-0000k-of-0000n.bin` shards of at most
    CKPT_SHARD_BYTES with HF's index file, and `config.json` from
    `to_hf_dict()`. Returns the bytes and seconds of the export, the cast
    and the writes."""
    from tokenpacker_tpu_torch.io.hf_export import export_vlm_state_dict

    path.mkdir(parents=True)
    t0 = time.perf_counter()
    sd = export_vlm_state_dict(params, cfg)
    t1 = time.perf_counter()
    groups, size = [[]], 0
    for k, v in sd.items():
        if size + v.size * 2 > CKPT_SHARD_BYTES and groups[-1]:
            groups.append([])
            size = 0
        groups[-1].append(k)
        size += v.size * 2
    total, write_s, weight_map = 0, 0.0, {}
    cast_s = 0.0
    for i, keys in enumerate(groups):
        name = f"pytorch_model-{i + 1:05d}-of-{len(groups):05d}.bin"
        t = time.perf_counter()
        shard = {k: torch.from_numpy(sd.pop(k)).to(torch.bfloat16) for k in keys}
        cast_s += time.perf_counter() - t
        t = time.perf_counter()
        torch.save(shard, path / name)
        write_s += time.perf_counter() - t
        total += sum(x.numel() * 2 for x in shard.values())
        weight_map.update({k: name for k in keys})
        del shard
    (path / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict(), indent=2))
    return {"bytes": total, "shards": len(groups), "export_s": t1 - t0, "cast_s": cast_s,
            "write_s": write_s}


@contextlib.contextmanager
def api_stand_ins():
    """`api._load_tokenizer` replaced by the word tokenizer (no tokenizer
    is loaded, and the card's machine has no `transformers`), HF set
    offline; restored after."""
    import os

    from tokenpacker_tpu_torch import api

    offline = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}
    real, saved = api._load_tokenizer, {k: os.environ.get(k) for k in offline}
    api._load_tokenizer = lambda path: WordTokenizer()
    os.environ.update(offline)
    try:
        yield api
    finally:
        api._load_tokenizer = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_phase28_checkpoint(device, seed: int) -> dict:
    """Phase 28's write: TokenPacker-HD-7b's weights from phase 6's seed in
    the reference's layout (bf16 shards and config.json) under a new
    temporary directory `root`, the LM's depth cut only where no disk holds
    it. Returns {"root", "path", "cfg", "params" (the bf16 weights on the
    card), "write" (`write_hf_checkpoint`'s figures)}."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes

    release_earlier_phases()
    cfg = preset_config(HD_PRESET)
    lc = cfg.lm
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    need = tree_bytes(params)
    per_layer = tree_bytes(params["lm"]["layers"][0])
    place, free = checkpoint_place(need)
    depth = lc.num_hidden_layers
    if free < 1.2 * need:  # cut the depth, never a width
        depth = int((free / 1.2 - (need - depth * per_layer)) // per_layer)
        if depth < 1:
            raise AssertionError(f"phase 28: {free / 1e9:.1f} GB free cannot hold one layer")
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(lc, num_hidden_layers=depth))
        del params["lm"]["layers"][depth:]
        torch.cuda.empty_cache()
    cut = "" if depth == lc.num_hidden_layers else f" (LM depth cut to {depth}: disk)"
    root = Path(tempfile.mkdtemp(prefix="phase28_", dir=place))
    path = root / "tokenpacker-hd-7b-9patch-144token"
    try:
        w = write_hf_checkpoint(path, params, cfg)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    print(f"phase 28: {HD_PRESET}{cut}, random weights from seed {seed} written in the "
          f"reference's layout to {path}: {w['bytes'] / 1e9:.3f} GB in {w['shards']} bf16 "
          f"shards; export (fp32 numpy) {w['export_s']:.2f} s, cast {w['cast_s']:.2f} s, "
          f"write {w['write_s']:.2f} s = {w['bytes'] / w['write_s'] / 1e9:.2f} GB/s")
    return {"root": root, "path": path, "cfg": cfg, "params": params, "write": w}


def phase_checkpoint_load(device, seed: int, batch, blocks, ckpt: dict | None = None) -> dict:
    """Phase 28: TokenPacker-HD-7b's weights from phase 6's seed, written in
    the reference's layout (bf16 shards and config.json), loaded through
    `api.load_pretrained_model(dir, load_8bit=True)` and again with
    `load_4bit=True` (nf4): every leaf bit-equal to `quantize_lm_int8` /
    `quantize_lm_4bit` of the weights in memory, phase 6's 4 HD requests
    with 32 greedy tokens equal to a `Generator` over those (one K4 call a
    decode step with load_8bit; with load_4bit K6 for every decode
    product and K3 for the attention). Prints the write's and each load's
    seconds and GB/s, the host's peak resident set and the card's peak
    memory over each load. Where the disk cannot hold the checkpoint, the
    LM's depth is cut (never its widths) and the line says so. `ckpt`:
    what `write_phase28_checkpoint` returned (phase 31 serves the same
    directory, and its caller deletes it); None writes one here and
    deletes it at the end."""
    import shutil

    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.io.weights import quantize_lm_4bit, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    own = ckpt is None  # a checkpoint written here is deleted here
    ckpt = ckpt or write_phase28_checkpoint(device, seed)
    params, cfg, path, w = ckpt["params"], ckpt["cfg"], ckpt["path"], ckpt["write"]
    ckpt["params"] = None  # this phase frees them when it ends
    runs = []
    try:
        depth = cfg.lm.num_hidden_layers
        forms = (("load_8bit", dict(load_8bit=True), quantize_lm_int8,
                  {"decode_attention": 0, "fused_decode": NEW_TOKENS - 1, "q4_matmul": 0}),
                 ("load_4bit nf4", dict(load_4bit=True), lambda p: quantize_lm_4bit(p, "nf4"),
                  {"decode_attention": depth * (NEW_TOKENS - 1), "fused_decode": 0,
                   "q4_matmul": (4 * depth + 1) * (NEW_TOKENS - 1) + 1}))
        counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                    "decode_attention": decode_attention, "fused_decode": fused_decode_hidden,
                    "q4_matmul": q4_matmul}
        for label, flags, quantize, want in forms:
            with api_stand_ins() as api:
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with PeakRss() as rss:
                    t0 = time.perf_counter()
                    tokenizer, model, _, context_len = api.load_pretrained_model(str(path),
                                                                                 **flags)
                    torch.cuda.synchronize()
                    load_s = time.perf_counter() - t0
            card_peak = torch.cuda.max_memory_allocated() - resident
            loaded = model.params
            ref = quantize(lm_copy(params))
            leaves = trees_equal(f"phase 28 {label}", loaded, ref)
            if model.cfg.to_hf_dict() != cfg.to_hf_dict() or context_len != cfg.model_max_length:
                raise AssertionError(f"phase 28 {label}: the loaded config differs")
            print(f"  {label}: load_pretrained_model in {load_s:.2f} s "
                  f"({w['bytes'] / load_s / 1e9:.2f} GB/s of checkpoint), host resident set "
                  f"{rss.before / 2**30:.2f} -> peak {rss.peak / 2**30:.2f} GiB, card peak "
                  f"{card_peak / 2**30:.3f} GiB over the {resident / 2**30:.3f} GiB held before; "
                  f"{leaves} tensors bit-equal to the in-memory weights "
                  f"{'quantized' if flags else ''} ({tree_bytes(loaded['lm']) / 2**30:.3f} GiB "
                  f"LM)")
            got_tokens, want_tokens = [], []
            run = check_generation(f"phase 28 {label}", model.generator, batch, model.cfg,
                                   {"vit_attention": tower_blocks(cfg), "flash_attention": depth,
                                    **want}, counters, got_tokens)
            ref_gen = Generator(ref, model.cfg, tokenizer)
            reset_counts(counters)
            want_tokens = ref_gen.generate(batch, max_new_tokens=NEW_TOKENS).sequences
            if got_tokens[0] != want_tokens:
                raise AssertionError(f"phase 28 {label}: the loaded model's tokens differ from "
                                     "the in-memory weights'")
            print(f"  {label}: 4 HD requests (grids {blocks}), {NEW_TOKENS} greedy tokens equal "
                  f"to a Generator over the in-memory weights, first request "
                  f"{got_tokens[0][0][:8]}...")
            runs.append(run)
            del model, loaded, ref, ref_gen, tokenizer
            release_earlier_phases()
    finally:
        if own:
            shutil.rmtree(ckpt["root"], ignore_errors=True)
    del params
    release_earlier_phases()
    return {k: sum(r.get(k, 0) for r in runs) for k in counters}


def phase_checkpoint_layouts(device, seed: int) -> dict:
    """Phase 29: TokenPacker-HD-7b at full width and 2 LM layers, random
    bf16 weights from the seed, in the other layouts and through the tools.
    A stage-1 delta (an LM-only base, `mm_projector.bin`, the tower in its
    own directory through TOKENPACKER_CLIP_PATH) loads bit-equal to the
    weights; a rank-16 LoRA adapter over all seven targets with a
    projector (`write_peft`) merges into the full checkpoint, every target
    within one bf16 step of W + (alpha / r) B A (fp32) and every other leaf
    bit-equal, the projector the adapter's; `surgery`'s
    extract-mm-projector writes the projector's tensors, merge-lora and
    consolidate write checkpoints that load back bit-equal to the LoRA load
    and to the weights. Then `serve/cli.main --load-8bit` on the full
    checkpoint chats two turns at temperature 0 through a patched `input`
    (the word tokenizer in place of `_load_tokenizer`): each printed
    answer equals `generate_stream`'s text for the same prompt."""
    import os
    import shutil

    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.io import surgery
    from tokenpacker_tpu_torch.io.hf_export import export_vlm_state_dict, to_torch_state_dict
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes

    release_earlier_phases()
    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    sd = to_torch_state_dict(export_vlm_state_dict(params, cfg), torch.bfloat16)
    tower = "model.vision_tower.vision_tower."
    # the full checkpoint, its LM, its tower, a consolidated copy and the
    # fp32 merge: about six times the weights
    root = Path(tempfile.mkdtemp(prefix="phase29_",
                                 dir=checkpoint_place(6 * tree_bytes(params))[0]))
    t0 = time.perf_counter()
    try:
        def write(name: str, tensors: dict, file: str = "pytorch_model.bin",
                  config: bool = True) -> str:
            d = root / name
            d.mkdir(exist_ok=True)
            torch.save(tensors, d / file)
            if config:
                (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
            return str(d)

        full_dir = write("tokenpacker-hd-7b-2layers", sd)
        clip_dir = write("clip", {k[len(tower):]: v for k, v in sd.items()
                                  if k.startswith(tower)}, config=False)
        base_dir = write("base", {k: v for k, v in sd.items()
                                  if not k.startswith((tower, "model.mm_projector."))})
        delta_dir = write("stage1", {k: v for k, v in sd.items()
                                     if k.startswith("model.mm_projector.")}, "mm_projector.bin")
        adapter = random_adapters(cfg.lm, seed + 29, LORA_SERVE_SCALE, names=("ad",))["ad"]
        adapter_projector = init_vlm_on_device(cfg, seed=seed + 29, device=device,
                                               dtype=torch.bfloat16)["projector"]
        lora_dir = root / "lora"
        write_peft(lora_dir, adapter, adapter_projector)
        (lora_dir / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
        checked = {}
        with api_stand_ins() as api:
            os.environ["TOKENPACKER_CLIP_PATH"] = clip_dir
            delta = api.load_pretrained_model(delta_dir, base_dir)[1].params
            del os.environ["TOKENPACKER_CLIP_PATH"]
            checked["stage-1 delta"] = trees_equal("phase 29 stage-1 delta", delta, params)
            del delta
            lora = api.load_pretrained_model(str(lora_dir), full_dir)[1].params
            worst, moved = lora_merge_steps(lora, params, lora_dir, device)
            # lora_merge_steps put the base's tensors in the targets' place:
            # the rest must be the base's weights and the adapter's projector
            checked["LoRA"] = trees_equal("phase 29 LoRA", lora,
                                          {**params, "projector": adapter_projector})
            del lora
            extracted = root / "mm_projector.bin"
            surgery.extract_mm_projector(full_dir, str(extracted))
            checked["extract-mm-projector"] = trees_equal(
                "phase 29 extract-mm-projector", torch.load(extracted, weights_only=True),
                {k: v for k, v in sd.items() if k.startswith("model.mm_projector.")})
            surgery.merge_lora(str(lora_dir), full_dir, str(root / "merged"))
            merged = api.load_pretrained_model(str(root / "merged"))[1].params
            fresh = api.load_pretrained_model(str(lora_dir), full_dir)[1].params
            checked["merge-lora"] = trees_equal("phase 29 merge-lora", merged, fresh)
            del merged, fresh
            surgery.consolidate(full_dir, str(root / "consolidated"))
            cons = api.load_pretrained_model(str(root / "consolidated"))[1].params
            checked["consolidate"] = trees_equal("phase 29 consolidate", cons, params)
            del cons
        print(f"phase 29: {HD_PRESET} at 2 LM layers, full widths, bf16 weights from seed {seed}: "
              f"tensors bit-equal per layout and tool {checked}; LoRA targets within "
              f"{worst:.3f} bf16 steps of W + (alpha / r) B A (moved up to {moved:.4f} from the "
              f"base) ({time.perf_counter() - t0:.1f} s)")
        return cli_two_turns(device, root, full_dir, cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del params
        release_earlier_phases()


def lora_merge_steps(lora, params, lora_dir: Path, device) -> tuple[float, float]:
    """Phase 29's LoRA targets: how many bf16 steps (units in the last place
    of bf16 at the value) each loaded kernel lies from W + (alpha / r) B A
    computed in fp32 on the card from the adapter's file and the base
    weights, the worst one (0.5 is the rounding of an exact merge; the
    loader's fp32 sums on the host may round to the other neighbour); and
    the most any target moved from its base. Puts the base's tensor in
    each target's place in `lora`, for the caller's comparison of the
    rest."""
    from tokenpacker_tpu_torch.serve.multi_lora import _TORCH_NAMES

    lora_sd = torch.load(lora_dir / "adapter_model.bin", weights_only=True)
    worst, moved = 0.0, 0.0
    for i, layer in enumerate(lora["lm"]["layers"]):
        for torch_name, (part, leaf) in _TORCH_NAMES.items():
            key = f"base_model.model.model.layers.{i}.{torch_name}"
            a = lora_sd[f"{key}.lora_A.weight"].to(device).float()
            b = lora_sd[f"{key}.lora_B.weight"].to(device).float()
            base = params["lm"]["layers"][i][part][leaf]["kernel"]
            want = base.float() + (LORA_ALPHA / LORA_RANK) * (b @ a).t()
            got = layer[part][leaf]["kernel"].float()
            ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
            steps = (got - want).abs() / ulp.clamp_min(2.0**-133)
            worst = max(worst, steps.max().item())
            moved = max(moved, (got - base.float()).abs().max().item())
            layer[part][leaf]["kernel"] = base
    if worst > 1.0:
        raise AssertionError(f"phase 29: a merged LoRA target lies {worst:.3f} bf16 steps from "
                             "W + (alpha / r) B A")
    if moved == 0.0:
        raise AssertionError("phase 29: the LoRA merge left the targets as they were")
    return worst, moved


def cli_two_turns(device, root: Path, model_dir: str, cfg) -> dict:
    """Phase 29's chat: `serve/cli.main` with --load-8bit on `model_dir`,
    temperature 0, 16 new tokens, two turns through a patched `input`;
    each printed answer must equal the text `generate_stream` gives on the
    model it loaded for the prompt the llava_v1 template makes (the image
    in the first turn, the first answer in the second's history). Returns
    the launches of the chat."""
    import builtins
    import io

    from PIL import Image

    from tokenpacker_tpu_torch.data.conversation import conv_templates
    from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token
    from tokenpacker_tpu_torch.generate import pick_bucket
    from tokenpacker_tpu_torch.image.processing import process_image
    from tokenpacker_tpu_torch.models.splice import build_splice_plan
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.serve import cli

    rng = np.random.default_rng(SEED + 29)
    image = root / "image.png"
    Image.fromarray(rng.integers(0, 256, (448, 672, 3), dtype=np.uint8)).save(image)
    turns = ["describe the image", "and what else"]
    fed = iter(turns)
    new = 16

    def fake_input(prompt):
        print(prompt, end="")
        try:
            return next(fed)
        except StopIteration:
            raise EOFError from None

    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_decode": fused_decode_hidden}
    loaded = {}
    with api_stand_ins() as api:
        real_load, real_input = api.load_pretrained_model, builtins.input

        def load(*args, **kw):
            loaded["out"] = real_load(*args, **kw)
            return loaded["out"]

        api.load_pretrained_model, builtins.input = load, fake_input
        out = io.StringIO()
        reset_counts(counters)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main(["--model-path", model_dir, "--image-file", str(image), "--load-8bit",
                          "--temperature", "0", "--max-new-tokens", str(new)])
            torch.cuda.synchronize()
        finally:
            api.load_pretrained_model, builtins.input = real_load, real_input
    launches = read_counts(counters)
    seconds = time.perf_counter() - t0
    tok, model, _, _ = loaded["out"]
    mc = model.cfg
    crops, hb, wb = process_image(Image.open(image).convert("RGB"), mc.image_aspect_ratio,
                                  mc.patch_num, mc.vision.image_size)
    conv = conv_templates["llava_v1"].copy()
    answers = []
    for i, text in enumerate(turns):
        conv.append_message(conv.roles[0], ("<image>\n" if i == 0 else "") + text)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tok), np.int64)
        args = ([ids], [[(hb, wb)]], mc.tokens_per_view, "slice", tok.convert_tokens_to_ids(","),
                tok.convert_tokens_to_ids("\n"), tok.pad_token_id)
        plan = build_splice_plan(*args)
        plan = build_splice_plan(*args, pad_to=pick_bucket(int(plan.lengths[0])))
        batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
                 "image_slot": plan.image_slot, "lengths": plan.lengths,
                 "images": crops.transpose(0, 2, 3, 1)}
        texts = list(model.generator.generate_stream(batch, max_new_tokens=new,
                                                     stop_strings=(conv.sep2,)))
        answers.append(texts[-1] if texts else "")
        conv.messages[-1][-1] = answers[-1]
    printed = out.getvalue().split("USER: ")
    if len(printed) != 4 or printed[-1] != "":
        raise AssertionError(f"phase 29: the chat printed {out.getvalue()!r}")
    for line, answer in zip(printed[1:3], answers):
        if not line.startswith(f"ASSISTANT: {answer}\n[turn took "):
            raise AssertionError(f"phase 29: the chat printed {line!r}, generate_stream gave "
                                 f"{answer!r}")
    print(f"  serve/cli.main --load-8bit ({hb}x{wb} grid, 2 turns, {new} tokens a turn, "
          f"{seconds:.2f} s with the load): the printed answers equal generate_stream's texts "
          f"{[a[:40] for a in answers]}; launches {launches}")
    if launches["fused_decode"] == 0 or launches["decode_attention"] != 0:
        raise AssertionError(f"phase 29: the chat's decode steps are not on K4: {launches}")
    del model, loaded
    return launches


@contextlib.contextmanager
def lossy_quantized_products():
    """Within the block, every product of MPT's layers over a quantized
    kernel (4-bit, int8 weight-only or w8a8, whatever its route) loses
    the last 128 rows of K: phase 30 shows that each of its bands fails
    that."""
    from tokenpacker_tpu_torch.models import mpt

    real = mpt.linear

    def lossy(params, x, w8a8=False):
        if isinstance(params["kernel"], dict):
            x = x.clone()
            x[..., -128:] = 0
        return real(params, x, w8a8)

    mpt.linear = lossy
    try:
        yield
    finally:
        mpt.linear = real


def phase_mpt_quantized(device, seed: int) -> dict:
    """Phase 30: MPT's quantized forms. MPT-7B behind the HD-7b tower
    (`mpt_vlm_config`) with its LM from `quantize_lm_4bit` (nf4; `wte`
    stays dense) answers phase 6's 4 HD requests with 32 greedy tokens: K6
    four times a layer a decode step (wqkv, out, up, down; the tied logits
    are a dense product), K3-ALiBi once a layer a step, K2-bias once a
    layer at the prefill (whose products, of more than 32 rows, take the
    dequantized weight); checks as in phase 4. Then card against CPU at
    full width and 2 layers, prefill and 4 decode steps fed the CPU's
    tokens, for the nf4, the int8 weight-only and the w8a8 forms, in the
    bands of phases 13, 7 (LOGIT_BAND) and 15 (W8A8_LOGIT_BAND); each band
    must fail the same card run with every quantized product losing the
    last 128 rows of K."""
    from tokenpacker_tpu_torch.generate import Generator, decode_step, device_batch, prefill
    from tokenpacker_tpu_torch.io.weights import (
        init_vlm_on_device,
        params_to,
        quantize_lm_4bit,
        quantize_lm_int8,
    )
    from tokenpacker_tpu_torch.ops.q4_matmul import q4_matmul
    from tokenpacker_tpu_torch.ops.q8_matmul import s8_matmul
    from tokenpacker_tpu_torch.ops.quantize import tree_bytes
    from tokenpacker_tpu_torch.ops.s8_gemm import s8_gemm

    release_earlier_phases()
    cfg = mpt_vlm_config()
    t0 = time.perf_counter()
    params = init_vlm_on_device(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    bf16_lm = tree_bytes(params["lm"])
    quantize_lm_4bit(params, "nf4")
    torch.cuda.synchronize()
    batch, blocks = make_hd_requests(cfg, seed)
    n, l = batch["token_ids"].shape
    print(f"phase 30: MPT-7B behind {HD_PRESET}'s tower and projector, random weights from seed "
          f"{seed}, LM quantized to nf4 on the card ({bf16_lm / 2**30:.3f} -> "
          f"{tree_bytes(params['lm']) / 2**30:.3f} GiB, wte dense) in "
          f"{time.perf_counter() - t0:.2f} s; bf16 cache; {n} requests, grids {blocks}, bucket {l}")
    depth = cfg.lm.num_hidden_layers
    counters = {**mpt_counters(), "q4_matmul": q4_matmul, "s8_matmul": s8_matmul,
                "s8_gemm": s8_gemm}
    want = {name: 0 for name in counters}
    want.update(vit_attention=tower_blocks(cfg), flash_attention_bias=depth,
                decode_attention_alibi=depth * (NEW_TOKENS - 1),
                q4_matmul=4 * depth * (NEW_TOKENS - 1))
    gen = Generator(params, cfg)
    if gen.fused is not False:
        raise AssertionError("phase 30: an MPT tree must decode per layer")
    launches = check_generation("phase 30", gen, batch, cfg, want, counters)
    del params, gen
    release_earlier_phases()

    cfg2 = mpt_vlm_config(n_layers=2)
    cpu_cfg = dataclasses.replace(cfg2, dtype=torch.float32)
    batch, blocks = make_hd_requests(cfg2, seed + 1, sizes=((672, 336), (336, 336)),
                                     text_lens=(40, 70))
    l = batch["token_ids"].shape[1]
    steps = 4
    # K6 / K7 a decode step: four products a layer; the prefill's (2 x l rows)
    # take the dequantized weight (4-bit) or K8 (w8a8, 2 x l >= 256)
    forms = (("nf4", lambda p: quantize_lm_4bit(p, "nf4"), False, LOGIT_BAND,
              {"q4_matmul": steps * 4 * 2, "s8_matmul": 0, "s8_gemm": 0}),
             ("int8 weight-only", quantize_lm_int8, False, LOGIT_BAND,
              {"q4_matmul": 0, "s8_matmul": 0, "s8_gemm": 0}),
             ("w8a8", quantize_lm_int8, True, W8A8_LOGIT_BAND,
              {"q4_matmul": 0, "s8_matmul": steps * 4 * 2, "s8_gemm": 4 * 2}))
    kernels = {"q4_matmul": q4_matmul, "s8_matmul": s8_matmul, "s8_gemm": s8_gemm}
    for label, quantize, w8a8, band, want in forms:
        params = quantize(init_vlm_on_device(cfg2, seed=seed, device=device,
                                             dtype=torch.bfloat16))
        cpu_params = params_to(params, "cpu", torch.float32)
        t0 = time.perf_counter()

        def run(p, c, dev, tokens=None):
            """Prefill and `steps` decode steps; returns the logits of each and
            the tokens fed (the argmax of this run's logits unless given)."""
            b = device_batch(batch, c.dtype, dev)
            logits, cache = prefill(p, c, b, l + steps, w8a8=w8a8)
            out, fed = [logits.float().cpu()], []
            for step in range(steps):
                tok = tokens[step] if tokens is not None else out[-1].argmax(-1)
                fed.append(tok)
                logits, cache = decode_step(p, c, cache, tok.to(dev), b["lengths"], step, l,
                                            w8a8=w8a8)
                out.append(logits.float().cpu())
            return out, fed

        cpu_logits, fed = run(cpu_params, cpu_cfg, "cpu")
        reset_counts(kernels)
        gpu_logits, _ = run(params, cfg2, device, fed)
        got = read_counts(kernels)
        results = [band_check(f"phase 30 {label} step {i}", g, c, band)
                   for i, (g, c) in enumerate(zip(gpu_logits, cpu_logits))]
        with lossy_quantized_products():
            lost_logits, _ = run(params, cfg2, device, fed)
        lost = max((g - c).abs().max().item() for g, c in zip(lost_logits, cpu_logits))
        print(f"  {label}: full widths, 2 MPT layers, 2 HD requests (grids {blocks}): card bf16 "
              f"vs CPU fp32, prefill + {steps} decode steps ({time.perf_counter() - t0:.1f} s) "
              f"max|dlogit| per step {[round(r[0], 4) for r in results]} band={band}; top-1 "
              f"agree {[r[2] for r in results]}; launches {got}; with every quantized product "
              f"losing the last 128 rows of K max|dlogit| {lost:.4f}")
        if got != want:
            raise AssertionError(f"phase 30 {label}: launches {got} != {want}")
        if not lost > band:
            raise AssertionError(f"phase 30 {label}: the band does not see products losing rows")
        del params, cpu_params
        release_earlier_phases()
    return launches


SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK = 4, 2048, 256  # phase 31's paged worker
SERVE_TEXTS = ("Describe this image in detail.", "What objects can you see here?",
               "Write a short story about this picture.", "What colors dominate the scene?")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def serve_http(handler, port: int | None = None):
    """A ThreadingHTTPServer on localhost in a daemon thread: (base URL,
    server); `stop_http` ends it."""
    import threading
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("localhost", port or free_port()), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://localhost:{server.server_address[1]}", server


def stop_http(server) -> None:
    server.shutdown()
    server.server_close()


def http_call(url: str, body=None, stream: bool = False, timeout: float = 600) -> dict:
    """POST `body` (GET without one): {"status", "json"} or, streamed,
    {"status", "events", "times"} (each SSE event and its arrival on the
    host clock, None for [DONE]); "sent" is when the request went out."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    sent = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not stream:
            raw = resp.read()
            try:
                return {"status": resp.status, "sent": sent, "json": json.loads(raw)}
            except json.JSONDecodeError:
                return {"status": resp.status, "sent": sent, "text": raw.decode()}
        events, times = [], []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                times.append(time.perf_counter())
                payload = line[len(b"data: "):].strip()
                events.append(None if payload == b"[DONE]" else json.loads(payload))
        return {"status": resp.status, "sent": sent, "events": events, "times": times}


def metric_values(text: str) -> dict:
    """{series: value} of a /metrics scrape."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def hd_images_b64(seed: int) -> list[str]:
    """Phase 6's 4 HD images (`make_hd_requests`' draws) as base64 PNG."""
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for w, h in HD_SIZES:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
        out.append(base64.b64encode(buf.getvalue()).decode())
    return out


def chat_body(text: str, image: str, **kw) -> dict:
    return {"model": HD_PRESET, "max_tokens": NEW_TOKENS, "temperature": 0.0,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": text},
                {"type": "image_url", "image_url": {"url": "data:image/png;base64," + image}}]}],
            **kw}


def wire_tee(worker, wire: list) -> None:
    """Record every request the worker streams: (its params, its chunks
    as parsed JSON), appended when the stream ends."""
    gate = worker.generate_stream_gate

    def tee(params):
        chunks, it = [], gate(params)
        try:
            for c in it:
                chunks.append(json.loads(c[:-1]))
                yield c
        finally:
            it.close()
            wire.append((params, chunks))

    worker.generate_stream_gate = tee


def wire_ids(chunks: list) -> list:
    """A stream's token ids, from its logprob entries' `id`."""
    return [e["id"] for c in chunks for e in c.get("logprobs", [])]


def check_stream(name: str, worker, params: dict, chunks: list, n_ids: int | None = None) -> dict:
    """Every chunk error_code 0; the final chunk's usage (prompt_tokens the
    spliced length, completion_tokens the tokens streamed) and
    finish_reason ("length" at the cap, else "stop") right. Returns the
    final chunk."""
    if not chunks or any(c.get("error_code") != 0 for c in chunks):
        raise AssertionError(f"phase 31 {name}: an error chunk or no chunk: {chunks[-1:]}")
    final = chunks[-1]
    _, spliced = worker.plan(params["prompt"], params.get("images"))
    n = len(chunks) - 1 if n_ids is None else n_ids
    usage = {"prompt_tokens": spliced, "completion_tokens": n, "total_tokens": spliced + n}
    finish = "length" if n == params["max_new_tokens"] else "stop"
    if final.get("usage") != usage or final.get("finish_reason") != finish:
        raise AssertionError(f"phase 31 {name}: final chunk {final.get('usage')} "
                             f"{final.get('finish_reason')}, expected {usage} {finish}")
    return final


def seeded_draw_margin(row: torch.Tensor, step: int, a: int, b: int, temperature: float) -> float:
    """|z_a - z_b| of the seeded request's Gumbel-max draw at `step`
    (z = logits / temperature + the noise of seed_keys(SEED_REQ, step))."""
    from tokenpacker_tpu_torch.generate import gumbel_noise, seed_keys

    key = int(seed_keys([SEED_REQ], [step])[0])
    z = row.float().reshape(1, -1) / temperature + gumbel_noise((1, row.numel()), row.device,
                                                                None, [key])
    return abs(z[0, a] - z[0, b]).item()


def phase_serving(device, seed: int, model_dir: Path, card: str) -> dict:
    """Phase 31 (configuration P, the HTTP serving stack): the port's
    controller, `ModelWorker`, OpenAI gateway and web server on localhost
    ports in this process, over phase 28's TokenPacker-HD-7b directory.

    A paged worker (`load_8bit`, an int8 pool, 4 slots, 2,048 positions,
    chunks of 256) registers itself and beats once. Through the gateway
    go phase 6's 4 HD images as base64 PNG at once: two greedy chat
    requests (one streamed, with top_logprobs 3), one sampled at
    temperature 0.8 and top_p 0.95, one sampled at 0.8 with seed 1234;
    then the seeded one again alone; then one request straight to
    /worker_generate_stream and one chat turn through the web server
    with an image in "Pad" mode. The worker drains, and a second worker
    over the same directory (scheduler "none", speculative_k 4) takes one
    greedy request (speculative, K4-verify) and one sampled request (K4)
    through the gateway.

    Checks (every failure raises): every chunk's error_code 0; usage and
    finish_reason; ids (from the logprob entries' `id`, or the stream's
    tokens where speculation streams no entries) of each greedy request
    equal to a recorded plain run over the weights the worker loaded
    wherever its margin is decisive; the seeded request's two runs equal
    up to a draw whose Gumbel margin is within 2 LOGIT_BAND / temperature
    in both; every logprob entry within LP_BAND of log_softmax of its
    step's raw logits; the web server's frames and logs; /metrics on the
    controller and the worker counting the requests, TTFT and tokens; K1,
    K2, K4, K4-verify and K5 counted against the steps taken (K2 from the
    direct worker only). Prints the loads' and warm-ups' seconds, TTFT
    through the gateway beside submit-to-first-token on the batcher, ms a
    token at the SSE client beside the batcher's ms a step, and the
    worker's phase timings, with the card's name and power limit."""
    import threading

    from tokenpacker_tpu_torch import generate as gen_mod
    from tokenpacker_tpu_torch.serve import controller, metrics, model_worker, openai_api
    from tokenpacker_tpu_torch.serve import scheduler as sched
    from tokenpacker_tpu_torch.serve import web_server
    from tokenpacker_tpu_torch.utils.profiling import GLOBAL_STATS

    release_earlier_phases()
    counters = sampling_counters()
    images = hd_images_b64(seed)
    ctl = controller.Controller("shortest_queue")
    cbase, cserver = serve_http(controller.make_handler(ctl))
    gw = openai_api.Gateway(cbase)
    gbase, gserver = serve_http(openai_api.make_handler(gw))
    logdir = Path(tempfile.mkdtemp(prefix="phase31_logs_"))
    real_logdir, web_server.LOGDIR = web_server.LOGDIR, str(logdir)
    webbase, webserver = serve_http(web_server.make_handler(cbase))
    real_lp_rows, real_entry = sched.logprob_rows, gen_mod.token_logprob_entry
    servers = [cserver, gserver, webserver]
    runs = []
    try:
        # -- the paged worker ------------------------------------------------
        wport = free_port()
        with api_stand_ins():
            worker = model_worker.ModelWorker(
                cbase, f"http://localhost:{wport}", str(model_dir), load_8bit=True,
                scheduler="paged", scheduler_slots=SERVE_SLOTS, scheduler_max_len=SERVE_MAX_LEN,
                scheduler_prefill_chunk=SERVE_CHUNK, kv_cache_dtype=torch.int8, warmup=True)
        cfg, batcher = worker.cfg, worker.batcher
        depth = cfg.lm.num_hidden_layers
        print(f"phase 31: {card}; paged worker over {model_dir.name} (load_8bit, int8 pool of "
              f"{batcher.num_pages} pages of 64, {SERVE_SLOTS} slots): load "
              f"{worker.load_s:.2f} s, warm-up {worker.warmup_s:.2f} s")
        wbase, wserver = serve_http(model_worker.make_handler(worker), wport)
        servers.append(wserver)
        if http_call(cbase + "/list_models", {})["json"]["models"] != [HD_PRESET]:
            raise AssertionError("phase 31: the worker did not register itself")
        beats = metrics.CONTROLLER_HEARTBEATS.value()
        worker.send_heart_beat()
        if metrics.CONTROLLER_HEARTBEATS.value() != beats + 1:
            raise AssertionError("phase 31: the controller did not count the heartbeat")
        bodies = {
            "greedy": chat_body(SERVE_TEXTS[0], images[0], logprobs=True, top_logprobs=0),
            "greedy streamed": chat_body(SERVE_TEXTS[1], images[1], logprobs=True,
                                         top_logprobs=3, stream=True,
                                         stream_options={"include_usage": True}),
            "sampled": chat_body(SERVE_TEXTS[2], images[2], temperature=0.8, top_p=0.95,
                                 logprobs=True, top_logprobs=0),
            "seeded": chat_body(SERVE_TEXTS[3], images[3], temperature=0.8, seed=SEED_REQ,
                                logprobs=True, top_logprobs=0),
        }
        prompts = {k: openai_api.render_chat_prompt(HD_PRESET, b["messages"])[0]
                   for k, b in bodies.items()}
        direct_prompt = openai_api.render_chat_prompt(HD_PRESET, chat_body(
            "Is there anything unusual in this image?", images[0])["messages"])[0]
        for text in [*prompts.values(), direct_prompt]:
            worker.tokenizer(text)  # the word ids are fixed before requests run at once

        # raw logits of every logprob entry, and submit / first-token times,
        # per batcher request (keyed by its id)
        rows, timing = {}, {}
        real_seat, real_submit = batcher._seat, batcher.submit

        def seat(slot, req, logits, true_len):
            if req.logprobs is not None:
                rows.setdefault(id(req), []).append(logits[0].float().cpu())
            return real_seat(slot, req, logits, true_len)

        def lp_rows(logits, toks, n_top):
            for slot, req in enumerate(batcher.slots):
                if req is not None and req.logprobs is not None:
                    rows.setdefault(id(req), []).append(logits[slot].float().cpu())
            return real_lp_rows(logits, toks, n_top)

        def submit(batch, **kw):
            on_token, box = kw.pop("on_token"), {}

            def first(tok):
                box.setdefault("first", time.perf_counter())
                on_token(tok)

            t = time.perf_counter()
            fut = real_submit(batch, on_token=first, **kw)
            timing[id(fut._tp_request)] = (t, box, fut._tp_request)
            return fut

        batcher._seat, batcher.submit, sched.logprob_rows = seat, submit, lp_rows
        wire: list = []
        wire_tee(worker, wire)

        def request_of(chunks):
            """The batcher request behind a stream: the one whose logprob
            entries (ids and values) begin with the stream's."""
            sent = [(e["id"], e["logprob"]) for c in chunks for e in c.get("logprobs", [])]
            for _, _, r in timing.values():
                if sent and [(e["id"], e["logprob"]) for e in r.lp_entries[:len(sent)]] == sent:
                    return r
            raise AssertionError("phase 31: a stream matches no batcher request")

        scrape0 = metric_values(http_call(wbase + "/metrics")["text"])
        stats0, prefix0 = dict(batcher.stats), batcher.prefix.stats()
        GLOBAL_STATS.reset()  # the process's phase timers: this worker's requests alone
        reset_counts(counters)
        results = {}

        def call(name):
            results[name] = http_call(gbase + "/v1/chat/completions", bodies[name],
                                      stream=bodies[name].get("stream", False))

        threads = [threading.Thread(target=call, args=(k,)) for k in bodies]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        together_s = time.perf_counter() - t0
        if set(results) != set(bodies):
            raise AssertionError(f"phase 31: requests without an answer: "
                                 f"{set(bodies) - set(results)}")
        stats1 = dict(batcher.stats)
        first_seeded = results["seeded"]
        call("seeded")
        results["seeded again"], results["seeded"] = results["seeded"], first_seeded
        direct = {"prompt": direct_prompt, "images": [images[0]], "temperature": 0.0,
                  "max_new_tokens": NEW_TOKENS, "logprobs": 0}
        direct_frames = [json.loads(f) for f in http_call(
            wbase + "/worker_generate_stream", direct)["text"].split("\0") if f]
        web_body = {"model": HD_PRESET, "history": [["user", "What is in the picture?"]],
                    "image": images[1], "image_process_mode": "Pad", "temperature": 0.0,
                    "max_new_tokens": NEW_TOKENS}
        web_frames = [json.loads(f) for f in http_call(
            webbase + "/chat", web_body)["text"].split("\0") if f]
        torch.cuda.synchronize()
        launches = read_counts(counters)
        stats2, prefix2 = dict(batcher.stats), batcher.prefix.stats()
        scrape1 = metric_values(http_call(wbase + "/metrics")["text"])
        ctl_scrape = metric_values(http_call(cbase + "/metrics")["text"])
        status = http_call(wbase + "/worker_get_status", {})["json"]

        # the streams as the worker sent them, by prompt (the seeded one twice)
        by_prompt: dict = {}
        for params, chunks in wire:
            by_prompt.setdefault(params["prompt"], []).append((params, chunks))
        if len(wire) != 7:
            raise AssertionError(f"phase 31: the worker streamed {len(wire)} requests, not 7")
        finals = {}
        for name, prompt in prompts.items():
            for k, (params, chunks) in enumerate(by_prompt[prompt]):
                tag = name if k == 0 else "seeded again"
                finals[tag] = check_stream(tag, worker, params, chunks, len(wire_ids(chunks)))
        (dparams, dchunks), = by_prompt[direct_prompt]
        if dchunks != direct_frames:
            raise AssertionError("phase 31: the direct request's frames differ from its stream")
        finals["direct"] = check_stream("direct", worker, dparams, dchunks,
                                        len(wire_ids(dchunks)))
        (wparams, wchunks), = [(p, c) for p, c in wire
                               if p["prompt"] not in prompts.values() and p["prompt"] != direct_prompt]
        check_stream("web chat", worker, wparams, wchunks)
        if not web_frames or any(f.get("error_code") or f["text"].startswith(
                ("error: ", "image error: ")) for f in web_frames):
            raise AssertionError(f"phase 31: the web server answered {web_frames[-1:]}")
        logs = sorted(p.name.split("-", 3)[-1] for p in logdir.iterdir())
        if logs != ["conv.json", "images.json"]:
            raise AssertionError(f"phase 31: the web server's logs are {logs}")

        # the gateway's answers against the worker's streams
        for name, res in results.items():
            if res["status"] != 200:
                raise AssertionError(f"phase 31 {name}: gateway status {res['status']}")
            if "events" in res:
                evs = [e for e in res["events"] if e is not None]
                usage = [e["usage"] for e in evs if not e["choices"]]
                finish = [e["choices"][0]["finish_reason"] for e in evs if e["choices"]][-1]
                content = [x for e in evs if e["choices"]
                           for x in (e["choices"][0].get("logprobs") or {}).get("content", [])]
            else:
                usage = [res["json"]["usage"]]
                finish = res["json"]["choices"][0]["finish_reason"]
                content = res["json"]["choices"][0]["logprobs"]["content"]
            final = finals[name]
            if usage != [final["usage"]] or finish != final["finish_reason"]:
                raise AssertionError(f"phase 31 {name}: the gateway's usage {usage} / {finish} "
                                     f"differ from the worker's {final['usage']}")
            if len(content) != final["usage"]["completion_tokens"]:
                raise AssertionError(f"phase 31 {name}: {len(content)} logprob entries")

        # ids against the plain run over the loaded weights; logprob entries
        # against their raw logits; the seeded runs against each other
        params_loaded = worker.model.params
        greedy_agree = {}
        seeded_runs = []
        lp_worst = 0.0
        for name in ("greedy", "greedy streamed", "sampled", "seeded", "seeded again", "direct"):
            prompt = direct_prompt if name == "direct" else prompts[name.replace(" again", "")]
            runs_of = by_prompt[prompt]
            params, chunks = runs_of[1] if name == "seeded again" else runs_of[0]
            req = request_of(chunks)
            ids = wire_ids(chunks)
            entries = [x for c in chunks for x in c.get("logprobs", [])]
            n_top = {"greedy streamed": 3}.get(name, 0)
            checked = [{"id": e["id"], "logprob": e["logprob"],
                        "top": [(t[0], t[2]) for t in e.get("top", [])]} for e in entries]
            if n_top:
                lp_worst = max(lp_worst, check_logprob_entries(
                    f"phase 31 {name}", checked, rows[id(req)][:len(ids)], n_top))
            else:
                for e, row in zip(checked, rows[id(req)][:len(ids)]):
                    lp_worst = max(lp_worst, abs(e["logprob"] - torch.log_softmax(
                        row, -1)[e["id"]].item()))
            if name in ("greedy", "greedy streamed", "direct"):
                batch, _ = worker.plan(params["prompt"], params["images"])
                ref, margins = plain_reference(params_loaded, cfg, batch, device)
                greedy_agree[name] = decisive_agree(f"phase 31 {name}", ids, ref[0], margins[0])
            if name.startswith("seeded"):
                seeded_runs.append((ids, rows[id(req)][:len(ids)]))
        if lp_worst > LP_BAND:
            raise AssertionError(f"phase 31: logprob entries {lp_worst} from their logits")
        (ids_a, rows_a), (ids_b, rows_b) = seeded_runs
        seeded_agree = 0
        for j, (a, b) in enumerate(zip(ids_a, ids_b)):
            if a != b:
                margins = [seeded_draw_margin(r[j].to(device), j, a, b, 0.8)
                           for r in (rows_a, rows_b)]
                if max(margins) > 2 * LOGIT_BAND / 0.8:
                    raise AssertionError(f"phase 31: the seeded runs part at token {j} where "
                                         f"the draws' margins are {margins}")
                break
            seeded_agree += 1

        # launches against the steps
        steps = stats2["decode_steps"] - stats0["decode_steps"]
        encodes = 7 - (prefix2["prefix_vision_encodes_skipped"]
                       - prefix0["prefix_vision_encodes_skipped"])
        want = {"vit_attention": tower_blocks(cfg) * encodes, "vit_block": 0,
                "flash_attention": 0, "decode_attention": 0, "fused_decode": 0,
                "fused_verify": 0, "paged_attention": depth * steps}
        if launches != want or steps == 0:
            raise AssertionError(f"phase 31 paged worker: launches {launches} != {want}")
        runs.append(launches)

        # metrics: requests, TTFT and tokens counted
        generated = (sum(f["usage"]["completion_tokens"] for f in finals.values())
                     + wchunks[-1]["usage"]["completion_tokens"])
        dispatches = f'tokenpacker_controller_dispatches_total{{model="{HD_PRESET}"}}'
        delta = {k: scrape1.get(k, 0.0) - scrape0.get(k, 0.0) for k in (
            "tokenpacker_worker_requests_total", "tokenpacker_worker_ttft_seconds_count",
            "tokenpacker_worker_generated_tokens_total", "tokenpacker_worker_errors_total")}
        delta[dispatches] = ctl_scrape.get(dispatches, 0.0) - scrape0.get(dispatches, 0.0)
        want_delta = {"tokenpacker_worker_requests_total": 7.0,
                      "tokenpacker_worker_ttft_seconds_count": 7.0,
                      "tokenpacker_worker_generated_tokens_total": float(generated),
                      "tokenpacker_worker_errors_total": 0.0,
                      dispatches: 6.0}  # the gateway's 5 and the web server's 1
        if delta != want_delta or ctl_scrape.get("tokenpacker_controller_heartbeats_total",
                                                 0) < 1:
            raise AssertionError(f"phase 31: /metrics moved by {delta}, expected {want_delta}")

        # what the clients and the batcher saw
        sse = results["greedy streamed"]
        content_times = [t for e, t in zip(sse["events"], sse["times"])
                         if e and e["choices"] and e["choices"][0].get("logprobs")]
        stream_req = request_of(by_prompt[prompts["greedy streamed"]][0][1])
        t_submit, box, _ = timing[id(stream_req)]
        step_ms = (stats1["decode_s"] - stats0["decode_s"]) / max(
            stats1["decode_steps"] - stats0["decode_steps"], 1) * 1e3
        print(f"  {card}: 4 HD requests at once through the gateway in {together_s:.2f} s "
              f"({steps} paged steps in all, K5 {launches['paged_attention']} launches, K1 "
              f"{launches['vit_attention']} = {encodes} tower passes); streamed greedy "
              f"request: TTFT {(sse['times'][0] - sse['sent']) * 1e3:.2f} ms at the SSE client "
              f"(request sent to the first event) vs {(box['first'] - t_submit) * 1e3:.2f} ms "
              f"submit-to-first-token on the batcher; "
              f"{(content_times[-1] - content_times[0]) / max(len(content_times) - 1, 1) * 1e3:.2f}"
              f" ms a token at the SSE client vs {step_ms:.2f} ms a batcher step (4 requests)")
        print(f"  {card}: greedy ids equal to the plain run over the loaded weights for "
              f"{greedy_agree} tokens (the rest past a margin within {LOGIT_BAND}); the seeded "
              f"request's two runs agree for {seeded_agree} of {len(ids_a)} tokens; logprob "
              f"entries within {lp_worst:.2e} of their logits; usage and finish_reason right "
              f"on 7 streams; /metrics moved by {delta}; web chat logged {logs}")
        print(f"  {card}: paged worker phase_timings {json.dumps(status['phase_timings'])}")

        batcher._seat, batcher.submit = real_seat, real_submit
        worker.drain(timeout=60)
        if http_call(cbase + "/list_models", {})["json"]["models"] != []:
            raise AssertionError("phase 31: the drained worker is still registered")
        stop_http(wserver)
        servers.remove(wserver)
        del worker, batcher, rows, timing, wire, by_prompt, seat, lp_rows, submit
        del request_of, params_loaded, stream_req, wserver
        sched.logprob_rows = real_lp_rows
        release_earlier_phases()

        # -- the direct worker, with speculation -------------------------------
        wport = free_port()
        with api_stand_ins():
            worker = model_worker.ModelWorker(
                cbase, f"http://localhost:{wport}", str(model_dir), load_8bit=True,
                scheduler="none", speculative_k=SPEC_K, kv_cache_dtype=torch.int8, warmup=True)
        print(f"phase 31: {card}; direct worker (scheduler none, speculative_k {SPEC_K}): load "
              f"{worker.load_s:.2f} s, warm-up {worker.warmup_s:.2f} s")
        wbase, wserver = serve_http(model_worker.make_handler(worker), wport)
        servers.append(wserver)
        gen = worker.model.generator
        streamed_toks, lp_rows_direct = {}, []
        real_text = gen._stream_text

        def stream_text(toks, stop_strings):
            streamed_toks["last"] = list(toks)
            return real_text(toks, stop_strings)

        def entry(logits_row, tok, n_top):
            lp_rows_direct.append(logits_row.float().cpu())
            return real_entry(logits_row, tok, n_top)

        gen._stream_text, gen_mod.token_logprob_entry = stream_text, entry
        wire = []
        wire_tee(worker, wire)
        stream0 = dict(gen.stream_stats)
        GLOBAL_STATS.reset()
        reset_counts(counters)
        greedy = http_call(gbase + "/v1/chat/completions", chat_body(SERVE_TEXTS[0], images[0]))
        greedy_ids = streamed_toks["last"]
        sampled = http_call(gbase + "/v1/chat/completions", chat_body(
            SERVE_TEXTS[2], images[2], temperature=0.8, top_p=0.95, logprobs=True,
            top_logprobs=3))
        torch.cuda.synchronize()
        launches = read_counts(counters)
        stream1 = dict(gen.stream_stats)
        d = {k: stream1[k] - stream0[k] for k in stream0}
        want = {"vit_attention": tower_blocks(worker.cfg) * d["prefills"], "vit_block": 0,
                "flash_attention": depth * d["prefills"], "decode_attention": 0,
                "fused_decode": d["decode_steps"], "fused_verify": d["verify_rounds"],
                "paged_attention": 0}
        if (launches != want or d["prefills"] != 2 or not d["decode_steps"]
                or not d["verify_rounds"]):
            raise AssertionError(f"phase 31 direct worker: launches {launches} != {want} "
                                 f"(streams {d})")
        runs.append(launches)
        if len(wire) != 2:
            raise AssertionError(f"phase 31: the direct worker streamed {len(wire)} requests")
        (gparams, gchunks), (sparams, schunks) = wire
        final_g = check_stream("direct greedy", worker, gparams, gchunks, len(greedy_ids))
        final_s = check_stream("direct sampled", worker, sparams, schunks,
                               len(wire_ids(schunks)))
        for res, final in ((greedy, final_g), (sampled, final_s)):
            if res["status"] != 200 or res["json"]["usage"] != final["usage"]:
                raise AssertionError(f"phase 31: the gateway's usage {res['json'].get('usage')}"
                                     f" differs from the worker's {final['usage']}")
        s_entries = [{"id": e["id"], "logprob": e["logprob"],
                      "top": [(t[0], t[2]) for t in e["top"]]}
                     for c in schunks for e in c.get("logprobs", [])]
        lp_direct = check_logprob_entries("phase 31 direct sampled", s_entries,
                                          lp_rows_direct[:len(s_entries)], 3)
        batch, _ = worker.plan(gparams["prompt"], gparams["images"])
        ref, margins = plain_reference(worker.model.params, worker.cfg, batch, device)
        agree = decisive_agree("phase 31 direct greedy", greedy_ids, ref[0], margins[0])
        print(f"  {card}: greedy (speculative: {d['verify_rounds']} verify rounds, "
              f"{d['decode_steps']} plain steps in both streams) ids equal to the plain run for "
              f"{agree} of {len(greedy_ids)} tokens; sampled logprob entries within "
              f"{lp_direct:.2e}; launches {launches}; phase_timings "
              f"{json.dumps(worker.get_status()['phase_timings'])}")
        gen._stream_text = real_text
        gen_mod.token_logprob_entry = real_entry
        worker.drain(timeout=60)
        del worker, gen, stream_text, entry
    finally:
        sched.logprob_rows, gen_mod.token_logprob_entry = real_lp_rows, real_entry
        web_server.LOGDIR = real_logdir
        for server in servers:
            stop_http(server)
        ctl.stop()
        shutil.rmtree(logdir, ignore_errors=True)
        release_earlier_phases()
    return {k: sum(r.get(k, 0) for r in runs) for k in counters}




def qlora_record_checks(out: Path, steps: int, depth: int, first: bool = True) -> dict:
    """Phase 32's checks of one run's reference-layout checkpoints: each
    checkpoint (with `first`, checkpoint-1 too) holds adapter_config.json
    (r, alpha), adapter_model.bin with every target's lora_A / lora_B of
    every layer, and non_lora_trainables.bin with the projector; every B
    of checkpoint-1 is 0 (step 1 runs at lr 0) and every B of the last one
    is not. Returns the last checkpoint's adapter dict."""
    from tokenpacker_tpu_torch.train.lora import NAME_MAP

    want = {f"base_model.model.model.layers.{i}.{mod}.lora_{p}.weight"
            for i in range(depth) for mod in NAME_MAP.values() for p in "AB"}
    sds = {}
    for i in ((1, steps) if first else (steps,)):
        ck = out / f"checkpoint-{i}"
        acfg = json.loads((ck / "adapter_config.json").read_text())
        if (acfg["r"], acfg["lora_alpha"]) != (QLORA_RANK, QLORA_ALPHA):
            raise AssertionError(f"phase 32: {ck.name} adapter_config.json {acfg}")
        sds[i] = torch.load(ck / "adapter_model.bin", weights_only=True)
        if set(sds[i]) != want:
            raise AssertionError(f"phase 32: {ck.name} holds {len(sds[i])} adapter keys, "
                                 f"expected {len(want)}")
        nlt = torch.load(ck / "non_lora_trainables.bin", weights_only=True)
        if not nlt or not all(k.startswith("base_model.model.model.mm_projector.") for k in nlt):
            raise AssertionError(f"phase 32: {ck.name} non_lora_trainables.bin keys {list(nlt)}")
    zero1 = not first or all(not v.any() for k, v in sds[1].items() if "lora_B" in k)
    moved = all(v.any() for k, v in sds[steps].items() if "lora_B" in k)
    if not (zero1 and moved):
        raise AssertionError(f"phase 32: every B zero after step 1: {zero1}, every B non-zero "
                             f"after step {steps}: {moved}")
    return sds[steps]


def phase_qlora_train(device, seed: int, ckpt: dict, rows: dict, card: str) -> dict:
    """Phase 32 (configuration Q): QLoRA of TokenPacker-HD-7b from phase 28's
    checkpoint through the CLI, `train.main([...])` with LLaVA's
    finetune_qlora.sh settings (--bits 4 --lora-enable --lora-r 128
    --lora-alpha 256, lr 2e-4, mm_projector_lr 2e-5, no weight decay),
    slice mode with 9 patches, remat full, 3 steps of TRAIN_BATCH HD
    caption records padded to TRAIN_SEQ; then 2 steps with --bits 8. Each
    run: step ms, valid and padded tok/s and peak GiB a step; K1, K2-fwd
    and K2-bwd launches against the expected counts; the quantized base
    and the tower bitwise unchanged; the reference files (`qlora_record_
    checks`). Then the round trip of the nf4 run's last checkpoint
    (`qlora_round_trip`). Returns the launches of the two runs and the
    round trip's."""
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.train import train as train_cli
    from tokenpacker_tpu_torch.train import trainer as trainer_mod

    release_earlier_phases()
    cfg, path = ckpt["cfg"], ckpt["path"]
    depth = cfg.lm.num_hidden_layers
    root = Path(tempfile.mkdtemp(prefix="phase32_", dir=ckpt["root"]))
    data = write_caption_dataset(root, TRAIN_BATCH * QLORA_STEPS["4"], seed + 32)
    records = json.loads(data.read_text())
    data8 = root / "data8.json"
    data8.write_text(json.dumps(records[:TRAIN_BATCH * QLORA_STEPS["8"]]))
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd}
    per_step = {"vit_attention": tower_blocks(cfg), "flash_attention": 2 * depth,
                "flash_attention_bwd": depth}
    print(f"phase 32 (Q): QLoRA of {HD_PRESET} from phase 28's checkpoint through "
          f"tokenpacker_tpu_torch.train.train.main: rank {QLORA_RANK}, alpha {QLORA_ALPHA}, lr "
          f"{QLORA_LR}, mm_projector_lr {QLORA_PROJECTOR_LR}, slice mode 9 patches, remat full, "
          f"{TRAIN_BATCH} HD caption records a step padded to {TRAIN_SEQ}; {card}")
    frozen = {}
    real_train = trainer_mod.Trainer.train

    def train_checked(self):
        """Trainer.train with the frozen parts' fingerprints taken around it."""
        frozen["before"] = {part: fingerprints(self.params[part]) for part in ("vision", "lm")}
        out = real_train(self)
        frozen["after"] = {part: fingerprints(self.params[part]) for part in ("vision", "lm")}
        return out

    runs, lora_run = [], None
    trainer_mod.Trainer.train = train_checked
    try:
        for bits, data_path in (("4", data), ("8", data8)):
            steps = QLORA_STEPS[bits]
            out = root / f"bits{bits}"
            argv = ["--model-path", str(path), "--data-path", str(data_path),
                    "--image-folder", str(root), "--output-dir", str(out), "--version", "plain",
                    "--image-aspect-ratio", "slice", "--patch-num", "9",
                    "--model-max-length", str(TRAIN_SEQ), "--per-device-batch-size",
                    str(TRAIN_BATCH), "--bits", bits, "--lora-enable", "--lora-r",
                    str(QLORA_RANK), "--lora-alpha", str(QLORA_ALPHA), "--learning-rate",
                    str(QLORA_LR), "--mm-projector-lr", str(QLORA_PROJECTOR_LR),
                    "--weight-decay", "0", "--remat", "full",
                    # nf4: every step, for the B-after-step-1 check; int8: the end only
                    "--save-steps", "1" if bits == "4" else str(steps),
                    "--save-total-limit", str(steps), "--seed", str(seed),
                    "--device", torch.device(device).type]
            with api_stand_ins():
                torch.cuda.synchronize()
                reset_counts(counters)
                t0 = time.perf_counter()
                trainer = train_cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = read_counts(counters)
            want = {k: steps * v for k, v in per_step.items()}
            print(f"  --bits {bits}: {steps} steps in {wall:.2f} s (the checkpoint's load, the "
                  f"quantization and {steps} checkpoint writes included); launches {launches}, "
                  f"expected {want} (per step: 1 tower pass, {depth} K2-fwd + {depth} "
                  f"recomputed, {depth} K2-bwd)")
            if launches != want:
                raise AssertionError(f"phase 32 --bits {bits}: kernel launch counts {launches} "
                                     f"!= {want}")
            for r in trainer.history:
                print(f"  step {r['step']}: loss {r['loss']:.4f}, {r['seconds'] * 1e3:.1f} ms, "
                      f"{r['valid_tokens']} valid / {r['padded_tokens']} padded tokens = "
                      f"{r['valid_tokens'] / r['seconds']:.1f} / "
                      f"{r['padded_tokens'] / r['seconds']:.1f} tok/s, grad_norm "
                      f"{r['grad_norm']:.4f}, peak {r.get('peak_bytes', 0) / 2**30:.3f} GiB")
            if not all(np.isfinite(r["loss"]) for r in trainer.history):
                raise AssertionError(f"phase 32 --bits {bits}: a non-finite loss")
            if frozen["before"] != frozen["after"]:
                raise AssertionError(f"phase 32 --bits {bits}: the quantized base or the tower "
                                     "changed")
            qlora_record_checks(out, steps, depth, first=bits == "4")
            step_s = statistics.median(r["seconds"] for r in trainer.history[1:])
            print(f"  --bits {bits}: quantized base and tower bitwise unchanged; "
                  + ("every B zero after step 1 (lr 0), " if bits == "4" else "")
                  + f"every B non-zero after step {steps}; the reference files hold "
                  f"all {7 * depth} targets; step time (median of steps 2-{steps}) "
                  f"{step_s * 1e3:.1f} ms; {card}")
            runs.append(launches)
            if bits == "4":
                lora_run = {"lora": trainer.lora, "projector": trainer.params["projector"],
                            "ckpt": out / f"checkpoint-{steps}"}
            del trainer
            release_earlier_phases()
    finally:
        trainer_mod.Trainer.train = real_train
    runs.append(qlora_round_trip(device, seed, ckpt, lora_run))
    shutil.rmtree(root, ignore_errors=True)
    release_earlier_phases()
    return {k: sum(r.get(k, 0) for r in runs) for k in set().union(*runs)}


@torch.no_grad()
def first_step_logits(params, cfg, dev, fed: torch.Tensor | None = None, slot_lora=None):
    """The prefill's next-token logits and one decode step's (token `fed`,
    by default the prefill's top-1) of a batch, fp32 on the host, bf16
    cache: `decode_step` (K4 for an int8 tree, else per layer), or with
    `slot_lora` (its slots set) the slot overlay's `decode_step_cb` (K4-LoRA
    over an int8 tree). Returns ([prefill, step] logits, fed)."""
    from tokenpacker_tpu_torch.generate import decode_step, decode_step_cb, fused_weights, prefill

    l = dev["token_ids"].shape[1]
    pp = params
    if slot_lora is not None:
        pp = {**slot_lora.overlay(params), "projector": slot_lora.projectors["q"]}
    logits, cache = prefill(pp, cfg, dev, l + 8)
    out = [logits.float().cpu()]
    if fed is None:
        fed = logits.argmax(-1)
    if slot_lora is None:
        logits, _ = decode_step(params, cfg, cache, fed, dev["lengths"], 0, l)
    else:
        over = slot_lora.overlay(params)
        cur = dev["lengths"].clone().int()
        active = torch.ones_like(cur, dtype=torch.bool)
        logits, _ = decode_step_cb(over, cfg, cache, fed, cur, active, fused_weights(over, cfg))
    out.append(logits.float().cpu())
    return out, fed


@torch.no_grad()
def merged_dense(params, lora: dict | None, lcfg_scale: float, dequantize: bool) -> dict:
    """A plain bf16 tree: the LM's kernels (fused qkv / gateup where the tree
    has them; int8 ones dequantized when `dequantize`) with each target's
    delta (alpha / r) a @ b added in fp32 on the card (none for `lora`
    None), then cast to bf16. `lora`: the trainer's adapter tree; the
    other leaves are shared."""
    from tokenpacker_tpu_torch.ops.quantize import dequantize_int8, is_qleaf

    parts = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}
    lm = params["lm"]
    layers = []
    for i, layer in enumerate(lm["layers"]):
        new = dict(layer)
        for group in ("attn", "mlp"):
            sub = {}
            for name, mod in layer[group].items():
                k = mod["kernel"]
                w = dequantize_int8(k["q"], k["scale"], torch.float32) if is_qleaf(k) else k.float()
                if lora is not None:
                    ab = [lora["layers"][i][group][t] for t in parts.get(name, (name,))]
                    w += lcfg_scale * torch.cat([x["a"].float() @ x["b"].float() for x in ab],
                                                dim=-1)
                sub[name] = {**mod, "kernel": w.to(torch.bfloat16)}
                del w
            new[group] = sub
        layers.append(new)
    head = lm["lm_head"]["kernel"]
    if is_qleaf(head):
        head = dequantize_int8(head["q"], head["scale"], torch.bfloat16)
    return {**params, "lm": {**lm, "layers": layers, "lm_head": {**lm["lm_head"],
                                                                  "kernel": head}}}


def qlora_round_trip(device, seed: int, ckpt: dict, run: dict) -> dict:
    """Phase 32's round trip of the nf4 run's last checkpoint: (a)
    `api.load_pretrained_model(ckpt, model_base=<phase 28's dir>,
    load_8bit=True)` decodes phase 6's 4 HD requests greedily (K1, K2-fwd,
    K4 once a step) and its int8 codes lie within one step of
    `quantize_lm_int8` of the card's own merge of the trained adapters;
    (b) the base loaded with load_8bit serves the adapter through
    `ContinuousBatcher(adapters={"q": load_adapter(ckpt)})`, 32 greedy
    tokens of the 4 requests (K4-LoRA once a step), the adapter's a and
    alpha / r * b equal to the trained ones. First-step logits of (b)
    against a plain bf16 run of the int8 base dequantized plus the delta,
    and of (a) against one of its int8 weights dequantized, within
    QLORA_DEEP_BAND, which (b) with the adapter's term dropped must fail;
    the same comparison without the adapter is printed beside them."""
    from tokenpacker_tpu_torch.generate import device_batch
    from tokenpacker_tpu_torch.io.weights import params_to, quantize_lm_int8
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.fused_decode import fused_decode_hidden
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention
    from tokenpacker_tpu_torch.serve import scheduler as sched
    from tokenpacker_tpu_torch.serve.multi_lora import SlotLora, load_adapter

    cfg, path, lora, ck = ckpt["cfg"], ckpt["path"], run["lora"], run["ckpt"]
    depth = cfg.lm.num_hidden_layers
    scale = QLORA_ALPHA / QLORA_RANK
    batch, blocks = make_hd_requests(cfg, seed)
    dev = device_batch(batch, torch.bfloat16, device)
    counters = {"vit_attention": vit_attention, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_decode": fused_decode_hidden,
                "fused_decode_lora": (fused_decode_hidden, "lora_launches")}
    secs = {}
    with api_stand_ins() as api:
        t0 = time.perf_counter()
        dense = api.load_pretrained_model(str(path))[1].params
        torch.cuda.synchronize()
        secs["bf16 base load"] = time.perf_counter() - t0
    ref_a = {**merged_dense(dense, lora, scale, dequantize=False), "projector": run["projector"]}
    del dense
    exact_logits_a, fed = first_step_logits(ref_a, cfg, dev)
    want_q = quantize_lm_int8(lm_copy(ref_a))
    del ref_a
    ref_a = merged_dense(want_q, None, scale, dequantize=True)
    ref_logits_a, _ = first_step_logits(ref_a, cfg, dev, fed)
    del ref_a
    release_earlier_phases()
    with api_stand_ins() as api:
        t0 = time.perf_counter()
        model = api.load_pretrained_model(str(ck), str(path), load_8bit=True)[1]
        torch.cuda.synchronize()
        secs["LoRA checkpoint load (merge on the host, load_8bit)"] = time.perf_counter() - t0
    worst, differ, total = 0, 0, 0
    for got_l, want_l in zip(model.params["lm"]["layers"], want_q["lm"]["layers"]):
        for group in ("attn", "mlp"):
            for name, mod in got_l[group].items():
                g, w = mod["kernel"]["q"].int(), want_l[group][name]["kernel"]["q"].int()
                worst = max(worst, int((g - w).abs().max()))
                differ += int((g != w).sum())
                total += g.numel()
    del want_q
    n_proj = trees_equal("phase 32 projector", model.params["projector"], run["projector"])
    print(f"phase 32 round trip: {ck.name} over phase 28's directory, load_pretrained_model("
          f"load_8bit=True): int8 codes of the targets {differ} of {total} one step from "
          f"quantize_lm_int8 of the card's own merge, at most {worst} step; its projector's "
          f"{n_proj} tensors bit-equal to the trained one")
    if worst > 1:
        raise AssertionError(f"phase 32: the loaded LoRA merge lies {worst} int8 steps off")
    launches_a = check_generation("phase 32 load_8bit LoRA", model.generator, batch, cfg,
                                  {"vit_attention": tower_blocks(cfg), "flash_attention": depth,
                                   "decode_attention": 0, "fused_decode": NEW_TOKENS - 1,
                                   "fused_decode_lora": 0}, counters)
    got_a, _ = first_step_logits(model.params, cfg, dev, fed)
    del model
    release_earlier_phases()
    with api_stand_ins() as api:
        t0 = time.perf_counter()
        base = api.load_pretrained_model(str(path), load_8bit=True)[1].params
        torch.cuda.synchronize()
        secs["base load (load_8bit)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adapter = load_adapter(str(ck), cfg)
    secs["load_adapter"] = time.perf_counter() - t0
    same = all(np.array_equal(adapter.lora[(g, n)][0][i],
                              lora["layers"][i][g][n]["a"].detach().float().cpu().numpy())
               and np.array_equal(adapter.lora[(g, n)][1][i],
                                  (lora["layers"][i][g][n]["b"].detach().float() * scale)
                                  .cpu().numpy())
               for (g, n) in adapter.lora for i in range(depth))
    trees_equal("phase 32 load_adapter projector",
                params_to(adapter.projector, device, torch.bfloat16), run["projector"])
    if not same or len(adapter.lora) != 7:
        raise AssertionError("phase 32: load_adapter's a and alpha / r * b differ from the trained "
                             "adapters")
    reqs = paged_requests(cfg, seed)[:4]
    batcher = sched.ContinuousBatcher(base, cfg, num_slots=4, max_seq_len=SPEC_SEQ,
                                      adapters={"q": adapter}, device=device)
    try:
        torch.cuda.synchronize()
        reset_counts(counters)
        batcher.start()
        t1 = time.perf_counter()
        futs = [batcher.submit(r, max_new_tokens=NEW_TOKENS, adapter="q") for r in reqs]
        tokens = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t1
        batcher.stop()
        torch.cuda.synchronize()
    finally:
        batcher.stop()
    launches_b = read_counts(counters)
    steps = batcher.stats["decode_steps"]
    print(f"  the load_8bit base with the adapter through ContinuousBatcher(adapters="
          f"{{'q': load_adapter(ckpt)}}): phase 10's first 4 requests, tokens "
          f"{[len(t) for t in tokens]} in {wall:.3f} s, {steps} K4-LoRA steps; launches "
          f"{launches_b}; load_adapter's a and alpha / r * b equal the trained adapters; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    if launches_b["fused_decode_lora"] != steps or steps == 0 or any(
            len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError(f"phase 32: the adapter's batcher run: launches {launches_b}, "
                             f"{steps} steps, tokens {[len(t) for t in tokens]}")
    del batcher
    release_earlier_phases()
    sl = SlotLora(base, cfg, {"q": adapter}, 4)
    for i in range(4):
        sl.set_slot(i, "q")
    got_b, _ = first_step_logits(base, cfg, dev, fed, slot_lora=sl)
    for i in range(4):
        sl.set_slot(i, None)
    dropped, _ = first_step_logits(base, cfg, dev, fed, slot_lora=sl)
    ref_b = merged_dense(base, lora, scale, dequantize=True)
    ref_b["projector"] = sl.projectors["q"]
    ref_logits_b, _ = first_step_logits(ref_b, cfg, dev, fed)
    del ref_b
    ref_base_b = merged_dense(base, None, scale, dequantize=True)
    ref_base_b["projector"] = sl.projectors["q"]
    base_logits_b, _ = first_step_logits(ref_base_b, cfg, dev, fed)
    del ref_base_b, base, sl
    release_earlier_phases()

    def reading(got, want):
        return [round((g - w).abs().max().item(), 4) for g, w in zip(got, want)]

    served, merged = reading(got_b, ref_logits_b), reading(got_a, ref_logits_a)
    lost = reading(dropped, ref_logits_b)
    print(f"  first-step logits, max|dlogit| (prefill, step 1), band {QLORA_DEEP_BAND}: the "
          f"adapter served (K4-LoRA) vs plain bf16 of the int8 base dequantized + delta "
          f"{served} (without the adapter on both sides {reading(dropped, base_logits_b)}; "
          f"with the term dropped on the served side {lost}, which must exceed the band); the "
          f"merged load_8bit (K4) vs plain bf16 of its int8 weights dequantized {merged} "
          f"(against the bf16 base + delta, before the int8 rounding: "
          f"{reading(got_a, exact_logits_a)}; the delta alone moves the plain run by "
          f"{reading(ref_logits_b, base_logits_b)})")
    for name, got, want in (("served", got_b, ref_logits_b), ("merged", got_a, ref_logits_a)):
        for tag, g, w in zip(("prefill", "step 1"), got, want):
            band_check(f"phase 32 {name} adapter, {tag}", g, w, QLORA_DEEP_BAND)
    if not min(lost) > QLORA_DEEP_BAND:
        raise AssertionError("phase 32: the band does not see the adapter's term dropped")
    return {k: launches_a.get(k, 0) + launches_b.get(k, 0) for k in counters}


def phase_qlora_parity(device, seed: int) -> None:
    """Phase 33: full widths, 2 LM layers; one LoRA step over an nf4 base on
    the card (bf16, kernels) and on the CPU (fp32, plain versions) from the
    same weights, adapters and batch (`stage2_parity`'s QLoRA form), the
    adapters at the LM's band, and K2's backward losing dq, or dk and dv,
    must fail it."""
    from tokenpacker_tpu_torch.config import preset_config
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention_bwd

    full = preset_config(HD_PRESET)
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    stage2_parity("phase 33", cfg, device, seed, ("dq", "dk, dv"),
                  (flash_attention_bwd, "launches"), r"lm\.layers\.\d+\.attn\.[qkvo]\.[ab]", 16,
                  qlora=True)


# -- phase 34: the evaluation harness (configuration R) ------------------------

EVAL_GQA, EVAL_GQA_BATCH = 32, 16  # (a): questions, and gqa.sh's --batch-size
EVAL_SMALL = 4  # (b)'s TSV rows, (c)'s questions of each benchmark, (e)'s MMMU records
# (a)'s answers held against batch-1 runs: rows of both 8-row tiles that
# K4 takes at the batch's 16 rows
EVAL_REF = (0, 1, 2, 3, 12, 13, 14, 15)
EVAL_MAX_NEW = 128  # the CLIs' default --max-new-tokens
GQA_OBJECTS = ("car", "man", "table", "dog", "shirt", "sign", "tree", "bus", "cup", "horse",
               "window", "bag", "fence", "boat", "chair", "plate")
GQA_FORMS = ("What color is the {} on the left?", "Is the {} to the right of the person?",
             "Which side of the picture is the {} on?", "What is the {} made of?")
GQA_PROMPT = "\nAnswer the question using a single word or phrase."


def photo(rng, w: int, h: int):
    """A synthetic photo: a coarse random field, smoothed up to w x h, with
    per-pixel noise (an RGB PIL image)."""
    from PIL import Image

    small = rng.integers(0, 256, (max(2, h // 48), max(2, w // 48), 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR), dtype=np.int16)
    noise = rng.integers(-10, 11, (h, w, 1), dtype=np.int16)
    return Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8))


def document_page(rng, w: int = 1700, h: int = 2200):
    """A synthetic scanned page (or, small, a word crop): dark word boxes
    in lines on white."""
    from PIL import Image

    page = np.full((h, w, 3), 248, dtype=np.uint8)
    mx, my = min(130, w // 10), min(140, h // 6)
    for y in range(my, h - my - 22, 46):
        x = mx
        while x < w - mx - 200:
            width = int(rng.integers(30, 200))
            page[y:y + 22, x:x + width] = int(rng.integers(10, 70))
            x += width + int(rng.integers(14, 28))
    return Image.fromarray(page)


def png_b64(img) -> str:
    import base64
    import io

    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def write_eval_fixtures(root: Path, seed: int) -> dict:
    """The inputs of phase 34's steps under root: (a) EVAL_GQA GQA-style
    questions over PNGs of 320-800 px a side (mixed aspect, so the HD grids
    of a batch are ragged) and their labels; (b) an MMBench TSV of
    EVAL_SMALL rows with base64 PNGs (an empty hint, a row of 2 options, a
    row of numeric options); (c) DocVQA pages of 1700 x 2200, OCRBench
    word crops, text-only questions; (d) one photo; (e) MMMU records
    (2 multiple-choice, 2 open) with their answer dict. Returns the paths
    and the records."""
    rng = np.random.default_rng(seed)
    imgs = root / "images"
    imgs.mkdir(parents=True)
    questions, labels = [], {}
    for i in range(EVAL_GQA):
        w, h = (int(x) for x in rng.integers(320, 801, 2))
        photo(rng, w, h).save(imgs / f"gqa{i}.png")
        text = GQA_FORMS[i % len(GQA_FORMS)].format(GQA_OBJECTS[i % len(GQA_OBJECTS)])
        questions.append({"question_id": f"gqa{i}", "image": f"gqa{i}.png",
                          "text": text + GQA_PROMPT})
        labels[f"gqa{i}"] = {"answer": ("left", "yes", "right", "wood")[i % 4]}
    (root / "gqa.jsonl").write_text("".join(json.dumps(q) + "\n" for q in questions))
    (root / "gqa_labels.json").write_text(json.dumps(labels))
    tsv = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\tcategory\timage"]
    rows = [(0, "Which animal is shown?", "", "cat", "dog", "horse", "bird", "B"),
            (1, "Is the light on?", "Look at the lamp.", "yes", "no", "", "", "A"),
            (2, "How many people are in the picture?", "Count them.", "1", "2", "3", "4", "C"),
            (3, "Which season is it?", "nan", "spring", "summer", "autumn", "winter", "D")]
    for idx, q, hint, a, b, c, d, ans in rows:
        w, h = (int(x) for x in rng.integers(400, 641, 2))
        tsv.append("\t".join([str(idx), q, hint, a, b, c, d, ans, "attribute",
                              png_b64(photo(rng, w, h))]))
    (root / "mmbench.tsv").write_text("\n".join(tsv) + "\n")
    docs = {"data": []}
    for i in range(EVAL_SMALL):
        document_page(rng).save(imgs / f"doc{i}.png")
        docs["data"].append({"questionId": 100 + i, "image": f"doc{i}.png",
                             "question": ("What is the date?", "Who signed the letter?",
                                          "What is the total?", "What is the title?")[i]})
    (root / "docvqa.json").write_text(json.dumps(docs))
    ocr = []
    for i in range(EVAL_SMALL):
        document_page(rng, 400 + 60 * i, 140).save(imgs / f"ocr{i}.png")
        ocr.append({"question": "what is written in the image?", "image_path": f"ocr{i}.png",
                    "type": ("Regular Text Recognition", "Key Information Extraction")[i % 2],
                    "answers": ["hello", "world"][: 1 + i % 2], "dataset_name": "synthetic"})
    (root / "ocrbench.json").write_text(json.dumps(ocr))
    (root / "textqa.jsonl").write_text("".join(
        json.dumps({"question_id": i, "text": t}) + "\n" for i, t in enumerate(
            ("What is the capital of France?", "Name a prime number larger than ten.",
             "Why is the sky blue?", "Write one sentence about the sea."))))
    photo(rng, 640, 480).save(imgs / "demo.png")
    mc = "multiple-choice"
    records = [
        {"id": "validation_Art_1", "question": "<image 1> Which style is this painting?",
         "question_type": mc, "options": "['Baroque', 'Cubism', 'Impressionism', 'Gothic']",
         "answer": "C"},
        {"id": "validation_Biology_2", "question": "What does the diagram <image 1> show?",
         "question_type": mc, "options": "['Mitosis', 'Meiosis']", "answer": "A"},
        {"id": "validation_Math_3", "question": "<image 1> What is the area of the square?",
         "question_type": "open", "options": "[]", "answer": "16"},
        {"id": "validation_Physics_4", "question": "<image 1> What is the speed in m/s?",
         "question_type": "open", "options": "[]", "answer": "3.5"}]
    for r in records:
        r["image_1"] = photo(rng, int(rng.integers(300, 700)), int(rng.integers(300, 700)))
    (root / "mmmu_answer_dict.json").write_text(json.dumps(
        {r["id"]: {"ground_truth": r["answer"], "question_type": r["question_type"]}
         for r in records}))
    return {"root": root, "images": imgs, "records": records}


@contextlib.contextmanager
def eval_recorder(keep_model: bool = False):
    """While open, records every `Generator.generate` call (its batch's
    rows, views and image tokens, num_beams, result and host clock), the
    rows of each K4 and K4-verify call made in it, every
    `EvalRunner._prepare` (host clock, from the prefetch thread) and each
    `api.load_pretrained_model` (seconds; the model if `keep_model`)."""
    from tokenpacker_tpu_torch import api
    from tokenpacker_tpu_torch import generate as gen_mod
    from tokenpacker_tpu_torch import speculative as spec_mod
    from tokenpacker_tpu_torch.eval import runner as runner_mod

    rec = {"calls": [], "preps": [], "loads": []}
    real = (gen_mod.Generator.generate, runner_mod.EvalRunner._prepare,
            gen_mod.fused_decode_hidden, spec_mod.fused_verify_hidden, api.load_pretrained_model)

    def generate(self, batch, *a, **kw):
        images = batch.get("images")
        call = {"rows": batch["token_ids"].shape[0],
                "views": None if images is None else images.shape[0],
                "image_tokens": int(np.asarray(batch["is_image"]).sum()),
                "num_beams": kw.get("num_beams", 1), "k4_rows": [], "verify_rows": []}
        rec["calls"].append(call)
        call["start"] = time.perf_counter()
        call["result"] = real[0](self, batch, *a, **kw)
        call["end"] = time.perf_counter()
        return call["result"]

    def prepare(self, samples):
        t0 = time.perf_counter()
        out = real[1](self, samples)
        rec["preps"].append((t0, time.perf_counter()))
        return out

    def k4(lm, lc, emb, *a, **kw):
        rec["calls"][-1]["k4_rows"].append(emb.shape[0])
        return real[2](lm, lc, emb, *a, **kw)

    def k4_verify(lm, lc, emb, *a, **kw):
        rec["calls"][-1]["verify_rows"].append(tuple(emb.shape[:2]))
        return real[3](lm, lc, emb, *a, **kw)

    def load(*a, **kw):
        t0 = time.perf_counter()
        out = real[4](*a, **kw)
        torch.cuda.synchronize()
        rec["loads"].append({"seconds": time.perf_counter() - t0,
                             **({"tokenizer": out[0], "model": out[1]} if keep_model else {})})
        return out

    (gen_mod.Generator.generate, runner_mod.EvalRunner._prepare, gen_mod.fused_decode_hidden,
     spec_mod.fused_verify_hidden, api.load_pretrained_model) = (generate, prepare, k4, k4_verify,
                                                                 load)
    try:
        yield rec
    finally:
        (gen_mod.Generator.generate, runner_mod.EvalRunner._prepare, gen_mod.fused_decode_hidden,
         spec_mod.fused_verify_hidden, api.load_pretrained_model) = real


def eval_launches(name: str, rec: dict, cfg, counters: dict) -> dict:
    """The launches the recorded calls imply: per `generate` one tower pass
    over the batch's views (K1 on each of its blocks; none without an
    image), one prefill (K2-fwd a layer), one K4 call a decode step at the
    batch's rows (n x k with beams) and one K4-verify call a speculative
    round. Raises where a batch's views are not exactly those its image
    tokens read (a padded or unread view), or where K4's calls disagree
    with the steps `generate` reports."""
    want = {k: 0 for k in counters}
    for i, c in enumerate(rec["calls"]):
        stats = c["result"].stats
        want["flash_attention"] += cfg.lm.num_hidden_layers
        if c["views"] is not None:
            want["vit_attention"] += tower_blocks(cfg)
            if c["image_tokens"] != c["views"] * cfg.tokens_per_view:
                raise AssertionError(f"{name} call {i}: {c['views']} views for "
                                     f"{c['image_tokens']} image tokens")
        rows = c["rows"] * max(c["num_beams"], 1)
        if any(r != rows for r in c["k4_rows"]):
            raise AssertionError(f"{name} call {i}: K4 at rows {sorted(set(c['k4_rows']))}, "
                                 f"expected {rows}")
        if c["num_beams"] <= 1 and len(c["k4_rows"]) != stats["decode_steps"]:
            raise AssertionError(f"{name} call {i}: {len(c['k4_rows'])} K4 calls for "
                                 f"{stats['decode_steps']} decode steps")
        if len(c["verify_rows"]) != stats.get("verify_rounds", 0):
            raise AssertionError(f"{name} call {i}: {len(c['verify_rows'])} K4-verify calls for "
                                 f"{stats.get('verify_rounds', 0)} rounds")
        want["fused_decode"] += len(c["k4_rows"])
        want["fused_verify"] += len(c["verify_rows"])
    return want


def answers_in_order(name: str, path: Path, ids: list) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    got = [r["question_id"] for r in rows]
    if got != ids:
        raise AssertionError(f"{name}: answers for {got}, expected {ids}")
    if not all(isinstance(r["text"], str) for r in rows):
        raise AssertionError(f"{name}: an answer without text")
    return rows


def phase_eval(device, seed: int, ckpt: dict, card: str) -> dict:
    """Phase 34 (configuration R, the evaluation harness): phase 28's
    TokenPacker-HD-7b directory through the port's eval CLIs, each called
    through its `main([...])` with --load-8bit and the device, under
    `api_stand_ins()`, each loading the model anew and freeing it before
    the next:

    (a) `benchmarks vqa` with gqa.sh's flags (--batch-size 16, vicuna_v1,
        128 new tokens) over EVAL_GQA GQA-style questions; (b)
        `benchmarks mmbench --all-rounds --single-pred-prompt` (batch 16)
        over the TSV; (c) `docvqa` (slice, batch 8), `ocrbench` (batch 16)
        and `textqa`; (d) `run_demo` at temperature 0 with --num-beams 4,
        then with --speculative-k 4; (e) `mmmu.run` over the records from a
        list, then `mmmu score`, `convert gqa` + `score_cli gqa` on (a),
        `score_cli mmbench` (majority and strict) and `convert mmbench` on
        (b).

    Checks: each answers file holds one line a question (a round for
    (b)), ids in order; the launches of each CLI run equal what its
    `generate` calls imply (`eval_launches`: every view real, K4 once a
    step at the batch's rows, K4-verify once a round, none of K1 for
    textqa); (a)'s answers EVAL_REF, by token id, equal a batch-1
    `Generator.generate` of the same sample on the same loaded model up to
    the first token where that run's top-2 margin is within LOGIT_BAND
    (`plain_reference`, the same steps, records the margins; its tokens
    equal the batch-1 run's). Prints (a)'s load, wall, questions/s, ms a
    question and peak GiB, and each batch's host preparation and how much
    of it ran under the previous batch's generate, beside `card`."""
    import io

    from tokenpacker_tpu_torch.eval import benchmarks, convert, mmmu, run_demo, score_cli
    from tokenpacker_tpu_torch.eval.runner import EvalRunner

    release_earlier_phases()
    cfg, path = ckpt["cfg"], str(ckpt["path"])
    root = Path(tempfile.mkdtemp(prefix="phase34_", dir=ckpt["root"]))
    t0 = time.perf_counter()
    fx = write_eval_fixtures(root, seed + 34)
    imgs, out = str(fx["images"]), root / "answers"
    print(f"phase 34 (R): the eval harness over phase 28's {HD_PRESET} directory, each CLI "
          f"through its main() with --load-8bit; fixtures written in "
          f"{time.perf_counter() - t0:.2f} s; {card}")
    dev = ["--load-8bit", "--device", torch.device(device).type]
    counters = sampling_counters()
    runs = []

    def cli(step: str, fn, argv: list, keep_model: bool = False):
        release_earlier_phases()
        printed = io.StringIO()
        with api_stand_ins(), eval_recorder(keep_model) as rec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            t = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                fn(argv + dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        want = eval_launches(f"phase 34 {step}", rec, cfg, counters)
        load_s = rec["loads"][0]["seconds"]
        gen_s = sum(c["end"] - c["start"] for c in rec["calls"])
        print(f"  {step}: {len(rec['calls'])} generate calls (rows "
              f"{[c['rows'] for c in rec['calls']]}, views {[c['views'] for c in rec['calls']]}) "
              f"in {wall:.2f} s: load {load_s:.2f} s, generate {gen_s:.2f} s; peak "
              f"{peak / 2**30:.2f} GiB; launches {launches}")
        if launches != want:
            raise AssertionError(f"phase 34 {step}: kernel launch counts {launches} != {want}")
        runs.append(launches)
        return rec, wall, printed.getvalue()

    # (a) GQA through `benchmarks vqa`, gqa.sh's flags
    qids = [f"gqa{i}" for i in range(EVAL_GQA)]
    rec, wall, _ = cli("(a) vqa", benchmarks.main, [
        "vqa", "--model-path", path, "--question-file", str(root / "gqa.jsonl"),
        "--image-folder", imgs, "--answers-file", str(out / "gqa.jsonl"),
        "--batch-size", str(EVAL_GQA_BATCH), "--conv-mode", "vicuna_v1"], keep_model=True)
    answers_in_order("phase 34 (a)", out / "gqa.jsonl", qids)
    load_s = rec["loads"][0]["seconds"]
    gen_wall = wall - load_s
    print(f"  (a) {EVAL_GQA} questions, batch {EVAL_GQA_BATCH}: load {load_s:.2f} s, wall "
          f"{wall:.2f} s, {EVAL_GQA / gen_wall:.2f} questions/s and "
          f"{gen_wall / EVAL_GQA * 1e3:.1f} ms a question after the load; {card}")
    preps, calls = rec["preps"], rec["calls"]
    for i, (c, (p0, p1)) in enumerate(zip(calls, preps)):
        if i == 0:
            hidden, waited = "nothing to hide it under", c["start"] - p1
        else:
            prev = calls[i - 1]
            under = max(0.0, min(p1, prev["end"]) - max(p0, prev["start"]))
            hidden, waited = f"{under * 1e3:.1f} ms of it under batch {i - 1}'s generate", \
                c["start"] - prev["end"]
        print(f"  (a) batch {i}: host preparation {(p1 - p0) * 1e3:.1f} ms ({hidden}); generate "
              f"{(c['end'] - c['start']) * 1e3:.1f} ms ({c['result'].stats['decode_steps']} "
              f"decode steps); the loop waited {max(waited, 0.0) * 1e3:.1f} ms before it")
    # answers from both of K4's 8-row tiles against batch-1 runs of the same
    # samples on the same model
    model, tokenizer = rec["loads"][0]["model"], rec["loads"][0]["tokenizer"]
    runner = EvalRunner(model, tokenizer, conv_mode="vicuna_v1")
    samples = list(benchmarks.iter_vqa_jsonl(str(root / "gqa.jsonl"), imgs))
    agree = []
    for i in EVAL_REF:
        s = samples[i]
        plan, images = runner._prepare([s])
        batch = {"token_ids": plan.token_ids, "is_image": plan.is_image,
                 "image_slot": plan.image_slot, "lengths": plan.lengths, "images": images}
        one = model.generator.generate(batch, max_new_tokens=EVAL_MAX_NEW,
                                       stop_strings=runner.stop_strings()).sequences[0]
        toks, margins = plain_reference(model.params, model.cfg, batch, device,
                                        kv_cache_dtype=None, new_tokens=EVAL_MAX_NEW)
        if toks[0][:len(one)] != one:
            raise AssertionError(f"phase 34 (a) question {i}: batch-1 generate {one[:8]}... "
                                 f"differs from its plain steps {toks[0][:8]}...")
        got = calls[0]["result"].sequences[i]
        agree.append((decisive_agree(f"phase 34 (a) question {i}", got, one, margins[0]),
                      len(got), len(one)))
    print(f"  (a) answers {list(EVAL_REF)} by token id against batch-1 Generator.generate on "
          f"the loaded model: (leading tokens equal, batch-16 tokens, batch-1 tokens) {agree}, "
          f"any difference at a margin within LOGIT_BAND {LOGIT_BAND}")
    del rec, model, tokenizer, runner
    # (b) MMBench: all rounds, single-prediction prompt
    rec, _, _ = cli("(b) mmbench", benchmarks.main, [
        "mmbench", "--model-path", path, "--question-file", str(root / "mmbench.tsv"),
        "--answers-file", str(out / "mmbench.jsonl"), "--all-rounds", "--single-pred-prompt",
        "--batch-size", str(EVAL_GQA_BATCH), "--conv-mode", "vicuna_v1"])
    rounds = answers_in_order("phase 34 (b)", out / "mmbench.jsonl",
                              [0] * 4 + [1] * 2 + [2] * 4 + [3] * 4)
    if [r["round_id"] for r in rounds] != [0, 1, 2, 3, 0, 1, 0, 1, 2, 3, 0, 1, 2, 3]:
        raise AssertionError("phase 34 (b): rounds out of order")
    # (c) DocVQA (slice, docvqa.sh's batch 8), OCRBench, text-only QA
    rec, _, _ = cli("(c) docvqa", benchmarks.main, [
        "docvqa", "--model-path", path, "--question-file", str(root / "docvqa.json"),
        "--image-folder", imgs, "--answers-file", str(out / "docvqa.jsonl"),
        "--image-aspect-ratio", "slice", "--batch-size", "8", "--conv-mode", "vicuna_v1"])
    answers_in_order("phase 34 (c) docvqa", out / "docvqa.jsonl", [100, 101, 102, 103])
    rec, _, printed = cli("(c) ocrbench", benchmarks.main, [
        "ocrbench", "--model-path", path, "--question-file", str(root / "ocrbench.json"),
        "--image-folder", imgs, "--answers-file", str(out / "ocrbench.jsonl"),
        "--batch-size", str(EVAL_GQA_BATCH), "--conv-mode", "vicuna_v1"])
    scored = answers_in_order("phase 34 (c) ocrbench", out / "ocrbench.jsonl", [0, 1, 2, 3])
    if json.loads(printed)["total"] != sum(r["score"] for r in scored):
        raise AssertionError("phase 34 (c) ocrbench: the printed total differs from the scores")
    rec, _, _ = cli("(c) textqa", benchmarks.main, [
        "textqa", "--model-path", path, "--question-file", str(root / "textqa.jsonl"),
        "--answers-file", str(out / "textqa.jsonl"), "--conv-mode", "vicuna_v1"])
    answers_in_order("phase 34 (c) textqa", out / "textqa.jsonl", [0, 1, 2, 3])
    if runs[-1]["vit_attention"] != 0:
        raise AssertionError("phase 34 (c) textqa: the tower ran")
    # (d) run_demo: beams, then speculation
    demo = ["--model-path", path, "--image-file", str(fx["images"] / "demo.png"), "--query",
            "Describe this image in detail.", "--temperature", "0"]
    for flags in (["--num-beams", "4"], ["--speculative-k", str(SPEC_K)]):
        rec, _, printed = cli(f"(d) run_demo {' '.join(flags)}", run_demo.main, demo + flags)
        if len(printed.splitlines()) != 1:
            raise AssertionError(f"phase 34 (d) {flags}: printed {printed!r}")
        print(f"  (d) run_demo {' '.join(flags)}: {len(rec['calls'][0]['result'].sequences[0])} "
              f"tokens, {len(rec['calls'][0]['k4_rows'])} K4 calls at rows "
              f"{sorted(set(rec['calls'][0]['k4_rows']))}, "
              f"{rec['calls'][0]['result'].stats.get('verify_rounds', 0)} verify rounds")
    # (e) MMMU from a list of records, then the scorers and converters
    rec, _, _ = cli("(e) mmmu run", lambda argv: mmmu.run(mmmu.build_parser().parse_args(argv),
                                                          fx["records"]),
                    ["run", "--model-path", path, "--output", str(out / "mmmu.json")])
    parsed = json.loads((out / "mmmu.json").read_text())
    if list(parsed) != [r["id"] for r in fx["records"]] or \
            parsed["validation_Art_1"] not in "ABCD" or parsed["validation_Biology_2"] not in "AB":
        raise AssertionError(f"phase 34 (e): parsed answers {parsed}")
    del rec
    release_earlier_phases()
    host = io.StringIO()
    with contextlib.redirect_stdout(host):
        mmmu.main(["score", "--answers", str(out / "mmmu.json"), "--answer-dict",
                   str(root / "mmmu_answer_dict.json")])
        mmmu_scores = json.loads(host.getvalue())
        convert.main(["gqa", "--src", str(out / "gqa.jsonl"), "--dst", str(out / "gqa_pred.json")])
        score_cli.main(["gqa", "--result-file", str(out / "gqa_pred.json"), "--questions",
                        str(root / "gqa_labels.json")])
        for strict in ([], ["--all-rounds-strict"]):
            score_cli.main(["mmbench", "--annotation-file", str(root / "mmbench.tsv"),
                            "--result-file", str(out / "mmbench.jsonl"), *strict])
        convert.main(["mmbench", "--annotation-file", str(root / "mmbench.tsv"), "--result-file",
                      str(out / "mmbench.jsonl"), "--dst", str(out / "upload" / "mmbench.xlsx")])
    if mmmu_scores["Overall"]["num"] != len(fx["records"]):
        raise AssertionError(f"phase 34 (e): MMMU scored {mmmu_scores}")
    if len(json.loads((out / "gqa_pred.json").read_text())) != EVAL_GQA:
        raise AssertionError("phase 34 (e): convert gqa lost answers")
    lines = host.getvalue().splitlines()
    accuracies = [line for line in lines if line.startswith("Accuracy:")]
    upload = sorted(p.name for p in (out / "upload").iterdir())
    if len(accuracies) != 3 or not upload:
        raise AssertionError(f"phase 34 (e): score and convert printed {lines}")
    print(f"  (e) MMMU overall {mmmu_scores['Overall']}; score_cli gqa / mmbench majority / "
          f"strict: {[a.split()[1] for a in accuracies]} (random weights); convert mmbench "
          f"wrote {upload}")
    shutil.rmtree(root, ignore_errors=True)
    release_earlier_phases()
    return {k: sum(r.get(k, 0) for r in runs) for k in counters}


# -- configuration S: the sharded programs as two ranks on the one card --------------

PARALLEL_TIMEOUT = 600  # phase 35's two ranks, their start and the weights' init included


# Phase 35's two ranks: `phase_parallel` spawns this script twice with
# `--rank` (through `dryrun.launch(script=...)`), and each runs the
# scenarios below through `dryrun.main(argv, S_RUNNERS)`. Full widths on
# the card; rank 0 also does the single-process work each run is held
# to, and returns what `phase_parallel` checks with its own measures and
# the kernel launches of each sharded run.

S_LAYERS = {"hd13b": 8, "train7b": 2, "pipeline7b": 4, "batcher7b": 2, "lora7b": 8}
S_NEW_TOKENS = 16
# (g)'s batchers (`dryrun.lora_batcher`), its adapters' ranks and entries:
# A and B both at 0.015 x sqrt(alpha / r), the products of phase 18's
# adapters (A at LORA_SERVE_SCALE, B at it times alpha / r), a term of ~1/10
# of the base products. At 0.03 for both (an H100 80GB HBM3 run at 700 W),
# ad_a left the base at token 0 by a gap of 4.49, but the larger logits'
# bf16 ties parted the streams from one rank's early (68 of 128 tokens
# compared)
S_LORA_SIZES = dict(page_size=16, chunk=32, max_seq_len=128)
S_LORA_RANKS = {"ad_a": 16, "ad_b": 8}
S_LORA_SCALES = {"ad_a": 0.0212, "ad_b": 0.03}
S_LORA_PROMPTS = (40, 48)  # (g)'s two prompt lengths


def s_config(kind: str):
    from tokenpacker_tpu_torch.config import preset_config

    preset = {"hd13b": "tokenpacker-hd-13b-9patch-144token",
              "train7b": "tokenpacker-7b-144token", "pipeline7b": "tokenpacker-7b-144token",
              "batcher7b": "tokenpacker-hd-7b-9patch-144token",
              "lora7b": "tokenpacker-hd-7b-9patch-144token"}[kind]
    cfg = preset_config(preset)
    lm = dataclasses.replace(cfg.lm, num_hidden_layers=S_LAYERS[kind])
    return dataclasses.replace(cfg, lm=lm, dtype=torch.bfloat16)


def s_launch_counters() -> dict:
    """The kernel wrappers the sharded runs launch, by kernel-line name."""
    from tokenpacker_tpu_torch.ops.decode_attention import decode_attention
    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tokenpacker_tpu_torch.ops.paged_attention import paged_attention
    from tokenpacker_tpu_torch.ops.vit_attention import vit_attention

    return {"flash_attention_rank": flash_attention, "flash_attention_bwd_rank":
            flash_attention_bwd, "decode_attention_rank": decode_attention,
            "paged_attention_rank": paged_attention, "vit_attention": vit_attention}


def s_counted(run):
    """run() with the launch counters set to 0 just before and read just
    after: (its result, {name: launches})."""
    counters = s_launch_counters()
    for c in counters.values():
        c.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def s_weights(cfg, seed: int, device, int8: bool):
    from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, quantize_lm_int8

    params = init_vlm_on_device(cfg, seed, device, cfg.dtype)
    return quantize_lm_int8(params) if int8 else params


def s_hd_batch(cfg, seed: int):
    """One HD request: a 2 x 2 grid and the global view of random pixels,
    30 text tokens before the image and 20 after."""
    from tokenpacker_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    rng = np.random.default_rng(seed)
    v = min(cfg.lm.vocab_size, 32000)
    ids = np.concatenate([[1], rng.integers(3, v, 30), [IMAGE_TOKEN_INDEX],
                          rng.integers(3, v, 20)]).astype(np.int64)
    plan = build_splice_plan([ids], [[(2, 2)]], cfg.tokens_per_view, "slice", sep_id=3,
                             newline_id=4, pad_id=0)
    imgs = rng.standard_normal((5, cfg.vision.image_size, cfg.vision.image_size, 3))
    return {"token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths,
            "images": imgs.astype(np.float32)}


def s_greedy_with_margins(params, cfg, batch: dict, new: int, device):
    """Greedy tokens of one rank's run over the per-layer decode path (K3),
    with the top-2 margin of the logits behind each."""
    from tokenpacker_tpu_torch.generate import decode_step, device_batch, prefill

    l = batch["token_ids"].shape[1]
    dev = device_batch(batch, cfg.dtype, device)
    logits, cache = prefill(params, cfg, dev, l + new)
    toks, margins = [], []
    for step in range(new):
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float(top2[0, 0] - top2[0, 1]))
        toks.append(int(logits[0].argmax()))
        if step < new - 1:
            logits, cache = decode_step(params, cfg, cache,
                                        torch.tensor([toks[-1]], device=device),
                                        dev["lengths"], step, l, False)
    return toks, margins


def s_hd13b(ctx):
    """(a) HD-13b int8 (fused layout) HD prefill and greedy decode at
    tp = 2 through `Generator`, and the same on one rank."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.generate import Generator
    from tokenpacker_tpu_torch.parallel.mesh import make_mesh
    from tokenpacker_tpu_torch.parallel.sharding import shard_params

    cfg, device = s_config("hd13b"), ctx["device"]
    mesh = make_mesh(tp=2, device=device, backend=ctx["backend"])
    params = s_weights(cfg, 0, device, int8=True)
    batch = s_hd_batch(cfg, 0)
    sharded = shard_params(params, mesh, cfg)
    if ctx["rank"] != 0:
        del params
    with mesh:
        res, launches = s_counted(lambda: Generator(sharded, cfg).generate(
            batch, max_new_tokens=S_NEW_TOKENS))
    del sharded
    out = {}
    if ctx["rank"] == 0:
        toks, margins = s_greedy_with_margins(params, cfg, batch, S_NEW_TOKENS, device)
        out = {"tokens": res.sequences[0], "ref_tokens": toks, "ref_margins": margins,
               "launches": launches, "positions": int(batch["lengths"][0]),
               "layers": cfg.lm.num_hidden_layers}
    dist.barrier()
    return out


def s_leaf_norms(got: dict, want: dict) -> dict:
    """{leaf: (||got - want||, ||want||)} in fp32."""
    return {k: (float((got[k].float() - w.float()).norm()), float(w.float().norm()))
            for k, w in want.items()}


def s_train7b(ctx):
    """(b) One stage-2 step's loss and gradients of TokenPacker-7b at 2 LM
    layers on tp = 2 (dp = 1 on two ranks) and on one rank."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.data.dataset import SupervisedDataset, collate
    from tokenpacker_tpu_torch.models.vlm import vlm_loss
    from tokenpacker_tpu_torch.parallel import dryrun
    from tokenpacker_tpu_torch.parallel.mesh import make_mesh
    from tokenpacker_tpu_torch.parallel.sharding import (
        placement,
        shard_params,
        sync_grads,
        unshard_leaf,
    )
    from tokenpacker_tpu_torch.train.step import leaves_with_paths
    from tokenpacker_tpu_torch.train.trainer import device_train_batch

    cfg, device = s_config("train7b"), ctx["device"]
    mesh = make_mesh(tp=2, device=device, backend=ctx["backend"])
    work = tempfile.mkdtemp(prefix=f"card-train-{ctx['rank']}-")
    data_path, img_dir = dryrun.write_dataset(work, 2)
    ds = SupervisedDataset(data_path, dryrun.WordTokenizer(), image_folder=img_dir,
                           image_size=cfg.vision.image_size)
    batch = device_train_batch(collate([ds[0], ds[1]], cfg.tokens_per_view, 3, 4, 0, pad_to=256),
                               cfg.dtype, device)

    def grads_of(params, m):
        named = [(".".join(map(str, p)), t) for p, t in leaves_with_paths(params)
                 if p[0] != "vision"]
        for _, t in named:
            t.requires_grad_(True)
        with m if m is not None else contextlib.nullcontext():
            loss, metrics = vlm_loss(params, cfg, batch)
            g = torch.autograd.grad(loss, [t for _, t in named])
            g = sync_grads(g, [t for _, t in named], m)
        return float(metrics["loss"]), {k: unshard_leaf(x, placement(t)).float().cpu()
                                        for (k, t), x in zip(named, g)}

    params = s_weights(cfg, 2, device, int8=False)
    sharded = shard_params(params, mesh, cfg)
    (loss, got), launches = s_counted(lambda: grads_of(sharded, mesh))
    del sharded
    out = {}
    if ctx["rank"] == 0:
        ref_loss, want = grads_of(params, None)
        out = {"loss": loss, "ref_loss": ref_loss, "norms": s_leaf_norms(got, want),
               "launches": launches}
    shutil.rmtree(work, ignore_errors=True)
    dist.barrier()
    return out


def s_pipeline7b(ctx):
    """(c) The pipeline at pp = 2 over a 7B-width stack of 4 layers, forward
    and backward of mean(h^2), and the stack on one rank; every rank
    holds its own layers to its own single-rank run."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.io.weights import init_lm_on_device
    from tokenpacker_tpu_torch.parallel import dryrun
    from tokenpacker_tpu_torch.parallel.pipeline import make_pp_mesh

    cfg, device = s_config("pipeline7b"), ctx["device"]
    lm = cfg.lm
    mesh = make_pp_mesh(pp=2, dp=1, device=device, backend=ctx["backend"])
    params = init_lm_on_device(lm, 4, device, cfg.dtype)
    b, t = 4, 512
    x = (torch.randn((b, t, lm.hidden_size), generator=torch.Generator().manual_seed(5))
         .to(device=device, dtype=cfg.dtype))
    (loss, got), launches = s_counted(lambda: dryrun.pipeline_grads(params, lm, x, mesh, 2,
                                                                    device))
    ref_loss, want = dryrun.reference_stack_grads(params, lm, x, device)
    mine = {k: (float((g.float() - want[k].float()).norm()), float(want[k].float().norm()))
            for k, g in got.items() if k.startswith("layers")}
    everything = [None] * ctx["n"]
    dist.all_gather_object(everything, mine)
    out = {}
    if ctx["rank"] == 0:
        norms = {}
        for part in everything:
            norms.update(part)
        heads = {k: (float((g.float() - want[k].float()).norm()), float(want[k].float().norm()))
                 for k, g in got.items() if not k.startswith("layers")
                 and float(want[k].float().norm()) > 0}
        out = {"loss": float(loss.detach()), "ref_loss": float(ref_loss.detach()),
               "norms": {**norms, **heads}, "launches": launches,
               "shape": [b, t, lm.hidden_size], "layers": lm.num_hidden_layers}
    dist.barrier()
    return out


def s_ring(ctx):
    """(d) Ring attention over two ranks at [1, 4096, 32, 128] bf16 (causal),
    and K2's causal attention on one rank."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.ring_attention import ring_attention
    from tokenpacker_tpu_torch.parallel import comm
    from tokenpacker_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    device, n = ctx["device"], ctx["n"]
    shape = (1, 4096, 32, 128)
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g).to(device=device, dtype=torch.bfloat16)
               for _ in range(3))
    mesh = make_mesh(dp=n, tp=1, device=device, backend=ctx["backend"])
    ax = mesh.axis(DATA_AXIS)
    mine = [x.chunk(n, dim=1)[ax.index].contiguous() for x in (q, k, v)]
    got = comm.all_gather(ring_attention(*mine, mesh, "data", True), 1, ax)
    out = {}
    if ctx["rank"] == 0:
        want = flash_attention(q, k, v, True)[0]
        out = {"got": got.cpu(), "want": want.cpu(), "shape": list(shape)}
    dist.barrier()
    return out


def s_margin_at(params, cfg, prompt: list, toks: list, j: int, device,
                against: int | None = None) -> float:
    """The top-2 margin of one rank's logits for token j after `prompt` and
    toks[:j] (teacher-forced); with `against`, the top logit less that
    token's."""
    from tokenpacker_tpu_torch.generate import device_batch, prefill
    from tokenpacker_tpu_torch.parallel import dryrun

    seq = list(prompt) + list(toks[:j])
    b = dryrun.text_request(seq)
    logits, _ = prefill(params, cfg, device_batch(b, cfg.dtype, device), len(seq) + 1)
    logits = logits.float()
    if against is not None:
        return float(logits[0].max() - logits[0, against])
    top2 = logits.topk(2, dim=-1).values
    return float(top2[0, 0] - top2[0, 1])


def s_batcher7b(ctx):
    """(e) The paged batcher scenario over HD-7b int8 (fused) at 2 layers,
    tp = 2, pages of 16, chunks of 32, and the same on one rank; where a
    token differs, the one-rank margin there."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.parallel import dryrun
    from tokenpacker_tpu_torch.parallel.mesh import make_mesh
    from tokenpacker_tpu_torch.parallel.sharding import shard_params

    cfg, device = s_config("batcher7b"), ctx["device"]
    mesh = make_mesh(tp=2, device=device, backend=ctx["backend"])
    params = s_weights(cfg, 3, device, int8=True)
    rng = np.random.default_rng(3)
    v = min(cfg.lm.vocab_size, 32000)
    prompts = ([1] + rng.integers(3, v, 39).tolist(), [1] + rng.integers(3, v, 47).tolist())
    kw = dict(page_size=16, chunk=32, prompts=prompts, new=12)
    leader = ctx["rank"] == 0
    got, launches = s_counted(lambda: dryrun.batcher_scenario(
        shard_params(params, mesh, cfg), cfg, device, leader, **kw))
    out = {}
    if leader:
        ref = dryrun.batcher_scenario(params, cfg, device, True, **kw)
        margins = {}
        for key, prompt in (("cold", prompts[0]), ("warm", prompts[0]), ("other", prompts[0]),
                            ("cancelled", prompts[1])):
            diff = [j for j, (a, b) in enumerate(zip(got[key], ref[key])) if a != b]
            if diff:
                margins[key] = (diff[0], s_margin_at(params, cfg, prompt, ref[key], diff[0],
                                                     device))
        out = {"got": got, "ref": ref, "margins": margins, "launches": launches}
    dist.barrier()
    return out


def s_lora7b(ctx):
    """(g) Multi-LoRA serving over the tp = 2 tree: HD-7b's LM int8 (fused)
    at 8 of its 32 layers, two adapters over all seven targets at full
    width (ranks 16 and 8, seed 0), `dryrun.serve_adapters`' four text
    requests (ad_a, ad_b beside it, the base, ad_a again on ad_a's prompt;
    16 greedy tokens each) through `ContinuousBatcher` and
    `PagedContinuousBatcher` (pages of 16, prefix cache, chunks of 32), and
    the base request through each with no adapter loaded; rank 0 also the
    single-process greedy tokens and margins of each (prompt, adapter),
    and where ad_a's stream first leaves the base's, ad_a's top logit less
    that of the base's token there."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.parallel import dryrun
    from tokenpacker_tpu_torch.parallel.mesh import make_mesh
    from tokenpacker_tpu_torch.parallel.sharding import shard_params
    from tokenpacker_tpu_torch.serve.multi_lora import Adapter, SlotLora

    t0 = time.perf_counter()
    cfg, device = s_config("lora7b"), ctx["device"]
    mesh = make_mesh(tp=2, device=device, backend=ctx["backend"])
    params = s_weights(cfg, 4, device, int8=True)
    adapters = {n: Adapter(lora, r) for n, (lora, r) in dryrun.lora_adapters(
        cfg.lm, SEED, S_LORA_RANKS, S_LORA_SCALES).items()}
    rng = np.random.default_rng(4)
    v = min(cfg.lm.vocab_size, 32000)
    prompts = tuple([1] + rng.integers(3, v, n - 1).tolist() for n in S_LORA_PROMPTS)
    leader = ctx["rank"] == 0
    sharded = shard_params(params, mesh, cfg)
    got, launches = {}, {}
    for kind in ("dense", "paged"):
        got[kind], launches[kind] = s_counted(lambda kind=kind: dryrun.lora_batcher_scenario(
            sharded, cfg, kind, adapters, device, leader, prompts=prompts, new=S_NEW_TOKENS,
            **S_LORA_SIZES))
        alone = dryrun.lora_batcher_scenario(sharded, cfg, kind, None, device, leader,
                                             prompts=prompts, new=S_NEW_TOKENS, **S_LORA_SIZES)
        got[kind + " no adapter"] = alone and alone["tokens"][0]
    sharded_s = time.perf_counter() - t0
    out = {}
    if leader:
        sl = SlotLora(params, cfg, adapters, 1, dtype=cfg.dtype)
        refs = {name: s_greedy_with_margins(sl.prefill_params(params, name), cfg,
                                            dryrun.text_request(prompt), S_NEW_TOKENS, device)
                for prompt, name in ((prompts[0], "ad_a"), (prompts[1], "ad_b"),
                                     (prompts[0], None))}
        ad_a, base = refs["ad_a"][0], refs[None][0]
        j = next((i for i, (x, y) in enumerate(zip(ad_a, base)) if x != y), None)
        gap = None if j is None else s_margin_at(sl.prefill_params(params, "ad_a"), cfg,
                                                 prompts[0], ad_a, j, device, against=base[j])
        out = {"got": got, "refs": refs, "launches": launches, "sharded_s": sharded_s,
               "layers": cfg.lm.num_hidden_layers, "prompts": [len(p) for p in prompts],
               "leaves": (j, gap)}
    dist.barrier()
    return out


S_RUNNERS = {"hd13b": s_hd13b, "train7b": s_train7b, "pipeline7b": s_pipeline7b,
             "ring": s_ring, "batcher7b": s_batcher7b, "lora7b": s_lora7b}


def s_hd13b_length() -> int:
    """The prompt length of phase 35 (a)'s HD request (HD-13b, 2 x 2 crops
    and the global view)."""
    return int(s_hd_batch(s_config("hd13b"), 0)["token_ids"].shape[1])


def rank_kernel_rows(device, case, every_case) -> dict:
    """Phase 3's per-rank rows (configuration S): each kernel at the shapes
    one rank of a tp = 2 run gives it. K2's forward at 13B's 20 heads
    (phase 35 (a)'s HD prefill, [1, L, 20, 128]) and 7B's 16 ([2, 256, 16,
    128], (b)'s step; [1, 40|48, 16, 128], (g)'s admissions), K2's
    backward at 16, K3 at 20 heads over (a)'s cache at its last decode
    step and at 16 over (g)'s dense batcher's two slots at theirs, K5 at
    16 kv heads over (e)'s pool and (g)'s (bf16, pages of 16); each held
    and timed as its phase-3 row is, every case with its own times.
    Returns {kernel-line name: row}."""
    from tokenpacker_tpu_torch.ops import decode_attention as k3
    from tokenpacker_tpu_torch.ops import flash_attention as k2
    from tokenpacker_tpu_torch.ops import paged_attention as k5
    from tokenpacker_tpu_torch.parallel import dryrun

    rows = {}
    l13 = s_hd13b_length()
    fwd = []
    for n, t, h in ((1, l13, 20), (2, 256, 16)) + tuple((1, t, 16) for t in S_LORA_PROMPTS):
        q, kk, vv = (bf16((n, t, h, 128), 50 + i, device) for i in range(3))
        fwd.append(case(
            f"K2 flash causal q[{n},{t},{h},128] (one rank of tp 2)", k2.flash_attention,
            k2.flash_attention_plain, (q, kk, vv, True), check=compare_flash_fwd,
            library=lambda q=q, kk=kk, vv=vv: sdpa(q, kk, vv, is_causal=True),
            work=(4 * n * t * h * 128 * 2 + n * h * t * 4, 4 * n * h * 128 * t * (t + 1) / 2),
            achieved="ops"))
    rows["flash_attention_rank"] = every_case(fwd)

    n, t, h, d = 2, 256, 16, 128
    q, k, v, do = (bf16((n, t, h, d), 60 + i, device) for i in range(4))
    o, lse = k2.flash_attention(q, k, v, True)
    tag = f"K2-bwd flash causal q[{n},{t},{h},{d}] (one rank of tp 2)"
    got = k2.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = k2.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    err = max(compare_tiles(f"{tag} {name}", g, w)
              for g, w, name in zip(got, want, ("dq", "dk", "dv")))
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    dol = do.transpose(1, 2)
    ms = time_ms(lambda: k2.flash_attention_bwd(q, k, v, o, lse, do, True))
    plain_ms = time_ms(lambda: k2.flash_attention_bwd_plain(q, k, v, o, lse, do, True))
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True))
    pairs, elems = n * h * t * (t + 1) / 2, n * t * h * d
    b_ms, b_by = bound(8 * elems * 2 + n * h * t * 4, 5 * 2 * d * pairs)
    print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (SDPA "
          f"backward), bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of the kernel's time)")
    rows["flash_attention_bwd_rank"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                                        "case": tag}
    del q, k, v, do, o, lse, got, want, ql, kl, vl, out

    # K3 at (a)'s last decode step (the prompt [0, L) and the span [L, L +
    # 15)) and at (g)'s dense batcher's (2 slots of 128 positions, both
    # prompts and 15 decoded rows); the lossy version drops the decoded rows
    dec = []
    pl = torch.tensor(S_LORA_PROMPTS, dtype=torch.int32, device=device)
    for n, h, s, lengths, span, tag in (
            (1, 20, -(-(l13 + S_NEW_TOKENS) // 8) * 8,
             torch.tensor([l13], dtype=torch.int32, device=device), l13, ""),
            (2, 16, S_LORA_SIZES["max_seq_len"], pl + S_NEW_TOKENS - 1, 0,
             ", (g)'s dense batcher")):
        q = bf16((n, h, 128), 70, device)
        ck, cv = bf16((n, s, h, 128), 71, device), bf16((n, s, h, 128), 72, device)
        needed = lengths + S_NEW_TOKENS - 1 if span else lengths
        prompt = lengths if span else pl
        keys = int(needed.sum())
        mask = (torch.arange(s, device=device) < needed[:, None])[:, None, None, :]
        args = (q, ck, cv, lengths, needed, span)
        keys_at = f"span [{span}, {keys})" if span else f"lengths {needed.tolist()}"
        dec.append(case(
            f"K3 decode q[{n},{h},128] cache S={s} {keys_at}{tag} (one rank of tp 2)",
            k3.decode_attention, k3.decode_attention_plain, args,
            library=lambda q=q, ck=ck, cv=cv, mask=mask: sdpa(q[:, None], ck, cv,
                                                              attn_mask=mask),
            work=(2 * keys * h * 128 * 2 + 2 * n * h * 128 * 2 + 8 * n, 4 * keys * h * 128),
            check=lambda name, out, want, args=args, prompt=prompt: compare_rows(
                name, out, want, k3.decode_attention_plain(*args[:3], prompt, prompt, args[5])),
            graph=True, library_graph=True, achieved="bytes"))
        del q, ck, cv, args
    rows["decode_attention_rank"] = every_case(dec)

    # K5 over (e)'s pool (16 blocks a sequence) and (g)'s (64 pages, 8
    # blocks a sequence): 2 sequences, pages of 16, 16 kv heads, bf16
    paged = []
    h, d, ps = 16, 128, 16
    for n, mp, pages, lens, seed, tag in (
            (2, 16, 33, (52, 61), SEED + 9, ""),
            (2, S_LORA_SIZES["max_seq_len"] // ps, 64,
             tuple(t + S_NEW_TOKENS - 1 for t in S_LORA_PROMPTS), SEED + 10,
             " of a pool of 64 pages, (g)'s paged batcher")):
        lens = torch.tensor(lens, dtype=torch.int32, device=device)
        dropped = lens - ((lens - 1) % ps + 1)
        g = torch.Generator(device=device).manual_seed(seed)
        table = (torch.randperm(pages - 1, generator=g, device=device)[:n * mp] + 1).view(
            n, mp).int()
        kp, vp = (torch.randn((pages, ps, h, d), generator=g, device=device).bfloat16()
                  for _ in range(2))
        kd, vd = (x[table.long()].view(n, -1, h, d) for x in (kp, vp))
        valid = torch.arange(mp * ps, device=device)[None, :] < lens[:, None]
        q = bf16((n, h, d), 73, device)
        args = (q, kp, vp, table, lens, None, None)
        keys = int(lens.sum())
        paged.append(case(
            f"K5 paged_attention q[{n},{h},{d}] pages of {ps} x {mp} blocks{tag}, {h} kv "
            f"heads, bf16 pool, {keys} valid keys (one rank of tp 2)",
            k5.paged_attention, k5.paged_attention_plain, args,
            library=lambda q=q, kd=kd, vd=vd, valid=valid: sdpa(
                q[:, None], kd, vd, attn_mask=valid[:, None, None, :]),
            work=(2 * keys * h * d * 2 + 2 * n * h * d * 2 + table.numel() * 4 + n * 4,
                  4 * keys * h * d),
            check=lambda name, out, want, args=args, dropped=dropped: compare_rows(
                name, out, want, k5.paged_attention_plain(*args[:4], dropped, *args[5:])),
            graph=True, library_graph=True, achieved="bytes"))
        del kp, vp, kd, vd, q, args
    rows["paged_attention_rank"] = every_case(paged)
    torch.cuda.empty_cache()
    return rows


# one rank's [K, N] of Vicuna-13B's products at tp = 2: the column-parallel
# qkv and gateup keep half their columns, the row-parallel o and down half
# their rows
RANK_13B_SHAPES = {"qkv/2": (5120, 7680), "o/2": (2560, 5120), "gateup/2": (5120, 13824),
                   "down/2": (6912, 5120)}


def rank_quantized_cases(device, case) -> dict:
    """Phase 3, K7 at M = 8 and K8 at M = 256 on one rank's share of
    Vicuna-13B's products (`RANK_13B_SHAPES`), held bit for bit and timed
    as their phase-3 cases are. Returns {kernel name: [case rows]}."""
    from tokenpacker_tpu_torch.ops import q8_matmul as k7
    from tokenpacker_tpu_torch.ops import s8_gemm as k8
    from tokenpacker_tpu_torch.ops.quantize import quantize_int8

    g = torch.Generator(device=device).manual_seed(SEED + 12)
    out = {"s8_matmul": [], "s8_gemm": []}
    for name, (k, n) in RANK_13B_SHAPES.items():
        wq, ws = quantize_int8(torch.randn((k, n), generator=g, device=device) * 0.02)
        x = torch.randn((256, k), generator=g, device=device).bfloat16()
        xq8, _ = k7.quantize_activations(x[:8])
        out["s8_matmul"].append(case(
            f"K7 s8_matmul 13B {name} xq[8,{k}] wq[{k},{n}] (one rank of tp 2)", k7.s8_matmul,
            k7.s8_matmul_plain, (xq8, wq), library=int_mm_call(xq8, wq), rate=INT8_OPS_PER_S,
            graph=True, work=(8 * k + k * n + 8 * n * 4, 2 * 8 * k * n),
            check=lambda nm, got, want, xq=xq8, wq=wq: compare_exact(
                nm, got, want, k7.s8_matmul_plain(xq[:, :-128], wq[:-128]))))
        xq, _ = k7.quantize_activations(x)
        out["s8_gemm"].append(case(
            f"K8 s8_gemm 13B {name} x[256,{k}] wq[{k},{n}] (one rank of tp 2)", k8.s8_gemm,
            k8.s8_gemm_plain, (x, wq, ws), library=int_mm_call(xq, wq), rate=INT8_OPS_PER_S,
            work=(256 * k * 2 + k * n + n * 4 + 256 * n * 2, 2 * 256 * k * n),
            check=lambda nm, got, want, args=(x, wq, ws): compare_s8_gemm(nm, *args),
            graph=True, library_graph=True, achieved="ops"))
        del wq, ws, x, xq, xq8
    torch.cuda.empty_cache()
    return out


def native_check() -> None:
    """Phase 35 (f): the port's native preprocessing library built here
    with g++ (`image/native`), held against the plain numpy resize and
    normalization, numpy's HD slicing and PIL's JPEG decode (or, built
    without libjpeg, `load_image`'s PIL path), with the host times of the
    native and the plain resize."""
    from tokenpacker_tpu_torch.image import native

    # built into a directory of its own and loaded for this check only: a
    # library left in the package's build directory would send every later
    # process's slice_image and load_image through it
    saved, build_dir = native._LIB, tempfile.mkdtemp(prefix="native-")
    native._LIB = None
    try:
        native_check_in(build_dir)
    finally:
        native._LIB = saved
        shutil.rmtree(build_dir, ignore_errors=True)


def native_check_in(build_dir: str) -> None:
    import io

    from PIL import Image

    from tokenpacker_tpu_torch.image import hd_tiler, native
    from tokenpacker_tpu_torch.image.io import load_image

    t0 = time.perf_counter()
    path = native.build(build_dir)
    native.load(build_dir)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    img = rng.standard_normal((3, 1008, 1008)).astype(np.float32)
    got, want = native.resize_bilinear(img, 672, 1008), hd_tiler._resize_bilinear(img, 672, 1008)
    resize_err = float(np.abs(got - want).max())
    nat_ms = statistics.median(timed(lambda: native.resize_bilinear(img, 672, 1008))
                               for _ in range(5))
    np_ms = statistics.median(timed(lambda: hd_tiler._resize_bilinear(img, 672, 1008))
                              for _ in range(3))
    u8 = rng.integers(0, 255, (600, 900, 3), dtype=np.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    norm_want = ((u8.astype(np.float32) / 255.0 - np.asarray(mean, np.float32))
                 / np.asarray(std, np.float32)).transpose(2, 0, 1)
    norm_err = float(np.abs(native.normalize_u8(u8, mean, std) - norm_want).max())
    tiled = rng.standard_normal((3, 600, 1100)).astype(np.float32)
    crops, hb, wb = hd_tiler.slice_image(tiled)
    plain, hb2, wb2 = hd_tiler.slice_image(tiled, use_native=False)
    slice_err = float(np.abs(crops - plain).max()) if crops.shape == plain.shape else np.inf
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=95)
    with tempfile.TemporaryDirectory() as tmp:
        jpg = Path(tmp) / "x.jpg"
        jpg.write_bytes(buf.getvalue())
        pil = np.asarray(Image.open(jpg).convert("RGB"))
        if native.jpeg_available():
            jpeg_err = float(np.mean(np.abs(native.decode_jpeg(jpg.read_bytes()).astype(int)
                                            - pil.astype(int))))
            jpeg = f"libjpeg decode vs PIL mean |diff| {jpeg_err:.4f} (limit 1)"
        else:
            jpeg_err = float(np.mean(np.abs(np.asarray(load_image(str(jpg))).astype(int)
                                            - pil.astype(int))))
            jpeg = ("built without libjpeg (no jpeglib.h on this machine): load_image takes "
                    f"PIL, mean |diff| {jpeg_err:.4f}")
    print(f"  (f) native library {path.name} built in {built:.2f} s (g++); resize [3,1008,1008] "
          f"-> 672x1008 max |diff| {resize_err:.2e} vs the plain resize (limit 1e-4), native "
          f"{nat_ms:.2f} ms vs numpy {np_ms:.2f} ms (host, 4 threads); normalize max |diff| "
          f"{norm_err:.2e} (limit 1e-5); HD slice {hb}x{wb} max |diff| {slice_err:.2e} (limit "
          f"2e-4); {jpeg}")
    if not (resize_err <= 1e-4 and norm_err <= 1e-5 and slice_err <= 2e-4 and jpeg_err < 1.0
            and (hb, wb) == (hb2, wb2)):
        raise AssertionError("phase 35 (f): the native library disagrees with its references")


def check_lora7b(g: dict) -> list:
    """Phase 35 (g)'s checks and its line; returns the failures (a token
    that differs where the reference's margin is decisive raises)."""
    failures, agree, total, each = [], 0, 0, []
    order = ("ad_a", "ad_b", None, "ad_a")  # `dryrun.serve_adapters`' four requests
    for kind in ("dense", "paged"):
        run = g["got"][kind]
        for i, name in enumerate(order):
            ref, margins = g["refs"][name]
            each.append(decisive_agree(f"phase 35 (g) {kind} request {i} ({name or 'base'})",
                                       run["tokens"][i], ref, margins))
            agree += each[-1]
            total += len(ref)
        if run["tokens"][2] != g["got"][kind + " no adapter"]:
            failures.append(f"(g) {kind}: the base request {run['tokens'][2]} differs from the "
                            f"run with no adapter {g['got'][kind + ' no adapter']}")
        if run["tokens"][2] in (run["tokens"][0], run["tokens"][3]):
            failures.append(f"(g) {kind}: ad_a's tokens equal the base request's "
                            f"{run['tokens'][2]}")
        need = (("flash_attention_rank", "decode_attention_rank") if kind == "dense"
                else ("paged_attention_rank",))
        failures += [f"(g) {kind}: {n} never launched" for n in need
                     if g["launches"][kind][n] == 0]
    paged = g["got"]["paged"]
    if not (paged["reused"][0] == 0 < paged["reused"][1] and paged["leaked"] == 0):
        failures.append(f"(g) paged: prefix tokens reused {paged['reused']} (base, ad_a's "
                        f"repeat), pages leaked {paged['leaked']}")
    j, gap = g["leaves"]
    if j is None or not gap > LOGIT_BAND:
        failures.append(f"(g) on one rank ad_a's stream leaves the base's at token {j} by a "
                        f"logit gap of {gap}, not above LOGIT_BAND")
    least = min(min(m) for _, m in g["refs"].values())
    print(f"  (g) multi-LoRA serving, HD-7b int8 {g['layers']} layers, tp 2, adapters of rank "
          f"{S_LORA_RANKS['ad_a']} and {S_LORA_RANKS['ad_b']} and the base, prompts "
          f"{g['prompts']}, {S_NEW_TOKENS} tokens each: {agree}/{total} tokens equal to one "
          f"rank's before a first difference within the band (dense then paged, per request "
          f"{each}; least margin {least:.4f}); on one rank ad_a leaves the "
          f"base at token {j} by a logit gap of {gap}; base == no adapter loaded "
          f"(dense {g['got']['dense']['tokens'][2] == g['got']['dense no adapter']}, paged "
          f"{paged['tokens'][2] == g['got']['paged no adapter']}); paged prefix tokens reused "
          f"{paged['reused']} (base, ad_a's repeat), pages leaked {paged['leaked']}; sharded "
          f"runs {g['sharded_s']:.1f} s; launches on rank 0 {g['launches']}")
    return failures


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def nccl_world_of_one(device) -> None:
    """The NCCL path at a world of one through the same entry points
    (`make_mesh`, `ring_attention`, `comm`): ring attention over one rank
    against K2 causal, block by block."""
    import torch.distributed as dist

    from tokenpacker_tpu_torch.ops.flash_attention import flash_attention
    from tokenpacker_tpu_torch.ops.ring_attention import ring_attention
    from tokenpacker_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(tp=1, device=device)
        t = torch.arange(8.0, device=device)
        dist.all_reduce(t)
        q, k, v = (bf16((1, 1024, 32, 128), 80 + i, device) for i in range(3))
        with torch.no_grad():
            got = ring_attention(q, k, v, mesh, "data", True)
            want = flash_attention(q, k, v, True)[0]
        print(f"  NCCL world of one ({mesh.backend}): all_reduce {t.tolist() == list(range(8))}; "
              "ring_attention over 1 rank vs K2 causal:")
        compare_tiles("ring_attention [1,1024,32,128] world of one", got, want)
    finally:
        dist.destroy_process_group()


def phase_parallel(device, card: str) -> dict:
    """Phase 35, configuration S: the sharded programs as two ranks on the
    one card. NCCL refuses two ranks on one device ("Duplicate GPU
    detected"), so the ranks run a gloo group whose CUDA tensors
    `parallel/comm` stages through pinned host memory (`--backend gloo`,
    named explicitly; the phase first asks NCCL and prints its answer,
    which chooses nothing); compute stays on the card, in the port's
    kernels. The two ranks are this script spawned twice with `--rank`
    (`dryrun.launch(script=...)`, `--device cuda --one-device --backend
    gloo`), each running the scenarios of `S_RUNNERS`, rank 0 also the
    single-process work each is held to:
    (a) HD-13b int8 (fused) at 8 of its 40 layers, one HD request (2 x 2
        crops and the global view): HD prefill and 16 greedy tokens at
        tp = 2 through `Generator` (K1, K2 at 20 heads, K3 at 20 heads), the
        tokens equal the single-process run's wherever its margin exceeds
        LOGIT_BAND;
    (b) TokenPacker-7b at 2 LM layers: one stage-2 step at tp = 2 (dp = 1),
        the loss within LOSS_BAND and every trained leaf's gradient within
        its group's band (phase 9's measure, against the single-process
        bf16 step);
    (c) the pipeline at pp = 2 over a 7B-width stack of 4 layers, forward
        and backward of mean(h^2) over [4, 512, 4096], loss within
        LOSS_BAND and each leaf's gradient within the LM's band;
    (d) ring attention at [1, 4096, 32, 128] bf16 (causal) against K2, per
        64-position block (`compare_tiles`);
    (e) the paged batcher scenario (`__graft_entry__`'s cold, warm,
        cancelled, concurrent; prefix hit, no page leaked) over HD-7b int8
        (fused) at 2 layers, pages of 16, chunks of 32: tokens equal the
        single-process run's wherever its margin exceeds LOGIT_BAND;
    (f) the native library (`native_check`);
    (g) multi-LoRA serving over HD-7b int8 (fused) at 8 layers, tp = 2:
        two adapters (ranks 16 and 8) and the base model through the dense
        and the paged batcher (`s_lora7b`); each request's tokens equal
        the single-process run's with its adapter wherever its margin
        exceeds LOGIT_BAND, the base request's equal a run with no adapter
        loaded, ad_a's differ from the base's (and on one rank leave them by
        a logit gap above LOGIT_BAND), and on the paged batcher the base
        takes none of ad_a's cached pages, ad_a's repeat takes them, and no
        page leaks;
    and the NCCL path at a world of one (`nccl_world_of_one`). Launches
    counted on rank 0 from 0 just before each sharded run and read just
    after: {kernel-line name: launches}."""
    from tokenpacker_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    print(f"phase 35: configuration S, the sharded programs as 2 ranks on one card ({card})")
    native_check()
    nccl_world_of_one(device)
    try:
        dryrun.launch(2, ["--device", "cuda", "--one-device", "--backend", "nccl",
                          "--scenarios", "probe"], 120)
        nccl = "accepted"
    except RuntimeError as e:
        found = re.search(r"Duplicate GPU detected[^\n]*", str(e))
        nccl = f"refused ({found.group(0) if found else str(e).splitlines()[0]})"
    print(f"  NCCL with two ranks on cuda:0: {nccl}")
    print("  transport: gloo (named: --backend gloo), CUDA tensors staged through pinned host "
          "memory; compute on cuda:0 in both ranks")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "s.pt"
        log = dryrun.launch(2, ["--device", "cuda", "--one-device", "--backend", "gloo",
                                "--scenarios", ",".join(S_RUNNERS), "--out", str(out)],
                            PARALLEL_TIMEOUT, script=__file__)[0]
        res = torch.load(out, weights_only=False)
    print("  " + "\n  ".join(line for line in log.splitlines() if "s)" in line))

    a = res["hd13b"]
    agree = decisive_agree("phase 35 (a)", a["tokens"], a["ref_tokens"], a["ref_margins"])
    print(f"  (a) HD-13b int8, {a['layers']} layers, {a['positions']} positions, tp 2: tokens "
          f"{a['tokens'][:8]}..., {agree}/{len(a['ref_tokens'])} equal to one rank's "
          f"(least margin {min(a['ref_margins']):.4f}); launches on rank 0 {a['launches']}")
    b = res["train7b"]
    groups = {g: sum(n ** 2 for k, (_, n) in b["norms"].items() if k.startswith(g + ".")) ** 0.5
              for g in GRAD_REL_RMS_BANDS}

    def rel(k, diff, norm):
        group = groups[k.split(".")[0]]
        scale = group if k in ZERO_GRAD_LEAVES else max(norm, SMALL_LEAF_SHARE * group)
        return diff / scale

    b_rel = {k: rel(k, dn, n) for k, (dn, n) in b["norms"].items()}
    b_loss = abs(b["loss"] - b["ref_loss"]) / abs(b["ref_loss"])
    b_out = [k for k, r in b_rel.items() if not r <= GRAD_REL_RMS_BANDS[k.split(".")[0]]]
    worst = max(b_rel, key=b_rel.get)
    print(f"  (b) TokenPacker-7b, 2 LM layers, tp 2 step vs one rank: loss {b['loss']:.5f} vs "
          f"{b['ref_loss']:.5f} (relative {b_loss:.2e}, band {LOSS_BAND}); {len(b_rel)} leaves, "
          f"worst {worst} {b_rel[worst]:.4f}; launches on rank 0 {b['launches']}")
    c = res["pipeline7b"]
    c_rel = {k: dn / n for k, (dn, n) in c["norms"].items()}
    c_loss = abs(c["loss"] - c["ref_loss"]) / abs(c["ref_loss"])
    c_worst = max(c_rel, key=c_rel.get)
    print(f"  (c) pipeline pp 2, {c['layers']} layers of 7B width, x {c['shape']}: loss "
          f"{c['loss']:.6f} vs {c['ref_loss']:.6f} (relative {c_loss:.2e}); {len(c_rel)} leaves, "
          f"worst {c_worst} {c_rel[c_worst]:.4f} (band {GRAD_REL_RMS_BANDS['lm']}); launches on "
          f"rank 0 {c['launches']}")
    d = res["ring"]
    print(f"  (d) ring attention {d['shape']} bf16 over 2 ranks vs K2 causal:")
    compare_tiles("ring_attention [1,4096,32,128] 2 ranks", d["got"].to(device),
                  d["want"].to(device))
    e = res["batcher7b"]
    got, ref = e["got"], e["ref"]
    print(f"  (e) paged batcher, HD-7b int8 2 layers, tp 2: cold {got['cold']}, cancelled after "
          f"{len(got['cancelled'])}, prefix tokens reused {got['reused']}, pages leaked "
          f"{got['leaked']} (one rank: {ref['reused']}, {ref['leaked']}); first differences "
          f"(token, one rank's margin) {e['margins'] or 'none'}; launches on rank 0 "
          f"{e['launches']}")
    failures = []
    if not b_loss <= LOSS_BAND or b_out:
        failures.append(f"(b) loss {b_loss}, leaves outside their band {b_out}")
    if not c_loss <= LOSS_BAND or not c_rel[c_worst] <= GRAD_REL_RMS_BANDS["lm"]:
        failures.append(f"(c) loss {c_loss}, worst leaf {c_worst} {c_rel[c_worst]}")
    for key, (j, margin) in e["margins"].items():
        if margin > LOGIT_BAND:
            failures.append(f"(e) {key} differs at token {j}, one rank's margin {margin}")
    if not (got["reused"] > 0 and got["leaked"] == 0 and ref["leaked"] == 0
            and len(got["cancelled"]) >= 2):
        failures.append(f"(e) reused {got['reused']}, leaked {got['leaked']}")
    launches = {}
    for r in (a, b, c, e):
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    for name, need in (("flash_attention_rank", a), ("decode_attention_rank", a),
                       ("flash_attention_bwd_rank", b), ("paged_attention_rank", e)):
        if need["launches"][name] == 0:
            failures.append(f"{name} never launched in its sharded run")
    failures += check_lora7b(res["lora7b"])
    for counts in res["lora7b"]["launches"].values():
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    if failures:
        raise AssertionError("phase 35: " + "; ".join(failures))
    print(f"  phase 35 took {time.perf_counter() - t0:.1f} s")
    release_earlier_phases()
    return launches


# each kernel's source in the port and the TPU kernel it replaces (the kernels line)
KERNEL_META = {
    "vit_attention": ("tokenpacker_tpu_torch/csrc/vit_attention.cu",
                      "tokenpacker_tpu/ops/vit_attention.py:75"),
    "flash_attention": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                        "tokenpacker_tpu/ops/flash_attention.py:183"),
    "decode_attention": ("tokenpacker_tpu_torch/csrc/decode_attention.cu",
                         "tokenpacker_tpu/ops/decode_attention.py:120"),
    "fused_decode": ("tokenpacker_tpu_torch/csrc/fused_decode.cu",
                     "tokenpacker_tpu/ops/fused_decode.py:1295"),
    "flash_attention_bwd": ("tokenpacker_tpu_torch/csrc/flash_bwd.cu",
                            "tokenpacker_tpu/ops/flash_attention.py:356"),
    "paged_attention": ("tokenpacker_tpu_torch/csrc/paged_attention.cu",
                        "tokenpacker_tpu/ops/paged_attention.py:127"),
    "q4_matmul": ("tokenpacker_tpu_torch/csrc/q4_matmul.cu",
                  "tokenpacker_tpu/ops/q4_matmul.py:132"),
    "s8_matmul": ("tokenpacker_tpu_torch/csrc/s8_matmul.cu",
                  "tokenpacker_tpu/ops/q8_matmul.py:59"),
    "s8_gemm": ("tokenpacker_tpu_torch/csrc/s8_gemm.cu", "tokenpacker_tpu/ops/s8_gemm.py:108"),
    "vit_block": ("tokenpacker_tpu_torch/csrc/vit_block.cu",
                  "tokenpacker_tpu/ops/vit_block.py:125"),
    "fused_verify": ("tokenpacker_tpu_torch/csrc/fused_decode.cu",
                     "tokenpacker_tpu/ops/fused_decode.py:1390"),
    "fused_decode_lora": ("tokenpacker_tpu_torch/csrc/fused_decode.cu",
                          "tokenpacker_tpu/ops/fused_decode.py:1162"),
    "fused_verify_lora": ("tokenpacker_tpu_torch/csrc/fused_decode.cu",
                          "tokenpacker_tpu/ops/fused_decode.py:1390"),
    "flash_attention_bias": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                             "tokenpacker_tpu/ops/flash_attention.py:183"),
    "flash_attention_bias_bwd": ("tokenpacker_tpu_torch/csrc/flash_bwd.cu",
                                 "tokenpacker_tpu/ops/flash_attention.py:356"),
    "decode_attention_alibi": ("tokenpacker_tpu_torch/csrc/decode_attention.cu",
                               "tokenpacker_tpu/ops/decode_attention.py:120"),
    "flash_attention_full_bias": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                                  "tokenpacker_tpu/ops/flash_attention.py:183"),
    "dma_stride": ("tokenpacker_tpu_torch/csrc/stream_probes.cu",
                   "scripts/probe_dma_stride.py:74"),
    "int4_ring": ("tokenpacker_tpu_torch/csrc/stream_probes.cu",
                  "scripts/probe_int4_ring.py:76"),
    "bitcast_pack": ("tokenpacker_tpu_torch/csrc/stream_probes.cu",
                     "scripts/probe_bitcast_pack.py:34"),
    "bitcast_stream": ("tokenpacker_tpu_torch/csrc/stream_probes.cu",
                       "scripts/probe_bitcast_pack.py:133"),
    "stream_dtype": ("tokenpacker_tpu_torch/csrc/stream_probes.cu",
                     "scripts/probe_stream_dtype.py:68"),
    # configuration S: the same kernels at one rank's shapes of a tp = 2 run
    # (phase 3's per-rank rows), launched by phase 35's sharded runs
    "flash_attention_rank": ("tokenpacker_tpu_torch/csrc/flash_fwd.cu",
                             "tokenpacker_tpu/ops/flash_attention.py:183"),
    "flash_attention_bwd_rank": ("tokenpacker_tpu_torch/csrc/flash_bwd.cu",
                                 "tokenpacker_tpu/ops/flash_attention.py:356"),
    "decode_attention_rank": ("tokenpacker_tpu_torch/csrc/decode_attention.cu",
                              "tokenpacker_tpu/ops/decode_attention.py:120"),
    "paged_attention_rank": ("tokenpacker_tpu_torch/csrc/paged_attention.cu",
                             "tokenpacker_tpu/ops/paged_attention.py:127"),
}


def kernels_line(rows: dict, runs: list) -> str:
    """The kernels JSON line: each row of `rows` with its source, the TPU
    kernel it replaces and its launches summed over the main-path `runs`."""
    return json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1], "launches": sum(r.get(name, 0) for r in runs),
         **rows[name]} for name in KERNEL_META if name in rows]})


def ok_line() -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


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
    from tokenpacker_tpu_torch.ops import fused_decode as k4

    if hasattr(k4, "pdl_probe"):  # K4 launches with these attributes; a refusal fails its calls
        rc = k4.pdl_probe(device)
        print("phase 2: K4's launch attributes (thread-block cluster, programmatic dependent "
              f"launch): {'accepted' if rc == 0 else f'refused (error {rc})'}")

    if "--sampling" in sys.argv[1:]:
        hd_batch, _ = make_hd_requests(preset_config(HD_PRESET), SEED)
        runs = phase_sampling(device, SEED, hd_batch, card.splitlines()[0] if card else "")
        print(json.dumps({"launches": {name: sum(r.get(name, 0) for r in runs)
                                       for name in sampling_counters()}}))
        return
    if "--serving" in sys.argv[1:]:
        ckpt = write_phase28_checkpoint(device, SEED)
        ckpt["params"] = None
        try:
            runs = [phase_serving(device, SEED, ckpt["path"], card.splitlines()[0] if card
                                  else "")]
        finally:
            shutil.rmtree(ckpt["root"], ignore_errors=True)
        print(json.dumps({"launches": {name: sum(r.get(name, 0) for r in runs)
                                       for name in sampling_counters()}}))
        return
    if "--checkpoints" in sys.argv[1:]:
        hd_batch, hd_blocks = make_hd_requests(preset_config(HD_PRESET), SEED)
        rows = phase_kernels(device, hd_batch["lengths"], 0, (0, 0), "checkpoints")
        runs = [phase_checkpoint_load(device, SEED, hd_batch, hd_blocks),
                phase_checkpoint_layouts(device, SEED), phase_mpt_quantized(device, SEED)]
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if "--profile-train" in sys.argv[1:]:
        profile_train_step(device, SEED)
        return
    if "--splits" in sys.argv[1:]:
        split_sweep(device)
        return
    if "--profile-paged" in sys.argv[1:]:
        profile_paged_decode(device, SEED)
        return
    hd_cfg = preset_config(HD_PRESET)
    hd_batch, hd_blocks = make_hd_requests(hd_cfg, SEED)
    if "--profile" in sys.argv[1:]:
        profile_hd_decode(device, SEED, hd_batch)
        return
    if "--profile-quantized" in sys.argv[1:]:
        profile_hd_decode(device, SEED, hd_batch, four_bit=True)
        torch.cuda.empty_cache()
        profile_paged_decode(device, SEED, w8a8=True)
        return
    l = hd_batch["token_ids"].shape[1]
    s_hd = -(-(l + NEW_TOKENS) // 32) * 32  # generate.prefill's int8 cache length
    # the last decode step writes slot l + NEW_TOKENS - 2 and attends the
    # decoded span [l, l + NEW_TOKENS - 2) besides the prompt
    quantized = "--quantized" in sys.argv[1:]
    speculative = "--speculative" in sys.argv[1:]
    lora = "--lora" in sys.argv[1:]
    lora_train = "--lora-train" in sys.argv[1:]
    mpt = "--mpt" in sys.argv[1:]
    probes = "--probes" in sys.argv[1:]
    flash = "--flash" in sys.argv[1:]
    tower = "--tower" in sys.argv[1:]
    evals = "--eval" in sys.argv[1:]
    parallel = "--parallel" in sys.argv[1:]
    only = ("quantized" if quantized else "speculative" if speculative else "lora" if lora
            else "lora-train" if lora_train else "mpt" if mpt else "probes" if probes
            else "flash" if flash else "tower" if tower else "eval" if evals
            else "parallel" if parallel else "")
    rows = phase_kernels(device, hd_batch["lengths"], s_hd, (l, l + NEW_TOKENS - 2), only)
    if "--kernels" in sys.argv[1:]:
        return
    card_line = card.splitlines()[0] if card else ""
    if parallel:
        runs = [phase_parallel(device, card_line)]
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if only == "eval":
        ckpt = write_phase28_checkpoint(device, SEED)
        ckpt["params"] = None
        try:
            runs = [phase_eval(device, SEED, ckpt, card_line)]
        finally:
            shutil.rmtree(ckpt["root"], ignore_errors=True)
        print(kernels_line(rows, runs))
        print(ok_line())
        return
    if lora_train:
        ckpt = write_phase28_checkpoint(device, SEED)
        ckpt["params"] = None
        try:
            runs = [phase_qlora_train(device, SEED, ckpt, rows, card_line)]
        finally:
            shutil.rmtree(ckpt["root"], ignore_errors=True)
        phase_qlora_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if probes:
        rows.update(phase_probes(device))
        # no main path runs in this mode, so no launch count is read
        print(json.dumps(rows))
        return
    if flash:
        runs = [phase_train_stage1(device, SEED, rows)]
        phase_train_parity(device, SEED)
        runs.append(phase_mpt_train(device, SEED))
        phase_mpt_train_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if tower:
        runs = [phase_end_to_end(device, SEED)]
        phase_parity(device, SEED)
        runs.append(phase_train_stage1(device, SEED, rows))
        phase_train_parity(device, SEED)
        runs.append(phase_spec_serving(device, SEED))
        phase_spec_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if mpt:
        runs = [phase_mpt_serving(device, SEED)]
        phase_mpt_parity(device, SEED)
        runs.append(phase_mpt_train(device, SEED))
        phase_mpt_train_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if lora:
        runs = [phase_lora_serving(device, SEED)]
        phase_lora_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if speculative:
        runs = [phase_spec_serving(device, SEED)]
        phase_spec_parity(device, SEED)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    if quantized:
        runs = [phase_hd_4bit(device, SEED, hd_batch, hd_blocks)]
        phase_4bit_parity(device, SEED)
        runs.append(phase_paged_serving(device, SEED, w8a8=True))
        phase_paged_parity(device, SEED, w8a8=True)
        print(json.dumps({name: {**row, "launches": sum(r.get(name, 0) for r in runs)}
                          for name, row in rows.items()}))
        return
    # K2's full-bias form and the probes: no serving or training path
    # reaches them; counted over all of the main-path phases 4-23 and 25-34
    unreached = probe_counters()
    reset_counts(unreached)
    runs = [phase_end_to_end(device, SEED)]
    phase_parity(device, SEED)
    runs.append(phase_hd_int8(device, SEED, hd_batch, hd_blocks))
    phase_int8_parity(device, SEED)
    runs.append(phase_train_stage1(device, SEED, rows))
    phase_train_parity(device, SEED)
    runs.append(phase_paged_serving(device, SEED))
    phase_paged_parity(device, SEED)
    runs.append(phase_hd_4bit(device, SEED, hd_batch, hd_blocks))
    phase_4bit_parity(device, SEED)
    runs.append(phase_paged_serving(device, SEED, w8a8=True))
    phase_paged_parity(device, SEED, w8a8=True)
    runs.append(phase_spec_serving(device, SEED))
    phase_spec_parity(device, SEED)
    runs.append(phase_lora_serving(device, SEED))
    phase_lora_parity(device, SEED)
    runs.append(phase_mpt_serving(device, SEED))
    phase_mpt_parity(device, SEED)
    runs.append(phase_mpt_train(device, SEED))
    phase_mpt_train_parity(device, SEED)
    runs += phase_sampling(device, SEED, hd_batch, card.splitlines()[0] if card else "")
    ckpt = write_phase28_checkpoint(device, SEED)  # phases 28 and 31 read it
    try:
        runs.append(phase_checkpoint_load(device, SEED, hd_batch, hd_blocks, ckpt))
        runs.append(phase_checkpoint_layouts(device, SEED))
        runs.append(phase_mpt_quantized(device, SEED))
        runs.append(phase_serving(device, SEED, ckpt["path"], card_line))
        runs.append(phase_qlora_train(device, SEED, ckpt, rows, card_line))
        runs.append(phase_eval(device, SEED, ckpt, card_line))
    finally:
        shutil.rmtree(ckpt["root"], ignore_errors=True)
    phase_qlora_parity(device, SEED)
    runs.append(phase_parallel(device, card_line))
    counts = read_counts(unreached)
    counts["bitcast_pack"] += counts.pop("bitcast_unpack")
    runs.append(counts)
    release_earlier_phases()
    rows.update(phase_probes(device))

    # launches: summed over the main-path runs (phases 4, 6, 8, 10, 12, 14,
    # 16, 18, 20 and 22, phase 25's sampled Generator, phase 26's two
    # batchers, phase 27's beams, phase 28's two loaded models, phase 29's
    # chat, phase 30's nf4 MPT, phase 31's two HTTP workers, phase 32's two
    # training runs and its round trip's Generator and batcher, and phase
    # 34's eval CLIs, phase 35's sharded runs on rank 0), each counted from 0
    # just before its run and read just after; the six that no path reaches
    # over phases 4-23 and 25-34 as a whole (0)
    print(kernels_line(rows, runs))
    print(ok_line())

if __name__ == "__main__":
    if "--rank" in sys.argv[1:]:  # one of phase 35's two ranks, spawned by phase_parallel
        from tokenpacker_tpu_torch.parallel import dryrun

        dryrun.main(sys.argv[1:], S_RUNNERS)
    else:
        main()
