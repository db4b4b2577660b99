"""One-command real-weights accuracy runway (counterpart of
`scripts/eval_runway.py`), run through the port's modules and launchers.

When the released `sunshine-lwt/TokenPacker-*` checkpoints are on disk:

  python -m tokenpacker_tpu_torch.eval.runway --ckpt /path/to/TokenPacker-7b-144token \\
      --gqa-dir playground/data/eval/gqa \\
      --mmbench-tsv playground/data/eval/mmbench/mmbench_dev_20230712.tsv \\
      --expected expected_scores.json --limit 500

Steps (each skipped when its inputs are absent, so partial staging works):
  1. import   — load_pretrained_model + config summary
  2. smoke    — deterministic 3-image greedy decode; tokens written to
               <out>/smoke_tokens.json; --smoke-expect diffs them against a
               recorded run
  3. gqa      — eval/scripts/gqa.sh on a --limit subset, scored with
               `score_cli gqa` where the labels are present
  4. mmbench  — eval/scripts/mmbench.sh on a subset, scored by `score_cli mmbench`
  5. compare  — scores vs --expected {"gqa": .., "mmbench": ..} (the
               paper's table, arXiv:2407.02392, supplied by the operator)
               within --tolerance points

`--device` (the card by default) is where steps 1-2 load the model, and
is passed on to the launchers' CLIs with `--extra-args`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
# the directory that holds the package: the launchers' `python -m` runs there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(f"[runway] {msg}", flush=True)


def step_import(args) -> None:
    from tokenpacker_tpu_torch.api import load_pretrained_model

    tokenizer, model, _, context_len = load_pretrained_model(
        args.ckpt, args.model_base, load_8bit=args.load_8bit, device=args.device
    )
    cfg = model.cfg
    log(
        f"import OK: family={cfg.lm.model_family} hidden={cfg.lm.hidden_size} "
        f"layers={cfg.lm.num_hidden_layers} scale_factor={cfg.scale_factor} "
        f"tokens/view={cfg.tokens_per_view} aspect={cfg.image_aspect_ratio} "
        f"context_len={context_len}"
    )
    args._loaded = (tokenizer, model)


def step_smoke(args) -> None:
    from tokenpacker_tpu_torch.data.conversation import conv_templates
    from tokenpacker_tpu_torch.data.mm_tokenize import tokenizer_image_token
    from tokenpacker_tpu_torch.models.splice import build_splice_plan

    tokenizer, model = args._loaded
    cfg = model.cfg
    rng = np.random.default_rng(0)
    toks_out = []
    for _ in range(3):
        conv = conv_templates[args.conv_mode].copy()
        conv.append_message(conv.roles[0], "<image>\nWhat is shown in this image?")
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), tokenizer)
        plan = build_splice_plan(
            [np.asarray(ids)], [[(1, 1)]], cfg.tokens_per_view, "single",
            0, 0, tokenizer.pad_token_id or 0,
            pad_to=max(64, ((len(ids) + cfg.tokens_per_view) + 63) // 64 * 64),
        )
        image = rng.standard_normal(
            (1, cfg.vision.image_size, cfg.vision.image_size, 3)
        ).astype(np.float32)
        batch = {
            "token_ids": plan.token_ids, "is_image": plan.is_image,
            "image_slot": plan.image_slot, "lengths": plan.lengths,
            "images": image,
        }
        res = model.generator.generate(batch, max_new_tokens=16, temperature=0.0)
        toks_out.append([int(t) for t in res.sequences[0]])
    out_path = os.path.join(args.out, "smoke_tokens.json")
    with open(out_path, "w") as f:
        json.dump(toks_out, f)
    log(f"smoke OK: greedy tokens for 3 deterministic images → {out_path}")
    if args.smoke_expect:
        with open(args.smoke_expect) as f:
            expect = json.load(f)
        if toks_out != expect:
            log(f"smoke DIFF vs {args.smoke_expect}: got {toks_out} want {expect}")
            args._failures.append("smoke")
        else:
            log("smoke parity: token-identical vs recorded reference")


def _subset_jsonl(src: str, dst: str, limit: int) -> None:
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= limit:
                break
            g.write(line)


def _run_script(script: str, env_extra: dict) -> str:
    env = dict(os.environ)
    env.update(env_extra)
    r = subprocess.run(
        ["bash", os.path.join(SCRIPTS, script)],
        cwd=ROOT, env=env, capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"{script} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
        )
    return r.stdout


def _score_output(cmd: list[str]) -> tuple[str, float | None]:
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} failed: {r.stderr[-2000:]}")
    m = re.search(r"Accuracy:\s*([0-9.]+)%", r.stdout)
    return r.stdout.strip(), float(m.group(1)) if m else None


def _extra_args(args) -> str:
    return f"{args.extra_args} --device {args.device}".strip()


def step_gqa(args, scores: dict) -> None:
    split = "llava_gqa_testdev_balanced"
    work = os.path.join(args.out, "gqa")
    os.makedirs(os.path.join(work, "answers"), exist_ok=True)
    src = os.path.join(args.gqa_dir, f"{split}.jsonl")
    _subset_jsonl(src, os.path.join(work, f"{split}.jsonl"), args.limit)
    imgs = os.path.join(args.gqa_dir, "images")
    if not os.path.exists(os.path.join(work, "images")):
        os.symlink(os.path.abspath(imgs), os.path.join(work, "images"))
    _run_script("gqa.sh", {
        "CKPT": args.ckpt, "GQADIR": work, "CHUNKS": str(args.chunks),
        "EXTRA_ARGS": _extra_args(args),
    })
    labels = os.path.join(args.gqa_dir, "testdev_balanced_questions.json")
    if os.path.exists(labels):
        out, acc = _score_output([
            sys.executable, "-m", "tokenpacker_tpu_torch.eval.score_cli", "gqa",
            "--result-file", os.path.join(work, "testdev_balanced_predictions.json"),
            "--questions", labels,
        ])
        log(f"gqa: {out}")
        scores["gqa"] = acc
    else:
        log(f"gqa: predictions written to {work} (no local labels; submit/score offline)")


def step_mmbench(args, scores: dict) -> None:
    split = os.path.splitext(os.path.basename(args.mmbench_tsv))[0]
    work = os.path.join(args.out, "mmbench")
    os.makedirs(work, exist_ok=True)
    # subset the tsv (header + limit rows)
    dst_tsv = os.path.join(work, f"{split}.tsv")
    with open(args.mmbench_tsv) as f, open(dst_tsv, "w") as g:
        for i, line in enumerate(f):
            if i > args.limit:
                break
            g.write(line)
    _run_script("mmbench.sh", {
        "CKPT": args.ckpt, "DIR": work, "SPLIT": split,
        "NAME": "runway", "EXTRA_ARGS": _extra_args(args),
    })
    out, acc = _score_output([
        sys.executable, "-m", "tokenpacker_tpu_torch.eval.score_cli", "mmbench",
        "--annotation-file", dst_tsv,
        "--result-file", os.path.join(work, "answers", split, "runway.jsonl"),
    ])
    log(f"mmbench: {out}")
    scores["mmbench"] = acc


def step_compare(args, scores: dict) -> None:
    if not args.expected:
        log("no --expected file: skipping score comparison")
        return
    with open(args.expected) as f:
        expected = json.load(f)
    for name, want in expected.items():
        got = scores.get(name)
        if got is None:
            log(f"compare {name}: no measured score (subset not run/scoreable)")
            continue
        delta = got - float(want)
        ok = abs(delta) <= args.tolerance
        log(f"compare {name}: got {got:.2f} expected {want:.2f} "
            f"(delta {delta:+.2f}, tol {args.tolerance}) {'OK' if ok else 'FAIL'}")
        if not ok:
            args._failures.append(f"compare:{name}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--load-8bit", action="store_true")
    p.add_argument("--conv-mode", default="vicuna_v1")
    p.add_argument("--out", default="./runway_out")
    p.add_argument("--smoke-expect", default=None,
                   help="json of recorded greedy tokens to diff against")
    p.add_argument("--gqa-dir", default=None)
    p.add_argument("--mmbench-tsv", default=None)
    p.add_argument("--expected", default=None,
                   help='json {"gqa": 62.0, "mmbench": 64.1} from the paper table')
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--limit", type=int, default=500)
    p.add_argument("--chunks", type=int, default=1)
    p.add_argument("--extra-args", default="",
                   help="forwarded to the benchmark CLI (e.g. --max-new-tokens 4)")
    p.add_argument("--skip-smoke", action="store_true")
    p.add_argument("--device", default="cuda", help="the card by default; 'cpu' to run there")
    args = p.parse_args(argv)
    args._failures = []
    os.makedirs(args.out, exist_ok=True)

    scores: dict = {}
    step_import(args)
    if not args.skip_smoke:
        step_smoke(args)
    args._loaded = None  # the launchers load their own models: free this one
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if args.gqa_dir:
        step_gqa(args, scores)
    if args.mmbench_tsv:
        step_mmbench(args, scores)
    step_compare(args, scores)
    with open(os.path.join(args.out, "scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    if args._failures:
        log(f"FAILURES: {args._failures}")
        return 1
    log("runway complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
