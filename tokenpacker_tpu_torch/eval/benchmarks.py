"""Per-benchmark question loaders and CLI entry points (counterpart of
`tokenpacker_tpu/eval/benchmarks.py`).

Covers the reference harness (SURVEY.md §2.4): VQAv2 / GQA / MME /
TextVQA / VizWiz (jsonl, `model_vqa_loader.py`), POPE
(`model_vqa_loader_pope.py`), MM-Vet (`model_vqa.py`), MMBench
(`model_vqa_mmbench.py`: tsv, base64 images, option rotation), DocVQA
(`eval_docvqa.py`, HD), OCRBench (`eval_ocr_bench.py`) and text-only QA
(`model_qa.py`). The flags are the JAX CLI's, plus `--device` (the card
by default, `cpu` to run there).

Usage (the reference's shell fan-out, e.g. eval/scripts/gqa.sh):
  python -m tokenpacker_tpu_torch.eval.benchmarks vqa \
      --model-path ... --question-file ... --image-folder ... \
      --answers-file ... --num-chunks 8 --chunk-idx 0 --conv-mode vicuna_v1
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import os

from tokenpacker_tpu_torch.eval.runner import EvalRunner, EvalSample, get_chunk, write_answers
from tokenpacker_tpu_torch.eval.tsv import read_table


def _load_model(args):
    from tokenpacker_tpu_torch.api import load_pretrained_model

    tokenizer, model, image_processor, context_len = load_pretrained_model(
        args.model_path,
        getattr(args, "model_base", None),
        load_8bit=getattr(args, "load_8bit", False),
        load_4bit=getattr(args, "load_4bit", False),
        device=getattr(args, "device", "cuda"),
    )
    runner = EvalRunner(
        model,
        tokenizer,
        conv_mode=args.conv_mode,
        image_aspect_ratio=getattr(args, "image_aspect_ratio", None),
        batch_size=getattr(args, "batch_size", 8),
        max_new_tokens=getattr(args, "max_new_tokens", 128),
        temperature=getattr(args, "temperature", 0.0),
        num_beams=getattr(args, "num_beams", 1),
    )
    return runner


# ---------------------------------------------------------------------------
# jsonl VQA family: VQAv2, GQA, MME, TextVQA, VizWiz, POPE, MM-Vet
# ---------------------------------------------------------------------------


def iter_vqa_jsonl(question_file, image_folder, num_chunks=1, chunk_idx=0):
    with open(os.path.expanduser(question_file)) as f:
        questions = [json.loads(line) for line in f]
    questions = get_chunk(questions, num_chunks, chunk_idx)
    for q in questions:
        yield EvalSample(
            question_id=q["question_id"],
            prompt_text=q["text"],
            image_path=os.path.join(image_folder, q["image"]) if q.get("image") else None,
            extra={"prompt": q["text"]},
        )


def run_vqa(args):
    runner = _load_model(args)
    samples = iter_vqa_jsonl(args.question_file, args.image_folder, args.num_chunks, args.chunk_idx)
    write_answers(args.answers_file, runner.run(samples))


# ---------------------------------------------------------------------------
# MMBench: tsv, base64 images, option rotation (model_vqa_mmbench.py)
# ---------------------------------------------------------------------------

_OPTION_KEYS = ["A", "B", "C", "D"]


def _is_none(v):
    if v is None:
        return True
    if isinstance(v, float) and math.isnan(v):
        return True
    return isinstance(v, str) and v.lower() in ("nan", "none")


def iter_mmbench(question_file, num_chunks=1, chunk_idx=0, all_rounds=False,
                 single_pred_prompt=False, lang="en"):
    """The JAX loader's samples; the TSV is read by `tsv.read_table`, which
    gives the values pandas would (its NA set and numeric columns)."""
    from PIL import Image

    rows = get_chunk(read_table(question_file), num_chunks, chunk_idx)
    for row in rows:
        options = [row[k] for k in _OPTION_KEYS if not _is_none(row.get(k))]
        n_rounds = len(options) if all_rounds else 1
        cur = list(options)
        keys = list(_OPTION_KEYS[: len(options)])
        for rnd in range(n_rounds):
            img = Image.open(io.BytesIO(base64.b64decode(row["image"]))).convert("RGB")
            question = row["question"]
            hint = row.get("hint")
            if not _is_none(hint):
                question = hint + "\n" + question
            for k, opt in zip(_OPTION_KEYS, cur):
                question += f"\n{k}. {opt}"
            if single_pred_prompt:
                if lang == "cn":
                    question += "\n请直接回答选项字母。"
                else:
                    question += "\nAnswer with the option's letter from the given choices directly."
            yield EvalSample(
                question_id=row["index"],
                prompt_text=question,
                image=img,
                extra={
                    "round_id": rnd,
                    "prompt": question,
                    "options": json.dumps(cur),
                    "option_char": json.dumps(keys),
                },
            )
            # rotate options for the next round
            cur = cur[1:] + cur[:1]
            keys = keys[1:] + keys[:1]


def run_mmbench(args):
    runner = _load_model(args)
    samples = iter_mmbench(
        args.question_file,
        args.num_chunks,
        args.chunk_idx,
        all_rounds=args.all_rounds,
        single_pred_prompt=args.single_pred_prompt,
        lang=args.lang,
    )
    write_answers(args.answers_file, runner.run(samples))


# ---------------------------------------------------------------------------
# DocVQA (eval_docvqa.py): HD slice path over the val/test json
# ---------------------------------------------------------------------------


def iter_docvqa(question_file, image_folder, num_chunks=1, chunk_idx=0):
    with open(os.path.expanduser(question_file)) as f:
        data = json.load(f)["data"]
    data = get_chunk(data, num_chunks, chunk_idx)
    for q in data:
        yield EvalSample(
            question_id=q["questionId"],
            prompt_text=q["question"] + "\nAnswer the question using a single word or phrase.",
            image_path=os.path.join(image_folder, q["image"]),
            extra={"prompt": q["question"]},
        )


def run_docvqa(args):
    runner = _load_model(args)
    samples = iter_docvqa(args.question_file, args.image_folder, args.num_chunks, args.chunk_idx)
    write_answers(args.answers_file, runner.run(samples))


# ---------------------------------------------------------------------------
# OCRBench (eval_ocr_bench.py): json list with per-category substring scoring
# ---------------------------------------------------------------------------


def iter_ocrbench(question_file, image_folder, num_chunks=1, chunk_idx=0):
    with open(os.path.expanduser(question_file)) as f:
        data = json.load(f)
    data = get_chunk(data, num_chunks, chunk_idx)
    for i, q in enumerate(data):
        yield EvalSample(
            question_id=i,
            prompt_text=q["question"],
            image_path=os.path.join(image_folder, q["image_path"]),
            extra={"type": q["type"], "answers": q["answers"], "dataset": q.get("dataset_name")},
        )


def run_ocrbench(args):
    from tokenpacker_tpu_torch.eval.scorers import ocrbench_aggregate, ocrbench_score

    runner = _load_model(args)
    samples = iter_ocrbench(args.question_file, args.image_folder, args.num_chunks,
                            args.chunk_idx)
    records = []
    for ans in runner.run(samples):
        gt = ans["answers"] if isinstance(ans["answers"], list) else [ans["answers"]]
        records.append({**ans, "score": ocrbench_score(ans["text"], gt)})
    write_answers(args.answers_file, records)
    print(json.dumps(ocrbench_aggregate(records), indent=2))


# ---------------------------------------------------------------------------
# Text-only QA (model_qa.py)
# ---------------------------------------------------------------------------


def iter_textqa(question_file, num_chunks=1, chunk_idx=0):
    with open(os.path.expanduser(question_file)) as f:
        questions = [json.loads(line) for line in f]
    for q in get_chunk(questions, num_chunks, chunk_idx):
        yield EvalSample(question_id=q["question_id"], prompt_text=q["text"])


def run_textqa(args):
    runner = _load_model(args)
    samples = iter_textqa(args.question_file, args.num_chunks, args.chunk_idx)
    write_answers(args.answers_file, runner.run(samples))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser():
    p = argparse.ArgumentParser(description="TokenPacker eval harness (PyTorch port)")
    sub = p.add_subparsers(dest="benchmark", required=True)

    def common(sp):
        sp.add_argument("--model-path", required=True)
        sp.add_argument("--model-base", default=None)
        sp.add_argument("--question-file", required=True)
        sp.add_argument("--image-folder", default=".")
        sp.add_argument("--answers-file", required=True)
        sp.add_argument("--conv-mode", default="vicuna_v1")
        sp.add_argument("--num-chunks", type=int, default=1)
        sp.add_argument("--chunk-idx", type=int, default=0)
        sp.add_argument("--batch-size", type=int, default=8)
        sp.add_argument("--max-new-tokens", type=int, default=128)
        sp.add_argument("--temperature", type=float, default=0.0)
        sp.add_argument("--num-beams", type=int, default=1)
        sp.add_argument("--image-aspect-ratio", default=None)
        sp.add_argument("--load-8bit", action="store_true")
        sp.add_argument("--load-4bit", action="store_true")
        sp.add_argument("--device", default="cuda",
                        help="the card by default; 'cpu' to run there")

    for name, fn in [
        ("vqa", run_vqa),  # VQAv2 / GQA / MME / TextVQA / VizWiz / POPE / MM-Vet
        ("docvqa", run_docvqa),
        ("ocrbench", run_ocrbench),
        ("textqa", run_textqa),
    ]:
        sp = sub.add_parser(name)
        common(sp)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("mmbench")
    common(sp)
    sp.add_argument("--all-rounds", action="store_true")
    sp.add_argument("--single-pred-prompt", action="store_true")
    sp.add_argument("--lang", default="en")
    sp.set_defaults(fn=run_mmbench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
