"""Scorer CLIs (counterpart of `tokenpacker_tpu/eval/score_cli.py`:
reference llava/eval/eval_pope.py, eval_textvqa.py, m4c_evaluator entry
points, and a GQA accuracy shortcut). Scoring runs on the host after
generation; no subcommand needs pandas (`mmbench` reads its TSV with
`tsv.read_table`).

  python -m tokenpacker_tpu_torch.eval.score_cli pope --annotation-dir ... --question-file ... --result-file ...
  python -m tokenpacker_tpu_torch.eval.score_cli textvqa --annotation-file ... --result-file ...
  python -m tokenpacker_tpu_torch.eval.score_cli gqa --result-file predictions.json --questions questions.json
"""

from __future__ import annotations

import argparse
import json
import os

from tokenpacker_tpu_torch.eval.scorers import anls, gqa_accuracy, pope_scores, vqa_accuracy
from tokenpacker_tpu_torch.eval.tsv import read_table


def _jsonl(path):
    with open(os.path.expanduser(path)) as f:
        return [json.loads(l) for l in f if l.strip()]


def run_pope(args):
    """Per-category (adversarial/popular/random) P/R/F1 like eval_pope.py."""
    answers = _jsonl(args.result_file)
    questions = {q["question_id"]: q for q in _jsonl(args.question_file)}
    for a in answers:
        a["category"] = questions.get(a["question_id"], {}).get("category")
    for cat_file in sorted(os.listdir(args.annotation_dir)):
        if not cat_file.endswith(".json"):
            continue
        category = cat_file[10:-5] if cat_file.startswith("coco_pope_") else cat_file[:-5]
        labels = _jsonl(os.path.join(args.annotation_dir, cat_file))
        cur = [
            a for a in answers
            if questions.get(a["question_id"], {}).get("category", category) == category
        ] or answers
        label_ids = {l["question_id"] for l in labels}
        cur = [a for a in cur if a["question_id"] in label_ids]
        if not cur:
            continue
        s = pope_scores(cur, labels)
        print(f"Category: {category}, # samples: {len(cur)}")
        print(
            f"  acc {s['accuracy']:.4f}  precision {s['precision']:.4f}  "
            f"recall {s['recall']:.4f}  f1 {s['f1']:.4f}  yes {s['yes_ratio']:.4f}"
        )


def run_textvqa(args):
    """VQA soft accuracy over TextVQA annotations (eval_textvqa.py)."""
    with open(os.path.expanduser(args.annotation_file)) as f:
        annotations = json.load(f)["data"]
    # match on question text + image like the reference
    index = {
        (a["image_id"], a["question"].lower()): [x["answer"] for x in a.get("answers", [])]
        or a.get("answers", [])
        for a in annotations
    }
    results = _jsonl(args.result_file)
    total, acc = 0, 0.0
    for r in results:
        prompt = r.get("prompt", "")
        question = prompt.split("\n")[0].lower() if prompt else ""
        gts = None
        for (img, q), answers in index.items():
            if q == question:
                gts = answers
                break
        if gts is None:
            continue
        total += 1
        acc += vqa_accuracy(r["text"], gts)
    print(f"Samples: {total}\nAccuracy: {100.0 * acc / max(total, 1):.2f}%")


def run_gqa(args):
    with open(os.path.expanduser(args.questions)) as f:
        questions = json.load(f)
    labels = {qid: q["answer"] for qid, q in questions.items() if "answer" in q}
    with open(os.path.expanduser(args.result_file)) as f:
        preds = json.load(f)
    answers = [{"question_id": p["questionId"], "text": p["prediction"]} for p in preds]
    print(f"Accuracy: {100.0 * gqa_accuracy(answers, labels):.2f}%")


def run_mmbench(args):
    """Dev-split accuracy: prediction letter vs the tsv 'answer' column
    (majority vote over rotation rounds when --all-rounds was used).

    An --all-rounds answer is un-rotated: the letter shown at position i
    ("ABCD"[i]) stood for the option whose canonical letter is
    option_char[i]. The JAX scorer maps it the other way round
    (`"ABCD"[option_char.index(p)]`, the inverse rotation), so a model
    right in every round scores 0% strict there; single-round answers
    (option_char "ABCD") score the same in both."""
    from collections import Counter, defaultdict

    rows = read_table(args.annotation_file)
    gt = {row["index"]: str(row.get("answer", "")).strip().upper() for row in rows}
    votes = defaultdict(list)
    for r in _jsonl(args.result_file):
        pred = (r["text"].strip().upper() or "?")[0]
        chars = json.loads(r["option_char"]) if "option_char" in r else None
        if chars and pred in [c.upper() for c in chars]:
            pred = chars["ABCD".index(pred)].upper()
        votes[r["question_id"]].append(pred)
    total = correct = 0
    for qid, vs in votes.items():
        if qid not in gt or not gt[qid] or gt[qid] == "NAN":
            continue
        total += 1
        if args.all_rounds_strict:
            correct += int(all(v == gt[qid] for v in vs))
        else:
            correct += int(Counter(vs).most_common(1)[0][0] == gt[qid])
    print(f"Samples: {total}\nAccuracy: {100.0 * correct / max(total, 1):.2f}%")


def run_anls(args):
    """ANLS over DocVQA-style annotations with gt answers."""
    with open(os.path.expanduser(args.annotation_file)) as f:
        annos = {a["questionId"]: a["answers"] for a in json.load(f)["data"]}
    results = _jsonl(args.result_file)
    total, score = 0, 0.0
    for r in results:
        gts = annos.get(r["question_id"])
        if gts is None:
            continue
        total += 1
        score += anls(r["text"], gts)
    print(f"Samples: {total}\nANLS: {score / max(total, 1):.4f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pope")
    sp.add_argument("--annotation-dir", required=True)
    sp.add_argument("--question-file", required=True)
    sp.add_argument("--result-file", required=True)
    sp.set_defaults(fn=run_pope)

    sp = sub.add_parser("textvqa")
    sp.add_argument("--annotation-file", required=True)
    sp.add_argument("--result-file", required=True)
    sp.set_defaults(fn=run_textvqa)

    sp = sub.add_parser("gqa")
    sp.add_argument("--questions", required=True)
    sp.add_argument("--result-file", required=True)
    sp.set_defaults(fn=run_gqa)

    sp = sub.add_parser("anls")
    sp.add_argument("--annotation-file", required=True)
    sp.add_argument("--result-file", required=True)
    sp.set_defaults(fn=run_anls)

    sp = sub.add_parser("mmbench")
    sp.add_argument("--annotation-file", required=True)
    sp.add_argument("--result-file", required=True)
    sp.add_argument("--all-rounds-strict", action="store_true",
                    help="require every rotation round correct (circular eval)")
    sp.set_defaults(fn=run_mmbench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
