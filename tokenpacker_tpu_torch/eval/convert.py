"""Answer-file converters for benchmark submission/scoring servers
(counterpart of `tokenpacker_tpu/eval/convert.py`).

Parity with the reference's scripts/convert_* family: GQA eval format,
VQAv2 + VizWiz EvalAI submissions (with answer normalization), MM-Vet GPT-4
grading dict, MMBench Excel upload, DocVQA server json, MME per-category
answer files. `mmbench` writes through pandas where it is installed, as
the JAX package does, and otherwise writes the same CSV with the csv
module.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os

from tokenpacker_tpu_torch.eval.scorers import evalai_process_answer
from tokenpacker_tpu_torch.eval.tsv import read_table


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def convert_gqa(src: str, dst: str):
    """scripts/convert_gqa_for_eval.py format: questionId/prediction list."""
    out = [
        {"questionId": r["question_id"], "prediction": r["text"].rstrip(".").lower()}
        for r in _read_jsonl(src)
    ]
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f)


def convert_vqav2(src: str, test_split: str, dst: str):
    """EvalAI submission: all test-split qids answered, normalized; missing
    predictions filled with empty answers."""
    results = {r["question_id"]: r["text"] for r in _read_jsonl(src)}
    split = _read_jsonl(test_split)
    out = []
    for q in split:
        qid = q["question_id"]
        ans = results.get(qid, "")
        out.append({"question_id": qid, "answer": evalai_process_answer(ans)})
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f)


def convert_vizwiz(src: str, annotation_file: str, dst: str):
    # the reference annotation (llava_test.jsonl) is JSONL; accept a plain
    # JSON array too (convert_vizwiz_for_submission.py:30)
    with open(annotation_file) as f:
        text = f.read().strip()
    try:
        annos = json.loads(text)
    except json.JSONDecodeError:
        annos = [json.loads(l) for l in text.splitlines() if l.strip()]
    results = {r["question_id"]: r["text"] for r in _read_jsonl(src)}
    out = []
    for q in annos:
        image = q["image"]
        out.append({"image": image, "answer": evalai_process_answer(results.get(image, ""))})
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f)


def convert_mmvet(src: str, dst: str):
    out = {f"v1_{r['question_id']}": r["text"] for r in _read_jsonl(src)}
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)


_MMBENCH_DROP = ("hint", "category", "source", "image", "comment", "l2-category")


def _mmbench_csv_without_pandas(annotation_file: str, result_file: str, dst: str):
    """The CSV `convert_mmbench` writes through pandas (`to_csv(index=False)`),
    from `tsv.read_table`'s rows: the same columns, a prediction column at
    position 6 (the last answer of a question wins), missing values empty."""
    rows = read_table(annotation_file)
    header = [c for c in rows[0] if c not in _MMBENCH_DROP] if rows else []
    header.insert(min(6, len(header)), "prediction")
    preds = {r["question_id"]: r["text"] for r in _read_jsonl(result_file)}

    def cell(v):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return ""
        return v

    with open(dst, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for row in rows:
            row = {**row, "prediction": preds.get(row["index"])}
            w.writerow([cell(row[c]) for c in header])


def convert_mmbench(annotation_file: str, result_file: str, dst_xlsx: str):
    try:
        import pandas as pd
    except ImportError:
        os.makedirs(os.path.dirname(os.path.abspath(dst_xlsx)), exist_ok=True)
        alt = os.path.splitext(dst_xlsx)[0] + ".csv"
        _mmbench_csv_without_pandas(annotation_file, result_file, alt)
        print(f"pandas unavailable; wrote {alt} instead of xlsx")
        return

    df = pd.read_table(annotation_file)
    cur = df.copy()
    drop = [c for c in _MMBENCH_DROP if c in cur]
    cur = cur.drop(columns=drop)
    cur.insert(min(6, len(cur.columns)), "prediction", None)
    for r in _read_jsonl(result_file):
        cur.loc[df["index"] == r["question_id"], "prediction"] = r["text"]
    os.makedirs(os.path.dirname(os.path.abspath(dst_xlsx)), exist_ok=True)
    try:
        cur.to_excel(dst_xlsx, index=False)
    except (ImportError, ModuleNotFoundError):
        # no openpyxl in the environment: write csv next to the requested
        # name so the submission data is still produced
        alt = os.path.splitext(dst_xlsx)[0] + ".csv"
        cur.to_csv(alt, index=False)
        print(f"openpyxl unavailable; wrote {alt} instead of xlsx")


def convert_docvqa(src: str, dst: str):
    """DocVQA evaluation-server format: questionId/answer list."""
    out = [{"questionId": r["question_id"], "answer": r["text"]} for r in _read_jsonl(src)]
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f)


def convert_mme(src: str, annotation_dir: str, dst_dir: str):
    """Official MME tool expects per-category txt files:
    image\\tquestion\\tgt\\tpred per line. Annotations: the MME release's
    per-category question files under `annotation_dir`."""
    os.makedirs(dst_dir, exist_ok=True)
    results = {r["question_id"]: r for r in _read_jsonl(src)}
    by_cat: dict[str, list[str]] = {}
    for qid, r in results.items():
        cat = r.get("category") or str(qid).split("/")[0]
        by_cat.setdefault(cat, []).append(
            "\t".join(
                [
                    str(r.get("image", qid)),
                    r.get("prompt", ""),
                    r.get("annotation", ""),
                    r["text"].replace("\n", " "),
                ]
            )
        )
    for cat, lines in by_cat.items():
        with open(os.path.join(dst_dir, f"{cat}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("gqa")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("vqav2")
    sp.add_argument("--src", required=True)
    sp.add_argument("--test-split", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("vizwiz")
    sp.add_argument("--src", required=True)
    sp.add_argument("--annotation-file", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("mmvet")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("mmbench")
    sp.add_argument("--annotation-file", required=True)
    sp.add_argument("--result-file", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("docvqa")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)

    sp = sub.add_parser("mme")
    sp.add_argument("--src", required=True)
    sp.add_argument("--annotation-dir", default=".")
    sp.add_argument("--dst-dir", required=True)

    args = p.parse_args(argv)
    if args.cmd == "gqa":
        convert_gqa(args.src, args.dst)
    elif args.cmd == "vqav2":
        convert_vqav2(args.src, args.test_split, args.dst)
    elif args.cmd == "vizwiz":
        convert_vizwiz(args.src, args.annotation_file, args.dst)
    elif args.cmd == "mmvet":
        convert_mmvet(args.src, args.dst)
    elif args.cmd == "mmbench":
        convert_mmbench(args.annotation_file, args.result_file, args.dst)
    elif args.cmd == "docvqa":
        convert_docvqa(args.src, args.dst)
    elif args.cmd == "mme":
        convert_mme(args.src, args.annotation_dir, args.dst_dir)


if __name__ == "__main__":
    main()
