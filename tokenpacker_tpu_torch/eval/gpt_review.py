"""GPT-judged pairwise review + summarizer (legacy LLaVA-Bench pipeline): a
copy of `tokenpacker_tpu/eval/gpt_review.py`.

Parity with reference llava/eval/eval_gpt_review*.py + summarize_gpt_review.py:
two assistants' answers are scored 1-10 by a judge model using a rule prompt;
`summarize` averages per-category relative scores. The reference used
ray-parallel OpenAI calls; this uses a thread pool + urllib (no openai sdk in
the image). Requires OPENAI_API_KEY; no-ops with a clear error otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import urllib.request
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

NUM_SECONDS_TO_SLEEP = 3


def call_judge(content: str, model: str = "gpt-4-0314", max_tokens: int = 1024) -> str:
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise RuntimeError("OPENAI_API_KEY is required for GPT review")
    payload = {
        "model": model,
        "messages": [
            {"role": "system", "content": "You are a helpful and precise assistant for checking the quality of the answer."},
            {"role": "user", "content": content},
        ],
        "temperature": 0.2,
        "max_tokens": max_tokens,
    }
    for attempt in range(5):
        try:
            req = urllib.request.Request(
                "https://api.openai.com/v1/chat/completions",
                json.dumps(payload).encode(),
                {"Content-Type": "application/json", "Authorization": f"Bearer {api_key}"},
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                data = json.loads(resp.read())
            return data["choices"][0]["message"]["content"]
        except Exception as e:
            print(f"judge error (attempt {attempt}): {e}")
            time.sleep(NUM_SECONDS_TO_SLEEP)
    return "error"


def parse_score(review: str) -> list[float]:
    """First line must be 'x y' scores (reference eval_gpt_review.py:39-51)."""
    try:
        first = review.split("\n")[0].replace(",", " ")
        parts = first.split(" ")
        if len(parts) == 2:
            return [float(parts[0]), float(parts[1])]
        return [-1.0, -1.0]
    except Exception:
        return [-1.0, -1.0]


def build_content(rule: dict, question: dict, ans1: dict, ans2: dict, context: str | None):
    prompt = rule["prompt"]
    role = rule["role"]
    cap = f"[Context]\n{context}\n\n" if context else ""
    return (
        f"{cap}"
        f"[Question]\n{question['text']}\n\n"
        f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
        f"[System]\n{prompt}\n\n"
    )


def run_review(question_file, answer_list, rule_file, context_file, output, model, max_tokens=1024):
    with open(rule_file) as f:
        rules = json.load(f)
    questions = [json.loads(l) for l in open(question_file)]
    ans1 = [json.loads(l) for l in open(answer_list[0])]
    ans2 = [json.loads(l) for l in open(answer_list[1])]
    contexts = None
    if context_file:
        contexts = {c["image"]: c for c in (json.loads(l) for l in open(context_file))}

    def judge_one(args):
        q, a1, a2 = args
        category = q.get("category", "default")
        rule = rules.get(category, rules.get("default"))
        ctx = None
        if contexts is not None and q.get("image") in contexts:
            ctx_rec = contexts[q["image"]]
            ctx = "\n".join(ctx_rec.get("captions", []) or []) or ctx_rec.get("text")
        content = build_content(rule, q, a1, a2, ctx)
        review = call_judge(content, model=model, max_tokens=max_tokens)
        return {
            "id": q.get("question_id"),
            "question_id": q.get("question_id"),
            "answer1_id": a1.get("answer_id"),
            "answer2_id": a2.get("answer_id"),
            "category": category,
            "content": review,
            "tuple": parse_score(review),
        }

    with ThreadPoolExecutor(max_workers=4) as pool:
        reviews = list(pool.map(judge_one, zip(questions, ans1, ans2)))
    with open(output, "w") as f:
        for r in reviews:
            f.write(json.dumps(r) + "\n")


def summarize(review_files):
    """Per-category mean scores and relative % (summarize_gpt_review.py)."""
    for path in review_files:
        scores = defaultdict(list)
        with open(path) as f:
            for line in f:
                review = json.loads(line)
                if "tuple" in review:
                    scores[review.get("category", "all")].append(review["tuple"])
                    scores["all"].append(review["tuple"])
        print(os.path.basename(path))
        for k, v in sorted(scores.items()):
            import numpy as np

            stats = np.asarray(v).mean(0)
            print(
                f"  {k}: rel {round(stats[1] / stats[0] * 100, 1)}%  "
                f"judge1 {round(stats[0] * 10, 1)}  judge2 {round(stats[1] * 10, 1)}"
            )


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("review")
    sp.add_argument("--question", required=True)
    sp.add_argument("--answer-list", nargs=2, required=True)
    sp.add_argument("--rule", required=True)
    sp.add_argument("--context", default=None)
    sp.add_argument("--output", required=True)
    sp.add_argument("--model", default="gpt-4-0314")
    sp.add_argument("--max-tokens", type=int, default=1024)
    sp = sub.add_parser("summarize")
    sp.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    if args.cmd == "review":
        run_review(
            args.question, args.answer_list, args.rule, args.context, args.output,
            args.model, args.max_tokens,
        )
    else:
        summarize(args.files)


if __name__ == "__main__":
    main()
