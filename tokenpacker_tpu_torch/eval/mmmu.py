"""MMMU benchmark harness (counterpart of `tokenpacker_tpu/eval/mmmu.py`).

Compact reimplementation of the reference's vendored MMMU harness
(llava/eval/mmmu/eval/: run_llava.py, eval_utils parsing, main_eval_only,
print_results): builds multiple-choice / open prompts, parses responses
into option letters or normalized open answers, and scores per subject and
overall. The prompt, the parsers (with their private seed-42 fallback) and
the scoring are the JAX package's, line for line.

`run` loads the MMMU HF dataset (30 subjects) through `datasets`, imported
there only; `answer_records` runs the loop over records, so that a list of
records in memory can stand in for the dataset.

Usage:
  python -m tokenpacker_tpu_torch.eval.mmmu run   --model-path ... --output answers.json
  python -m tokenpacker_tpu_torch.eval.mmmu score --answers answers.json --answer-dict answer_dict_val.json
"""

from __future__ import annotations

import argparse
import ast
import json
import random
import re
import string

SUBJECTS = [
    "Accounting", "Agriculture", "Architecture_and_Engineering", "Art", "Art_Theory",
    "Basic_Medical_Science", "Biology", "Chemistry", "Clinical_Medicine", "Computer_Science",
    "Design", "Diagnostics_and_Laboratory_Medicine", "Economics", "Electronics",
    "Energy_and_Power", "Finance", "Geography", "History", "Literature", "Manage",
    "Marketing", "Materials", "Math", "Mechanical_Engineering", "Music", "Pharmacy",
    "Physics", "Psychology", "Public_Health", "Sociology",
]

MC_PROMPT = "Answer with the option's letter from the given choices directly."
OPEN_PROMPT = "Answer the question using a single word or phrase."


def build_prompt(sample: dict) -> tuple[str, list[str]]:
    """Returns (prompt_text, option_letters). Image placeholders <image 1>
    etc. collapse to a single leading <image> (single-image subset, as the
    reference's llava1.5 config does)."""
    question = re.sub(r"<image \d+>", "", sample["question"]).strip()
    if sample["question_type"] == "multiple-choice":
        options = sample["options"]
        if isinstance(options, str):
            options = ast.literal_eval(options)
        letters = list(string.ascii_uppercase[: len(options)])
        lines = [question] + [f"{l}. {o}" for l, o in zip(letters, options)] + [MC_PROMPT]
        return "\n".join(lines), letters
    return f"{question}\n{OPEN_PROMPT}", []


# The reference (eval_utils.py:5-6) seeds the GLOBAL random module at import
# (seed 42) for the no-candidate fallback in parse_multi_choice_response. We
# keep the same sequence on a private Random so importing this module does not
# reseed callers' global RNG; tests reseed both sides for byte-equality.
_fallback_rng = random.Random(42)


def parse_multi_choice_response(response: str, all_choices: list[str], index2ans: dict) -> str:
    """Faithful port of the reference parser
    (llava/eval/mmmu/eval/utils/eval_utils.py:10-62): bracketed `(A)` hits
    first; then bare ` A `; then option-text containment when the response
    has >5 words; random fallback; multi-candidate → last occurrence wins
    (np.argmax tie-break = first max)."""
    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = " " + response + " "  # add space to avoid partial match

    index_ans = True
    ans_with_brack = False
    candidates = []
    for choice in all_choices:  # e.g., (A) (B) (C) (D)
        if f"({choice})" in response:
            candidates.append(choice)
            ans_with_brack = True
    if len(candidates) == 0:
        for choice in all_choices:  # e.g., A B C D
            if f" {choice} " in response:
                candidates.append(choice)
    # no candidates + response longer than 5 WORDS → try the option text
    if len(candidates) == 0 and len(response.split()) > 5:
        for index, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(index)
                index_ans = False  # it's a content answer

    if len(candidates) == 0:  # still nothing: random choice
        return _fallback_rng.choice(all_choices)
    if len(candidates) > 1:
        start_indexes = []
        if index_ans:
            if ans_with_brack:
                for can in candidates:
                    start_indexes.append(response.rfind(f"({can})"))
            else:
                for can in candidates:
                    start_indexes.append(response.rfind(f" {can} "))
        else:
            for can in candidates:
                start_indexes.append(response.lower().rfind(index2ans[can].lower()))
        # last occurrence; ties resolve to the FIRST max like np.argmax
        return candidates[max(range(len(start_indexes)), key=start_indexes.__getitem__)]
    return candidates[0]


def check_is_number(string: str) -> bool:
    """eval_utils.py:65-73."""
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(string: str) -> list:
    """eval_utils.py:76-96: numbers → rounded float; 1-char strings pad with
    a space on either side to avoid trivial containment matches."""
    string = string.strip()
    if check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    string = string.lower()
    if len(string) == 1:
        return [" " + string, string + " "]
    return [string]


def extract_numbers(string: str) -> list[str]:
    """eval_utils.py:98-117: comma-grouped, scientific, and simple numbers."""
    pattern_commas = r"-?\b\d{1,3}(?:,\d{3})+\b"
    pattern_scientific = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
    pattern_simple = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"
    return (
        re.findall(pattern_commas, string)
        + re.findall(pattern_scientific, string)
        + re.findall(pattern_simple, string)
    )


def get_key_subresponses(response: str) -> list[str]:
    """eval_utils.py:125-154. Note the reference lowercases BEFORE splitting
    on `\\.\\s(?=[A-Z])`, so that branch never fires and sub-responses are
    split on newlines only — reproduced faithfully."""
    response = response.strip().strip(".").lower()
    sub_responses = re.split(r"\.\s(?=[A-Z])|\n", response)
    indicators_of_keys = ["could be ", "so ", "is ", "thus ", "therefore ",
                          "final ", "answer ", "result "]
    key_responses = []
    for index, resp in enumerate(sub_responses):
        # the last sub-response may be a bare equation
        if index == len(sub_responses) - 1:
            indicators_of_keys.extend(["="])
        shortest_key_response = None
        for indicator in indicators_of_keys:
            if indicator in resp:
                tail = resp.split(indicator)[-1].strip()
                if not shortest_key_response:
                    shortest_key_response = tail
                elif len(tail) < len(shortest_key_response):
                    shortest_key_response = tail
        if shortest_key_response:
            if shortest_key_response.strip() not in [":", ",", ".", "!", "?", ";", ":", "'"]:
                key_responses.append(shortest_key_response)
    if len(key_responses) == 0:
        return [response]
    return key_responses


def parse_open_response(response: str) -> list:
    """eval_utils.py:120-172: key sub-responses + their extracted numbers,
    all normalized, deduplicated (set — order is not meaningful)."""
    key_responses = get_key_subresponses(response)
    pred_list = key_responses.copy()
    for resp in key_responses:
        pred_list.extend(extract_numbers(resp))
    tmp = []
    for pred in pred_list:
        tmp.extend(normalize_str(pred))
    return list(set(tmp))


def eval_multi_choice(gold_i, pred_i) -> bool:
    """eval_utils.py:176-190: exact match against the gold letter(s)."""
    golds = gold_i if isinstance(gold_i, list) else [gold_i]
    return any(answer == pred_i for answer in golds)


def eval_open(gold_i, pred_i: list) -> bool:
    """eval_utils.py:192-216: normalized golds vs parsed preds; strings
    match by containment (gold in pred), floats by equality."""
    norm_answers = []
    if isinstance(gold_i, list):
        for answer in gold_i:
            norm_answers.extend(normalize_str(answer))
    else:
        norm_answers = normalize_str(gold_i)
    for pred in pred_i:
        if isinstance(pred, str):
            for norm_ans in norm_answers:
                if isinstance(norm_ans, str) and norm_ans in pred:
                    return True
        else:
            if pred in norm_answers:
                return True
    return False


def eval_answer(sample_type: str, gold, pred) -> bool:
    if sample_type == "multiple-choice":
        return eval_multi_choice(gold, pred)
    preds = parse_open_response(pred) if isinstance(pred, str) else [pred]
    return eval_open(gold, preds)


def score_answers(answers: dict, answer_dict: dict) -> dict:
    """answers: qid → parsed prediction; answer_dict: qid →
    {'ground_truth', 'question_type'}. Per-subject + overall accuracy."""
    per_subject: dict[str, list[bool]] = {}
    for qid, pred in answers.items():
        meta = answer_dict.get(qid)
        if meta is None:
            continue
        subject = "_".join(qid.split("_")[1:-1])
        ok = eval_answer(meta["question_type"], meta["ground_truth"], pred)
        per_subject.setdefault(subject, []).append(ok)
    out = {}
    all_flat = []
    for s, v in sorted(per_subject.items()):
        out[s] = {"num": len(v), "acc": sum(v) / len(v)}
        all_flat.extend(v)
    out["Overall"] = {
        "num": len(all_flat),
        "acc": sum(all_flat) / max(len(all_flat), 1),
    }
    return out


def answer_records(runner, records) -> dict:
    """Each record ({"id", "question", "question_type", "options",
    "image_1"}) through `runner`: the parsed option letter of a
    multiple-choice answer, the text of an open one, by id."""
    from tokenpacker_tpu_torch.eval.runner import EvalSample

    metas = {}

    def samples():
        for rec in records:
            prompt, letters = build_prompt(rec)
            options = rec["options"]
            if isinstance(options, str):
                options = ast.literal_eval(options)
            metas[rec["id"]] = (rec["question_type"], letters,
                                {l: o for l, o in zip(letters, options)} if letters else {})
            yield EvalSample(question_id=rec["id"], prompt_text=prompt, image=rec["image_1"])

    parsed = {}
    for ans in runner.run(samples()):
        qtype, letters, index2ans = metas[ans["question_id"]]
        if qtype == "multiple-choice":
            parsed[ans["question_id"]] = parse_multi_choice_response(
                ans["text"], letters, index2ans
            )
        else:
            parsed[ans["question_id"]] = ans["text"]
    return parsed


def load_split(data_path: str, split: str):
    """The 30 subjects of the MMMU dataset's `split`, concatenated."""
    from datasets import concatenate_datasets, load_dataset

    return concatenate_datasets([load_dataset(data_path, s, split=split) for s in SUBJECTS])


def run(args, records=None):
    """Answers the records (the dataset's split when None; every
    `num_chunks`-th from `chunk_idx`, the reference mmmu_val.sh fan-out)
    and writes {id: parsed prediction} to `args.output`."""
    from tokenpacker_tpu_torch.api import load_pretrained_model
    from tokenpacker_tpu_torch.eval.runner import EvalRunner

    tokenizer, model, _, _ = load_pretrained_model(
        args.model_path, args.model_base, load_8bit=args.load_8bit, device=args.device,
    )
    # --num-beams: the reference's unused mmmu variant hardcodes 5
    # (eval/mmmu/eval/utils/model_utils.py:52); the imported one is greedy.
    runner = EvalRunner(model, tokenizer, conv_mode=args.conv_mode,
                        batch_size=args.batch_size, num_beams=args.num_beams)
    if records is None:
        records = load_split(args.data_path, args.split)
    if args.num_chunks > 1:
        records = [records[i] for i in range(args.chunk_idx, len(records), args.num_chunks)]
    parsed = answer_records(runner, records)
    with open(args.output, "w") as f:
        json.dump(parsed, f, indent=2)


def convert_to_test(args):
    """val-format results (jsonl of {'id', 'parsed_pred', ...}) → the MMMU
    test-split submission mapping {id: pred}; list preds collapse to their
    first element stringified. Faithful port of the reference reformatter
    (llava/eval/mmmu/eval/convert_to_test.py:18-25)."""
    out_json = {}
    with open(args.result_file) as f:
        for line in f:
            if not line.strip():
                continue
            sample = json.loads(line)
            result = sample["parsed_pred"]
            if isinstance(result, list):
                result = str(result[0])
            out_json[sample["id"]] = result
    with open(args.output_path, "w") as f:
        json.dump(out_json, f, indent=4)
    print(f"wrote {len(out_json)} entries to {args.output_path}")


def score(args):
    with open(args.answers) as f:
        answers = json.load(f)
    with open(args.answer_dict) as f:
        answer_dict = json.load(f)
    results = score_answers(answers, answer_dict)
    print(json.dumps(results, indent=2))


def build_parser():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("run")
    sp.add_argument("--model-path", required=True)
    sp.add_argument("--model-base", default=None)
    sp.add_argument("--data-path", default="MMMU/MMMU")
    sp.add_argument("--split", default="validation")
    sp.add_argument("--conv-mode", default="vicuna_v1")
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--num-beams", type=int, default=1)
    sp.add_argument("--num-chunks", type=int, default=1)
    sp.add_argument("--chunk-idx", type=int, default=0)
    sp.add_argument("--output", required=True)
    sp.add_argument("--load-8bit", action="store_true")
    sp.add_argument("--device", default="cuda", help="the card by default; 'cpu' to run there")
    sp.set_defaults(fn=run)
    sp = sub.add_parser("score")
    sp.add_argument("--answers", required=True)
    sp.add_argument("--answer-dict", required=True)
    sp.set_defaults(fn=score)
    sp = sub.add_parser("convert-to-test")
    sp.add_argument("--result-file", required=True)
    sp.add_argument("--output-path", required=True)
    sp.set_defaults(fn=convert_to_test)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
