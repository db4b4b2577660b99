"""Benchmark scorers (pure Python, no model needed): a copy of
`tokenpacker_tpu/eval/scorers.py`, equal to it on every input.

Parity targets:
- POPE yes/no P/R/F1: reference llava/eval/eval_pope.py
- VQA soft accuracy + answer normalization: llava/eval/m4c_evaluator.py
  (EvalAIAnswerProcessor + TextVQAAccuracyEvaluator)
- ANLS (DocVQA/STVQA): m4c_evaluator.py STVQAANLSEvaluator
- OCRBench per-category substring scoring: eval_ocr_bench.py:50-52
- GQA exact-match after normalization: official GQA eval protocol
"""

from __future__ import annotations

import json
import re
from collections import defaultdict


# ---------------------------------------------------------------------------
# EvalAI answer normalization (m4c_evaluator.py EvalAIAnswerProcessor)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCTS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def evalai_process_answer(item: str) -> str:
    """EvalAI answer processor (m4c_evaluator.py)."""
    item = item.replace("\n", " ").replace("\t", " ").strip().lower()
    # punctuation
    for p in _PUNCTS:
        if (p + " " in item or " " + p in item) or (re.search(_COMMA_STRIP, item) is not None):
            item = item.replace(p, "")
        else:
            item = item.replace(p, " ")
    item = _PERIOD_STRIP.sub("", item, re.UNICODE)
    # digits/articles
    out = []
    for word in item.lower().split():
        word = _NUMBER_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    # contractions
    for i, w in enumerate(out):
        if w in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[w]
    return " ".join(out)


def vqa_accuracy(pred: str, gt_answers: list[str]) -> float:
    """VQAv2 soft accuracy: min(#matching humans / 3, 1), averaged over
    leave-one-out ground-truth subsets (m4c_evaluator.TextVQAAccuracyEvaluator)."""
    pred = evalai_process_answer(pred)
    gts = [evalai_process_answer(a) for a in gt_answers]
    if len(gts) == 1:
        return float(pred == gts[0])
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1 :]
        matches = sum(1 for o in others if o == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(pred: str, gt_answers: list[str], tau: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (DocVQA/ST-VQA metric,
    m4c_evaluator.STVQAANLSEvaluator): max over GT of 1-NL if below tau."""
    best = 0.0
    p = " ".join(pred.strip().lower().split())
    for gt in gt_answers:
        g = " ".join(gt.strip().lower().split())
        if not p and not g:
            s = 1.0
        else:
            d = _levenshtein(p, g)
            nl = d / max(len(p), len(g), 1)
            s = 1.0 - nl if nl < tau else 0.0
        best = max(best, s)
    return best


# ---------------------------------------------------------------------------
# POPE (eval_pope.py)
# ---------------------------------------------------------------------------


def pope_normalize(text: str) -> str:
    """Map free-form answer to 'yes'/'no' (eval_pope.py semantics)."""
    words = text.lower().replace(".", " ").replace(",", " ").split()
    if "no" in words or "not" in words:
        return "no"
    return "yes"


def pope_scores(answers: list[dict], labels: list[dict]) -> dict:
    """answers: [{'question_id', 'text'}]; labels: [{'question_id', 'label'}]
    with label in {'yes','no'}. Returns accuracy/precision/recall/f1/yes_ratio."""
    label_map = {l["question_id"]: l["label"] for l in labels}
    tp = fp = tn = fn = 0
    yes_count = 0
    for a in answers:
        pred = pope_normalize(a["text"])
        gt = label_map[a["question_id"]]
        if pred == "yes":
            yes_count += 1
        if pred == "yes" and gt == "yes":
            tp += 1
        elif pred == "yes" and gt == "no":
            fp += 1
        elif pred == "no" and gt == "no":
            tn += 1
        else:
            fn += 1
    total = max(tp + fp + tn + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": (tp + tn) / total,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": yes_count / total,
    }


# ---------------------------------------------------------------------------
# OCRBench (eval_ocr_bench.py:50-52): substring match per category
# ---------------------------------------------------------------------------


def ocrbench_score(pred: str, gt_answers: list[str]) -> int:
    p = pred.lower().strip().replace("\n", " ")
    for gt in gt_answers:
        if gt.lower().strip() in p:
            return 1
    return 0


def ocrbench_aggregate(records: list[dict]) -> dict:
    """records: [{'type': category, 'score': 0/1}]."""
    by_cat: dict[str, list[int]] = defaultdict(list)
    for r in records:
        by_cat[r["type"]].append(r["score"])
    out = {k: sum(v) for k, v in by_cat.items()}
    out["total"] = sum(sum(v) for v in by_cat.values())
    return out


# ---------------------------------------------------------------------------
# GQA: exact match after lowercase/strip (official eval protocol core)
# ---------------------------------------------------------------------------


def gqa_accuracy(answers: list[dict], labels: dict) -> float:
    """answers: [{'question_id','text'}]; labels: qid → gt answer."""
    correct = 0
    for a in answers:
        gt = labels.get(str(a["question_id"]))
        if gt is not None and a["text"].strip().lower() == gt.strip().lower():
            correct += 1
    return correct / max(len(answers), 1)


# ---------------------------------------------------------------------------
# MME: per-task acc + acc+ (official calculation)
# ---------------------------------------------------------------------------


def mme_scores(records: list[dict]) -> dict:
    """records: [{'category', 'image_id', 'gt': 'yes'/'no', 'pred_text'}].
    Per category: acc (per question) + acc+ (both questions of an image
    right) summed as the official perception/cognition scores do."""
    by_cat = defaultdict(lambda: defaultdict(list))
    for r in records:
        pred = pope_normalize(r["pred_text"])
        by_cat[r["category"]][r["image_id"]].append(pred == r["gt"])
    out = {}
    for cat, images in by_cat.items():
        flat = [ok for pair in images.values() for ok in pair]
        acc = sum(flat) / max(len(flat), 1)
        acc_plus = sum(1 for pair in images.values() if all(pair) and len(pair) == 2) / max(
            len(images), 1
        )
        out[cat] = 100 * acc + 100 * acc_plus
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# TextCaps BLEU-4 (m4c_evaluator.py:301-334, TextCapsBleu4Evaluator)
# ---------------------------------------------------------------------------

# PTBTokenizer punctuation drop-list (pycocoevalcap ptbtokenizer.py) — the
# reference shells out to the Stanford Java tokenizer; this pure-Python
# approximation lowercases, splits words/numbers/punctuation PTB-style, and
# drops the same punctuation tokens. Differences from the Java tokenizer are
# limited to exotic unicode/bracket normalization.
_PTB_PUNCT = {
    "''", "'", "``", "`", "-lrb-", "-rrb-", "-lcb-", "-rcb-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}


def _ptb_tokenize(caption: str) -> list[str]:
    import re

    toks = re.findall(r"[a-z0-9]+(?:'[a-z0-9]+)*|\.\.\.|--|[^\sa-z0-9]", caption.lower())
    return [t for t in toks if t not in _PTB_PUNCT]


def _bleu_ngram_counts(tokens: list[str], n: int = 4) -> dict:
    counts: dict = {}
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            ng = tuple(tokens[i : i + k])
            counts[ng] = counts.get(ng, 0) + 1
    return counts


def bleu4(pred_list: list[dict]) -> float:
    """Corpus BLEU-4 with the pycocoevalcap BleuScorer math
    (option='closest': per-sentence reference length nearest the hypothesis;
    corpus-level brevity penalty; tiny/small smoothing constants) — the
    scorer behind the reference's TextCapsBleu4Evaluator
    (m4c_evaluator.py:321-334). pred_list items: {'pred_answer': str,
    'gt_answers': [str, ...]}."""
    import math

    n = 4
    small = 1e-9
    tiny = 1e-15  # so that if guess is 0 still return 0
    totalcomps = {"testlen": 0, "reflen": 0,
                  "guess": [0] * n, "correct": [0] * n}
    for entry in pred_list:
        test = _ptb_tokenize(entry["pred_answer"])
        refs = [_ptb_tokenize(r) for r in entry["gt_answers"]]
        testlen = len(test)
        # closest reference length (ties -> shorter, like the min() scan)
        reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
        refcounts: dict = {}
        for r in refs:
            for ng, c in _bleu_ngram_counts(r, n).items():
                refcounts[ng] = max(refcounts.get(ng, 0), c)
        counts = _bleu_ngram_counts(test, n)
        totalcomps["testlen"] += testlen
        totalcomps["reflen"] += reflen
        for ng, c in counts.items():
            k = len(ng) - 1
            totalcomps["guess"][k] += c
            totalcomps["correct"][k] += min(refcounts.get(ng, 0), c)
        # (guess[k] = max(0, testlen-k) implicitly via enumeration above)
    bleus = []
    bleu = 1.0
    for k in range(n):
        bleu *= (totalcomps["correct"][k] + tiny) / (totalcomps["guess"][k] + small)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (totalcomps["testlen"] + tiny) / (totalcomps["reflen"] + small)
    if ratio < 1:
        penalty = math.exp(1 - 1 / ratio)
        bleus = [b * penalty for b in bleus]
    return bleus[3]
