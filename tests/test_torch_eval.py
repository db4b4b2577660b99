"""The port's evaluation harness (`tokenpacker_tpu_torch/eval/`,
`data/prefetch`) against the JAX package's on the CPU.

- The scorers, the MMMU prompt and parsers, the converters and the score
  CLIs give what JAX's give on the JAX tests' cases and on seeded random
  inputs (the MMMU fallback's private `random.Random(42)` reseeded on
  both sides).
- Each benchmark subcommand's loader hands its runner the same samples
  (ids, prompt text, image path or pixels, extra) and writes the same
  answers file, with the model replaced by a recording runner on both
  sides. The MMBench TSV is read without pandas (`eval/tsv.read_table`)
  and gives what `pd.read_table` gives, NA set and numeric columns
  included.
- `EvalRunner` on `tiny_vlm_config` in fp32 on the CPU gives JAX's
  greedy answers in pad mode, in slice mode with ragged grids (JAX pads
  the views to a crop bucket, the port does not), on a text-only batch,
  with beams (and the batch cap) and with speculation at batch 1.
- R16: JAX's `score_cli mmbench` un-rotates --all-rounds answers the
  wrong way; a model right in every round scores 0% strict there and
  100% in the port. Single-round scores are equal.
"""

import argparse
import base64
import contextlib
import io
import json
import random
import string
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from tokenpacker_tpu.config import tiny_vlm_config as jax_tiny_config
from tokenpacker_tpu.eval import benchmarks as jax_benchmarks
from tokenpacker_tpu.eval import convert as jax_convert
from tokenpacker_tpu.eval import mmmu as jax_mmmu
from tokenpacker_tpu.eval import runner as jax_runner
from tokenpacker_tpu.eval import score_cli as jax_score_cli
from tokenpacker_tpu.eval import scorers as jax_scorers
from tokenpacker_tpu.generate import Generator as JaxGenerator
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.data.prefetch import DevicePrefetcher
from tokenpacker_tpu_torch.eval import benchmarks, convert, mmmu, runner, score_cli, scorers, tsv
from tokenpacker_tpu_torch.generate import Generator
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device, params_to_jax
from tests.test_mmmu_parser import GOLDS_OPEN, MC_CHOICES, MC_INDEX2ANS, MC_RESPONSES, OPEN_RESPONSES
from tests.test_trainer import Tok

NEW_TOKENS = 6


class IdTok(Tok):
    """The word tokenizer; decode writes one "<id>" a token, so that two
    answers compare their ids."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"<{int(i)}>" for i in ids)


# -- scorers --------------------------------------------------------------------


def _random_texts(rng: random.Random, n: int) -> list[str]:
    words = ["the", "a", "cat", "Two", "isnt", "dont", "yes", "No", "not", "1,000", "3.5",
             "hello", "world", "it's", "A", "b", "dog!", "(x)", "e.g.", "none", "ten"]
    chars = string.ascii_letters + string.digits + string.punctuation + "  \n\t"
    out = []
    for _ in range(n):
        if rng.random() < 0.5:
            out.append(" ".join(rng.choices(words, k=rng.randint(0, 8))))
        else:
            out.append("".join(rng.choices(chars, k=rng.randint(0, 24))))
    return out


def _scorer_calls():
    """(name, [(args, kwargs)]) for every scorer: the JAX tests' cases and
    seeded random ones."""
    rng = random.Random(19)
    texts = _random_texts(rng, 60)
    fixed = ["The Cat.", "two", "isnt", "A dog!", "cat", "dog", "hello", "helo", "xyz", "",
             "Yes, it is.", "No.", "It is not present", "the answer is PARIS", "london"]
    texts = fixed + texts
    gts = [["cat"] * 10, ["dog"] * 3 + ["cat"] * 7, ["hello"], [""], ["paris"]]
    gts += [rng.sample(texts, rng.randint(1, 10)) for _ in range(8)]
    answers = [{"question_id": i, "text": t} for i, t in enumerate(texts)]
    labels = [{"question_id": i, "label": rng.choice(["yes", "no"])} for i in range(len(texts))]
    gqa_labels = {str(i): rng.choice(texts) for i in range(0, len(texts), 2)}
    records = [{"type": rng.choice(["ocr", "kie", "vqa"]), "score": rng.randint(0, 1)}
               for _ in range(30)]
    mme = [{"category": rng.choice(["color", "count"]), "image_id": f"im{i // 2}",
            "gt": rng.choice(["yes", "no"]), "pred_text": rng.choice(texts)} for i in range(40)]
    vocab = ["a", "man", "dog", "rides", "red", "park", "the", "street", "plays", "in", "with",
             "ball", "bicycle", "down", "two", "It's", "3.5%!", "A man, riding;"]
    corpora = [[{"pred_answer": " ".join(rng.choices(vocab, k=rng.randint(1, 12))),
                 "gt_answers": [" ".join(rng.choices(vocab, k=rng.randint(1, 12)))
                                for _ in range(rng.randint(1, 5))]}
                for _ in range(rng.randint(1, 6))] for _ in range(20)]
    corpora.append([{"pred_answer": "a man rides a bicycle",
                     "gt_answers": ["a man rides a bicycle down the long street"]}])
    return {
        "evalai_process_answer": [((t,), {}) for t in texts],
        "vqa_accuracy": [((t, g), {}) for t in texts[:40] for g in gts],
        "anls": [((t, g), {}) for t in texts[:40] for g in gts] + [(("helo", ["hello"]),
                                                                      {"tau": 0.3})],
        "pope_normalize": [((t,), {}) for t in texts],
        "pope_scores": [((answers, labels), {}), ((answers[:4], labels[:4]), {})],
        "ocrbench_score": [((t, g), {}) for t in texts[:40] for g in gts],
        "ocrbench_aggregate": [((records,), {})],
        "gqa_accuracy": [((answers, gqa_labels), {})],
        "mme_scores": [((mme,), {})],
        "_ptb_tokenize": [((t,), {}) for t in texts + [p["pred_answer"] for c in corpora
                                                       for p in c]],
        "bleu4": [((c,), {}) for c in corpora],
    }


@pytest.mark.parametrize("name", list(_scorer_calls()))
def test_scorer_matches_jax(name):
    calls = _scorer_calls()[name]
    for args, kw in calls:
        assert getattr(scorers, name)(*args, **kw) == getattr(jax_scorers, name)(*args, **kw), args


# -- MMMU -----------------------------------------------------------------------


def _reseed():
    jax_mmmu._fallback_rng.seed(42)
    mmmu._fallback_rng.seed(42)


def test_mmmu_multi_choice_parser_matches_jax():
    """The JAX parser test's responses (the fallback's draws included, in
    order) over two option sets."""
    _reseed()
    for choices, index2ans in ((MC_CHOICES, MC_INDEX2ANS), (["A", "B"], {"A": "true", "B": "false"})):
        for resp in MC_RESPONSES + ["true", "(A) no (B)", "neither honestly speaking my friend"]:
            got = mmmu.parse_multi_choice_response(resp, choices, index2ans)
            assert got == jax_mmmu.parse_multi_choice_response(resp, choices, index2ans), resp


def test_mmmu_open_parser_and_scoring_match_jax():
    cases = ["42", " 42 ", "1,000", "3.14159", "abc", "A", "", "  x  ", "-5", "nan-ish", "1e3",
             "1,23", "0.126", "0.125"]
    for s in cases:
        assert mmmu.check_is_number(s) == jax_mmmu.check_is_number(s)
        assert mmmu.normalize_str(s) == jax_mmmu.normalize_str(s)
    for resp in OPEN_RESPONSES:
        assert mmmu.extract_numbers(resp) == jax_mmmu.extract_numbers(resp)
        assert mmmu.get_key_subresponses(resp) == jax_mmmu.get_key_subresponses(resp)
        pred = mmmu.parse_open_response(resp)
        assert sorted(pred, key=repr) == sorted(jax_mmmu.parse_open_response(resp), key=repr)
        for gold in GOLDS_OPEN:
            assert mmmu.eval_open(gold, pred) == jax_mmmu.eval_open(gold, pred)
            assert mmmu.eval_answer("open", gold, resp) == jax_mmmu.eval_answer("open", gold, resp)
    for gold in ["A", "B", ["A", "C"], ["D"]]:
        for pred in MC_CHOICES + ["E"]:
            assert mmmu.eval_answer("multiple-choice", gold, pred) == \
                jax_mmmu.eval_answer("multiple-choice", gold, pred)
    answers = {f"validation_Art_Theory_{i}": MC_CHOICES[i % 4] for i in range(9)}
    answers.update({f"validation_Math_{i}": r for i, r in enumerate(OPEN_RESPONSES)})
    answer_dict = {f"validation_Art_Theory_{i}": {"ground_truth": MC_CHOICES[i % 3],
                                                  "question_type": "multiple-choice"}
                   for i in range(9)}
    answer_dict.update({f"validation_Math_{i}": {"ground_truth": GOLDS_OPEN[i % len(GOLDS_OPEN)],
                                                 "question_type": "open"}
                        for i in range(len(OPEN_RESPONSES))})
    assert mmmu.score_answers(answers, answer_dict) == jax_mmmu.score_answers(answers, answer_dict)


def test_mmmu_prompt_and_converter_match_jax(tmp_path):
    samples = [
        {"question": "<image 1> What is shown? <image 2>", "question_type": "multiple-choice",
         "options": "['cat', 'dog', 'a \"fox\"']"},
        {"question": "Pick one", "question_type": "multiple-choice", "options": ["x", "y"]},
        {"question": "<image 1>How many?", "question_type": "open", "options": "[]"},
    ]
    for s in samples:
        assert mmmu.build_prompt(s) == jax_mmmu.build_prompt(s)
    rf = tmp_path / "val.jsonl"
    rows = [{"id": "validation_Art_1", "parsed_pred": "B"},
            {"id": "validation_Math_2", "parsed_pred": ["3.14", "pi"]},
            {"id": "validation_Bio_3", "parsed_pred": [7]}]
    rf.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for mod, name in ((mmmu, "port.json"), (jax_mmmu, "jax.json")):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.convert_to_test(argparse.Namespace(result_file=str(rf),
                                                   output_path=str(tmp_path / name)))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# -- the loaders, the TSV reader and the answers files ------------------------------


def _png_b64(rng, h, w) -> str:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def write_mmbench_tsv(path, seed=0):
    """Rows that show pandas' rules: an empty hint and a "NA" one (NaN,
    dropped), "None" and "" options (dropped: row 1 has 2 options), an
    integer option column and one with a gap (floats: "3.0"), an integer
    index, a column of True/False, a quoted hint with a tab inside and a
    quote inside a question."""
    rng = np.random.default_rng(seed)
    header = ["index", "question", "hint", "A", "B", "C", "D", "answer", "category", "flag",
              "image"]
    rows = [
        [0, "pick one", "", "cat", "5", "3", "owl", "A", "x", "True"],
        [1, "which is \"big\"?", "NA", "1", "2", "None", "", "B", "y", "False"],
        [2, "count them", "There are\tsome.", "3", "4", "5", "6", "C", "x", "true"],
        [7, "numbers", "hint", "10", "11", "12", "13", "D", "z", "FALSE"],
    ]
    # A: text and numbers (text as written); B: integers ("5"); C: integers
    # with a gap (floats, "3.0"); D: text with an empty field (dropped)
    lines = ["\t".join(header)]
    for r in rows:
        fields = [str(r[0])] + [f'"{f}"' if "\t" in f else f for f in r[1:]]
        lines.append("\t".join(fields + [_png_b64(rng, 30 + 7 * r[0], 40)]))
    path.write_text("\n".join(lines) + "\n")
    return path


def test_read_table_gives_what_pandas_gives(tmp_path):
    import pandas as pd

    cols = {
        "ints": ["1", "2", "3", "4"], "ints_na": ["1", "", "3", "NA"], "lead0": ["007", "2", "+3",
                                                                               " 4"],
        "floats": ["1.5", "2", "1e3", ".5"], "inf": ["inf", "-Infinity", "3", "nan"],
        "bools": ["True", "FALSE", "tRue", "false"], "bool_na": ["True", "", "False", "N/A"],
        "mixed": ["1", "a", "3", "None"], "text": ["x y", " a", "b ", "null"],
        "hex": ["0x10", "1", "1_000", "2"], "na_only": ["", "NA", "nan", "#N/A"],
        "quoted": ['"a\tb"', 'say "hi"', '"multi\nline"', "plain"],
        "long": ["x" * 300_000, "y", "", "z"],  # past the csv module's default field limit
    }
    names = list(cols)
    lines = ["\t".join(names)] + ["\t".join(cols[c][i] for c in names) for i in range(4)]
    path = tmp_path / "t.tsv"
    path.write_text("\n".join(lines) + "\n\n")
    got = tsv.read_table(str(path))
    want = [row for _, row in pd.read_table(path).iterrows()]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w.index)
        for c in names:
            a, b = g[c], w[c]
            if isinstance(b, float):
                assert type(a) is float and (f"{a}" == f"{b}"), (c, a, b)
            else:
                assert type(a) is type(b) and a == b, (c, a, b)


class Recorder:
    """Stands in for the model: records the samples it is handed and
    answers each with a text made from its id and prompt."""

    def __init__(self):
        self.samples = []

    def run(self, samples):
        for s in samples:
            self.samples.append(s)
            yield {"question_id": s.question_id, "text": f"ans {s.question_id} {len(s.prompt_text)}",
                   **s.extra}


def _sample_view(s) -> dict:
    img = None if s.image is None else (s.image.size, s.image.mode, s.image.tobytes())
    return {"question_id": s.question_id, "prompt_text": s.prompt_text,
            "image_path": s.image_path, "image": img, "extra": s.extra}


def _benchmark_fixture(tmp_path):
    rng = np.random.default_rng(1)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for n in ("a.png", "b.png", "c.png"):
        Image.fromarray(rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)).save(imgs / n)
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(r) + "\n" for r in [
        {"question_id": "q0", "image": "a.png", "text": "what is this"},
        {"question_id": 1, "text": "text only", "image": ""},
        {"question_id": 2, "image": "c.png", "text": "<image>\nsay it"}]))
    (tmp_path / "doc.json").write_text(json.dumps({"data": [
        {"questionId": 5, "question": "date?", "image": "b.png"},
        {"questionId": 6, "question": "total?", "image": "c.png"}]}))
    (tmp_path / "ocr.json").write_text(json.dumps([
        {"question": "read", "image_path": "a.png", "type": "Regular", "answers": ["hi"],
         "dataset_name": "ct80"},
        {"question": "again", "image_path": "b.png", "type": "KIE", "answers": "one"}]))
    write_mmbench_tsv(tmp_path / "mmb.tsv")
    return {"vqa": ["--question-file", str(tmp_path / "q.jsonl"), "--image-folder", str(imgs)],
            "textqa": ["--question-file", str(tmp_path / "q.jsonl")],
            "docvqa": ["--question-file", str(tmp_path / "doc.json"), "--image-folder", str(imgs)],
            "ocrbench": ["--question-file", str(tmp_path / "ocr.json"), "--image-folder",
                         str(imgs)],
            "mmbench": ["--question-file", str(tmp_path / "mmb.tsv")]}


@pytest.mark.parametrize("bench,flags", [
    ("vqa", []), ("vqa", ["--num-chunks", "2", "--chunk-idx", "1"]), ("textqa", []),
    ("docvqa", []), ("ocrbench", []), ("mmbench", []),
    ("mmbench", ["--all-rounds", "--single-pred-prompt"]),
    ("mmbench", ["--all-rounds", "--lang", "cn", "--single-pred-prompt", "--num-chunks", "2"]),
])
def test_benchmark_loaders_and_answers_match_jax(bench, flags, tmp_path, monkeypatch):
    """Each subcommand's samples and answers file equal JAX's; the port's
    MMBench loader runs with pandas hidden."""
    fixture = _benchmark_fixture(tmp_path)
    recorders = {}
    for side, mod in (("port", benchmarks), ("jax", jax_benchmarks)):
        recorders[side] = Recorder()
        monkeypatch.setattr(mod, "_load_model", lambda args, r=recorders[side]: r)
    argv = [bench, "--model-path", "unused", *fixture[bench], *flags]
    out = {}
    for side, mod in (("port", benchmarks), ("jax", jax_benchmarks)):
        out[side] = tmp_path / f"{side}.jsonl"
        args = mod.build_parser().parse_args(argv + ["--answers-file", str(out[side])])
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            if side == "port":
                with monkeypatch.context() as m:
                    m.setitem(sys.modules, "pandas", None)
                    args.fn(args)
            else:
                args.fn(args)
        out[side + " printed"] = printed.getvalue()
    port, want = recorders["port"].samples, recorders["jax"].samples
    assert len(port) == len(want) > 0
    assert [_sample_view(s) for s in port] == [_sample_view(s) for s in want]
    assert out["port"].read_bytes() == out["jax"].read_bytes()
    assert out["port printed"] == out["jax printed"]


def test_get_chunk_matches_jax():
    for n in range(0, 12):
        for chunks in range(1, 5):
            for i in range(chunks):
                lst = list(range(n))
                assert runner.get_chunk(lst, chunks, i) == jax_runner.get_chunk(lst, chunks, i)


# -- the prefetcher ---------------------------------------------------------------


def test_prefetcher_keeps_order_and_depth():
    for depth in (1, 2, 3):
        pulled = []

        def source():
            for i in range(12):
                pulled.append(i)
                yield i

        it = iter(DevicePrefetcher(source(), transform=lambda x: x * 2, depth=depth))
        assert next(it) == 0
        time.sleep(0.2)  # let the worker run as far ahead as it may
        # one item handed out, `depth` in the queue, one made and waiting to go in
        assert len(pulled) <= depth + 2, (depth, pulled)
        assert [0] + list(it) == [2 * i for i in range(12)]


def test_prefetcher_raises_at_the_failing_item():
    def bad(x):
        if x == 3:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for v in DevicePrefetcher(range(10), transform=bad, depth=2):
            got.append(v)
    assert got == [0, 1, 2]

    def source():
        yield 1
        raise RuntimeError("source failed")

    got = []
    with pytest.raises(RuntimeError, match="source failed"):
        for v in DevicePrefetcher(source(), depth=1):
            got.append(v)
    assert got == [1]


def test_prefetcher_to_device_moves_nested_arrays():
    from collections import namedtuple

    Pair = namedtuple("Pair", "a b")
    item = {"x": np.arange(4, dtype=np.float32), "y": [torch.ones(2), (np.zeros(3), "keep")],
            "p": Pair(np.ones(1), 7), "n": None}
    (got,) = list(DevicePrefetcher([item], to_device=True, device="cpu"))
    assert isinstance(got["x"], torch.Tensor) and got["x"].tolist() == [0, 1, 2, 3]
    assert isinstance(got["y"], list) and isinstance(got["y"][1], tuple)
    assert torch.equal(got["y"][0], torch.ones(2)) and got["y"][1][1] == "keep"
    assert isinstance(got["y"][1][0], torch.Tensor) and got["y"][1][0].shape == (3,)
    assert isinstance(got["p"], Pair) and isinstance(got["p"].a, torch.Tensor) and got["p"].b == 7
    assert got["n"] is None
    # without to_device the item is handed over as it is
    (same,) = list(DevicePrefetcher([item], depth=1))
    assert same is item


# -- EvalRunner against the JAX runner ---------------------------------------------


class Loaded:
    def __init__(self, cfg, generator):
        self.config, self.generator = cfg, generator


@pytest.fixture(scope="module")
def models():
    """The tiny VLM from one seed in both packages behind the id tokenizer;
    each generator records the views of every batch it is handed."""
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=3, device="cpu", dtype=torch.float32)
    tok = IdTok()
    port = Loaded(cfg, Generator(params, cfg, tok))
    want = Loaded(jax_tiny_config(), JaxGenerator(params_to_jax(params), jax_tiny_config(), tok))
    views = {"port": [], "jax": []}
    for side, m in (("port", port), ("jax", want)):
        real = m.generator.generate

        def generate(batch, *a, real=real, side=side, **kw):
            views[side].append(None if batch["images"] is None else batch["images"].shape[0])
            return real(batch, *a, **kw)

        m.generator.generate = generate
    return {"port": port, "jax": want, "tok": tok, "views": views}


def _samples(cls, sizes, texts=None):
    rng = np.random.default_rng(5)
    out = []
    for i, hw in enumerate(sizes):
        img = None if hw is None else Image.fromarray(
            rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
        text = texts[i] if texts else f"what is item {i}"
        out.append(cls(question_id=i, prompt_text=text, image=img, extra={"k": i}))
    return out


@pytest.mark.parametrize("case", ["pad", "slice ragged", "text only", "beams", "speculative"])
def test_runner_matches_jax(models, case):
    kw, sizes, texts = {}, [(50, 60), (120, 40), (70, 150)], None
    if case == "pad":
        kw = dict(batch_size=2)
    elif case == "slice ragged":
        kw = dict(batch_size=3, image_aspect_ratio="slice", patch_num=9)
        sizes = [(50, 60), (120, 40), (70, 190)]
    elif case == "text only":
        kw, sizes = dict(batch_size=3), [None, None, None]
        texts = ["tell me a story", "what now", "hi"]
    elif case == "beams":
        kw = dict(batch_size=16, num_beams=2)
    else:
        kw = dict(batch_size=1, speculative=2)
    for v in models["views"].values():
        v.clear()
    got_runner = runner.EvalRunner(models["port"], models["tok"], max_new_tokens=NEW_TOKENS, **kw)
    want_runner = jax_runner.EvalRunner(models["jax"], models["tok"], max_new_tokens=NEW_TOKENS,
                                        **kw)
    got = list(got_runner.run(_samples(runner.EvalSample, sizes, texts)))
    want = list(want_runner.run(_samples(jax_runner.EvalSample, sizes, texts)))
    assert got == want
    assert [a["question_id"] for a in got] == [0, 1, 2]
    assert all(a["text"].startswith("<") for a in got)
    assert got_runner.batch_size == want_runner.batch_size
    assert got_runner.stop_strings() == want_runner.stop_strings()
    if case == "beams":
        assert got_runner.batch_size == 8  # 16 // num_beams
    # the port hands the generator each batch's real views; JAX pads them
    # to its crop bucket (zero views that no slot reads)
    views = models["views"]
    assert views["jax"] == [None if n is None else jax_runner._crop_bucket(n)
                            for n in views["port"]]
    if case == "slice ragged":
        (n,) = views["port"]  # one batch of 3 images tiled into their grids
        assert jax_runner._crop_bucket(n) > n
    if case == "text only":
        assert views["port"] == [None]


# -- R16 and the score CLIs ------------------------------------------------------------


def _run_cli(mod, argv) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main(argv)
    return out.getvalue()


def test_r16_all_rounds_unrotation(tmp_path):
    """MMBench rows with four options through four rotation rounds, and a
    model that picks the letter showing the right option's text each round:
    JAX's scorer reads 0% strict, the port's 100%. Single-round answers
    (and the majority vote here) score the same in both."""
    rng = np.random.default_rng(0)
    tsv_path = tmp_path / "dev.tsv"
    tsv_path.write_text("index\tquestion\tA\tB\tC\tD\tanswer\timage\n"
                        f"0\tq\to1\to2\to3\to4\tB\t{_png_b64(rng, 8, 8)}\n"
                        f"1\tq\to1\to2\to3\to4\tC\t{_png_b64(rng, 8, 8)}\n"
                        f"2\tq\to1\to2\tNA\t\tA\t{_png_b64(rng, 8, 8)}\n")
    rounds = list(benchmarks.iter_mmbench(str(tsv_path), all_rounds=True))
    assert [_sample_view(s) for s in rounds] == [
        _sample_view(s) for s in jax_benchmarks.iter_mmbench(str(tsv_path), all_rounds=True)]
    answer = {0: "o2", 1: "o3", 2: "o1"}
    perfect = []
    for s in rounds:
        shown = json.loads(s.extra["options"]).index(answer[s.question_id])
        perfect.append({"question_id": s.question_id, "text": "ABCD"[shown], **s.extra})
    single = [{"question_id": q, "text": t, "option_char": json.dumps(["A", "B", "C", "D"])}
              for q, t in ((0, "B"), (1, "a"), (2, ""))]
    # rows 0 and 1 have four options; row 2 two, whose rotation is its own
    # inverse, so JAX's mapping is right there
    four = [r for r in perfect if r["question_id"] != 2]
    two = [r for r in perfect if r["question_id"] == 2]
    for name, rows in (("perfect", four), ("two", two), ("single", single)):
        (tmp_path / f"{name}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    argv = ["mmbench", "--annotation-file", str(tsv_path), "--result-file"]
    strict = ["--all-rounds-strict"]
    assert _run_cli(jax_score_cli, argv + [str(tmp_path / "perfect.jsonl")] + strict) == \
        "Samples: 2\nAccuracy: 0.00%\n"
    assert _run_cli(score_cli, argv + [str(tmp_path / "perfect.jsonl")] + strict) == \
        "Samples: 2\nAccuracy: 100.00%\n"
    for mod in (score_cli, jax_score_cli):
        assert _run_cli(mod, argv + [str(tmp_path / "two.jsonl")] + strict) == \
            "Samples: 1\nAccuracy: 100.00%\n"
    for extra in ([], strict):
        f = str(tmp_path / "single.jsonl")
        assert _run_cli(score_cli, argv + [f] + extra) == _run_cli(jax_score_cli, argv + [f] + extra)
    f = str(tmp_path / "perfect.jsonl")
    assert _run_cli(score_cli, argv + [f]) == _run_cli(jax_score_cli, argv + [f])


def _score_fixture(tmp_path):
    res = [{"question_id": i, "text": t, "prompt": f"what is written {i}\nmore"}
           for i, t in enumerate(["Yes", "no", "hello", "Hello.", "helo"])]
    (tmp_path / "res.jsonl").write_text("".join(json.dumps(r) + "\n" for r in res))
    (tmp_path / "q.jsonl").write_text("".join(
        json.dumps({"question_id": i, "category": "random" if i % 2 else "popular"}) + "\n"
        for i in range(5)))
    ann = tmp_path / "coco"
    ann.mkdir()
    for cat in ("random", "popular"):
        (ann / f"coco_pope_{cat}.json").write_text("".join(
            json.dumps({"question_id": i, "label": "yes" if i % 3 else "no"}) + "\n"
            for i in range(5)))
    (tmp_path / "textvqa.json").write_text(json.dumps({"data": [
        {"image_id": f"im{i}", "question": f"what is written {i}",
         "answers": [{"answer": "hello"}] * 7 + [{"answer": "yes"}] * 3} for i in range(5)]}))
    (tmp_path / "pred.json").write_text(json.dumps(
        [{"questionId": f"q{i}", "prediction": t} for i, t in enumerate(["cat", "Dog", "red"])]))
    (tmp_path / "gqa_q.json").write_text(json.dumps(
        {"q0": {"answer": "cat"}, "q1": {"answer": "dog"}, "q2": {}}))
    (tmp_path / "doc.json").write_text(json.dumps({"data": [
        {"questionId": i, "answers": ["hello", "hi"]} for i in range(4)]}))
    return {
        "pope": ["--annotation-dir", str(ann), "--question-file", str(tmp_path / "q.jsonl"),
                 "--result-file", str(tmp_path / "res.jsonl")],
        "textvqa": ["--annotation-file", str(tmp_path / "textvqa.json"), "--result-file",
                    str(tmp_path / "res.jsonl")],
        "gqa": ["--questions", str(tmp_path / "gqa_q.json"), "--result-file",
                str(tmp_path / "pred.json")],
        "anls": ["--annotation-file", str(tmp_path / "doc.json"), "--result-file",
                 str(tmp_path / "res.jsonl")],
    }


@pytest.mark.parametrize("cmd", ["pope", "textvqa", "gqa", "anls"])
def test_score_cli_matches_jax(cmd, tmp_path):
    argv = [cmd, *_score_fixture(tmp_path)[cmd]]
    out = _run_cli(score_cli, argv)
    assert out and out == _run_cli(jax_score_cli, argv)


def _convert_fixture(tmp_path):
    res = [{"question_id": i, "text": t, "category": "color" if i < 2 else None,
            "image": f"{i}.png", "prompt": "is it?", "annotation": "yes"}
           for i, t in enumerate(["The Cat.", "Two dogs\nrun", "isnt", "A dog!"])]
    (tmp_path / "res.jsonl").write_text("".join(json.dumps(r) + "\n" for r in res) + "\n")
    (tmp_path / "split.jsonl").write_text("".join(
        json.dumps({"question_id": i}) + "\n" for i in range(6)))
    (tmp_path / "viz.jsonl").write_text("".join(
        json.dumps({"image": i, "question_id": i}) + "\n" for i in (0, 2, 9)))
    return {"gqa": ["--src", "res.jsonl", "--dst", "out/x.json"],
            "vqav2": ["--src", "res.jsonl", "--test-split", "split.jsonl", "--dst", "out/x.json"],
            "vizwiz": ["--src", "res.jsonl", "--annotation-file", "viz.jsonl", "--dst",
                       "out/x.json"],
            "mmvet": ["--src", "res.jsonl", "--dst", "out/x.json"],
            "docvqa": ["--src", "res.jsonl", "--dst", "out/x.json"],
            "mme": ["--src", "res.jsonl", "--dst-dir", "out"]}


@pytest.mark.parametrize("cmd", ["gqa", "vqav2", "vizwiz", "mmvet", "docvqa", "mme"])
def test_converters_match_jax(cmd, tmp_path, monkeypatch):
    files = {}
    for side, mod in (("port", convert), ("jax", jax_convert)):
        d = tmp_path / side
        d.mkdir()
        argv = _convert_fixture(d)[cmd]
        monkeypatch.chdir(d)
        mod.main([cmd, *argv])
        files[side] = {p.relative_to(d / "out"): p.read_bytes() for p in (d / "out").rglob("*")}
    assert files["port"] and files["port"] == files["jax"]


def test_convert_mmbench_writes_pandas_csv_without_pandas(tmp_path, monkeypatch):
    """With pandas but no Excel writer, the port and JAX write the same CSV
    through pandas; with pandas hidden the port writes that CSV itself."""
    import pandas as pd

    tsv_path = write_mmbench_tsv(tmp_path / "dev.tsv")
    answers = [{"question_id": 0, "text": "A"}, {"question_id": 2, "text": "say, \"C\""},
               {"question_id": 2, "text": "C again"}]
    (tmp_path / "res.jsonl").write_text("".join(json.dumps(r) + "\n" for r in answers))

    def no_excel(*a, **k):
        raise ImportError("no openpyxl")

    monkeypatch.setattr(pd.DataFrame, "to_excel", no_excel)
    out = {}
    for side, mod, hide in (("jax", jax_convert, False), ("port", convert, False),
                            ("bare", convert, True)):
        dst = tmp_path / side / "up.xlsx"
        with monkeypatch.context() as m, contextlib.redirect_stdout(io.StringIO()):
            if hide:
                m.setitem(sys.modules, "pandas", None)
            mod.convert_mmbench(str(tsv_path), str(tmp_path / "res.jsonl"), str(dst))
        out[side] = (tmp_path / side / "up.csv").read_bytes()
    assert out["port"] == out["jax"]
    assert out["bare"] == out["jax"]
    assert b"prediction" in out["bare"] and b"C again" in out["bare"]  # the last answer wins
