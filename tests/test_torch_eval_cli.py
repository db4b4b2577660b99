"""The port's eval entry points on the CPU against the JAX package's CLIs,
on one tiny checkpoint in the reference layout.

- `benchmarks.main` for `vqa` and `mmbench` (`--device cpu`): answers
  files byte-equal to the JAX CLI's. Both loaders are patched to load in
  fp32: at their bf16 default the two packages' CPU products round
  differently and a greedy token can flip (the mmbench case did, at its
  fifth token). The word tokenizer stands in for the checkpoint's on both
  sides.
- `run_demo.main`: the same printed text as JAX's (fp32 the same way),
  greedy, with beams and with speculation.
- The copied launchers `gqa.sh` and `mmbench.sh` as shell scripts with
  CHUNKS=2 and EXTRA_ARGS="--device cpu ...", through merge, convert and
  score, and `eval.runway`'s fixture dry run (import, smoke, both
  launchers, compare). These run the CLIs in subprocesses, which load the
  checkpoint's byte-level GPT2 tokenizer.
- Import hygiene: no port eval module pulls in jax, the JAX package,
  pandas, datasets or transformers.
"""

import base64
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tokenpacker_tpu import api as jax_api
from tokenpacker_tpu.eval import benchmarks as jax_benchmarks
from tokenpacker_tpu.eval import run_demo as jax_run_demo
from tokenpacker_tpu_torch import api
from tokenpacker_tpu_torch.config import tiny_vlm_config
from tokenpacker_tpu_torch.eval import benchmarks, run_demo, runway
from tokenpacker_tpu_torch.io import hf_export
from tokenpacker_tpu_torch.io.weights import init_vlm_on_device
from tests.test_eval_launchers import _write_gpt2_byte_tokenizer
from tests.test_torch_eval import IdTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "tokenpacker_tpu_torch", "eval", "scripts")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """tiny_vlm_config from seed 0 in the reference's layout (config.json,
    pytorch_model.bin with the tower's keys) and a byte-level GPT2
    tokenizer that loads offline."""
    d = tmp_path_factory.mktemp("tokenpacker-tiny")
    cfg = tiny_vlm_config()
    params = init_vlm_on_device(cfg, seed=0, device="cpu", dtype=torch.float32)
    sd = hf_export.to_torch_state_dict(hf_export.export_vlm_state_dict(params, cfg))
    torch.save(sd, d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    _write_gpt2_byte_tokenizer(d)
    return str(d)


@pytest.fixture
def word_tokenizer(monkeypatch):
    """Both packages' `_load_tokenizer` replaced by one id tokenizer and
    their `load_pretrained_model` loading in fp32; HF offline, the JAX
    CLIs' compilation cache off."""
    tok = IdTok()
    for mod, fp32 in ((api, torch.float32), (jax_api, jnp.float32)):
        monkeypatch.setattr(mod, "_load_tokenizer", lambda path: tok)
        monkeypatch.setattr(mod, "load_pretrained_model",
                            functools.partial(mod.load_pretrained_model, dtype=fp32))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TOKENPACKER_COMPILE_CACHE", "off")
    monkeypatch.delenv("TOKENPACKER_PLATFORM", raising=False)
    return tok


def _images(d, names, size=(60, 72)):
    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    for n in names:
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(os.path.join(d, n))


def _jsonl(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _mmbench_tsv(path, n=3):
    rng = np.random.default_rng(0)
    lines = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\timage"]
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(buf, "PNG")
        c, d = ("fox", "owl") if i else ("", "NA")  # row 0: two options
        lines.append(f"{i}\tpick one {i}\t{'' if i % 2 else 'a hint'}\tcat\tdog\t{c}\t{d}\tA\t"
                     + base64.b64encode(buf.getvalue()).decode())
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("bench", ["vqa", "mmbench"])
def test_benchmark_cli_answers_equal_jax(bench, ckpt_dir, tmp_path, word_tokenizer):
    if bench == "vqa":
        _images(tmp_path / "imgs", ["a.png", "b.png", "c.png"])
        _jsonl(str(tmp_path / "q.jsonl"), [
            {"question_id": f"q{i}", "image": f"{c}.png", "text": f"what is this {i}"}
            for i, c in enumerate("abc")] + [{"question_id": "t", "text": "text only"}])
        flags = ["--question-file", str(tmp_path / "q.jsonl"), "--image-folder",
                 str(tmp_path / "imgs"), "--batch-size", "2"]
    else:
        flags = ["--question-file", str(_mmbench_tsv(tmp_path / "dev.tsv")), "--all-rounds",
                 "--single-pred-prompt", "--batch-size", "4"]
    common = [bench, "--model-path", ckpt_dir, *flags, "--max-new-tokens", "5"]
    benchmarks.main(common + ["--answers-file", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    jax_benchmarks.main(common + ["--answers-file", str(tmp_path / "jax.jsonl")])
    got = (tmp_path / "port.jsonl").read_bytes()
    lines = got.decode().splitlines()
    assert len(lines) == (4 if bench == "vqa" else 2 + 4 + 4)
    assert all(json.loads(line)["model_id"] == "tokenpacker-tpu" for line in lines)
    assert got == (tmp_path / "jax.jsonl").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--num-beams", "2"], ["--speculative-k", "2"]])
def test_run_demo_prints_what_jax_prints(flags, ckpt_dir, tmp_path, capsys, word_tokenizer):
    _images(tmp_path, ["x.png", "y.png"], size=(50, 90))
    argv = ["--model-path", ckpt_dir, "--image-file", f"{tmp_path}/x.png,{tmp_path}/y.png",
            "--query", "what is it", "--temperature", "0", "--max-new-tokens", "6", *flags]
    run_demo.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jax_run_demo.main(argv)
    want = capsys.readouterr().out
    assert len(got.splitlines()) == 2 and got.startswith("<")
    assert got == want


def _launcher_env(ckpt_dir, **extra):
    env = dict(os.environ)
    env.update({"CKPT": ckpt_dir, "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
                "EXTRA_ARGS": "--device cpu --max-new-tokens 4", "BATCH": "2", **extra})
    return env


def _run_script(script, env):
    r = subprocess.run(["bash", os.path.join(SCRIPTS, script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"{script}:\nSTDOUT:{r.stdout[-3000:]}\nSTDERR:{r.stderr[-3000:]}"
    return r


def test_gqa_launcher(ckpt_dir, tmp_path):
    """CHUNKS=2: two CLI processes side by side, merged by cat, converted to
    GQA's predictions file, then scored by `score_cli gqa`."""
    root = tmp_path / "gqa"
    _images(root / "images", ["a.png", "b.png", "c.png"])
    _jsonl(str(root / "llava_gqa_testdev_balanced.jsonl"),
           [{"question_id": f"q{i}", "image": f"{c}.png", "text": f"what {i}"}
            for i, c in enumerate("abc")])
    _run_script("gqa.sh", _launcher_env(ckpt_dir, GQADIR=str(root), CHUNKS="2"))
    chunks = [(root / "answers" / "llava_gqa_testdev_balanced" / f"chunk{i}.jsonl").read_text()
              for i in range(2)]
    assert [len(c.splitlines()) for c in chunks] == [2, 1]
    preds = json.loads((root / "testdev_balanced_predictions.json").read_text())
    assert [p["questionId"] for p in preds] == ["q0", "q1", "q2"]
    (root / "labels.json").write_text(json.dumps({f"q{i}": {"answer": "no"} for i in range(3)}))
    r = subprocess.run([sys.executable, "-m", "tokenpacker_tpu_torch.eval.score_cli", "gqa",
                        "--result-file", str(root / "testdev_balanced_predictions.json"),
                        "--questions", str(root / "labels.json")],
                       cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert r.stdout.startswith("Accuracy: ")


def test_mmbench_launcher(ckpt_dir, tmp_path):
    """Generation, the upload file (xlsx where openpyxl is installed, else
    CSV) and the circular-eval score."""
    root = tmp_path / "mmbench"
    root.mkdir()
    _mmbench_tsv(root / "mmbench_dev_20230712.tsv")
    r = _run_script("mmbench.sh", _launcher_env(ckpt_dir, DIR=str(root), NAME="tiny"))
    assert "Samples: 3\nAccuracy: " in r.stdout
    answers = (root / "answers" / "mmbench_dev_20230712" / "tiny.jsonl").read_text().splitlines()
    assert [json.loads(a)["question_id"] for a in answers] == [0, 1, 2]
    up = root / "answers_upload" / "mmbench_dev_20230712"
    assert (up / "tiny.xlsx").exists() or (up / "tiny.csv").exists()


def test_runway_fixture_dry_run(ckpt_dir, tmp_path, monkeypatch):
    """The runway in this process on the CPU: import, the 3-image greedy
    smoke (then diffed against its own record), gqa.sh with 2 chunks and
    mmbench.sh on 3-question subsets, both scored and compared; a wrong
    record makes it return 1."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    gqa = tmp_path / "gqa"
    _images(gqa / "images", ["a.png", "b.png", "c.png"])
    _jsonl(str(gqa / "llava_gqa_testdev_balanced.jsonl"),
           [{"question_id": f"q{i}", "image": f"{c}.png", "text": f"what {i}"}
            for i, c in enumerate("abcab")])
    (gqa / "testdev_balanced_questions.json").write_text(
        json.dumps({f"q{i}": {"answer": "yes"} for i in range(5)}))
    tsv = _mmbench_tsv(tmp_path / "mmbench_dev_20230712.tsv", n=4)
    expected = tmp_path / "expected.json"
    expected.write_text(json.dumps({"gqa": 0.0, "mmbench": 0.0}))
    out = tmp_path / "out"
    argv = ["--ckpt", ckpt_dir, "--out", str(out), "--device", "cpu"]
    rc = runway.main(argv + ["--gqa-dir", str(gqa), "--mmbench-tsv", str(tsv), "--expected",
                             str(expected), "--tolerance", "100", "--limit", "3", "--chunks",
                             "2", "--extra-args", "--max-new-tokens 4"])
    assert rc == 0
    scores = json.loads((out / "scores.json").read_text())
    assert set(scores) == {"gqa", "mmbench"} and all(0 <= v <= 100 for v in scores.values())
    preds = json.loads((out / "gqa" / "testdev_balanced_predictions.json").read_text())
    assert len(preds) == 3
    smoke = json.loads((out / "smoke_tokens.json").read_text())
    assert len(smoke) == 3 and all(len(t) > 0 for t in smoke)
    assert runway.main(argv + ["--smoke-expect", str(out / "smoke_tokens.json")]) == 0
    (tmp_path / "wrong.json").write_text(json.dumps([[1], [2], [3]]))
    assert runway.main(argv + ["--smoke-expect", str(tmp_path / "wrong.json")]) == 1


def test_help_lists_jax_flags_and_device():
    """Every entry point takes the JAX CLI's flags plus --device, which
    defaults to the card."""
    argv = ["vqa", "--model-path", "m", "--question-file", "q", "--answers-file", "a"]
    assert benchmarks.build_parser().parse_args(argv).device == "cuda"
    code = ("import sys, contextlib, io\n"
            "from tokenpacker_tpu_torch.eval import benchmarks, run_demo, mmmu, score_cli, "
            "convert, gpt_review, runway\n"
            "for mod, argv in ((benchmarks, ['mmbench', '--help']), (run_demo, ['--help']), "
            "(mmmu, ['run', '--help']), (score_cli, ['mmbench', '--help']), "
            "(convert, ['mmbench', '--help']), (gpt_review, ['review', '--help']), "
            "(runway, ['--help'])):\n"
            "    out = io.StringIO()\n"
            "    try:\n"
            "        with contextlib.redirect_stdout(out):\n"
            "            mod.main(argv)\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (mod, e.code)\n"
            "    print('::', mod.__name__, out.getvalue().replace(chr(10), ' '))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, check=True)
    helps = {line.split()[1]: line for line in r.stdout.splitlines() if line.startswith("::")}
    assert len(helps) == 7
    for name in ("benchmarks", "run_demo", "mmmu", "runway"):
        assert "--device" in helps[f"tokenpacker_tpu_torch.eval.{name}"], name
    for flag in ("--all-rounds", "--single-pred-prompt", "--load-8bit", "--num-chunks"):
        assert flag in helps["tokenpacker_tpu_torch.eval.benchmarks"]
    for flag in ("--num-beams", "--speculative-k", "--sep"):
        assert flag in helps["tokenpacker_tpu_torch.eval.run_demo"]


def test_eval_modules_import_no_jax_pandas_or_hf():
    code = ("import sys\n"
            "import tokenpacker_tpu_torch.data.prefetch\n"
            "from tokenpacker_tpu_torch.eval import benchmarks, convert, gpt_review, mmmu, "
            "run_demo, runner, runway, score_cli, scorers, tsv\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tokenpacker_tpu', 'pandas', 'datasets', 'transformers')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
