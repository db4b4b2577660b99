"""Single-image demo, the simplest generate path (counterpart of
`tokenpacker_tpu/eval/run_demo.py`, reference llava/eval/run_llava.py).

  python -m tokenpacker_tpu_torch.eval.run_demo --model-path ckpt \
      --image-file cat.jpg --query "What is this?" [--load-8bit] [--device cpu]
"""

from __future__ import annotations

import argparse

from tokenpacker_tpu_torch.eval.runner import EvalRunner, EvalSample


def eval_model(args):
    from tokenpacker_tpu_torch.api import load_pretrained_model
    from tokenpacker_tpu_torch.serve.cli import load_image, pick_conv_mode

    tokenizer, model, _, _ = load_pretrained_model(
        args.model_path, args.model_base, load_8bit=args.load_8bit, device=args.device,
    )
    conv_mode = args.conv_mode or pick_conv_mode(args.model_path)
    runner = EvalRunner(
        model,
        tokenizer,
        conv_mode=conv_mode,
        batch_size=1,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        speculative=args.speculative_k,
        num_beams=args.num_beams,
    )
    images = [load_image(f) for f in args.image_file.split(args.sep)]
    outputs = []
    for i, img in enumerate(images):
        sample = EvalSample(question_id=i, prompt_text=args.query, image=img)
        for ans in runner.run([sample]):
            print(ans["text"])
            outputs.append(ans["text"])
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--image-file", required=True)
    parser.add_argument("--query", required=True)
    parser.add_argument("--conv-mode", default=None)
    parser.add_argument("--sep", default=",")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--num-beams", type=int, default=1,
                        help="beam search width (reference run_llava.py:145; "
                             "beams are greedy — used when temperature <= 0)")
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--speculative-k", type=int, default=0,
                        help="prompt-lookup speculative decoding draft length "
                             "(greedy only; 0 disables)")
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--device", default="cuda", help="the card by default; 'cpu' to run there")
    eval_model(parser.parse_args(argv))


if __name__ == "__main__":
    main()
