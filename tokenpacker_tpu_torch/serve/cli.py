"""Terminal chat (counterpart of `tokenpacker_tpu/serve/cli.py`, reference
llava/serve/cli.py).

Loads a checkpoint through `api.load_pretrained_model`, preprocesses one
image (pad or HD slices, by the model's config), picks the conversation
template from the model's name and streams each answer through
`Generator.generate_stream`, with the turn's wall-clock time
(cli.py:147-162). An empty line or end of input ends the chat.

    python -m tokenpacker_tpu_torch.serve.cli --model-path DIR --image-file IMG [--load-8bit]
"""

from __future__ import annotations

import argparse
import io
import time

import numpy as np

from tokenpacker_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from tokenpacker_tpu_torch.data.conversation import SeparatorStyle, conv_templates
from tokenpacker_tpu_torch.data.mm_tokenize import get_model_name_from_path, tokenizer_image_token
from tokenpacker_tpu_torch.generate import pick_bucket
from tokenpacker_tpu_torch.image.processing import process_image
from tokenpacker_tpu_torch.models.splice import build_splice_plan


def pick_conv_mode(model_name: str) -> str:
    """The template from the model's name (reference cli.py and
    gradio_web_server.py:167-193)."""
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "v1" in name or "tokenpacker" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"


def load_image(image_file: str):
    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(image_file) as resp:
            return Image.open(io.BytesIO(resp.read())).convert("RGB")
    return Image.open(image_file).convert("RGB")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--image-file", required=True)
    parser.add_argument("--conv-mode", default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--device", default="cuda", help="the card by default; 'cpu' to run there")
    args = parser.parse_args(argv)

    from tokenpacker_tpu_torch.api import load_pretrained_model

    model_name = get_model_name_from_path(args.model_path)
    tokenizer, model, _, context_len = load_pretrained_model(
        args.model_path, args.model_base,
        load_8bit=args.load_8bit, load_4bit=args.load_4bit, device=args.device,
    )
    cfg = model.config

    conv_mode = args.conv_mode or pick_conv_mode(model_name)
    conv = conv_templates[conv_mode].copy()

    image = load_image(args.image_file)
    crops, hb, wb = process_image(image, cfg.image_aspect_ratio, cfg.patch_num,
                                  cfg.vision.image_size)
    mode = "slice" if cfg.image_aspect_ratio == "slice" else "single"
    images = crops.transpose(0, 2, 3, 1)

    sep_id = tokenizer.convert_tokens_to_ids(",")
    ret_id = tokenizer.convert_tokens_to_ids("\n")
    pad_id = tokenizer.pad_token_id or 0
    first_turn = True

    while True:
        try:
            inp = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if not inp:
            print("exit...")
            break
        if first_turn:
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            first_turn = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        ids = np.asarray(tokenizer_image_token(prompt, tokenizer), dtype=np.int64)
        plan = build_splice_plan(
            [ids], [[(hb, wb)]], cfg.tokens_per_view, mode, sep_id, ret_id, pad_id
        )
        plan = build_splice_plan(
            [ids], [[(hb, wb)]], cfg.tokens_per_view, mode, sep_id, ret_id, pad_id,
            pad_to=pick_bucket(int(plan.lengths[0])),
        )
        stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2

        print(f"{conv.roles[1]}: ", end="", flush=True)
        start = time.time()
        text = ""
        printed = 0
        for text in model.generator.generate_stream(
            {
                "token_ids": plan.token_ids,
                "is_image": plan.is_image,
                "image_slot": plan.image_slot,
                "lengths": plan.lengths,
                "images": images,
            },
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            stop_strings=(stop_str,) if stop_str else (),
        ):
            print(text[printed:], end="", flush=True)
            printed = len(text)
        print()
        print(f"[turn took {time.time() - start:.2f}s]")
        conv.messages[-1][-1] = text


if __name__ == "__main__":
    main()
