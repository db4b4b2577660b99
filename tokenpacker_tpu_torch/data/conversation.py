"""Conversation / prompt templates (counterpart of
`tokenpacker_tpu/data/conversation.py`).

The template registry and the rendered prompt strings of the reference
`llava/conversation.py`, byte for byte: the system prompts and separators
are part of the released checkpoints' training distribution. This copy
holds what training's `preprocess` needs (`SeparatorStyle`,
`Conversation` with `get_prompt` / `append_message` / `copy`, every
template of `conv_templates`) and what the serving front ends use: the
image process modes (`_resized_image`: Pad / Resize / Crop / Default and
the size clamp), `get_images`, `to_gradio_chatbot` and `dict`, whose
outputs are byte-equal to the JAX package's.
"""

from __future__ import annotations

import base64
import dataclasses
from enum import Enum, auto
from io import BytesIO
from typing import Any


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _msg_text(message) -> str:
    return message[0] if isinstance(message, tuple) else message


def _render_single(conv: "Conversation", messages) -> str:
    parts = [conv.system + conv.sep]
    for role, message in messages:
        if message:
            parts.append(f"{role}: {_msg_text(message)}{conv.sep}")
        else:
            parts.append(f"{role}:")
    return "".join(parts)


def _render_two(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    parts = [conv.system + seps[0]]
    for i, (role, message) in enumerate(messages):
        if message:
            parts.append(f"{role}: {_msg_text(message)}{seps[i % 2]}")
        else:
            parts.append(f"{role}:")
    return "".join(parts)


def _render_mpt(conv: "Conversation", messages) -> str:
    parts = [conv.system + conv.sep]
    for role, message in messages:
        if message:
            parts.append(f"{role}{_msg_text(message)}{conv.sep}")
        else:
            parts.append(role)
    return "".join(parts)


def _render_plain(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    parts = [conv.system]
    for i, (_, message) in enumerate(messages):
        if message:
            parts.append(_msg_text(message) + seps[i % 2])
    return "".join(parts)


def _render_llama2(conv: "Conversation", messages) -> str:
    out = ""
    for i, (role, message) in enumerate(messages):
        if i == 0:
            assert message, "first message should not be none"
            assert role == conv.roles[0], "first message should come from user"
        if not message:
            continue
        text = _msg_text(message)
        if i == 0:
            text = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n" + text
        if i % 2 == 0:
            out += f"{conv.sep}[INST] {text} [/INST]"
        else:
            out += f" {text} {conv.sep2}"
    return out.lstrip(conv.sep)


_RENDERERS = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: _render_llama2,
}


@dataclasses.dataclass
class Conversation:
    system: str
    roles: tuple
    messages: list
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str | None = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        messages = list(self.messages)
        if messages and isinstance(messages[0][1], tuple):
            # first user turn carries an image: normalize its placement
            init_role, init_msg = messages[0]
            text = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = (init_role, text)
                messages.insert(0, (self.roles[0], "<Image><image></Image>"))
                messages.insert(1, (self.roles[1], "Received."))
            else:
                messages[0] = (init_role, "<image>\n" + text)
        try:
            render = _RENDERERS[self.sep_style]
        except KeyError:
            raise ValueError(f"Invalid style: {self.sep_style}")
        return render(self, messages)

    def append_message(self, role, message) -> None:
        self.messages.append([role, message])

    def _resized_image(self, image, image_process_mode):
        from PIL import Image as PILImage

        if image_process_mode == "Pad":
            w, h = image.size
            if w != h:
                side = max(w, h)
                sq = PILImage.new(image.mode, (side, side), (122, 116, 104))
                sq.paste(image, ((side - w) // 2, (side - h) // 2))
                image = sq
        elif image_process_mode == "Resize":
            image = image.resize((336, 336))
        elif image_process_mode not in ("Default", "Crop"):
            raise ValueError(f"Invalid image_process_mode: {image_process_mode}")
        max_hw, min_hw = max(image.size), min(image.size)
        aspect = max_hw / min_hw
        shortest = int(min(800 / aspect, 400, min_hw))
        longest = int(shortest * aspect)
        w, h = image.size
        if longest != max(image.size):
            if h > w:
                image = image.resize((shortest, longest))
            else:
                image = image.resize((longest, shortest))
        return image

    def get_images(self, return_pil: bool = False) -> list:
        images = []
        for i, (_, msg) in enumerate(self.messages[self.offset :]):
            if i % 2 == 0 and isinstance(msg, tuple):
                _, image, mode = msg
                image = self._resized_image(image, mode)
                if return_pil:
                    images.append(image)
                else:
                    buf = BytesIO()
                    image.save(buf, format="PNG")
                    images.append(base64.b64encode(buf.getvalue()).decode())
        return images

    def to_gradio_chatbot(self) -> list:
        ret: list[list[Any]] = []
        for i, (_, msg) in enumerate(self.messages[self.offset :]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text, image, _ = msg
                    image = self._resized_image(image, "Default")
                    buf = BytesIO()
                    image.save(buf, format="JPEG")
                    b64 = base64.b64encode(buf.getvalue()).decode()
                    img_tag = f'<img src="data:image/png;base64,{b64}" alt="user upload image" />'
                    ret.append([img_tag + text.replace("<image>", "").strip(), None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        messages = (
            [[r, m[0] if isinstance(m, tuple) else m] for r, m in self.messages]
            if self.get_images()
            else self.messages
        )
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_V0_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)
_V1_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)
_LLAMA2_SYSTEM = """You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information."""
_LLAVA_LLAMA2_SYSTEM = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)
_MPT_SYSTEM = """<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers."""

# The v0 template ships with a two-turn seed exchange (offset=2).
_V0_SEED_Q = "What are the key differences between renewable and non-renewable energy sources?"
_V0_SEED_A = (
    "Renewable energy sources are those that can be replenished naturally in a relatively "
    "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
    "Non-renewable energy sources, on the other hand, are finite and will eventually be "
    "depleted, such as coal, oil, and natural gas. Here are some key differences between "
    "renewable and non-renewable energy sources:\n"
    "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
    "energy sources are finite and will eventually run out.\n"
    "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
    "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
    "and other negative effects.\n"
    "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
    "have lower operational costs than non-renewable sources.\n"
    "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
    "locations than non-renewable sources.\n"
    "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
    "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
    "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
    "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"
)

conv_vicuna_v0 = Conversation(
    system=_V0_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[["Human", _V0_SEED_Q], ["Assistant", _V0_SEED_A]],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system=_V1_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system=_LLAMA2_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system=_LLAVA_LLAMA2_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system=_MPT_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system=_V0_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system=_V0_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

default_conversation = conv_vicuna_v1
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
