"""Reading checkpoint files (the state-dict reader of
`tokenpacker_tpu/api.py:65-85` and `io/surgery.py:113-136`).

A checkpoint directory holds `*.safetensors` files (preferred) or
`pytorch_model*.bin` shards. The GPU machine has neither the
`safetensors` nor the `transformers` package, so `read_safetensors` is the
port's own reader of the format: an unsigned 64-bit little-endian header
length, a JSON header mapping each name to its `dtype`, `shape` and
`data_offsets` (relative to the end of the header), then the raw
little-endian bytes. Tensors are views of a copy-on-write memory map of
the file (nothing is read until used). It reads bf16, which the JAX
package's `safe_open(framework="np")` cannot (ROADMAP R12).
`.bin` shards go through `torch.load(..., weights_only=True, mmap=True)`.
"""

from __future__ import annotations

import glob
import json
import os
import struct

import numpy as np
import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, as CPU tensors that view a
    copy-on-write map of the file (a tensor whose bytes do not sit at a
    multiple of its element size is copied out)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    base = 8 + n
    data = np.memmap(path, dtype=np.uint8, mode="c") if header else None
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader "
                             f"does not know ({sorted(SAFETENSORS_DTYPES)})")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        width = torch.empty((), dtype=dtype).element_size()
        if end - begin != width * int(np.prod(shape)):
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, its shape {shape} "
                             f"needs {width * int(np.prod(shape))}")
        raw = torch.from_numpy(data[base + begin:base + end])
        if (base + begin) % width:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_bin(path: str) -> dict[str, torch.Tensor]:
    """One `torch.save`d state dict, memory-mapped."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_state_dict(model_path: str) -> dict:
    """All weights of a checkpoint directory: its `*.safetensors` files if
    it has any, else its `pytorch_model*.bin` shards, each in sorted order
    (the JAX `api._load_state_dict`)."""
    sd: dict = {}
    st_files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    bin_files = sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no weights found in {model_path}")
    for f in bin_files:
        sd.update(load_bin(f))
    return sd


def load_any_state_dict(path: str) -> dict:
    """The surgery tools' reader (the JAX `surgery._load_any_state_dict`):
    every `pytorch_model*.bin` and `*.safetensors` file of a directory
    together in sorted order, or one weights file given by its path."""
    sd: dict = {}
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))
                   + glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        if os.path.isfile(path):
            files = [path]
        else:
            raise FileNotFoundError(f"no weights under {path}")
    for f in files:
        sd.update(read_safetensors(f) if f.endswith(".safetensors") else load_bin(f))
    return sd

