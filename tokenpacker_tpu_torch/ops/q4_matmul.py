"""K6: the 4-bit dequant-in-kernel matmul for small M (counterpart of
`tokenpacker_tpu/ops/q4_matmul.py`).

y = x @ dequantize_4bit(W) for a 4-bit leaf of `ops/quantize` (nf4 or
int4, blocks of 64 rows), without ever building the dense weight. On a
CUDA tensor `q4_matmul` launches `csrc/q4_matmul.cu`, which streams the
packed bytes once for up to 32 rows of x, decodes both nibbles in
registers into the tensor cores' fragments, and splits K across the
`q4_splits` blocks of one cluster; on a CPU tensor it runs
`q4_matmul_plain`, the dequantized product in f32. Decode steps (M <= 32,
`ops/layers.linear`) take it; larger M dequantizes and takes a dense
product, as the JAX package does.

The TPU kernel folds int4's 1/7 into absmax and subtracts 8 * sum(x)
instead of decoding idx - 8; the kernel here decodes (idx - 8) / 7 times
absmax directly, the same f32 weight `dequantize_4bit` builds, so the two
differ only in the order of the sums.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.ops.splits import cluster_splits, sm_count
from tokenpacker_tpu_torch.ops.quantize import dequantize_4bit, q4_meta

BLOCK_COLS = 128  # output columns a block of the kernel
MAX_ROWS = 32  # rows of x the kernel takes (the route's M <= 32)


def q4_splits(k: int, n: int, sms: int = 132) -> int:
    """The blocks that share one 128-column tile's K in the kernel: a power
    of two up to MAX_SPLITS, doubled while the grid holds fewer than two
    blocks an SM, as long as each split keeps a whole 64-row quantization
    block (`splits.cluster_splits`). The kernel hands each split whole
    blocks, balanced."""
    return cluster_splits(k, -(-n // BLOCK_COLS), sms)


def q4_matmul_plain(x: torch.Tensor, qleaf: dict) -> torch.Tensor:
    """x [..., K] @ dequantize_4bit(qleaf) [K, N] in f32 -> [..., N] in
    x's dtype."""
    return (x.float() @ dequantize_4bit(qleaf, torch.float32)).to(x.dtype)


def q4_matmul(x: torch.Tensor, qleaf: dict) -> torch.Tensor:
    """x [..., K] bf16 times a 4-bit leaf (packed [K/2, N] uint8, absmax
    [K/64, N] f32) -> [..., N] bf16, in one launch; on the card the rows
    of x are at most MAX_ROWS."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qleaf)
    key, quant_type, block = q4_meta(qleaf)
    packed, absmax = qleaf[key], qleaf["absmax"]
    lead, k = x.shape[:-1], x.shape[-1]
    n = packed.shape[-1]
    xm = x.reshape(-1, k).contiguous()
    m = xm.shape[0]
    if (block != 64 or quant_type not in ("nf4", "int4") or packed.shape != (k // 2, n)
            or absmax.shape != (k // 64, n) or k % 64 or n % 16 or m > MAX_ROWS):
        raise ValueError(f"q4_matmul: x {tuple(x.shape)}, {key} {tuple(packed.shape)}, absmax "
                         f"{tuple(absmax.shape)}: the kernel takes blocks of 64 rows, K % 64 == 0, "
                         f"N % 16 == 0 and M <= {MAX_ROWS}")
    stream = _build.cuda_args("q4_matmul", x=(xm, torch.bfloat16), packed=(packed, torch.uint8),
                              absmax=(absmax, torch.float32))
    lib = _build.library()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    rc = lib.tp_q4_matmul(xm.data_ptr(), packed.data_ptr(), absmax.data_ptr(), out.data_ptr(), m,
                          k, n, int(quant_type == "nf4"), q4_splits(k, n, sm_count(x.device.index)),
                          stream)
    _build.check(rc, "q4_matmul")
    q4_matmul.launches += 1
    return out.reshape(*lead, n)


q4_matmul.launches = 0
